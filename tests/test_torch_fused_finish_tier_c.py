"""The port's fused dense finish and device-resident RREF against the JAX
package's at p = 4294967291 (tier C) on the CPU, exactly: a file of its
own because the reference compiles tier C slowly (about a minute a
finish), so that it runs beside test_torch_fused_finish.py."""

from test_torch_fused_finish import check_fused, check_rref


def test_fused_finish_matches_reference_tier_c(monkeypatch):
    check_fused(4294967291, "mixed", 1, monkeypatch)


def test_rref_matches_reference_tier_c(rng, monkeypatch):
    check_rref(4294967291, 1, False, rng, monkeypatch)
