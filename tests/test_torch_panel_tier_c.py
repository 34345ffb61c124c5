"""Port's plain panel elimination at a tier-C prime (p = 2**32 - 5, where
the JAX package has no Pallas kernel) against the JAX fallback
_panel_eliminate.  A file of its own: XLA takes most of a minute to
compile the reference's uint32 tier-C arithmetic, and this keeps that off
the other panel tests' worker."""

import jax.numpy as jnp

from test_torch_panel import _check, _ref_panel, cut_of, make_panel, port_panel


def test_panel_tier_c_matches_jax_fallback(rng):
    f, P, ispiv = make_panel(4294967291, rng)
    j0, npivcols = cut_of(True, P.shape[1])
    got = port_panel(f, P, ispiv, j0, npivcols)
    assert got[4].sum() > 0
    want = _ref_panel(f, jnp.asarray(P), jnp.asarray(ispiv), j0, npivcols)
    _check(got, want)
