"""The reader of the program's counts of panel groups
(``last_phase_stats()``'s rref_groups / rref_groups_run): the skipped
share summed over the window's calls, nothing where the program keeps no
such counts or no call reached a group, and a share in [0, 1) in a traced
CPU run at a tiny size whose dense finish takes the device block loop
(below ``host_cutoff_for(f)`` elements it is the host's, which has no
groups)."""

import os

import pytest

import conftest
import harness
from test_portbench_run import CELLS, run_cell


def reader():
    return harness.load_module(os.path.join(
        conftest.PB, "metrics", "rref_group_skip_share.py"))


def test_share_is_summed_over_the_calls():
    record = {"phase_stats": [{"rref_groups": 128, "rref_groups_run": 16},
                              {"rref_groups": 364, "rref_groups_run": 108},
                              {"rref_groups": 0, "rref_groups_run": 0}]}
    assert reader().read(record) == pytest.approx(1 - 124 / 492)


def test_nothing_without_counts_or_groups():
    old = {"pivot_s": 0.2, "finish_s": 0.15, "finish_blocks": 52}
    assert reader().read({"phase_stats": [dict(old)] * 2}) is None
    assert reader().read({"phase_stats": []}) is None
    host = {"rref_groups": 0, "rref_groups_run": 0}
    assert reader().read({"phase_stats": [host] * 3}) is None


@pytest.mark.parametrize("name", CELLS)
def test_traced_run_reports_the_share(mini, name, monkeypatch):
    from spasm_tpu_torch.ops import dense

    monkeypatch.setattr(dense, "HOST_CUTOFF", 1)
    monkeypatch.setattr(dense, "HOST_CUTOFF_BIGP", 1)
    res = run_cell(mini, name, trace=1)
    assert res["correct"]
    got = res["metrics"]["rref_group_skip_share"]
    assert got["unit"] == "fraction" and 0 <= got["value"] < 1
    untraced = run_cell(mini, name, trace=0)
    assert "rref_group_skip_share" not in untraced["metrics"]
