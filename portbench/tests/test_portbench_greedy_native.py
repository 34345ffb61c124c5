"""The reader of the program's greedy-completion counts
(``last_phase_stats()``'s greedy_native / greedy_numpy): the share summed
over the window's calls, nothing where the program keeps no such counts
or no completion ran, and 1.0 in a traced CPU run at a tiny size."""

import os

import pytest

import conftest
import harness
from test_portbench_run import CELLS, run_cell


def reader():
    return harness.load_module(os.path.join(
        conftest.PB, "metrics", "greedy_native_share.py"))


def test_share_is_summed_over_the_calls():
    record = {"phase_stats": [{"greedy_native": 2, "greedy_numpy": 0},
                              {"greedy_native": 1, "greedy_numpy": 1},
                              {"greedy_native": 0, "greedy_numpy": 0}]}
    assert reader().read(record) == pytest.approx(3 / 4)


def test_nothing_without_counts_or_completions():
    old = {"pivot_s": 0.2, "finish_s": 0.15, "total_s": 0.36}
    assert reader().read({"phase_stats": [dict(old)] * 2}) is None
    assert reader().read({"phase_stats": []}) is None
    none_ran = {"greedy_native": 0, "greedy_numpy": 0}
    assert reader().read({"phase_stats": [none_ran] * 3}) is None


@pytest.mark.parametrize("name", CELLS)
def test_traced_run_reports_the_share(mini, name):
    res = run_cell(mini, name, trace=1)
    assert res["correct"]
    got = res["metrics"]["greedy_native_share"]
    assert got == {"value": 1.0, "unit": "fraction"}
    untraced = run_cell(mini, name, trace=0)
    assert "greedy_native_share" not in untraced["metrics"]
