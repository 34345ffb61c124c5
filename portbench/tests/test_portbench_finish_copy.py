"""The reader of the program's count of the bytes the dense finish copied
between the host and the card (``last_phase_stats()``'s
finish_copy_bytes): the mean over the window's calls in MB, nothing where
the program keeps no such count, and 0 in a traced CPU run, whose finish
copies nothing to a card."""

import os

import pytest

import conftest
import harness
from test_portbench_run import CELLS, run_cell


def reader():
    return harness.load_module(os.path.join(
        conftest.PB, "metrics", "finish_copy_mb.py"))


def test_mean_over_the_calls():
    record = {"phase_stats": [{"finish_copy_bytes": 20_900_000},
                              {"finish_copy_bytes": 21_100_000},
                              {"finish_copy_bytes": 0}]}
    assert reader().read(record) == pytest.approx(14.0)


def test_nothing_without_the_count():
    old = {"pivot_s": 0.2, "finish_s": 0.15, "rref_groups": 128}
    assert reader().read({"phase_stats": [dict(old)] * 2}) is None
    assert reader().read({"phase_stats": []}) is None


@pytest.mark.parametrize("name", CELLS)
def test_traced_run_reports_the_count(mini, name):
    res = run_cell(mini, name, trace=1)
    assert res["correct"]
    got = res["metrics"]["finish_copy_mb"]
    assert got == {"value": 0.0, "unit": "MB"}
    untraced = run_cell(mini, name, trace=0)
    assert "finish_copy_mb" not in untraced["metrics"]
