"""The readers of the program's spans (``last_phase_stats()``): means over
the window's calls, nothing where the program reports no such span (as
before it had them), and ``unspanned_s`` as each call's wall less its
top-level spans.  Then a traced CPU run at a tiny size that reports all
of them."""

import os

import pytest

import conftest
import harness
from test_portbench_run import CELLS, run_cell

SPANS = ["convert_s", "estimate_s", "finish_prep_s", "finish_wait_s",
         "finish_extract_s", "assemble_s"]
NEW = SPANS + ["unspanned_s"]
TOP = ("convert_s", "pivot_s", "estimate_s", "schur_s", "finish_s",
       "assemble_s")


def reader(name):
    return harness.load_module(os.path.join(conftest.PB, "metrics",
                                            name + ".py"))


def stats(i):
    """A call's phases with known values: key k of call i reads
    (k's place + 1) * (i + 1) ms."""
    keys = dict.fromkeys(TOP + tuple(SPANS))
    return {k: (j + 1) * (i + 1) * 1e-3 for j, k in enumerate(keys)}


@pytest.mark.parametrize("name", SPANS)
def test_span_reader_is_the_mean(name):
    record = {"phase_stats": [stats(0), stats(1), stats(2)],
              "walls": [1.0] * 3}
    want = sum(s[name] for s in record["phase_stats"]) / 3
    assert reader(name).read(record) == pytest.approx(want)


@pytest.mark.parametrize("name", NEW)
def test_nothing_where_the_program_has_no_span(name):
    """Phase stats as the program gave them before its spans: pivot_s,
    schur_s, finish_s, assemble_s, device_s, total_s and device_share.
    Of the new metrics only assemble_s finds its key there."""
    old = {"pivot_s": 0.2, "schur_s": 0.0, "finish_s": 0.15,
           "assemble_s": 0.01, "device_s": 0.1, "total_s": 0.36,
           "device_share": 0.28}
    record = {"phase_stats": [dict(old)] * 2, "walls": [0.4, 0.4]}
    got = reader(name).read(record)
    assert got == (0.01 if name == "assemble_s" else None)
    assert reader(name).read({"phase_stats": [], "walls": []}) is None


def test_unspanned_is_the_wall_less_the_top_spans():
    phases = [stats(0), stats(1)]
    walls = [0.5, 0.25]
    want = [w - sum(s[k] for k in TOP) for w, s in zip(walls, phases)]
    record = {"phase_stats": phases, "walls": walls}
    got = reader("unspanned_s").read(record)
    assert got == pytest.approx(sum(want) / 2)
    # the finish's children are inside finish_s: they do not count again
    for s in phases:
        s["finish_wait_s"] += 1.0
    assert reader("unspanned_s").read(record) == pytest.approx(got)
    # a call without a top-level span is left out, not counted as 0
    del phases[1]["convert_s"]
    assert reader("unspanned_s").read(record) == pytest.approx(want[0])


@pytest.mark.parametrize("name", CELLS)
def test_traced_run_reports_the_spans(mini, name):
    res = run_cell(mini, name, trace=1)
    assert res["correct"]
    got = {k: res["metrics"][k]["value"] for k in NEW}
    assert all(res["metrics"][k]["unit"] == "s" for k in NEW)
    assert all(v >= 0 for v in got.values())
    assert got["finish_wait_s"] > 0 and got["convert_s"] > 0
    untraced = run_cell(mini, name, trace=0)
    assert not set(NEW) & set(untraced["metrics"])
