"""The port's spans (``utils/profiling.phase``) inside ``echelonize``: the
keys of ``last_phase_stats()`` they feed, the ``spasm.*`` events they put
into a torch.profiler trace, and what they cost with no profiler running.
On the CPU at test sizes; ``ops.dense.HOST_CUTOFF`` lowered sends the
dense finish to the device-sized loops, as on a card."""

import gc
import json
import math
import re

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

import spasm_tpu_torch as stt
from spasm_tpu_torch._host import fixtures
from spasm_tpu_torch._host.utils import logging as host_logging
from spasm_tpu_torch.ops import dense
from spasm_tpu_torch.utils import profiling

KEYS = ("total_s", "convert_s", "pivot_s", "estimate_s", "schur_s",
        "schur_reduce_s", "schur_eliminate_s", "finish_s", "finish_prep_s",
        "finish_wait_s", "finish_tail_s", "finish_extract_s", "assemble_s",
        "device_s")
TOP = ("convert_s", "pivot_s", "estimate_s", "schur_s", "finish_s",
       "assemble_s")
CHILDREN = ("finish_prep_s", "finish_wait_s", "finish_extract_s")
# the counts beside the spans: pivot searches whose greedy completion ran
# in C and in NumPy; Schur updates; the dense finish's rows, whether it
# streamed, its blocks and the rows its tail check skipped; the panel
# groups its RREFs reached and ran
COUNTS = ("greedy_native", "greedy_numpy", "rounds", "finish_rows",
          "finish_streamed", "finish_blocks", "finish_rows_skipped",
          "rref_groups", "rref_groups_run", "finish_copy_bytes")
# span name -> the key it feeds
SPAN_KEY = {"echelonize": "total_s", "convert": "convert_s",
            "pivots": "pivot_s", "estimate": "estimate_s",
            "schur": "schur_s", "schur.reduce": "schur_reduce_s",
            "schur.eliminate": "schur_eliminate_s", "finish": "finish_s",
            "finish.prep": "finish_prep_s", "finish.wait": "finish_wait_s",
            "finish.tail": "finish_tail_s",
            "finish.extract": "finish_extract_s", "assemble": "assemble_s"}
# the spans a call enters only with Schur rounds or a tail check
ROUND_AND_TAIL = {"schur", "schur.reduce", "schur.eliminate", "finish.tail"}
# the dense finish's paths: the fused finish after a dense switch at round
# 0 (the card's main path), the streaming loop, the streaming loop of a
# finish under the cutoff (on CPU tensors, no device time), a run whose
# Schur rounds come before a streaming finish, and a boundary whose two
# Schur rounds come before the streaming loop and its tail check
PATHS = ("fused", "streaming", "host", "rounds", "boundary")


def _case(path, monkeypatch):
    f = stt.field(42013)
    if path != "host":
        monkeypatch.setattr(dense, "HOST_CUTOFF", 1)
    if path == "streaming":
        monkeypatch.setattr(dense, "FUSED_BUDGET", 0)
    if path == "rounds":    # three Schur rounds, then 6 pivots to finish
        return stt.SparseGFp.rand(f, 400, 300, 0.01,
                                  np.random.default_rng(2))
    if path == "boundary":  # 15,493 x 16,740; the finish gets 5,002 rows
        return fixtures.subcomplex_boundary(18, 6, 0.9, seed=0)
    return stt.SparseGFp.rand(f, 200, 160, 0.05, np.random.default_rng(7))


def _call(A, path=None):
    # the boundary's finish in blocks of 256 rows: 20 where it had no check
    kw = {"dense_block_size": 256} if path == "boundary" else {}
    lu = stt.echelonize(A, device="cpu", **kw)
    return lu, stt.last_phase_stats()


@pytest.mark.parametrize("path", PATHS)
def test_spans_cover_the_call(path, monkeypatch):
    """Every key is there and >= 0; the finish's three children tile it;
    the top-level spans leave under 2% of the call unnamed."""
    A = _case(path, monkeypatch)
    _call(A, path)                    # native builds, first-call costs
    lu, st = _call(A, path)
    assert lu.dense_piv_start is not None    # the dense finish ran
    assert set(st) == set(KEYS) | set(COUNTS)
    assert all(st[k] >= 0 for k in KEYS)
    # the finish's RREFs (on CPU tensors for the host-sized finish too):
    # some groups run, none past the count
    assert 0 < st["rref_groups_run"] <= st["rref_groups"]
    # the streaming loop counts its blocks at every size; finish_streamed
    # says it ran a finish on the device
    streams = path != "fused"
    assert (st["finish_blocks"] > 0) == streams
    assert st["finish_streamed"] == int(streams and path != "host")
    for k in ("convert_s", "pivot_s", "estimate_s", "finish_wait_s",
              "finish_extract_s"):
        assert st[k] > 0, k
    assert (st["schur_s"] > 0) == (path in ("rounds", "boundary"))
    assert (st["device_s"] > 0) == (path != "host")
    assert st["finish_copy_bytes"] == 0      # nothing goes to a card
    kids = sum(st[k] for k in CHILDREN)
    assert 0.98 * st["finish_s"] <= kids <= st["finish_s"]
    top = sum(st[k] for k in TOP)
    assert 0.98 * st["total_s"] <= top <= st["total_s"]


def _spans(trace_path):
    with open(trace_path) as fh:
        events = json.load(fh)["traceEvents"]
    return [e for e in events if e.get("ph") == "X"
            and e.get("cat") == "user_annotation"
            and e.get("name", "").startswith("spasm.")]


def _inside(e, outer):
    return (outer["ts"] <= e["ts"]
            and e["ts"] + e["dur"] <= outer["ts"] + outer["dur"] + 1e-3)


@pytest.mark.parametrize("path", ["fused", "rounds", "boundary"])
def test_spans_in_the_profiler_trace(path, monkeypatch, tmp_path):
    """Under torch.profiler every span is a ``user_annotation`` event
    ``spasm.<span>`` inside the call's root, the finish's children inside
    ``spasm.finish``, the Schur update's inside a ``spasm.schur`` and the
    tail checks inside a ``spasm.finish.wait``, and each name's events last
    as long as its key says; the result is the untraced call's."""
    A = _case(path, monkeypatch)
    want, _ = _call(A, path)
    # the first events of a profiler session, and a collection of the
    # garbage, can stall a span's record_function outside its clock by
    # milliseconds: both kept out of the compared call
    gc.collect()
    gc.disable()
    try:
        with profile(activities=[ProfilerActivity.CPU]) as prof:
            with torch.profiler.record_function("warm-up"):
                pass
            lu, st = _call(A, path)
    finally:
        gc.enable()
    prof.export_chrome_trace(str(tmp_path / "trace.json"))
    assert lu.r == want.r
    assert (lu.U.to_scipy() != want.U.to_scipy()).nnz == 0
    events = _spans(tmp_path / "trace.json")
    names = {e["name"][len("spasm."):] for e in events}
    need = {"echelonize", "convert", "pivots", "estimate", "finish",
            "finish.prep", "finish.wait", "finish.extract", "assemble"}
    if path != "fused":
        need |= {"schur", "schur.reduce", "schur.eliminate"}
    if path == "boundary":
        need.add("finish.tail")
    assert need <= names <= set(SPAN_KEY)
    (root,) = [e for e in events if e["name"] == "spasm.echelonize"]
    (fin,) = [e for e in events if e["name"] == "spasm.finish"]

    def named(name):
        return [e for e in events if e["name"] == name]

    for e in events:
        assert _inside(e, root), e["name"]
        if e["name"].startswith("spasm.finish."):
            assert _inside(e, fin), e["name"]
        if e["name"].startswith("spasm.schur."):
            assert any(_inside(e, o) for o in named("spasm.schur"))
        if e["name"] == "spasm.finish.tail":
            assert any(_inside(e, o) for o in named("spasm.finish.wait"))
    for name in names:
        dur_s = sum(e["dur"] for e in events
                    if e["name"] == "spasm." + name) / 1e6
        key = st[SPAN_KEY[name]]
        assert abs(dur_s - key) <= max(0.1 * key, 1e-3), (name, dur_s, key)


def test_child_spans_and_counts_match_the_log(monkeypatch):
    """On a boundary with two Schur rounds and a streaming finish whose
    tail check skips rows: ``rounds``, ``finish_blocks`` and
    ``finish_rows_skipped`` are what the log says; the Schur update's
    children lie within it and the tail checks within the block loop; the
    top-level spans leave under 1% of the call unnamed."""
    A = _case("boundary", monkeypatch)
    _call(A, "boundary")
    _, quiet = _call(A, "boundary")
    top = sum(quiet[k] for k in TOP)
    assert 0.99 * quiet["total_s"] <= top <= quiet["total_s"]
    lines = []
    host_logging.set_log(lines.append)
    try:
        lu = stt.echelonize(A, device="cpu", verbose=True,
                            dense_block_size=256)
    finally:
        host_logging.set_log(None)
    st = stt.last_phase_stats()
    assert {k: st[k] for k in COUNTS} == {k: quiet[k] for k in COUNTS}
    updates = [s for s in lines if s.startswith("Schur complement: ")]
    (proc,) = [re.search(r"processing (\d+) x \d+ in blocks of (\d+)", s)
               for s in lines if "[echelonize/dense] processing" in s]
    (skip,) = [re.search(r"remaining (\d+) rows dependent", s)
               for s in lines if "randomized check" in s]
    n_s, bs = int(proc.group(1)), int(proc.group(2))
    skipped = int(skip.group(1))
    assert st["rounds"] == len(updates) == 2
    assert st["finish_rows"] == n_s and st["finish_streamed"] == 1
    assert st["finish_rows_skipped"] == skipped > 0
    assert st["finish_blocks"] == math.ceil((n_s - skipped) / bs)
    assert 0 < st["schur_reduce_s"] + st["schur_eliminate_s"] <= st[
        "schur_s"]
    assert 0 < st["finish_tail_s"] <= st["finish_wait_s"]
    assert lu.r == stt.echelonize(A, device="cpu", enable_dense=False).r


class _Counting:
    """A stand-in for ``torch.profiler.record_function`` that counts the
    spans entered."""

    entered = 0

    def __init__(self, name):
        self.name = name

    def __enter__(self):
        type(self).entered += 1
        return self

    def __exit__(self, *exc):
        return False


def test_no_record_function_without_a_profiler(monkeypatch):
    """With no profiler running no span enters ``record_function``; under
    one every span does (the stand-in is the one ``phase`` looks up)."""
    A = _case("fused", monkeypatch)
    monkeypatch.setattr(_Counting, "entered", 0)
    monkeypatch.setattr(torch.profiler, "record_function", _Counting)
    _call(A)
    assert _Counting.entered == 0
    with profile(activities=[ProfilerActivity.CPU]):
        _call(A)
    # no Schur round or tail check here
    assert _Counting.entered >= len(set(SPAN_KEY) - ROUND_AND_TAIL)


def test_phase_with_stats_adds_and_logs_nothing():
    """With a dict ``phase`` adds its seconds to the key (dots become
    underscores, or the key given) and leaves ``phase_records`` and the log
    alone; without one it keeps the records and the ``[profile]`` line."""
    lines = []
    profiling.reset_phases()
    host_logging.set_log(lines.append)
    try:
        stats = {}
        for _ in range(2):
            with profiling.phase("finish.prep", stats):
                pass
        with profiling.phase("echelonize", stats, key="total_s"):
            pass
        assert set(stats) == {"finish_prep_s", "total_s"}
        assert all(v >= 0 for v in stats.values())
        assert profiling.phase_records == [] and lines == []
        with profiling.phase("outer"):
            pass
        assert [n for n, _ in profiling.phase_records] == ["outer"]
        assert len(lines) == 1 and lines[0].startswith("[profile] outer: ")
    finally:
        host_logging.set_log(None)
        profiling.reset_phases()
