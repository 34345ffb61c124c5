"""Whole runs of every cell on the CPU at tiny sizes: the result line, the
trace's metrics, and ``correct`` against the timed path broken underneath."""

import argparse
import dataclasses
import json
import os
import subprocess
import sys

import numpy as np
import pytest

import conftest
import harness

CELLS = [w["name"] for w in conftest.bench()["workloads"]]
KEYS = ["correct", "attempted", "failed", "metrics", "device"]


def run_cell(mini, name, trace=0, program=None, seconds=0.5, seed=2**31 + 5):
    import spasm_tpu_torch

    files = harness.cell(name, here=str(mini / "portbench"), root=str(mini))
    args = argparse.Namespace(workload=name, seed=seed, seconds=seconds,
                              trace=trace)
    return harness.run(args, device="cpu", program=program or spasm_tpu_torch,
                       cell_files=files, log=lambda msg: None)


@pytest.mark.parametrize("name", CELLS)
def test_untraced_line(mini, name):
    res = run_cell(mini, name)
    assert list(res) == KEYS + ["checks"]
    assert res["correct"] and res["failed"] == 0 and res["attempted"] >= 1
    e2e = [m for m in conftest.bench()["end_to_end"]
           if name in m.get("workloads", [name])]
    # card_mem_gib reads the card's allocator: nothing to read on the CPU;
    # a percentile needs ten calls
    want = {m["name"] for m in e2e} - {"card_mem_gib"}
    if res["attempted"] < 10:
        want.discard("echelonize_s.p90")
    assert want <= set(res["metrics"])
    assert all(v["value"] > 0 for v in res["metrics"].values())
    assert set(res["device"]) == {"platform", "kind", "count",
                                  "memory_peak_bytes"}
    assert res["checks"] == {"rank_gap": {"value": 0, "limit": 0},
                             "form_faults": {"value": 0, "limit": 0},
                             "residual_nonzeros": {"value": 0, "limit": 0}}
    json.dumps(res)


@pytest.mark.parametrize("name", CELLS)
def test_traced_line(mini, name):
    res = run_cell(mini, name, trace=1)
    assert list(res) == KEYS + ["breakdown", "checks"]
    assert res["correct"]
    assert {"busy_s", "window_s"} <= set(res["device"])
    assert res["device"]["window_s"] > 0
    names = {m["name"] for m in conftest.bench()["per_layer"]}
    assert set(res["metrics"]) <= names
    assert "pivot_s" in res["metrics"]
    assert set(res["breakdown"]) == {"device_ops", "idle_gaps"}
    assert len(res["breakdown"]["idle_gaps"]) <= 10


class Broken:
    """The program with its timed path broken underneath."""

    def __init__(self, how):
        import spasm_tpu_torch

        self._p = spasm_tpu_torch
        self.how = how

    def __getattr__(self, name):
        return getattr(self._p, name)

    def echelonize(self, A, **kw):
        p = self._p
        if self.how == "half":       # half of the rows left out
            S = A.to_scipy()[:A.n // 2]
            B = p.SparseGFp.from_scipy(S, A.field.p, assume_canonical=True)
            lu = p.echelonize(B, **kw)
            return dataclasses.replace(lu, n=A.n)
        lu = p.echelonize(A, **kw)
        if self.how == "altered":    # one value of U altered where made
            U = lu.U.to_scipy().tocsr()
            U.data[U.nnz // 2] = (U.data[U.nnz // 2] + 1) % A.field.p
            U = p.SparseGFp.from_scipy(U, A.field.p)
            return dataclasses.replace(lu, U=U)
        if self.how == "rank":       # the rank one too high
            return dataclasses.replace(lu, r=lu.r + 1)
        if self.how == "unchanged":  # the input returned as its own form
            rows = np.arange(lu.r)
            U = p.SparseGFp.from_scipy(A.to_scipy()[rows], A.field.p)
            return dataclasses.replace(lu, U=U)
        raise ValueError(self.how)


@pytest.mark.parametrize("how", ["half", "altered", "rank", "unchanged"])
@pytest.mark.parametrize("name", CELLS)
def test_fault_is_not_correct(mini, name, how):
    res = run_cell(mini, name, program=Broken(how))
    assert res["correct"] is False
    assert res["failed"] == res["attempted"]
    assert any(v["value"] > v["limit"] for v in res["checks"].values())


def test_no_jax_loaded(mini):
    """A whole run loads no module named jax, jaxlib, flax or spasm_tpu
    (top-level names compared whole)."""
    code = (
        "import sys; sys.path[:0] = [%r, %r, %r]\n"
        "import test_portbench_run as t, pathlib, harness\n"
        "t.run_cell(pathlib.Path(%r), %r, trace=1)\n"
        "print(harness.forbidden_modules())\n"
        % (conftest.HERE, conftest.PB, conftest.ROOT, str(mini), CELLS[0]))
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=300)
    assert out.returncode == 0, out.stderr[-2000:]
    assert out.stdout.strip().splitlines()[-1] == "[]"


def test_forbidden_names_compared_whole(monkeypatch):
    monkeypatch.setitem(sys.modules, "spasm_tpu_torch_x", sys)
    assert "spasm_tpu" not in harness.forbidden_modules()
    monkeypatch.setitem(sys.modules, "jax.numpy", sys)
    assert "jax" in harness.forbidden_modules()


def test_without_a_card_no_result(tmp_path):
    """No card: exit 1 and nothing on standard output."""
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="")
    out = subprocess.run(
        [sys.executable, os.path.join(conftest.PB, "run.py"), "--workload",
         CELLS[0], "--seed", "1", "--seconds", "1", "--trace", "0"],
        capture_output=True, text=True, cwd=conftest.ROOT, env=env,
        timeout=120)
    assert out.returncode != 0
    assert out.stdout == ""


@pytest.mark.cuda
def test_card_run_of_a_tiny_cell(card, mini):
    """The harness on the card at a tiny size: the kernels build, the run
    is correct and names the card.  (At this size the program may finish
    on the host and hold no device memory.)"""
    import torch

    import spasm_tpu_torch

    files = harness.cell(CELLS[0], here=str(mini / "portbench"),
                         root=str(mini))
    args = argparse.Namespace(workload=CELLS[0], seed=3, seconds=1.0,
                              trace=1)
    res = harness.run(args, device=card, program=spasm_tpu_torch,
                      sync=torch.cuda.synchronize, cell_files=files,
                      log=lambda msg: None)
    assert res["correct"]
    assert res["device"]["platform"] == "gpu"
    assert res["device"]["kind"] == torch.cuda.get_device_name()
