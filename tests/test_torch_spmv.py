"""The port's device SpMV (spasm_tpu_torch.ops.spmv, on CPU tensors)
against spasm_tpu.ops.spmv, and its profiling hooks
(spasm_tpu_torch.utils.profiling).  GF(p) arithmetic is exact: the
products must be equal, tolerance 0."""

import json
import os

import numpy as np
import pytest
import torch

from spasm_tpu import SparseGFp, field
from spasm_tpu.ops import spmv as ref_spmv

from spasm_tpu_torch import interop
from spasm_tpu_torch.ops import spmv
from spasm_tpu_torch.utils import profiling


@pytest.mark.parametrize("p", [42013, 4294967291])
@pytest.mark.parametrize("op", ["xapy", "axpy"])
@pytest.mark.parametrize("with_y", [False, True])
def test_spmv_matches_reference(p, op, with_y):
    f = field(p)
    rng = np.random.default_rng(p % 1000 + with_y)
    A = SparseGFp.rand(f, 300, 200, 0.05, rng)
    A.data[:3] = (f.p - 1) // 2   # the balanced range's extremes
    A.data[3:6] = -((f.p - 1) // 2)
    n_in, n_out = (A.n, A.m) if op == "xapy" else (A.m, A.n)
    x = f.rand(n_in, rng)
    x[:2] = (f.p - 1) // 2
    y = f.rand(n_out, rng) if with_y else None
    want = np.asarray(getattr(ref_spmv, op)(ref_spmv.DeviceCOO.from_csr(A),
                                            x, y))
    D = spmv.DeviceCOO.from_csr(interop.sparse_from_reference(A),
                                device="cpu")
    got = getattr(spmv, op)(D, x, y)
    assert got.dtype == torch.int32 and got.device.type == "cpu"
    np.testing.assert_array_equal(got.numpy(), want)
    # and the host product of the JAX package's SparseGFp
    host = A.xapy(x) if op == "xapy" else A.axpy(x)
    if y is not None:
        host = f.normalize(host.astype(np.int64) + y)
    np.testing.assert_array_equal(got.numpy(), host)


def test_spmv_takes_tensors_and_zero_rows():
    f = field(42013)
    A = SparseGFp.rand(f, 50, 40, 0.0, np.random.default_rng(1))
    D = spmv.DeviceCOO.from_csr(interop.sparse_from_reference(A),
                                device="cpu")
    x = torch.arange(50, dtype=torch.int32)
    assert not spmv.xapy(D, x).any() and spmv.xapy(D, x).shape == (40,)


def test_phase_nesting():
    profiling.reset_phases()
    with profiling.phase("outer"):
        with profiling.phase("inner"):
            pass
    assert [n for n, _ in profiling.phase_records] == ["inner", "outer"]
    assert all(dt >= 0 for _, dt in profiling.phase_records)
    profiling.reset_phases()
    assert profiling.phase_records == []


def test_trace_writes_a_chrome_trace(tmp_path):
    with profiling.trace(str(tmp_path)) as prof:
        torch.ones(64, 64) @ torch.ones(64, 64)
    assert prof.key_averages()
    path = tmp_path / f"trace_{os.getpid()}.json"
    with open(path) as fh:
        events = json.load(fh)["traceEvents"]
    assert any("mm" in str(e.get("name", "")) for e in events)
