"""The port's device sparse Schur path against the JAX package on the CPU:
``spasm_tpu_torch.ops.sparse_onepass.eliminate_onepass_device`` (its
merge on CPU tiles is the plain version of K3) against the reference's
(CPU ``lax.sort`` path) and the host ``eliminate_against_reduced``,
CSR-exact; and ``echelonize(..., device_sparse_min_nnz=1)`` against the
reference's, equal in every LU array.  GF(p) arithmetic is exact:
tolerance 0."""

import importlib

import numpy as np
import pytest
import scipy.sparse as sp

import spasm_tpu as st
from spasm_tpu import elimination as E
from spasm_tpu import fixtures as fx
from spasm_tpu.csr import SparseGFp
from spasm_tpu.echelonize import _round_schur_estimate
from spasm_tpu.pivots import find_structural_pivots

import spasm_tpu_torch as stt
from spasm_tpu_torch import interop
from test_torch_echelonize import run_both

ref_onepass = importlib.import_module("spasm_tpu.ops.sparse_onepass")
port_onepass = importlib.import_module("spasm_tpu_torch.ops.sparse_onepass")
PRIMES = [3, 42013, 2**31 - 19, 2**32 - 5]
COUNTS = ("classes", "chunks", "device_calls", "host_fallback_rows")
WALLS = ("prep_s", "device_s", "pull_s")


def _round0(A):
    f = A.field
    S = A.to_scipy()
    prows, pcols, _ = find_structural_pivots(A)
    est, S_rest, rest_rows, blk = _round_schur_estimate(f, S, prows, pcols)
    Upart, piv_vals, levels = blk
    Ustar, ok = E.mutual_reduce(f, Upart, pcols, levels)
    assert ok
    return f, Ustar, pcols, sp.csr_matrix(S_rest)


def _csr_equal(a, b):
    a = sp.csr_matrix(a)
    a.sort_indices()
    a.eliminate_zeros()
    return (a.shape == b.shape and np.array_equal(a.indptr, b.indptr)
            and np.array_equal(a.indices, b.indices)
            and np.array_equal(a.data, b.data))


def check_onepass(A, **kw):
    """Port == reference == host on A's round 0; the port's stats
    returned.  None (over budget) must agree too."""
    f, Ustar, pcols, S_rest = _round0(A)
    ref_stats, port_stats = {}, {}
    want = ref_onepass.eliminate_onepass_device(
        f, Ustar, pcols, S_rest, _stats=ref_stats, **kw)
    got = port_onepass.eliminate_onepass_device(
        stt.field(f.p), Ustar, pcols, S_rest, device="cpu",
        _stats=port_stats, **kw)
    if want is None:
        assert got is None
        return None
    Dh, _ = E.eliminate_against_reduced(f, Ustar, pcols, S_rest,
                                        assume_canonical=True)
    assert _csr_equal(Dh, got) and _csr_equal(want, got)
    assert set(port_stats) == set(ref_stats) == set(COUNTS + WALLS)
    assert {k: port_stats[k] for k in COUNTS} == {
        k: ref_stats[k] for k in COUNTS}
    assert all(port_stats[k] >= 0 for k in WALLS)
    return port_stats


@pytest.mark.parametrize("p", PRIMES)
@pytest.mark.parametrize("min_class_rows", [0, 10**9])
def test_onepass_matches_reference_random(p, min_class_rows, rng):
    f = st.field(p)
    done = 0
    for _ in range(3):
        A = SparseGFp.rand(f, int(rng.integers(30, 150)),
                           int(rng.integers(30, 150)), 0.06, rng)
        if len(find_structural_pivots(A)[0]) == 0:
            continue
        stats = check_onepass(A, min_class_rows=min_class_rows)
        done += 1
        if min_class_rows == 0:
            assert stats["device_calls"] == stats["chunks"] > 0
        else:
            assert stats["device_calls"] == 0
    assert done


def test_onepass_zipf_many_classes():
    A = fx.zipf_sparse(st.field(42013), 600, 300, mean_nnz=6.0, seed=3)
    stats = check_onepass(A, min_class_rows=64)
    assert stats["classes"] >= 1 and stats["host_fallback_rows"] > 0


def test_onepass_row_chunking():
    stats = check_onepass(fx.simplex_boundary(14, 5),
                          max_tile_slots=1 << 17, min_class_rows=0)
    assert stats["chunks"] > stats["classes"]


def test_onepass_subcomplex():
    check_onepass(fx.subcomplex_boundary(11, 3, keep=0.8), min_class_rows=0)


@pytest.mark.parametrize("kw", [dict(work_budget=1 << 12),
                                dict(max_tile_slots=1 << 8)])
def test_onepass_over_budget_is_none(kw):
    assert check_onepass(fx.simplex_boundary(12, 5), min_class_rows=0,
                         **kw) is None


@pytest.fixture
def onepass_kw(monkeypatch):
    """Override keyword arguments of eliminate_onepass_device in both
    packages (the echelonize callers pass only the budget); the port's
    stats of each call are collected in the returned list."""
    calls = []

    def apply(**over):
        for mod in (ref_onepass, port_onepass):
            def wrapped(*a, _orig=mod.eliminate_onepass_device,
                        _port=mod is port_onepass, **k):
                k.update(over)
                if _port:
                    k["_stats"] = {}
                    calls.append(k["_stats"])
                return _orig(*a, **k)

            monkeypatch.setattr(mod, "eliminate_onepass_device", wrapped)
        return calls

    return apply


def _default_u(A, **kw):
    fact = stt.echelonize(interop.sparse_from_reference(A), device="cpu",
                          **kw)
    return interop.lu_arrays(fact)["U_data"]


def test_echelonize_device_sparse_boundary(onepass_kw):
    # a class of 2048+ rows reaches the merge at the default
    # min_class_rows
    calls = onepass_kw()
    got = run_both(fx.simplex_boundary(16, 5), device_sparse_min_nnz=1)
    assert got["r"] == fx.expected_boundary_rank(16, 5)
    assert sum(c["device_calls"] for c in calls) > 0
    assert stt.last_phase_stats()["device_s"] > 0


def _random_case():
    # sparse rounds, then the dense finish
    return SparseGFp.rand(st.field(42013), 3000, 3000, 7e-4,
                          np.random.default_rng(42))


@pytest.mark.parametrize("case", ["random", "zipf"])
def test_echelonize_device_sparse_irregular(case, onepass_kw):
    # classes of 64+ rows reach the merge (min_class_rows lowered in
    # both); the zipf rounds stay sparse only below a raised threshold
    calls = onepass_kw(min_class_rows=64)
    if case == "random":
        A, kw = _random_case(), {}
    else:
        A = fx.zipf_sparse(st.field(42013), 600, 300, mean_nnz=3.0, seed=3)
        kw = dict(sparsity_threshold=0.99)
    got, lines, _ = run_both(A, logs=True, device_sparse_min_nnz=1, **kw)
    assert sum(c["device_calls"] for c in calls) > 0
    # the device rounds keep the unreduced U blocks (the default path
    # stores the mutually reduced ones)
    assert not np.array_equal(got["U_data"], _default_u(A, **kw))
    if case == "random":
        assert any("[echelonize/dense] processing" in s for s in lines)


def test_echelonize_device_sparse_reduce_fails():
    # mutual_reduce returns ok=False in round 0: both packages run their
    # device waves on the unreduced block, whose first capacity overflows
    # and whose retry is logged; the logs agree line for line
    A = fx.subcomplex_boundary(20, 6, keep=0.8)
    _, ref_lines, port_lines = run_both(
        A, logs=True, device_sparse_min_nnz=1, enable_dense=False)
    assert any("wave fallback" in s for s in port_lines)
    assert any("capacity overflow" in s for s in port_lines)


def test_echelonize_device_sparse_over_budget(onepass_kw):
    # every round over the merge's budget: the waves on the unreduced
    # block in both packages
    calls = onepass_kw(min_class_rows=0, work_budget=1 << 12)
    A = _random_case()
    got, lines, _ = run_both(A, logs=True, device_sparse_min_nnz=1)
    assert calls and all(c == {} for c in calls)
    assert sum("wave fallback" in s for s in lines) == len(calls)
    assert not np.array_equal(got["U_data"], _default_u(A))


def test_echelonize_device_sparse_ignored_with_L(onepass_kw):
    calls = onepass_kw(min_class_rows=0)
    A = fx.simplex_boundary(12, 5)
    got = run_both(A, L=True, device_sparse_min_nnz=1)
    assert calls == []
    np.testing.assert_array_equal(got["U_data"], _default_u(A, L=True))
