"""The port's solve.py (spasm_tpu_torch, device="cpu") against the JAX
package's spasm_tpu.solve on the CPU: kernel bases, RREF, solve / gesv,
the sparse and dense triangular solves, the complete RREF factorization,
the corner-block inverse through ops/dense.rref's tensor path, and LU
files and arrays carried between the packages.  GF(p) arithmetic is exact,
so every comparison has tolerance 0."""

import functools

import numpy as np
import pytest

import spasm_tpu as st
from spasm_tpu import SparseGFp, field
from spasm_tpu import fixtures as fx
from spasm_tpu.ops import dense as ref_dense

import spasm_tpu_torch as stt
from spasm_tpu_torch import interop
from spasm_tpu_torch.ops import dense as port_dense

F = field(42013)
# one prime of each arithmetic tier: p <= 92681, < 2**31, < 2**32
PRIMES = (42013, 2147483629, 4294967291)


def port(A):
    return interop.sparse_from_reference(A)


def both(A, **kw):
    """(reference LU, port LU on the CPU) of A, with equal arrays."""
    want = st.echelonize(A, **kw)
    got = stt.echelonize(port(A), device="cpu", **kw)
    assert_lu_equal(got, want)
    return want, got


def assert_lu_equal(got, want):
    a, b = interop.lu_arrays(got), interop.lu_arrays(want)
    assert set(a) == set(b)
    for k in b:
        np.testing.assert_array_equal(a[k], b[k], k)


def assert_sparse_equal(got, want):
    assert isinstance(got, stt.SparseGFp)
    assert got.shape == want.shape and got.field.p == want.field.p
    for name in ("indptr", "indices", "data"):
        np.testing.assert_array_equal(getattr(got, name),
                                      getattr(want, name), name)


def consistent_rhs(f, A, k, rng):
    """k rows x0 @ A (so solvable) as a reference SparseGFp."""
    X0 = SparseGFp.rand(f, k, A.n, 0.5, rng)
    return X0 @ A


def cases():
    return {
        "random": lambda p: SparseGFp.rand(field(p), 40, 52, 0.08,
                                           np.random.default_rng(1)),
        "low_rank": lambda p: (SparseGFp.rand(field(p), 36, 6, 0.5,
                                              np.random.default_rng(2))
                               @ SparseGFp.rand(field(p), 6, 30, 0.5,
                                                np.random.default_rng(3))),
        "boundary": lambda p: fx.simplex_boundary(9, 4) if p == 42013
        else None,
    }


CASES = [(name, p) for name in cases() for p in PRIMES
         if not (name == "boundary" and p != 42013)]


def make(name, p):
    return cases()[name](p)


@pytest.mark.parametrize("name,p", CASES)
def test_kernel_rref_and_pivots_match_reference(name, p):
    A = make(name, p)
    want, got = both(A)
    assert_sparse_equal(stt.kernel(got), st.kernel(want))
    R, q = stt.rref(got)
    R0, q0 = st.rref(want)
    assert_sparse_equal(R, R0)
    np.testing.assert_array_equal(q, q0)
    assert_sparse_equal(stt.rref_of_U(got), R0)
    assert_sparse_equal(stt.kernel_from_rref(R, q),
                        st.kernel_from_rref(R0, q0))
    # the one-stop forms echelonize on their own
    assert_sparse_equal(stt.kernel(port(A), device="cpu"), st.kernel(A))
    k, hit = stt.kernel_pivots(port(A), device="cpu")
    k0, hit0 = st.kernel_pivots(A)
    assert_sparse_equal(k, k0)
    np.testing.assert_array_equal(hit, hit0)
    assert stt.rank(got) == stt.rank(port(A), device="cpu") == st.rank(A)


@pytest.mark.parametrize("name,p", CASES)
def test_solve_and_gesv_match_reference(name, p):
    f = field(p)
    rng = np.random.default_rng(4)
    A = make(name, p)
    want, got = both(A, L=True)
    x0 = f.rand(A.n, rng)
    b = A.xapy(x0)
    x = stt.solve(got, b)
    np.testing.assert_array_equal(x, st.solve(want, b))
    np.testing.assert_array_equal(A.xapy(x), b)
    bad = f.rand(A.m, rng)
    assert (stt.solve(got, bad) is None) == (st.solve(want, bad) is None)
    if want.r < A.m:
        assert stt.solve(got, bad) is None
    # gesv: consistent rows, then random (inconsistent) rows
    B = consistent_rhs(f, A, 5, rng).vstack(SparseGFp.rand(f, 3, A.m, 0.6,
                                                           rng))
    X, ok = stt.gesv(got, port(B))
    X0, ok0 = st.gesv(want, B)
    assert_sparse_equal(X, X0)
    np.testing.assert_array_equal(ok, ok0)
    assert ok[:5].all()


@pytest.mark.parametrize("name,p", CASES)
def test_sparse_triangular_solve_and_truediv_match_reference(name, p):
    f = field(p)
    rng = np.random.default_rng(5)
    A = make(name, p)
    want, got = both(A)
    B = SparseGFp.rand(f, 4, want.r, 0.5, rng) @ want.U
    X = stt.sparse_triangular_solve(got, port(B))
    assert_sparse_equal(X, st.sparse_triangular_solve(want, B))
    assert_sparse_equal(port(B) / got, B / want)
    assert_sparse_equal(stt.sparse_triangular_solve(got.U, port(B),
                                                    got.qinv), X)
    assert_sparse_equal(port(A) / got, A / want)
    if want.r < A.m:
        free = int(np.flatnonzero(want.qinv < 0)[0])
        Bad = SparseGFp.from_coo(f, 1, A.m, [0], [free], [1])
        assert st.sparse_triangular_solve(want, Bad) is None
        assert port(Bad) / got is None


def _lower(p, n, rng):
    f = field(p)
    d = np.tril(f.normalize(rng.integers(-(p // 2), p // 2 + 1, (n, n))))
    np.fill_diagonal(d, f.normalize(rng.integers(1, p, n)))
    perm = rng.permutation(n)
    shuffled = np.zeros_like(d)
    shuffled[perm] = d
    return shuffled, perm


@pytest.mark.parametrize("p", PRIMES)
def test_dense_triangular_solves_match_reference(p):
    f = field(p)
    rng = np.random.default_rng(6)
    n = 24
    d, perm = _lower(p, n, rng)
    L0 = SparseGFp.from_dense(d, p)
    x = f.normalize(rng.integers(-(p // 2), p // 2 + 1, n))
    b = L0.xapy(x)
    got = stt.dense_back_solve(port(L0), b, perm)
    np.testing.assert_array_equal(got, st.dense_back_solve(L0, b, perm))
    np.testing.assert_array_equal(f.normalize(got), x)
    u = np.triu(f.normalize(rng.integers(-(p // 2), p // 2 + 1, (n, n))))
    np.fill_diagonal(u, 1)
    U0 = SparseGFp.from_dense(u, p)
    b = U0.xapy(x)
    got = stt.dense_forward_solve(port(U0), b, np.arange(n))
    np.testing.assert_array_equal(
        got, st.dense_forward_solve(U0, b, np.arange(n)))
    # a right-hand side with no solution
    L1 = SparseGFp.from_dense([[1, 0], [3, 0]], p)
    assert stt.dense_back_solve(port(L1), np.array([0, 1]),
                                np.array([0, 1])) is None
    assert st.dense_back_solve(L1, np.array([0, 1]), np.array([0, 1])) \
        is None


@pytest.mark.parametrize("L", [False, True])
@pytest.mark.parametrize("name", ["random", "low_rank", "boundary"])
def test_complete_matches_reference(name, L):
    rng = np.random.default_rng(7)
    A = make(name, 42013)
    want, got = both(A, complete=True, L=L)
    assert got.complete and got.U == stt.rref(stt.echelonize(
        port(A), device="cpu"))[0]
    if L:
        assert got.L @ got.U == port(A)
        b = A.xapy(F.rand(A.n, rng))
        np.testing.assert_array_equal(stt.solve(got, b), st.solve(want, b))
        B = consistent_rhs(F, A, 3, rng)
        X, ok = stt.gesv(got, port(B))
        X0, ok0 = st.gesv(want, B)
        assert_sparse_equal(X, X0)
        np.testing.assert_array_equal(ok, ok0)


@pytest.fixture
def tensor_path_rref(monkeypatch):
    """ops/dense.rref of both packages with host_cutoff=0, so the
    corner-block inverse of small cases takes the tensor path (the JAX
    package's jitted RREF; the port's rref_inplace); records the port's
    calls."""
    calls = []
    port_rref = port_dense._rref

    def spy(f, X, npivcols, panel, want_transform):
        calls.append((tuple(X.shape), want_transform))
        return port_rref(f, X, npivcols, panel, want_transform)

    monkeypatch.setattr(ref_dense, "rref",
                        functools.partial(ref_dense.rref, host_cutoff=0))
    monkeypatch.setattr(port_dense, "rref",
                        functools.partial(port_dense.rref, host_cutoff=0))
    monkeypatch.setattr(port_dense, "_rref", spy)
    return calls


@pytest.mark.parametrize("case", ["mixed", "max_round_0", "complete"])
def test_corner_inverse_on_the_tensor_path(case, tensor_path_rref):
    rng = np.random.default_rng(8)
    kw = dict(L=True)
    if case == "mixed":
        A = fx.mixed_block_matrix(F, seed=1)
    else:
        A = SparseGFp.rand(F, 60, 70, 0.06, np.random.default_rng(9))
        kw.update(max_round=0) if case == "max_round_0" else kw.update(
            complete=True)
    want, got = both(A, **kw)
    ds = got.dense_piv_start
    assert ds is not None and got.r - ds >= 40
    b = A.xapy(F.rand(A.n, rng))
    x = stt.solve(got, b)
    np.testing.assert_array_equal(x, st.solve(want, b))
    np.testing.assert_array_equal(A.xapy(x), b)
    # the port inverted D = Lp[ds:, ds:] once, by the RREF of (D | I)
    k = got.r - ds
    assert tensor_path_rref == [((k, k), True)]
    np.testing.assert_array_equal(got._dinv_cache, want._dinv_cache)
    B = consistent_rhs(F, A, 4, rng).vstack(SparseGFp.rand(F, 2, A.m, 0.5,
                                                           rng))
    X, ok = stt.gesv(got, port(B))
    X0, ok0 = st.gesv(want, B)
    assert_sparse_equal(X, X0)
    np.testing.assert_array_equal(ok, ok0)
    assert tensor_path_rref == [((k, k), True)]  # cached on the LU


def test_solves_on_the_reference_factorization(tensor_path_rref):
    # the JAX package's LU, carried over as arrays, drives the port's
    # solves apart from the port's echelonize
    rng = np.random.default_rng(10)
    A = fx.mixed_block_matrix(F, seed=2)
    want = st.echelonize(A, L=True)
    got = interop.lu_from_arrays(interop.lu_arrays(want), device="cpu")
    assert got._device == "cpu"
    assert_lu_equal(got, want)
    b = A.xapy(F.rand(A.n, rng))
    np.testing.assert_array_equal(stt.solve(got, b), st.solve(want, b))
    assert tensor_path_rref
    B = consistent_rhs(F, A, 3, rng)
    X, ok = stt.gesv(got, port(B))
    X0, ok0 = st.gesv(want, B)
    assert_sparse_equal(X, X0)
    np.testing.assert_array_equal(ok, ok0)
    assert_sparse_equal(stt.kernel(got), st.kernel(want))


@pytest.mark.parametrize("kw", [dict(), dict(L=True),
                                dict(L=True, complete=True)])
def test_lu_files_load_in_the_other_package(kw, tmp_path):
    rng = np.random.default_rng(11)
    A = SparseGFp.rand(F, 50, 44, 0.1, np.random.default_rng(12))
    want, got = both(A, **kw)
    st.save_lu(str(tmp_path / "ref.npz"), want)
    stt.save_lu(str(tmp_path / "port.npz"), got)
    from_ref = stt.load_lu(str(tmp_path / "ref.npz"), device="cpu")
    from_port = st.load_lu(str(tmp_path / "port.npz"))
    assert from_ref._device == "cpu"
    assert stt.load_lu(str(tmp_path / "ref.npz"))._device == "cuda"
    assert_lu_equal(from_ref, want)
    assert_lu_equal(from_port, got)
    np.testing.assert_array_equal(from_ref.levels, want.levels)
    np.testing.assert_array_equal(from_port.levels, got.levels)
    assert_sparse_equal(stt.kernel(from_ref), st.kernel(from_port))
    if kw.get("L"):
        b = A.xapy(F.rand(A.n, rng))
        np.testing.assert_array_equal(stt.solve(from_ref, b),
                                      st.solve(from_port, b))


def test_lu_arrays_round_trip():
    A = fx.mixed_block_matrix(F, seed=3)
    fact = stt.echelonize(port(A), device="cpu", L=True)
    back = interop.lu_from_arrays(interop.lu_arrays(fact), device="cpu")
    assert_lu_equal(back, fact)
    assert back.L == fact.L and back.U == fact.U


def test_solve_requires_L():
    A = SparseGFp.rand(F, 10, 12, 0.3, np.random.default_rng(13))
    _, got = both(A)
    with pytest.raises(ValueError, match="with L"):
        stt.solve(got, np.zeros(12, np.int64))
    with pytest.raises(ValueError, match="with L"):
        stt.gesv(got, stt.SparseGFp.zeros(got.field, 1, 12))
