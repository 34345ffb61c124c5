"""The dense finish's staging between the host and its device, on the CPU:

* output: ``ops/dense.extract_u_csr`` builds U's canonical CSR over the
  global columns from the accumulated panel; it equals, array for array
  (indptr, indices, data), the JAX package's ``extract_u_csr`` with its
  columns mapped through ``alive_cols`` and reduced by ``mod_reduce``, which
  is what the program did on the host before;
* input: ``ops/dense.upload_csr`` forms the COO from S's CSR on the device;
  it densifies to the same X as the host COO the program built before (S's
  ``tocoo()``, its columns mapped, its values normalized), entry for entry;
* the count of bytes copied to and from a card is 0 for a finish on CPU
  tensors."""

import jax.numpy as jnp
import numpy as np
import pytest
import scipy.sparse as sp
import torch

from spasm_tpu.field import field
from spasm_tpu.ops import dense as ref_dense
from spasm_tpu.sputil import mod_reduce

from spasm_tpu_torch import SparseGFp, echelonize, last_phase_stats
from spasm_tpu_torch import field as port_field
from spasm_tpu_torch.ops import dense

PRIMES = [2, 3, 42013, 2147483629, 4294967291]


class _F2:
    """GF(2) for ``mod_reduce`` (the fields admit p > 2 only): the balanced
    range is {0, 1}."""
    p = 2

    @staticmethod
    def normalize(x):
        return np.mod(np.asarray(x, np.int64), 2)

    @staticmethod
    def rand(shape, rng):
        return rng.integers(0, 2, size=shape, dtype=np.int64)


def _field(p):
    return _F2() if p == 2 else field(p)


def panel(p, case, seed=0):
    """An accumulated panel as the finish leaves it: Ud (cap, na_b) int32
    whose rows [:r_d] are in full mutual RREF over the first na columns,
    pivot columns pc_map[:r_d] in slot order (not column order), rows past
    r_d and columns past na holding values the extraction must not read;
    ``alive`` (increasing, width columns) maps the finish's columns to U's.

    "mixed": a row holding only its pivot, a free column all zero, zeros
    scattered; "no_free": r_d = na; "empty": r_d = 0; "gaps": as mixed,
    with alive_cols leaving columns out."""
    f = _field(p)
    rng = np.random.default_rng(seed + p % 1000)
    na = 40
    r_d = {"mixed": 29, "no_free": na, "empty": 0, "gaps": 31}[case]
    cap, na_b = r_d + 16, 64
    Ud = f.rand((cap, na_b), rng).astype(np.int64)
    Ud[rng.random(Ud.shape) < 0.3] = 0
    pc = rng.permutation(na)[:r_d]
    Ud[:r_d, pc] = np.eye(r_d, dtype=np.int64)
    free = np.setdiff1d(np.arange(na), pc)
    if case in ("mixed", "gaps"):
        Ud[:r_d, free[2]] = 0            # a free column all zero
        Ud[5, free] = 0                  # a row holding only its pivot
    pc_map = np.zeros(cap, np.int64)
    pc_map[:r_d] = pc
    width = na
    alive = None
    if case == "gaps":
        width = 100
        alive = np.sort(rng.permutation(width)[:na])
    return f, Ud.astype(np.int32), pc_map, r_d, na, alive, width


@pytest.mark.parametrize("case", ["mixed", "no_free", "empty", "gaps"])
@pytest.mark.parametrize("p", PRIMES)
def test_u_csr_matches_reference(p, case):
    f, Ud, pc_map, r_d, na, alive, width = panel(p, case)
    got = dense.extract_u_csr(
        torch.from_numpy(Ud), torch.from_numpy(pc_map), r_d, na,
        None if alive is None else torch.from_numpy(alive.astype(np.int32)))
    U = ref_dense.extract_u_csr(jnp.asarray(Ud),
                                jnp.asarray(pc_map.astype(np.int32)), r_d,
                                na, pc_map[:r_d])
    if alive is not None:
        U = sp.csr_matrix((U.data, alive[U.indices], U.indptr),
                          shape=(r_d, width))
    want = mod_reduce(U, f)
    assert [x.dtype for x in got] == [np.int64, np.int32, np.int32]
    for g, w, name in zip(got, (want.indptr, want.indices, want.data),
                          ("indptr", "indices", "data")):
        np.testing.assert_array_equal(g, w, name)
    indptr, indices, data = got
    assert indptr.size == r_d + 1 and indptr[-1] == indices.size == data.size
    if case == "no_free":
        np.testing.assert_array_equal(data, 1)
    if case in ("mixed", "gaps"):
        assert indptr[6] - indptr[5] == 1      # the pivot-only row
    if r_d:
        # a CSR scipy takes as it is, canonical for from_scipy
        M = sp.csr_matrix((data, indices, indptr), shape=(r_d, width))
        assert M.has_canonical_format


def host_coo(f, S, alive_cols):
    """The host COO the program built before forming it on the device:
    S's tocoo(), its columns through the map of alive_cols, its values
    normalized."""
    colmap = np.full(S.shape[1], -1, np.int64)
    colmap[alive_cols] = np.arange(alive_cols.size)
    Sc = S.tocoo()
    return Sc.row, colmap[Sc.col], f.normalize(Sc.data)


def finish_input(p, case, seed=3):
    """S (scipy CSR) and its alive columns: "int32" canonical data, with
    empty rows; "int64" data outside the balanced range (multiples of p,
    negatives, values over p); "subset" columns without an entry, so that
    alive_cols leaves them out; "dup" a duplicated entry, which densifies as
    a sum."""
    f = port_field(p)
    rng = np.random.default_rng(seed + p % 997)
    n, m = 90, 70
    X = f.rand((n, m), rng)
    X[rng.random(X.shape) < 0.7] = 0
    X[[0, 17, 18, 89]] = 0                        # empty rows
    if case == "subset":
        X[:, [3, 4, 30, 69]] = 0
    S = sp.csr_matrix(X)
    if case == "int32":
        S.data = S.data.astype(np.int32)
    if case == "int64":
        S.data = (S.data.astype(np.int64)
                  + p * rng.integers(-3, 4, S.nnz, dtype=np.int64))
    if case == "dup":
        # the first entry stored twice in its row
        r0 = int(np.searchsorted(S.indptr, 0, side="right")) - 1
        S = sp.csr_matrix((np.insert(S.data, 1, S.data[0]),
                           np.insert(S.indices, 1, S.indices[0]),
                           S.indptr + (np.arange(n + 1) > r0)),
                          shape=(n, m))
    alive = np.flatnonzero(np.bincount(S.indices, minlength=m))
    return f, S, alive


@pytest.mark.parametrize("case", ["int32", "int64", "subset", "dup"])
@pytest.mark.parametrize("p", [3, 42013, 2147483629, 4294967291])
def test_coo_from_csr_densifies_as_the_host_coo(p, case):
    f, S, alive = finish_input(p, case)
    if case == "subset":
        assert alive.size < S.shape[1]
    rows, cols, vals, alive_t = dense.upload_csr(f, S, alive, "cpu")
    assert (alive_t is None) == (alive.size == S.shape[1])
    if alive_t is not None:
        np.testing.assert_array_equal(alive_t.numpy(), alive)
    want = host_coo(f, S, alive)
    for g, w in zip((rows, cols, vals), want):
        np.testing.assert_array_equal(g.numpy(), w)
    assert vals.dtype == torch.int32
    shape = (S.shape[0], alive.size)
    np.testing.assert_array_equal(
        dense.densify_coo(shape, rows, cols, vals, "cpu").numpy(),
        dense.densify_coo(shape, *want, "cpu").numpy())


@pytest.mark.parametrize("fused", [True, False])
def test_no_bytes_counted_on_the_cpu(fused, monkeypatch):
    # a finish over the cutoff on CPU tensors, fused or streaming, copies
    # nothing to a card
    monkeypatch.setattr(dense, "HOST_CUTOFF", 1)
    if not fused:
        monkeypatch.setattr(dense, "FUSED_BUDGET", 0)
    A = SparseGFp.rand(port_field(42013), 300, 260, 0.05,
                       np.random.default_rng(4))
    before = dict(dense.COPY_BYTES)
    lu = echelonize(A, device="cpu", max_round=0)
    stats = last_phase_stats()
    assert lu.r > 0 and stats["finish_rows"] == 300
    assert stats["finish_streamed"] == int(not fused)
    assert stats["finish_copy_bytes"] == 0 and dense.COPY_BYTES == before
