"""The dense finish's tail check (``echelonize._tail_is_dependent``) on CPU
tensors: a tail with a single row outside the row space found so far is
never skipped, a dependent tail is, the sparse product behind the samples
is exact at every prime tier, and the boundary on which the earlier check
(16 rows a sample) lost rank keeps it."""

import importlib
import math

import numpy as np
import pytest
import scipy.sparse as sp
import torch

import spasm_tpu_torch as stt
from spasm_tpu_torch._host import fixtures
from spasm_tpu_torch._host.field import field

ech = importlib.import_module("spasm_tpu_torch.echelonize")

PRIMES = (42013, 2147483629, 4294967291)


def _finish_coo(f, rng, head, n_tail, outside, r=60, na=240):
    """A finish's COO sorted by row: ``head`` processed rows of noise, then
    ``n_tail`` rows that each combine 3 rows of U (r x na, identity at
    its pivot columns), one of them, with ``outside``, plus a multiple of a
    unit vector off the pivot columns.  Returns the COO, U and its pivot
    columns."""
    piv = np.sort(rng.choice(na, r, replace=False))
    free = np.setdiff1d(np.arange(na), piv)
    U = np.zeros((r, na), np.int64)
    U[:, piv] = np.eye(r, dtype=np.int64)
    U[:, free] = f.rand((r, free.size), rng)
    tail = np.zeros((n_tail, na), np.int64)
    for _ in range(3):
        c = f.rand(n_tail, rng)
        tail = f.normalize(tail + f.mul(c[:, None], U[rng.integers(0, r,
                                                                 n_tail)]))
    if outside:
        i = rng.integers(0, n_tail)
        tail[i, free[rng.integers(0, free.size)]] += 1 + rng.integers(
            0, f.p - 1)
        tail[i] = f.normalize(tail[i])
    X = np.vstack([f.rand((head, na), rng), tail])
    C = sp.csr_matrix(X).tocoo()
    return (C.row.astype(np.int64), C.col.astype(np.int64),
            f.normalize(C.data)), U, piv


def _check(f, coo, head, n_s, U, piv):
    """``_tail_is_dependent`` on CPU tensors of the tail's COO (the rows
    from ``head`` on), as the streaming loop calls it."""
    rows, cols, vals = coo
    lo = np.searchsorted(rows, head)
    return ech._tail_is_dependent(
        f, torch.from_numpy(rows[lo:]), torch.from_numpy(cols[lo:]),
        torch.from_numpy(vals[lo:].astype(np.int32)), head, n_s, U.shape[1],
        torch.from_numpy(U.astype(np.int32)), torch.from_numpy(piv))


@pytest.mark.parametrize("p", PRIMES)
@pytest.mark.parametrize("outside", [True, False])
def test_one_row_outside_the_row_space_is_caught(p, outside):
    """10,000 tail rows in the row space of U and, with ``outside``, one
    more row outside it: the check says dependent exactly when there is
    none.  (Samples of 16 rows each, as the reference's, miss the one row
    in 8 samples with probability about 0.99.)"""
    f = field(p)
    rng = np.random.default_rng(p % 1000 + outside)
    head, n_tail = 500, 10_000 + outside
    coo, U, piv = _finish_coo(f, rng, head, n_tail, outside)
    assert _check(f, coo, head, head + n_tail, U, piv) is (not outside)


@pytest.mark.parametrize("p", PRIMES)
def test_samples_reach_the_bound(p):
    """p**-samples <= 2**-64, with no sample to spare."""
    s = ech._tail_samples(p)
    assert s * math.log2(p) >= 64 > (s - 1) * math.log2(p)
    assert s == {42013: 5}.get(p, 3)


@pytest.mark.parametrize("p", PRIMES)
def test_device_sample_product_is_exact(p, monkeypatch):
    """``_combine_rows_on`` (the tail check's samples) against big
    integers at the extreme balanced values, over chunks of 1000
    entries."""
    monkeypatch.setattr(ech, "TAIL_CHUNK", 1000)
    f = field(p)
    rng = np.random.default_rng(6)
    k, na, s = 3000, 24, ech._tail_samples(p)
    ext = np.array([f.halfp, f.mhalfp], np.int64)
    C = ext[rng.integers(0, 2, (s, k))]
    T = sp.random(k, na, density=0.5, format="coo", random_state=8)
    T.data = ext[rng.integers(0, 2, T.nnz)]
    want = (C.astype(object) @ T.toarray().astype(object)) % p
    got = ech._combine_rows_on(
        f, torch.from_numpy(C), torch.from_numpy(T.row.astype(np.int64)),
        torch.from_numpy(T.col.astype(np.int64)),
        torch.from_numpy(T.data.astype(np.int32)), na)
    np.testing.assert_array_equal(f.to_unsigned(got.numpy()),
                                  want.astype(np.int64))


@pytest.mark.parametrize("outside", [True, False])
def test_chunked_device_check(outside, monkeypatch):
    """Over chunks of 4,096 tail entries the check still catches the one
    row outside the row space, and skips a dependent tail."""
    monkeypatch.setattr(ech, "TAIL_CHUNK", 4096)
    f = field(42013)
    rng = np.random.default_rng(3 + outside)
    head, n_tail = 500, 10_000 + outside
    coo, U, piv = _finish_coo(f, rng, head, n_tail, outside)
    assert _check(f, coo, head, head + n_tail, U, piv) is (not outside)


def test_subcomplex_keeps_its_rank():
    """The random subcomplex boundary (20, 6, keep 0.9), seed 0: two host
    rounds, then 14,584 rows for the streaming finish, of which the
    earlier tail check skipped 11,584 after three blocks and lost 3 of
    the rank (23,346).  The exact check skips only the last 584 rows.
    The rank is held against the sparse path's on the same input (no
    dense finish, so no tail check): 23,349."""
    A = fixtures.subcomplex_boundary(20, 6, 0.9, seed=0)
    lu = stt.echelonize(A, device="cpu")
    st = stt.last_phase_stats()
    assert lu.r == stt.echelonize(A, device="cpu", enable_dense=False).r
    assert (st["rounds"], st["finish_streamed"]) == (2, 1)
    assert st["finish_rows"] == 14_584
    assert 0 < st["finish_rows_skipped"] < 11_584
