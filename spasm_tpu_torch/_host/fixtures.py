"""Structured fixture generators for the reference's problem domain.

The reference's target workloads are huge homology boundary matrices
(GL7d/relat class, SURVEY.md section 0).  Those exact matrices are not
available in this environment; the k-th boundary matrix of the FULL
simplex on n vertices is the standard stand-in — same chain-complex
structure (d o d = 0), combinatorially known rank C(n-1, k).

``simplex_boundary`` is fully vectorized AND memory-traffic-lean (this
VM's effective memory bandwidth is low, so traffic dominates wall time
at the 53M-nnz d9 scale):

* faces are ranked by the combinatorial number system (colex rank of an
  ascending k-subset {c_0 < ... < c_{k-1}} is sum_i C(c_i, i+1)); the
  subset table is built once in **int8** (vertices < 128);
* the k+1 face ranks of each row come from two binomial gathers and two
  exclusive cumsums (prefix keeps position weights, suffix shifts them
  down) instead of k+1 `np.delete` passes;
* per row the ranks are strictly DECREASING in the removed position t,
  so emitting them reversed yields canonical CSR directly — no 53M-entry
  lexsort.

Row and column numbering is colex (a permutation of the lex numbering) —
rank/kernel dimensions are invariant under the permutation, and boundary
matrices of consecutive degrees still compose (d o d == 0).
"""

from __future__ import annotations

from math import comb

import numpy as np

from .csr import SparseGFp
from .field import DEFAULT_PRIME, field


def simplex_boundary(n: int, k: int, p: int = DEFAULT_PRIME) -> SparseGFp:
    """k-th boundary matrix of the full simplex on n vertices:
    (C(n, k+1), C(n, k)) with k+1 nonzeros per row, exact rank
    C(n-1, k)."""
    if not (0 < k < n):
        raise ValueError(f"need 0 < k < n, got k={k}, n={n}")
    import scipy.sparse as sp

    R = _combs_colex(n, k + 1)  # (C(n, k+1), k+1) int8, colex order
    nr = R.shape[0]
    binom = np.zeros((n, k + 2), np.int64)
    for c in range(n):
        for i in range(1, k + 2):
            binom[c, i] = comb(c, i)
    # removing position t from the ascending (k+1)-subset leaves
    # positions i < t with weight C(c_i, i+1) and positions i > t shifted
    # down with weight C(c_i, i):
    #   rank_t = sum_{i<t} C(c_i, i+1) + sum_{i>t} C(c_i, i)
    # rank_t strictly decreases in t (removing a smaller element keeps a
    # colex-larger face), so the reversed row is ascending: canonical CSR.
    # Chunked over row blocks: temporaries stay small and page-warm
    # (first-touch faults are the cost on this VM, utils/hostmem.py).
    indices = np.empty(nr * (k + 1), np.int64)
    sign = np.array([(-1) ** t for t in range(k, -1, -1)], np.int64)
    data = np.tile(sign, nr)
    pos1 = np.arange(1, k + 2, dtype=np.int64)[None, :]
    chunk = 1 << 20
    for r0 in range(0, nr, chunk):
        Rc = R[r0:r0 + chunk]
        A = binom[Rc, pos1]        # C(c_i, i+1)
        B = binom[Rc, pos1 - 1]    # C(c_i, i)
        ranks = np.zeros((Rc.shape[0], k + 1), np.int64)
        np.cumsum(A[:, :-1], axis=1, out=ranks[:, 1:])   # exclusive prefix
        ranks[:, :-1] += B[:, ::-1].cumsum(axis=1)[:, -2::-1]
        indices[r0 * (k + 1):(r0 + Rc.shape[0]) * (k + 1)] = (
            ranks[:, ::-1].reshape(-1))
    indptr = np.arange(nr + 1, dtype=np.int64) * (k + 1)
    S = sp.csr_matrix((data, indices, indptr), shape=(nr, comb(n, k)))
    # +-1 entries are already balanced mod any p > 2
    return SparseGFp.from_scipy(S, field(p).p, assume_canonical=True)


def expected_boundary_rank(n: int, k: int) -> int:
    return comb(n - 1, k)


def subcomplex_boundary(n: int, k: int, keep: float = 0.8,
                        seed: int = 0, p: int = DEFAULT_PRIME) -> SparseGFp:
    """Boundary of a RANDOM SUBCOMPLEX of the full simplex: delete a
    random (1-keep) fraction of the k-faces, then every (k+1)-face with a
    deleted facet.  Unlike the full simplex (perfectly uniform weights —
    a best case for Faugere-Lachartre pivot search), the surviving
    k-faces have irregular coface counts and the column pattern is
    random-structured, matching the GL7d/relat workload class better
    (SURVEY.md section 0).  d o d = 0 still holds (it is a complex), so
    certificates/kernels remain meaningful; the rank has no closed form —
    validate against the oracle or certificates.

    Columns are restricted to the surviving k-faces (reindexed dense);
    rows are the surviving (k+1)-faces.
    """
    if not (0 < keep <= 1):
        raise ValueError(f"need 0 < keep <= 1, got {keep}")
    import scipy.sparse as sp

    B = simplex_boundary(n, k, p)
    rng = np.random.default_rng(seed)
    ncol = B.shape[1]
    keep_col = rng.random(ncol) < keep
    # a row survives iff all of its k+1 facets survive (every row of a
    # full-simplex boundary has exactly k+1 entries — no empty rows)
    row_ok = np.logical_and.reduceat(keep_col[B.indices], B.indptr[:-1])
    S = B.to_scipy()[np.flatnonzero(row_ok)][:, np.flatnonzero(keep_col)]
    return SparseGFp.from_scipy(sp.csr_matrix(S), field(p).p,
                                assume_canonical=True)


def zipf_sparse(f_or_p, n: int, m: int, mean_nnz: float = 8.0,
                alpha: float = 1.3, seed: int = 0) -> SparseGFp:
    """Random matrix with ZIPF-SKEWED row weights (a few heavy rows, a
    long tail of light ones) — adversarial for pivot heuristics tuned on
    uniform-weight boundaries (VERDICT r4 'What's weak' item 7)."""
    f = f_or_p if not isinstance(f_or_p, int) else field(f_or_p)
    rng = np.random.default_rng(seed)
    w = rng.zipf(alpha, size=n).astype(np.int64)
    w = np.minimum(w * max(1, int(mean_nnz // 2)), m)
    cols = [np.sort(rng.choice(m, size=int(wi), replace=False))
            for wi in w]
    indptr = np.zeros(n + 1, np.int64)
    np.cumsum(w, out=indptr[1:])
    indices = np.concatenate(cols) if n else np.zeros(0, np.int64)
    data = rng.integers(1, f.p, size=indices.size)
    return SparseGFp(f, n, m, indptr, indices, _balance(data, f.p))


def _balance(v: np.ndarray, p: int) -> np.ndarray:
    r = np.remainder(v, p)
    return np.where(r > p // 2, r - p, r).astype(np.int64)


def mixed_block_matrix(f_or_p, seed: int = 0, scale: int = 1,
                       permute: bool = True) -> SparseGFp:
    """Block-diagonal mix of heterogeneous structures — a small boundary
    block, a random low-rank product (rank-deficient by construction), a
    dense-ish random block and a zipf-skewed hyper-sparse block — under
    random row/column permutations.  Mixed densities + skewed weights +
    hidden low-rank structure exercise pivot search, density estimation
    and the dense/low-rank finishes off the uniform-boundary happy path
    (VERDICT r4 missing item 5).  Rank is validated against the big-int
    oracle / certificates in the tests."""
    import scipy.sparse as sp

    f = f_or_p if not isinstance(f_or_p, int) else field(f_or_p)
    rng = np.random.default_rng(seed)
    s = scale
    bd = simplex_boundary(9, 3, f.p)                    # rank C(8,3)=56
    r_lr = 20 * s
    X = sp.random(80 * s, r_lr, density=0.3, random_state=rng,
                  data_rvs=lambda k: rng.integers(1, min(f.p, 1 << 20), k),
                  dtype=np.int64)
    Y = sp.random(r_lr, 90 * s, density=0.3, random_state=rng,
                  data_rvs=lambda k: rng.integers(1, min(f.p, 1 << 20), k),
                  dtype=np.int64)
    lowrank = SparseGFp.from_scipy(
        (X.astype(np.int64) @ Y.astype(np.int64)).tocsr(), f.p)
    dense = SparseGFp.rand(f, 60 * s, 50 * s, 0.5, rng)
    zipf = zipf_sparse(f, 120 * s, 100 * s, mean_nnz=6.0, seed=seed + 1)
    blocks = [SparseGFp.from_scipy(bd.to_scipy(), f.p), lowrank, dense,
              zipf]
    A = sp.block_diag([b.to_scipy() for b in blocks], format="csr")
    if permute:
        pr = rng.permutation(A.shape[0])
        pc = rng.permutation(A.shape[1])
        A = A[pr][:, pc]
    return SparseGFp.from_scipy(sp.csr_matrix(A), f.p)


def _combs_colex(n: int, k: int, _memo=None) -> np.ndarray:
    """All ascending k-subsets of range(n) as a (C(n, k), k) **int8**
    array in colex order, built by the vectorized recursion
    combs(n, k) = combs(n-1, k) ++ (combs(n-1, k-1) | {n-1})
    (no Python-level iteration over subsets; the memo lives per top-level
    call so the intermediate tables are freed afterwards).  int8 holds
    n <= 128 — an 8x traffic cut that matters at C(26, 10) scale."""
    if n > 127:
        raise ValueError("int8 subset table supports n <= 127")
    if _memo is None:
        _memo = {}
    key = (n, k)
    if key in _memo:
        return _memo[key]
    if k == 0:
        out = np.zeros((1, 0), np.int8)
    elif k > n:
        out = np.zeros((0, k), np.int8)
    else:
        a = _combs_colex(n - 1, k, _memo)
        b = _combs_colex(n - 1, k - 1, _memo)
        nb = b.shape[0]
        out = np.empty((a.shape[0] + nb, k), np.int8)
        out[:a.shape[0]] = a
        out[a.shape[0]:, :k - 1] = b
        out[a.shape[0]:, k - 1] = n - 1
    _memo[key] = out
    return out
