"""Boundary matrices of simplicial complexes over GF(p), unit-scaled.

Frozen copies of the program's fixtures ``simplex_boundary`` and
``subcomplex_boundary`` (``spasm_tpu_torch/_host/fixtures.py``), in plain
NumPy and SciPy: the same faces in the same (colex) order and the same
draws, so a matrix equals the program's own at the same arguments
(``tests/test_portbench_generators.py``).  A change to the program cannot
move this yardstick.

The boundary of the full simplex on n vertices has rank C(n-1, k); that of
a random subcomplex (a ``keep`` share of the k-faces, and every
(k+1)-face whose facets all survive) has irregular row and column weights
and no closed-form rank.  The pool's copies scale the rows and the columns
by nonzero units drawn from the seed: the pattern and the rank stay, the
values leave {-1, 1}.
"""

from __future__ import annotations

from math import comb

import numpy as np
import scipy.sparse as sp


def _combs_colex(n: int, k: int, memo: dict) -> np.ndarray:
    """All ascending k-subsets of range(n), (C(n, k), k) int8, colex order."""
    if n > 127:
        raise ValueError("int8 subset table supports n <= 127")
    key = (n, k)
    if key not in memo:
        if k == 0:
            out = np.zeros((1, 0), np.int8)
        elif k > n:
            out = np.zeros((0, k), np.int8)
        else:
            a = _combs_colex(n - 1, k, memo)
            b = _combs_colex(n - 1, k - 1, memo)
            out = np.empty((a.shape[0] + b.shape[0], k), np.int8)
            out[:a.shape[0]] = a
            out[a.shape[0]:, :k - 1] = b
            out[a.shape[0]:, k - 1] = n - 1
        memo[key] = out
    return memo[key]


def simplex_boundary(n: int, k: int) -> sp.csr_matrix:
    """k-th boundary of the full simplex on n vertices, (C(n, k+1),
    C(n, k)), entries +-1, k+1 a row, rank C(n-1, k)."""
    if not (0 < k < n):
        raise ValueError(f"need 0 < k < n, got k={k}, n={n}")
    R = _combs_colex(n, k + 1, {})
    nr = R.shape[0]
    binom = np.zeros((n, k + 2), np.int64)
    for c in range(n):
        for i in range(1, k + 2):
            binom[c, i] = comb(c, i)
    # removing position t of the ascending (k+1)-subset: the face's colex
    # rank is sum_{i<t} C(c_i, i+1) + sum_{i>t} C(c_i, i), decreasing in t
    indices = np.empty(nr * (k + 1), np.int64)
    sign = np.array([(-1) ** t for t in range(k, -1, -1)], np.int64)
    data = np.tile(sign, nr)
    pos1 = np.arange(1, k + 2, dtype=np.int64)[None, :]
    chunk = 1 << 20
    for r0 in range(0, nr, chunk):
        Rc = R[r0:r0 + chunk]
        A = binom[Rc, pos1]
        B = binom[Rc, pos1 - 1]
        ranks = np.zeros((Rc.shape[0], k + 1), np.int64)
        np.cumsum(A[:, :-1], axis=1, out=ranks[:, 1:])
        ranks[:, :-1] += B[:, ::-1].cumsum(axis=1)[:, -2::-1]
        indices[r0 * (k + 1):(r0 + Rc.shape[0]) * (k + 1)] = (
            ranks[:, ::-1].reshape(-1))
    indptr = np.arange(nr + 1, dtype=np.int64) * (k + 1)
    return sp.csr_matrix((data, indices, indptr), shape=(nr, comb(n, k)))


def subcomplex_boundary(n: int, k: int, keep: float,
                        seed: int) -> sp.csr_matrix:
    """Boundary of the random subcomplex that keeps a ``keep`` share of the
    k-faces (``np.random.default_rng(seed)``) and every (k+1)-face whose
    facets all survive; columns and rows are the surviving faces."""
    if not (0 < keep <= 1):
        raise ValueError(f"need 0 < keep <= 1, got {keep}")
    B = simplex_boundary(n, k)
    rng = np.random.default_rng(seed)
    keep_col = rng.random(B.shape[1]) < keep
    row_ok = np.logical_and.reduceat(keep_col[B.indices], B.indptr[:-1])
    S = B[np.flatnonzero(row_ok)][:, np.flatnonzero(keep_col)]
    S = sp.csr_matrix(S)
    S.sort_indices()
    return S


def unit_scaled(B: sp.csr_matrix, p: int,
                rng: np.random.Generator) -> sp.csr_matrix:
    """D_r B D_c mod p (balanced) with D_r, D_c diagonal of uniform
    nonzero units."""
    dr = rng.integers(1, p, size=B.shape[0])
    dc = rng.integers(1, p, size=B.shape[1])
    rows = np.repeat(np.arange(B.shape[0]), np.diff(B.indptr))
    v = np.mod(B.data.astype(np.int64) * dr[rows], p)
    v = np.mod(v * dc[B.indices], p)
    v = np.where(v > p // 2, v - p, v)
    return sp.csr_matrix((v, B.indices.copy(), B.indptr.copy()),
                         shape=B.shape)


def make_pool(config: dict, traffic: dict, rng: np.random.Generator,
              device=None) -> dict:
    """One complex from the seed, ``traffic['pool']`` unit-scaled copies of its
    boundary, made on the host.  The copies share the base's rank, which
    the reference works out once."""
    p = int(traffic["p"])
    n, k = config["vertices"], config["degree"]
    if config["complex"] == "simplex":
        B = simplex_boundary(n, k)
    else:
        B = subcomplex_boundary(n, k, config["keep"],
                                int(rng.integers(0, 2**63 - 1)))
    B.data = B.data.astype(np.int64)
    mats = [unit_scaled(B, p, rng) for _ in range(traffic["pool"])]
    return {"p": p, "matrices": mats, "bases": [B], "base_of": [0] * len(mats)}
