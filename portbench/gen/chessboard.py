"""Boundary matrices of chessboard complexes over GF(p), sign-scaled.

The chessboard complex M(m, n) has a vertex for each square of an m x n
board and a face for each set of non-attacking rooks (no two in one row or
column).  Its boundary of degree d has a row for each placement of d + 1
rooks and a column for each placement of d rooks, with entry (-1)**t where
the column's placement is the row's less its t-th rook in the order of
the board's rows.  SIMC's Homology group (J.-G. Dumas) holds the family as
``ch<m>-<n>.b<d>``; the definition fixes the matrix up to the order and the
signs of its rows and columns, which leave the pattern's structure and the
rank as they are.

Rows and columns here are placements in lexicographic order of (rows of
the board, columns of the board).  Plain NumPy and SciPy: nothing of the
program.

M(m, n) is (nu - 2)-connected, nu = min(m, n, (m + n + 1) // 3)
(Bjorner, Lovasz, Vrecica and Zivaljevic, 1994), so its reduced homology
vanishes in degrees up to nu - 2 over every field; ``closed_form_rank``
follows from that.  The pool's copies are D_r B D_c with D_r, D_c random
+-1 diagonals from the seed: the values stay +-1 and the pattern, the rank
and the fill of an elimination stay B's, while every call gets a matrix of
its own.
"""

from __future__ import annotations

import itertools
from math import comb, perm

import numpy as np
import scipy.sparse as sp


def placements(m: int, n: int, k: int) -> tuple[np.ndarray, np.ndarray]:
    """The board rows (N, k) and columns (N, k) of every placement of k
    non-attacking rooks on an m x n board, rooks ordered by board row,
    placements in lexicographic order of (rows, columns)."""
    R = np.array(list(itertools.combinations(range(m), k)),
                 np.int64).reshape(-1, k)
    C = np.array(list(itertools.permutations(range(n), k)),
                 np.int64).reshape(-1, k)
    return (np.repeat(R, C.shape[0], axis=0),
            np.tile(C, (R.shape[0], 1)))


def _cells(rows: np.ndarray, cols: np.ndarray, n: int) -> np.ndarray:
    """Each placement as the bit set of the squares it holds (uint64)."""
    bits = np.left_shift(np.uint64(1), (rows * n + cols).astype(np.uint64))
    return np.bitwise_or.reduce(bits, axis=1)


def chessboard_boundary(m: int, n: int, d: int) -> sp.csr_matrix:
    """The degree-d boundary of M(m, n): (placements of d + 1 rooks,
    placements of d rooks), entries +-1, d + 1 a row, int64 CSR with sorted
    indices."""
    if not (1 <= d and d + 1 <= min(m, n)):
        raise ValueError(f"need 1 <= d < min(m, n), got d={d}, m={m}, n={n}")
    if m * n > 64:
        raise ValueError("the squares' bit sets hold boards up to 64 squares")
    rr, rc = placements(m, n, d + 1)
    fr, fc = placements(m, n, d)
    face_keys = _cells(fr, fc, n)
    order = np.argsort(face_keys)
    sorted_keys = face_keys[order]
    row_keys = _cells(rr, rc, n)
    nr = rr.shape[0]
    indices = np.empty((nr, d + 1), np.int64)
    for t in range(d + 1):
        sq = np.left_shift(np.uint64(1),
                           (rr[:, t] * n + rc[:, t]).astype(np.uint64))
        pos = np.searchsorted(sorted_keys, row_keys & ~sq)
        indices[:, t] = order[pos]
    data = np.tile(np.array([(-1) ** t for t in range(d + 1)], np.int64), nr)
    indptr = np.arange(nr + 1, dtype=np.int64) * (d + 1)
    B = sp.csr_matrix((data, indices.reshape(-1), indptr),
                      shape=(nr, fr.shape[0]))
    B.sort_indices()
    return B


def face_count(m: int, n: int, k: int) -> int:
    """Placements of k rooks on an m x n board."""
    return comb(m, k) * perm(n, k)


def closed_form_rank(m: int, n: int, d: int) -> int:
    """rank of the degree-d boundary over any field, where M(m, n) is
    connected enough (d <= nu - 1): the augmented chain complex is exact
    below degree d, so rank b_d = sum_{i < d} (-1)**(d-1-i) f_i, f_i the
    faces of i + 1 rooks, with f_{-1} = 1."""
    nu = min(m, n, (m + n + 1) // 3)
    if d > nu - 1:
        raise ValueError(f"M({m},{n}) is only {nu - 2}-connected: no closed "
                         f"form for degree {d}")
    return sum((-1) ** (d - 1 - i) * face_count(m, n, i + 1)
               for i in range(-1, d))


def sign_scaled(B: sp.csr_matrix, rng: np.random.Generator) -> sp.csr_matrix:
    """D_r B D_c with D_r, D_c diagonals of uniform signs."""
    dr = rng.choice(np.array([-1, 1], np.int64), size=B.shape[0])
    dc = rng.choice(np.array([-1, 1], np.int64), size=B.shape[1])
    rows = np.repeat(np.arange(B.shape[0]), np.diff(B.indptr))
    return sp.csr_matrix((B.data * dr[rows] * dc[B.indices],
                          B.indices.copy(), B.indptr.copy()), shape=B.shape)


def make_pool(config: dict, traffic: dict, rng: np.random.Generator,
              device=None) -> dict:
    """``traffic['pool']`` sign-scaled copies of the configuration's
    boundary, made on the host.  They share its rank, which the reference
    works out once."""
    B = chessboard_boundary(config["rows"], config["cols"], config["degree"])
    mats = [sign_scaled(B, rng) for _ in range(traffic["pool"])]
    return {"p": int(traffic["p"]), "matrices": mats, "bases": [B],
            "base_of": [0] * len(mats)}
