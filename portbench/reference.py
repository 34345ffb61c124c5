"""The plain reference that decides ``correct``.

It imports nothing of the program and takes nothing the program made: it
reads the generated matrices and judges the echelon forms that the timed
calls returned.  An output (rank r, U, its pivot columns Q, the inverse
map qinv and the row origins p) is an exact echelon form of A over GF(p)
when three numbers are 0:

* ``rank_gap``: |r - rank(A)|, rank(A) from ``rank_mod_p`` below, a
  blocked Gaussian elimination in plain PyTorch with exact products;
* ``form_faults``: entries that break the echelon form: Q not r distinct
  columns, qinv not its inverse, p not r distinct rows of A, U[i, Q[i]] not
  1, or U[i, Q[j]] nonzero for some j < i (U[:, Q] is then unit upper
  triangular, so U has rank r);
* ``residual_nonzeros``: the nonzeros left when random combinations of
  the rows of A (drawn from the seed) are reduced against U.  Zero means
  every row of A lies in the row space of U, except with probability
  p**-combos.

With the three at 0 the row spaces of U and A are one space of dimension
r = rank(A).  ``echelon_form(..., arith="float32")`` is the control: a
reduced echelon form by blocked Gauss-Jordan elimination, put in the
program's place, with its products rounded to float32, the step below
exact integer products that would tempt a faster kernel.  With
``arith="exact"`` the same function gives an exact form, which the checks
pass.
"""

from __future__ import annotations

import numpy as np
import scipy.sparse as sp
import torch


def matmul_mod(a: torch.Tensor, b: torch.Tensor, p: int,
               arith: str = "exact") -> torch.Tensor:
    """a @ b mod p for a, b in [0, p).  Exact: float64 products of 16-bit
    limbs, each sum below 2**53 for inner sizes up to 2**21."""
    if arith == "float32":
        return torch.remainder(a @ b, p)
    if a.shape[1] >= 1 << 21:
        raise ValueError("inner size too large for exact float64 limbs")
    f = torch.float64
    if p < 1 << 16:
        return torch.remainder((a.to(f) @ b.to(f)).long(), p)
    ah, al = (a >> 16).to(f), (a & 0xFFFF).to(f)
    bh, bl = (b >> 16).to(f), (b & 0xFFFF).to(f)
    hh = torch.remainder((ah @ bh).long(), p)
    mid = torch.remainder((ah @ bl).long() + (al @ bh).long(), p)
    ll = torch.remainder((al @ bl).long(), p)
    return torch.remainder(
        torch.remainder(torch.remainder(hh * 65536, p) + mid, p) * 65536
        + ll, p)


def _eliminate(W: torch.Tensor, ncols: int, p: int, jordan: bool):
    """Fraction-free elimination of W's first ``ncols`` columns, in place:
    for each column, the first free row with a nonzero becomes its pivot
    row, and every other row r (every free row, or with ``jordan`` every
    row) becomes v * r - W[r, j] * pivot, v the pivot value.  Row scalings
    keep the row space and need no inverse, so the loop runs on the device
    without reading anything back.  A column with no candidate leaves W as
    it is.  Returns the pivot row of each column (-1: none), on the
    device."""
    rows = W.shape[0]
    dev = W.device
    free = torch.ones(rows, dtype=torch.bool, device=dev)
    prow = torch.full((ncols,), -1, dtype=torch.int64, device=dev)
    one = torch.ones(1, dtype=W.dtype, device=dev)
    minus = torch.full((1,), -1, dtype=torch.int64, device=dev)
    for j in range(ncols):
        # 1-element index tensors: a 0-d one would be read back as an int
        col = W[:, j]
        cand = (col != 0) & free
        i = torch.argmax(cand.to(torch.uint8)).view(1)
        has = cand.index_select(0, i)
        v = torch.where(has, col.index_select(0, i), one)
        piv = W.index_select(0, i)
        fac = (col * (has if jordan else free & has)).index_fill_(0, i, 0)
        W.mul_(v).sub_(fac[:, None] * piv).remainder_(p)
        free.index_copy_(0, i, free.index_select(0, i) & ~has)
        prow[j:j + 1] = torch.where(has, i, minus)
    return prow


def _inverse(B: torch.Tensor, p: int) -> torch.Tensor:
    """B^-1 mod p for a nonsingular k x k B, by fraction-free Gauss-Jordan
    on [B | I]: pivot row i_j ends as d_j e_j, so row j of B^-1 is its
    right half over d_j."""
    k = B.shape[0]
    W = torch.cat([B, torch.eye(k, dtype=B.dtype, device=B.device)], 1)
    prow = _eliminate(W, k, p, jordan=True)
    rows = prow.tolist()
    if min(rows) < 0 and B.dtype == torch.int64:
        raise ArithmeticError("pivot block is singular")
    # the control's rounding can leave a column without a pivot: its row
    # of the inverse stays 0
    idx = torch.tensor([max(r, 0) for r in rows], device=B.device)
    d = W[idx, torch.arange(k, device=B.device)].tolist()
    scale = torch.tensor([pow(int(x) % p, p - 2, p) if r >= 0 else 0
                          for r, x in zip(rows, d)], dtype=B.dtype,
                         device=B.device)
    return torch.remainder(W[idx, k:] * scale[:, None], p)


def rank_mod_p(X: torch.Tensor, p: int, panel: int = 256,
               row_block: int = 4096) -> int:
    """Rank of X (n x m, integers in [0, p)) over GF(p), p < 2**31.

    Right-looking blocked elimination: the pivots of a panel of ``panel``
    columns are found by elimination on the panel, and the rows that hold
    none get the Schur complement T_N - P_NC B^-1 T_R, B = P_RC the panel's
    pivot block; the panel's columns and pivot rows then go."""
    if p >= 1 << 31:
        raise ValueError("the reference holds p < 2**31")
    dt = torch.int64
    S = X
    rank = 0
    while S.shape[0] and S.shape[1]:
        b = min(panel, S.shape[1])
        P0 = S[:, :b]
        piv = _eliminate(P0.clone(), b, p, jordan=False).tolist()
        prow = [r for r in piv if r >= 0]
        pcol = [j for j, r in enumerate(piv) if r >= 0]
        k = len(prow)
        rank += k
        T = S[:, b:]
        keep = torch.ones(S.shape[0], dtype=torch.bool, device=S.device)
        if k == 0 or T.shape[1] == 0:
            keep[prow] = False
            S = T[keep]
            continue
        R = torch.tensor(prow, device=S.device)
        C = torch.tensor(pcol, device=S.device)
        Binv = _inverse(P0[R][:, C], p)
        keep[R] = False
        N = torch.nonzero(keep).flatten()
        TR = T[R]
        out = torch.empty((N.numel(), T.shape[1]), dtype=dt, device=S.device)
        for r0 in range(0, N.numel(), row_block):
            Nb = N[r0:r0 + row_block]
            M = matmul_mod(P0[Nb][:, C], Binv, p)
            out[r0:r0 + row_block] = torch.remainder(
                T[Nb] - matmul_mod(M, TR, p), p)
        S = out
    return rank


def dense_unsigned(A: sp.csr_matrix, p: int, device) -> torch.Tensor:
    """A (balanced CSR) as a dense int64 tensor in [0, p) on ``device``."""
    coo = A.tocoo()
    X = torch.zeros(A.shape, dtype=torch.int64, device=device)
    X[torch.from_numpy(coo.row.astype(np.int64)).to(device),
      torch.from_numpy(coo.col.astype(np.int64)).to(device)] = torch.remainder(
        torch.from_numpy(coo.data.astype(np.int64)).to(device), p)
    return X


def reference_rank(A: sp.csr_matrix, p: int, device) -> int:
    X = dense_unsigned(A, p, device)
    try:
        return rank_mod_p(X, p)
    finally:
        del X
        if torch.device(device).type == "cuda":
            torch.cuda.empty_cache()


def echelon_form(A: sp.csr_matrix, p: int, device, arith: str = "exact",
                 panel: int = 256, row_block: int = 4096) -> dict:
    """A reduced echelon form of A as an output the checks judge: rank r,
    U (r x m, U[:, Q] the identity), pivot columns Q in increasing order,
    qinv and the pivot rows p.  Blocked Gauss-Jordan on the dense matrix:
    a panel's pivots are found among the rows that hold none yet, its
    pivot rows are scaled by B^-1 (B their pivot block), and every other
    row loses its panel columns against them.  ``arith="float32"`` is the
    control."""
    if p >= 1 << 31:
        raise ValueError("the reference holds p < 2**31")
    dt = torch.float32 if arith == "float32" else torch.int64
    X = dense_unsigned(A, p, device).to(dt)
    n, m = X.shape
    dev = X.device
    done = torch.zeros(n, dtype=torch.bool, device=dev)
    rows, cols = [], []
    for c0 in range(0, m, panel):
        c1 = min(c0 + panel, m)
        free = torch.nonzero(~done).flatten()
        if free.numel() == 0:
            break
        piv = _eliminate(X[free, c0:c1].clone(), c1 - c0, p,
                         jordan=False).tolist()
        got = [(r, c0 + j) for j, r in enumerate(piv) if r >= 0]
        if not got:
            continue
        R = free[torch.tensor([r for r, _ in got], device=dev)]
        C = torch.tensor([c for _, c in got], device=dev)
        X[R] = matmul_mod(_inverse(X[R][:, C], p), X[R], p, arith)
        done[R] = True
        others = torch.nonzero(torch.ones(n, dtype=torch.bool, device=dev)
                               .index_fill_(0, R, False)).flatten()
        XR = X[R]
        for r0 in range(0, others.numel(), row_block):
            Ob = others[r0:r0 + row_block]
            X[Ob] = torch.remainder(
                X[Ob] - matmul_mod(X[Ob][:, C], XR, p, arith), p)
        rows.append(R)
        cols.append(C)
    R = torch.cat(rows) if rows else torch.zeros(0, dtype=torch.int64)
    Q = (torch.cat(cols) if cols else R).cpu().numpy().astype(np.int64)
    U = X[R.to(dev)]
    U = torch.remainder((U.round() if U.is_floating_point() else U).long(),
                        p)
    U = torch.where(U > p // 2, U - p, U).cpu().numpy()
    del X
    if torch.device(device).type == "cuda":
        torch.cuda.empty_cache()
    qinv = np.full(m, -1, np.int64)
    qinv[Q] = np.arange(Q.size)
    U = sp.csr_matrix(U)
    U.eliminate_zeros()
    return {"r": int(Q.size), "U": U, "piv_cols": Q, "qinv": qinv,
            "p": R.cpu().numpy().astype(np.int64)}


# ---------------------------------------------------------------- checks

def _row_combos(A: sp.csr_matrix, p: int, combos: int,
                rng: np.random.Generator) -> np.ndarray:
    """(combos, m) int64 in [0, p): y @ A for uniform y, exact (16-bit
    limbs of y keep every partial sum of A^T y below 2**63)."""
    n = A.shape[0]
    y = rng.integers(0, p, size=(n, combos), dtype=np.int64)
    At = sp.csr_matrix(A.T, dtype=np.int64)
    hi = np.mod(At @ (y >> 16), p)
    lo = np.mod(At @ (y & 0xFFFF), p)
    return np.mod(np.mod(hi * 65536, p) + lo, p).T.copy()


def form_faults(out: dict, n: int, m: int, p: int) -> int:
    """Entries of the output that break the echelon form (see above)."""
    r, U, Q = out["r"], out["U"], np.asarray(out["piv_cols"], np.int64)
    faults = 0
    if U.shape != (r, m) or Q.shape != (r,):
        return max(1, abs(U.shape[0] - r) + abs(Q.size - r))
    if Q.size and (Q.min() < 0 or Q.max() >= m):
        return int(((Q < 0) | (Q >= m)).sum())
    faults += r - np.unique(Q).size
    qinv = np.full(m, -1, np.int64)
    qinv[Q] = np.arange(r)
    faults += int((np.asarray(out["qinv"], np.int64) != qinv).sum())
    rows = np.asarray(out["p"], np.int64)
    faults += abs(rows.size - r)
    if rows.size:
        faults += int(((rows < 0) | (rows >= n)).sum())
        faults += rows.size - np.unique(rows).size
    Uc = sp.csr_matrix(U).tocoo()
    at = qinv[Uc.col]
    on_q = at >= 0
    vals = np.mod(Uc.data[on_q].astype(np.int64), p)
    ri, ci = Uc.row[on_q], at[on_q]
    diag = ri == ci
    faults += int((vals[diag] != 1).sum())
    faults += r - int(diag.sum())      # a pivot entry that is missing
    faults += int((ci[~diag] < ri[~diag]).sum())
    return faults


def residual_nonzeros(A: sp.csr_matrix, out: dict, p: int, combos: int,
                      rng: np.random.Generator) -> int:
    """Nonzeros left when ``combos`` random combinations of A's rows are
    reduced against U in pivot order (U[:, Q] unit upper triangular)."""
    Z = _row_combos(A, p, combos, rng)
    U = sp.csr_matrix(out["U"], dtype=np.int64)
    U.data = np.mod(U.data, p)
    Q = np.asarray(out["piv_cols"], np.int64)
    r = Q.size
    Uq = U[:, Q]
    if Uq.nnz == r:            # U[:, Q] is the identity: one product
        C = Z[:, Q]
        hi = np.mod((U.T @ (C >> 16).T).T, p)
        lo = (U.T @ (C & 0xFFFF).T).T
        Z = np.mod(Z - np.mod(hi * 65536 + lo, p), p)
        return int(np.count_nonzero(Z))
    ip, ix, dv = U.indptr, U.indices, U.data
    for i in range(r):
        c = Z[:, Q[i]]
        if not c.any():
            continue
        sl = slice(ip[i], ip[i + 1])
        Z[:, ix[sl]] = np.mod(Z[:, ix[sl]] - c[:, None] * dv[None, sl], p)
    return int(np.count_nonzero(Z))
