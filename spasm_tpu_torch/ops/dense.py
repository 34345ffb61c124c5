"""Dense exact elimination over GF(p): the port of ``spasm_tpu/ops/dense.py``.

The blocked Gauss-Jordan elimination of the reference, on torch tensors:

* the matrix is processed in column panels of width ``c``; a panel's
  Jordan elimination (``_panel_eliminate``, or the K2 kernel on CUDA)
  returns the rank-c correction G with ``row_i_final = X_i + G_i @
  X[prows]``;
* the correction reaches the other columns through ONE exact modular
  matmul (``matmul.modmatmul``, the K1 kernel on CUDA) per group of panels,
  with the group's corrected pivot rows resolved by an exact Neumann
  product.

The reference's ``lax.cond`` / ``while_loop`` become Python control flow
that reads one flag or count back per panel.  Its shape bucketing and nnz
padding are gone: they only avoided XLA recompiles, and zero padding is
pivot-neutral, so the results are the same bits.
"""

from __future__ import annotations

import numpy as np
import scipy.sparse as sp
import torch

from . import modmul
from .matmul import modmatmul

DEFAULT_PANEL = 128


def _panel_eliminate(f, P: torch.Tensor, is_piv_row: torch.Tensor, j0: int,
                     npivcols: int):
    """Plain PyTorch Jordan elimination of the (n, c) panel P whose first
    column is global column j0; only global columns < npivcols may hold
    pivots.  The pivot of column jj is the first non-pivot row with a
    nonzero there.  The scaling is folded into the coefficient
    (beta[pr] = pinv - 1, beta[i] = -P[i, jj] * pinv), so
    ``row_i_final = X_i + G_i @ X[prows]``.

    Returns (P', G, prow, pcol, pfound, is_piv'); slot k of G, prow, pcol
    is the k-th pivot found, unused slots are 0 / 0 / False.  The inputs
    are not modified."""
    n, c = P.shape
    dev = P.device
    P = P.clone()
    is_piv = is_piv_row.clone()
    G = torch.zeros((n, c), dtype=torch.int32, device=dev)
    prow = torch.zeros(c, dtype=torch.int32, device=dev)
    pcol = torch.zeros(c, dtype=torch.int32, device=dev)
    pfound = torch.zeros(c, dtype=torch.bool, device=dev)
    kk = 0
    for jj in range(c):
        if j0 + jj >= npivcols:
            break
        col = P[:, jj].clone()
        cand = torch.nonzero((col != 0) & ~is_piv)
        if cand.numel() == 0:
            continue
        pr = int(cand[0, 0])
        pinv = _balanced(pow(int(col[pr]) % f.p, f.p - 2, f.p), f.p)
        beta = modmul.mul(f, modmul.neg(f, col), pinv)
        beta[pr] = _balanced(pinv - 1, f.p)
        g_row = G[pr].clone()
        g_row[kk] += 1
        P = modmul.add(f, P, modmul.mul(f, beta[:, None], P[pr][None, :]))
        G = modmul.add(f, G, modmul.mul(f, beta[:, None], g_row[None, :]))
        is_piv[pr] = True
        prow[kk] = pr
        pcol[kk] = jj
        pfound[kk] = True
        kk += 1
    return P, G, prow, pcol, pfound, is_piv


def _balanced(v: int, p: int) -> int:
    v %= p
    return v - p if v > p // 2 else v


def _one_panel(f, P, is_piv, j0, npivcols):
    if P.is_cuda:
        from .cuda_panel import panel_eliminate_cuda

        return panel_eliminate_cuda(f, npivcols, P, is_piv, j0)
    return _panel_eliminate(f, P, is_piv, j0, npivcols)


# panels per full-width rank-c correction on CUDA: the K panels of a group
# share ONE whole-matrix matmul; cross-panel consistency inside a group
# comes from small window corrections, and the corrected pivot rows are
# resolved once per group by an exact Neumann inverse of the strictly
# block-lower coefficient matrix
PANEL_GROUP = 4
_FORCE_GROUP = None  # tests override to exercise grouping on the CPU


def rref_inplace(f, X: torch.Tensor, npivcols: int,
                 panel: int = DEFAULT_PANEL):
    """Blocked Jordan RREF of X (n, m) over GF(p).  Only the first
    ``npivcols`` columns are searched for pivots.

    Returns (R, rank, piv_row_of, piv_col_of, is_piv_row): R (n, m), rank
    a Python int, ``piv_row_of[k]`` / ``piv_col_of[k]`` (min(n, npivcols),)
    int64 tensors giving the k-th pivot in column order (-1 past rank), and
    the (n,) pivot-row mask.  X itself is not modified.

    Panels run in groups of PANEL_GROUP on CUDA (1 on the CPU): within a
    group each panel sees the earlier panels' row operations only on its
    own column window and on its pivot rows, and the full-width update
    X += [G_1|..|G_K] @ [R_1;..;R_K] happens once per group.  This is exact,
    so the grouping does not change the result."""
    n, m = X.shape
    dev = X.device
    nmax = min(n, npivcols)
    npan = -(-npivcols // panel)
    group = _FORCE_GROUP or (PANEL_GROUP if X.is_cuda else 1)
    ngrp = -(-npan // group)
    m_pad = max(m, ngrp * group * panel)
    Xp = torch.zeros((n, m_pad), dtype=torch.int32, device=dev)
    Xp[:, :m] = X
    X = Xp
    is_piv = torch.zeros(n, dtype=torch.bool, device=dev)
    prow_of = torch.full((nmax,), -1, dtype=torch.int64, device=dev)
    pcol_of = torch.full((nmax,), -1, dtype=torch.int64, device=dev)
    rank = 0
    zeros_c = torch.zeros(panel, dtype=torch.int64, device=dev)
    for gi in range(ngrp):
        rank_in = rank
        Gs, prows_l, wins, found_l = [], [], [], []
        for k in range(group):
            j0 = (gi * group + k) * panel
            Xwin = X[:, j0:j0 + panel]
            P = Xwin
            # corrected windows of the earlier panels' pivot rows at this
            # panel's columns: R_l|win = Xwin[prows_l] + sum_j C_lj R_j|win.
            # A panel without pivots has G_l == 0 and adds nothing.
            Rwin = []
            for l in range(k):
                rw = None
                if found_l[l]:
                    rw = Xwin[prows_l[l], :]
                    for j in range(l):
                        if found_l[j]:
                            rw = modmul.add(
                                f, rw, modmatmul(f, wins[l][j], Rwin[j]))
                    P = modmul.add(f, P, modmatmul(f, Gs[l], rw))
                Rwin.append(rw)
            # a window with no nonzero is a no-op panel: skip the kernel
            if bool(P.any()):
                _, G, prows, pcols, pfound, is_piv = _one_panel(
                    f, P, is_piv, j0, npivcols)
                prows, pcols = prows.long(), pcols.long()
                nfound = int(pfound.sum())
            else:
                G = torch.zeros((n, panel), dtype=torch.int32, device=dev)
                prows = pcols = zeros_c
                nfound = 0
            # C_kl coefficient blocks for the group-end resolve (unused
            # slots gather row 0; their Gcat columns are zero)
            wins.append([Gs[l][prows, :] for l in range(k)])
            Gs.append(G)
            prows_l.append(prows)
            found_l.append(nfound)
            # found slots are a prefix, in column order within the panel
            prow_of[rank:rank + nfound] = prows[:nfound]
            pcol_of[rank:rank + nfound] = j0 + pcols[:nfound]
            rank += nfound
        if rank > rank_in:   # else Gcat == 0 and X is unchanged
            Gcat = torch.cat(Gs, dim=1)                    # (n, K*c)
            Xrows = X[torch.cat(prows_l), :]
            if group > 1:
                Kc = group * panel
                L = torch.zeros((Kc, Kc), dtype=torch.int32, device=dev)
                for k in range(group):
                    for l in range(k):
                        L[k * panel:(k + 1) * panel,
                          l * panel:(l + 1) * panel] = wins[k][l]
                eye = torch.eye(Kc, dtype=torch.int32, device=dev)
                T = modmul.add(f, eye, L)
                Lp = L
                for _ in range((group - 1).bit_length() - 1):
                    Lp = modmatmul(f, Lp, Lp)
                    T = modmatmul(f, modmul.add(f, eye, Lp), T)
                Rcat = modmatmul(f, T, Xrows)              # (Kc, m_pad)
            else:
                Rcat = Xrows
            X = modmul.add(f, X, modmatmul(f, Gcat, Rcat))
        # early exit: once every row with a nonzero in a pivot-eligible
        # column is a pivot row, the later groups are no-ops
        if rank >= nmax:
            break
        row_nz = (X[:, :npan * panel] != 0).any(dim=1)
        if not bool((row_nz & ~is_piv).any()):
            break
    return X[:, :m], rank, prow_of, pcol_of, is_piv


def _rref(f, X: torch.Tensor, npivcols: int, panel: int,
          want_transform: bool):
    n, m = X.shape
    if want_transform:
        X = torch.cat([X, torch.eye(n, dtype=torch.int32, device=X.device)],
                      dim=1)
    R, rank, prow_of, pcol_of, is_piv = rref_inplace(f, X, npivcols, panel)
    T = R[:, m:] if want_transform else None
    return R[:, :m], rank, prow_of, pcol_of, is_piv, T


# below this element count, the host NumPy elimination is used
HOST_CUTOFF = 1 << 20
# large primes make the host int64 product chunk to a few columns, so the
# crossover drops (same constants as the reference)
HOST_CUTOFF_BIGP = 1 << 16


def host_cutoff_for(f) -> int:
    """Element-count crossover between the host NumPy elimination and the
    tensor path, as a function of the prime (as the reference)."""
    half = max(1, f.p // 2)
    safe_k = max(1, (1 << 62) // (half * half))
    return HOST_CUTOFF if safe_k >= 256 else HOST_CUTOFF_BIGP


def rref(f, X, want_transform: bool = False, panel: int = DEFAULT_PANEL,
         host_cutoff: "int | None" = None, device=None):
    """Dense RREF.  X: (n, m) balanced integers, a numpy array-like or a
    torch tensor.

    Returns a dict of numpy results, as the reference:
      R          (n, m) the reduced row echelon form (rows in original
                 positions)
      rank       int
      piv_rows   (rank,) row index of each pivot, in pivot-column order
      piv_cols   (rank,) strictly increasing pivot columns
      qinv       (m,) qinv[j] = k if column j holds pivot k else -1
      T          (n, n) transform with R = T @ X mod p (if requested)

    Below ``host_cutoff`` elements it runs on the host (NumPy).  Otherwise
    it runs on X's device for a tensor, else on ``device`` (default
    "cuda")."""
    if isinstance(X, torch.Tensor):
        dev = X.device
        Xn = None
    else:
        dev = torch.device(device or "cuda")
        Xn = np.asarray(X)
    n, m = X.shape
    if n == 0 or m == 0:
        return dict(R=np.zeros((n, m), np.int32), rank=0,
                    piv_rows=np.zeros(0, np.int64),
                    piv_cols=np.zeros(0, np.int64),
                    qinv=np.full(m, -1, np.int64),
                    T=np.eye(n, dtype=np.int32) if want_transform else None)
    if host_cutoff is None:
        host_cutoff = host_cutoff_for(f)
    if n * m < host_cutoff:
        if Xn is None:
            Xn = X.cpu().numpy()
        return _host_rref(f, Xn, want_transform)
    panel = min(panel, max(8, m))
    if Xn is None:
        Xd = modmul.normalize(f, X)
    else:
        Xd = modmul.normalize(f, torch.from_numpy(
            np.ascontiguousarray(Xn).astype(np.int64)).to(dev))
    R, rank, prow_of, pcol_of, _, T = _rref(f, Xd, m, panel, want_transform)
    piv_rows = prow_of[:rank].cpu().numpy().astype(np.int64)
    piv_cols = pcol_of[:rank].cpu().numpy().astype(np.int64)
    qinv = np.full(m, -1, np.int64)
    qinv[piv_cols] = np.arange(rank)
    return dict(R=R.cpu().numpy(), rank=rank, piv_rows=piv_rows,
                piv_cols=piv_cols, qinv=qinv,
                T=T.cpu().numpy() if want_transform else None)


def _host_rref(f, X, want_transform: bool):
    """NumPy Gauss-Jordan mod p — exact int64, same output contract (the
    reference's ``_host_rref``)."""
    n, m = X.shape
    A = f.normalize(X).astype(np.int64)
    if want_transform:
        A = np.hstack([A, np.eye(n, dtype=np.int64)])
    is_piv = np.zeros(n, bool)
    piv_rows, piv_cols = [], []
    for j in range(m):
        cand = np.flatnonzero((A[:, j] != 0) & ~is_piv)
        if cand.size == 0:
            continue
        pr = int(cand[0])
        A[pr] = f.mul(A[pr], int(f.inv(A[pr, j])))
        coef = A[:, j].copy()
        coef[pr] = 0
        rows = np.flatnonzero(coef)
        if rows.size:
            A[rows] = f.normalize(A[rows] - coef[rows, None] * A[pr][None, :])
        is_piv[pr] = True
        piv_rows.append(pr)
        piv_cols.append(j)
    rank = len(piv_rows)
    qinv = np.full(m, -1, np.int64)
    qinv[piv_cols] = np.arange(rank)
    return dict(R=A[:, :m].astype(np.int32), rank=rank,
                piv_rows=np.array(piv_rows, np.int64),
                piv_cols=np.array(piv_cols, np.int64), qinv=qinv,
                T=A[:, m:].astype(np.int32) if want_transform else None)


# ---------------- the blocked dense finish ----------------


def densify_coo(shape, rows, cols, vals, device):
    """Scatter COO entries (numpy or tensors) into a dense int32 tensor on
    ``device``; duplicates add, as ``.at[].add`` in the reference."""
    out = torch.zeros(shape, dtype=torch.int32, device=device)
    idx = (torch.as_tensor(rows, dtype=torch.int64).to(device),
           torch.as_tensor(cols, dtype=torch.int64).to(device))
    out.index_put_(idx, torch.as_tensor(vals).to(device, torch.int32),
                   accumulate=True)
    return out


def extract_sparse(X: torch.Tensor):
    """(rows, cols, vals) numpy triples of the nonzeros of X."""
    r, c = torch.nonzero(X, as_tuple=True)
    v = X[r, c]
    return (r.cpu().numpy().astype(np.int64), c.cpu().numpy().astype(np.int64),
            v.cpu().numpy().astype(np.int64))


def count_nonzero_device(X: torch.Tensor) -> int:
    return int(torch.count_nonzero(X))


def _compact_nonpivot(na: int, Ud: torch.Tensor, pc_map: torch.Tensor,
                      r_d: int):
    """The NON-pivot columns of the accumulated mutual-RREF panel Ud[:r_d]:
    in full mutual RREF every pivot column is a unit vector the host
    already knows, so only this block carries information.  Returns
    (compact (r_d, na - r_d), np_idx)."""
    pmask = torch.zeros(na, dtype=torch.bool, device=Ud.device)
    pmask[pc_map[:r_d]] = True
    np_idx = torch.nonzero(~pmask, as_tuple=True)[0]
    return Ud[:r_d, :na][:, np_idx], np_idx


def extract_u_csr(Ud: torch.Tensor, pc_map: torch.Tensor, r_d: int, na: int,
                  piv_cols_loc):
    """Read the accumulated mutual-RREF panel back as scipy CSR (r_d, na):
    the unit pivot entries are synthesized on the host from
    ``piv_cols_loc`` (slot order == Ud row order); only the non-pivot
    columns are scanned and transferred."""
    eye_r = np.arange(r_d, dtype=np.int64)
    eye_c = np.asarray(piv_cols_loc, np.int64)
    if r_d >= na:  # no non-pivot columns: U is exactly the identity part
        return sp.csr_matrix((np.ones(r_d, np.int64), (eye_r, eye_c)),
                             shape=(r_d, na))
    compact, np_idx = _compact_nonpivot(na, Ud, pc_map, r_d)
    er, ec, ev = extract_sparse(compact)
    ec = np_idx.cpu().numpy().astype(np.int64)[ec]
    rows = np.concatenate([eye_r, er])
    cols = np.concatenate([eye_c, ec])
    vals = np.concatenate([np.ones(r_d, np.int64), ev])
    return sp.csr_matrix((vals, (rows, cols)), shape=(r_d, na))


# elements of the accumulated panel back-eliminated per K1 call (2**27:
# one call at the flagship's 8192^2, 1 GiB for each int64 temporary)
SUB_CHUNK = 1 << 27


def blocked_finish_step(f, shape, panel: int, rows, cols, vals,
                        Ud: torch.Tensor, pc_map: torch.Tensor, r_d: int):
    """One step of the blocked dense finish: densify the block's COO slice,
    eliminate it against the accumulated mutual-RREF panel Ud[:r_d] (one
    K1 matmul), Jordan-RREF it, back-eliminate Ud[:r_d] against the new
    pivots and append them.

    shape = (rows of this block, na).  Ud (cap, na) and pc_map (cap,)
    int64 are updated in place (the reference donates them); cap must hold
    r_d plus the block's new rank, and min(rows, cols) of the whole finish
    always does.  Returns (r_d', new_rank, prow_of, pcol_of)."""
    X = densify_coo(shape, rows, cols, vals, Ud.device)
    if r_d:
        coeff = X[:, pc_map[:r_d]]
        X = modmul.sub(f, X, modmatmul(f, coeff, Ud[:r_d]))
    R, new_rank, prow_of, pcol_of, _ = rref_inplace(f, X, shape[1], panel)
    if new_rank:
        newU = R[prow_of[:new_rank]]
        npc = pcol_of[:new_rank]
        if r_d:
            co = Ud[:r_d][:, npc]
            # the subtraction's int64 temporaries are 8x Ud's int32 rows:
            # bound them by updating SUB_CHUNK elements of Ud at a time
            step = max(1, SUB_CHUNK // max(1, Ud.shape[1]))
            for i in range(0, r_d, step):
                j = min(r_d, i + step)
                Ud[i:j] = modmul.sub(f, Ud[i:j], modmatmul(f, co[i:j], newU))
        Ud[r_d:r_d + new_rank] = newU
        pc_map[r_d:r_d + new_rank] = npc
    return r_d + new_rank, new_rank, prow_of, pcol_of
