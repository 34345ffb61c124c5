"""Batched elimination against an ordered pivot set — the TPU-native
replacement for the reference's per-row sparse triangular solve
(``spasm_triangular.c`` / ``spasm_reach.c`` DFS, src/SpaSM.jl:623-722)
and the sparse Schur inner loop (``spasm_scatter.c``, src/SpaSM.jl:619).

Given pivot rows U (unit pivots, one per pivot column, listed in an
elimination order where only *earlier* pivots have entries in a pivot's
column — guaranteed by the append invariant, see pivots.py), elimination of
any set of rows B proceeds in **level waves**:

    level(k) = 1 + max{ level(l) : l < k, U[l, col(k)] != 0 }   (else 0)

All pivots of one level have final coefficients simultaneously, so a wave is
one sparse matmul:  B <- B - B[:, cols(level t)] @ U[level t].  The number
of waves is the elimination-DAG depth, not the pivot count — each wave is a
large batched SpGEMM (host scipy here; the dense/device variant runs the
same schedule with MXU modular matmuls in schur.py/ops.dense).
"""

from __future__ import annotations

import numpy as np
import scipy.sparse as sp

from .csr import SparseGFp
from .field import Field
from .sputil import mod_reduce, safe_spgemm


def pivot_graph_edges(U, piv_cols):
    """Edges (l -> k) of the elimination DAG: pivot l's row touches pivot
    k's column.  U: SparseGFp (r x m), piv_cols: (r,).  Returns (src, dst)
    arrays."""
    r, m = U.shape
    qinv = np.full(m, -1, np.int64)
    qinv[piv_cols] = np.arange(r)
    if hasattr(U, "rows_expanded"):
        rows = U.rows_expanded()
    else:  # scipy csr
        rows = np.repeat(np.arange(r, dtype=np.int64), np.diff(U.indptr))
    hit = qinv[U.indices]
    mask = (hit >= 0) & (hit != rows)
    return rows[mask], hit[mask]


def compute_levels(U, piv_cols, require_order=True):
    """Level (longest path depth) of each pivot in the elimination DAG.

    If require_order, asserts edges only go from earlier to later pivots
    (the append invariant); otherwise the caller must pass a topologically
    sorted U (see topo_order).  U may be a SparseGFp or a scipy csr."""
    r, m = U.shape
    if require_order:
        # one sequential pass straight off the CSR (csrc/pivot_scan.c):
        # no edge materialization, order violations raise as below
        from .native import levels_from_csr_native

        qinv = np.full(m, -1, np.int64)
        qinv[np.asarray(piv_cols, np.int64)] = np.arange(r)
        levels = levels_from_csr_native(U.indptr, U.indices, qinv, r)
        if levels is not None:
            return levels
    src, dst = pivot_graph_edges(U, piv_cols)
    if require_order and src.size and not (src < dst).all():
        raise ValueError("pivot list is not in elimination order")
    # edges arrive sorted by src (rows_expanded order), and src < dst, so
    # ONE sequential pass computes exact longest-path levels (the native
    # kernel); the vectorized fixpoint below is the fallback.
    from .native import levels_from_sorted_edges, scatter_max

    levels = levels_from_sorted_edges(src, dst, r)
    if levels is not None:
        return levels
    levels = np.zeros(r, np.int64)
    # longest-path by fixpoint: depth iterations, each fully vectorized
    for _ in range(r + 1):
        cand = levels[src] + 1
        new = levels.copy()
        scatter_max(new, dst, cand)
        if np.array_equal(new, levels):
            return levels
        levels = new
    raise ValueError("pivot graph has a cycle")  # unreachable when ordered


def topo_order(U, piv_cols):
    """Topological order of a general permuted-triangular pivot set (Kahn).
    Raises ValueError if the set has an alternating cycle."""
    r = U.shape[0]
    src, dst = pivot_graph_edges(U, piv_cols)
    indeg = np.zeros(r, np.int64)
    np.add.at(indeg, dst, 1)
    order_of_src = np.argsort(src, kind="stable")
    src_s, dst_s = src[order_of_src], dst[order_of_src]
    starts = np.searchsorted(src_s, np.arange(r + 1))
    out = []
    ready = list(np.flatnonzero(indeg == 0))
    while ready:
        l = ready.pop()
        out.append(l)
        for k in dst_s[starts[l]:starts[l + 1]]:
            indeg[k] -= 1
            if indeg[k] == 0:
                ready.append(int(k))
    if len(out) != r:
        raise ValueError("pivot set is not cycle-free")
    return np.array(out, np.int64)


def mutual_reduce(f: Field, U_sp, piv_cols, levels,
                  fill_cap: "float | None" = 16.0):
    """Bring the pivot block into FULL MUTUAL REDUCED form: every row has
    zero at every *other* pivot's column.  Against such a U*, eliminating
    any row set B is a single product — B - B[:, piv_cols] @ U* — because
    each coefficient is read directly off B (no cascade).  This is the
    sparse analog of the dense finish's accumulated mutual-RREF panel
    (ops/dense.py) and replaces a depth-deep wave cascade over the
    (usually much larger) remaining-row set with a cascade over the r
    pivot rows only, done once and reused.

    Returns (Ustar, ok): ok=False when the reduced form exceeded
    ``fill_cap`` x nnz(U) (fill blow-up — caller falls back to waves).
    """
    r, m = U_sp.shape
    if r == 0:
        return U_sp, True
    piv_cols = np.asarray(piv_cols, np.int64)
    depth = int(levels.max()) + 1
    if depth <= 1:
        return U_sp, True
    order = np.argsort(levels, kind="stable")  # rows sorted by level
    lev_sorted = levels[order]
    pc_sorted = piv_cols[order]
    offs = np.searchsorted(lev_sorted, np.arange(depth + 1))
    nnz_cap = (None if fill_cap is None
               else max(1024, int(fill_cap * max(1, U_sp.nnz))))
    # one-call kernel (csrc/mutual_mod.c): each row finalized exactly once
    # against already-final higher-level rows; the level permutation is
    # applied inside the kernel on read and undone on write, so neither
    # the sorted gather of U nor the inverse gather of the (bigger)
    # result is ever materialized.  The per-level sweep below is the
    # fallback (and the reference for the bit-identical equivalence test).
    from .native import mutual_reduce_native

    U_csr = sp.csr_matrix(U_sp)
    qinv_glob = np.full(m, -1, np.int64)
    qinv_glob[pc_sorted] = np.arange(r)
    out = mutual_reduce_native(f, U_csr, qinv_glob, offs, depth, nnz_cap,
                               rowperm=order)
    if out is False:
        return U_sp, False
    if out is not None:
        return out, True
    W = U_csr[order]
    # backward sweep: once level t is final, reduce all lower levels
    # against it in one product.  The active prefix shrinks every sweep;
    # finalized level blocks are stacked ONCE at the end (a per-sweep
    # vstack would copy the whole matrix depth times).
    out = _mutual_reduce_native(f, W, pc_sorted, offs, depth, nnz_cap)
    if out is not None:
        W2, ok = out
        if not ok:
            return U_sp, False
        inv_order = np.argsort(order, kind="stable")
        return W2[inv_order], True
    final_blocks = []
    nnz_final = 0
    for t in range(depth - 1, 0, -1):
        lo, hi = offs[t], offs[t + 1]
        Ut = sp.csr_matrix(W[lo:hi])
        final_blocks.append(Ut)
        nnz_final += Ut.nnz
        P = sp.csr_matrix(W[:lo])
        Ct = sp.csr_matrix(P[:, pc_sorted[lo:hi]])
        W = _schur_update(f, P, Ct, Ut) if Ct.nnz else P
        if nnz_cap is not None and W.nnz + nnz_final > nnz_cap:
            return U_sp, False
    W = sp.vstack([W] + final_blocks[::-1], format="csr")
    inv_order = np.argsort(order, kind="stable")
    return W[inv_order], True


def _mutual_reduce_native(f, W, pc_sorted, offs, depth, nnz_cap):
    """Backward sweep of mutual_reduce on raw CSR triples via the ranged
    qinv-driven C kernel (csrc/schur_mod.c): the prefix is never sliced and
    the per-level coefficient submatrix is never materialized — the kernel
    reads coefficients off the rows themselves.  Returns (W_reduced, ok)
    with rows still in level-sorted order, or None when the native library
    is unavailable (caller falls back to the scipy sweep)."""
    from .native import schur_update_ranged_native

    r, m = W.shape
    qinv_glob = np.full(m, -1, np.int64)
    qinv_glob[pc_sorted] = np.arange(r)
    Pp = W.indptr.astype(np.int64, copy=False)
    Pj = W.indices
    Px = W.data.astype(np.int64, copy=False)
    final_blocks = []  # (local indptr, indices, data) per level, desc
    nnz_final = 0
    for t in range(depth - 1, 0, -1):
        lo, hi = int(offs[t]), int(offs[t + 1])
        b0, b1 = int(Pp[lo]), int(Pp[hi])
        final_blocks.append((np.asarray(Pp[lo:hi + 1]) - b0,
                             Pj[b0:b1], Px[b0:b1]))
        nnz_final += b1 - b0
        out = schur_update_ranged_native(f, Pp, Pj, Px, lo, m, qinv_glob,
                                         lo, hi)
        if out is None:
            return None
        Pp, Pj, Px = out
        if nnz_cap is not None and int(Pp[-1]) + nnz_final > nnz_cap:
            return W, False
    # assemble: reduced level-0 prefix, then the finalized blocks in
    # ascending level order
    parts = [(Pp, Pj, Px)] + final_blocks[::-1]
    indptr = [np.zeros(1, np.int64)]
    base = 0
    for pp, _, _ in parts:
        indptr.append(np.asarray(pp[1:], np.int64) + base)
        base += int(pp[-1])
    indptr = np.concatenate(indptr)
    indices = np.concatenate([pj for _, pj, _ in parts])
    data = np.concatenate([px for _, _, px in parts])
    W2 = sp.csr_matrix((data, indices, indptr), shape=(r, m))
    W2.has_sorted_indices = True
    return W2, True


def eliminate_against_reduced(f: Field, Ustar, piv_cols, B_sp,
                              record_coeffs=False, assume_canonical=False,
                              rows=None):
    """Single-wave elimination against a mutually reduced pivot block:
    B' = B - B[:, piv_cols] @ Ustar (mod p).  Same contract as
    wave_eliminate.  ``rows`` (optional) restricts to B_sp[rows] without
    materializing the row-subset gather (the kernel permutes on read);
    requires assume_canonical and is only taken on the native
    coefficient-free path — other paths gather first."""
    r = Ustar.shape[0]
    piv_cols = np.asarray(piv_cols, np.int64)
    if rows is not None:
        rows = np.asarray(rows, np.int64)
        if assume_canonical and not record_coeffs and r:
            from .native import schur_update_qinv_native

            qinv = np.full(B_sp.shape[1], -1, np.int64)
            qinv[piv_cols] = np.arange(r)
            D = schur_update_qinv_native(f, sp.csr_matrix(B_sp), qinv,
                                         sp.csr_matrix(Ustar), rows=rows)
            if D is not None:
                return D, None
        # fallback: materialize the subset and continue below
        from .native import gather_rows_native

        sub = gather_rows_native(sp.csr_matrix(B_sp), rows)
        B_sp = sub if sub is not None else sp.csr_matrix(B_sp)[rows]
    q = B_sp.shape[0]
    B = sp.csr_matrix(B_sp) if assume_canonical else mod_reduce(B_sp, f)
    if r == 0:
        return B, (sp.csr_matrix((q, 0), dtype=np.int64)
                   if record_coeffs else None)
    # the qinv-driven C kernel reads each coefficient off B itself,
    # skipping the O(nnz) scipy column slice; with record_coeffs the
    # coefficient matrix is exactly B's values at the pivot columns
    # (C[i, k] = B[i, pivcol(k)]), built vectorized off the hit mask
    from .native import schur_update_qinv_native

    qinv = np.full(B.shape[1], -1, np.int64)
    qinv[piv_cols] = np.arange(r)
    D = schur_update_qinv_native(f, B, qinv, sp.csr_matrix(Ustar))
    if D is not None:
        C = None
        if record_coeffs:
            # C's row i = B row i's qinv hits: build the CSR directly
            # (indptr = running hit count sampled at B's row boundaries)
            # instead of a COO round-trip over all of B's nnz
            k = qinv[B.indices]
            mask = k >= 0
            csum = np.zeros(mask.size + 1, np.int64)
            np.cumsum(mask, out=csum[1:])
            indptr = csum[B.indptr]
            C = sp.csr_matrix(
                (np.asarray(B.data)[mask].astype(np.int64, copy=False),
                 k[mask].astype(np.int32), indptr), shape=(q, r))
            C.sort_indices()
        return D, C
    C = sp.csr_matrix(B[:, piv_cols])
    if C.nnz:
        B = _schur_update(f, B, C, sp.csr_matrix(Ustar))
    return B, (C if record_coeffs else None)


def _schur_update(f: Field, B, C, U):
    """D = B - C @ U (mod p, canonical csr): the fused OpenMP C kernel
    (csrc/schur_mod.c — the host analog of the reference's scatter loop,
    src/SpaSM.jl:619-621) with a scipy fallback."""
    from .native import schur_update_native

    D = schur_update_native(f, B, C, U)
    if D is not None:
        return D
    half = max(1, f.halfp)
    safe_k = max(1, (1 << 62) // (half * half)) - 1
    if C.shape[1] <= safe_k:
        return mod_reduce(B - C @ U, f)
    return mod_reduce(B - safe_spgemm(f, C, U), f)


def wave_eliminate(f: Field, U_sp, piv_cols, levels, B_sp,
                   record_coeffs=False, assume_canonical=False):
    """Eliminate all pivot columns from the rows of B.

    U_sp: scipy csr (r x m) pivot rows, unit pivots at piv_cols, in
    elimination order.  B_sp: scipy csr (q x m).  Returns (B', C) with
    B' = B - C @ U (mod p) having zero in every pivot column; C is (q x r)
    if record_coeffs else None.  assume_canonical skips the entry
    re-reduction when B is already balanced/sorted (round-loop S slices).
    """
    q = B_sp.shape[0]
    r = U_sp.shape[0]
    piv_cols = np.asarray(piv_cols, dtype=np.int64)
    B = sp.csr_matrix(B_sp) if assume_canonical else mod_reduce(B_sp, f)
    coeff_parts = []
    if r == 0:
        return B, (sp.csr_matrix((q, 0), dtype=np.int64)
                   if record_coeffs else None)
    depth = int(levels.max()) + 1
    if q <= 8 and depth > 1:
        # few-row case (triangular solves of single vectors, certificate
        # transcripts): the per-row heap cascade avoids depth kernel
        # launches and per-level O(m) sorts (csrc/cascade_mod.c)
        from .native import cascade_eliminate_native

        out = cascade_eliminate_native(f, B, sp.csr_matrix(U_sp), piv_cols)
        if out is not None:
            D, C = out
            return D, (C if record_coeffs else None)
    for t in range(depth):
        kt = np.flatnonzero(levels == t)
        if kt.size == 0:
            continue
        Ct = B[:, piv_cols[kt]]  # (q, |kt|) — coefficients, final at level t
        Ct = sp.csr_matrix(Ct)
        if Ct.nnz:
            B = _schur_update(f, B, Ct, sp.csr_matrix(U_sp[kt]))
        if record_coeffs:
            # scatter Ct's columns into global pivot coordinates
            Ct = Ct.tocoo()
            coeff_parts.append((Ct.row, kt[Ct.col], Ct.data))
    C = None
    if record_coeffs:
        if coeff_parts:
            ci = np.concatenate([p[0] for p in coeff_parts])
            cj = np.concatenate([p[1] for p in coeff_parts])
            cv = np.concatenate([p[2] for p in coeff_parts])
        else:
            ci = cj = cv = np.zeros(0, np.int64)
        C = sp.csr_matrix((cv, (ci, cj)), shape=(q, r), dtype=np.int64)
    return B, C


def eliminate_csr(f: Field, U: SparseGFp, piv_cols, B: SparseGFp,
                  levels=None, record_coeffs=False):
    """SparseGFp wrapper around wave_eliminate."""
    if levels is None:
        levels = compute_levels(U, piv_cols)
    Bs, C = wave_eliminate(f, U.to_scipy(), piv_cols, levels, B.to_scipy(),
                           record_coeffs)
    out = SparseGFp.from_scipy(Bs, f.p)
    return (out, C) if record_coeffs else out
