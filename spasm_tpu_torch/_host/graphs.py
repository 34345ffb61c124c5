"""Structural combinatorics on sparsity patterns: maximum matching,
structural rank, Dulmage-Mendelsohn decomposition, strongly connected
components — the analogs of ``spasm_matching.c``, ``spasm_dm.c``,
``spasm_scc.c`` (src/SpaSM.jl:780-799).

Host graph algorithms (scipy.csgraph where possible); the resulting
permutations are applied on device / in the CSR layer.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import scipy.sparse as sp
import scipy.sparse.csgraph as csgraph

from .csr import SparseGFp


def maximum_matching(A: SparseGFp):
    """Maximum bipartite matching of the pattern
    (``spasm_maximum_matching``).  Returns (size, jmatch, imatch):
    jmatch[i] = column matched to row i (or -1), imatch[j] = row matched to
    column j (or -1)."""
    n, m = A.shape
    pattern = sp.csr_matrix(
        (np.ones(A.nnz, np.int8), A.indices, A.indptr), shape=(n, m))
    imatch = csgraph.maximum_bipartite_matching(pattern, perm_type="row")
    imatch = np.asarray(imatch, np.int64)  # per column: matched row or -1
    jmatch = np.full(n, -1, np.int64)
    cols = np.flatnonzero(imatch >= 0)
    jmatch[imatch[cols]] = cols
    return int(cols.size), jmatch, imatch


def structural_rank(A: SparseGFp) -> int:
    """``spasm_structural_rank``: size of a maximum matching — an upper
    bound for the rank."""
    return maximum_matching(A)[0]


@dataclasses.dataclass
class DM:
    """Dulmage-Mendelsohn decomposition (the reference's struct,
    src/SpaSM.jl:307-323).

    p (n,) row permutation, q (m,) column permutation; in A[p][:, q] the
    pattern is block upper triangular.  Fine blocks: block k is rows
    r[k]:r[k+1] and cols c[k]:c[k+1]; nb blocks total.  Coarse boundaries
    rr[5] / cc[5] delimit (in permuted order):
      [rr0:rr1] rows of the horizontal (underdetermined) part H
      [rr1:rr2] rows of the square part S
      [rr2:rr3] matched rows of the vertical (overdetermined) part V
      [rr3:rr4] unmatched rows of V
      [cc0:cc1] unmatched cols of H
      [cc1:cc2] matched cols of H
      [cc2:cc3] cols of S
      [cc3:cc4] cols of V
    """

    p: np.ndarray
    q: np.ndarray
    r: np.ndarray
    c: np.ndarray
    nb: int
    rr: np.ndarray
    cc: np.ndarray


def _alternating_reach_from_rows(A, At, jmatch, imatch, start_rows):
    """Rows/cols reachable from start_rows by alternating paths
    (row -> any col edge, col -> matched row)."""
    n, m = A.shape
    row_seen = np.zeros(n, bool)
    col_seen = np.zeros(m, bool)
    frontier = np.asarray(start_rows, np.int64)
    row_seen[frontier] = True
    while frontier.size:
        cols = np.unique(np.concatenate(
            [A.row(i)[0] for i in frontier]) if frontier.size else [])
        cols = cols[~col_seen[cols]]
        col_seen[cols] = True
        nxt = imatch[cols]
        nxt = nxt[(nxt >= 0)]
        nxt = np.unique(nxt[~row_seen[nxt]])
        row_seen[nxt] = True
        frontier = nxt
    return row_seen, col_seen


def _alternating_reach_from_cols(A, At, jmatch, imatch, start_cols):
    """Cols/rows reachable from start_cols (col -> any row edge,
    row -> matched col)."""
    n, m = A.shape
    row_seen = np.zeros(n, bool)
    col_seen = np.zeros(m, bool)
    frontier = np.asarray(start_cols, np.int64)
    col_seen[frontier] = True
    while frontier.size:
        rows = np.unique(np.concatenate(
            [At.row(j)[0] for j in frontier]) if frontier.size else [])
        rows = rows[~row_seen[rows]]
        row_seen[rows] = True
        nxt = jmatch[rows]
        nxt = nxt[nxt >= 0]
        nxt = np.unique(nxt[~col_seen[nxt]])
        col_seen[nxt] = True
        frontier = nxt
    return row_seen, col_seen


def dulmage_mendelsohn(A: SparseGFp) -> DM:
    """``spasm_dulmage_mendelsohn`` (src/SpaSM.jl:794): coarse
    decomposition from a maximum matching + fine block triangularization of
    the square part by SCC."""
    n, m = A.shape
    At = A.T
    _, jmatch, imatch = maximum_matching(A)

    # H: reachable from unmatched COLUMNS (extra columns side)
    h_rows, h_cols = _alternating_reach_from_cols(
        A, At, jmatch, imatch, np.flatnonzero(imatch < 0))
    # V: reachable from unmatched ROWS (extra rows side)
    v_rows, v_cols = _alternating_reach_from_rows(
        A, At, jmatch, imatch, np.flatnonzero(jmatch < 0))
    s_rows = ~(h_rows | v_rows)
    s_cols = ~(h_cols | v_cols)

    # fine decomposition: SCC of the square part's quotient digraph
    sq_rows = np.flatnonzero(s_rows)
    sq_cols = np.flatnonzero(s_cols)
    k = sq_rows.size
    fine_r = [0]
    fine_c = [0]
    if k:
        # square part is perfectly matched: contract col j ~ row imatch[j];
        # digraph on matched pairs via the remaining entries
        colpos = np.full(m, -1, np.int64)
        colpos[sq_cols] = np.arange(sq_cols.size)
        # pair index by row
        rowpos = np.full(n, -1, np.int64)
        rowpos[sq_rows] = np.arange(k)
        pair_of_col = rowpos[imatch[sq_cols]]  # col -> pair id
        i_all, j_all, _ = A.to_coo()
        mask = s_rows[i_all] & s_cols[j_all]
        src = rowpos[i_all[mask]]
        dst = pair_of_col[colpos[j_all[mask]]]
        g = sp.csr_matrix((np.ones(src.size, np.int8), (src, dst)),
                          shape=(k, k))
        ncomp, labels = csgraph.connected_components(
            g, directed=True, connection="strong")
        # order components topologically: condensation is a DAG; scipy's
        # labels are not ordered, so order blocks by topological sort
        order = _condensation_topo_order(g, ncomp, labels)
        rank_of = np.empty(ncomp, np.int64)
        rank_of[order] = np.arange(ncomp)
        pair_order = np.argsort(rank_of[labels], kind="stable")
        sq_rows = sq_rows[pair_order]
        sq_cols_by_pair = np.empty(k, np.int64)
        sq_cols_by_pair[pair_of_col] = sq_cols  # pair -> its col
        sq_cols = sq_cols_by_pair[pair_order]
        sizes = np.bincount(rank_of[labels], minlength=ncomp)
        fine_r = np.concatenate([[0], np.cumsum(sizes)]).tolist()
        fine_c = fine_r

    # assemble permutations
    hm = np.flatnonzero(h_cols & (imatch >= 0))
    hu = np.flatnonzero(h_cols & (imatch < 0))
    vm = np.flatnonzero(v_rows & (jmatch >= 0))
    vu = np.flatnonzero(v_rows & (jmatch < 0))
    h_row_list = np.flatnonzero(h_rows)
    v_col_list = np.flatnonzero(v_cols)

    p = np.concatenate([h_row_list, sq_rows, vm, vu]).astype(np.int64)
    q = np.concatenate([hu, hm, sq_cols, v_col_list]).astype(np.int64)
    rr = np.array([0, h_row_list.size, h_row_list.size + sq_rows.size,
                   h_row_list.size + sq_rows.size + vm.size, n], np.int64)
    cc = np.array([0, hu.size, hu.size + hm.size,
                   hu.size + hm.size + sq_cols.size, m], np.int64)

    # global fine blocks: H as one block, the square SCC blocks, V as one
    r_list = [0]
    c_list = [0]
    if h_row_list.size or hu.size + hm.size:
        r_list.append(h_row_list.size)
        c_list.append(hu.size + hm.size)
    base_r, base_c = r_list[-1], c_list[-1]
    for t in range(1, len(fine_r)):
        r_list.append(base_r + fine_r[t])
        c_list.append(base_c + fine_c[t])
    if n - r_list[-1] or m - c_list[-1]:
        r_list.append(n)
        c_list.append(m)
    else:
        r_list[-1] = n
        c_list[-1] = m
    return DM(p=p, q=q, r=np.array(r_list, np.int64),
              c=np.array(c_list, np.int64), nb=len(r_list) - 1,
              rr=rr, cc=cc)


def _condensation_topo_order(g, ncomp, labels):
    """Topological order of the SCC condensation (sources first)."""
    gc = sp.coo_matrix(g)
    src, dst = labels[gc.row], labels[gc.col]
    keep = src != dst
    edges = sp.csr_matrix(
        (np.ones(keep.sum(), np.int8), (src[keep], dst[keep])),
        shape=(ncomp, ncomp))
    indeg = np.asarray((edges != 0).sum(axis=0)).ravel()
    order = []
    ready = list(np.flatnonzero(indeg == 0))
    edges_csc = edges.tocsr()
    while ready:
        u = ready.pop()
        order.append(u)
        row = edges_csc[u]
        for v in np.unique(row.indices):
            indeg[v] -= 1
            if indeg[v] == 0:
                ready.append(int(v))
    return np.array(order, np.int64)


def strongly_connected_components(A: SparseGFp) -> DM:
    """``spasm_strongly_connected_components`` (src/SpaSM.jl:797): SCC
    block triangularization of a square matrix's pattern, returned in the
    DM struct (p == q)."""
    n, m = A.shape
    assert n == m, "SCC needs a square matrix"
    pattern = sp.csr_matrix((np.ones(A.nnz, np.int8), A.indices, A.indptr),
                            shape=(n, m))
    ncomp, labels = csgraph.connected_components(pattern, directed=True,
                                                 connection="strong")
    order = _condensation_topo_order(pattern, ncomp, labels)
    rank_of = np.empty(ncomp, np.int64)
    rank_of[order] = np.arange(ncomp)
    perm = np.argsort(rank_of[labels], kind="stable").astype(np.int64)
    sizes = np.bincount(rank_of[labels], minlength=ncomp)
    r = np.concatenate([[0], np.cumsum(sizes)]).astype(np.int64)
    rr = np.array([0, 0, n, n, n], np.int64)
    cc = np.array([0, 0, n, n, n], np.int64)
    return DM(p=perm, q=perm, r=r, c=r.copy(), nb=ncomp, rr=rr, cc=cc)


# --------- matching-derived permutations (spasm_permutation helpers) ------


def permute_row_matching(n, jmatch, p, qinv):
    """``spasm_permute_row_matching``: jmatch under row perm p / col perm
    qinv."""
    jmatch = np.asarray(jmatch, np.int64)
    out = np.full(n, -1, np.int64)
    p = np.asarray(p, np.int64)
    qinv = np.asarray(qinv, np.int64)
    src = jmatch[p]
    ok = src >= 0
    out[ok] = qinv[src[ok]]
    return out


def permute_column_matching(m, imatch, pinv, q):
    """``spasm_permute_column_matching``."""
    imatch = np.asarray(imatch, np.int64)
    out = np.full(m, -1, np.int64)
    pinv = np.asarray(pinv, np.int64)
    q = np.asarray(q, np.int64)
    src = imatch[q]
    ok = src >= 0
    out[ok] = pinv[src[ok]]
    return out


def submatching(match, a, b, c, d):
    """``spasm_submatching(match, a, b, c, d)`` (src/SpaSM.jl:786):
    restrict a matching to the submatrix [a, b) x [c, d) and REINDEX —
    entry k of the result is match[a + k] - c when the partner falls in
    [c, d), else -1 (unmatched in the submatrix)."""
    out = np.asarray(match, np.int64)[a:b] - c
    out[(out < 0) | (out >= d - c)] = -1
    return out
