"""Structural pivot search — data-parallel reformulation of
``spasm_pivots.c`` (src/SpaSM.jl:773-778).

The reference finds, per round, a set of *structural* pivots: entries
(i, j) such that the pivot submatrix can be permuted to triangular form
with nonzero diagonal ("alternating cycle-free"), via three strategies
(README.md:21-23): Faugère-Lachartre on rows, FL on columns, and a greedy
cycle-free completion.

Our formulation enforces a single **append invariant**: a pivot (i, j) may
be appended to the ordered pivot list only if row i has no entries in any
previously selected pivot column.  Then, by construction:

* the list order is a valid elimination (topological) order — eliminating
  any row against the pivots in list order never reintroduces an already
  eliminated pivot column (pivot row k has no entries at columns of pivots
  < k);
* the combined set over all strategies AND over all rounds AND the dense /
  GPLU finishing pivots (whose rows have all earlier pivot columns already
  eliminated) stays cycle-free globally.

This replaces the reference's per-row DFS (spasm_reach.c) with *static*
level scheduling (see elimination.py), which is what makes the Schur and
solve paths batchable on the TPU.

Strategies implemented:

* ``fl_row_pivots`` — classic FL: for each column, the lightest row whose
  leftmost entry is that column.  Inserted in increasing column order, the
  append invariant holds automatically.
* ``greedy_pivots`` — weight-ordered greedy completion: scan remaining rows
  by increasing weight, select a row iff it has no entry in any selected
  column, choosing its sparsest column as pivot.  (This subsumes much of
  the reference's "FL on columns" + greedy alternating-cycle-free search;
  the exact pivot sets may differ — the contract is rank/kernel equality,
  not pivot-for-pivot equality.)
"""

from __future__ import annotations

import numpy as np

from .csr import SparseGFp
from .native import (greedy_scan_native, pivot_scan_native, scatter_add,
                     scatter_max, scatter_min)

# Below this entry count the fused native scan's private-array setup costs
# more than the NumPy passes it replaces (tests force 0 to cover both paths
# on the same inputs).
_NATIVE_SCAN_MIN_NNZ = 1 << 18


def fl_row_pivots(A: SparseGFp, row_mask=None, col_mask=None):
    """Faugère-Lachartre row pivots.

    row_mask/col_mask: boolean arrays marking selectable rows/columns.
    Returns (rows, cols) in increasing pivot-column order.
    """
    n, m = A.shape
    lengths = A.row_lengths()
    rows = np.flatnonzero(lengths > 0)
    if row_mask is not None:
        rows = rows[row_mask[rows]]
    if rows.size == 0:
        return np.zeros(0, np.int64), np.zeros(0, np.int64)
    # leftmost *selectable* column of each row
    if col_mask is None:
        min_col = A.indices[A.indptr[rows]].astype(np.int64)
    else:
        # vectorized first-selectable-entry per row: mask entries, take the
        # per-row min column over the surviving entries (segment min)
        re = A.rows_expanded()
        sel = col_mask[A.indices]
        if row_mask is not None:
            sel &= row_mask[re]
        min_all = np.full(n, m, np.int64)
        scatter_min(min_all, re[sel], A.indices[sel].astype(np.int64))
        min_col = min_all[rows]
        keep = min_col < m
        rows, min_col = rows[keep], min_col[keep]
        if rows.size == 0:
            return np.zeros(0, np.int64), np.zeros(0, np.int64)
    # NOTE: using the row's overall leftmost column keeps the append
    # invariant only if col_mask is monotone (True prefix); we instead
    # re-check the invariant in the caller for masked searches.
    #
    # Per column we keep the row minimizing (length, row index).  A
    # scatter-min over the packed key (length << 32 | row) selects
    # exactly what the former lexsort+first-occurrence pass did, in
    # O(rows + m) instead of a 3-key sort (~0.25 s of the d9 pivot
    # phase).
    if rows.size and int(n) < (1 << 32) and int(lengths.max()) < (1 << 31):
        best = np.full(m, np.iinfo(np.int64).max, np.int64)
        combo = (lengths[rows].astype(np.int64) << 32) | rows
        scatter_min(best, min_col, combo)
        cols = np.flatnonzero(best != np.iinfo(np.int64).max)
        return (best[cols] & 0xFFFFFFFF).astype(np.int64), cols
    order = np.lexsort((rows, lengths[rows], min_col))
    rows, min_col = rows[order], min_col[order]
    first = np.ones(rows.size, bool)
    first[1:] = min_col[1:] != min_col[:-1]
    return rows[first], min_col[first]


def fl_col_pivots(A: SparseGFp, col_selected, row_used, entries=None):
    """Faugère-Lachartre "on columns" (README.md:22): for each unused
    column, the topmost unused row; a candidate row is accepted only if it
    has no entries in already-selected columns.

    Soundness of the combined order: among these pivots, u_k touching c_l
    implies row_k >= row_l (row_l is c_l's topmost candidate), so listing
    them by DECREASING row index makes every elimination edge point
    earlier -> later; the explicit column check handles edges vs the
    FL-row pivots (which precede them in the global list).

    entries: optional (re_u, ci_u) — the (row, col) pairs of the entries
    of currently-UNUSED rows, precomputed by the caller so the unused-row
    compression is shared across strategies (one pass over nnz instead of
    one per strategy; at 50M+ nnz these passes dominate pivot search).

    Returns (rows, cols) in decreasing-row order; masks updated in place.
    """
    n, m = A.shape
    if entries is None:
        i = A.rows_expanded()
        j = A.indices
        keep = ~row_used[i]
        i, j = i[keep], j[keep]
    else:
        i, j = entries
    i_u, j_u = i, j  # unused-row entries (for the invariant check below)
    cand = ~col_selected[j]
    i, j = i[cand], j[cand]
    if i.size == 0:
        return np.zeros(0, np.int64), np.zeros(0, np.int64)
    # topmost unused row per column: one scatter-min over the candidate
    # entries (a lexsort here costs tens of seconds at tens of M nnz)
    min_row = np.full(m, n, np.int64)
    scatter_min(min_row, j.astype(np.int64), i)
    cols_c = np.flatnonzero(min_row < n)
    rows_c = min_row[cols_c]
    # one pivot per row: keep the smallest column for each row (same
    # result as the former sort-and-keep-first)
    min_col = np.full(n, m, np.int64)
    scatter_min(min_col, rows_c, cols_c)
    keep = min_col[rows_c] == cols_c
    rows_c, cols_c = rows_c[keep], cols_c[keep]
    # sort by row (rows are unique) so the reversal below yields the
    # decreasing-row soundness order
    order = np.argsort(rows_c, kind="stable")
    rows_c, cols_c = rows_c[order], cols_c[order]
    # append-invariant check vs previously selected columns (vectorized:
    # per-row count of entries landing in already-selected columns;
    # np.bincount is the fast C path for counting scatters).  Candidate
    # rows are unused, so the unused-row entry set suffices.
    sel_entries = col_selected[j_u]
    if sel_entries.any():
        hits = np.bincount(i_u[sel_entries], minlength=A.n)
        ok = hits[rows_c] == 0
    else:
        ok = np.ones(rows_c.size, bool)
    rows_c, cols_c = rows_c[ok], cols_c[ok]
    # decreasing row order
    rows_c, cols_c = rows_c[::-1].copy(), cols_c[::-1].copy()
    row_used[rows_c] = True
    col_selected[cols_c] = True
    return rows_c.astype(np.int64), cols_c.astype(np.int64)


# calls of greedy_pivots whose completion ran in C ("native") and in the
# NumPy body ("numpy"), over the process's life
GREEDY_RUNS = {"native": 0, "numpy": 0}


def greedy_pivots(A: SparseGFp, col_selected, row_used, positions,
                  piv_pos_of_col, col_touch_max, max_passes=2,
                  mopup=True, entries=None):
    """Greedy cycle-free completion by fractional-position insertion.

    The selected pivots carry real-valued *positions* whose sorted order is
    a valid elimination order (a linear extension of the pivot DAG).  A
    candidate (i, j) — row i unused, column j unselected, A[i,j] != 0 —
    can be inserted at position q iff

        P1 = max{ pos(k) : selected k whose ROW touches column j } < q
        P2 = min{ pos(l) : selected l whose COLUMN is in row i's support }
        and P1 < q < P2,

    because then every new DAG edge (k -> new for u_k[j] != 0, new -> l
    for support(i) hitting c_l) is consistent with the existing order,
    which itself is unchanged — so the extended order stays acyclic.
    This strictly subsumes the append rule (append = require P2 = +inf).

    col_touch_max[c] tracks max pos of selected pivots whose row support
    includes c; piv_pos_of_col[c] the position of the pivot on column c
    (+inf if none).  All four state arrays are updated in place.
    Returns (rows, cols, pos) of the newly selected pivots.

    The completion runs in C (native.greedy_pivots_native) straight off
    A's CSR and the state; the NumPy body below, bit-identical, runs where
    the native library is unavailable.  ``GREEDY_RUNS`` counts the calls
    of each.  entries: the (row, col) pairs of A's entries of rows unused
    at some earlier point (a caller-shared compression), read only by the
    NumPy body.
    """
    # imported here, so that the module's imports stay the reference's
    from .native import greedy_pivots_native

    res = greedy_pivots_native(A.indptr, A.indices, col_selected, row_used,
                               piv_pos_of_col, col_touch_max,
                               max_passes=max_passes, mopup=mopup)
    if res is not None:
        GREEDY_RUNS["native"] += 1
        return res
    GREEDY_RUNS["numpy"] += 1
    n, m = A.shape
    lengths = A.row_lengths()
    col_counts = np.bincount(A.indices, minlength=m).astype(np.int64)
    sel_r, sel_c, sel_p = [], [], []
    # Compress ONCE to the entries of currently-unused rows (or narrow the
    # caller-shared compression); accepted rows' entries are dropped
    # incrementally, so every pass costs O(live entries), not O(nnz)
    # (at 50M+ nnz the per-pass recompression used to dominate the whole
    # pivot search).
    if entries is None:
        keep = ~row_used[A.rows_expanded()]
        re = A.rows_expanded()[keep]
        ci = A.indices[keep].astype(np.int64)
    else:
        re, ci = entries
        keep = ~row_used[re]
        re, ci = re[keep], ci[keep]

    # Batched greedy: each pass computes every unused row's best insertable
    # column under the CURRENT state, then accepts a mutually
    # non-interacting subset by weight priority (a row is accepted iff no
    # lighter accepted row chose a column inside its support).  The
    # lightest remaining valid candidate is always accepted, so each pass
    # makes progress; a handful of passes replaces the per-row Python loop
    # of the sequential formulation (the pivot SET may differ — the
    # rank/RREF/kernel contract is what is preserved).
    exhausted = False
    for _ in range(max(max_passes, 8)):
        if re.size == 0:
            exhausted = True
            break
        # p2 per row: min position over selected pivot columns in support
        p2 = np.full(n, np.inf)
        scatter_min(p2, re, piv_pos_of_col[ci])
        # eligible entries: free column, insertable below the row's p2
        elig = (~col_selected[ci]) & (col_touch_max[ci] < p2[re])
        if not elig.any():
            # the sequential rule below uses the SAME eligibility test, so
            # an empty eligible set proves the mop-up would find nothing
            exhausted = True
            break
        re_e, ci_e = re[elig], ci[elig]
        # per-row best column: minimize (col_count, col) — composite key
        key = col_counts[ci_e] * (m + 1) + ci_e
        best_key = np.full(n, np.iinfo(np.int64).max)
        scatter_min(best_key, re_e, key)
        rows_c = np.unique(re_e)
        j_of = (best_key[rows_c] % (m + 1)).astype(np.int64)
        # priority = weight rank (ties by row index for determinism)
        order = np.lexsort((rows_c, lengths[rows_c]))
        rows_c, j_of = rows_c[order], j_of[order]
        rank_of_row = np.full(n, np.iinfo(np.int64).max)
        rank_of_row[rows_c] = np.arange(rows_c.size)
        # min candidate rank touching each column (via supports)
        mc = np.full(m, np.iinfo(np.int64).max)
        cand_mask = rank_of_row[re] < np.iinfo(np.int64).max
        re_c, ci_c = re[cand_mask], ci[cand_mask]
        scatter_min(mc, ci_c, rank_of_row[re_c])
        # also columns CHOSEN by candidates (choice may differ from mere
        # touch only in priority, supports already cover chosen cols)
        # accept: my rank is strictly the smallest over every column of my
        # support (so no lighter accepted row interacts with me), and I am
        # the unique chooser of my column at that rank
        viol = np.zeros(n, np.int64)
        scatter_add(viol, re_c,
                    (mc[ci_c] < rank_of_row[re_c]).astype(np.int64))
        acc = viol[rows_c] == 0
        rows_a, j_a = rows_c[acc], j_of[acc]
        if rows_a.size == 0:
            break
        # positions: q in (p1, p2) per accepted row
        p1 = col_touch_max[j_a]
        p2a = p2[rows_a]
        lo = np.where(np.isfinite(p1), p1,
                      np.where(np.isfinite(p2a), p2a - 2.0, 0.0))
        hi = np.where(np.isfinite(p2a), p2a, lo + 2.0)
        q = 0.5 * (lo + hi)
        ok = (p1 < q) & (q < p2a)  # float underflow in a crowded gap: skip
        rows_a, j_a, q = rows_a[ok], j_a[ok], q[ok]
        if rows_a.size == 0:
            break
        col_selected[j_a] = True
        row_used[rows_a] = True
        piv_pos_of_col[j_a] = q
        q_of_row = np.full(n, -np.inf)
        q_of_row[rows_a] = q
        in_acc = q_of_row[re] > -np.inf
        scatter_max(col_touch_max, ci[in_acc], q_of_row[re[in_acc]])
        sel_r.append(rows_a)
        sel_c.append(j_a)
        sel_p.append(q)
        # drop the accepted rows' entries (rows only ever become used)
        re, ci = re[~in_acc], ci[~in_acc]
        # diminishing returns: when a pass accepts almost none of its
        # candidates (dense overlapping supports — the batched rule is
        # conservative there), stop paying O(live entries) per pass and
        # let the sequential mop-up below finish with the exact rule.
        # The absolute floor of 16 intentionally routes SMALL low-yield
        # pools to the mop-up too: its lightest-first exact insertion
        # harvests measurably better pivot sets on dense-overlap rounds
        # (irregular subcomplex end-to-end 1.2 s vs 2.9 s with a
        # relative-only threshold — NOTES_r5)
        if rows_a.size < max(16, rows_c.size // 64):
            break
    # sequential mop-up on the remaining candidates: the batched
    # acceptance is conservative on cascade/chain structures (heavily
    # overlapping supports) where the fractional-insertion rule shines —
    # the Python loop continues in cap-sized batches while productive
    # (matching the reference's unbounded greedy) and stops after one
    # low-yield batch (bounded host work on unproductive tails).
    # Skipped when the batched passes PROVED exhaustion (empty eligible
    # set): the per-row loop applies the identical insertion rule.  Also
    # skippable by the caller (mopup=False) when the round is likely to
    # discard its pivots (accelerator dense-switch probe).
    if not exhausted and mopup:
        sq_r, sq_c, sq_p = _greedy_sequential(
            A, col_selected, row_used, piv_pos_of_col, col_touch_max,
            col_counts, lengths, cap=4096)
        sel_r.append(sq_r)
        sel_c.append(sq_c)
        sel_p.append(sq_p)
    if sel_r:
        return (np.concatenate(sel_r).astype(np.int64),
                np.concatenate(sel_c).astype(np.int64),
                np.concatenate(sel_p))
    return (np.zeros(0, np.int64), np.zeros(0, np.int64),
            np.zeros(0, np.float64))


def _greedy_sequential(A, col_selected, row_used, piv_pos_of_col,
                       col_touch_max, col_counts, lengths, cap=4096):
    """Sequential fractional-insertion greedy over the unused rows in
    lightest-first order (the exact per-row rule; see greedy_pivots
    docstring).

    Yield-adaptive continuation: rows are processed in ``cap``-sized
    batches; the loop keeps going while a batch accepts at least 1/64 of
    its rows.  A productive instance therefore harvests like the
    reference's UNBOUNDED greedy (every extra pivot here saves a whole
    Schur round), while an unproductive tail — the case the old hard
    4096-row cap protected against — still stops after one dry batch of
    bounded host work."""
    indptr, indices = A.indptr, A.indices
    cand = np.flatnonzero((~row_used) & (lengths > 0))
    cand = cand[np.argsort(lengths[cand], kind="stable")]
    sel_r, sel_c, sel_p = [], [], []
    accepted_in_batch = 0
    batch_end = min(cap, cand.size)
    for pos in range(cand.size):
        if pos == batch_end:
            if accepted_in_batch * 64 < cap:
                break  # dry batch: stop, bounded host work
            accepted_in_batch = 0
            batch_end = min(batch_end + cap, cand.size)
        i = cand[pos]
        ji = indices[indptr[i]:indptr[i + 1]]
        free = ji[~col_selected[ji]]
        if free.size == 0:
            continue
        p2 = piv_pos_of_col[ji].min()  # +inf when no selected col hit
        p1s = col_touch_max[free]
        ok = p1s < p2
        if not ok.any():
            continue
        cand_cols = free[ok]
        j = cand_cols[np.argmin(col_counts[cand_cols])]
        p1 = col_touch_max[j]
        lo = p1 if np.isfinite(p1) else (p2 - 2.0 if np.isfinite(p2)
                                         else 0.0)
        hi = p2 if np.isfinite(p2) else lo + 2.0
        q = 0.5 * (lo + hi)
        if not (p1 < q < p2):
            continue  # float underflow in a crowded gap: skip
        col_selected[j] = True
        row_used[i] = True
        piv_pos_of_col[j] = q
        np.maximum.at(col_touch_max, ji, q)
        sel_r.append(i)
        sel_c.append(j)
        sel_p.append(q)
        accepted_in_batch += 1
    return (np.array(sel_r, np.int64), np.array(sel_c, np.int64),
            np.array(sel_p, np.float64))


def find_structural_pivots(A: SparseGFp, enable_greedy=True, fl=None,
                           greedy_mopup=True, col_election=None):
    """One round of structural pivot selection on the (current Schur) matrix
    A.  Returns (rows, cols, counts_by_strategy) with the global list in
    append-invariant order: FL pivots (by column), then greedy completions.

    fl: optionally a precomputed FL-row pivot set (rows, cols) in
    increasing-column order — e.g. from the distributed device election
    (parallel.sparse_sharded.sharded_fl_election), which is bit-identical
    to ``fl_row_pivots``.

    col_election: optional callable (col_selected, row_used) ->
    (rows, cols) replacing the host FL-cols strategy — e.g. the device
    mesh election (parallel.sparse_sharded.sharded_fl_col_election),
    bit-identical to ``fl_col_pivots``.  It must update both masks in
    place and return decreasing-row order.
    """
    n, m = A.shape
    fl_r, fl_c = fl if fl is not None else fl_row_pivots(A)
    # verify/enforce the append invariant for the FL set: row k must have no
    # entries in earlier FL pivot columns.  Leftmost-column construction
    # guarantees it (entries of row k all lie at columns >= its pivot col,
    # and earlier pivots have strictly smaller columns), so no check needed.
    col_selected = np.zeros(m, bool)
    row_used = np.zeros(n, bool)
    col_selected[fl_c] = True
    row_used[fl_r] = True
    if col_election is None and A.nnz >= _NATIVE_SCAN_MIN_NNZ:
        # fused native path: FL-cols candidates + invariant hits + greedy
        # touch state in ONE OpenMP sweep, greedy eligibility in a second
        # (csrc/pivot_scan.c) — replaces the per-strategy NumPy passes
        # that dominate pivot search at tens of M nnz.  Outputs are exact
        # reductions, bit-identical to the NumPy formulation below.
        pos_of_row = np.full(n, -np.inf)
        pos_of_row[fl_r] = np.arange(fl_r.size, dtype=np.float64)
        scan = pivot_scan_native(A.indptr, A.indices, row_used,
                                 col_selected, pos_of_row)
        if scan is not None:
            return _pivots_from_scan(A, fl_r, fl_c, scan, col_selected,
                                     row_used, enable_greedy, greedy_mopup)
    # ONE unused-row compression shared by FL-cols and the greedy (each
    # strategy used to re-walk the full entry set; these single-threaded
    # NumPy passes dominate pivot search at tens of M nnz)
    re_all = A.rows_expanded()
    keep_u = ~row_used[re_all]
    re_u = re_all[keep_u]
    ci_u = A.indices[keep_u].astype(np.int64)
    if col_election is not None:
        c_r, c_c = col_election(col_selected, row_used)
    else:
        c_r, c_c = fl_col_pivots(A, col_selected, row_used,
                                 entries=(re_u, ci_u))

    rows = np.concatenate([fl_r, c_r])
    cols = np.concatenate([fl_c, c_c])
    pos = np.arange(rows.size, dtype=np.float64)
    if enable_greedy:
        # position state for fractional-insertion greedy (see greedy_pivots)
        piv_pos_of_col = np.full(m, np.inf)
        piv_pos_of_col[cols] = pos
        col_touch_max = np.full(m, -np.inf)
        # vectorized: scatter-max each selected row's position onto its
        # support columns — FL rows from the compression complement,
        # FL-col rows from the unused-row set (they were unused at the
        # compression point)
        if rows.size:
            pos_of_row = np.full(n, -np.inf)
            pos_of_row[rows] = pos
            if fl_r.size:
                ci_s = A.indices[~keep_u].astype(np.int64)
                scatter_max(col_touch_max, ci_s,
                            pos_of_row[re_all[~keep_u]])
            if c_r.size:
                touch = pos_of_row[re_u]
                live = np.isfinite(touch)
                scatter_max(col_touch_max, ci_u[live], touch[live])
        g_r, g_c, g_p = greedy_pivots(A, col_selected, row_used, pos,
                                      piv_pos_of_col, col_touch_max,
                                      mopup=greedy_mopup,
                                      entries=(re_u, ci_u))
        rows = np.concatenate([rows, g_r])
        cols = np.concatenate([cols, g_c])
        pos = np.concatenate([pos, g_p])
        order = np.argsort(pos, kind="stable")
        rows, cols = rows[order], cols[order]
    else:
        g_r = np.zeros(0, np.int64)
    return rows, cols, {"faugere-lachartre": fl_r.size,
                        "faugere-lachartre-cols": c_r.size,
                        "greedy": g_r.size}


def _pivots_from_scan(A, fl_r, fl_c, scan, col_selected, row_used,
                      enable_greedy, greedy_mopup):
    """Pivot selection driven by the fused native scan: the FL-cols
    acceptance and greedy eligibility run on the scan's outputs instead of
    re-walking the entry set per strategy.  Selection rules (and therefore
    the pivot set) are identical to the NumPy path in
    ``find_structural_pivots``."""
    n, m = A.shape
    min_row, hits, col_touch_max = scan
    # FL-cols acceptance — same rule as fl_col_pivots: topmost unused row
    # per unselected column, one pivot per row (smallest column), append
    # invariant (no entry in a selected column), decreasing-row order.
    cols_c = np.flatnonzero(min_row < n).astype(np.int64)
    if cols_c.size:
        rows_c = min_row[cols_c].astype(np.int64)
        min_col = np.full(n, m, np.int64)
        scatter_min(min_col, rows_c, cols_c)
        keep = min_col[rows_c] == cols_c
        rows_c, cols_c = rows_c[keep], cols_c[keep]
        order = np.argsort(rows_c, kind="stable")
        rows_c, cols_c = rows_c[order], cols_c[order]
        ok = hits[rows_c] == 0
        rows_c, cols_c = rows_c[ok][::-1].copy(), cols_c[ok][::-1].copy()
        row_used[rows_c] = True
        col_selected[cols_c] = True
        c_r, c_c = rows_c, cols_c
    else:
        c_r = c_c = np.zeros(0, np.int64)

    rows = np.concatenate([fl_r, c_r])
    cols = np.concatenate([fl_c, c_c])
    pos = np.arange(rows.size, dtype=np.float64)
    g_r = np.zeros(0, np.int64)
    if enable_greedy and rows.size:
        piv_pos_of_col = np.full(m, np.inf)
        piv_pos_of_col[cols] = pos
        if c_r.size:
            # the scan's col_touch_max covers the FL rows; extend it with
            # the FL-col pivot rows' supports (small set)
            lens = A.indptr[c_r + 1] - A.indptr[c_r]
            total = int(lens.sum())
            starts = np.repeat(np.cumsum(lens) - lens, lens)
            idx = np.repeat(A.indptr[c_r], lens) + (np.arange(total) - starts)
            scatter_max(col_touch_max, A.indices[idx].astype(np.int64),
                        np.repeat(pos[fl_r.size:], lens))
        res = greedy_scan_native(A.indptr, A.indices, row_used,
                                 col_selected, piv_pos_of_col,
                                 col_touch_max)
        if res is None or res[0] > 0:
            # candidates exist (or the eligibility kernel vanished): run
            # the greedy completion, which reads the CSR itself
            g_r, g_c, g_p = greedy_pivots(
                A, col_selected, row_used, pos, piv_pos_of_col,
                col_touch_max, mopup=greedy_mopup)
            rows = np.concatenate([rows, g_r])
            cols = np.concatenate([cols, g_c])
            pos = np.concatenate([pos, g_p])
            order = np.argsort(pos, kind="stable")
            rows, cols = rows[order], cols[order]
        # res == (0, elig): the eligibility test is the SAME rule the
        # batched pass and the sequential mop-up both start from, so an
        # empty eligible set proves both would find nothing
    return rows, cols, {"faugere-lachartre": fl_r.size,
                        "faugere-lachartre-cols": c_r.size,
                        "greedy": g_r.size}
