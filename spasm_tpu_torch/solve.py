"""Derived operations on an echelonization: RREF, kernel basis, linear
solves — the port of ``spasm_tpu/solve.py``, the analogs of
``spasm_rref.c``, ``spasm_kernel.c``, ``spasm_solve.c`` and
``spasm_triangular.c`` (src/SpaSM.jl:660-923).

Everything here is host code over the port's copy of the reference's host
modules (``._host``), batched through the level-wave elimination; per-row
DFS never happens.  The one device computation is the inverse of the
dense-finish corner block (``_dense_block_inverse``), an augmented Jordan
RREF through ``ops/dense.rref`` on the device the LU was computed on.
"""

from __future__ import annotations

import numpy as np
import scipy.sparse as sp

from ._host.csr import SparseGFp
from .echelonize import LU, echelonize
from ._host.elimination import compute_levels, topo_order, wave_eliminate
from ._host.field import Field
from ._host.sputil import mod_reduce
from ._host.utils.logging import log, push_verbose, wtime


def rref_of_U(fact: LU) -> SparseGFp:
    """Canonical reduced row echelon form of the factorization's row space
    — ``spasm_rref`` (src/SpaSM.jl:869-871).

    The RREF of a row space is unique, but a factorization's pivot columns
    need not be the canonical (leftmost) ones; reducing against them would
    give a non-canonical reduced form.  We therefore (1) auto-reduce the
    basis until every row has a distinct leading column — those ARE the
    canonical pivot columns — then (2) Jordan-reduce against them with the
    wave machinery (rows sorted by leading column satisfy the append
    invariant: every entry of a row lies at or right of its lead)."""
    f = fact.field
    r = fact.r
    if r == 0:
        return SparseGFp.zeros(f, 0, fact.m)
    from ._host.sputil import safe_spgemm

    B = mod_reduce(fact.U.to_scipy(), f)
    # (1) distinct leading columns (rows are independent: none vanish)
    while True:
        leads = B.indices[B.indptr[:-1]].astype(np.int64)
        order = np.argsort(leads, kind="stable")
        B = sp.csr_matrix(B)[order]
        leads = leads[order]
        dup = np.flatnonzero(leads[1:] == leads[:-1]) + 1
        if dup.size == 0:
            break
        # eliminate each duplicate-lead row with the first row of its run
        first_of = np.arange(r)
        for i in dup:  # runs are short; assign first of each run
            first_of[i] = first_of[i - 1]
        # leads are the rows' LEFTMOST entries: read straight off the CSR
        # (scipy's 2D fancy indexing costs ~0.5 s at 2M rows)
        lead_val = B.data[B.indptr[:-1]].astype(np.int64)
        coef = f.mul(lead_val[dup], f.inv(lead_val[first_of[dup]]))
        C = sp.csr_matrix((coef, (dup, first_of[dup])), shape=(r, r))
        B = mod_reduce(B - safe_spgemm(f, C, B), f)
    piv_cols = leads
    # (2) scale leads to unit pivots, then bring the basis into full
    # mutual reduced form — which IS the canonical RREF (distinct leading
    # columns + every row zero at every other pivot).  mutual_reduce runs
    # the prefix-shrinking backward sweep through the native Schur kernel
    # — much cheaper than a per-level Jordan over the whole basis.
    lead_val = B.data[B.indptr[:-1]].astype(np.int64)  # leftmost entries
    row_of = np.repeat(np.arange(r), np.diff(B.indptr))
    if np.abs(lead_val).max(initial=0) <= 1:
        # +-1 leads (boundary matrices): inverse == value, and +-1 scaling
        # keeps data balanced — skip the Fermat inverses + normalize pass
        B.data = B.data * lead_val[row_of]
    else:
        B.data = f.normalize(B.data * f.inv(lead_val)[row_of])
    Bw = SparseGFp.from_scipy(B, f.p, assume_canonical=True)
    levels = compute_levels(Bw, piv_cols)
    from ._host.elimination import mutual_reduce

    R, ok = mutual_reduce(f, B, piv_cols, levels, fill_cap=None)
    assert ok  # fill_cap=None: the RREF's fill is whatever it must be
    return SparseGFp.from_scipy(sp.csr_matrix(R), f.p,
                                assume_canonical=True)


def rref_qinv_of(R: SparseGFp):
    """qinv of a canonical RREF: its pivot columns are the rows' leading
    columns (which may differ from a factorization's pivot choices)."""
    qinv = np.full(R.m, -1, np.int64)
    if R.n:
        leads = R.indices[R.indptr[:-1]].astype(np.int64)
        qinv[leads] = np.arange(R.n)
    return qinv


def rref(fact: LU):
    """(R, Rqinv): canonical RREF of the row space + its qinv
    (``spasm_rref``, src/SpaSM.jl:869-871)."""
    R = rref_of_U(fact)
    return R, rref_qinv_of(R)


def kernel_from_rref(R: SparseGFp, qinv) -> SparseGFp:
    """Right-kernel basis from an RREF — ``spasm_kernel_from_rref``
    (src/SpaSM.jl:884).

    For each free column j (qinv[j] < 0, ascending), the kernel row is
        sum_k R[k, j] * e_{piv_col(k)}  -  e_j
    which matches the reference's output exactly (golden values in
    test/runtests.jl:17-24 and README.md:44-47)."""
    f = R.field
    r, m = R.shape
    qinv = np.asarray(qinv, np.int64)
    free_cols = np.flatnonzero(qinv < 0)
    piv_cols = np.full(r, -1, np.int64)
    piv_cols[qinv[qinv >= 0]] = np.flatnonzero(qinv >= 0)
    nfree = free_cols.size
    # Kernel row i (free column f = free_cols[i]) holds R's column-f
    # values at the pivots' columns plus the -1 at f itself.  R's CSC is
    # R.T's CSR, so the per-free-column slices come from ONE parallel row
    # gather of the transpose; pivot columns ascend with the pivot index
    # in a canonical RREF, so each gathered row is already column-sorted
    # and only the -1 entry needs splicing in at its sorted position —
    # no COO round-trip over the kernel's nnz.
    Rc = R.to_scipy().tocsc()
    RT = sp.csr_matrix((Rc.data, Rc.indices, Rc.indptr), shape=(m, r))
    from ._host.native import gather_rows_native

    sub = gather_rows_native(RT, free_cols)
    if sub is None:
        sub = sp.csr_matrix(RT[free_cols])
    counts = np.diff(sub.indptr).astype(np.int64)
    bulk_cols = piv_cols[sub.indices]            # ascending per row
    bulk_vals = np.asarray(sub.data, np.int64)
    nbulk = bulk_cols.size
    # position of the -1 entry in each row = #bulk entries left of f
    f_rep = np.repeat(free_cols, counts)
    less = bulk_cols < f_rep
    csum = np.zeros(nbulk + 1, np.int64)
    np.cumsum(less, out=csum[1:])
    pos = csum[sub.indptr[1:]] - csum[sub.indptr[:-1]]
    indptr = np.zeros(nfree + 1, np.int64)
    np.cumsum(counts + 1, out=indptr[1:])
    total = int(indptr[-1])
    indices = np.empty(total, np.int64)
    data = np.empty(total, np.int64)
    # bulk destinations: base + local index, +1 past the spliced -1
    local = np.arange(nbulk, dtype=np.int64) - np.repeat(
        sub.indptr[:-1].astype(np.int64), counts)
    dest = np.repeat(indptr[:-1], counts) + local + (
        local >= np.repeat(pos, counts))
    indices[dest] = bulk_cols
    data[dest] = bulk_vals
    mdest = indptr[:-1] + pos
    indices[mdest] = free_cols
    data[mdest] = -1
    return SparseGFp(f, nfree, m, indptr,
                     indices.astype(np.int32), data.astype(np.int32),
                     _canonical=True)


def kernel(obj, verbose=False, **kwargs) -> SparseGFp:
    """Right-null-space basis: (m - r) rows x with obj @ x.T == 0
    (``spasm_kernel``, src/SpaSM.jl:874-884; one-stop :1147)."""
    if isinstance(obj, SparseGFp):
        fact = echelonize(obj, verbose=verbose, **kwargs)
    else:
        fact = obj
    with push_verbose(bool(verbose)):
        t0 = wtime()
        log(f"[kernel] start. U is {fact.U.shape[0]} x {fact.U.shape[1]} "
            f"({fact.U.nnz} nnz)")
        R = rref_of_U(fact)
        K = kernel_from_rref(R, rref_qinv_of(R))
        log(f"[kernel] done in {wtime() - t0:.1f}s. NNZ(K) = {K.nnz}")
    return K


def rank(obj, *, device="cuda", **kwargs) -> int:
    """``rank`` one-stop (src/SpaSM.jl:1149): the exact rank of a
    SparseGFp echelonized on ``device``, or the rank of an LU."""
    if isinstance(obj, LU):
        return obj.r
    return echelonize(obj, device=device, **kwargs).r


def kernel_pivots(A: SparseGFp, **kwargs):
    """kernel + the free columns its support hits
    (src/SpaSM.jl:1151-1170)."""
    fact = echelonize(A, **kwargs)
    k = kernel(fact)
    free = set(np.flatnonzero(fact.qinv < 0).tolist())
    hit = sorted({int(j) for j in k.indices if int(j) in free})
    return k, np.array(hit, np.int64)


# ---------------- solves ----------------


def _solve_vs_U(fact: LU, B_sp):
    """Reduce rows of B against U, returning (coefficients Y, residual)."""
    f = fact.field
    res, Y = wave_eliminate(f, fact.U.to_scipy(), fact.piv_cols,
                            fact.levels, B_sp, record_coeffs=True)
    return Y, res


def _prep_triangular_Lp(f: Field, Lp, order=None):
    """One-time preparation for solving Z @ Lp == Y: conjugate by the slot
    permutation ``order`` (LU.lp_order — rounds recorded against the
    reduced pivot block have upper-triangular diagonal L blocks, made
    lower-triangular by reversing their slot order), scale to unit
    diagonal, reverse (row k of a lower-triangular Lp has entries only at
    columns <= k, so the REVERSED pivot list satisfies the append
    invariant), and compute the wave levels.  The result is reusable
    across solves (cached on the LU by _solve_zLp)."""
    r = Lp.shape[0]
    if order is not None:
        order = np.asarray(order, np.int64)
        Lp = sp.csr_matrix(Lp)[order][:, order]
    M = sp.csr_matrix(Lp)
    diag = M.diagonal().astype(np.int64)
    scales = f.inv(diag)
    row_of = np.repeat(np.arange(r), np.diff(M.indptr))
    M.data = f.normalize(M.data * scales[row_of])  # unit diagonal
    rev = np.arange(r - 1, -1, -1, dtype=np.int64)
    Mo = sp.csr_matrix(M)[rev]
    # Mo's data is already normalized (balanced); an in-place per-row
    # index sort (no-op when scipy's flag is set) is all that canonical
    # form still needs — the full from_scipy canonicalization re-reduced
    # every value (~1.8 s at d9's 26M-nnz L pivot block)
    Mo.sort_indices()
    Mw = SparseGFp.from_scipy(Mo, f.p, assume_canonical=True)
    levels = compute_levels(Mw, rev)
    return dict(Mo=Mo, rev=rev, levels=levels,
                scales_u=f.to_unsigned(scales), order=order, r=r)


def _apply_triangular_Lp(f: Field, prep, Y):
    """Solve Z @ Lp == Y using a _prep_triangular_Lp state.

    Z @ Lp = Y expresses Y's rows as combinations of Lp's rows, so we
    wave-eliminate Y against Lp itself and read the coefficients."""
    order = prep["order"]
    if order is not None:
        Y = sp.csr_matrix(Y)[:, order]
    res, C = wave_eliminate(f, prep["Mo"], prep["rev"], prep["levels"], Y,
                            record_coeffs=True)
    assert res.nnz == 0, "triangular Lp solve must be exact"
    # map reversed coefficient slots back and undo the row scaling:
    # y = sum c_k' (Lp[k]/v_k)  =>  z_k = c_k' * inv(v_k)
    Cc = sp.csr_matrix(C).tocoo()
    orig = prep["rev"][Cc.col]
    data = f.normalize(Cc.data.astype(np.int64) * prep["scales_u"][orig])
    if order is not None:
        orig = order[orig]
    return sp.csr_matrix((data, (Cc.row, orig)),
                         shape=(Y.shape[0], prep["r"]))


def _solve_triangular_Lp(f: Field, Lp, Y, order=None):
    """One-shot prepare + apply (see _prep_triangular_Lp)."""
    return _apply_triangular_Lp(f, _prep_triangular_Lp(f, Lp, order), Y)


def _dense_block_inverse(fact: LU):
    """Inverse of the dense-finish corner block D = Lp[ds:, ds:] (a general
    invertible matrix — coefficients of rows against an RREF).  Computed
    once on the LU's device via augmented Jordan RREF; cached on the LU."""
    cached = getattr(fact, "_dinv_cache", None)
    if cached is not None:
        return cached
    from .ops import dense as dense_ops
    f = fact.field
    ds = fact.dense_piv_start
    D = fact.L.select_rows(fact.p[ds:]).to_scipy()[:, ds:].toarray()
    out = dense_ops.rref(f, D, want_transform=True, device=fact._device)
    assert out["rank"] == D.shape[0], "dense L block must be invertible"
    # T @ D == R where R is the scattered permuted identity with
    # R[piv_rows[k], piv_cols[k]] == 1; hence row piv_cols[k] of D^-1 is
    # row piv_rows[k] of T
    dinv = np.empty_like(out["T"])
    dinv[out["piv_cols"]] = out["T"][out["piv_rows"]]
    fact._dinv_cache = dinv
    return dinv


def _solve_zLp(fact: LU, Y):
    """Solve Z @ Lp == Y where Lp = L[p] is the (r x r) pivot-row block of
    L.  Lp is lower-triangular in pivot order except for an optional dense
    corner block from the dense finish:  Lp = [[T, 0], [C, D]].  Solve
    z_d @ D = y_d densely, then z_s @ T = y_s - z_d @ C by waves."""
    f = fact.field
    r = fact.r
    if r == 0:
        return sp.csr_matrix((Y.shape[0], 0), dtype=np.int64)
    Y = sp.csr_matrix(Y)
    ds = fact.dense_piv_start if fact.dense_piv_start is not None else r
    order = fact.lp_order  # None = identity; covers the sparse prefix
    # the triangular-solve preparation (row gather, conjugation, reversal,
    # wave levels) costs as much as a solve at millions of pivots — cache
    # it on the LU (certificate creation alone calls this twice)
    cache = getattr(fact, "_lp_solve_cache", None)
    if cache is None:
        Lp = fact.L.select_rows(fact.p).to_scipy()  # (r, r)
        if ds >= r:
            prep = _prep_triangular_Lp(f, Lp, order)
            C_blk = None
        else:
            prep = _prep_triangular_Lp(
                f, Lp[:ds, :ds],
                None if order is None else order[:ds]) if ds else None
            C_blk = Lp[ds:, :ds]
        cache = dict(ds=ds, prep=prep, C_blk=C_blk)
        fact._lp_solve_cache = cache
    ds, prep, C_blk = cache["ds"], cache["prep"], cache["C_blk"]
    if ds >= r:
        return _apply_triangular_Lp(f, prep, Y)
    Y_s, Y_d = Y[:, :ds], Y[:, ds:]
    # z_d @ D = y_d  ->  z_d = y_d @ D^-1
    dinv = _dense_block_inverse(fact)
    Z_d = mod_reduce(sp.csr_matrix(
        _spgemm_dense_rhs(f, Y_d, dinv)), f)
    if ds:
        from ._host.sputil import safe_spgemm

        rhs = mod_reduce(Y_s - safe_spgemm(f, Z_d, C_blk), f)
        Z_s = _apply_triangular_Lp(f, prep, rhs)
    else:
        Z_s = sp.csr_matrix((Y.shape[0], 0), dtype=np.int64)
    return sp.csr_matrix(sp.hstack([Z_s, Z_d], format="csr"))


def _spgemm_dense_rhs(f: Field, A_sp, B_dense):
    """A_sp (sparse) @ B_dense (small dense), exact in int64."""
    half = max(1, f.halfp)
    safe_k = max(1, (1 << 62) // (half * half))
    A_sp = sp.csr_matrix(A_sp)
    B_dense = np.asarray(B_dense, np.int64)
    k = A_sp.shape[1]
    if k <= safe_k:
        return sp.csr_matrix(f.normalize(A_sp @ B_dense))
    acc = np.zeros((A_sp.shape[0], B_dense.shape[1]), np.int64)
    for c0 in range(0, k, safe_k):
        c1 = min(k, c0 + safe_k)
        acc = f.normalize(acc + f.normalize(A_sp[:, c0:c1] @ B_dense[c0:c1]))
    return sp.csr_matrix(acc)



def solve(fact: LU, b):
    """Solve x @ A == b for one dense RHS b (length m) given the
    factorization of A (``spasm_solve``, src/SpaSM.jl:889-905).  Requires
    opts.L.  Returns x (length n) or None if inconsistent."""
    if fact.L is None:
        raise ValueError("solve requires a factorization with L "
                         "(echelonize(..., L=True))")
    f = fact.field
    b = np.asarray(f.normalize(np.asarray(b)), np.int64)
    assert b.shape == (fact.m,)
    B = sp.csr_matrix(b.reshape(1, -1))
    Y, res = _solve_vs_U(fact, B)
    if res.nnz:
        return None
    Z = _solve_zLp(fact, Y)
    x = np.zeros(fact.n, np.int64)
    Zc = Z.tocoo()
    x[fact.p[Zc.col]] = f.normalize(Zc.data)
    return x


def gesv(fact: LU, B: SparseGFp, verbose=False):
    """Solve X @ A == B sparse multi-RHS (``spasm_gesv``,
    src/SpaSM.jl:907-923).  Returns (X, ok) with per-row solvable flags;
    unsolvable rows of X are zero."""
    if fact.L is None:
        raise ValueError("gesv requires a factorization with L")
    f = fact.field
    assert B.m == fact.m
    with push_verbose(bool(verbose)):
        Y, res = _solve_vs_U(fact, B.to_scipy())
        bad = np.zeros(B.n, bool)
        bad[np.unique(sp.coo_matrix(res).row)] = True
        ok = ~bad
        Z = _solve_zLp(fact, sp.csr_matrix(Y.multiply(
            sp.csr_matrix(ok.astype(np.int64).reshape(-1, 1)))))
        Zc = Z.tocoo()
        X = SparseGFp.from_coo(f, B.n, fact.n, Zc.row, fact.p[Zc.col],
                               Zc.data, sum_duplicates=False)
    return X, ok


def sparse_triangular_solve(U, B: SparseGFp, qinv=None):
    """Solve X @ U == B where U is permuted-triangular with unit pivots
    located by qinv (``spasm_sparse_triangular_solve`` batched over the
    rows of B, src/SpaSM.jl:694-755).  U may be an LU (then its U/qinv are
    used).  Returns X or None if any row has no solution."""
    if isinstance(U, LU):
        fact = U
        Usp, qinv = fact.U, fact.qinv
    else:
        Usp = U
    f = Usp.field
    r, m = Usp.shape
    assert B.m == m
    qinv = np.asarray(qinv, np.int64)
    piv_of_row = np.full(r, -1, np.int64)
    sel = np.flatnonzero(qinv >= 0)
    piv_of_row[qinv[sel]] = sel
    if (piv_of_row < 0).any():
        raise ValueError("qinv does not give a pivot for every row of U")
    # general triangular set: topologically order, then wave-eliminate
    order = topo_order(Usp, piv_of_row)
    Uo = Usp.select_rows(order)
    cols_o = piv_of_row[order]
    levels = compute_levels(Uo, cols_o)
    res, C = wave_eliminate(f, Uo.to_scipy(), cols_o, levels, B.to_scipy(),
                            record_coeffs=True)
    if res.nnz:
        return None
    Cc = C.tocoo()
    return SparseGFp.from_coo(f, B.n, r, Cc.row, order[Cc.col], Cc.data,
                              sum_duplicates=False)


def dense_back_solve(L: SparseGFp, b, p):
    """Solve x @ L == b densely; L (n x m) permuted lower-triangular with
    nonzero diagonal located by p (p[j] = row of the diagonal entry of
    column j) — ``spasm_dense_back_solve`` (src/SpaSM.jl:663-677)."""
    from ._host.native import dense_trisolve_native

    f = L.field
    n, m = L.shape
    b = np.asarray(f.normalize(np.asarray(b)), np.int64).copy()
    p = np.asarray(p, np.int64)
    nat = dense_trisolve_native("back", L, b, p, f.p)
    if nat is not NotImplemented:
        return nat
    x = np.zeros(n, np.int64)
    for j in range(m - 1, -1, -1):
        if b[j] == 0:
            continue
        i = p[j]
        ji, vi = L.row(i)
        hit = np.searchsorted(ji, j)
        if hit >= ji.size or ji[hit] != j:
            return None
        coef = f.mul(b[j], f.inv(vi[hit]))
        x[i] = coef
        b[ji] = f.normalize(b[ji] - coef * vi.astype(np.int64))
    if b.any():
        return None
    return x


def dense_forward_solve(U: SparseGFp, b, q):
    """Solve x @ U == b densely; U (n x m) permuted upper-triangular with
    unit pivots, q[i] = pivot column of row i —
    ``spasm_dense_forward_solve`` (src/SpaSM.jl:679-692)."""
    from ._host.native import dense_trisolve_native

    f = U.field
    n, m = U.shape
    b = np.asarray(f.normalize(np.asarray(b)), np.int64).copy()
    q = np.asarray(q, np.int64)
    nat = dense_trisolve_native("forward", U, b, q, f.p)
    if nat is not NotImplemented:
        return nat
    x = np.zeros(n, np.int64)
    for i in range(n):
        j = q[i]
        if b[j] == 0:
            continue
        ji, vi = U.row(i)
        x[i] = b[j]
        b[ji] = f.normalize(b[ji] - x[i] * vi.astype(np.int64))
    if b.any():
        return None
    return x
