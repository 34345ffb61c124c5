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

The reference's control flow stays on the device, as its ``lax.cond`` /
``while_loop`` do: the rank, the pivot slots, the empty-panel test, the
group predicate ``rank > rank_in`` and the early exit are tensors, which
the kernels read (K2 and K1 take a one-byte run flag and return at once
where it is 0).  Captured into a CUDA graph, ``rref_inplace`` makes no host
read: each group of panels runs under its predicate (the early exit, and
a nonzero in the group's columns) as a conditional node of the graph
(``_cuda.graph_if``), so that a replay runs only the groups that can hold
a pivot.  Run eagerly, it reads that predicate on the host once per group
and launches nothing for a group that is dead or empty; the plain
versions on the CPU also read their predicates on the host, as JAX's
``lax.cond`` evaluates on the CPU.  The bits are the same either way.

``fused_blocked_finish`` is the reference's single-dispatch dense finish:
the COO densified once, then the block loop.  On a card it becomes one
CUDA graph with no host read, captured on the second call of a bucketed
shape (``_bucket``, as the reference's ``jax.jit`` caches by bucket) and
replayed after.
"""

from __future__ import annotations

import collections
import time

import numpy as np
import torch

from . import _cuda, modmul
from .matmul import modmatmul

DEFAULT_PANEL = 128


def _panel_eliminate(f, P: torch.Tensor, is_piv_row: torch.Tensor, j0: int,
                     npivcols: int, run: torch.Tensor = None):
    """Plain PyTorch Jordan elimination of the (n, c) panel P whose first
    column is global column j0; only global columns < npivcols may hold
    pivots.  The pivot of column jj is the first non-pivot row with a
    nonzero there.  The scaling is folded into the coefficient
    (beta[pr] = pinv - 1, beta[i] = -P[i, jj] * pinv), so
    ``row_i_final = X_i + G_i @ X[prows]``.

    Returns (P', G, prow, pcol, pfound, is_piv'); slot k of G, prow, pcol
    is the k-th pivot found, unused slots are 0 / 0 / False.  The inputs
    are not modified.  Where ``run`` (a 0-d bool tensor, read here on the
    host) holds False nothing is eliminated: P, zero G / prow / pcol, no
    pivot and is_piv_row come back, the reference's empty-panel branch."""
    n, c = P.shape
    dev = P.device
    P = P.clone()
    is_piv = is_piv_row.clone()
    G = torch.zeros((n, c), dtype=torch.int32, device=dev)
    prow = torch.zeros(c, dtype=torch.int32, device=dev)
    pcol = torch.zeros(c, dtype=torch.int32, device=dev)
    pfound = torch.zeros(c, dtype=torch.bool, device=dev)
    if run is not None and not bool(run):
        return P, G, prow, pcol, pfound, is_piv
    kk = 0
    for jj in range(c):
        if j0 + jj >= npivcols:
            break
        col = P[:, jj]
        cand = torch.nonzero((col != 0) & ~is_piv)
        if cand.numel() == 0:
            continue
        pr = int(cand[0, 0])
        pinv = _balanced(pow(int(col[pr]) % f.p, f.p - 2, f.p), f.p)
        beta = modmul.mul(f, modmul.neg(f, col), pinv)
        beta[pr] = _balanced(pinv - 1, f.p)
        # only the rows with beta != 0 change; a non-pivot row is zero left
        # of jj, and G's slots past kk are unused: the update leaves those
        # columns as they are
        rows = torch.nonzero(beta).view(-1)
        b = beta[rows, None]
        g_row = G[pr, :kk + 1].clone()
        g_row[kk] += 1
        P[rows, jj:] = modmul.axpy(f, b, P[pr, jj:], P[rows, jj:])
        G[rows, :kk + 1] = modmul.axpy(f, b, g_row, G[rows, :kk + 1])
        is_piv[pr] = True
        prow[kk] = pr
        pcol[kk] = jj
        pfound[kk] = True
        kk += 1
    return P, G, prow, pcol, pfound, is_piv


def _balanced(v: int, p: int) -> int:
    v %= p
    return v - p if v > p // 2 else v


def _one_panel(f, P, is_piv, j0, npivcols, run, out):
    """The Jordan elimination of panel P in place: P and is_piv updated,
    out = (G, prow, pcol, pfound, scratch) written (K2 on CUDA, with no
    allocation; the plain version on the CPU)."""
    if P.is_cuda:
        from .cuda_panel import panel_eliminate_cuda

        panel_eliminate_cuda(f, npivcols, P, is_piv, j0, run=run, out=out)
        return
    got = _panel_eliminate(f, P, is_piv, j0, npivcols, run)
    for dst, src in zip((P, *out[:4], is_piv), got):
        dst.copy_(src)


# panels per full-width rank-c correction on CUDA: the K panels of a group
# share ONE whole-matrix matmul; cross-panel consistency inside a group
# comes from small window corrections, and the corrected pivot rows are
# resolved once per group by an exact Neumann inverse of the strictly
# block-lower coefficient matrix
PANEL_GROUP = 4
_FORCE_GROUP = None  # tests override to exercise grouping on the CPU


def _group_size(device) -> int:
    return _FORCE_GROUP or (PANEL_GROUP if torch.device(device).type
                            == "cuda" else 1)


def rref_groups(npivcols: int, panel: int, device) -> int:
    """The panel groups of one ``rref_inplace`` with ``npivcols`` pivot
    columns on ``device``: the groups a finish's RREF reaches, whether
    their bodies run or not."""
    npan = -(-npivcols // panel)
    return -(-npan // _group_size(device))


def _group_buffers(f, n: int, m_pad: int, panel: int, group: int,
                   nmax: int, dev):
    """Every tensor a panel group's body writes, but the RREF's state: one
    set per ``rref_inplace``, made on the caller's stream, so that the
    bodies (captured on a stream of their own) allocate no more than the
    reductions' scratch, from the capture's pool for its bodies."""
    c, Kc = panel, group * panel
    i32 = dict(dtype=torch.int32, device=dev)
    i64 = dict(dtype=torch.int64, device=dev)
    b = dict(dtype=torch.bool, device=dev)
    w = dict(
        P=torch.empty((group, n, c), **i32),        # the panels, in place
        G=torch.empty((group, n, c), **i32),        # their corrections
        prow=torch.empty((group, c), **i32),
        pcol=torch.empty((group, c), **i32),
        pfound=torch.empty((group, c), **b),
        scratch=torch.empty(2 * n, **i32),
        prows=torch.empty((group, c), **i64),
        found=torch.empty(group, **b),
        Rwin=torch.empty((max(1, group - 1), c, c), **i32),
        slot=torch.arange(c, device=dev),
        at=torch.empty(c, **i64), val=torch.empty(c, **i64),
        count=torch.empty((), **i32), rank_in=torch.empty((), **i32),
        run=torch.empty((), **b), grew=torch.empty((), **b),
        flag=torch.empty((), **b), pred=torch.empty((), **b),
        nmax=torch.full((), nmax, **i64), no_slot=torch.full((), -1, **i64),
        Gcat=torch.empty((n, Kc), **i32),
        Xrows=torch.empty((Kc, m_pad), **i32),
        row_nz=torch.empty(n, **b), free=torch.empty(n, **b),
        work=None)
    if group > 1:
        # L's diagonal blocks and the blocks above stay zero
        w.update(L=torch.zeros((Kc, Kc), **i32),
                 Lp=torch.empty((2, Kc, Kc), **i32),
                 T=torch.empty((2, Kc, Kc), **i32),
                 Rcat=torch.empty((Kc, m_pad), **i32))
    if dev.type == "cuda":
        from .cuda_matmul import planes_bytes

        # K1's limb planes, shared by the body's products in stream order:
        # the largest is the group's update (n, Kc) @ (Kc, m_pad)
        w["work"] = torch.empty(planes_bytes(max(n, Kc), Kc, m_pad, f.p),
                                dtype=torch.int8, device=dev)
    return w


def _group_body(f, X, gi: int, st: dict, w: dict, npivcols: int,
                npan: int, panel: int, group: int, nmax: int) -> None:
    """Panel group gi of ``rref_inplace``: its panels' eliminations and the
    full-width update, on the state st (X, is_piv, prow_of, pcol_of, rank,
    alive) in place, so that a body a replay skips leaves it as a dead group
    does.  Every other tensor it writes is one of ``w``'s."""
    c = panel
    rank, work = st["rank"], w["work"]
    L = w.get("L")

    def blk(k, l):
        return L[k * c:(k + 1) * c, l * c:(l + 1) * c]

    w["rank_in"].copy_(rank)
    for k in range(group):
        j0 = (gi * group + k) * c
        Xwin = X[:, j0:j0 + c]
        P = w["P"][k]
        P.copy_(Xwin)
        # corrected windows of the earlier panels' pivot rows at this
        # panel's columns: R_l|win = Xwin[prows_l] + sum_j C_lj R_j|win.
        # A panel without pivots has G_l == 0 and adds nothing, so its
        # products are skipped.
        for l in range(k):
            rw = w["Rwin"][l]
            torch.index_select(Xwin, 0, w["prows"][l], out=rw)
            for j in range(l):
                modmatmul(f, blk(l, j), w["Rwin"][j], out=rw,
                          run=w["found"][j], work=work)
            modmatmul(f, w["G"][l], rw, out=P, run=w["found"][l], work=work)
        # a window with no nonzero is a no-op panel: the kernel returns at
        # once (a body runs only while alive holds)
        torch.any(P, out=w["run"])
        pfound = w["pfound"][k]
        _one_panel(f, P, st["is_piv"], j0, npivcols, w["run"],
                   (w["G"][k], w["prow"][k], w["pcol"][k], pfound,
                    w["scratch"]))
        prows = w["prows"][k]
        prows.copy_(w["prow"][k])
        # C_kl coefficient blocks for the group-end resolve (unused slots
        # gather row 0; their Gcat columns are zero)
        for l in range(k):
            torch.index_select(w["G"][l], 0, prows, out=blk(k, l))
        torch.any(pfound, out=w["found"][k])
        # found slots are a prefix, in column order within the panel; the
        # writes of unused slots land in slot nmax
        at, val = w["at"], w["val"]
        torch.add(w["slot"], rank, out=at)
        torch.where(pfound, at, w["nmax"], out=at)
        torch.where(pfound, prows, w["no_slot"], out=val)
        st["prow_of"].scatter_(0, at, val)
        torch.add(w["pcol"][k], j0, out=val)
        torch.where(pfound, val, w["no_slot"], out=val)
        st["pcol_of"].scatter_(0, at, val)
        torch.sum(pfound, dim=0, dtype=torch.int32, out=w["count"])
        rank.add_(w["count"])
    # no pivot in the whole group: Gcat == 0 and X is unchanged
    grew = torch.gt(rank, w["rank_in"], out=w["grew"])
    torch.cat(tuple(w["G"]), dim=1, out=w["Gcat"])            # (n, K*c)
    torch.index_select(X, 0, w["prows"].view(-1), out=w["Xrows"])
    if group > 1:
        # T = I + L + .. + L^(K-1) = (I - L)^-1 (L is strictly block-lower)
        # by the Neumann product
        T, spare = w["T"][0], w["T"][1]
        T.copy_(L)
        T.diagonal().fill_(1)
        Lp = L
        for i in range((group - 1).bit_length() - 1):
            nxt = w["Lp"][i % 2]
            nxt.zero_()
            Lp = modmatmul(f, Lp, Lp, out=nxt, run=grew, work=work)
            # (I + Lp) T = T + Lp T
            spare.copy_(T)
            modmatmul(f, Lp, T, out=spare, run=grew, work=work)
            T, spare = spare, T
        Rcat = w["Rcat"]
        Rcat.zero_()
        modmatmul(f, T, w["Xrows"], out=Rcat, run=grew,
                  work=work)                                   # (Kc, m_pad)
    else:
        Rcat = w["Xrows"]
    modmatmul(f, w["Gcat"], Rcat, out=X, run=grew, work=work)
    # early exit: once every row with a nonzero in a pivot-eligible column
    # is a pivot row, the later groups are no-ops
    row_nz, flag = w["row_nz"], w["flag"]
    torch.any(X[:, :npan * panel], dim=1, out=row_nz)
    row_nz.logical_and_(torch.logical_not(st["is_piv"], out=w["free"]))
    st["alive"].logical_and_(torch.any(row_nz, out=flag))
    st["alive"].logical_and_(torch.lt(rank, nmax, out=flag))


def rref_inplace(f, X: torch.Tensor, npivcols: int,
                 panel: int = DEFAULT_PANEL, alive: torch.Tensor = None,
                 runs: torch.Tensor = None):
    """Blocked Jordan RREF of X (n, m) over GF(p).  Only the first
    ``npivcols`` columns are searched for pivots.

    Returns (R, rank, piv_row_of, piv_col_of, is_piv_row): R (n, m), rank
    a 0-d int32 tensor on X's device, ``piv_row_of[k]`` /
    ``piv_col_of[k]`` (min(n, npivcols),) int64 tensors giving the k-th
    pivot in column order (-1 past rank), and the (n,) pivot-row mask.  X
    itself is not modified.  ``alive`` (a 0-d bool tensor, default True)
    is the early exit's predicate on entry: False makes the whole RREF a
    no-op.  ``runs`` (a 0-d int64 tensor on X's device) takes the number
    of panel groups whose body ran (of ``rref_groups``).

    Panels run in groups of PANEL_GROUP on CUDA (1 on the CPU): within a
    group each panel sees the earlier panels' row operations only on its
    own column window and on its pivot rows, and the full-width update
    X += [G_1|..|G_K] @ [R_1;..;R_K] happens once per group.  This is exact,
    so the grouping does not change the result.

    The control flow is the reference's, on the device: a group's body
    (``_group_body``) runs under ``alive & any(X[:, group's columns] !=
    0)``, a panel's kernel under ``any(P != 0)``, the products of a panel's
    corrections under its ``any(pfound)``, the group's under ``rank >
    rank_in``, and ``alive`` becomes False once every row with a nonzero in
    a pivot-eligible column is a pivot row.  The kernels read these flags.
    Under a CUDA graph capture the host reads nothing: each group's body is
    captured into a conditional (IF) node on its predicate, so a replay
    runs only the groups that can hold a pivot, and ``runs`` adds the
    predicate on the card.  Otherwise the host reads the predicate once
    before each group, stops once ``alive`` is False (the later groups
    would be no-ops), skips an all-zero group, and adds its count of the
    bodies it ran to ``runs`` once at the end.  The state the bodies
    update (X's padded copy, rank, the pivot lists and mask, alive) is
    allocated before the first group and written in place, so a skipped
    body leaves it as a dead group does."""
    n, m = X.shape
    dev = X.device
    capture = X.is_cuda and torch.cuda.is_current_stream_capturing()
    nmax = min(n, npivcols)
    npan = -(-npivcols // panel)
    group = _group_size(dev)
    ngrp = rref_groups(npivcols, panel, dev)
    Kc = group * panel
    m_pad = max(m, ngrp * Kc)
    Xp = torch.zeros((n, m_pad), dtype=torch.int32, device=dev)
    Xp[:, :m] = X
    X = Xp
    # slot nmax takes the writes of unused slots and is cut off at the end
    # (the reference's scatter with mode="drop")
    st = dict(
        is_piv=torch.zeros(n, dtype=torch.bool, device=dev),
        prow_of=torch.full((nmax + 1,), -1, dtype=torch.int64, device=dev),
        pcol_of=torch.full((nmax + 1,), -1, dtype=torch.int64, device=dev),
        rank=torch.zeros((), dtype=torch.int32, device=dev),
        alive=(torch.ones((), dtype=torch.bool, device=dev) if alive is None
               else alive.clone()))
    w = _group_buffers(f, n, m_pad, panel, group, nmax, dev)
    ran = 0
    for gi in range(ngrp):
        g0 = gi * Kc
        if capture:
            pred = torch.any(X[:, g0:g0 + Kc], out=w["pred"])
            pred.logical_and_(st["alive"])
            if runs is not None:
                runs.add_(pred)
            with _cuda.graph_if(pred):
                _group_body(f, X, gi, st, w, npivcols, npan, panel, group,
                            nmax)
            continue
        # one read a group: stop once alive is False, and skip a group
        # whose columns are all zero (its panels find no pivot and its
        # update is a no-op)
        live, nonzero = torch.stack(
            [st["alive"], X[:, g0:g0 + Kc].any()]).tolist()
        if not live:
            break
        if not nonzero:
            continue
        _group_body(f, X, gi, st, w, npivcols, npan, panel, group, nmax)
        ran += 1
    if runs is not None and not capture:
        runs.add_(ran)
    return (X[:, :m], st["rank"], st["prow_of"][:nmax], st["pcol_of"][:nmax],
            st["is_piv"])


def _rref(f, X: torch.Tensor, npivcols: int, panel: int,
          want_transform: bool):
    n, m = X.shape
    if want_transform:
        X = torch.cat([X, torch.eye(n, dtype=torch.int32, device=X.device)],
                      dim=1)
    R, rank, prow_of, pcol_of, is_piv = rref_inplace(f, X, npivcols, panel)
    T = R[:, m:] if want_transform else None
    return R[:, :m], rank, prow_of, pcol_of, is_piv, T


# below this element count ``rref`` runs the host NumPy elimination, and a
# dense finish of smaller blocks runs its streaming loop on CPU tensors
HOST_CUTOFF = 1 << 20
# large primes make the host int64 product chunk to a few columns, so the
# crossover drops (same constants as the reference)
HOST_CUTOFF_BIGP = 1 << 16


def host_cutoff_for(f) -> int:
    """Element-count crossover between the host and the tensor path on
    the device (``rref``; a dense finish's block), as a function of the
    prime (as the reference)."""
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
    rank = int(rank)
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
    out = torch.empty(shape, dtype=torch.int32, device=device)
    _densify_into(out, *(torch.as_tensor(x).to(device)
                         for x in (rows, cols, vals)))
    return out


def count_nonzero_device(X: torch.Tensor) -> int:
    return int(torch.count_nonzero(X))


def upload_csr(f, S, alive_cols, device):
    """The dense finish's input on ``device``, for S (scipy CSR, n_s rows)
    whose live columns are ``alive_cols`` (increasing, numpy): S goes up as
    its CSR (``upload``: indptr int64, indices int32, data int32 where it
    is, else int64), and its COO is formed there with no host read: each
    entry's row from indptr (``repeat_interleave`` with the count the host
    knows), its column through the map from S's columns to the finish's
    (``alive_cols`` goes up, 4 B a column, only where a column of S is not
    alive: else the map is the identity), its value balanced
    (``modmul.normalize``).  Entries keep S's order, so the COO densifies
    to the same X as S's ``tocoo()`` with its columns mapped and its values
    normalized on the host.

    Returns (rows int64, cols int32, vals int32, alive): alive the uploaded
    ``alive_cols`` (int32) or None for the identity, U's column map in
    ``extract_u_csr``."""
    indptr = upload(S.indptr, np.int64, device)
    cols = upload(S.indices, np.int32, device)
    vals = upload(S.data, np.int32 if S.data.dtype == np.int32 else np.int64,
                  device)
    rows = torch.repeat_interleave(indptr[1:] - indptr[:-1],
                                   output_size=int(S.indptr[-1]))
    alive = None
    if alive_cols.size < S.shape[1]:
        alive = upload(alive_cols, np.int32, device)
        colmap = torch.full((S.shape[1],), -1, dtype=torch.int32,
                            device=device)
        colmap.index_copy_(0, alive.long(), torch.arange(
            alive.numel(), dtype=torch.int32, device=device))
        cols = colmap.index_select(0, cols)
    return rows, cols, modmul.normalize(f, vals), alive


def extract_u_csr(Ud: torch.Tensor, pc_map: torch.Tensor, r_d: int, na: int,
                  alive: torch.Tensor = None):
    """The finish's block of U as its canonical CSR, built on Ud's device
    and read back in one copy: Ud[:r_d] is the accumulated panel in full
    mutual RREF over the finish's na columns, its rows in pivot-slot order
    with pivot columns ``pc_map[:r_d]``, so each pivot column is a unit
    vector and only the other (free) columns are scanned.  ``alive`` maps
    the finish's columns to U's (increasing; None: the identity).

    The free columns are compacted to (r_d, na - r_d); their nonzeros come
    in row-major order from ``torch.nonzero`` (the one read of a count),
    already sorted within each row since the columns and the map increase;
    each row's unit entry goes in after the nonzeros left of its pivot
    column, found by a ``searchsorted`` of the flat keys row * nf + col,
    as are the rows' starts.  Returns numpy (indptr int64 (r_d + 1,), indices
    int32, data int32): balanced values, no zeros, sorted indices, rows in
    pivot-slot order, as ``sputil.mod_reduce`` gives of U's host CSR."""
    dev = Ud.device
    i64 = dict(dtype=torch.int64, device=dev)
    nf = na - r_d
    pc = pc_map[:r_d]
    free = torch.ones(na, dtype=torch.bool, device=dev)
    free[pc] = False
    upto = torch.cumsum(free, 0)     # free columns up to each column
    slot = torch.where(free, upto - 1, nf)
    free_cols = torch.empty(nf + 1, **i64).scatter_(
        0, slot, torch.arange(na, **i64))[:nf]
    C = Ud[:r_d].index_select(1, free_cols)
    keys = torch.nonzero(C.view(-1)).view(-1)
    row = torch.div(keys, max(nf, 1), rounding_mode="floor")
    col = keys - row * nf
    left = upto[pc]                  # free columns left of each pivot
    ar = torch.arange(r_d + 1, **i64)
    indptr = torch.searchsorted(keys, ar * nf) + ar
    unit = torch.searchsorted(keys, ar[:-1] * nf + left) + ar[:-1]
    at = torch.arange(keys.numel(), **i64) + row + (col >= left[row])
    gcol = torch.arange(na, **i64) if alive is None else alive.long()
    nnz = keys.numel() + r_d
    head = 2 * (r_d + 1)
    out = torch.empty(head + 2 * nnz, dtype=torch.int32, device=dev)
    out[:head].view(torch.int64).copy_(indptr)
    ind, dat = out[head:head + nnz], out[head + nnz:]
    ind.index_copy_(0, at, gcol[free_cols][col].int())
    ind.index_copy_(0, unit, gcol[pc].int())
    dat.index_copy_(0, at, C.view(-1)[keys])
    dat.index_fill_(0, unit, 1)
    buf = to_host(out).numpy()
    return buf[:head].view(np.int64), buf[head:head + nnz], buf[head + nnz:]


# elements of the accumulated panel back-eliminated per K1 call (2**27:
# one call at the flagship's 8192^2, 1 GiB for each int64 temporary)
SUB_CHUNK = 1 << 27


def blocked_finish_step(f, shape, panel: int, rows, cols, vals,
                        Ud: torch.Tensor, pc_map: torch.Tensor, r_d: int):
    """One step of the blocked dense finish: densify the block's COO slice,
    then ``_block_body``: eliminate it against the accumulated mutual-RREF
    panel Ud[:r_d] (one K1 matmul), Jordan-RREF it, back-eliminate Ud[:r_d]
    against the new pivots and append them.

    shape = (rows of this block, na).  Ud (cap, na) and pc_map (cap,)
    int64 are updated in place (the reference donates them); cap must hold
    r_d plus the block's rows: the finish's rank bound min(rows, cols) plus
    a block always does (``stream_buffers``).  Returns (r_d', new_rank,
    prow_of, pcol_of, groups_run) (``_read_step``): prow_of / pcol_of CPU
    tensors, the last the panel groups whose body the step's RREF ran (of
    ``rref_groups(shape[1], panel, device)``).  One read a step, the
    block's rank and pivots.

    On a card, with the buffers of ``stream_buffers``, the step is replayed
    as a CUDA graph (``_step_on_card``)."""
    if Ud.is_cuda and _stream.get("Ud") is Ud:
        with torch.cuda.device(Ud.device):
            return _step_on_card(f, shape, panel, rows, cols, vals, Ud,
                                 pc_map, r_d)
    X = densify_coo(shape, rows, cols, vals, Ud.device)
    rd = torch.full((), r_d, dtype=torch.int64, device=Ud.device)
    return _read_step(_step_meta(f, X, Ud, pc_map, rd, r_d, shape[1], panel),
                      r_d, shape[0])


# The streaming finish's state on a card: its accumulated panel Ud and
# pc_map, kept from call to call of one (device, rows, na), and the CUDA
# graphs of its steps, which read and write them in place.  A step's graph
# is keyed by (p, block shape, panel, panel group, K), K the bucketed rank
# so far (``_bucket``); it is captured on a key's second step, the first
# running ``_block_body`` eagerly (the warm-up the capture asks for), and
# replayed after.  The graphs share one memory pool, and one for their IF
# bodies (``_cuda.capture``): a step's transients live only through its
# replay.  ``release_finish_graphs`` frees it all.
_stream: dict = {}


def stream_buffers(rows: int, na: int, device):
    """Zeroed (Ud (rows, na) int32, pc_map (rows,) int64) for the streaming
    finish.  On a card, the same tensors as the last call of this shape
    (another shape drops them and the step graphs), so that the block
    steps replay the graphs captured on them."""
    device = torch.device(device)
    if device.type != "cuda":
        return (torch.zeros((rows, na), dtype=torch.int32, device=device),
                torch.zeros(rows, dtype=torch.int64, device=device))
    key = (device.index, rows, na)
    if _stream.get("key") != key:
        _stream.clear()
        _stream.update(
            key=key, graphs={}, seen=set(),
            Ud=torch.zeros((rows, na), dtype=torch.int32, device=device),
            pc_map=torch.zeros(rows, dtype=torch.int64, device=device))
    else:
        _stream["Ud"].zero_()
        _stream["pc_map"].zero_()
    return _stream["Ud"], _stream["pc_map"]


def _step_on_card(f, shape, panel, rows, cols, vals, Ud, pc_map, r_d):
    dev = Ud.device
    K = min(_bucket(r_d), Ud.shape[0]) if r_d else 0
    key = (f.p, *shape, panel, _FORCE_GROUP or PANEL_GROUP, K)
    entry = _stream["graphs"].get(key)
    if entry is None:
        X = torch.empty(shape, dtype=torch.int32, device=dev)
        rd = torch.full((), r_d, dtype=torch.int64, device=dev)
        _densify_into(X, *(torch.as_tensor(x).to(dev)
                           for x in (rows, cols, vals)))
        if key not in _stream["seen"]:
            _stream["seen"].add(key)
            meta = _step_meta(f, X, Ud, pc_map, rd, K, shape[1], panel)
        else:
            if "pool" not in _stream:
                _stream["pool"] = torch.cuda.graph_pool_handle()
                _stream["bodies"] = _cuda.body_pool(dev)
            graph = torch.cuda.CUDAGraph()
            with _cuda.capture(graph, dev, _stream["pool"],
                               _stream["bodies"]):
                meta = _step_meta(f, X, Ud, pc_map, rd, K, shape[1], panel)
            _stream["graphs"][key] = dict(graph=graph, X=X, rd=rd,
                                          meta=meta)
            graph.replay()
    else:
        _densify_into(entry["X"], *(torch.as_tensor(x).to(dev)
                                    for x in (rows, cols, vals)))
        entry["rd"].fill_(r_d)
        entry["graph"].replay()
        meta = entry["meta"]
    return _read_step(meta, r_d, shape[0])


def _step_meta(f, X, Ud, pc_map, rd, K, npiv, panel):
    """``_block_body`` of a streaming step, and what the host reads of it
    in one copy: [new_rank, groups run, prow_of, pcol_of]."""
    runs = torch.zeros((), dtype=torch.int64, device=X.device)
    new_rank, prow_of, pcol_of, _ = _block_body(f, X, Ud, pc_map, rd, K,
                                                npiv, panel, runs)
    return torch.cat([new_rank.view(1).long(), runs.view(1), prow_of,
                      pcol_of])


def _read_step(meta, r_d: int, n: int):
    """The host's one read of a step of ``n`` block rows, its meta of
    ``_step_meta``: (r_d', new_rank, prow_of, pcol_of, groups_run), the
    pivot lists as CPU tensors."""
    meta = to_host(meta)
    new_rank = int(meta[0])
    return r_d + new_rank, new_rank, meta[2:2 + n], meta[2 + n:], int(meta[1])


# element-count cap for the fused finish: the densified matrix (n_pad x na)
# must stay comfortably inside device memory next to the U panel and the
# product transients (3e8 int32 elements = 1.2 GB; the reference's value)
FUSED_BUDGET = 300_000_000


def _bucket(x: int) -> int:
    """Bucket the fused finish's shapes, as the reference does, so that a
    graph is captured once per bucket: powers of two up to 1024, then
    multiples of 1024."""
    if x <= 1024:
        b = 128
        while b < x:
            b <<= 1
        return b
    return -(-x // 1024) * 1024


# bytes that ``upload`` and ``to_host`` copied between the host and a
# card (none for CPU tensors): ``echelonize`` reports a finish's share as
# ``finish_copy_bytes``
COPY_BYTES = {"card": 0}


def upload(a, dtype, device) -> torch.Tensor:
    """A host array on ``device``; to a card from pinned memory with no
    synchronization, its bytes added to ``COPY_BYTES``."""
    t = torch.from_numpy(np.ascontiguousarray(a, dtype=dtype))
    if torch.device(device).type != "cuda":
        return t.to(device)
    COPY_BYTES["card"] += t.nbytes
    return t.pin_memory().to(device, non_blocking=True)


def to_host(t: torch.Tensor) -> torch.Tensor:
    """t on the CPU; from a card its bytes are added to ``COPY_BYTES``."""
    if t.is_cuda:
        COPY_BYTES["card"] += t.nbytes
    return t.cpu()


def _densify_into(X: torch.Tensor, rows, cols, vals) -> None:
    """X = 0, then the COO entries (tensors on X's device) added in."""
    X.zero_()
    at = rows.to(torch.int64, copy=True).mul_(X.shape[1]).add_(cols)
    X.view(-1).index_add_(0, at, vals.to(torch.int32))


def _block_body(f, Xb: torch.Tensor, Ud: torch.Tensor, pc_map: torch.Tensor,
                r_d: torch.Tensor, K: int, npiv: int, panel: int,
                runs: torch.Tensor = None):
    """One row block of the blocked finish on the device, with no host
    read, under the device predicate ``r_d < npiv``: eliminate Xb (bs, na)
    against Ud[:K], Jordan-RREF it, back-eliminate Ud[:K] against its new
    pivots and append them at r_d (a 0-d int64 tensor, not advanced here).
    The rows of Ud from r_d on are zero, so any static K >= r_d gives the
    same bits; Ud and pc_map need r_d + bs rows.  ``runs`` takes the
    RREF's count of the panel groups it ran (``rref_inplace``).  Returns
    (new_rank, prow_of, pcol_of, live): prow_of / pcol_of padded with -1
    to bs slots, live the predicate."""
    bs, na = Xb.shape
    nmax = min(bs, npiv)
    slot = torch.arange(bs, device=Xb.device)
    live_blk = r_d < npiv
    if K:
        # empty pc_map slots gather column 0 against zero Ud rows
        coeff = Xb.index_select(1, pc_map[:K])
        Xb = Xb.clone()
        modmatmul(f, modmul.neg(f, coeff), Ud[:K], out=Xb, run=live_blk)
    R, new_rank, prow_of, pcol_of, _ = rref_inplace(f, Xb, npiv, panel,
                                                    alive=live_blk, runs=runs)
    if nmax < bs:
        prow_of = torch.nn.functional.pad(prow_of, (0, bs - nmax), value=-1)
        pcol_of = torch.nn.functional.pad(pcol_of, (0, bs - nmax), value=-1)
    live = slot < new_rank
    gather = torch.where(live, prow_of.clamp(0, bs - 1), 0)
    newU = torch.where(live[:, None], R.index_select(0, gather), 0)
    npc = torch.where(live, pcol_of.clamp(0, na - 1), 0)
    if K:
        # back-eliminate the live rows of Ud, SUB_CHUNK elements a call
        nco = modmul.neg(f, torch.where(live[None, :],
                                        Ud[:K].index_select(1, npc), 0))
        step = max(1, SUB_CHUNK // na)
        for i in range(0, K, step):
            j = min(K, i + step)
            modmatmul(f, nco[i:j], newU, out=Ud[i:j], run=new_rank > 0)
    # append at r_d (rows past new_rank of newU and of Ud are zero)
    at = r_d + slot
    Ud.index_copy_(0, at, newU)
    pc_map.index_copy_(0, at, npc)
    return new_rank, prow_of, pcol_of, live_blk


def _fused_body(f, X: torch.Tensor, npiv: int, bs: int, panel: int):
    """The block loop of ``fused_blocked_finish`` on the dense (n_pad, na)
    X, with no host read: every block runs, under the device predicate
    ``r_d < npiv`` (the reference's while_loop condition), which the
    kernels of a block read; the K of a block's products is static.  The
    blocks' RREFs add the panel groups they ran to ``groups_run``."""
    n_pad, na = X.shape
    dev = X.device
    nblocks = n_pad // bs
    cap = _bucket(min(n_pad, npiv)) + bs
    Ud = torch.zeros((cap, na), dtype=torch.int32, device=dev)
    pc_map = torch.zeros(cap, dtype=torch.int64, device=dev)
    r_d = torch.zeros((), dtype=torch.int64, device=dev)
    ranks = torch.zeros(nblocks, dtype=torch.int64, device=dev)
    prows = torch.zeros((nblocks, bs), dtype=torch.int64, device=dev)
    pcols = torch.zeros((nblocks, bs), dtype=torch.int64, device=dev)
    groups_run = torch.zeros((), dtype=torch.int64, device=dev)
    for b in range(nblocks):
        # r_d <= b * bs, and the rows of Ud from r_d on are zero: the host
        # knows a static K for both products of this block (the reference
        # loops over KC-row chunks up to r_d on the device instead)
        new_rank, prow_of, pcol_of, live_blk = _block_body(
            f, X[b * bs:(b + 1) * bs], Ud, pc_map, r_d, min(b * bs, cap),
            npiv, panel, groups_run)
        ranks[b] = new_rank
        # a block the loop does not reach keeps the reference's zeros
        prows[b] = torch.where(live_blk, prow_of, 0)
        pcols[b] = torch.where(live_blk, pcol_of, 0)
        r_d = r_d + new_rank
    return Ud, pc_map, r_d, ranks, prows, pcols, groups_run


# CUDA graphs of the fused finish, by (p, device, n_pad, na, bs, panel, npiv,
# panel group), least recently used first.  One holds in device memory its
# static input (n_pad x na int32: 256 MiB at the flagship's 8192^2,
# ``input_bytes``) and its private pools, the graph's and its IF bodies':
# the outputs (Ud, cap x na int32) and every transient of one finish
# (``graph_bytes``).  A shape is captured
# on its second call: ``_seen`` holds the keys met once, which hold no
# memory.  ``release_finish_graphs`` frees both.
GRAPH_CACHE_SIZE = 2
_graphs: "collections.OrderedDict" = collections.OrderedDict()
_seen: "collections.OrderedDict" = collections.OrderedDict()
# how the last fused finish on a card ran: "graph" ("eager", "captured" or
# "replayed"), capture_s, graph_bytes, input_bytes
last_finish: dict = {}


def release_finish_graphs() -> None:
    """Free the cached CUDA graphs of the fused finish and of the
    streaming finish's steps (with its buffers), and forget the shapes
    met once."""
    _graphs.clear()
    _seen.clear()
    _stream.clear()
    if torch.cuda.is_initialized():
        torch.cuda.empty_cache()


def _fused_on_card(f, shape, npiv, bs, panel, rows, cols, vals):
    dev = rows.device
    group = _FORCE_GROUP or PANEL_GROUP
    key = (f.p, dev.index, *shape, bs, panel, npiv, group)
    entry = _graphs.get(key)
    if entry is not None:
        _graphs.move_to_end(key)
        _densify_into(entry["X"], rows, cols, vals)
        entry["graph"].replay()
        last_finish.update(graph="replayed", capture_s=0.0,
                           graph_bytes=entry["nbytes"],
                           input_bytes=entry["X"].nbytes)
        return entry["out"]
    if key not in _seen:
        # the first call of a shape runs eagerly: a process that finishes
        # once (the CLI, a script's one rank()) pays no capture
        _seen[key] = None
        while len(_seen) > 4 * GRAPH_CACHE_SIZE:
            _seen.popitem(last=False)
        X = torch.empty(shape, dtype=torch.int32, device=dev)
        _densify_into(X, rows, cols, vals)
        last_finish.update(graph="eager", capture_s=0.0, graph_bytes=0,
                           input_bytes=X.nbytes)
        return _fused_body(f, X, npiv, bs, panel)
    # the second: capture on a side stream (the first call was the warm-up
    # PyTorch asks for), then replay on this one for the result
    del _seen[key]
    while len(_graphs) >= GRAPH_CACHE_SIZE:
        _graphs.popitem(last=False)
    X = torch.empty(shape, dtype=torch.int32, device=dev)
    _densify_into(X, rows, cols, vals)
    t0 = time.perf_counter()
    before = torch.cuda.memory_reserved(dev)
    graph = torch.cuda.CUDAGraph()
    bodies = _cuda.body_pool(dev)
    with _cuda.capture(graph, dev, torch.cuda.graph_pool_handle(), bodies):
        out = _fused_body(f, X, npiv, bs, panel)
    nbytes = torch.cuda.memory_reserved(dev) - before
    _graphs[key] = dict(graph=graph, X=X, out=out, nbytes=nbytes,
                        bodies=bodies)
    last_finish.update(graph="captured",
                       capture_s=time.perf_counter() - t0,
                       graph_bytes=nbytes, input_bytes=X.nbytes)
    graph.replay()
    return out


def fused_blocked_finish(f, shape, npiv: int, bs: int, panel: int, rows,
                         cols, vals):
    """The entire blocked dense finish with no host read (the reference's
    single-dispatch ``fused_blocked_finish``): densify the COO once into
    (n_pad, na), then the loop over row blocks of ``bs`` rows, each
    eliminated against the accumulated mutual-RREF panel, Jordan-RREF'd,
    back-eliminated into the panel and appended.  Same math as
    ``blocked_finish_step`` (the streaming loop, kept for low-rank mode,
    resume from a dense sidecar, inputs over FUSED_BUDGET and finishes
    under the host cutoff).

    shape = (n_pad, na) with n_pad a multiple of bs; npiv <= na is the true
    column count: only those columns hold pivots, and once they all do the
    later blocks are no-ops.  rows, cols, vals: the COO as tensors on the
    device.  Returns (Ud, pc_map, r_d, ranks, prows, pcols, groups_run),
    tensors on the device: Ud (cap, na) with pc_map (cap,) and r_d for
    ``extract_u_csr``, ranks (nblocks,), prows / pcols (nblocks, bs) the
    per-block pivots (slot order = pivot-column order within the block),
    groups_run the panel groups whose body the blocks' RREFs ran (of
    nblocks * ``rref_groups(npiv, panel, device)``).

    On a card the loop becomes one CUDA graph per (p, shape, npiv, bs,
    panel, panel group), cached (``GRAPH_CACHE_SIZE``): the first call of a
    shape runs the loop eagerly, the second captures it and replays, and
    later ones densify into the graph's static input and replay.  The
    tensors a replay returns belong to the graph: the next replay of that
    shape overwrites them."""
    if rows.is_cuda:
        # the capture and the replay use the current device's streams
        with torch.cuda.device(rows.device):
            return _fused_on_card(f, shape, npiv, bs, panel, rows, cols,
                                  vals)
    X = torch.empty(shape, dtype=torch.int32, device=rows.device)
    _densify_into(X, rows, cols, vals)
    return _fused_body(f, X, npiv, bs, panel)
