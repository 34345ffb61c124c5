"""One-pass Schur update on the device: the port of
``spasm_tpu/ops/sparse_onepass.py``.

The host kernel (``csrc/schur_mod.c``) eliminates every pivot column from
a row block B in one pass against a mutually reduced pivot block U*: each
coefficient is read off B (C[i, k] = B[i, pivcol(k)]) and the row update
is a sparse-accumulator scatter.  This is the same contract as a batched
per-row merge on the device:

  1. rows of B with no pivot hit pass through untouched;
  2. hit rows are bucketed into (pow4 |row|, pow4 #hits, pow4 max |U row|)
     width classes (the reference's keys, so the classes, chunks and host
     rows are the reference's);
  3. per class (and row chunk): the referenced U* rows are gathered
     (a compacted per-class ELL), scaled by -coeff mod p, laid beside the
     row in an (R, Wt) tile, and merged by ``merge.merge_rows``: K3 on a
     CUDA tile, the plain version on a CPU tile;
  4. the kept (col, val) slots come back to the host, which splices them
     with the untouched rows and the rows of classes too small for the
     device (the host kernel's).

``eliminate_onepass_device`` returns None, as the reference does, when a
single minimal tile or the total padded work would exceed its budgets;
the caller then falls back.

With a ``mesh`` (a 1-D ``DeviceMesh``, one process a rank, every rank
calling with the same matrices), each rank builds and merges only its row
range of each class tile on its own device, compacts the kept slots, and
all-gathers them, so that every rank assembles the same D.  The work
budget counts each class's rows padded as the tiles of the reference's
mesh path are (a multiple of the shard count), the same formula for the
estimate and the tiles; the reference's estimate leaves that round-up out.
"""

from __future__ import annotations

import time

import numpy as np
import scipy.sparse as sp
import torch

from .._host.field import Field
from . import merge, modmul

# row-count floor of the reference's padded tiles, kept in its budget
# arithmetic (the port's tiles are not padded)
_R_PAD = 128


def _ceil_pow2(x: int) -> int:
    return 1 << max(0, int(x - 1).bit_length())


def _ceil_pow4(x) -> np.ndarray:
    """Vectorized: smallest power of 4 >= x (>= 1)."""
    x = np.maximum(np.asarray(x, np.int64), 1)
    nb = np.int64(np.ceil(np.log2(x)))
    return np.int64(1) << ((nb + 1) // 2 * 2)


def _onepass_class(f: Field, b_cols, b_vals, hit_k, hit_c, hit_ok, u_cols,
                   u_vals, m: int):
    """One width class: (R, Wb) B rows + (R, H) hits against (nref, Ku)
    compacted U* ELL, all on one device.  Returns (cols, vals, keep, count)
    of shape (R, Wt), Wt = Wb + H * Ku; dead slots have col == m."""
    R = b_cols.shape[0]
    H = hit_k.shape[1]
    Ku = u_cols.shape[1]
    hk = hit_k.long()
    ok = hit_ok[:, :, None]
    # expansion: -coeff * U*[k] per hit, dead hits masked to the sentinel
    e_cols = torch.where(ok, u_cols[hk], m)
    e_vals = modmul.mul(f, modmul.neg(f, hit_c)[:, :, None], u_vals[hk])
    e_vals = torch.where(ok, e_vals, 0)
    tile_cols = torch.cat([b_cols, e_cols.reshape(R, H * Ku)], dim=1)
    tile_vals = torch.cat([b_vals, e_vals.reshape(R, H * Ku)], dim=1)
    cols_s, v, keep = merge.merge_rows(f, tile_cols, tile_vals, m)
    return cols_s, v, keep, keep.sum()


def _compact_class(tile_cols, tile_vals, keep):
    """The kept slots as flat (row, col, val) int64 tensors on the tile's
    device, row-major (the reference's order)."""
    rows = torch.nonzero(keep)[:, 0]
    return (rows, tile_cols[keep].to(torch.int64),
            tile_vals[keep].to(torch.int64))


def _padded_rows(R: int, nsh: int) -> int:
    """A class chunk's row count in the reference's budget: the power of 2
    at or above R, at least 128, rounded up to a multiple of the shard
    count."""
    R_pad = max(_R_PAD, _ceil_pow2(R))
    return -(-R_pad // nsh) * nsh


def eliminate_onepass_device(f: Field, Ustar, piv_cols, B,
                             max_tile_slots: int = 1 << 27,
                             work_budget: int = 1 << 30,
                             min_class_rows: int = 2048, *,
                             device="cuda", mesh=None,
                             _stats: dict | None = None):
    """Device one-pass Schur: D = B - B[:, piv_cols] @ U* (mod p), with
    the class tiles on ``device``, or with a ``mesh`` on each rank's device
    (``device`` must then name the mesh's device type), each rank merging
    its row range of every tile.

    Ustar: scipy CSR, MUTUALLY REDUCED (unit pivots, no entries in other
    pivot columns: elimination.mutual_reduce).  B: scipy CSR.  Returns a
    canonical scipy CSR equal to the host eliminate_against_reduced, or
    None when one minimal tile of a class would exceed ``max_tile_slots``
    or the total padded slot count over all chunks exceeds
    ``work_budget`` (the reference's formula, with its 128-row floor).
    Classes of fewer than ``min_class_rows`` rows run on the host kernel.
    ``_stats`` receives the reference's keys: classes, chunks,
    device_calls (this rank's merge launches), host_fallback_rows, prep_s,
    device_s and pull_s.
    """
    device = torch.device(device)
    nsh, me = 1, 0
    if mesh is not None:
        from ..parallel.sparse_sharded import all_gather_rows, mesh_device

        if mesh_device(mesh).type != device.type:
            raise ValueError(f"device {device} is not the mesh's "
                             f"{mesh.device_type}")
        device = mesh_device(mesh)
        nsh, me = mesh.size(), mesh.get_local_rank()
    Ustar = sp.csr_matrix(Ustar)
    B = sp.csr_matrix(B)
    q, m = B.shape
    r = Ustar.shape[0]
    if r == 0 or B.nnz == 0:
        return B.copy()
    piv_cols = np.asarray(piv_cols, np.int64)
    qinv = np.full(m, -1, np.int64)
    qinv[piv_cols] = np.arange(r)

    b_indptr = np.asarray(B.indptr, np.int64)
    b_idx = np.asarray(B.indices, np.int64)
    b_val = np.asarray(B.data, np.int64)
    k_of = qinv[b_idx]                       # (nnz,) U row per entry or -1
    hit = k_of >= 0
    lens = np.diff(b_indptr)
    # per-row hit counts + per-row max referenced-U-row length
    csum = np.concatenate([[0], np.cumsum(hit)])
    nh = csum[b_indptr[1:]] - csum[b_indptr[:-1]]
    hot = np.flatnonzero(nh > 0)
    if hot.size == 0:
        return B.copy()
    ulen = np.diff(np.asarray(Ustar.indptr, np.int64))
    uh = np.where(hit, ulen[np.clip(k_of, 0, None)], 0)
    kmax = np.zeros(q, np.int64)
    nz_rows = np.flatnonzero(lens > 0)
    if nz_rows.size:
        kmax[nz_rows] = np.maximum.reduceat(uh, b_indptr[nz_rows])
    keys = np.stack([_ceil_pow4(lens[hot]), _ceil_pow4(nh[hot]),
                     _ceil_pow4(kmax[hot])], 1)
    uniq, inv = np.unique(keys, axis=0, return_inverse=True)
    groups = []
    host_rows: list[np.ndarray] = []
    for g in range(uniq.shape[0]):
        rows_c = hot[np.flatnonzero(inv == g)]
        if rows_c.size < min_class_rows:
            host_rows.append(rows_c)
        else:
            groups.append((tuple(int(x) for x in uniq[g]), rows_c))

    u_indptr = np.asarray(Ustar.indptr, np.int64)
    u_idx = np.asarray(Ustar.indices, np.int64)
    u_val = np.asarray(Ustar.data, np.int64)

    out_cols_parts: list[np.ndarray] = []
    out_vals_parts: list[np.ndarray] = []
    out_rows_parts: list[np.ndarray] = []
    dev_calls = 0
    t_prep = t_dev = t_pull = 0.0
    chunked = []
    for key, rows_c in groups:
        Wb, H, Ku = key
        Wt = Wb + H * Ku
        # row-chunk classes whose tile would exceed max_tile_slots
        fit = max(max_tile_slots // max(Wt, 1), 1)
        r_cap = max(_R_PAD, 1 << (fit.bit_length() - 1))  # pow2 floor
        if _R_PAD * Wt > max_tile_slots:
            return None  # a single minimal tile cannot fit (pathological)
        for s in range(0, rows_c.size, r_cap):
            chunked.append((key, rows_c[s:s + r_cap]))
    total_slots = sum(_padded_rows(rc.size, nsh) * (k[0] + k[1] * k[2])
                      for k, rc in chunked)
    if total_slots > work_budget:
        return None  # padded merge work blew up (dense U*): fall back

    def put(x):
        return torch.from_numpy(x).to(device)

    for (Wb, H, Ku), rows_all_c in chunked:
        _t0 = time.perf_counter()
        # this rank's contiguous part of the chunk's rows
        per = -(-rows_all_c.size // nsh)
        row0 = min(rows_all_c.size, me * per)
        rows_c = rows_all_c[row0:row0 + per]
        R = rows_c.size
        L = lens[rows_c]
        total = int(L.sum())
        rowrep = np.repeat(np.arange(R, dtype=np.int64), L)
        base = np.cumsum(L) - L
        pos = np.arange(total, dtype=np.int64) - np.repeat(base, L)
        src = np.repeat(b_indptr[rows_c], L) + pos
        b_cols = np.full((R, Wb), m, np.int32)
        b_vals = np.zeros((R, Wb), np.int32)
        b_cols[rowrep, pos] = b_idx[src]
        b_vals[rowrep, pos] = b_val[src]
        # hits within each class row, packed to the front
        hsel = hit[src]
        ch = np.cumsum(hsel)
        excl = np.repeat(ch[base] - hsel[base], L)
        hpos = (ch - 1 - excl)[hsel]
        hrow = rowrep[hsel]
        ks = k_of[src][hsel]
        # the referenced U rows as a compacted per-class ELL
        refs, ks_local = np.unique(ks, return_inverse=True)
        nref = refs.size
        uL = ulen[refs]
        utot = int(uL.sum())
        urep = np.repeat(np.arange(nref, dtype=np.int64), uL)
        ubase = np.cumsum(uL) - uL
        upos = np.arange(utot, dtype=np.int64) - np.repeat(ubase, uL)
        usrc = np.repeat(u_indptr[refs], uL) + upos
        u_cols = np.full((nref, Ku), m, np.int32)
        u_vals = np.zeros((nref, Ku), np.int32)
        u_cols[urep, upos] = u_idx[usrc]
        u_vals[urep, upos] = u_val[usrc]
        hit_k = np.zeros((R, H), np.int32)
        hit_c = np.zeros((R, H), np.int32)
        hit_ok = np.zeros((R, H), bool)
        hit_k[hrow, hpos] = ks_local
        hit_c[hrow, hpos] = b_val[src][hsel]
        hit_ok[hrow, hpos] = True
        _t1 = time.perf_counter()
        t_prep += _t1 - _t0
        if R:
            cols_d, vals_d, keep_d, cnt_d = _onepass_class(
                f, put(b_cols), put(b_vals), put(hit_k), put(hit_c),
                put(hit_ok), put(u_cols), put(u_vals), m)
            dev_calls += 1
            int(cnt_d)  # the device wall ends at this scalar read
        _t2 = time.perf_counter()
        t_dev += _t2 - _t1
        if R:
            rk, ck, cv = _compact_class(cols_d, vals_d, keep_d)
        else:
            rk = ck = cv = torch.zeros(0, dtype=torch.int64, device=device)
        if mesh is not None:
            # every rank's kept slots, its rows offset to the whole chunk
            rk, ck, cv = all_gather_rows(
                torch.stack([rk + row0, ck, cv], dim=1), mesh).unbind(1)
        out_rows_parts.append(rows_all_c[rk.cpu().numpy()])
        out_cols_parts.append(ck.cpu().numpy())
        out_vals_parts.append(cv.cpu().numpy())
        t_pull += time.perf_counter() - _t2
    # tiny classes: the host one-pass kernel on just those rows
    nhost = 0
    if host_rows:
        from .._host.elimination import eliminate_against_reduced

        hrows = np.concatenate(host_rows)
        nhost = hrows.size
        Dh, _ = eliminate_against_reduced(f, Ustar, piv_cols, B,
                                          assume_canonical=True, rows=hrows)
        Dh = sp.csr_matrix(Dh)
        Dh.eliminate_zeros()
        out_rows_parts.append(hrows[Dh.tocoo().row])
        out_cols_parts.append(np.asarray(Dh.indices, np.int64))
        out_vals_parts.append(np.asarray(Dh.data, np.int64))
    if _stats is not None:
        _stats["classes"] = len(groups)
        _stats["chunks"] = len(chunked)
        _stats["device_calls"] = dev_calls
        _stats["host_fallback_rows"] = nhost
        _stats["prep_s"] = round(t_prep, 4)
        _stats["device_s"] = round(t_dev, 4)
        _stats["pull_s"] = round(t_pull, 4)
    # assemble: hot rows from the device output, cold rows pass through
    rows_all = np.concatenate(
        out_rows_parts + [np.repeat(np.arange(q), np.where(nh > 0, 0, lens))])
    cold_src = np.flatnonzero(~np.repeat(nh > 0, lens))
    cols_all = np.concatenate(out_cols_parts + [b_idx[cold_src]])
    vals_all = np.concatenate(out_vals_parts + [b_val[cold_src]])
    D = sp.csr_matrix(
        (vals_all, (rows_all, cols_all)), shape=(q, m), dtype=np.int64)
    D.sort_indices()
    return D
