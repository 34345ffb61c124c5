"""Sparse wave elimination over GF(p) on a device: the port of
``spasm_tpu/ops/sparse_device.py``.

The host path (``_host/elimination.py``) runs the level-wave Schur updates
through scipy SpGEMM.  Here the working matrix lives on the device as COO,
one int64 key ``(row << 32) | col`` and one balanced int32 value a
nonzero, kept sorted by key; the pivot rows are a padded ELL block.  One
wave t is:

  1. the entries in a pivot column of level t are the coefficients;
  2. each coefficient emits its pivot row's ELL entries scaled by -coef
     (the emitted entry at the pivot column cancels the coefficient exactly,
     unit pivots, so no deletion step is needed);
  3. old and emitted entries are sorted by key (``torch.sort``), and each
     run of equal keys is summed exactly: an int64 prefix sum differenced at
     the run ends, then reduced mod p;
  4. the runs whose sum is not 0 are the new matrix.

The reference's arrays have static capacities (``cap`` slots, ``cap_hits``
coefficients a wave) and it reports overflow rather than truncate.  Torch
sizes every array to its contents, but the capacities are kept as limits:
the same inputs overflow in the same waves, so ``eliminate_device``
returns None exactly where the reference does and the caller takes the
same path.  Every other failure (a launch, an allocation) raises.
"""

from __future__ import annotations

import numpy as np
import torch

from .._host.csr import SparseGFp
from .._host.field import Field
from . import modmul

_COL_MASK = (1 << 32) - 1


def wave_eliminate_device(f: Field, cap: int, cap_hits: int, depth: int,
                          rows, cols, vals, u_cols, u_vals, level_of,
                          col2piv, nrows: int, *, device, _stats=None):
    """Eliminate every pivot column from the COO matrix (rows, cols, vals)
    in ``depth`` waves on ``device``.

    Entries with ``rows >= nrows`` (the sentinel) are padding and dropped.
    u_cols / u_vals: (npiv, Ku) ELL of the unit pivot rows (cols padded -1,
    vals 0); level_of (npiv,); col2piv (m,), -1 off the pivot columns.

    Returns (rows, cols, vals, overflow): int64 rows and cols, balanced
    int32 vals, sorted by (row, col) with no zero; ``overflow`` is True when
    a wave had more than ``cap_hits`` coefficients or kept more than
    ``cap`` entries (the results are then None).  ``_stats``, if given, gets
    the coefficients (``hits``) and the kept entries of each wave run, the
    largest expansion (coefficients x Ku) and the wave that overflowed
    (``overflow_wave``, None if none did)."""
    dev = torch.device(device)

    def put(x, dtype=torch.int64):
        return torch.as_tensor(x).to(dev, dtype)

    rows, cols, vals = put(rows), put(cols), put(vals, torch.int32)
    u_cols, u_vals = put(u_cols), put(u_vals, torch.int32)
    level_of, col2piv = put(level_of), put(col2piv)
    live = rows < nrows
    key = (rows[live] << 32) | cols[live]
    val = vals[live]
    stats = {} if _stats is None else _stats
    stats.update(hits=[], kept=[], max_expansion=0, overflow_wave=None)

    def overflow(t):
        stats["overflow_wave"] = t
        return None, None, None, True

    for t in range(depth):
        piv = col2piv[key & _COL_MASK]
        hit = (piv >= 0) & (val != 0)
        hit &= level_of[piv.clamp(min=0)] == t
        hi = hit.nonzero().squeeze(1)
        nhits = hi.numel()
        stats["hits"].append(nhits)
        if nhits > cap_hits:
            return overflow(t)
        hp = piv[hi]
        e_cols = u_cols[hp]                                  # (nhits, Ku)
        e_vals = modmul.mul(f, modmul.neg(f, val[hi])[:, None], u_vals[hp])
        e_live = (e_cols >= 0) & (e_vals != 0)
        e_key = ((key[hi] >> 32) << 32)[:, None] | e_cols
        skey, perm = torch.sort(torch.cat([key, e_key[e_live]]))
        sval = torch.cat([val, e_vals[e_live]])[perm]
        last = torch.ones_like(skey, dtype=torch.bool)
        last[:-1] = skey[1:] != skey[:-1]
        ends = last.nonzero().squeeze(1)
        # balanced values have |v| <= p/2 < 2**31 and a wave holds fewer
        # than 2**31 entries, so every prefix sum stays below 2**62
        csum = torch.cumsum(sval, 0, dtype=torch.int64)[ends]
        run = modmul.normalize(f, csum - torch.cat([csum.new_zeros(1),
                                                    csum[:-1]]))
        keep = run != 0
        key, val = skey[ends][keep], run[keep]
        stats["kept"].append(key.numel())
        stats["max_expansion"] = max(stats["max_expansion"], e_cols.numel())
        if key.numel() > cap:
            return overflow(t)
    return key >> 32, key & _COL_MASK, val, False


def ell_pack(U):
    """Pack a SparseGFp's rows into a padded ELL block (cols padded -1,
    vals padded 0) — vectorized (no per-row Python loop)."""
    npiv = U.shape[0]
    Ku = int(U.row_lengths().max()) if U.nnz else 1
    u_cols = np.full((npiv, Ku), -1, np.int64)
    u_vals = np.zeros((npiv, Ku), np.int64)
    if U.nnz:
        re = U.rows_expanded()
        pos = np.arange(U.nnz, dtype=np.int64) - U.indptr[re]
        u_cols[re, pos] = U.indices
        u_vals[re, pos] = U.data
    return u_cols, u_vals


def col_to_pivot(m: int, piv_cols) -> np.ndarray:
    """(m,) pivot index of each column, -1 off the pivot columns."""
    piv_cols = np.asarray(piv_cols, np.int64)
    col2piv = np.full(m, -1, np.int64)
    col2piv[piv_cols] = np.arange(piv_cols.size)
    return col2piv


def csr_from_sorted(f: Field, n: int, m: int, rows, cols, vals) -> SparseGFp:
    """The SparseGFp of COO tensors sorted by (row, col), free of
    duplicates and zeros, with balanced values: what ``SparseGFp.from_coo``
    builds from them, without its host sort."""
    counts = torch.bincount(rows, minlength=n)
    indptr = torch.cat([counts.new_zeros(1), torch.cumsum(counts, 0)])
    return SparseGFp(f, n, m, indptr.cpu().numpy(),
                     cols.to(torch.int32).cpu().numpy(),
                     vals.to(torch.int32).cpu().numpy(), _canonical=True)


def eliminate_device(f: Field, U, piv_cols, levels, B, cap_factor=4,
                     cap_hits=None, *, device, _stats=None):
    """Eliminate the unit pivot rows U (SparseGFp, pivots at ``piv_cols``,
    wave ``levels``) from every row of B on ``device``; returns the
    eliminated B, or None on capacity overflow (the caller falls back to
    the host).  The capacities are the reference's: ``cap`` slots, a power
    of two of at least ``cap_factor`` x nnz(B) and 1024, and ``cap_hits``
    coefficients a wave (default cap / 8, at least 256)."""
    npiv, m = U.shape
    q = B.shape[0]
    cap = max(1024, 1 << int(cap_factor * max(1, B.nnz) - 1).bit_length())
    if cap_hits is None:
        cap_hits = max(256, cap // 8)
    if B.nnz > cap:
        raise ValueError(f"B has {B.nnz} entries, more than the {cap} slots "
                         f"of cap_factor={cap_factor}")
    depth = int(np.asarray(levels).max()) + 1 if npiv else 0
    if depth == 0:
        return B
    u_cols, u_vals = ell_pack(U)
    i, j, v = B.to_coo()
    rows, cols, vals, overflow = wave_eliminate_device(
        f, cap, cap_hits, depth, i, j, v, u_cols, u_vals, levels,
        col_to_pivot(m, piv_cols), q, device=device, _stats=_stats)
    if overflow:
        return None
    return csr_from_sorted(f, q, m, rows, cols, vals)
