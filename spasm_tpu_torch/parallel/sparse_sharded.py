"""Row-sharded pivot elections over a mesh of ranks: the port of
``spasm_tpu/parallel/sparse_sharded.py`` (its elections and helpers).

The mesh is a 1-D ``torch.distributed.device_mesh.DeviceMesh`` and the
program is SPMD: one process a rank, each with one device (a card, or the
CPU), every rank calling with the same host matrix.  This is the
reference's multi-process mode; JAX's single process over many devices has
no counterpart in torch.  Each rank works on its own row range, and the
results are combined by collectives over the mesh's process group:

* ``sharded_fl_election``: the Faugère-Lachartre row election, per column
  the best (weight, global row) among the rows whose leftmost entry is that
  column; two ``all_reduce(MIN)`` calls, weight then row id;
* ``sharded_fl_col_election``: Faugère-Lachartre "on columns", the topmost
  candidate row per unselected column (``all_reduce(MIN)``) and each row's
  count of entries in selected columns (``all_gather``).

Both are bit-identical to the host ``pivots.fl_row_pivots`` /
``fl_col_pivots`` and do not depend on the number of ranks.

``sharded_sparse_eliminate`` is the round's Schur update by the sort-based
waves of ``ops/sparse_device.py``, each rank on its own rows; a capacity
overflow on any rank is voted over the mesh (``all_reduce(MAX)``), so
every rank returns None together and no rank waits in a collective that
another has left.

The collective helpers (``all_reduce``, ``all_gather_rows``, ``barrier``)
take the place of the reference's ``_global_put`` / ``_global_get``.  On a
gloo group, a collective of CUDA tensors is staged through host memory
explicitly (copied to the CPU, reduced there, copied back), so that two
ranks can share one card, which NCCL refuses; NCCL groups take the
tensors where they are.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.distributed as dist

from .._host.csr import SparseGFp
from .._host.field import Field

BIG = 2**31 - 1


# ---------------- the mesh and its collectives ----------------


def mesh_device(mesh) -> torch.device:
    """The device this rank computes on: its current card for a CUDA mesh,
    the CPU for a CPU mesh."""
    if mesh.device_type == "cuda":
        return torch.device("cuda", torch.cuda.current_device())
    return torch.device(mesh.device_type)


def _host_staged(t: torch.Tensor, group) -> bool:
    return t.is_cuda and dist.get_backend(group) == "gloo"


class _Pending:
    """An asynchronous collective; ``wait()`` returns its result on the
    input's device (copied back from the host where it was staged)."""

    def __init__(self, work, out: torch.Tensor, device: torch.device):
        self._work, self._out, self._device = work, out, device

    def wait(self) -> torch.Tensor:
        if self._work is not None:
            self._work.wait()
        return self._out.to(self._device)


def all_reduce(t: torch.Tensor, mesh, op=dist.ReduceOp.SUM,
               async_op: bool = False):
    """The elementwise ``op`` of ``t`` over the mesh, on t's device; t is
    not modified.  With ``async_op`` it returns a pending result whose
    ``wait()`` gives the tensor."""
    group = mesh.get_group()
    out = t.cpu() if _host_staged(t, group) else t.clone()
    work = dist.all_reduce(out, op=op, group=group, async_op=async_op)
    pending = _Pending(work, out, t.device)
    return pending if async_op else pending.wait()


def all_gather_rows(t: torch.Tensor, mesh) -> torch.Tensor:
    """Concatenate every rank's ``t`` along dim 0, in rank order; the
    ranks' first dimensions may differ.  Returns a tensor on t's device."""
    group = mesh.get_group()
    size = mesh.size()
    staged = _host_staged(t, group)
    x = t.cpu() if staged else t
    n = torch.tensor([x.shape[0]], dtype=torch.int64, device=x.device)
    counts = [torch.zeros_like(n) for _ in range(size)]
    dist.all_gather(counts, n, group=group)
    counts = [int(c) for c in counts]
    top = max(counts)
    pad = x.new_zeros((top - x.shape[0],) + tuple(x.shape[1:]))
    xp = torch.cat([x, pad]) if pad.shape[0] else x.contiguous()
    parts = [torch.empty_like(xp) for _ in range(size)]
    dist.all_gather(parts, xp, group=group)
    out = torch.cat([p[:c] for p, c in zip(parts, counts)])
    return out.to(t.device)


def barrier(mesh) -> None:
    dist.barrier(group=mesh.get_group())


# ---------------- row sharding ----------------


def shard_rows(B: SparseGFp, nshards: int, cap_per_shard: "int | None" = None):
    """Partition B's rows evenly into per-shard COO blocks of one capacity
    (padding entries carry the local row count ``per`` as their row).
    ``cap_per_shard`` None takes the largest shard's entry count.  Returns
    (rows_l, cols_l, vals_l, per), each array (nshards, cap)."""
    n = B.n
    per = -(-n // nshards)
    i, j, v = B.to_coo()
    bounds = np.searchsorted(i, np.arange(nshards + 1) * per)
    cnts = np.diff(bounds)
    if cap_per_shard is None:
        cap_per_shard = max(1, int(cnts.max(initial=0)))
    if cnts.max(initial=0) > cap_per_shard:
        raise ValueError("cap_per_shard too small for shard nnz")
    rows_l = np.full((nshards, cap_per_shard), per, np.int32)
    cols_l = np.zeros((nshards, cap_per_shard), np.int32)
    vals_l = np.zeros((nshards, cap_per_shard), np.int32)
    sidx = np.repeat(np.arange(nshards), cnts)
    pos = np.arange(i.size) - np.repeat(bounds[:-1], cnts)
    rows_l[sidx, pos] = i - sidx * per
    cols_l[sidx, pos] = j
    vals_l[sidx, pos] = v
    return rows_l, cols_l, vals_l, per


def _my_shard(mesh, B: SparseGFp, cap_per_shard: "int | None" = None):
    """This rank's (local rows, cols, vals) of B's row shard as int64
    tensors on its device, with the live-entry mask and ``per``."""
    rows_l, cols_l, vals_l, per = shard_rows(B, mesh.size(), cap_per_shard)
    me = mesh.get_local_rank()
    dev = mesh_device(mesh)
    rows, cols, vals = (torch.from_numpy(x[me].astype(np.int64)).to(dev)
                        for x in (rows_l, cols_l, vals_l))
    return rows, cols, vals, rows < per, per


def _scatter_min(size: int, index, src, device):
    out = torch.full((size,), BIG, dtype=torch.int64, device=device)
    return out.scatter_reduce_(0, index, src, reduce="amin")


# ---------------- the elections ----------------


def sharded_fl_election(f: Field, mesh, B: SparseGFp):
    """Faugère-Lachartre row pivots elected over the mesh.

    Returns (rows, cols) in increasing pivot-column order, bit-identical to
    ``pivots.fl_row_pivots(B)`` (per column: the row of minimum (weight,
    row id) among the rows whose leftmost entry is that column), whatever
    the number of ranks."""
    n, m = B.shape
    rows, cols, _, live, per = _my_shard(mesh, B)
    dev = rows.device
    one = live.to(torch.int64)
    rsafe = torch.where(live, rows, per)
    csafe = torch.where(live, cols, m)
    weight = torch.zeros(per + 1, dtype=torch.int64, device=dev)
    weight.index_add_(0, rsafe, one)
    leftmost = torch.full((per + 1,), m, dtype=torch.int64, device=dev)
    leftmost.scatter_reduce_(0, rsafe, csafe, reduce="amin")
    gid = (mesh.get_local_rank() * per
           + torch.arange(per + 1, dtype=torch.int64, device=dev))
    big = torch.full_like(weight, BIG)
    bw = _scatter_min(m + 1, leftmost, torch.where(weight > 0, weight, big),
                      dev)
    bw = all_reduce(bw, mesh, dist.ReduceOp.MIN)
    is_best = (weight > 0) & (weight == bw[leftmost])
    br = _scatter_min(m + 1, leftmost, torch.where(is_best, gid, big), dev)
    br = all_reduce(br, mesh, dist.ReduceOp.MIN)
    bw, br = bw[:m].cpu().numpy(), br[:m].cpu().numpy()
    pcols = np.flatnonzero(bw < BIG).astype(np.int64)
    prows = br[pcols].astype(np.int64)
    return prows, pcols


def sharded_fl_col_election(f: Field, mesh, B: SparseGFp, col_selected,
                            row_used):
    """Faugère-Lachartre "on columns" elected over the mesh: bit-identical
    to ``pivots.fl_col_pivots`` and independent of the number of ranks.

    On each rank's rows: (a) the topmost candidate global row per
    unselected column (the rows must be unused), combined by
    ``all_reduce(MIN)``; (b) each row's count of entries in already
    selected columns (the append-invariant check), gathered to every rank.
    Then on the host, as the host strategy: one pivot per row (its smallest
    column), the invariant filter, decreasing-row order.

    The masks are updated in place like ``fl_col_pivots``.  Returns
    (rows, cols) in decreasing-row order."""
    n, m = B.shape
    rows, cols, _, live, per = _my_shard(mesh, B)
    dev = rows.device
    me = mesh.get_local_rank()
    ru = np.ones(per + 1, np.int64)   # the padding row counts as used
    lo, hi = min(n, me * per), min(n, (me + 1) * per)
    ru[:hi - lo] = row_used[lo:hi]
    ru = torch.from_numpy(ru).to(dev)
    cs = torch.from_numpy(np.append(col_selected, True).astype(np.int64)
                          ).to(dev)
    rsafe = torch.where(live, rows, per)
    csafe = torch.where(live, cols, m)
    cand = live & (ru[rsafe] == 0) & (cs[csafe] == 0)
    gid = me * per + rsafe
    mr = _scatter_min(m + 1, csafe,
                      torch.where(cand, gid, torch.full_like(gid, BIG)), dev)
    mr = all_reduce(mr, mesh, dist.ReduceOp.MIN)[:m].cpu().numpy()
    hits = torch.zeros(per + 1, dtype=torch.int64, device=dev)
    hits.index_add_(0, rsafe, (live & (cs[csafe] == 1)).to(torch.int64))
    hits = all_gather_rows(hits[:per], mesh).cpu().numpy()[:n]
    cols_c = np.flatnonzero(mr < BIG).astype(np.int64)
    rows_c = mr[cols_c].astype(np.int64)
    if rows_c.size == 0:
        return np.zeros(0, np.int64), np.zeros(0, np.int64)
    # one pivot per row: keep the smallest column of each winner row
    from .._host.native import scatter_min

    min_col = np.full(n, m, np.int64)
    scatter_min(min_col, rows_c, cols_c)
    keep = min_col[rows_c] == cols_c
    rows_c, cols_c = rows_c[keep], cols_c[keep]
    order = np.argsort(rows_c, kind="stable")
    rows_c, cols_c = rows_c[order], cols_c[order]
    ok = hits[rows_c] == 0
    rows_c, cols_c = rows_c[ok], cols_c[ok]
    rows_c, cols_c = rows_c[::-1].copy(), cols_c[::-1].copy()
    row_used[rows_c] = True
    col_selected[cols_c] = True
    return rows_c, cols_c


# ---------------- the sort-based waves ----------------


def sharded_sparse_eliminate(f: Field, mesh, U: SparseGFp, piv_cols, levels,
                             B: SparseGFp, cap_factor: int = 8):
    """Eliminate U's pivot columns from all rows of B, each rank running
    the waves of ``ops/sparse_device`` on its row shard on its own device
    (capacities per shard: ``cap`` a power of two of at least cap_factor x
    the mean shard's entries and 1024, ``cap_hits`` cap / 8, at least
    256, as in the reference).  Returns the eliminated SparseGFp, the same
    on every rank, or None on every rank when any shard overflowed (the
    caller falls back to the host waves)."""
    from ..ops.sparse_device import (col_to_pivot, csr_from_sorted,
                                     ell_pack, wave_eliminate_device)

    nshards = mesh.size()
    npiv, m = U.shape
    if npiv == 0:
        return B
    per_nnz = max(1, -(-B.nnz // nshards))
    cap = max(1024, 1 << int(cap_factor * per_nnz - 1).bit_length())
    cap_hits = max(256, cap // 8)
    rows, cols, vals, _, per = _my_shard(mesh, B, cap)
    u_cols, u_vals = ell_pack(U)
    depth = int(np.asarray(levels).max()) + 1
    dev = rows.device
    r, c, v, overflow = wave_eliminate_device(
        f, cap, cap_hits, depth, rows, cols, vals, u_cols, u_vals, levels,
        col_to_pivot(m, piv_cols), per, device=dev)
    vote = torch.tensor([int(overflow)], dtype=torch.int64, device=dev)
    if int(all_reduce(vote, mesh, dist.ReduceOp.MAX)[0]):
        return None
    # shards hold consecutive row ranges and each comes back sorted, so
    # the rank-ordered concatenation is sorted by (row, col)
    part = torch.stack([r + mesh.get_local_rank() * per, c, v.long()], 1)
    out = all_gather_rows(part, mesh)
    return csr_from_sorted(f, B.n, m, out[:, 0], out[:, 1], out[:, 2])
