"""Distributed dense elimination over a mesh of ranks: the port of
``spasm_tpu/parallel/sharded.py``.

The matrix's rows are split evenly over a 1-D mesh (one process a rank,
SPMD; see ``parallel/sparse_sharded.py``); each rank holds its row block on
its device.  One round:

* **pivot election**: two ``all_reduce(MIN)`` calls over each column's best
  candidate, weight then global row id: deterministic, independent of the
  number of ranks;
* **pivot-row exchange**: ``all_reduce(SUM)`` of the winning rows (each rank
  contributes the rows it won, zeros elsewhere): first the (C, C) block of
  the pivot columns, then the rows in column stripes;
* the C elected pivots form a unit upper-triangular panel T = U[:, cols],
  inverted exactly by a Neumann product (T^-1 = prod (I + (-N)^(2^i)),
  N = T - I nilpotent), so the Schur update is one exact product a stripe:
  X <- X - X[:, cols] @ (T^-1 U).

Each stripe's exchange is started asynchronously and waited for just
before the stripe is first used, so the exchange of stripe s + 1 runs while
stripe s is multiplied.  Every product is ``ops/matmul.modmatmul``: K1 on a
card.  The panel width C is fixed; empty pivot slots are identity columns
that multiply by zero, as in the reference.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.distributed as dist

from .._host.field import Field
from ..ops import modmul
from ..ops.matmul import modmatmul
from .sparse_sharded import all_reduce, mesh_device

BIG = 2**31 - 1


def make_mesh(n_devices=None, axis="rows", device_type=None):
    """A 1-D mesh named ``axis`` over the ranks of the initialized default
    process group (``parallel.multihost.initialize``); ``n_devices``, when
    given, must equal their number.  ``device_type`` defaults to "cuda",
    which raises without a card."""
    from torch.distributed.device_mesh import init_device_mesh

    from .multihost import require_card

    if device_type is None:
        device_type = "cuda"
    require_card(device_type)
    world = dist.get_world_size()
    if n_devices is not None and n_devices != world:
        raise ValueError(f"a mesh of {n_devices} ranks needs a process group "
                         f"of {n_devices} processes; this one has {world}")
    return init_device_mesh(device_type, (world,), mesh_dim_names=(axis,))


def _eye(C: int, device) -> torch.Tensor:
    return torch.eye(C, dtype=torch.int32, device=device)


def _neumann_inverse(f: Field, T: torch.Tensor) -> torch.Tensor:
    """Exact inverse of a unit upper-triangular (C, C) panel over GF(p):
    (I + N)^-1 = prod_i (I + (-N)^(2^i)), N strictly upper nilpotent."""
    C = T.shape[0]
    eye = _eye(C, T.device)
    M = modmul.sub(f, eye, T)  # M = -N
    acc = modmul.add(f, eye, M)
    steps = max(1, (C - 1).bit_length())
    for _ in range(steps - 1):
        M = modmatmul(f, M, M)
        acc = modmatmul(f, modmul.add(f, eye, M), acc)
    return acc


def _local_fl_candidates(f: Field, X: torch.Tensor, row_offset: int):
    """Per column, the best (weight, global row) among the local rows whose
    leftmost nonzero is that column; empty columns get (BIG, BIG)."""
    nloc, m = X.shape
    dev = X.device
    nz = X != 0
    has = nz.any(dim=1)
    weight = nz.sum(dim=1)
    left = torch.where(has, nz.to(torch.int8).argmax(dim=1), m)
    gid = row_offset + torch.arange(nloc, dtype=torch.int64, device=dev)
    big = torch.full_like(weight, BIG)
    bw = torch.full((m + 1,), BIG, dtype=torch.int64, device=dev)
    bw.scatter_reduce_(0, left, torch.where(has, weight, big), reduce="amin")
    # row-id tie-break among the local rows of the column's best weight
    is_best = (weight == bw[left]) & has
    br = torch.full((m + 1,), BIG, dtype=torch.int64, device=dev)
    br.scatter_reduce_(0, left, torch.where(is_best, gid, big), reduce="amin")
    return bw[:m], br[:m]


def elimination_round(f: Field, mesh, X: torch.Tensor, panel: int = 128):
    """One distributed FL elimination round on this rank's row block X
    (nloc, m) int32, which starts at global row rank * nloc: every rank
    passes a block of the same height.  Returns (X', U, cols, valid, npiv):
    X' with the pivot columns eliminated and the pivot rows zeroed, and,
    the same on every rank, U the (C, m) Jordan-reduced pivot panel, cols
    the C pivot columns (m pads empty slots), valid their mask and npiv
    their count."""
    nloc, m = X.shape
    C = min(panel, m)
    dev = X.device
    row_offset = mesh.get_local_rank() * nloc
    bw, br = _local_fl_candidates(f, X, row_offset)
    bw_g = all_reduce(bw, mesh, dist.ReduceOp.MIN)    # best weight a col
    cand = torch.where(bw == bw_g, br, torch.full_like(br, BIG))
    br_g = all_reduce(cand, mesh, dist.ReduceOp.MIN)  # winner row a col
    has_piv = bw_g < BIG

    # the first C pivot columns (ascending), padded with m
    col_ids = torch.arange(m, dtype=torch.int64, device=dev)
    ranked = torch.where(has_piv, col_ids, m)
    cols = torch.sort(ranked).values[:C]
    valid = cols < m
    cols_safe = torch.where(valid, cols, 0)

    # each rank contributes the rows it won
    win_row = br_g[cols_safe]                         # global row a slot
    local_idx = win_row - row_offset
    mine = valid & (local_idx >= 0) & (local_idx < nloc)
    idx_safe = local_idx.clamp(0, nloc - 1)
    contrib = torch.where(mine[:, None], X[idx_safe], 0)

    # the small (C, C) exchange first: enough to build the panel inverse
    T_raw = all_reduce(contrib[:, cols_safe], mesh)
    ar = torch.arange(C, device=dev)
    # slot k's own column; its C inverses are taken on the host, one read,
    # where a Fermat power on the device is some 190 small launches
    pivval = torch.where(valid, T_raw[ar, ar], 1).cpu().numpy()
    pinv = torch.from_numpy(f.inv(pivval)).to(dev, torch.int32)
    T = modmul.mul(f, T_raw, pinv[:, None])
    T = torch.where((~valid)[:, None] | (~valid)[None, :], _eye(C, dev), T)
    Tinv = _neumann_inverse(f, T)
    # the unit-pivot scaling folded into the normalizer: Tinv @ diag(pinv)
    S_norm = modmul.mul(f, Tinv, pinv[None, :])

    coeff = torch.where(valid[None, :], X[:, cols_safe], 0)
    n_stripes = min(4, max(1, m // 512))
    bounds = [m * s // n_stripes for s in range(n_stripes + 1)]
    # every stripe's exchange is started at once and waited for before its
    # first use: stripe s + 1 travels while stripe s is multiplied
    pending = [all_reduce(contrib[:, bounds[s]:bounds[s + 1]].contiguous(),
                          mesh, async_op=True) for s in range(n_stripes)]
    U_parts, X_parts = [], []
    for s in range(n_stripes):
        Us = pending[s].wait()
        Ur = modmatmul(f, S_norm, Us)                 # normalized stripe
        U_parts.append(Ur)
        X_parts.append(modmul.sub(f, X[:, bounds[s]:bounds[s + 1]],
                                  modmatmul(f, coeff, Ur)))
    U = torch.cat(U_parts, dim=1)
    X = torch.cat(X_parts, dim=1)
    # the pivot rows leave the active matrix
    gid = row_offset + torch.arange(nloc, dtype=torch.int64, device=dev)
    is_piv_row = (gid[:, None]
                  == torch.where(valid, win_row, -1)[None, :]).any(dim=1)
    X = torch.where(is_piv_row[:, None], 0, X)
    npiv = valid.sum()
    return X, U, cols, valid, npiv


def distributed_rank(f: Field, mesh, X, panel: int = 128,
                     max_rounds: "int | None" = None) -> int:
    """Rank of a dense matrix by repeated distributed FL elimination
    rounds.  Every rank passes the same (n, m) host matrix X; its rows are
    padded to a multiple of the mesh size and each rank takes its block
    onto its device.  Returns the rank (the same on every rank)."""
    X = np.asarray(X)
    n, m = X.shape
    nloc = -(-n // mesh.size())
    me = mesh.get_local_rank()
    block = np.zeros((nloc, m), np.int64)
    lo, hi = min(n, me * nloc), min(n, (me + 1) * nloc)
    block[:hi - lo] = X[lo:hi]
    Xd = modmul.normalize(f, torch.from_numpy(block).to(mesh_device(mesh)))
    rank = 0
    rounds = 0
    limit = max_rounds if max_rounds is not None else m + 1
    while rounds < limit:
        Xd, _, _, _, npiv = elimination_round(f, mesh, Xd, panel)
        k = int(npiv)
        rank += k
        rounds += 1
        if k == 0:
            break
    return rank
