"""The per-row merge of the device sparse Schur update: the port of
``spasm_tpu/ops/pallas_merge.py::merge_rows_pallas``.

Each row of an (R, W) tile of (col, val) contributions is sorted by column,
runs of equal columns are summed exactly mod p, and a ``keep`` mask flags
the last slot of each run whose sum is nonzero and whose column is below
the sentinel ``m`` (dead slots carry ``col == m``).  Columns lie in
[0, m] with m < 2**31; values are balanced int32.

``merge_rows`` is the dispatching entry point: CUDA tensors go to K3
(``cuda_merge.merge_rows_cuda``, any width), CPU tensors to
``merge_rows_plain``.  Both sort each row by the composite key
(col, val as uint32), so ties are identical entries and the sorted row is
unique: the two agree bit for bit in all three outputs, including the
partial sums at slots that are not the last of their run.  Against the
reference, whose bitonic network compares the column only, the sorted
columns and the kept (col, val) slots agree; partial sums at the other
slots may not.
"""

from __future__ import annotations

import torch


def _fold_add(a: torch.Tensor, b: torch.Tensor, p: int) -> torch.Tensor:
    """a + b mod p on balanced int64 values: |a + b| <= p - 1, so one
    fold lands in the balanced range for every p <= 0xFFFFFFFB."""
    s = a + b
    s = torch.where(s > p // 2, s - p, s)
    return torch.where(s < -(p // 2), s + p, s)


def merge_rows_plain(f, cols: torch.Tensor, vals: torch.Tensor, m: int):
    """Plain PyTorch merge of every row of (R, W) int32 (cols, vals), on
    their device.  Returns (cols sorted, segmented sums as int32, keep)."""
    R, W = cols.shape
    key = (cols.to(torch.int64) << 32) | (vals.to(torch.int64) & 0xFFFFFFFF)
    key = torch.sort(key, dim=1).values
    cols_s = (key >> 32).to(torch.int32)
    v = key & 0xFFFFFFFF
    v = torch.where(v >= 1 << 31, v - (1 << 32), v)  # back to signed
    # segmented inclusive sum over runs of equal columns (log-shift scan)
    start = torch.ones((R, W), dtype=torch.bool, device=cols.device)
    start[:, 1:] = cols_s[:, 1:] != cols_s[:, :-1]
    flg = start
    shift = 1
    while shift < W:
        v_prev = torch.zeros_like(v)
        v_prev[:, shift:] = v[:, :-shift]
        f_prev = torch.ones_like(flg)
        f_prev[:, shift:] = flg[:, :-shift]
        v = torch.where(flg, v, _fold_add(v, v_prev, f.p))
        flg = flg | f_prev
        shift <<= 1
    last = torch.ones((R, W), dtype=torch.bool, device=cols.device)
    last[:, :-1] = start[:, 1:]
    keep = last & (v != 0) & (cols_s < m)
    return cols_s, v.to(torch.int32), keep


def merge_rows(f, cols: torch.Tensor, vals: torch.Tensor, m: int):
    """(cols, vals, keep) of the merge; K3 on CUDA tensors, the plain
    version on CPU tensors."""
    if cols.is_cuda or vals.is_cuda:
        from .cuda_merge import merge_rows_cuda

        return merge_rows_cuda(f, cols, vals, m)
    return merge_rows_plain(f, cols, vals, m)
