"""K3 wrapper: the per-row merge of the device sparse Schur update (CUDA).

Replaces ``spasm_tpu/ops/pallas_merge.py`` (``_merge_kernel_body``,
launched by ``merge_rows_pallas``); the kernel is
``spasm_tpu_torch/csrc/merge.cu``, whose header says what bounds it on the
H100.  Its plain PyTorch version is ``ops.merge.merge_rows_plain``, and
both return the same three outputs bit for bit.  The kernel takes widths
up to 2**30 and is checked on the card up to 2**20, the widest row the
one-pass class builder makes at its default tile budget; rows wider than
the kernel keeps in shared memory get a global-memory scratch row per CTA,
allocated here.
"""

from __future__ import annotations

import torch

from . import _cuda
from . import modmul

launches = 0  # kernel launches in this process (chip_smoke.py reads it)


def merge_rows_cuda(f, cols: torch.Tensor, vals: torch.Tensor, m: int):
    """Drop-in for ``merge.merge_rows_plain(f, cols, vals, m)`` on CUDA
    tensors: (R, W) int32 cols in [0, m] and balanced int32 vals in,
    (sorted cols, segmented sums, keep) out; the inputs stay untouched."""
    global launches
    if not (cols.is_cuda and vals.device == cols.device):
        raise ValueError("merge_rows_cuda needs cols and vals on one CUDA "
                         f"device, got {cols.device}, {vals.device}")
    if cols.dtype != torch.int32 or vals.dtype != torch.int32:
        raise TypeError(f"expected int32 cols and vals, got {cols.dtype}, "
                        f"{vals.dtype}")
    if cols.dim() != 2 or cols.shape != vals.shape:
        raise ValueError(f"bad shapes cols {tuple(cols.shape)}, "
                         f"vals {tuple(vals.shape)}")
    if not 0 <= m < 1 << 31:
        raise ValueError(f"sentinel m={m} outside [0, 2**31)")
    modmul.check_device_prime(f)
    R, W = cols.shape
    if W > 1 << 30:
        raise ValueError(f"row width {W} above 2**30")
    cols = cols.contiguous()
    vals = vals.contiguous()
    ocols = torch.empty_like(cols)
    ovals = torch.empty_like(vals)
    keep = torch.empty((R, W), dtype=torch.bool, device=cols.device)
    if R == 0 or W == 0:
        return ocols, ovals, keep
    lib = _cuda.lib()
    nsm = torch.cuda.get_device_properties(cols.device).multi_processor_count
    srows = lib.spasm_merge_scratch_rows(R, W, nsm)
    scratch = (torch.empty((srows, 1 << (W - 1).bit_length()),
                           dtype=torch.int64, device=cols.device)
               if srows else None)
    with torch.cuda.device(cols.device):
        rc = lib.spasm_merge_rows(
            cols.data_ptr(), vals.data_ptr(), ocols.data_ptr(),
            ovals.data_ptr(), keep.data_ptr(),
            scratch.data_ptr() if srows else None, R, W, int(m), f.p, nsm,
            _cuda.stream_of(cols))
    launches += 1
    _cuda.check(rc, "merge kernel")
    return ocols, ovals, keep
