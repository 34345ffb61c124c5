"""K2 wrapper: the Jordan elimination of one column panel (CUDA).

Replaces the Pallas panel kernels of ``spasm_tpu/ops/pallas_panel.py``
(``_kernel_scalefree``, ``_kernel`` and ``_kernel_b``, entry point
``panel_eliminate_pallas``); the kernel is ``spasm_tpu_torch/csrc/panel.cu``,
one thread-block cluster of 16 CTAs whose header says what bounds it on
the H100.  Its plain PyTorch version is ``ops.dense._panel_eliminate``, and
both return the same six outputs bit for bit, for every legal p and every n.
"""

from __future__ import annotations

import torch

from . import _cuda
from . import modmul

launches = 0  # kernel launches in this process (chip_smoke.py reads it)
PHASES = ("scan and push", "cluster barrier", "pivot row staged",
          "own rows updated", "step barrier")  # of a step, in order


def panel_eliminate_cuda(f, npivcols: int, P: torch.Tensor,
                         is_piv_row: torch.Tensor, j0: int,
                         stamps: torch.Tensor = None,
                         run: torch.Tensor = None):
    """Drop-in for ``dense._panel_eliminate(f, P, is_piv_row, j0,
    npivcols, run)`` on CUDA tensors: returns (P', G, prow, pcol, pfound,
    is_piv') and leaves the inputs untouched.  P holds balanced values.
    Raises where the card cannot hold a cluster of 16 CTAs.  ``stamps``, a
    zeroed int64 (c, 1 + len(PHASES)) CUDA tensor, receives the global
    timer (ns) at the start of each step and at the end of each of its
    PHASES (0 where a step had no pivot).  ``run``, a 0-d bool tensor on
    P's device, is read by the kernel: where it holds False the kernel
    returns at once, and the outputs are P, zero G / prow / pcol, no pivot
    found and is_piv_row (the reference's empty-panel ``lax.cond``)."""
    global launches
    if not (P.is_cuda and is_piv_row.device == P.device):
        raise ValueError("panel_eliminate_cuda needs P and is_piv_row on "
                         f"one CUDA device, got {P.device}, "
                         f"{is_piv_row.device}")
    if P.dtype != torch.int32 or is_piv_row.dtype != torch.bool:
        raise TypeError(f"expected int32 P and bool is_piv_row, got "
                        f"{P.dtype}, {is_piv_row.dtype}")
    if P.dim() != 2 or tuple(is_piv_row.shape) != (P.shape[0],):
        raise ValueError(f"bad shapes P {tuple(P.shape)}, "
                         f"is_piv_row {tuple(is_piv_row.shape)}")
    n, c = P.shape
    if not 0 < c <= 4096:
        raise ValueError(f"the panel kernel takes 1 <= c <= 4096, got c={c}")
    if stamps is not None and not (
            stamps.dtype == torch.int64 and stamps.device == P.device
            and stamps.is_contiguous()
            and tuple(stamps.shape) == (c, 1 + len(PHASES))):
        raise ValueError("stamps must be a contiguous int64 (c, "
                         f"{1 + len(PHASES)}) tensor on {P.device}")
    flag = _cuda.flag_of(run, P)
    modmul.check_device_prime(f)
    # the kernel works in place on contiguous copies
    Pk = P.clone(memory_format=torch.contiguous_format)
    ispiv = is_piv_row.clone(memory_format=torch.contiguous_format)
    G = torch.zeros_like(Pk)
    prow = torch.zeros(c, dtype=torch.int32, device=P.device)
    pcol = torch.zeros(c, dtype=torch.int32, device=P.device)
    pfound = torch.zeros(c, dtype=torch.bool, device=P.device)
    scratch = torch.empty(2 * n, dtype=torch.int32, device=P.device)
    with torch.cuda.device(P.device):
        rc = _cuda.lib().spasm_panel_eliminate(
            Pk.data_ptr(), G.data_ptr(), ispiv.data_ptr(),
            scratch.data_ptr(), prow.data_ptr(), pcol.data_ptr(),
            pfound.data_ptr(), n, c, int(j0), int(npivcols), f.p,
            None if stamps is None else stamps.data_ptr(), flag,
            _cuda.stream_of(P))
    _cuda.check(rc, "panel kernel")
    if not _cuda.capturing():   # a capture records the launch, runs none
        launches += 1
    return Pk, G, prow, pcol, pfound, ispiv
