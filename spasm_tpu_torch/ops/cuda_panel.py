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
                         run: torch.Tensor = None, out=None):
    """Drop-in for ``dense._panel_eliminate(f, P, is_piv_row, j0,
    npivcols, run)`` on CUDA tensors: returns (P', G, prow, pcol, pfound,
    is_piv') and leaves the inputs untouched.  P holds balanced values.
    Raises where the card cannot hold a cluster of 16 CTAs.  ``stamps``, a
    zeroed int64 (c, 1 + len(PHASES)) CUDA tensor, receives the global
    timer (ns) at the start of each step and at the end of each of its
    PHASES (0 where a step had no pivot).  ``run``, a 0-d bool tensor on
    P's device, is read by the kernel: where it holds False the kernel
    returns at once, and the outputs are P, zero G / prow / pcol, no pivot
    found and is_piv_row (the reference's empty-panel ``lax.cond``).

    ``out``, a tuple (G, prow, pcol, pfound, scratch) of contiguous CUDA
    tensors (int32 (n, c), int32 (c,), int32 (c,), bool (c,), int32
    (2n,)), makes the call allocate nothing: the kernel then works on a
    contiguous P and on is_piv_row in place, the outputs are zeroed and
    written, and (P, G, prow, pcol, pfound, is_piv_row) is returned."""
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
    if out is None:
        # the kernel works in place on contiguous copies
        P = P.clone(memory_format=torch.contiguous_format)
        is_piv_row = is_piv_row.clone(memory_format=torch.contiguous_format)
        i32 = dict(dtype=torch.int32, device=P.device)
        out = (torch.empty_like(P), torch.empty(c, **i32),
               torch.empty(c, **i32),
               torch.empty(c, dtype=torch.bool, device=P.device),
               torch.empty(2 * n, **i32))
    Pk, ispiv = P, is_piv_row
    G, prow, pcol, pfound, scratch = out
    want = ((Pk, torch.int32, (n, c)), (ispiv, torch.bool, (n,)),
            (G, torch.int32, (n, c)), (prow, torch.int32, (c,)),
            (pcol, torch.int32, (c,)), (pfound, torch.bool, (c,)),
            (scratch, torch.int32, (2 * n,)))
    if not all(t.dtype == dt and tuple(t.shape) == sh
               and t.is_contiguous() and t.device == P.device
               for t, dt, sh in want):
        raise ValueError("in place, P, is_piv_row and out must be "
                         "contiguous tensors of the shapes and dtypes "
                         "the docstring gives, on one device")
    for t in (G, prow, pcol, pfound):
        t.zero_()
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
