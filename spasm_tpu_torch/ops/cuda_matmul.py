"""K1 wrapper: the exact mod-p matmul on int8 tensor cores (CUDA).

Replaces ``spasm_tpu/ops/pallas_matmul.py`` (``_kernel``, launched by
``_pallas_mm`` and wrapped by ``modmatmul_pallas``); the kernel is
``spasm_tpu_torch/csrc/modmatmul.cu``, whose header says what bounds it on
the H100.  Its plain PyTorch version is ``ops.matmul.modmatmul_plain``.

The wrapper splits both operands into balanced int8 limb planes
(``modmul.to_limbs``, as the JAX package does outside its kernel), packs
them plane-major and zero-padded to the kernel's tile multiples, and
launches on the current stream.  Any k is exact: the kernel folds its int32
limb accumulators into a running mod-p total before they could overflow,
so no host-side k chunking is needed.
"""

from __future__ import annotations

import ctypes

import torch

from .._host.field import num_limbs
from . import _cuda
from . import modmul

launches = 0  # kernel launches in this process (chip_smoke.py reads it)


def tiles(nl: int) -> tuple[int, int, int]:
    """(BM, BN, BK): the multiples the limb planes are padded to."""
    out = (ctypes.c_int * 3)()
    _cuda.check(_cuda.lib().spasm_modmatmul_tiles(nl, out), "tiles")
    return out[0], out[1], out[2]


def _planes(f, x, nl, rows, cols):
    """x (r, c) -> zero-padded (nl, rows, cols) int8 limb planes."""
    out = torch.zeros((nl, rows, cols), dtype=torch.int8, device=x.device)
    out[:, :x.shape[0], :x.shape[1]] = modmul.to_limbs(f, x, nl).permute(
        2, 0, 1)
    return out


def modmatmul_cuda(f, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """C = a @ b (mod p): balanced int32 (n, k) and (k, m) CUDA tensors in,
    balanced int32 (n, m) out."""
    global launches
    if not (a.is_cuda and b.is_cuda and a.device == b.device):
        raise ValueError("modmatmul_cuda needs both operands on one CUDA "
                         f"device, got {a.device} and {b.device}")
    if a.dtype != torch.int32 or b.dtype != torch.int32:
        raise TypeError(f"expected int32 operands, got {a.dtype}, {b.dtype}")
    if a.dim() != 2 or b.dim() != 2 or a.shape[1] != b.shape[0]:
        raise ValueError(f"bad shapes {tuple(a.shape)} @ {tuple(b.shape)}")
    modmul.check_device_prime(f)
    n, k = a.shape
    m = b.shape[1]
    out = torch.empty((n, m), dtype=torch.int32, device=a.device)
    if n == 0 or m == 0:
        return out
    if k == 0:
        return out.zero_()
    nl = num_limbs(f.p)
    bm, bn, bk = tiles(nl)
    np_, kp, mp = -(-n // bm) * bm, -(-k // bk) * bk, -(-m // bn) * bn
    ap = _planes(f, a, nl, np_, kp)
    bp = _planes(f, b, nl, kp, mp)
    w = (ctypes.c_int64 * (2 * nl - 1))(
        *modmul.limb_weights(f, nl).tolist())
    with torch.cuda.device(a.device):
        rc = _cuda.lib().spasm_modmatmul(
            ap.data_ptr(), bp.data_ptr(), out.data_ptr(), n, m, kp, np_, mp,
            nl, f.p, ctypes.cast(w, ctypes.c_void_p), _cuda.stream_of(a))
    launches += 1
    _cuda.check(rc, "modmatmul kernel")
    return out
