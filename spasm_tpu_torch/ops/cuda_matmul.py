"""K1 wrapper: the exact mod-p matmul on the H100's int8 tensor cores.

Replaces ``spasm_tpu/ops/pallas_matmul.py`` (``_pallas_mm`` with body
``_kernel``, wrapped by ``modmatmul_pallas``, which splits the limbs in jnp
before its kernel).  The kernels are in ``spasm_tpu_torch/csrc/``:
``modmatmul.cu`` (the split kernels, and the header that says what bounds
K1 and why it is shaped this way) and ``modmatmul_product.cuh`` (the
product).  The plain PyTorch version of the whole is
``ops.matmul.modmatmul_plain``; ``pack_planes_plain`` and ``product_plain``
below are those of the two steps.

What bounds K1 on this card is the nl*nl int8 plane products on the tensor
cores; what held the first port back was everything around them.  So
``modmatmul_cuda`` allocates with ``torch.empty`` and launches three of
the port's own kernels and nothing else:

1. ``split_cuda(a)``: the balanced int32 operand, read through its strides,
   to nl int8 limb planes (nl, np, kp), zero-padded to the product's tile
   multiples;
2. ``split_cuda(b, transpose=True)``: the same for B, written transposed
   (nl, mp, kp), because ``wgmma`` reads 8-bit operands K-major only;
3. ``product_cuda``: a warp-specialized ``wgmma`` kernel fed by a ring of
   shared-memory stages that TMA keeps full, one int32 register accumulator
   per limb diagonal, folded mod p into C before it could overflow (every
   ``fold_interval(nl)`` of k) and at the end.  Any k is exact.

On a CPU or non-int32 tensor every function here raises: the plain
versions are the CPU's path, chosen by ``ops.matmul.modmatmul``.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from .._host.field import num_limbs
from . import _cuda
from . import modmul

launches = 0        # product-kernel launches in this process
split_launches = 0  # split-kernel launches (chip_smoke.py reads both)
# the kernel's constants (Shape<NL> of modmatmul.cu), mirrored for the code
# that runs without the library: rows, columns per limb count, k
BM, BK = 128, 128
BN = {1: 128, 2: 128, 3: 64, 4: 32, 5: 32}


def fold_interval(nl: int) -> int:
    """k between two folds of the int32 accumulators into C: the largest
    multiple of BK with nl * 128 * 128 * k < 2**31."""
    return ((1 << 31) - 1) // (nl * 16384) // BK * BK


@functools.lru_cache(maxsize=None)
def tiles(nl: int) -> tuple[int, int, int, int]:
    """(BM, BN, BK, kflush) as the built library states them."""
    out = (ctypes.c_int * 4)()
    _cuda.check(_cuda.lib().spasm_modmatmul_tiles(nl, out), "tiles")
    return out[0], out[1], out[2], out[3]


def padded(n: int, k: int, m: int, nl: int) -> tuple[int, int, int]:
    """(np, kp, mp): n, k, m rounded up to the tile multiples."""
    bn = BN[nl]
    return -(-n // BM) * BM, -(-k // BK) * BK, -(-m // bn) * bn


def planes_bytes(n: int, k: int, m: int, p: int) -> int:
    """Bytes of the limb planes that ``modmatmul_cuda`` of an (n, k) by a
    (k, m) operand at prime p splits into: the size of its ``work``."""
    nl = num_limbs(p)
    np_, kp, mp = padded(n, k, m, nl)
    return nl * (np_ + mp) * kp


@functools.lru_cache(maxsize=64)
def _weights(p: int, nl: int):
    """256**s mod p, balanced, s = 0 .. 2 nl - 2, as a C int64 array."""
    w = [pow(256, s, p) for s in range(2 * nl - 1)]
    return (ctypes.c_int64 * len(w))(*[x - p if x > p // 2 else x
                                       for x in w])


def pack_planes_plain(f, x: torch.Tensor, nl: int, rows: int, cols: int,
                      transpose: bool = False) -> torch.Tensor:
    """Plain PyTorch version of the split kernel: exactly its bytes.

    x (r, c) balanced int32 -> (nl, rows, cols) int8: plane i holds limb i
    of x (``modmul.to_limbs``) in its top left corner, of x transposed with
    ``transpose``, and zeros elsewhere."""
    limbs = modmul.to_limbs(f, x, nl).permute(2, 0, 1)      # (nl, r, c)
    if transpose:
        limbs = limbs.transpose(1, 2)
    out = torch.zeros((nl, rows, cols), dtype=torch.int8, device=x.device)
    out[:, :limbs.shape[1], :limbs.shape[2]] = limbs
    return out


def product_plain(f, ap: torch.Tensor, bp: torch.Tensor, n: int,
                  m: int) -> torch.Tensor:
    """Plain PyTorch version of the product kernel, by its schedule: the
    limb diagonals D_s = sum_{i+j=s} A_i @ B_j^T of one fold interval of k
    (float64 products of int8 planes, exact below 2**53; each must fit the
    kernel's int32 accumulator), folded mod p into C with the weights
    256**s, interval after interval."""
    nl, _, kp = ap.shape
    w = modmul.limb_weights(f, nl).tolist()
    a = ap[:, :n].to(torch.float64)
    b = bp[:, :m].to(torch.float64)
    c = torch.zeros((n, m), dtype=torch.int64, device=ap.device)
    step = fold_interval(nl)
    for k0 in range(0, kp, step):
        for s in range(2 * nl - 1):
            d = sum(a[i, :, k0:k0 + step] @ b[s - i, :, k0:k0 + step].T
                    for i in range(max(0, s - nl + 1), min(nl, s + 1)))
            if d.numel() and float(d.abs().max()) >= 2.0 ** 31:
                raise OverflowError("a limb diagonal left the int32 range")
            q = modmul.normalize(f, d.to(torch.int64)).to(torch.int64)
            c = modmul.normalize(f, c + q * w[s]).to(torch.int64)
    return c.to(torch.int32)


def _check_operand(x: torch.Tensor, what: str) -> None:
    if not x.is_cuda:
        raise ValueError(f"{what}: the CUDA kernels need a CUDA tensor, got "
                         f"one on {x.device}")
    if x.dtype != torch.int32:
        raise TypeError(f"{what}: expected int32, got {x.dtype}")
    if x.dim() != 2:
        raise ValueError(f"{what}: expected a matrix, got {tuple(x.shape)}")


def split_cuda(x: torch.Tensor, nl: int, rows: int, cols: int,
               transpose: bool = False) -> torch.Tensor:
    """The limb planes of x (r, c), any strides, by the split kernel:
    (nl, rows, cols) int8 as ``pack_planes_plain`` gives them."""
    global split_launches
    _check_operand(x, "split_cuda")
    r, c = x.shape
    need = (c, r) if transpose else (r, c)
    if not 1 <= nl <= 5 or r == 0 or c == 0 or need[0] > rows \
            or need[1] > cols or rows % 32 or cols % BK:
        raise ValueError(f"split_cuda: {tuple(x.shape)} into ({nl}, {rows}, "
                         f"{cols}), transpose={transpose}")
    out = torch.empty((nl, rows, cols), dtype=torch.int8, device=x.device)
    rc = _cuda.on_device_of(x, lambda: _cuda.lib().spasm_modmatmul_split(
        x.data_ptr(), x.stride(0), x.stride(1), r, c, out.data_ptr(), rows,
        cols, nl, int(transpose), None, _cuda.stream_of(x)))
    split_launches += 1
    _cuda.check(rc, "modmatmul split kernel")
    return out


def product_cuda(f, ap: torch.Tensor, bp: torch.Tensor, n: int,
                 m: int) -> torch.Tensor:
    """C (n, m) = A @ B mod p from the packed planes ap (nl, np, kp) and
    bp (nl, mp, kp) of A and of B transposed."""
    global launches
    nl = num_limbs(f.p)
    if not (ap.is_cuda and bp.is_cuda and ap.device == bp.device):
        raise ValueError("product_cuda needs both operands on one CUDA "
                         f"device, got {ap.device} and {bp.device}")
    if ap.dtype != torch.int8 or bp.dtype != torch.int8:
        raise TypeError(f"expected int8 planes, got {ap.dtype}, {bp.dtype}")
    if not (ap.dim() == bp.dim() == 3 and ap.shape[0] == bp.shape[0] == nl
            and ap.shape[2] == bp.shape[2] and ap.is_contiguous()
            and bp.is_contiguous()):
        raise ValueError(f"bad planes {tuple(ap.shape)}, {tuple(bp.shape)} "
                         f"for {nl} limbs")
    _, np_, kp = ap.shape
    mp = bp.shape[1]
    out = torch.empty((n, m), dtype=torch.int32, device=ap.device)
    rc = _cuda.on_device_of(ap, lambda: _cuda.lib().spasm_modmatmul(
        ap.data_ptr(), bp.data_ptr(), out.data_ptr(), n, m, kp, np_, mp, nl,
        f.p, ctypes.cast(_weights(f.p, nl), ctypes.c_void_p), 0, None,
        _cuda.stream_of(ap)))
    launches += 1
    _cuda.check(rc, "modmatmul kernel")
    return out


def modmatmul_cuda(f, a: torch.Tensor, b: torch.Tensor,
                   out: torch.Tensor = None,
                   run: torch.Tensor = None,
                   work: torch.Tensor = None) -> torch.Tensor:
    """C = a @ b (mod p): balanced int32 (n, k) and (k, m) CUDA tensors in
    (any strides), balanced int32 (n, m) out.

    With ``out`` (a contiguous balanced int32 (n, m) CUDA tensor, sharing
    no memory with a or b) the product is added to it in place, out = out
    + a @ b (mod p), and out is returned.  ``run`` (with ``out`` only), a
    0-d bool tensor on the device, is read by the three kernels: where it
    holds False they return at once and out is left as it is, so a
    product under a device predicate costs no host read.  ``work``, a
    contiguous int8 CUDA tensor of at least ``planes_bytes(n, k, m, p)``
    elements, takes the limb planes: with it and ``out`` the call
    allocates nothing."""
    global launches, split_launches
    _check_operand(a, "modmatmul_cuda")
    _check_operand(b, "modmatmul_cuda")
    if a.device != b.device:
        raise ValueError("modmatmul_cuda needs both operands on one CUDA "
                         f"device, got {a.device} and {b.device}")
    if a.shape[1] != b.shape[0]:
        raise ValueError(f"bad shapes {tuple(a.shape)} @ {tuple(b.shape)}")
    modmul.check_device_prime(f)
    n, k = a.shape
    m = b.shape[1]
    if out is not None:
        _check_operand(out, "modmatmul_cuda out")
        if (tuple(out.shape) != (n, m) or not out.is_contiguous()
                or out.device != a.device):
            raise ValueError(f"out must be a contiguous ({n}, {m}) tensor on "
                             f"{a.device}, got {tuple(out.shape)} on "
                             f"{out.device}")
    elif run is not None:
        raise ValueError("modmatmul_cuda: run needs out")
    flag = _cuda.flag_of(run, a)
    if n == 0 or m == 0:
        return out if out is not None else torch.empty(
            (n, m), dtype=torch.int32, device=a.device)
    if k == 0:
        return out if out is not None else torch.zeros(
            (n, m), dtype=torch.int32, device=a.device)
    nl = num_limbs(f.p)
    np_, kp, mp = padded(n, k, m, nl)
    # the three launches (split a, split b, product) in one call into the
    # library: most main-path products are small, and the host's time per
    # call is what they cost
    size = planes_bytes(n, k, m, f.p)
    if work is None:
        planes = torch.empty(size, dtype=torch.int8, device=a.device)
    elif (work.dtype != torch.int8 or work.device != a.device
          or not work.is_contiguous() or work.numel() < size):
        raise ValueError(f"work must be a contiguous int8 tensor of at "
                         f"least {size} elements on {a.device}, got "
                         f"{work.dtype} {tuple(work.shape)} on {work.device}")
    else:
        planes = work
    acc = out is not None
    if not acc:
        out = torch.empty((n, m), dtype=torch.int32, device=a.device)
    ap = planes.data_ptr()
    rc = _cuda.on_device_of(a, lambda: _cuda.lib().spasm_modmatmul_full(
        a.data_ptr(), a.stride(0), a.stride(1), b.data_ptr(), b.stride(0),
        b.stride(1), ap, ap + nl * np_ * kp, out.data_ptr(), n, k, m, np_,
        kp, mp, nl, f.p, ctypes.cast(_weights(f.p, nl), ctypes.c_void_p),
        int(acc), flag, _cuda.stream_of(a)))
    _cuda.check(rc, "modmatmul kernels")
    if not _cuda.capturing():   # a capture records the launches, runs none
        split_launches += 2
        launches += 1
    return out
