"""Exact dense matrix product over GF(p): the port of
``spasm_tpu/ops/matmul.py``.

``modmatmul`` is the dispatching entry point.  On a CUDA tensor it
launches K1 (``cuda_matmul.modmatmul_cuda``), at every size; on a CPU
tensor it runs ``modmatmul_plain``, the limb path of the reference:

    x = sum_i l_i 256**i,  l_i in [-128, 127]   (modmul.to_limbs)
    A @ B mod p = sum_s (sum_{i+j=s} A_i @ B_j) * (256**s mod p)

The limb products run as float64 matrix products (``torch.matmul`` has no
integer product on CUDA).  They are exact: a diagonal of one k chunk sums at
most ``_k_chunk(nl) * nl`` terms of magnitude <= 128 * 128, below 2**30,
far inside float64's 2**53.  Each chunk's diagonals are reduced mod p and
combined in int64, so the plain version gives the same bits on any device.
"""

from __future__ import annotations

import torch

from .._host.field import num_limbs
from . import modmul


def _k_chunk(nl: int) -> int:
    """k per chunk: chunk * 128 * 128 * nl <= 2**30 (as the reference)."""
    return max(128, (1 << 30) // (16384 * nl) // 128 * 128)


def modmatmul_plain(f, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch C = a @ b (mod p), balanced int32 in and out, on the
    operands' device."""
    modmul.check_device_prime(f)
    n, k = a.shape
    k2, m = b.shape
    if k != k2:
        raise ValueError(f"bad shapes {tuple(a.shape)} @ {tuple(b.shape)}")
    nl = num_limbs(f.p)
    al = modmul.to_limbs(f, a, nl).to(torch.float64)   # (n, k, nl)
    bl = modmul.to_limbs(f, b, nl).to(torch.float64)   # (k, m, nl)
    w = modmul.limb_weights(f, nl).tolist()
    acc = torch.zeros((n, m), dtype=torch.int64, device=a.device)
    chunk = _k_chunk(nl)
    for c0 in range(0, k, chunk):
        c1 = min(k, c0 + chunk)
        diags = [None] * (2 * nl - 1)
        for i in range(nl):
            for j in range(nl):
                prod = al[:, c0:c1, i] @ bl[c0:c1, :, j]
                s = i + j
                diags[s] = prod if diags[s] is None else diags[s] + prod
        for s, d in enumerate(diags):
            term = modmul.normalize(f, d.to(torch.int64)).to(torch.int64)
            acc = modmul.normalize(f, acc + term * w[s]).to(torch.int64)
    return acc.to(torch.int32)


def modmatmul(f, a: torch.Tensor, b: torch.Tensor,
              out: torch.Tensor = None,
              run: torch.Tensor = None,
              work: torch.Tensor = None) -> torch.Tensor:
    """C = a @ b (mod p), balanced int32 in and out.  CUDA tensors go to
    the K1 kernel, CPU tensors to the plain version.

    With ``out`` the product is added to it in place (out = out + a @ b
    mod p; contiguous, sharing no memory with a or b), and out is
    returned.  ``run`` (with ``out``), a 0-d bool tensor, skips the product
    where it holds False: the kernel reads it on the card, the plain
    version on the host, as ``lax.cond`` evaluates on the CPU.  ``work``
    is K1's limb-plane buffer (``cuda_matmul.modmatmul_cuda``); the plain
    version takes none."""
    if a.is_cuda or b.is_cuda:
        from .cuda_matmul import modmatmul_cuda

        return modmatmul_cuda(f, a, b, out=out, run=run, work=work)
    if out is None:
        if run is not None:
            raise ValueError("modmatmul: run needs out")
        return modmatmul_plain(f, a, b)
    if run is None or bool(run):
        out.copy_(modmul.add(f, out, modmatmul_plain(f, a, b)))
    return out


def modmatvec(f, a: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """a @ x (mod p) for a (n, k) and x (k,), balanced int32."""
    return modmatmul(f, a, x[:, None])[:, 0]


def modvecmat(f, x: torch.Tensor, a: torch.Tensor) -> torch.Tensor:
    """x @ a (mod p): the reference's row-vector convention (xApy)."""
    return modmatmul(f, x[None, :], a)[0]
