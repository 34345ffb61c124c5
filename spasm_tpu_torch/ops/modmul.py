"""Elementwise exact GF(p) arithmetic on torch tensors.

The port of ``spasm_tpu/ops/modmul.py``.  Values are stored in the balanced
representation as int32 (|v| <= p // 2, see ``spasm_tpu/field.py``), like
the reference.  The arithmetic runs in int64: a balanced product is below
(p / 2)**2 < 2**62 for every legal p <= 0xFFFFFFFB, so one int64 path is
exact over the whole prime range.  The reference's uint32 tier-B/C
machinery existed only because the TPU has no int64 and is not ported.

Every function takes any object with an integer ``p`` attribute as the
field (the port's or the reference's ``Field``).
"""

from __future__ import annotations

import torch

MAX_DEVICE_P = 0xFFFFFFFB  # the reference's full prime range


def check_device_prime(f) -> None:
    if f.p > MAX_DEVICE_P:
        raise NotImplementedError(
            f"device arithmetic supports p <= {MAX_DEVICE_P}; got p={f.p}")


def normalize(f, x: torch.Tensor) -> torch.Tensor:
    """Exact integers (any integer dtype) -> balanced int32."""
    p = f.p
    lo = p // 2 - p + 1                                 # the least balanced value
    r = torch.remainder(x.to(torch.int64) - lo, p)     # [0, p)
    r += lo
    return r.to(torch.int32)


def add(f, a, b):
    return normalize(f, a.to(torch.int64) + b.to(torch.int64))


def sub(f, a, b):
    return normalize(f, a.to(torch.int64) - b.to(torch.int64))


def neg(f, a):
    return -a  # the balanced range is symmetric up to one value: -a stays in it


def mul(f, a, b):
    """Balanced product; ``b`` may be a tensor or a Python int."""
    check_device_prime(f)
    if not isinstance(b, torch.Tensor):
        b = int(b)
    return normalize(f, a.to(torch.int64) * b)


def axpy(f, a, x, y):
    """a*x + y with one reduction: |a*x| < 2**62 and |y| < 2**31."""
    check_device_prime(f)
    return normalize(f, torch.addcmul(y.to(torch.int64), a.to(torch.int64),
                                      x.to(torch.int64)))


def inv_scalar(f, x: torch.Tensor) -> torch.Tensor:
    """Elementwise Fermat inverse x**(p-2) mod p; 0 maps to 0."""
    check_device_prime(f)
    e = f.p - 2
    result = torch.ones_like(x, dtype=torch.int32)
    base = x.to(torch.int32)
    while e:
        if e & 1:
            result = mul(f, result, base)
        base = mul(f, base, base)
        e >>= 1
    return result


def to_limbs(f, x: torch.Tensor, nl: int) -> torch.Tensor:
    """Balanced int32 -> ``nl`` balanced base-256 int8 limbs,
    ``x == sum_i limbs[..., i] * 256**i``; shape ``x.shape + (nl,)``.

    Same recurrence as the reference: the low byte is sign-extended to
    [-128, 127] and v' = (v >> 8) + (low >> 7) avoids overflow at the int32
    extremes that tier-C values reach."""
    v = x.to(torch.int32)
    limbs = []
    for _ in range(nl):
        low = v & 255
        limbs.append(((low ^ 128) - 128).to(torch.int8))
        v = (v >> 8) + (low >> 7)
    return torch.stack(limbs, dim=-1)


def limb_weights(f, nl: int, device=None) -> torch.Tensor:
    """256**s mod p as balanced int32, s = 0 .. 2*nl - 2."""
    w = [pow(256, s, f.p) for s in range(2 * nl - 1)]
    w = [x - f.p if x > f.p // 2 else x for x in w]
    return torch.tensor(w, dtype=torch.int32, device=device)
