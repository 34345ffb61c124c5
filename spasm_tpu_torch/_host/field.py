"""Exact finite-field arithmetic over GF(p) for p in (2, 2**32 - 5].

Reproduces the semantics of the reference's field layer (SpaSM.jl
``src/SpaSM.jl:51-121`` / ``spasm_ZZp.c``): elements are stored as signed
32-bit integers in the *balanced* range ``[-p/2, p/2]`` (for odd p this is
``[-(p-1)/2, (p-1)/2]``; for p with ``p/2`` rounding down, the reference uses
``halfp = p ÷ 2`` and ``mhalfp = p ÷ 2 - p + 1``).

Two execution tiers:

* **host**: NumPy ``int64``/``object`` arithmetic — always exact for any
  p < 2**32.  Used for orchestration, tiny tails and oracles.
* **device**: ``jnp.int32`` arithmetic designed for the TPU VPU.  Tier A
  (p < 46341, i.e. p*p/4 < 2**30) multiplies directly in int32; tier B
  (p < 2**31) uses a 16x16-bit split.  All device ops keep values in the
  balanced representation so they can feed the MXU int8-limb matmul
  (see ops/matmul.py) without conversion.

This module is pure-Python/NumPy + JAX; there is deliberately no FFI — the
reference's L3 binding layer disappears on TPU (SURVEY.md section 1).
"""

from __future__ import annotations

import dataclasses
import functools

import numpy as np

DEFAULT_PRIME = 42013  # the reference's prime-zero (src/SpaSM.jl:16)

_MAX_PRIME = 0xFFFFFFFB  # largest allowed p (src/SpaSM.jl:74)

# Tier A limit: balanced values have |v| <= p//2; their int32 product must be
# exact: (p//2)**2 < 2**31  =>  p//2 <= 46340  =>  p <= 92681.
_TIER_A_MAX_P = 92681


@dataclasses.dataclass(frozen=True)
class Field:
    """Finite-field context — the analog of the reference's ``Field`` struct
    (src/SpaSM.jl:51-77): precomputed ``p``, ``halfp``, ``mhalfp`` and the
    float reciprocal ``dinvp`` used for Barrett-style reduction."""

    p: int

    def __post_init__(self):
        if not (2 < self.p <= _MAX_PRIME):
            raise ValueError(f"prime must be in (2, {_MAX_PRIME}], got {self.p}")

    @property
    def halfp(self) -> int:
        return self.p // 2

    @property
    def mhalfp(self) -> int:
        return self.p // 2 - self.p + 1

    @property
    def dinvp(self) -> float:
        return 1.0 / self.p

    @property
    def tier(self) -> str:
        """Device arithmetic tier: 'a' = direct int32, 'b' = 16-bit split
        in uint32 (p < 2**31), 'c' = wrap-aware uint32 residues for the
        full reference range up to 2**32 - 5 (src/SpaSM.jl:74)."""
        if self.p <= _TIER_A_MAX_P:
            return "a"
        return "b" if self.p <= (1 << 31) - 1 else "c"

    # ---------------- host (NumPy, always-exact) operations ----------------

    def normalize(self, x):
        """Map arbitrary integers into the balanced range [mhalfp, halfp].

        Semantics of ``_normalize`` + ``mod`` (src/SpaSM.jl:83-97).

        (A division-free float-Barrett variant was measured here and
        reverted: on this host ``np.mod``'s constant-divisor path plus one
        ``np.where`` beats the multiply/round/fold chain once the balanced
        folds are counted.)
        """
        x = np.asarray(x)
        if x.dtype.kind not in "iu" and x.dtype != object:
            raise TypeError(f"expected integer array, got {x.dtype}")
        if x.dtype != object and x.dtype != np.uint64:
            # upcast so np.mod with p > 2**31 - 1 cannot overflow the input
            # dtype (int32 CSR data with large p raised OverflowError)
            x = x.astype(np.int64, copy=False)
        if (x.dtype == np.int64 and x.ndim == 1 and x.size >= (1 << 16)
                and x.flags.c_contiguous):
            # one OpenMP pass (csrc/rowops_mod.c) instead of the
            # mod + where + astype three-pass numpy chain
            from .native import normalize_i64_native

            out = normalize_i64_native(x, self.p)
            if out is not None:
                return out
        r = np.mod(x, self.p)  # in [0, p)
        r = np.where(r > self.halfp, r - self.p, r)
        return r.astype(np.int64) if r.dtype != object else r

    def to_unsigned(self, x):
        """Balanced -> [0, p) lift (the reference's UInt conversions,
        src/SpaSM.jl:110-113)."""
        x = np.asarray(x, dtype=np.int64)
        return np.where(x < 0, x + self.p, x).astype(np.int64)

    def add(self, a, b):
        return self.normalize(np.asarray(a, np.int64) + np.asarray(b, np.int64))

    def sub(self, a, b):
        return self.normalize(np.asarray(a, np.int64) - np.asarray(b, np.int64))

    def neg(self, a):
        return self.normalize(-np.asarray(a, np.int64))

    def mul(self, a, b):
        a = np.asarray(a, np.int64)
        b = np.asarray(b, np.int64)
        if self.p <= (1 << 31):
            # |a|,|b| <= p/2 < 2**30 -> product magnitude < 2**60, exact int64.
            return self.normalize(a * b)
        # p up to 2**32: products can reach 2**62 — still exact in int64
        # because |a|,|b| <= p/2 < 2**31 -> |a*b| < 2**62 < 2**63.
        return self.normalize(a * b)

    def axpy(self, a, x, y):
        """a*x + y, fused with a single reduction (src/SpaSM.jl:387-390)."""
        a = np.asarray(a, np.int64)
        x = np.asarray(x, np.int64)
        y = np.asarray(y, np.int64)
        return self.normalize(a * x + y)

    def inv(self, a):
        """Multiplicative inverse via Fermat (p prime), vectorized modpow.

        Matches ``Base.inv`` (src/SpaSM.jl:386) up to representation (the
        result is normalized into the balanced range).
        """
        a = self.to_unsigned(np.asarray(a, np.int64)).astype(np.uint64)
        if np.any(a % self.p == 0):
            raise ZeroDivisionError("inverse of zero in GF(p)")
        # square-and-multiply; p < 2**32 so products fit in uint64 exactly
        e = self.p - 2
        result = np.ones_like(a)
        base = a % np.uint64(self.p)
        p64 = np.uint64(self.p)
        while e:
            if e & 1:
                result = (result * base) % p64
            base = (base * base) % p64
            e >>= 1
        return self.normalize(result.astype(np.int64))

    def div(self, a, b):
        return self.mul(a, self.inv(b))

    def rand(self, shape, rng=None):
        """Uniform field elements in balanced representation
        (src/SpaSM.jl:121)."""
        rng = np.random.default_rng() if rng is None else rng
        return rng.integers(self.mhalfp, self.halfp + 1, size=shape, dtype=np.int64)

    def from_rational(self, num, den):
        """num/den mod p — the reference's Rational conversion
        (src/SpaSM.jl:115, 952-953)."""
        return self.mul(self.normalize(num), self.inv(self.normalize(den)))

    # ---------------- misc ----------------

    def element_dtype(self) -> np.dtype:
        return np.dtype(np.int32)

    def __repr__(self):
        return f"GF({self.p})"


class ZZp:
    """Scalar field element in the balanced representation — the analog of
    the reference's ``ZZp{F} <: Number`` (src/SpaSM.jl:79-121).  Array code
    should use Field's vectorized methods; this class is API-completeness
    sugar for scalar work."""

    __slots__ = ("field", "v")

    def __init__(self, x, field_: "Field | None" = None):
        self.field = field_ if field_ is not None else Field(DEFAULT_PRIME)
        self.v = int(self.field.normalize(int(x)))

    def _check(self, other):
        if isinstance(other, ZZp):
            if other.field.p != self.field.p:
                raise ValueError(
                    f"mixing GF({self.field.p}) and GF({other.field.p})")
            return other.v
        return int(other)

    def __add__(self, other):
        return ZZp(self.v + self._check(other), self.field)

    __radd__ = __add__

    def __sub__(self, other):
        return ZZp(self.v - self._check(other), self.field)

    def __rsub__(self, other):
        return ZZp(self._check(other) - self.v, self.field)

    def __mul__(self, other):
        return ZZp(self.v * self._check(other), self.field)

    __rmul__ = __mul__

    def __neg__(self):
        return ZZp(-self.v, self.field)

    def inv(self):
        return ZZp(int(self.field.inv(self.v)), self.field)

    def __truediv__(self, other):
        o = ZZp(self._check(other), self.field)
        return self * o.inv()

    def __eq__(self, other):
        if isinstance(other, ZZp):
            return self.field.p == other.field.p and self.v == other.v
        return self.v == self.field.normalize(int(other))

    def __hash__(self):
        return hash((self.field.p, self.v))

    def __int__(self):
        return self.v

    def lift(self) -> int:
        """Unsigned representative in [0, p)."""
        return self.v + self.field.p if self.v < 0 else self.v

    def __repr__(self):
        return f"{self.v}"


F0 = Field(DEFAULT_PRIME)


@functools.lru_cache(maxsize=None)
def field(p: int = DEFAULT_PRIME) -> Field:
    return Field(p)


def datatype_choose(p: int) -> str:
    """TPU analog of ``spasm_datatype_choose`` (src/SpaSM.jl:810): picks the
    carrier for dense mod-p arithmetic — the number of balanced base-256
    int8 limbs per value:

    * ``'i8l1'`` — p <= 255 (1 MXU pass per matmul)
    * ``'i8l2'`` — p <= 65279 (4 passes; covers the default 42013)
    * ``'i8l3'`` — p <= 16711423 (9 passes)
    * ``'i8l4'`` — p <= 4278124287 (16 passes)
    * ``'i8l5'`` — p <= 0xfffffffb (25 passes; only the top sliver of the
      legal prime range needs the 5th limb)

    Per-limb capacity: a balanced value v with |v| <= p//2 splits into
    balanced base-256 limbs in [-128, 127] (see ops/modmul.to_limbs); nl
    limbs cover |v| <= sum_{i<nl} 127 * 256**i.
    """
    half = p // 2
    for nl in range(1, 6):
        if half <= _limb_capacity(nl):
            return f"i8l{nl}"
    raise ValueError(f"p too large: {p}")


def _limb_capacity(num_limbs: int) -> int:
    # balanced base-256 limbs l_i in [-128, 127]; the binding constraint is
    # the positive side: max representable value is 127 * sum 256**i
    return sum(127 * 256**i for i in range(num_limbs))


def num_limbs(p: int) -> int:
    return int(datatype_choose(p)[3:])
