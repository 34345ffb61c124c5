"""One-stop functions on top of ``echelonize`` (the port of
``spasm_tpu/solve.py``; only ``rank`` so far)."""

from __future__ import annotations

from .echelonize import LU, echelonize


def rank(obj, *, device="cuda", **kwargs) -> int:
    """Exact rank of a SparseGFp (or the rank of an LU)."""
    if isinstance(obj, LU):
        return obj.r
    return echelonize(obj, device=device, **kwargs).r
