"""spasm_tpu_torch — exact sparse linear algebra over GF(p) on PyTorch and
CUDA: the port of ``spasm_tpu`` (the JAX package, kept as the reference)
to an NVIDIA H100.

The host rounds (structural pivots, Schur updates, GPLU) are the JAX
package's own numpy/C modules, shared through ``spasm_tpu_torch._host``
without loading jax.  The blocked dense finish runs on torch tensors, and
on a card through two hand-written CUDA kernels: the exact mod-p matmul on
int8 tensor cores (``ops/cuda_matmul.py``) and the panel Jordan
elimination (``ops/cuda_panel.py``).  ``echelonize`` and ``rank`` take
``device="cuda"`` (the default) or ``device="cpu"``.

This package never imports jax.
"""

from ._host.csr import SparseGFp, Triplet
from ._host.field import Field, field
from ._host.io import load_sms, save_sms
from .echelonize import LU, EchelonizeOptions, echelonize, last_phase_stats
from .solve import rank

__version__ = "0.1.0"

__all__ = [
    "Field", "field", "SparseGFp", "Triplet", "load_sms", "save_sms",
    "LU", "EchelonizeOptions", "echelonize", "last_phase_stats", "rank",
]
