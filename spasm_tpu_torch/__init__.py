"""spasm_tpu_torch — exact sparse linear algebra over GF(p) on PyTorch and
CUDA: the port of ``spasm_tpu`` (the JAX package, kept as the reference)
to an NVIDIA H100.

The host rounds (structural pivots, Schur updates, GPLU) run in
``spasm_tpu_torch._host``: the port's own copy of the JAX package's
numpy/C host modules and of the C sources they build, so the pivots are the
reference's.  The blocked dense finish runs on torch tensors, and on a card
through hand-written CUDA kernels: the exact mod-p matmul on int8 tensor
cores (``ops/cuda_matmul.py``) and the panel Jordan elimination on a
thread-block cluster (``ops/cuda_panel.py``); the opt-in device sparse
Schur update merges rows with a third (``ops/cuda_merge.py``).
``echelonize`` and ``rank`` take ``device="cuda"`` (the default) or
``device="cpu"``.

This package imports neither jax nor anything of ``spasm_tpu``.
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
