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

The public surface is the reference's: RREF, kernel bases, solve / gesv
(whose dense-finish corner block is inverted on the LU's device), rank
certificates, DM / SCC decompositions, block decompositions, LU files in
the reference's format, and the CLI (``python -m spasm_tpu_torch.cli``).
``echelonize``, ``rank``, ``certificate_rank_create`` and ``load_lu`` take
``device="cuda"`` (the default) or ``device="cpu"``.  ``echelonize`` also
checkpoints and resumes (``checkpoint=``, ``resume=``) and runs over a mesh
of ranks (``mesh=``, ``parallel/``: one process a rank over
``torch.distributed``); ``ops/spmv.py`` is the device SpMV and
``utils/profiling.py`` the profiling hooks.

This package imports neither jax nor anything of ``spasm_tpu``.
"""

from ._host.field import DEFAULT_PRIME, F0, Field, ZZp, field
from ._host.csr import (SparseGFp, Triplet, inverse_permutation, ipvec,
                        pvec, random_permutation)
from ._host.io import dumps_sms, load_sms, matrix_hash, save_pnm, save_sms
from .echelonize import LU, EchelonizeOptions, echelonize, last_phase_stats
from .solve import (dense_back_solve, dense_forward_solve, gesv, kernel,
                    kernel_from_rref, kernel_pivots, rank, rref, rref_of_U,
                    solve, sparse_triangular_solve)
from ._host.graphs import (dulmage_mendelsohn, maximum_matching,
                           strongly_connected_components, structural_rank)
from .blocks import (Block, block_decompose, echelonize_blocks,
                     kernel_blocks, rank_blocks)
from .certificate import (RankCertificate, certificate_rank_create,
                          certificate_rank_verify, factorization_verify,
                          rank_certificate_load, rank_certificate_save)
from .checkpoint import load_lu, save_lu
from ._host import native as _native
from ._host.utils.logging import set_log, wtime

__version__ = "0.1.0"

__all__ = [
    "DEFAULT_PRIME", "F0", "Field", "ZZp", "field",
    "SparseGFp", "Triplet", "inverse_permutation", "ipvec", "pvec",
    "random_permutation",
    "dumps_sms", "load_sms", "matrix_hash", "save_pnm", "save_sms",
    "LU", "EchelonizeOptions", "echelonize", "last_phase_stats",
    "dense_back_solve", "dense_forward_solve", "gesv", "kernel",
    "kernel_from_rref", "kernel_pivots", "rank", "rref", "rref_of_U",
    "solve", "sparse_triangular_solve",
    "dulmage_mendelsohn", "maximum_matching",
    "strongly_connected_components", "structural_rank",
    "Block", "block_decompose", "echelonize_blocks", "kernel_blocks",
    "rank_blocks",
    "RankCertificate", "certificate_rank_create", "certificate_rank_verify",
    "factorization_verify", "rank_certificate_load", "rank_certificate_save",
    "load_lu", "save_lu",
    "release_native_scratch",
    "set_log", "wtime",
]


def release_native_scratch():
    """Release the host kernels' scratch (the reference's call) and the
    cached CUDA graphs of the dense finish (the fused finish's and the
    streaming finish's steps, with its buffers), with the device memory
    their pools hold."""
    from .ops.dense import release_finish_graphs

    _native.release_native_scratch()
    release_finish_graphs()
