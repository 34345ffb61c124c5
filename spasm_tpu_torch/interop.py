"""Carry matrices and factorizations between ``spasm_tpu`` and the port.

The port keeps its own copy of the host modules
(``spasm_tpu_torch._host``), so its ``SparseGFp`` is a different class from
the reference's even though the code is the same.  These helpers go
through plain numpy arrays and never import jax or ``spasm_tpu``.
"""

from __future__ import annotations

import numpy as np

from ._host.csr import SparseGFp
from ._host.field import field


def sparse_from_arrays(p: int, shape, indptr, indices, data) -> SparseGFp:
    """A port SparseGFp from CSR arrays (canonicalized as the reference
    does for non-canonical input)."""
    n, m = shape
    return SparseGFp(field(int(p)), n, m, np.array(indptr, np.int64),
                     np.array(indices, np.int32), np.array(data, np.int32))


def sparse_from_reference(A) -> SparseGFp:
    """A port SparseGFp holding the same entries as ``A``, a ``spasm_tpu``
    SparseGFp (read as numpy arrays)."""
    return sparse_from_arrays(A.field.p, A.shape, A.indptr, A.indices,
                              A.data)


def lu_arrays(fact) -> dict:
    """An LU of either package as a dict of numpy arrays: ``r``, ``qinv``,
    ``p``, ``piv_cols``, U's CSR arrays (``U_indptr``, ``U_indices``,
    ``U_data``, ``U_shape``), L's when present, ``lp_order`` when present,
    and ``dense_piv_start`` (-1 for None)."""
    out = dict(r=np.int64(fact.r), qinv=np.asarray(fact.qinv, np.int64),
               p=np.asarray(fact.p, np.int64),
               piv_cols=np.asarray(fact.piv_cols, np.int64),
               dense_piv_start=np.int64(-1 if fact.dense_piv_start is None
                                        else fact.dense_piv_start))
    if fact.lp_order is not None:
        out["lp_order"] = np.asarray(fact.lp_order, np.int64)
    mats = [("U", fact.U)] + ([("L", fact.L)] if fact.L is not None else [])
    for name, M in mats:
        out[f"{name}_shape"] = np.asarray(M.shape, np.int64)
        out[f"{name}_indptr"] = np.asarray(M.indptr, np.int64)
        out[f"{name}_indices"] = np.asarray(M.indices, np.int64)
        out[f"{name}_data"] = np.asarray(M.data, np.int64)
    return out
