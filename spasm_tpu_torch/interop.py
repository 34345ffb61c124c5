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
    """An LU of either package as a dict of numpy arrays: ``prime``,
    ``n``, ``m``, ``r``, ``complete``, ``qinv``, ``p``, ``piv_cols``, U's
    CSR arrays (``U_indptr``, ``U_indices``, ``U_data``, ``U_shape``), L's
    when present, ``lp_order`` when present, and ``dense_piv_start`` (-1
    for None).  The port's private ``_device`` is not among them."""
    out = dict(prime=np.int64(fact.field.p), n=np.int64(fact.n),
               m=np.int64(fact.m), r=np.int64(fact.r),
               complete=np.int64(bool(fact.complete)),
               qinv=np.asarray(fact.qinv, np.int64),
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


def lu_from_arrays(d: dict, *, device) -> "LU":
    """The port's LU from ``lu_arrays``' dict (of either package's
    factorization), its solves' device work on ``device``: the inverse of
    ``lu_arrays``."""
    from .echelonize import LU

    f = field(int(d["prime"]))
    n, m, r = int(d["n"]), int(d["m"]), int(d["r"])

    def mat(name, shape):
        return SparseGFp(f, *shape, np.array(d[f"{name}_indptr"], np.int64),
                         np.array(d[f"{name}_indices"], np.int32),
                         np.array(d[f"{name}_data"], np.int32),
                         _canonical=True)

    dps = int(d["dense_piv_start"])
    return LU(field=f, n=n, m=m, r=r, complete=bool(int(d["complete"])),
              U=mat("U", (r, m)), qinv=np.array(d["qinv"], np.int64),
              p=np.array(d["p"], np.int64),
              piv_cols=np.array(d["piv_cols"], np.int64),
              L=mat("L", (n, r)) if "L_indptr" in d else None,
              dense_piv_start=None if dps < 0 else dps,
              lp_order=(np.array(d["lp_order"], np.int64)
                        if "lp_order" in d else None),
              _device=str(device))
