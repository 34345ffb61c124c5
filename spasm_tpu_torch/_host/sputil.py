"""scipy.sparse helpers with exact mod-p semantics (int64, overflow-safe)."""

from __future__ import annotations

import numpy as np
import scipy.sparse as sp

from .field import Field


def mod_reduce(mat, f: Field):
    """Reduce a scipy sparse matrix's data into balanced form, dropping
    zeros.  Returns csr."""
    mat = sp.csr_matrix(mat)
    mat.data = f.normalize(mat.data)
    mat.eliminate_zeros()
    mat.sort_indices()
    return mat


def safe_spgemm(f: Field, a, b):
    """a @ b mod p with int64 accumulation guaranteed exact: chunks the
    contraction dimension so that (#terms) * (p/2)**2 < 2**62."""
    a = sp.csr_matrix(a)
    b = sp.csr_matrix(b)
    half = max(1, f.halfp)
    safe_k = max(1, (1 << 62) // (half * half))
    k = a.shape[1]
    if k <= safe_k:
        return mod_reduce(a @ b, f)
    acc = None
    for c0 in range(0, k, safe_k):
        c1 = min(k, c0 + safe_k)
        part = mod_reduce(a[:, c0:c1] @ b[c0:c1, :], f)
        acc = part if acc is None else mod_reduce(acc + part, f)
    return acc


def safe_sub(f: Field, a, b):
    """a - b mod p, balanced."""
    return mod_reduce(sp.csr_matrix(a) - sp.csr_matrix(b), f)


def dense_matmul_host(f: Field, a, b):
    """Exact dense a @ b mod p on the host (int64, chunked)."""
    a = np.asarray(a, np.int64)
    b = np.asarray(b, np.int64)
    half = max(1, f.halfp)
    safe_k = max(1, (1 << 62) // (half * half))
    k = a.shape[1]
    if k <= safe_k:
        return f.normalize(a @ b)
    acc = np.zeros((a.shape[0], b.shape[1]), np.int64)
    for c0 in range(0, k, safe_k):
        c1 = min(k, c0 + safe_k)
        acc = f.normalize(acc + f.normalize(a[:, c0:c1] @ b[c0:c1]))
    return acc
