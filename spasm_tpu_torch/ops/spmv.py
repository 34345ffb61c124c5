"""Sparse matrix-vector products over GF(p) on a device: the port of
``spasm_tpu/ops/spmv.py`` (the ``spasm_spmv.c`` analog), COO formulation.

Each product A[k] * x[j] is reduced to the balanced range (|v| <= p // 2 <
2**31) and summed per row or column with ``index_add_`` in int64.  A segment
of up to 2**32 such terms sums below 2**63 in magnitude, so the sums are
exact and need no chunking: the reference chunks its int32
``segment_sum`` so that a partial sum never passes 2**31, which int64 makes
unnecessary.  One reduction mod p at the end gives balanced int32.
"""

from __future__ import annotations

import torch

from .._host.field import Field
from . import modmul


class DeviceCOO:
    """A sparse GF(p) matrix resident on ``device`` in COO form: int64
    ``rows`` and ``cols``, balanced int32 ``vals``."""

    def __init__(self, f: Field, n, m, rows, cols, vals, device="cuda"):
        self.field = f
        self.n = int(n)
        self.m = int(m)
        self.device = torch.device(device)
        self.rows = torch.as_tensor(rows).to(self.device, torch.int64)
        self.cols = torch.as_tensor(cols).to(self.device, torch.int64)
        self.vals = torch.as_tensor(vals).to(self.device, torch.int32)

    @classmethod
    def from_csr(cls, A, device="cuda"):
        i, j, v = A.to_coo()
        return cls(A.field, A.n, A.m, i, j, v, device=device)


def _segment_sum(f: Field, nseg: int, seg_ids, terms):
    """sum_{k in segment} terms[k] mod p, exact (see the module
    docstring), as balanced int32."""
    acc = torch.zeros(nseg, dtype=torch.int64, device=terms.device)
    acc.index_add_(0, seg_ids, terms.to(torch.int64))
    return modmul.normalize(f, acc)


def _vector(A: DeviceCOO, x):
    return torch.as_tensor(x).to(A.device, torch.int64)


def xapy(A: DeviceCOO, x, y=None):
    """y <- x @ A + y on A's device; balanced int32 of length A.m."""
    f = A.field
    prod = modmul.mul(f, A.vals, _vector(A, x)[A.rows])
    out = _segment_sum(f, A.m, A.cols, prod)
    if y is not None:
        out = modmul.add(f, out, _vector(A, y))
    return out


def axpy(A: DeviceCOO, x, y=None):
    """y <- A @ x + y on A's device; balanced int32 of length A.n."""
    f = A.field
    prod = modmul.mul(f, A.vals, _vector(A, x)[A.cols])
    out = _segment_sum(f, A.n, A.rows, prod)
    if y is not None:
        out = modmul.add(f, out, _vector(A, y))
    return out
