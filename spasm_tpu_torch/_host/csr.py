"""Host-side sparse matrix containers over GF(p).

``SparseGFp`` is the framework's CSR matrix — the analog of the reference's
``CSR{F}`` / ``struct spasm_csr`` (src/SpaSM.jl:126-167): int64 row pointers,
int32 column indices, int32 values in balanced representation.  Unlike the
reference (which tolerates unsorted rows), we keep a canonical form: indices
sorted within each row, no explicit zeros, values balanced.  All equality /
hashing / golden tests rely on this canonicalization.

``Triplet`` is the COO builder (``struct spasm_triplet``, src/SpaSM.jl:234-260):
entries are appended (mod-reduced on insert, dimensions grow dynamically,
duplicate entries sum on ``compress()``).

The device-side representation (padded tiles for Pallas kernels) is derived
from this container in ops/; orchestration (pivot search, round driver) reads
the raw numpy arrays directly.
"""

from __future__ import annotations

import numpy as np

from .field import DEFAULT_PRIME, Field, field


class SparseGFp:
    """CSR sparse matrix over GF(p), canonical form."""

    __slots__ = ("field", "n", "m", "indptr", "indices", "data",
                 "_rows_expanded")

    def __init__(self, field_, n, m, indptr, indices, data, _canonical=False):
        self.field = field_
        self.n = int(n)
        self.m = int(m)
        self.indptr = np.asarray(indptr, dtype=np.int64)
        self.indices = np.asarray(indices, dtype=np.int32)
        self.data = np.asarray(data, dtype=np.int32)
        assert self.indptr.shape == (self.n + 1,)
        assert self.indices.shape == self.data.shape
        if not _canonical:
            self._canonicalize()

    # ---------------- construction ----------------

    @classmethod
    def from_coo(cls, f: Field, n, m, i, j, v, sum_duplicates=True):
        """Build from COO entries.  Duplicate (i, j) pairs are summed
        mod p; ``sum_duplicates=False`` merely DOCUMENTS that the caller
        guarantees no duplicates (the construction is identical — scipy's
        C coo->csr counting sort replaces the former global lexsort +
        unbuffered scatter, ~5x at tens of M entries).  Exact: int64
        duplicate sums of balanced values cannot overflow below ~4e14
        coincident entries."""
        import scipy.sparse as _sp

        i = np.asarray(i, dtype=np.int64)
        j = np.asarray(j, dtype=np.int64)
        v = np.asarray(v)
        if v.size == 0:
            v = v.astype(np.int64)  # np.asarray([]) defaults to float64
        v = f.normalize(v).astype(np.int64)
        if i.size and (i.min() < 0 or i.max() >= n or j.min() < 0 or j.max() >= m):
            raise IndexError("coo entry out of bounds")
        M = _sp.csr_matrix((v, (i, j)), shape=(n, m))
        M.sort_indices()
        M.data = f.normalize(M.data)
        M.eliminate_zeros()
        return cls(f, n, m, M.indptr.astype(np.int64),
                   M.indices.astype(np.int32), M.data.astype(np.int32),
                   _canonical=True)

    @classmethod
    def from_dense(cls, dense, p: int = DEFAULT_PRIME):
        f = field(p)
        dense = f.normalize(np.asarray(dense))
        i, j = np.nonzero(dense)
        return cls.from_coo(f, dense.shape[0], dense.shape[1], i, j, dense[i, j])

    @classmethod
    def from_scipy(cls, mat, p: int = DEFAULT_PRIME,
                   assume_canonical: bool = False):
        """From a scipy sparse matrix (values mod-reduced; explicit zeros
        dropped) — the analog of ``CSR(::SparseMatrixCSC)``
        (src/SpaSM.jl:941-968) minus the transpose quirk: no transposition
        happens here, row-major in == row-major out.

        assume_canonical=True skips re-canonicalization AND the value
        re-reduction (valid for sputil.mod_reduce output: balanced values,
        sorted indices, no explicit zeros) — the lexsort and the mod pass
        are the dominant costs at tens of millions of nnz."""
        import scipy.sparse as sp

        f = field(p)
        mat = sp.csr_matrix(mat)
        data = (mat.data if assume_canonical else f.normalize(mat.data))
        return cls(f, mat.shape[0], mat.shape[1],
                   mat.indptr.astype(np.int64, copy=False),
                   mat.indices.astype(np.int32, copy=False),
                   data.astype(np.int32, copy=False),
                   _canonical=assume_canonical)

    @classmethod
    def zeros(cls, f: Field, n, m):
        """spzeros (src/SpaSM.jl:443)."""
        return cls(f, n, m, np.zeros(n + 1, np.int64), np.zeros(0, np.int32),
                   np.zeros(0, np.int32), _canonical=True)

    @classmethod
    def eye(cls, f: Field, n):
        """CSR(I, n) (src/SpaSM.jl:990-992)."""
        ar = np.arange(n)
        return cls.from_coo(f, n, n, ar, ar, np.ones(n, np.int64))

    @classmethod
    def rand(cls, f: Field, n, m, density=1.0, rng=None):
        """sprand (src/SpaSM.jl:445): iid Bernoulli(density) pattern with
        uniform nonzero balanced values.

        Large sparse instances use binomial-count + unique-uniform-position
        sampling (the same pattern distribution) instead of materializing
        the dense n*m mask — 50k x 50k at 1e-4 needs ~300k samples, not a
        20 GB mask."""
        rng = np.random.default_rng() if rng is None else rng
        total = int(n) * int(m)
        if total <= (1 << 24) or density >= 0.05:
            mask = rng.random((n, m)) < density
            i, j = np.nonzero(mask)
        else:
            k = int(rng.binomial(min(total, (1 << 62)), density))
            flat = np.unique(rng.integers(0, total, size=int(k * 1.05) + 16,
                                          dtype=np.int64))
            while flat.size < k:  # top up after duplicate removal
                extra = rng.integers(0, total, size=k, dtype=np.int64)
                flat = np.unique(np.concatenate([flat, extra]))
            flat = rng.permutation(flat)[:k]
            i, j = flat // m, flat % m
        v = rng.integers(1, f.p, size=i.size)
        return cls.from_coo(f, n, m, i, j, v)

    def _canonicalize(self):
        f = self.field
        n = self.n
        counts = np.diff(self.indptr)
        rows = np.repeat(np.arange(n, dtype=np.int64), counts)
        order = np.lexsort((self.indices, rows))
        j = self.indices[order]
        v = f.normalize(self.data[order]).astype(np.int32)
        keep = v != 0
        rows, j, v = rows[keep], j[keep], v[keep]
        indptr = np.zeros(n + 1, dtype=np.int64)
        np.add.at(indptr, rows + 1, 1)
        np.cumsum(indptr, out=indptr)
        self.indptr, self.indices, self.data = indptr, j, v

    # ---------------- basic properties ----------------

    @property
    def shape(self):
        return (self.n, self.m)

    @property
    def nnz(self) -> int:
        return int(self.indptr[-1])

    @property
    def prime(self) -> int:
        return self.field.p

    def row_lengths(self):
        return np.diff(self.indptr)

    def rows_expanded(self):
        """Row index of every stored entry (length nnz).  Cached: the
        pivot-search strategies all need it and np.repeat at tens of M
        entries costs ~0.1 s/call (the container is immutable by
        convention — every mutating op builds a new SparseGFp)."""
        cached = getattr(self, "_rows_expanded", None)
        if cached is None:
            cached = np.repeat(np.arange(self.n, dtype=np.int64),
                               self.row_lengths())
            object.__setattr__(self, "_rows_expanded", cached)
        return cached

    def row(self, i):
        """(indices, values) of row i as views."""
        lo, hi = self.indptr[i], self.indptr[i + 1]
        return self.indices[lo:hi], self.data[lo:hi]

    def __repr__(self):
        return (f"{self.n}x{self.m} SparseGFp % {self.field.p} "
                f"with {self.nnz} non-zeros")

    def _repr_png_(self):
        """Notebook rich display: the sparsity pattern as a grayscale
        density image, longest side capped at 500 px — the analog of the
        reference's IJulia PGM display (src/SpaSM.jl:753-767)."""
        from .io import repr_png
        return repr_png(self)

    def __truediv__(self, fact):
        """``B / LU`` — batched sparse triangular solve X @ U == B with
        the factorization's qinv (src/SpaSM.jl:755): the port's ``LU``
        and ``solve.sparse_triangular_solve``.  Returns X or None if any
        row is unsolvable."""
        from ..echelonize import LU
        from ..solve import sparse_triangular_solve
        if isinstance(fact, LU):
            return sparse_triangular_solve(fact, self)
        return NotImplemented

    # ---------------- conversions ----------------

    def to_scipy(self):
        """scipy csr view with int64 data (the elimination kernels do
        int64 arithmetic on .data).  Indices are passed as int32 — scipy
        keeps them (it downcasts int64 index arrays right back to int32
        whenever contents fit, so converting up first is two wasted O(nnz)
        copies at tens of M nnz)."""
        import scipy.sparse as sp

        return sp.csr_matrix(
            (self.data.astype(np.int64), self.indices, self.indptr),
            shape=(self.n, self.m))

    def to_dense(self):
        out = np.zeros((self.n, self.m), dtype=np.int32)
        out[self.rows_expanded(), self.indices] = self.data
        return out

    def to_coo(self):
        return self.rows_expanded(), self.indices.astype(np.int64), \
            self.data.astype(np.int64)

    def findnz(self):
        """(I, J, V) triples, the reference's findnz (src/SpaSM.jl:1088)."""
        return self.to_coo()

    def findnzs(self):
        """Iterator over (i, j, v) triples (src/SpaSM.jl:1104-1118)."""
        for i in range(self.n):
            for k in range(self.indptr[i], self.indptr[i + 1]):
                yield (i, int(self.indices[k]), int(self.data[k]))

    # ---------------- structural ops ----------------

    def transpose(self):
        """CSR transpose (spasm_transpose.c analog, src/SpaSM.jl:589) —
        counting-sort based, O(nnz)."""
        f = self.field
        i, j, v = self.to_coo()
        order = np.lexsort((i, j))
        return SparseGFp.from_coo(f, self.m, self.n, j[order], i[order],
                                  v[order], sum_duplicates=False)

    @property
    def T(self):
        return self.transpose()

    def submatrix(self, r0, r1, c0, c1, with_values=True):
        """Contiguous row/col range extraction (spasm_submatrix.c,
        src/SpaSM.jl:594-598).  Half-open ranges [r0, r1) x [c0, c1)."""
        i, j, v = self.to_coo()
        keep = (i >= r0) & (i < r1) & (j >= c0) & (j < c1)
        i, j, v = i[keep] - r0, j[keep] - c0, v[keep]
        if not with_values:
            v = np.ones_like(v)
        return SparseGFp.from_coo(self.field, r1 - r0, c1 - c0, i, j, v,
                                  sum_duplicates=False)

    def permute(self, p=None, qinv=None, with_values=True):
        """B = P A Q: row i of B is row p[i] of A; column j of A becomes
        column qinv[j] of B (spasm_permutation.c semantics,
        src/SpaSM.jl:606-614)."""
        i, j, v = self.to_coo()
        if p is not None:
            p = np.asarray(p, dtype=np.int64)
            pinv_ = inverse_permutation(p)
            i = pinv_[i]
        if qinv is not None:
            qinv = np.asarray(qinv, dtype=np.int64)
            j = qinv[j]
        if not with_values:
            v = np.ones_like(v)
        return SparseGFp.from_coo(self.field, self.n, self.m, i, j, v,
                                  sum_duplicates=False)

    def select_rows(self, rows, m=None):
        """New matrix whose k-th row is self[rows[k], :] (rows may repeat)."""
        rows = np.asarray(rows, dtype=np.int64)
        counts = self.row_lengths()[rows]
        indptr = np.zeros(rows.size + 1, dtype=np.int64)
        np.cumsum(counts, out=indptr[1:])
        take = _ranges_concat(self.indptr[rows], counts)
        return SparseGFp(self.field, rows.size, self.m if m is None else m,
                         indptr, self.indices[take], self.data[take],
                         _canonical=True)

    def select_cols(self, col_map, new_m):
        """Keep/remap columns: col_map[j] = new column of j, or -1 to drop."""
        col_map = np.asarray(col_map, dtype=np.int64)
        i, j, v = self.to_coo()
        nj = col_map[j]
        keep = nj >= 0
        return SparseGFp.from_coo(self.field, self.n, new_m, i[keep],
                                  nj[keep], v[keep], sum_duplicates=False)

    def vstack(self, other):
        assert self.m == other.m and self.field.p == other.field.p
        indptr = np.concatenate([self.indptr, self.indptr[-1] + other.indptr[1:]])
        return SparseGFp(self.field, self.n + other.n, self.m, indptr,
                         np.concatenate([self.indices, other.indices]),
                         np.concatenate([self.data, other.data]),
                         _canonical=True)

    def hstack(self, other):
        assert self.n == other.n and self.field.p == other.field.p
        return (self.T.vstack(other.T)).T

    # ---------------- element access ----------------

    def __getitem__(self, key):
        if isinstance(key, tuple) and len(key) == 2:
            r, c = key
            if np.isscalar(r) and np.isscalar(c):
                ji, vi = self.row(int(r))
                hit = np.searchsorted(ji, c)
                if hit < ji.size and ji[hit] == c:
                    return int(vi[hit])
                return 0
            r = _as_range(r, self.n)
            c = _as_range(c, self.m)
            return self.submatrix(r.start, r.stop, c.start, c.stop)
        raise TypeError(f"unsupported index {key!r}")

    # ---------------- algebra ----------------

    def __eq__(self, other):
        if not isinstance(other, SparseGFp):
            return NotImplemented
        return (self.shape == other.shape and self.field.p == other.field.p
                and np.array_equal(self.indptr, other.indptr)
                and np.array_equal(self.indices, other.indices)
                and np.array_equal(self.data, other.data))

    def __hash__(self):
        return hash((self.shape, self.field.p, self.indptr.tobytes(),
                     self.indices.tobytes(), self.data.tobytes()))

    def scale(self, alpha):
        alpha = int(self.field.normalize(alpha))
        if alpha == 0:
            return SparseGFp.zeros(self.field, self.n, self.m)
        data = self.field.mul(self.data, alpha)
        out = SparseGFp(self.field, self.n, self.m, self.indptr.copy(),
                        self.indices.copy(), data.astype(np.int32),
                        _canonical=True)
        return out

    def __mul__(self, alpha):
        if np.isscalar(alpha):
            return self.scale(alpha)
        return NotImplemented

    __rmul__ = __mul__

    def __neg__(self):
        return self.scale(-1)

    def __add__(self, other):
        assert self.shape == other.shape and self.field.p == other.field.p
        i1, j1, v1 = self.to_coo()
        i2, j2, v2 = other.to_coo()
        return SparseGFp.from_coo(self.field, self.n, self.m,
                                  np.concatenate([i1, i2]),
                                  np.concatenate([j1, j2]),
                                  np.concatenate([v1, v2]))

    def __sub__(self, other):
        return self + (-other)

    # ---------------- SpMV (spasm_spmv.c analog, src/SpaSM.jl:632-658) ----

    def xapy(self, x, y=None):
        """y <- x @ A + y (dense row vector times sparse matrix)."""
        f = self.field
        x = np.asarray(f.normalize(np.asarray(x)), np.int64)
        assert x.shape == (self.n,)
        out = self._chunked_vecmat(x)
        if y is not None:
            out = f.normalize(out + f.normalize(np.asarray(y)))
        return out

    def axpy(self, x, y=None):
        """y <- A @ x + y (sparse matrix times dense column vector)."""
        f = self.field
        x = np.asarray(f.normalize(np.asarray(x)), np.int64)
        assert x.shape == (self.m,)
        out = self._scatter_spmv(x, self.rows_expanded(), self.n)
        if y is not None:
            out = f.normalize(out + f.normalize(np.asarray(y)))
        return out

    def _chunked_vecmat(self, x):
        return self._scatter_spmv(x, self.indices.astype(np.int64), self.m,
                                  by_cols=True)

    def _scatter_spmv(self, x, idx, nout, by_cols=False):
        """Exact SpMV core: scatter data*x into nout targets through the
        native OpenMP kernel (np.add.at's unbuffered inner loop is
        ~20 M entries/s — 1.3 s per SpMV at d9 scale).  Raw products are
        bounded by (p/2)^2, so for moderate p the whole sum fits int64
        WITHOUT per-entry normalization (the int64 modulo pass was the
        other half of the SpMV wall); large p falls back to normalized
        chunks."""
        from .native import scatter_add

        f = self.field
        # scatter-by-cols (x @ A) gathers x by rows, and vice versa
        gather = self.rows_expanded() if by_cols else self.indices
        out = np.zeros(nout, np.int64)
        half = max(1, f.halfp)
        nnz = idx.size
        if nnz * half * half < (1 << 62):
            prod = self.data * x[gather]  # int64 upcast, |v| <= (p/2)^2
            scatter_add(out, idx, prod)
            return f.normalize(out)
        prod = f.normalize(self.data.astype(np.int64) * x[gather])
        safe_terms = max(1, (1 << 62) // half)
        if nnz <= safe_terms:
            scatter_add(out, idx, prod)
            return f.normalize(out)
        for s0 in range(0, nnz, safe_terms):
            scatter_add(out, idx[s0:s0 + safe_terms],
                        prod[s0:s0 + safe_terms])
            out = f.normalize(out)
        return out

    def __matmul__(self, other):
        """Exact sparse-sparse product mod p.  Chunked over the contraction
        dimension so int64 scipy accumulation never overflows."""
        assert self.m == other.n and self.field.p == other.field.p
        f = self.field
        half = f.halfp
        # max terms per output entry before int64 could overflow
        safe_k = max(1, (1 << 62) // max(1, half * half))
        if self.m <= safe_k:
            prod = self.to_scipy() @ other.to_scipy()
            prod.data = f.normalize(prod.data)
            return SparseGFp.from_scipy(prod, f.p)
        acc = None
        for c0 in range(0, self.m, safe_k):
            c1 = min(self.m, c0 + safe_k)
            part = (self.submatrix(0, self.n, c0, c1).to_scipy()
                    @ other.submatrix(c0, c1, 0, other.m).to_scipy())
            part.data = f.normalize(part.data)
            term = SparseGFp.from_scipy(part, f.p)
            acc = term if acc is None else acc + term
        return acc


class Triplet:
    """COO builder (spasm_triplet.c analog).  Push (i, j, v) entries; the
    dimensions grow to fit (spasm_add_entry semantics, src/SpaSM.jl:482-489)."""

    def __init__(self, n=0, m=0, p: int = DEFAULT_PRIME):
        self.field = field(p)
        self.n = n
        self.m = m
        self.i = []
        self.j = []
        self.v = []

    def push(self, i, j, v):
        if i < 0 or j < 0:
            raise IndexError("negative index")
        self.n = max(self.n, i + 1)
        self.m = max(self.m, j + 1)
        self.i.append(i)
        self.j.append(j)
        self.v.append(int(self.field.normalize(v)))
        return self

    @property
    def nnz(self):
        return len(self.i)

    def transpose_inplace(self):
        """spasm_triplet_transpose (src/SpaSM.jl:491)."""
        self.i, self.j = self.j, self.i
        self.n, self.m = self.m, self.n
        return self

    def compress(self) -> SparseGFp:
        """COO -> CSR, duplicates summed (spasm_compress,
        src/SpaSM.jl:493)."""
        return SparseGFp.from_coo(self.field, self.n, self.m,
                                  np.array(self.i, np.int64),
                                  np.array(self.j, np.int64),
                                  np.array(self.v, np.int64))

    def __repr__(self):
        return (f"{self.n}x{self.m} Triplet % {self.field.p} "
                f"with {self.nnz} non-zeros")


# ---------------- permutation helpers (spasm_permutation.c) ----------------


def inverse_permutation(p):
    """spasm_pinv (src/SpaSM.jl:610)."""
    p = np.asarray(p, dtype=np.int64)
    out = np.empty_like(p)
    out[p] = np.arange(p.size, dtype=np.int64)
    return out


def random_permutation(n, rng=None):
    rng = np.random.default_rng() if rng is None else rng
    return rng.permutation(n).astype(np.int64)


def pvec(p, b):
    """x[i] = b[p[i]] (spasm_pvec)."""
    return np.asarray(b)[np.asarray(p, dtype=np.int64)]


def ipvec(p, b):
    """x[p[i]] = b[i] (spasm_ipvec)."""
    p = np.asarray(p, dtype=np.int64)
    b = np.asarray(b)
    out = np.empty_like(b)
    out[p] = b
    return out


def _ranges_concat(starts, counts):
    """Concatenate ranges [starts[k], starts[k]+counts[k]) as one index
    array, vectorized."""
    starts = np.asarray(starts, dtype=np.int64)
    counts = np.asarray(counts, dtype=np.int64)
    nz = counts > 0
    starts, counts = starts[nz], counts[nz]
    total = int(counts.sum())
    if total == 0:
        return np.zeros(0, dtype=np.int64)
    out = np.ones(total, dtype=np.int64)
    out[0] = starts[0]
    ends = np.cumsum(counts)
    # at the first position of range k (>0), jump from the last value of
    # range k-1 to starts[k]
    out[ends[:-1]] = starts[1:] - (starts[:-1] + counts[:-1] - 1)
    np.cumsum(out, out=out)
    return out


def _as_range(key, size):
    if isinstance(key, slice):
        start, stop, step = key.indices(size)
        if step != 1:
            raise TypeError("only unit-step slices supported")
        return range(start, stop)
    if isinstance(key, range):
        return key
    raise TypeError(f"unsupported index {key!r}")
