"""The port's graphs (its _host copy) and blocks.py against the JAX
package's on the same inputs: maximum matching, structural rank, the
Dulmage-Mendelsohn and strongly-connected-component decompositions, and
the block decomposition with everything computed per block (echelonize,
rank, kernel, transpose, U / L, assembly, the block triangular solve).
Tolerance 0."""

import numpy as np
import pytest

import spasm_tpu as st
from spasm_tpu import SparseGFp, field
from spasm_tpu import blocks as ref_blocks
from spasm_tpu import fixtures as fx
from spasm_tpu import graphs as ref_graphs

import spasm_tpu_torch as stt
from spasm_tpu_torch import blocks as port_blocks
from spasm_tpu_torch import interop
from spasm_tpu_torch._host import graphs as port_graphs

F = field(42013)
DM_FIELDS = ("p", "q", "r", "c", "nb", "rr", "cc")


def port(A):
    return interop.sparse_from_reference(A)


def assert_sparse_equal(got, want):
    assert isinstance(got, stt.SparseGFp)
    assert got.shape == want.shape
    for name in ("indptr", "indices", "data"):
        np.testing.assert_array_equal(getattr(got, name),
                                      getattr(want, name), name)


def assert_lu_equal(got, want):
    a, b = interop.lu_arrays(got), interop.lu_arrays(want)
    assert set(a) == set(b)
    for k in b:
        np.testing.assert_array_equal(a[k], b[k], k)


def square(A):
    """The leading square submatrix of A plus the identity (so every
    vertex has a self loop, as the SCC tests of the reference have)."""
    k = min(A.shape)
    S = A.to_scipy()[:k, :k].tolil()
    S.setdiag(1)
    return SparseGFp.from_scipy(S.tocsr(), A.field.p)


MATRICES = {
    "mixed": lambda: fx.mixed_block_matrix(F, seed=1),
    "mixed_unpermuted": lambda: fx.mixed_block_matrix(F, seed=5,
                                                      permute=False),
    "random": lambda: SparseGFp.rand(F, 60, 48, 0.04,
                                     np.random.default_rng(30)),
    "boundary": lambda: fx.simplex_boundary(8, 3),
}


@pytest.mark.parametrize("name", sorted(MATRICES))
def test_matching_and_dm_match_reference(name):
    A = MATRICES[name]()
    got = port_graphs.maximum_matching(port(A))
    want = ref_graphs.maximum_matching(A)
    assert got[0] == want[0]
    for g, w in zip(got[1:], want[1:]):
        np.testing.assert_array_equal(g, w)
    assert stt.structural_rank(port(A)) == st.structural_rank(A)
    dm, dm0 = stt.dulmage_mendelsohn(port(A)), st.dulmage_mendelsohn(A)
    for k in DM_FIELDS:
        np.testing.assert_array_equal(getattr(dm, k), getattr(dm0, k), k)


@pytest.mark.parametrize("name", sorted(MATRICES))
def test_scc_matches_reference(name):
    A = square(MATRICES[name]())
    scc = stt.strongly_connected_components(port(A))
    scc0 = st.strongly_connected_components(A)
    for k in DM_FIELDS:
        np.testing.assert_array_equal(getattr(scc, k), getattr(scc0, k), k)


def test_matching_helpers_match_reference():
    A = MATRICES["mixed"]()
    _, jmatch, imatch = ref_graphs.maximum_matching(A)
    rng = np.random.default_rng(31)
    p, q = rng.permutation(A.n), rng.permutation(A.m)
    qinv, pinv = np.argsort(q), np.argsort(p)
    for fn, args in (
            ("permute_row_matching", (A.n, jmatch, p, qinv)),
            ("permute_column_matching", (A.m, imatch, pinv, q)),
            ("submatching", (jmatch, 10, 200, 20, 250))):
        np.testing.assert_array_equal(getattr(port_graphs, fn)(*args),
                                      getattr(ref_graphs, fn)(*args), fn)


def assert_block_equal(got, want, each):
    assert len(got) == len(want)
    for name in ("row2block", "col2block"):
        np.testing.assert_array_equal(getattr(got, name),
                                      getattr(want, name), name)
    for name in ("block2row", "block2col"):
        for g, w in zip(getattr(got, name), getattr(want, name)):
            np.testing.assert_array_equal(g, w, name)
    for g, w in zip(got.blocks, want.blocks):
        each(g, w)


@pytest.mark.parametrize("name", ["mixed", "mixed_unpermuted"])
def test_blocks_match_reference(name):
    A = MATRICES[name]()
    blk = stt.block_decompose(port(A))
    blk0 = st.block_decompose(A)
    assert len(blk0) > 1
    assert_block_equal(blk, blk0, assert_sparse_equal)
    assert_sparse_equal(port_blocks.assemble(blk), ref_blocks.assemble(blk0))
    assert port_blocks.assemble(blk) == port(A)
    assert_block_equal(port_blocks.transpose_blocks(blk),
                       ref_blocks.transpose_blocks(blk0),
                       assert_sparse_equal)
    assert stt.rank_blocks(blk, device="cpu") == st.rank_blocks(blk0) \
        == st.rank(A)
    eb = stt.echelonize_blocks(blk, device="cpu", L=True)
    eb0 = st.echelonize_blocks(blk0, L=True)
    assert_block_equal(eb, eb0, assert_lu_equal)
    assert_block_equal(port_blocks.blocks_U(eb), ref_blocks.blocks_U(eb0),
                       assert_sparse_equal)
    assert_block_equal(port_blocks.blocks_L(eb), ref_blocks.blocks_L(eb0),
                       assert_sparse_equal)
    kb = stt.kernel_blocks(blk, device="cpu")
    kb0 = st.kernel_blocks(blk0)
    assert_block_equal(kb, kb0, assert_sparse_equal)
    K = port_blocks.assemble_kernel(kb, stt.field(42013))
    assert_sparse_equal(K, ref_blocks.assemble_kernel(kb0, F))
    assert (port(A) @ K.T).nnz == 0
    # a consistent right-hand side: the U rows of every block, mapped back
    # through the column maps, and one that is not
    rows, cols, vals, off = [], [], [], 0
    for b, e in enumerate(eb0.blocks):
        i, j, v = e.U.to_coo()
        rows.append(i + off)
        cols.append(np.asarray(eb0.block2col[b])[j])
        vals.append(v)
        off += e.r
    B = SparseGFp.from_coo(F, off, A.m, np.concatenate(rows),
                           np.concatenate(cols), np.concatenate(vals))
    X = port_blocks.sparse_triangular_solve_blocks(eb, port(B))
    assert_sparse_equal(X, ref_blocks.sparse_triangular_solve_blocks(eb0, B))
    free = [int(np.asarray(eb0.block2col[b])[np.flatnonzero(e.qinv < 0)[0]])
            for b, e in enumerate(eb0.blocks) if (e.qinv < 0).any()]
    Bad = SparseGFp.from_coo(F, 1, A.m, [0], free[:1], [1])
    assert port_blocks.sparse_triangular_solve_blocks(eb, port(Bad)) is None
    assert ref_blocks.sparse_triangular_solve_blocks(eb0, Bad) is None
