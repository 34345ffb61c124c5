"""Connected-component block decomposition — the analog of the reference's
pure-Julia ``src/blocks.jl``: split a sparse matrix into independent
diagonal blocks by the connected components of its bipartite row-column
graph, compute per block (rank adds, kernels reassemble), and solve block
triangular systems.

This is also the framework's natural coarse work-partitioning unit for
multi-host runs (SURVEY.md section 2.10)."""

from __future__ import annotations

import dataclasses

import numpy as np
import scipy.sparse as sp
import scipy.sparse.csgraph as csgraph

from ._host.csr import SparseGFp
from ._host.field import Field


@dataclasses.dataclass
class Block:
    """blocks + bidirectional index maps (src/blocks.jl:1-7):
    row2block[i] = (block, position), block2row[b][k] = original row."""

    blocks: list
    row2block: np.ndarray   # (n, 2)
    col2block: np.ndarray   # (m, 2)
    block2row: list         # per block: original row indices
    block2col: list

    def __len__(self):
        return len(self.blocks)

    @property
    def shape(self):
        return (self.row2block.shape[0], self.col2block.shape[0])

    def __repr__(self):
        return "\n".join(
            f"block {b}: rows {list(self.block2row[b])} x cols "
            f"{list(self.block2col[b])}: {self.blocks[b]!r}"
            for b in range(len(self)))


def block_decompose(A: SparseGFp) -> Block:
    """``Block(A::CSR)`` (src/blocks.jl:35-105): connected components of
    the bipartite graph on rows+cols; each component becomes an
    independent submatrix."""
    n, m = A.shape
    i, j, v = A.to_coo()
    # bipartite adjacency on n + m nodes
    bi = sp.csr_matrix(
        (np.ones(i.size, np.int8), (i, j + n)), shape=(n + m, n + m))
    ncomp, labels = csgraph.connected_components(bi + bi.T, directed=False)
    row_lab = labels[:n]
    col_lab = labels[n:]
    # stable position-within-block maps
    row2block = np.zeros((n, 2), np.int64)
    col2block = np.zeros((m, 2), np.int64)
    block2row = [np.flatnonzero(row_lab == b) for b in range(ncomp)]
    block2col = [np.flatnonzero(col_lab == b) for b in range(ncomp)]
    for b in range(ncomp):
        row2block[block2row[b]] = np.stack(
            [np.full(block2row[b].size, b),
             np.arange(block2row[b].size)], axis=1)
        col2block[block2col[b]] = np.stack(
            [np.full(block2col[b].size, b),
             np.arange(block2col[b].size)], axis=1)
    blocks = []
    for b in range(ncomp):
        mask = row_lab[i] == b
        bi_, bj_, bv_ = i[mask], j[mask], v[mask]
        blocks.append(SparseGFp.from_coo(
            A.field, block2row[b].size, block2col[b].size,
            row2block[bi_, 1], col2block[bj_, 1], bv_,
            sum_duplicates=False))
    return Block(blocks=blocks, row2block=row2block, col2block=col2block,
                 block2row=block2row, block2col=block2col)


def echelonize_blocks(block: Block, **kwargs) -> Block:
    """Per-block echelonize (src/blocks.jl:107-115)."""
    from .echelonize import echelonize

    return dataclasses.replace(
        block, blocks=[echelonize(b, **kwargs) for b in block.blocks])


def rank_blocks(block: Block, **kwargs) -> int:
    """rank = sum of block ranks (src/blocks.jl:117)."""
    from .solve import rank

    return sum(rank(b, **kwargs) for b in block.blocks)


def kernel_blocks(block: Block, **kwargs) -> Block:
    """Per-block kernels with reassembled row maps (src/blocks.jl:119-139).
    Kernel rows live in the block's column space; col maps carry over."""
    from .solve import kernel

    ks = [kernel(b, **kwargs) for b in block.blocks]
    block2row = []
    row2block = []
    total = 0
    for b, k in enumerate(ks):
        nk = k.shape[0]
        block2row.append(np.arange(total, total + nk))
        for t in range(nk):
            row2block.append((b, t))
        total += nk
    return Block(blocks=ks,
                 row2block=np.array(row2block, np.int64).reshape(-1, 2),
                 col2block=block.col2block, block2row=block2row,
                 block2col=block.block2col)


def transpose_blocks(block: Block) -> Block:
    """transpose(::Block) (src/blocks.jl:141): per-block transpose with
    swapped index maps."""
    return Block(blocks=[b.T for b in block.blocks],
                 row2block=block.col2block, col2block=block.row2block,
                 block2row=block.block2col, block2col=block.block2row)


def blocks_U(block: Block) -> Block:
    """Block of the U factors of a Block of LUs (src/blocks.jl:20-28)."""
    return dataclasses.replace(block,
                               blocks=[x.U for x in block.blocks])


def blocks_L(block: Block) -> Block:
    return dataclasses.replace(block,
                               blocks=[x.L for x in block.blocks])


def assemble(block: Block, field_: Field | None = None,
             n_rows: int | None = None) -> SparseGFp:
    """``CSR(::Block)`` (src/blocks.jl:143-170): flatten back into one
    sparse matrix using the index maps."""
    f = field_ or block.blocks[0].field
    n = n_rows if n_rows is not None else block.row2block.shape[0]
    m = block.col2block.shape[0]
    is_, js_, vs_ = [], [], []
    for b, mat in enumerate(block.blocks):
        i, j, v = mat.to_coo()
        is_.append(np.asarray(block.block2row[b])[i])
        js_.append(np.asarray(block.block2col[b])[j])
        vs_.append(v)
    return SparseGFp.from_coo(
        f, n, m,
        np.concatenate(is_) if is_ else np.zeros(0, np.int64),
        np.concatenate(js_) if js_ else np.zeros(0, np.int64),
        np.concatenate(vs_) if vs_ else np.zeros(0, np.int64),
        sum_duplicates=False)


def assemble_kernel(block: Block, f: Field) -> SparseGFp:
    """Flatten a kernel Block into the full (sum nk) x m matrix."""
    total = sum(k.shape[0] for k in block.blocks)
    return assemble(block, f, n_rows=total)


def sparse_triangular_solve_blocks(block: Block, B: SparseGFp):
    """Block-wise X @ blocks == B (src/blocks.jl:178-226): split each RHS
    row across blocks (by column membership), per-block solve, reassemble.
    block.blocks must be LU factorizations.  Returns X or None."""
    from .solve import sparse_triangular_solve

    m = block.col2block.shape[0]
    assert B.m == m
    nb = len(block)
    # split B's columns per block
    Xs = []
    row_offsets = []
    total_rows = 0
    for b in range(nb):
        fact = block.blocks[b]
        cols = np.asarray(block.block2col[b])
        sel = np.full(m, -1, np.int64)
        sel[cols] = np.arange(cols.size)
        Bb = B.select_cols(sel, cols.size)
        Xb = sparse_triangular_solve(fact, Bb)
        if Xb is None:
            return None
        Xs.append(Xb)
        row_offsets.append(total_rows)
        total_rows += fact.U.shape[0]
    # reassemble: X columns = U-row indices offset per block
    is_, js_, vs_ = [], [], []
    for b, Xb in enumerate(Xs):
        i, j, v = Xb.to_coo()
        is_.append(i)
        js_.append(j + row_offsets[b])
        vs_.append(v)
    f = B.field
    return SparseGFp.from_coo(
        f, B.n, total_rows,
        np.concatenate(is_) if is_ else np.zeros(0, np.int64),
        np.concatenate(js_) if js_ else np.zeros(0, np.int64),
        np.concatenate(vs_) if vs_ else np.zeros(0, np.int64),
        sum_duplicates=False)
