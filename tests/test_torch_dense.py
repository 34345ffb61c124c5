"""Port's dense elimination (spasm_tpu_torch.ops.dense) against the JAX
package's spasm_tpu.ops.dense on the CPU, exactly: rref_inplace with panel
groups 1 and 4, rref on the host and forced onto the tensor path (with the
transform), and the blocked finish's block loop against
blocked_finish_step and fused_blocked_finish.  The port's U is its
canonical CSR (``extract_u_csr``), held against the reference's U through
``mod_reduce``, as the program reduced that U before it built its own."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import scipy.sparse as sp
import torch

from spasm_tpu.field import field
from spasm_tpu.ops import dense as ref_dense
from spasm_tpu.sputil import mod_reduce

from spasm_tpu_torch.echelonize import _low_rank_possible, _streaming_loop
from spasm_tpu_torch.ops import dense


def _matrix(p, rng, n=70, m=90):
    X = field(p).rand((n, m), rng).astype(np.int64)
    X[rng.random(X.shape) > 0.6] = 0
    X[5] = X[9]          # duplicate rows -> rank deficiency
    X[:, 11] = 0
    return X


# the reference compiles its uint32 tier-C arithmetic slowly: tier C runs
# with one panel group only
@pytest.mark.parametrize("p,group", [(42013, 1), (42013, 4), (104729, 1),
                                     (104729, 4), (4294967291, 1)])
def test_rref_inplace_matches_reference(p, group, rng, monkeypatch):
    f = field(p)
    X = _matrix(p, rng)
    npivcols, panel = 80, 8       # the last 10 columns are not eligible
    monkeypatch.setattr(ref_dense, "_FORCE_GROUP", group)
    monkeypatch.setattr(dense, "_FORCE_GROUP", group)
    # a fresh jit, so the reference traces with this group
    R, rank, prow_of, pcol_of, is_piv = jax.jit(
        lambda x: ref_dense.rref_inplace(f, x, npivcols, panel))(
            jnp.asarray(X, jnp.int32))
    got = dense.rref_inplace(f, torch.from_numpy(X.astype(np.int32)),
                             npivcols, panel)
    assert got[1] == int(rank) > 0
    np.testing.assert_array_equal(got[0].numpy(), np.asarray(R))
    np.testing.assert_array_equal(got[2].numpy(), np.asarray(prow_of))
    np.testing.assert_array_equal(got[3].numpy(), np.asarray(pcol_of))
    np.testing.assert_array_equal(got[4].numpy(), np.asarray(is_piv))


@pytest.mark.parametrize("want_transform", [False, True])
@pytest.mark.parametrize("host_cutoff", [None, 0])
def test_rref_matches_reference(host_cutoff, want_transform, rng):
    # host_cutoff=None: both run their host NumPy elimination;
    # host_cutoff=0: the tensor path (the reference's device path)
    f = field(42013)
    X = _matrix(42013, rng, 40, 56)
    want = ref_dense.rref(f, X, want_transform=want_transform, panel=8,
                          host_cutoff=host_cutoff)
    got = dense.rref(f, X, want_transform=want_transform, panel=8,
                     host_cutoff=host_cutoff, device="cpu")
    # a tensor input runs on its own device
    got_t = dense.rref(f, torch.from_numpy(X), want_transform=want_transform,
                       panel=8, host_cutoff=host_cutoff)
    assert set(got) == set(want)
    for k in want:
        for g in (got, got_t):
            if want[k] is None:
                assert g[k] is None
            else:
                np.testing.assert_array_equal(np.asarray(g[k]),
                                              np.asarray(want[k]), k)


def test_rref_empty():
    out = dense.rref(field(5), np.zeros((0, 4), np.int64), device="cpu")
    assert out["rank"] == 0 and out["qinv"].tolist() == [-1] * 4


def _coo(X):
    r, c = np.nonzero(X)
    return r, c, X[r, c]


def assert_same_csr(got, want, f):
    """got (indptr, indices, data) equals mod_reduce(want), array for
    array."""
    want = mod_reduce(want, f)
    for g, w, name in zip(got, (want.indptr, want.indices, want.data),
                          ("indptr", "indices", "data")):
        np.testing.assert_array_equal(g, w, name)


def test_block_steps_match_blocked_finish_step(rng):
    f = field(42013)
    n, m, bs = 200, 96, 64
    X = f.rand((n, m), rng).astype(np.int64)
    X[rng.random(X.shape) > 0.3] = 0
    X[150:] = f.normalize(X[:50] * 3)          # dependent tail
    r_all, c_all, v_all = _coo(X)
    cap = min(n, m) + bs      # the rank bound plus a block
    Ud = torch.zeros((cap, m), dtype=torch.int32)
    pc_map = torch.zeros(cap, dtype=torch.int64)
    r_d = 0
    jcap = ref_dense._bucket(cap) + bs
    Ud_j = jnp.zeros((jcap, m), jnp.int32)
    pc_j = jnp.zeros(jcap, jnp.int32)
    rd_j = jnp.int32(0)
    for b0 in range(0, n, bs):
        b1 = min(n, b0 + bs)
        sel = (r_all >= b0) & (r_all < b1)
        ri, ci, vi = r_all[sel] - b0, c_all[sel], v_all[sel]
        r_d, new_rank, prow_of, pcol_of, ran = dense.blocked_finish_step(
            f, (b1 - b0, m), 32, ri, ci, vi, Ud, pc_map, r_d)
        assert 0 <= ran <= dense.rref_groups(m, 32, "cpu")
        Ud_j, pc_j, rd_j, rank_j, prow_j, pcol_j = (
            ref_dense.blocked_finish_step(
                f, (bs, m), 32, jnp.asarray(ri, jnp.int32),
                jnp.asarray(ci, jnp.int32), jnp.asarray(vi, jnp.int32),
                Ud_j, pc_j, rd_j))
        assert new_rank == int(rank_j)
        np.testing.assert_array_equal(prow_of[:new_rank].numpy(),
                                      np.asarray(prow_j)[:new_rank])
        np.testing.assert_array_equal(pcol_of[:new_rank].numpy(),
                                      np.asarray(pcol_j)[:new_rank])
        assert r_d == int(rd_j)
        np.testing.assert_array_equal(Ud[:r_d].numpy(),
                                      np.asarray(Ud_j)[:r_d])
    assert r_d == 50 + 46 or r_d <= m
    piv = pc_map[:r_d].tolist()
    got = dense.extract_u_csr(Ud, pc_map, r_d, m)
    want = ref_dense.extract_u_csr(Ud_j, pc_j, r_d, m, piv)
    assert_same_csr(got, want, f)


def test_block_loop_matches_fused_blocked_finish(rng, monkeypatch):
    # the port's streaming block loop against the reference's
    # single-dispatch finish, with its dead-row chunking crossed (KC = 64 <
    # rank)
    f = field(42013)
    n, m, bs = 240, 160, 64
    X = f.rand((n, m), rng).astype(np.int64)
    X[rng.random(X.shape) > 0.4] = 0
    X[180:] = f.normalize(X[:60] * 7)
    r_all, c_all, v_all = _coo(X)

    class Opts:
        enable_tall_and_skinny = True
        L = False
        tall_and_skinny_ratio = 5.0

    Usp, piv_cols, piv_rows = _streaming_loop(
        f, sp.csr_matrix(X), np.arange(m), bs, Opts, torch.device("cpu"),
        _low_rank_possible(Opts, n, m))
    monkeypatch.setattr(ref_dense, "_FUSED_KC", 64)
    n_pad = -(-n // bs) * bs
    Ud, pc_map, r_d, ranks, prows, pcols = ref_dense.fused_blocked_finish(
        f, (n_pad, m), m, bs, 128, jnp.asarray(r_all, jnp.int32),
        jnp.asarray(c_all, jnp.int32), jnp.asarray(v_all, jnp.int32))
    ranks, prows, pcols = (np.asarray(x) for x in (ranks, prows, pcols))
    want_cols, want_rows = [], []
    for b in np.flatnonzero(ranks):
        k = int(ranks[b])
        want_cols += pcols[b, :k].tolist()
        want_rows += (b * bs + prows[b, :k]).tolist()
    assert int(r_d) == len(piv_cols) == 160
    np.testing.assert_array_equal(piv_cols, want_cols)
    np.testing.assert_array_equal(piv_rows, want_rows)
    want = ref_dense.extract_u_csr(Ud, pc_map, int(r_d), m, want_cols)
    assert_same_csr(Usp, want, f)


def test_densify_and_extract(rng):
    f = field(42013)
    rows = np.array([0, 1, 1, 3]); cols = np.array([2, 0, 0, 4])
    vals = np.array([5, 7, -3, 9])
    X = dense.densify_coo((4, 5), rows, cols, vals, "cpu")
    want = np.zeros((4, 5), np.int64)
    np.add.at(want, (rows, cols), vals)
    np.testing.assert_array_equal(X.numpy(), want)
    assert dense.host_cutoff_for(f) == ref_dense.host_cutoff_for(f)
    assert (dense.host_cutoff_for(field(4294967291))
            == ref_dense.host_cutoff_for(field(4294967291)))
