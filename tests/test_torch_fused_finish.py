"""The port's single-dispatch dense finish (spasm_tpu_torch.ops.dense
.fused_blocked_finish) and its device-resident rref_inplace against the JAX
package's on the CPU, exactly (GF(p): tolerance 0): the same seeded numpy
inputs give the same r_d, per-block ranks, pivot rows and columns, and the
same U from extract_u_csr (the port's canonical CSR against the
reference's through ``mod_reduce``).  Also: which block loop echelonize takes (the
reference's condition, with or without checkpoint=), the kernels' run
flags in their plain versions, and the mesh helpers, which no longer fall
back to the CPU.

The reference compiles its tier-B/C arithmetic slowly (a fused finish with
panel groups of 4 takes minutes at p = 2**31 - 19); those primes run here
with one panel group, and p = 4294967291 in its own file
(test_torch_fused_finish_tier_c.py) so that the two run side by side."""

import importlib
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import scipy.sparse as sp
import torch

import spasm_tpu as st
from spasm_tpu import SparseGFp
from spasm_tpu.field import field
from spasm_tpu.ops import dense as ref_dense
from spasm_tpu.sputil import mod_reduce

import spasm_tpu_torch as stt
from spasm_tpu_torch import interop
from spasm_tpu_torch.ops import dense
from torch_dead_groups import GROUPS, RUNS, dead_group_matrix

ref_ech = importlib.import_module("spasm_tpu.echelonize")
port_ech = importlib.import_module("spasm_tpu_torch.echelonize")


def finish_matrix(p, rng, case, n=160, m=100):
    """An (n, m) matrix for a finish in blocks of 32 rows with panels of
    16: "mixed" has a zero column band of two whole panels, zero rows, a
    rank-deficient block and dependent tail blocks (rows 96.. are multiples
    of rows 0..63), and more rows than columns, so the column rank is
    reached before the last block; "zero" is all zero; "full" is dense with
    rank m reached in the fourth block, the fifth dead."""
    f = field(p)
    X = f.rand((n, m), rng).astype(np.int64)
    if case == "zero":
        return X * 0
    if case == "mixed":
        X[rng.random(X.shape) > 0.5] = 0
        X[:, 16:48] = 0
        X[[3, 40, 41]] = 0
        X[40:48] = f.normalize(X[32:40] * 5)
        X[96:] = f.normalize(X[:64] * 3)
    return X


def _coo(X):
    r, c = np.nonzero(X)
    return r, c, X[r, c]


def _ref_fused(f, shape, npiv, bs, panel, r, c, v):
    # a fresh jit, so the reference traces with this test's panel group
    fn = jax.jit(ref_dense.fused_blocked_finish.__wrapped__,
                 static_argnums=(0, 1, 2, 3, 4))
    out = fn(f, shape, npiv, bs, panel, jnp.asarray(r, jnp.int32),
             jnp.asarray(c, jnp.int32), jnp.asarray(v, jnp.int32))
    return [np.asarray(x) for x in out]


def _pivots(ranks, prows, pcols, bs):
    cols, rows = [], []
    for b in np.flatnonzero(ranks):
        k = int(ranks[b])
        cols += pcols[b, :k].tolist()
        rows += (b * bs + prows[b, :k]).tolist()
    return cols, rows


def check_fused(p, case, group, monkeypatch, bs=32, panel=16, m=100):
    f = field(p)
    X = finish_matrix(p, np.random.default_rng(p % 1000 + len(case)), case,
                      m=m)
    n = X.shape[0]
    na = dense._bucket(m)
    assert na > m          # npiv < na: padding columns hold no pivot
    r, c, v = _coo(X)
    monkeypatch.setattr(ref_dense, "_FORCE_GROUP", group)
    monkeypatch.setattr(dense, "_FORCE_GROUP", group)
    monkeypatch.setattr(ref_dense, "_FUSED_KC", 64)   # crossed chunks
    want = _ref_fused(f, (n, na), m, bs, panel, r, c, v)
    got = dense.fused_blocked_finish(
        f, (n, na), m, bs, panel, torch.from_numpy(r), torch.from_numpy(c),
        torch.from_numpy(v.astype(np.int32)))
    r_d = int(got[2])
    assert r_d == int(want[2])
    for g, w, name in zip(got[3:], want[3:], ("ranks", "prows", "pcols")):
        np.testing.assert_array_equal(g.numpy(), w, name)
    cols, _ = _pivots(*want[3:], bs)
    assert len(cols) == r_d
    if r_d:
        U = dense.extract_u_csr(got[0], got[1], r_d, na)
        U_ref = mod_reduce(ref_dense.extract_u_csr(
            jnp.asarray(want[0]), jnp.asarray(want[1]), r_d, na, cols), f)
        for g, w in zip(U, (U_ref.indptr, U_ref.indices, U_ref.data)):
            np.testing.assert_array_equal(g, w)
    return r_d, got[3].numpy()


@pytest.mark.parametrize("group", [1, 4])
@pytest.mark.parametrize("case", ["mixed", "full", "zero"])
def test_fused_finish_matches_reference(case, group, monkeypatch):
    r_d, ranks = check_fused(42013, case, group, monkeypatch)
    if case == "full":
        # the column rank is reached in block 3: the later blocks are
        # dead (the reference's while_loop exits there)
        assert r_d == 100 and ranks.tolist() == [32, 32, 32, 4, 0]
    if case == "mixed":
        assert 0 < r_d < 100 and 0 in ranks.tolist()[3:]
    if case == "zero":
        assert r_d == 0


def test_fused_finish_matches_reference_tier_b(monkeypatch):
    check_fused(2147483629, "mixed", 1, monkeypatch)


def test_fused_finish_chunked_back_elimination(monkeypatch):
    # the back-elimination of the accumulated panel in one-row chunks
    # (SUB_CHUNK smaller than a row), as a finish wider than SUB_CHUNK
    # splits it: the same result
    monkeypatch.setattr(dense, "SUB_CHUNK", 1)
    check_fused(42013, "mixed", 1, monkeypatch)


# ---- the device-resident rref_inplace


def _rref_matrix(p, rng, n=70, m=90):
    X = field(p).rand((n, m), rng).astype(np.int64)
    X[rng.random(X.shape) > 0.6] = 0
    X[5] = X[9]
    X[:, 11] = 0
    X[:, 32:48] = 0        # two whole empty panels of 8
    X[60:] = field(p).normalize(X[:10] * 2)
    return X


def check_rref(p, group, want_transform, rng, monkeypatch):
    f = field(p)
    X = _rref_matrix(p, rng)
    npivcols = 80   # the last columns are not eligible
    monkeypatch.setattr(ref_dense, "_FORCE_GROUP", group)
    monkeypatch.setattr(dense, "_FORCE_GROUP", group)
    fn = jax.jit(ref_dense._rref_jit.__wrapped__,
                 static_argnums=(0, 2, 3, 4))
    want = fn(f, jnp.asarray(X, jnp.int32), npivcols, 8, want_transform)
    got = dense._rref(f, torch.from_numpy(X.astype(np.int32)), npivcols, 8,
                      want_transform)
    assert got[1].dim() == 0 and got[1].dtype == torch.int32
    assert int(got[1]) == int(want[1]) > 0
    for i, name in ((0, "R"), (2, "prow_of"), (3, "pcol_of"),
                    (4, "is_piv"), (5, "T")):
        if want[i] is None:
            assert got[i] is None
        else:
            np.testing.assert_array_equal(got[i].numpy(), np.asarray(want[i]),
                                          name)


@pytest.mark.parametrize("p,group,want_transform", [
    (42013, 1, False), (42013, 1, True), (42013, 4, False), (42013, 4, True),
    (2147483629, 1, True)])
def test_rref_matches_reference(p, group, want_transform, rng, monkeypatch):
    check_rref(p, group, want_transform, rng, monkeypatch)


def test_rref_inplace_dead_on_entry():
    # alive=False on entry: the reference's while_loop is not entered
    f = field(42013)
    X = torch.from_numpy(_rref_matrix(42013, np.random.default_rng(3))
                         .astype(np.int32))
    R, rank, prow_of, pcol_of, is_piv = dense.rref_inplace(
        f, X, 80, 8, alive=torch.tensor(False))
    assert int(rank) == 0 and torch.equal(R, X)
    assert (prow_of == -1).all() and (pcol_of == -1).all()
    assert not is_piv.any()


# ---- the panel groups whose body an RREF runs (counted on the host here)


def _dead_groups(p, seed):
    # five blocks of 16 rows over groups of two 8-column panels
    return dead_group_matrix(field(p), seed, bs=16, gw=16, last=12)


@pytest.mark.parametrize("p", [42013, 2147483629])
def test_rref_counts_the_groups_it_runs(p, monkeypatch):
    # block 0 alone: a leading all-zero group, a live one, then the early
    # exit before the last: one body of three, and the bits of one panel
    # a group
    f = field(p)
    X = torch.from_numpy(_dead_groups(p, 1)[:16].astype(np.int32))
    got = {}
    for group in (1, 2):
        monkeypatch.setattr(dense, "_FORCE_GROUP", group)
        runs = torch.zeros((), dtype=torch.int64)
        got[group] = dense.rref_inplace(f, X, 44, 8, runs=runs), int(runs)
    assert dense.rref_groups(44, 8, "cpu") == GROUPS
    assert got[2][1] == 1 and got[1][1] == 2      # panels 2 and 3 of 6
    assert int(got[2][0][1]) == 16
    for a, b in zip(got[1][0], got[2][0]):
        assert torch.equal(a, b)


@pytest.mark.parametrize("p", [42013, 2147483629])
def test_block_loops_count_the_groups_they_run(p, monkeypatch):
    # the fused finish and the streaming steps over the five blocks: the
    # dead groups (leading zeros, a dry block, a dependent block, the exit
    # in the middle of a block) run no body, the last group of block 2
    # does; each loop gives the bits of one panel a group
    f = field(p)
    X = _dead_groups(p, 2)
    r, c, v = (torch.from_numpy(x) for x in _coo(X))
    v = v.to(torch.int32)
    fused, steps = {}, {}
    for group in (1, 2):
        monkeypatch.setattr(dense, "_FORCE_GROUP", group)
        fused[group] = dense.fused_blocked_finish(f, (80, 128), 44, 16, 8,
                                                  r, c, v)
        Ud = torch.zeros((60, 44), dtype=torch.int32)
        pc_map = torch.zeros(60, dtype=torch.int64)
        r_d, ran = 0, []
        for b0 in range(0, 80, 16):
            sel = (r >= b0) & (r < b0 + 16)
            r_d, _, _, _, k = dense.blocked_finish_step(
                f, (16, 44), 8, r[sel] - b0, c[sel], v[sel], Ud, pc_map, r_d)
            ran.append(k)
        steps[group] = Ud[:r_d].clone(), ran
    assert fused[2][3].tolist() == [16, 0, 12, 0, 16]
    assert int(fused[2][6]) == RUNS and steps[2][1] == [1, 0, 1, 0, 1]
    assert int(fused[1][6]) == sum(steps[1][1]) == 6
    for a, b in zip(fused[1][:6], fused[2][:6]):
        assert torch.equal(a, b)
    assert torch.equal(steps[1][0], steps[2][0])
    assert torch.equal(steps[2][0], fused[2][0][:44, :44])


@pytest.mark.parametrize("run", [False, True])
def test_panel_run_flag(run):
    # the plain panel elimination with the kernel's run flag: False is the
    # reference's empty-panel branch (P, zeros, is_piv), True the same as
    # no flag
    f = field(42013)
    rng = np.random.default_rng(4)
    P = torch.from_numpy(f.rand((40, 16), rng).astype(np.int32))
    ip = torch.zeros(40, dtype=torch.bool)
    ip[3] = True
    got = dense._panel_eliminate(f, P, ip, 0, 16, torch.tensor(run))
    if run:
        want = dense._panel_eliminate(f, P, ip, 0, 16)
    else:
        z = torch.zeros(16, dtype=torch.int32)
        want = (P, torch.zeros_like(P), z, z, torch.zeros(16, dtype=bool), ip)
    for g, w in zip(got, want):
        assert torch.equal(g, w)


def test_modmatmul_out_and_run():
    # the accumulating product with a run flag (K1's plain path): out +=
    # a @ b mod p where the flag holds, out untouched where it does not
    from spasm_tpu_torch.ops import matmul

    f = field(42013)
    rng = np.random.default_rng(5)
    a, b, c = (torch.from_numpy(f.rand(s, rng).astype(np.int32))
               for s in ((30, 20), (20, 40), (30, 40)))
    want = dense.modmul.add(f, c, matmul.modmatmul(f, a, b))
    out = c.clone()
    assert matmul.modmatmul(f, a, b, out=out, run=torch.tensor(False)) is out
    assert torch.equal(out, c)
    matmul.modmatmul(f, a, b, out=out, run=torch.tensor(True))
    assert torch.equal(out, want)
    with pytest.raises(ValueError):
        matmul.modmatmul(f, a, b, run=torch.tensor(True))


# ---- which block loop echelonize takes


def _spies(monkeypatch):
    calls = {"ref": 0, "port": 0}
    for mod, key in ((ref_ech, "ref"), (port_ech, "port")):
        real = mod._fused_device_finish

        def spy(*a, _real=real, _key=key, **k):
            calls[_key] += 1
            return _real(*a, **k)

        monkeypatch.setattr(mod, "_fused_device_finish", spy)
    return calls


def _both(A, ref_kw=None, port_kw=None, **kw):
    want = interop.lu_arrays(st.echelonize(A, **kw, **(ref_kw or {})))
    got = interop.lu_arrays(stt.echelonize(
        interop.sparse_from_reference(A), device="cpu", **kw,
        **(port_kw or {})))
    assert set(got) == set(want)
    for k in want:
        np.testing.assert_array_equal(got[k], want[k], k)
    return got


@pytest.mark.parametrize("case", ["fused", "checkpoint", "low_rank",
                                  "over_budget", "L"])
def test_echelonize_takes_the_references_finish(case, monkeypatch,
                                                tmp_path):
    F = field(42013)
    rng = np.random.default_rng(11)
    monkeypatch.setattr(ref_dense, "HOST_CUTOFF", 1)
    monkeypatch.setattr(dense, "HOST_CUTOFF", 1)
    calls = _spies(monkeypatch)
    kw = dict(max_round=0, dense_block_size=100)
    ref_kw = port_kw = None
    want_calls = {"ref": 1, "port": 1}
    if case == "low_rank":
        X = sp.random(700, 20, density=0.3, random_state=rng,
                      data_rvs=lambda k: rng.integers(1, 1000, k),
                      dtype=np.int64)
        Y = sp.random(20, 60, density=0.3, random_state=rng,
                      data_rvs=lambda k: rng.integers(1, 1000, k),
                      dtype=np.int64)
        A = SparseGFp.from_scipy((X @ Y).tocsr(), F.p)
        want_calls = {"ref": 0, "port": 0}
    else:
        A = SparseGFp.rand(F, 260, 180, 0.06, rng)
    if case == "checkpoint":
        # both take the fused finish, which writes no dense sidecar
        ref_kw = dict(checkpoint=str(tmp_path / "ref.npz"))
        port_kw = dict(checkpoint=str(tmp_path / "port.npz"))
    if case == "over_budget":
        monkeypatch.setattr(ref_dense, "FUSED_BUDGET", 0)
        monkeypatch.setattr(dense, "FUSED_BUDGET", 0)
        want_calls = {"ref": 0, "port": 0}
    if case == "L":
        kw["L"] = True
    got = _both(A, ref_kw=ref_kw, port_kw=port_kw, **kw)
    assert calls == want_calls
    assert got["r"] > 0
    if case == "checkpoint":
        assert sorted(os.listdir(tmp_path)) == ["port.npz", "ref.npz"]


def checkpoint_case(rng, head):
    """A 300 x 180 matrix whose first ``head`` rows are zero in the first
    24 columns, and whose last 50 rows are multiples of rows 0..49: in
    blocks of ``head`` rows the pivots of rows head.. in those columns
    come after the first block's, in blocks of _bucket(head) rows
    before."""
    F = field(42013)
    M = SparseGFp.rand(F, 300, 180, 0.06, rng).to_scipy().tolil()
    M[:head, :24] = 0
    M = M.tocsr()
    M = sp.vstack([M[:250], (M[:50] * 3).tocsr()]).tocsr()
    M.data = F.normalize(M.data)
    return SparseGFp.from_scipy(M, F.p)


@pytest.mark.parametrize("block", [150, 200])
def test_checkpointed_echelonize_matches_reference(block, monkeypatch,
                                                   tmp_path):
    """echelonize(A, checkpoint=) in the port against the reference's
    echelonize(A, checkpoint=), every array of lu_arrays exactly, at block
    heights whose bucket differs (the fused loop's blocks are 256 rows).
    Failed before the port took the reference's fused finish under
    checkpoint=: it streamed in blocks of ``block`` rows, listed the
    pivots of rows ``block``.. after the first block's, and p, qinv,
    piv_cols and U's indices differed."""
    monkeypatch.setattr(ref_dense, "HOST_CUTOFF", 1)
    monkeypatch.setattr(dense, "HOST_CUTOFF", 1)
    calls = _spies(monkeypatch)
    A = checkpoint_case(np.random.default_rng(block), block)
    assert dense._bucket(block) != block
    got = _both(A, ref_kw=dict(checkpoint=str(tmp_path / "ref.npz")),
                port_kw=dict(checkpoint=str(tmp_path / "port.npz")),
                max_round=0, dense_block_size=block)
    assert calls == {"ref": 1, "port": 1}
    assert 0 < got["r"] < A.n
    assert not any(x.endswith(".dense") for x in os.listdir(tmp_path))


def test_fused_finish_returns_none_without_pivots(monkeypatch):
    # a finish whose rows are all zero in the finish's columns finds no
    # pivot: both loops return None alike
    F = field(42013)
    calls = _spies(monkeypatch)
    monkeypatch.setattr(ref_dense, "HOST_CUTOFF", 1)
    monkeypatch.setattr(dense, "HOST_CUTOFF", 1)
    rows = np.arange(200) % 100
    cols = np.arange(200) % 50
    vals = np.ones(200, np.int64)
    S = sp.csr_matrix((vals, (rows, cols)), shape=(100, 50))
    U, c, v = port_ech._fused_device_finish(
        F, S, np.arange(50), 128, 128, torch.device("cpu"))
    assert U[0].shape == (51,) and len(c) == 50
    got = port_ech._fused_device_finish(
        F, S * 0, np.arange(50), 128, 128, torch.device("cpu"))
    assert got is None and calls["port"] == 2


# ---- the mesh helpers default to the card


@pytest.mark.parametrize("helper", ["global_mesh", "make_mesh",
                                    "initialize"])
def test_mesh_helpers_need_a_card_by_default(helper):
    import torch.distributed as dist

    from spasm_tpu_torch.parallel import multihost, sharded

    if torch.cuda.is_available():
        pytest.skip("a card is present: the CUDA default runs")
    call = {"global_mesh": lambda: multihost.global_mesh(),
            "make_mesh": lambda: sharded.make_mesh(),
            "initialize": lambda: multihost.initialize(
                "localhost:1", num_processes=2, process_id=0)}[helper]
    with pytest.raises(RuntimeError, match="card"):
        call()
    assert not dist.is_initialized()
