"""The port's scale-out over torch.distributed (spasm_tpu_torch.parallel,
the mesh branch of the one-pass update, echelonize(mesh=), the CLI's
--num-devices) against the JAX package on the conftest's 8-device CPU mesh
and against the host pivot strategies.

The port's ranks are gloo processes on the CPU at world sizes 1, 2 and 3,
spawned from tests/torch_dist_workers.py (which imports no jax); every
result must equal the reference's with tolerance 0 (GF(p) arithmetic is
exact), on every rank."""

import os
import subprocess
import sys

import numpy as np
import pytest
import scipy.sparse as sp

import spasm_tpu as st
from spasm_tpu import SparseGFp, field
from spasm_tpu import elimination as E
from spasm_tpu.echelonize import _round_schur_estimate
from spasm_tpu.ops import sparse_device as ref_sparse_device
from spasm_tpu.ops import sparse_onepass as ref_onepass
from spasm_tpu.parallel import sharded as ref_sharded
from spasm_tpu.parallel import sparse_sharded as ref_sparse_sharded
from spasm_tpu.pivots import (find_structural_pivots, fl_col_pivots,
                              fl_row_pivots)

import spasm_tpu_torch as stt
from spasm_tpu_torch import interop
from spasm_tpu_torch.ops import sparse_device as port_sparse_device
from spasm_tpu_torch.parallel import multihost
import torch_dist_workers

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
F = field(42013)
WORLDS = (1, 2, 3)


def _arrays(A):
    return dict(p=A.field.p, shape=A.shape, indptr=np.asarray(A.indptr),
                indices=np.asarray(A.indices), data=np.asarray(A.data))


@pytest.fixture(scope="module")
def case(tmp_path_factory):
    """The inputs, as numpy arrays; the same for every world size."""
    rng = np.random.default_rng(21)
    elect = SparseGFp.rand(F, 101, 87, 0.06, rng)
    # masks of a partial selection: after the FL rows alone, every unused
    # row touches a selected column and FL-cols finds nothing
    cs = rng.random(87) < 0.15
    ru = rng.random(101) < 0.15
    A6, B6 = F.rand((40, 6), rng), F.rand((6, 32), rng)
    onepass = SparseGFp.rand(F, 400, 250, 0.05, rng)
    prows, pcols, _ = find_structural_pivots(onepass)
    _, S_rest, _, (Upart, _, levels) = _round_schur_estimate(
        F, onepass.to_scipy(), prows, pcols)
    Ustar, ok = E.mutual_reduce(F, Upart, pcols, levels)
    assert ok
    return dict(
        p=F.p, elect=_arrays(elect), elect_sparse=elect,
        col_selected=cs, row_used=ru,
        round_X=F.rand((48, 96), rng).astype(np.int32), round_panel=16,
        rank_cases=[(F.rand((48, 48), rng), 16),
                    (F.normalize(A6 @ B6), 8),
                    (np.zeros((16, 16), np.int64), 128)],
        onepass=(sp.csr_matrix(Ustar), pcols, sp.csr_matrix(S_rest)),
        # three rounds, then the dense finish
        echelon_sparse=SparseGFp.rand(F, 400, 400, 0.008,
                                      np.random.default_rng(21)),
        workdir=str(tmp_path_factory.mktemp("ranks")))


@pytest.fixture(scope="module")
def ranks(case):
    """world -> the port's per-rank results of the parallel suite; the
    three world sizes run at once, each once."""
    started, done = {}, {}
    for world in WORLDS:
        inputs = {k: v for k, v in case.items()
                  if k not in ("elect_sparse", "echelon_sparse")}
        inputs["echelon"] = _arrays(case["echelon_sparse"])
        inputs["ckpt_path"] = os.path.join(case["workdir"],
                                           f"ckpt_{world}.npz")
        started[world] = torch_dist_workers.Ranks(
            world, "parallel_suite", inputs, case["workdir"])

    def get(world):
        if world not in done:
            done[world] = started[world].results()
        return done[world]
    yield get
    for job in started.values():   # none outlives the module
        job.close()


@pytest.fixture(scope="module")
def mesh8():
    return ref_sharded.make_mesh(8)


@pytest.mark.parametrize("world", WORLDS)
def test_fl_election_matches_reference(ranks, case, mesh8, world):
    A = case["elect_sparse"]
    hr, hc = fl_row_pivots(A)
    jr, jc = ref_sparse_sharded.sharded_fl_election(F, mesh8, A)
    for out in ranks(world):
        got_r, got_c = out["fl"]
        for want_r, want_c in ((hr, hc), (jr, jc)):
            np.testing.assert_array_equal(got_r, want_r)
            np.testing.assert_array_equal(got_c, want_c)


@pytest.mark.parametrize("world", WORLDS)
def test_fl_col_election_matches_reference(ranks, case, mesh8, world):
    A = case["elect_sparse"]
    cs_h, ru_h = case["col_selected"].copy(), case["row_used"].copy()
    hr, hc = fl_col_pivots(A, cs_h, ru_h)
    cs_j, ru_j = case["col_selected"].copy(), case["row_used"].copy()
    jr, jc = ref_sparse_sharded.sharded_fl_col_election(F, mesh8, A, cs_j,
                                                        ru_j)
    np.testing.assert_array_equal(jr, hr)
    assert hr.size > 0
    for out in ranks(world):
        got_r, got_c = out["fl_cols"]
        np.testing.assert_array_equal(got_r, hr)
        np.testing.assert_array_equal(got_c, hc)
        np.testing.assert_array_equal(out["fl_cols_masks"][0], cs_h)
        np.testing.assert_array_equal(out["fl_cols_masks"][1], ru_h)


@pytest.fixture(scope="module")
def ref_round(case, mesh8):
    import jax
    from jax.sharding import NamedSharding, PartitionSpec as P

    Xd = jax.device_put(case["round_X"],
                        NamedSharding(mesh8, P("rows", None)))
    out = jax.jit(lambda x: ref_sharded.elimination_round(
        F, mesh8, x, panel=case["round_panel"]))(Xd)
    return tuple(np.asarray(t) for t in out)


@pytest.mark.parametrize("world", WORLDS)
def test_elimination_round_matches_reference(ranks, ref_round, world):
    X2, U, cols, valid, npiv = ref_round
    assert 0 < int(npiv) <= 16
    outs = ranks(world)
    got_X = np.concatenate([out["round"][0] for out in outs])
    np.testing.assert_array_equal(got_X, X2)
    for out in outs:
        _, gU, gcols, gvalid, gnpiv = out["round"]
        np.testing.assert_array_equal(gU, U)
        np.testing.assert_array_equal(gcols, cols)
        np.testing.assert_array_equal(gvalid, valid)
        assert int(gnpiv) == int(npiv)


@pytest.fixture(scope="module")
def ref_ranks(case, mesh8):
    return [ref_sharded.distributed_rank(F, mesh8, M, panel=pn)
            for M, pn in case["rank_cases"]]


@pytest.mark.parametrize("world", WORLDS)
def test_distributed_rank_matches_reference(ranks, ref_ranks, world):
    assert ref_ranks[1] == 6 and ref_ranks[2] == 0
    for out in ranks(world):
        assert out["ranks"] == ref_ranks


@pytest.fixture(scope="module")
def ref_onepass_mesh(case, mesh8):
    """The reference's mesh one-pass and the host kernel on the case."""
    Ustar, pcols, B = case["onepass"]
    want = ref_onepass.eliminate_onepass_device(F, Ustar, pcols, B,
                                                min_class_rows=0, mesh=mesh8)
    Dh, _ = E.eliminate_against_reduced(F, Ustar, pcols, B,
                                        assume_canonical=True)
    Dh = sp.csr_matrix(Dh)
    Dh.eliminate_zeros()
    Dh.sort_indices()
    return want, Dh


@pytest.mark.parametrize("world", WORLDS)
def test_onepass_mesh_matches_reference(ranks, ref_onepass_mesh, world):
    for out in ranks(world):
        for D in ref_onepass_mesh:
            for got, w in zip(out["onepass"], (D.indptr, D.indices, D.data)):
                np.testing.assert_array_equal(got, w)
        assert out["onepass_stats"]["classes"] > 0
        assert out["onepass_stats"]["device_calls"] > 0


@pytest.fixture(scope="module")
def ref_echelon(case, mesh8):
    """The reference's mesh LU, and the port's on one device with the
    device sparse rounds (which keep the same unreduced U blocks)."""
    A = case["echelon_sparse"]
    return (interop.lu_arrays(st.echelonize(A, mesh=mesh8)),
            interop.lu_arrays(stt.echelonize(
                interop.sparse_from_reference(A), device="cpu",
                device_sparse_min_nnz=1)))


@pytest.mark.parametrize("world", WORLDS)
def test_echelonize_mesh_matches_reference(ranks, ref_echelon, world):
    want, single = ref_echelon
    for out in ranks(world):
        got = out["echelon"]
        assert set(got) == set(want) == set(single)
        for k in want:
            np.testing.assert_array_equal(got[k], want[k], k)
            np.testing.assert_array_equal(got[k], single[k], k)


@pytest.mark.parametrize("world", WORLDS)
def test_mesh_checkpoint_written_by_rank0(ranks, world):
    outs = ranks(world)
    assert outs[0]["ckpt_saves"] == [0, 1]   # the initial and round 1
    assert all(out["ckpt_saves"] == [] for out in outs[1:])
    for out in outs:
        for k, v in outs[0]["echelon"].items():
            np.testing.assert_array_equal(out["resumed"][k], v, k)


@pytest.mark.parametrize("world", WORLDS)
def test_host_local_rows(ranks, world):
    per = -(-103 // world)
    assert [tuple(out["local_rows"]) for out in ranks(world)] == [
        (r * per, min((r + 1) * per, 103)) for r in range(world)]


@pytest.fixture(scope="module")
def waves_case():
    """Two round blocks (U, pcols, levels, B) of the sort-based waves: a
    random matrix's round 0, and a block whose remaining rows are followed
    by twice as many empty ones (at world sizes 1-3 every entry lies in
    rank 0's shard) and overflow the single device's first capacity."""
    from test_torch_sparse_device import make_case

    rnd = make_case(F, np.random.default_rng(5), 120, 120, 0.1)
    U, pcols, levels, B = make_case(F, np.random.default_rng(0), 200, 200,
                                    0.05)
    Bs = B.to_scipy()
    B_pad = SparseGFp.from_scipy(
        sp.vstack([Bs, sp.csr_matrix((2 * B.n, B.m), dtype=Bs.dtype)]),
        F.p)
    return {"round": rnd, "skewed": (U, pcols, levels, B_pad)}


@pytest.fixture(scope="module")
def wave_ranks(waves_case, tmp_path_factory):
    """world -> the port's per-rank waves results; the ranks are killed
    and the test fails if they do not all return within 120 s (a rank
    left waiting in a collective hangs)."""
    workdir = str(tmp_path_factory.mktemp("waves"))
    inputs = {"p": F.p}
    for name, (U, pcols, levels, B) in waves_case.items():
        inputs[name] = (_arrays(U), pcols, levels, _arrays(B))
    started = {w: torch_dist_workers.Ranks(w, "waves_suite", inputs,
                                           workdir, timeout=120.0)
               for w in WORLDS}
    done = {}

    def get(world):
        if world not in done:
            done[world] = started[world].results()
        return done[world]
    yield get
    for job in started.values():
        job.close()


def _csr_of(D):
    return (np.asarray(D.indptr), np.asarray(D.indices), np.asarray(D.data))


@pytest.mark.parametrize("world", WORLDS)
def test_sharded_waves_match_single_device(wave_ranks, waves_case, mesh8,
                                           world):
    U, pcols, levels, B = waves_case["round"]
    single = ref_sparse_device.eliminate_device(F, U, pcols, levels, B,
                                                cap_factor=8)
    ref_mesh = ref_sparse_sharded.sharded_sparse_eliminate(
        F, mesh8, U, pcols, levels, B)
    assert single is not None and single == ref_mesh and single.nnz > 0
    port_single = port_sparse_device.eliminate_device(
        interop.sparse_from_reference(B).field,
        interop.sparse_from_reference(U), pcols, levels,
        interop.sparse_from_reference(B), cap_factor=8, device="cpu")
    for out in wave_ranks(world):
        for g, w, s in zip(out["round_8"], _csr_of(single),
                           _csr_of(port_single)):
            np.testing.assert_array_equal(g, w)
            np.testing.assert_array_equal(g, s)


@pytest.mark.parametrize("world", WORLDS)
def test_sharded_waves_overflow_on_one_rank_is_none_on_all(
        wave_ranks, waves_case, world):
    U, pcols, levels, B = waves_case["skewed"]
    assert ref_sparse_device.eliminate_device(F, U, pcols, levels,
                                              B) is None
    want = ref_sparse_device.eliminate_device(F, U, pcols, levels, B,
                                              cap_factor=16)
    outs = wave_ranks(world)
    assert len(outs) == world
    for out in outs:
        assert out["skewed_4"] is None
        for g, w in zip(out["skewed_16"], _csr_of(want)):
            np.testing.assert_array_equal(g, w)


def test_initialize_single_process_is_a_noop():
    import torch.distributed as dist

    assert multihost.initialize() == (1, 0)
    assert not dist.is_initialized()


def test_cli_num_devices_under_torchrun(case, tmp_path):
    A = case["echelon_sparse"]
    path = str(tmp_path / "a.sms")
    stt.save_sms(interop.sparse_from_reference(A), path)
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    out = subprocess.run(
        [sys.executable, "-m", "torch.distributed.run", "--standalone",
         "--nproc-per-node", "2", "-m", "spasm_tpu_torch.cli", "rank",
         "--device", "cpu", "--num-devices", "2", path],
        cwd=ROOT, env=env, capture_output=True, text=True, timeout=240)
    assert out.returncode == 0, out.stderr[-3000:]
    lines = [ln for ln in out.stderr.splitlines() if ln.startswith("rank =")]
    assert lines == [f"rank = {st.rank(A)}"]   # rank 0 alone prints


def test_cli_num_devices_needs_its_ranks(case, tmp_path):
    from spasm_tpu_torch.cli.main import main

    path = str(tmp_path / "a.sms")
    stt.save_sms(interop.sparse_from_reference(case["echelon_sparse"]),
                 path)
    with pytest.raises(SystemExit, match="torchrun --nproc-per-node 2"):
        main(["rank", "--device", "cpu", "--num-devices", "2", path])
