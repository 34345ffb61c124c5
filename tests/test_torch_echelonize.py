"""The port's echelonize (spasm_tpu_torch, device="cpu") against the JAX
package's spasm_tpu.echelonize on the CPU, for the slice as a whole: the
two LU factorizations, read through interop.lu_arrays, are equal array for
array (rank, qinv, p, piv_cols, U, L, lp_order, dense_piv_start).  GF(p)
arithmetic is exact, so the tolerance is 0."""

import importlib
import re

import numpy as np
import pytest
import torch

import spasm_tpu as st
from spasm_tpu import SparseGFp, field
from spasm_tpu import fixtures as fx
from spasm_tpu.ops import dense as ref_dense

import spasm_tpu_torch as stt
from spasm_tpu_torch import interop
from spasm_tpu_torch.ops import dense as port_dense

ref_ech = importlib.import_module("spasm_tpu.echelonize")
port_ech = importlib.import_module("spasm_tpu_torch.echelonize")
F = field(42013)


def _untimed(line):
    return re.sub(r"\d+\.\d+s", "", line)


def run_both(A, logs=False, same_logs=True, **kw):
    """Echelonize A in both packages; assert equal LUs (and logs) and
    return the port's arrays (and the reference's and the port's log lines
    with ``logs``)."""
    from spasm_tpu.utils import logging as ref_log
    from spasm_tpu_torch._host.utils import logging as port_log

    ref_lines, port_lines = [], []
    ref_log.set_log(ref_lines.append)
    port_log.set_log(port_lines.append)
    try:
        want = interop.lu_arrays(st.echelonize(A, verbose=True, **kw))
        got = interop.lu_arrays(stt.echelonize(
            interop.sparse_from_reference(A), verbose=True, device="cpu",
            **kw))
    finally:
        ref_log.set_log(None)
        port_log.set_log(None)
    assert set(got) == set(want)
    for k in want:
        np.testing.assert_array_equal(got[k], want[k], k)
    if same_logs:  # the logs agree up to the walls they print
        assert ([_untimed(s) for s in port_lines]
                == [_untimed(s) for s in ref_lines])
    return (got, ref_lines, port_lines) if logs else got


@pytest.mark.parametrize("n,k", [(8, 3), (10, 4), (12, 5)])
def test_simplex_boundary(n, k):
    got = run_both(fx.simplex_boundary(n, k))
    assert got["r"] == fx.expected_boundary_rank(n, k)


@pytest.mark.parametrize("shape,density", [((120, 100), 0.05),
                                           ((200, 150), 0.02),
                                           ((400, 60), 0.1),
                                           ((60, 300), 0.08)])
def test_random(shape, density, rng):
    run_both(SparseGFp.rand(F, *shape, density, rng))


@pytest.mark.parametrize("case", ["subcomplex", "zipf", "mixed"])
def test_irregular_fixtures(case):
    A = {"subcomplex": lambda: fx.subcomplex_boundary(11, 4, keep=0.8),
         "zipf": lambda: fx.zipf_sparse(F, 300, 260, mean_nnz=6.0, seed=3),
         "mixed": lambda: fx.mixed_block_matrix(F, seed=1)}[case]()
    assert run_both(A)["r"] > 0


def test_round0_dense_switch(rng, monkeypatch):
    # on an accelerator (patched on both sides) the round loop switches to
    # the dense finish at device_sparsity_threshold
    monkeypatch.setattr(ref_ech, "_on_accelerator", lambda: True)
    monkeypatch.setattr(port_ech, "_on_accelerator", lambda device: True)
    A = SparseGFp.rand(F, 300, 300, 0.02, rng)
    _, lines, _ = run_both(A, logs=True, sparsity_threshold=0.9,
                           device_sparsity_threshold=1e-9, max_round=3)
    assert any("too dense" in s for s in lines)


def test_device_mode_finish(rng, monkeypatch):
    # the dense finish's device-mode block loop (the reference's fused
    # single-dispatch finish), forced at a small size; blocks of 128 rows
    # are the reference's bucketed block height too
    monkeypatch.setattr(ref_dense, "HOST_CUTOFF", 1)
    monkeypatch.setattr(port_dense, "HOST_CUTOFF", 1)
    A = SparseGFp.rand(F, 300, 200, 0.06, rng)
    _, lines, _ = run_both(A, logs=True, max_round=0, dense_block_size=128)
    assert any(s.endswith("(device)") for s in lines)


def test_device_mode_finish_chunked_back_elimination(rng, monkeypatch):
    # the device-mode streaming block loop (which a 64802^2 finish on the
    # card takes: it is over FUSED_BUDGET; the budget is set to 0 here, and
    # the reference streams as well) with the back-elimination of the
    # accumulated panel split into row chunks (one row a chunk here, as
    # that finish splits it): the same LU as the reference
    monkeypatch.setattr(ref_dense, "HOST_CUTOFF", 1)
    monkeypatch.setattr(port_dense, "HOST_CUTOFF", 1)
    monkeypatch.setattr(ref_dense, "FUSED_BUDGET", 0)
    monkeypatch.setattr(port_dense, "FUSED_BUDGET", 0)
    monkeypatch.setattr(port_dense, "SUB_CHUNK", 64)
    calls = []
    real = port_dense.modmatmul

    def counting(f, a, b, **kw):
        calls.append(a.shape[0])
        return real(f, a, b, **kw)

    monkeypatch.setattr(port_dense, "modmatmul", counting)
    A = SparseGFp.rand(F, 300, 200, 0.06, rng)
    _, lines, _ = run_both(A, logs=True, max_round=0, dense_block_size=128)
    assert any(s.endswith("(device)") for s in lines)
    assert calls.count(1) >= 128


def _tall_low_rank(p, rng):
    """A 900 x 60 product of random 900 x 20 and 20 x 60 factors: rank at
    most 20."""
    import scipy.sparse as sp

    X = sp.random(900, 20, density=0.3, random_state=rng,
                  data_rvs=lambda k: rng.integers(1, 1000, k), dtype=np.int64)
    Y = sp.random(20, 60, density=0.3, random_state=rng,
                  data_rvs=lambda k: rng.integers(1, 1000, k), dtype=np.int64)
    return SparseGFp.from_scipy((X @ Y).tocsr(), p)


def test_device_mode_low_rank_tail(rng, monkeypatch):
    # tall and low-rank: the block loop with per-block rank readbacks and
    # the randomized tail check.  The reference reads each block's rank
    # one block late (to hide link latency), so it runs its check after
    # one more block than the port; the LU is the same.
    monkeypatch.setattr(ref_dense, "HOST_CUTOFF", 1)
    monkeypatch.setattr(port_dense, "HOST_CUTOFF", 1)
    A = _tall_low_rank(F.p, rng)
    got, ref_lines, port_lines = run_both(
        A, logs=True, same_logs=False, max_round=0, dense_block_size=128)

    def remaining(lines):
        hits = [re.search(r"remaining (\d+) rows dependent", s)
                for s in lines]
        return [int(h.group(1)) for h in hits if h]

    assert remaining(port_lines) == [r + 128 for r in remaining(ref_lines)]
    assert len(remaining(port_lines)) == 1
    assert got["r"] <= 20


@pytest.mark.parametrize("case", ["boundary", "dense_corner"])
def test_L_factor(case, rng):
    A = (fx.simplex_boundary(10, 4) if case == "boundary"
         else SparseGFp.rand(F, 300, 320, 0.012, rng))
    got = run_both(A, L=True)
    assert "L_data" in got and "lp_order" in got


@pytest.mark.parametrize("p", [2147483629, 4294967291])
@pytest.mark.parametrize("case", ["boundary", "random"])
def test_large_primes(p, case, rng):
    # tier B and tier C primes, below the big-prime host cutoff: the
    # reference's dense finish runs its NumPy host loop, the port's its
    # streaming loop on CPU tensors
    A = (fx.simplex_boundary(9, 3, p) if case == "boundary"
         else SparseGFp.rand(field(p), 150, 120, 0.05, rng))
    run_both(A)
    run_both(A, L=True)


def _host_sized_case(p, shape, rng):
    f = field(p)
    if shape == "square":     # full rank, dense: the finish at round 0
        return SparseGFp.rand(f, 200, 200, 0.3, rng), {}
    if shape == "L":
        return SparseGFp.rand(f, 200, 150, 0.3, rng), dict(L=True)
    # the tail check skips the rows after the first dry block
    return _tall_low_rank(p, rng), dict(max_round=0, dense_block_size=128)


@pytest.mark.parametrize("shape", ["square", "tall_low_rank", "L"])
@pytest.mark.parametrize("p", [42013, 2147483629, 4294967291])
def test_host_sized_finish_matches_reference(p, shape, rng):
    # a dense finish under host_cutoff_for(f) elements a block, at the
    # default cutoffs: the port's streaming loop on CPU tensors against the
    # reference's NumPy host loop, the same LU; it counts its blocks, and
    # no device time
    A, kw = _host_sized_case(p, shape, rng)
    got, _, lines = run_both(A, logs=True, **kw)
    stats = stt.last_phase_stats()
    assert any(s.endswith("(host)") for s in lines)
    assert stats["finish_blocks"] >= 1 and stats["rref_groups_run"] >= 1
    assert stats["finish_streamed"] == 0 and stats["device_s"] == 0
    if shape == "square":
        assert got["r"] == 200
    if shape == "tall_low_rank":
        assert got["r"] <= 20 and stats["finish_rows_skipped"] > 0
    if shape == "L":
        assert "L_data" in got


@pytest.mark.parametrize("crash", [False, True])
def test_host_sized_finish_runs_on_one_thread(crash, rng, monkeypatch):
    # the streaming loop on CPU tensors runs on one torch thread, and the
    # caller's thread count comes back after it, also when a step raises
    real = port_dense.blocked_finish_step
    seen = []

    def step(*a, **kw):
        seen.append(torch.get_num_threads())
        if crash and len(seen) == 2:
            raise RuntimeError("simulated fault")
        return real(*a, **kw)

    monkeypatch.setattr(port_dense, "blocked_finish_step", step)
    A = stt.SparseGFp.rand(stt.field(F.p), 300, 200, 0.3, rng)
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    try:
        if crash:
            with pytest.raises(RuntimeError, match="simulated fault"):
                stt.echelonize(A, device="cpu", dense_block_size=128)
        else:
            assert stt.echelonize(A, device="cpu",
                                  dense_block_size=128).rank == 200
        assert torch.get_num_threads() == 2
    finally:
        torch.set_num_threads(n)
    assert seen == [1, 1]


def test_rank_and_interop(rng):
    A = SparseGFp.rand(F, 80, 90, 0.05, rng)
    B = interop.sparse_from_reference(A)
    assert isinstance(B, stt.SparseGFp) and B.shape == A.shape
    for name in ("indptr", "indices", "data"):
        np.testing.assert_array_equal(getattr(B, name), getattr(A, name))
    C = interop.sparse_from_arrays(A.field.p, A.shape, A.indptr, A.indices,
                                   A.data)
    assert C == B
    assert stt.rank(B, device="cpu") == st.rank(A)
    fact = stt.echelonize(B, device="cpu")
    assert stt.rank(fact) == fact.r == st.rank(A)


@pytest.mark.parametrize("kw", [dict(checkpoint="x"), dict(resume="x"),
                                dict(mesh=object()), "--num-devices"])
def test_deferred_features_raise(kw, tmp_path, capsys):
    """The four options that raised NotImplementedError until they were
    ported (the test keeps its name): each now runs on the CPU and gives
    the reference's result."""
    from spasm_tpu_torch.parallel import multihost

    A = SparseGFp.rand(F, 60, 50, 0.08, np.random.default_rng(3))
    B = interop.sparse_from_reference(A)
    want = interop.lu_arrays(st.echelonize(A))
    path = str(tmp_path / "x")
    if kw == "--num-devices":   # the CLI's mesh flag, one rank
        from spasm_tpu_torch.cli.main import main

        stt.save_sms(B, path)
        try:
            assert main(["rank", "--device", "cpu", "--num-devices", "1",
                         path]) == 0
        finally:
            stt.set_log(None)
            torch.distributed.destroy_process_group()
        assert f"rank = {want['r']}\n" in capsys.readouterr().err
        return
    kw = dict(kw)
    if "checkpoint" in kw:
        kw["checkpoint"] = path
    if "resume" in kw:
        stt.echelonize(B, device="cpu", checkpoint=path, max_round=1)
        kw["resume"] = path
    if "mesh" in kw:
        kw["mesh"] = multihost.global_mesh(device_type="cpu")
    try:
        got = interop.lu_arrays(stt.echelonize(B, device="cpu", **kw))
    finally:
        if "mesh" in kw:
            torch.distributed.destroy_process_group()
    if "checkpoint" in kw:
        from spasm_tpu_torch import checkpoint as port_ckpt

        assert port_ckpt.load_state(path)["field_p"] == F.p
    if "mesh" in kw:
        # a mesh takes the device sparse rounds, which keep the unreduced
        # U blocks: the LU of device_sparse_min_nnz=1 on one device
        want = interop.lu_arrays(
            stt.echelonize(B, device="cpu", device_sparse_min_nnz=1))
    for k in want:
        np.testing.assert_array_equal(got[k], want[k], k)


def test_cuda_device_needs_a_card():
    if torch.cuda.is_available():
        pytest.skip("a card is present: device='cuda' runs")
    A = stt.SparseGFp.from_dense([[1, 2], [3, 4]], 42013)
    with pytest.raises((RuntimeError, AssertionError)):
        stt.rank(A)


# round 0 of each breaks mutual_reduce's fill cap (a seeded scan at this
# size): the device waves' first capacity overflows, and their retry at 4x
# fits (zipf) or overflows too (random), when the host waves take the round
WAVE_CASES = {
    "retry_fits": (lambda: fx.zipf_sparse(F, 2000, 2000, 16.0, 2.0, 1),
                   [False, True]),
    "retry_overflows": (lambda: SparseGFp.rand(
        F, 2000, 2000, 0.006, np.random.default_rng(0)), [False, False]),
}


@pytest.mark.parametrize("case", sorted(WAVE_CASES))
def test_device_sparse_waves(case, monkeypatch):
    # with device_sparse_min_nnz both packages take the same branches and
    # give the same LU and the same log; the port's host waves run only
    # after the device waves returned None twice
    from spasm_tpu_torch.ops import sparse_device as port_sd

    make, outcomes = WAVE_CASES[case]
    real_device, real_host = port_sd.eliminate_device, port_ech.wave_eliminate
    calls = []

    def device_spy(*a, **kw):
        out = real_device(*a, **kw)
        calls.append(out is not None)
        return out

    def host_spy(*a, **kw):
        calls.append("host")
        return real_host(*a, **kw)

    monkeypatch.setattr(port_sd, "eliminate_device", device_spy)
    monkeypatch.setattr(port_ech, "wave_eliminate", host_spy)
    got, _, port_lines = run_both(make(), logs=True,
                                  device_sparse_min_nnz=1)
    assert calls == outcomes + (["host"] if not outcomes[-1] else [])
    i = port_lines.index("[schur/device] one-pass unavailable; wave fallback")
    assert port_lines[i + 1] == ("[schur/device] capacity overflow; "
                                 "retrying at 4x cap")
    assert got["r"] > 0
