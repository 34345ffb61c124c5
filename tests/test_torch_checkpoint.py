"""Checkpoint / resume of the port (spasm_tpu_torch, device="cpu") against
the JAX package: the cases of tests/test_checkpoint.py, checkpoints that
move between the two packages (the same file format), and the two faults
of the reference that the port leaves out on purpose (a sidecar that does
not load is ignored; both sidecars are deleted once the finish is done).
Every comparison of factorizations is array for array through
interop.lu_arrays: GF(p) arithmetic is exact, so the tolerance is 0."""

import importlib
import os

import numpy as np
import pytest
import torch

import spasm_tpu as st
from spasm_tpu import SparseGFp, field
from spasm_tpu.ops import dense as ref_dense

import spasm_tpu_torch as stt
from spasm_tpu_torch import checkpoint as port_ckpt
from spasm_tpu_torch import interop
from spasm_tpu_torch.ops import dense as port_dense

ref_ech = importlib.import_module("spasm_tpu.echelonize")
port_ech = importlib.import_module("spasm_tpu_torch.echelonize")
F = field(42013)


@pytest.fixture(autouse=True)
def one_torch_thread():
    """The device loop on CPU tensors is thousands of small ops: with the
    test workers sharing the cores, a thread pool a worker made them many
    times slower."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def assert_same_lu(got, want):
    got, want = interop.lu_arrays(got), interop.lu_arrays(want)
    assert set(got) == set(want)
    for k in want:
        np.testing.assert_array_equal(got[k], want[k], k)


def port(A, **kw):
    return stt.echelonize(interop.sparse_from_reference(A), device="cpu",
                          **kw)


def test_checkpoint_resume_equivalence(rng, tmp_path):
    A = SparseGFp.rand(F, 400, 400, 0.01, rng)   # sparse: does rounds
    path = str(tmp_path / "state.npz")
    full = port(A, checkpoint=path, max_round=3)
    assert os.path.exists(path)
    resumed = port(A, resume=path, max_round=3)
    assert_same_lu(resumed, full)
    assert_same_lu(full, st.echelonize(A, max_round=3))


def test_checkpoint_resume_midway(rng, tmp_path):
    A = SparseGFp.rand(F, 400, 400, 0.01, rng)
    path = str(tmp_path / "r1.npz")
    port(A, checkpoint=path, max_round=1)
    assert_same_lu(port(A, resume=path, max_round=3),
                   st.echelonize(A, max_round=3))


def test_checkpoint_wrong_prime(rng, tmp_path):
    A = SparseGFp.rand(F, 20, 20, 0.2, rng)
    path = str(tmp_path / "s.npz")
    port(A, checkpoint=path, max_round=1)
    B = SparseGFp.rand(field(65537), 20, 20, 0.2, rng)
    with pytest.raises(ValueError, match="prime"):
        port(B, resume=path)


def test_checkpoint_with_L(rng, tmp_path):
    A = SparseGFp.rand(F, 400, 400, 0.01, rng)
    path = str(tmp_path / "l.npz")
    port(A, checkpoint=path, L=True, max_round=2)
    fact = port(A, resume=path, L=True, max_round=2)
    # the reduced-round slot segments (lp_order) survive the resume
    assert_same_lu(fact, st.echelonize(A, L=True, max_round=2))
    assert fact.L @ fact.U == interop.sparse_from_reference(A)
    x0 = F.rand(A.n, rng)
    b = F.normalize(x0 @ A.to_dense().astype(np.int64))
    x = stt.solve(fact, b)
    np.testing.assert_array_equal(
        F.normalize(x @ A.to_dense().astype(np.int64)), b)


def _crash_on_call(monkeypatch, module, name, n):
    """Make module.name raise on its n-th call."""
    real = getattr(module, name)
    calls = {"n": 0}

    def failing(*a, **kw):
        calls["n"] += 1
        if calls["n"] == n:
            raise RuntimeError("simulated preemption")
        return real(*a, **kw)

    monkeypatch.setattr(module, name, failing)
    return real


def test_dense_finish_checkpoint_resume(rng, tmp_path, monkeypatch):
    """A finish under the cutoff (the streaming loop on CPU tensors):
    killed mid-finish, resumed from the sidecar without redoing the
    finished blocks, the same LU."""
    A = SparseGFp.rand(F, 500, 400, 0.3, rng)   # dense: finish at round 0
    opts = dict(dense_block_size=64)
    want = st.echelonize(A, **opts)
    path = str(tmp_path / "dense.npz")
    monkeypatch.setattr(port_ech, "DENSE_CKPT_INTERVAL_S", 0.0)
    real = _crash_on_call(monkeypatch, port_dense, "blocked_finish_step", 4)
    with pytest.raises(RuntimeError, match="simulated preemption"):
        port(A, checkpoint=path, **opts)
    side = port_ckpt.load_dense_state(path + ".dense")
    assert side["b0"] == 3 * 128   # blocks of max(128, 64) rows
    calls = {"n": 0}

    def counting(*a, **kw):
        calls["n"] += 1
        return real(*a, **kw)

    monkeypatch.setattr(port_dense, "blocked_finish_step", counting)
    assert_same_lu(port(A, resume=path, **opts), want)
    assert calls["n"] == 1          # only the last block was redone
    assert not os.path.exists(path + ".dense")


def _device_loop(monkeypatch):
    """Take the streaming loop of a device-sized finish at small sizes
    (the reference's lever: FUSED_BUDGET = 0 stands for a finish over the
    budget; within it a checkpointed run takes the fused finish), saving
    the sidecar after every block."""
    monkeypatch.setattr(port_dense, "FUSED_BUDGET", 0)
    monkeypatch.setattr(port_dense, "HOST_CUTOFF", 1)
    monkeypatch.setattr(port_dense, "HOST_CUTOFF_BIGP", 1)
    monkeypatch.setattr(port_ech, "DENSE_CKPT_INTERVAL_S", 0.0)


def test_dense_finish_checkpoint_resume_device_loop(rng, tmp_path,
                                                    monkeypatch):
    _device_loop(monkeypatch)
    A = SparseGFp.rand(F, 400, 500, 0.3, rng)
    opts = dict(dense_block_size=64)
    want = st.echelonize(A, **opts)
    path = str(tmp_path / "dev.npz")
    real = _crash_on_call(monkeypatch, port_dense, "blocked_finish_step", 4)
    with pytest.raises(RuntimeError, match="simulated preemption"):
        port(A, checkpoint=path, **opts)
    side = port_ckpt.load_dense_state(path + ".dense")
    assert side["b0"] == 384 and len(side["piv_cols_loc"]) == 384
    monkeypatch.setattr(port_dense, "blocked_finish_step", real)
    assert_same_lu(port(A, resume=path, **opts), want)
    assert not os.path.exists(path + ".dense")


def test_checkpointed_fused_finish_writes_no_sidecar(rng, tmp_path,
                                                     monkeypatch):
    """Within FUSED_BUDGET a checkpointed run takes the fused finish, as
    the reference does: it writes the round checkpoint and no dense
    sidecar, and resume= from that checkpoint runs the fused finish again
    and gives the reference's LU (the fused loop's blocks are 256 rows,
    the streaming loop's would be 150)."""
    monkeypatch.setattr(port_dense, "HOST_CUTOFF", 1)
    monkeypatch.setattr(ref_dense, "HOST_CUTOFF", 1)
    monkeypatch.setattr(port_ech, "DENSE_CKPT_INTERVAL_S", 0.0)
    fused = []
    real = port_ech._fused_device_finish
    monkeypatch.setattr(port_ech, "_fused_device_finish",
                        lambda *a, **k: fused.append(1) or real(*a, **k))
    saves = []
    real_save = port_ckpt.save_dense_state
    monkeypatch.setattr(port_ckpt, "save_dense_state",
                        lambda *a, **k: saves.append(1) or real_save(*a, **k))
    A = SparseGFp.rand(F, 400, 300, 0.05, rng)
    opts = dict(max_round=0, dense_block_size=150)
    want = st.echelonize(A, **opts)
    path = str(tmp_path / "fused.npz")
    assert_same_lu(port(A, checkpoint=path, **opts), want)
    assert os.listdir(tmp_path) == ["fused.npz"]
    assert port_ckpt.load_state(path)["round_idx"] == 0
    assert_same_lu(port(A, resume=path, **opts), want)
    assert fused == [1, 1] and saves == []


def test_dense_finish_stale_sidecar_ignored(rng, tmp_path):
    """A sidecar of another matrix or finish is ignored, not resumed."""
    A = SparseGFp.rand(F, 300, 250, 0.3, rng)
    path = str(tmp_path / "stale.npz")
    port(A, checkpoint=path, dense_block_size=64)
    port_ckpt.save_dense_state(path + ".dense", field_p=F.p, r0=999,
                               s_nnz=1, n_s=1, na=1, b0=1,
                               Uh=np.zeros((1, 1), np.int64),
                               piv_cols_loc=[0], piv_rows_glob=[0],
                               dry_blocks=0)
    assert_same_lu(port(A, resume=path, dense_block_size=64),
                   st.echelonize(A, dense_block_size=64))


def test_save_load_lu_across_packages(tmp_path, rng):
    A = SparseGFp.rand(F, 120, 100, 0.05, rng)
    path = str(tmp_path / "fact.npz")
    port_ckpt.save_lu(path, port(A, L=True))
    assert_same_lu(st.load_lu(path), st.echelonize(A, L=True))


# ---- checkpoints that move between the packages


def test_reference_round_checkpoint_resumed_by_port(rng, tmp_path):
    A = SparseGFp.rand(F, 400, 400, 0.01, rng)
    path = str(tmp_path / "ref.npz")
    st.echelonize(A, checkpoint=path, max_round=1)
    assert_same_lu(port(A, resume=path, max_round=3),
                   st.echelonize(A, max_round=3))


def test_port_round_checkpoint_resumed_by_reference(rng, tmp_path):
    A = SparseGFp.rand(F, 400, 400, 0.01, rng)
    path = str(tmp_path / "port.npz")
    port(A, checkpoint=path, max_round=1)
    assert_same_lu(st.echelonize(A, resume=path, max_round=3),
                   st.echelonize(A, max_round=3))


def test_reference_streaming_sidecar_resumed_by_port_device_loop(
        rng, tmp_path, monkeypatch):
    """The reference's streaming device loop (FUSED_BUDGET=1) saves the
    sidecar, crashes, and the port's device loop finishes from it."""
    _device_loop(monkeypatch)
    monkeypatch.setattr(ref_dense, "HOST_CUTOFF", 1)
    monkeypatch.setattr(ref_dense, "HOST_CUTOFF_BIGP", 1)
    monkeypatch.setattr(ref_dense, "FUSED_BUDGET", 1)
    monkeypatch.setattr(ref_ech, "DENSE_CKPT_INTERVAL_S", 0.0)
    A = SparseGFp.rand(F, 400, 500, 0.3, rng)
    opts = dict(dense_block_size=64)
    want = st.echelonize(A, **opts)
    path = str(tmp_path / "ref_dev.npz")
    _crash_on_call(monkeypatch, ref_dense, "blocked_finish_step", 4)
    with pytest.raises(RuntimeError, match="simulated preemption"):
        st.echelonize(A, checkpoint=path, **opts)
    assert port_ckpt.load_dense_state(path + ".dense")["b0"] == 384
    assert_same_lu(port(A, resume=path, **opts), want)
    assert not os.path.exists(path + ".dense")


# ---- the reference's faults, left out on purpose


@pytest.mark.parametrize("bad", ["corrupt", "schema"])
def test_unloadable_sidecar_is_ignored(rng, tmp_path, monkeypatch, bad):
    """(a) A sidecar that does not load is logged and ignored: the finish
    starts at block 0 (the reference aborts the resume)."""
    _device_loop(monkeypatch)
    A = SparseGFp.rand(F, 400, 500, 0.3, rng)
    path = str(tmp_path / "a.npz")
    port(A, checkpoint=path, max_round=0)
    if bad == "corrupt":
        with open(path + ".dense", "wb") as fh:
            fh.write(b"PK\x03\x04 not a zip archive")
    else:
        port_ckpt.save_dense_state(path + ".dense", field_p=F.p, r0=0,
                                   s_nnz=A.nnz, n_s=A.n, na=A.m, b0=128,
                                   Uh=np.zeros((0, A.m), np.int64),
                                   piv_cols_loc=[], piv_rows_glob=[],
                                   dry_blocks=0)
        with np.load(path + ".dense") as z:
            payload = dict(z)
        payload["dense_schema"] = np.int64(99)
        with open(path + ".dense", "wb") as fh:
            np.savez_compressed(fh, **payload)
        with pytest.raises(ValueError, match="schema"):
            st.checkpoint.load_dense_state(path + ".dense")
    lines = []
    stt.set_log(lines.append)
    try:
        got = port(A, resume=path, verbose=True)
    finally:
        stt.set_log(None)
    assert any("does not load" in ln for ln in lines)
    assert_same_lu(got, st.echelonize(A))
    assert not os.path.exists(path + ".dense")


def test_resume_sidecar_deleted_after_gplu_finish(rng, tmp_path):
    """(b) The GPLU finish deletes the sidecar it was resumed with (the
    reference leaves it)."""
    A = SparseGFp.rand(F, 300, 250, 0.3, rng)
    path = str(tmp_path / "g.npz")
    port(A, checkpoint=path, max_round=0)
    port_ckpt.save_dense_state(path + ".dense", field_p=F.p, r0=0,
                               s_nnz=A.nnz, n_s=A.n, na=A.m, b0=128,
                               Uh=np.zeros((0, A.m), np.int64),
                               piv_cols_loc=[], piv_rows_glob=[],
                               dry_blocks=0)
    got = port(A, resume=path, enable_dense=False)
    assert not os.path.exists(path + ".dense")
    assert_same_lu(got, st.echelonize(A, enable_dense=False))


def test_both_sidecars_deleted_when_checkpoint_differs(rng, tmp_path,
                                                      monkeypatch):
    """(b) With checkpoint != resume the finish saves into the checkpoint's
    sidecar, and deletes it and the resume's once done (the reference
    deletes only the checkpoint's)."""
    A = SparseGFp.rand(F, 500, 400, 0.3, rng)
    opts = dict(dense_block_size=64)
    old, new = str(tmp_path / "old.npz"), str(tmp_path / "new.npz")
    monkeypatch.setattr(port_ech, "DENSE_CKPT_INTERVAL_S", 0.0)
    real = _crash_on_call(monkeypatch, port_dense, "blocked_finish_step", 3)
    with pytest.raises(RuntimeError, match="simulated preemption"):
        port(A, checkpoint=old, **opts)
    assert port_ckpt.load_dense_state(old + ".dense")["b0"] == 256
    saved = []
    real_save = port_ckpt.save_dense_state

    def recording(path, **kw):
        saved.append((path, kw["b0"]))
        return real_save(path, **kw)

    monkeypatch.setattr(port_dense, "blocked_finish_step", real)
    monkeypatch.setattr(port_ckpt, "save_dense_state", recording)
    got = port(A, checkpoint=new, resume=old, **opts)
    assert saved == [(new + ".dense", 384)]
    assert not os.path.exists(old + ".dense")
    assert not os.path.exists(new + ".dense")
    assert_same_lu(got, st.echelonize(A, **opts))
