"""The port's CUDA kernels against their plain PyTorch versions on the card,
exactly (GF(p): tolerance 0).  Marked ``cuda`` and skipped without a card.

The machine with the card has no jax, and the suite's conftest imports it,
so there these tests run without it:

    python -m pytest --noconftest -q tests/test_torch_cuda.py
"""

import importlib

import numpy as np
import pytest
import torch

from spasm_tpu_torch import SparseGFp, echelonize, field, last_phase_stats
from spasm_tpu_torch._host.fixtures import (simplex_boundary,
                                            subcomplex_boundary)
from spasm_tpu_torch.interop import lu_arrays
from spasm_tpu_torch.ops import (cuda_matmul, cuda_merge, cuda_panel, dense,
                                 matmul, merge, sparse_onepass)
from torch_dead_groups import RUNS, dead_group_matrix

pytestmark = pytest.mark.cuda
PRIMES = [5, 42013, 92681, 2147483629, 4294967291]


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card (CUDA kernels have no CPU mode)")
    return torch.device("cuda")


def _rand(f, shape, seed, density=1.0):
    rng = np.random.default_rng(seed)
    x = f.rand(shape, rng).astype(np.int32)
    x[rng.random(shape) >= density] = 0
    return torch.from_numpy(x)


# the shapes rref_inplace and blocked_finish_step give K1 on the flagship,
# and n, k, m at 1 and at one past a tile multiple (128, 128, 128 or 32)
K1_SHAPES = [(130, 260, 140), (1000, 1000, 1024), (1, 5, 3),
             (1000, 128, 128), (512, 512, 512), (1000, 512, 8192),
             (1000, 1000, 8192), (1000, 7168, 8192), (7168, 1000, 8192),
             (1, 1, 1), (129, 260, 140), (130, 129, 140), (130, 260, 129),
             (130, 260, 33)]


@pytest.mark.parametrize("shape", K1_SHAPES)
@pytest.mark.parametrize("p", PRIMES)
def test_modmatmul_kernel_matches_plain(p, shape, card):
    f = field(p)
    n, k, m = shape
    a, b = _rand(f, (n, k), 1).to(card), _rand(f, (k, m), 2).to(card)
    before = cuda_matmul.launches, cuda_matmul.split_launches
    got = matmul.modmatmul(f, a, b)          # dispatches to the kernel
    assert cuda_matmul.launches == before[0] + 1
    assert cuda_matmul.split_launches == before[1] + 2
    want = matmul.modmatmul_plain(f, a, b)
    torch.cuda.synchronize()
    assert got.dtype == torch.int32 and torch.equal(got, want)


@pytest.mark.parametrize("p", PRIMES)
def test_modmatmul_kernel_strided_views(p, card):
    # a: a column window of a wider matrix (row stride > k, start not
    # 16-byte aligned); b: a transposed view (column stride != 1); the
    # split kernel byte for byte against its plain version, then the
    # product
    f = field(p)
    nl = cuda_matmul.num_limbs(p)
    n, k, m = 130, 260, 140
    a = _rand(f, (n, k + 7), 3).to(card)[:, 3:3 + k]
    b = _rand(f, (m, k), 4).to(card).T
    assert not a.is_contiguous() and b.stride(1) != 1
    np_, kp, mp = cuda_matmul.padded(n, k, m, nl)
    ap = cuda_matmul.split_cuda(a, nl, np_, kp)
    bp = cuda_matmul.split_cuda(b, nl, mp, kp, transpose=True)
    assert torch.equal(ap, cuda_matmul.pack_planes_plain(f, a, nl, np_, kp))
    assert torch.equal(bp, cuda_matmul.pack_planes_plain(f, b, nl, mp, kp,
                                                         transpose=True))
    want = matmul.modmatmul_plain(f, a, b)
    assert torch.equal(cuda_matmul.product_cuda(f, ap, bp, n, m), want)
    assert torch.equal(cuda_matmul.product_plain(f, ap, bp, n, m), want)
    assert torch.equal(cuda_matmul.modmatmul_cuda(f, a, b), want)


@pytest.mark.parametrize("n,k,m,p", [(40, 140_000, 48, 5),
                                     (40, 30_000, 48, 4294967291)])
def test_modmatmul_kernel_folds_inside_long_k(n, k, m, p, card):
    f = field(p)
    assert k > cuda_matmul.fold_interval(cuda_matmul.num_limbs(p))
    a, b = _rand(f, (n, k), 5).to(card), _rand(f, (k, m), 6).to(card)
    assert torch.equal(cuda_matmul.modmatmul_cuda(f, a, b),
                       matmul.modmatmul_plain(f, a, b))


def test_modmatmul_kernel_rejects_what_it_does_not_take(card):
    f = field(42013)
    a = torch.zeros((4, 8), dtype=torch.int32, device=card)
    b = torch.zeros((8, 3), dtype=torch.int32, device=card)
    before = cuda_matmul.launches, cuda_matmul.split_launches
    with pytest.raises(ValueError):
        cuda_matmul.modmatmul_cuda(f, a.cpu(), b)      # a CPU operand
    with pytest.raises(ValueError):
        cuda_matmul.modmatmul_cuda(f, a, b.cpu())
    with pytest.raises(TypeError):
        cuda_matmul.modmatmul_cuda(f, a.long(), b)     # not int32
    with pytest.raises(TypeError):
        cuda_matmul.modmatmul_cuda(f, a, b.to(torch.int8))
    with pytest.raises(ValueError):
        cuda_matmul.modmatmul_cuda(f, a, b[:5])        # inner sizes differ
    assert (cuda_matmul.launches, cuda_matmul.split_launches) == before
    # empty products launch nothing either
    assert cuda_matmul.modmatmul_cuda(f, a[:0], b).shape == (0, 3)
    z = cuda_matmul.modmatmul_cuda(f, a[:, :0], b[:0])
    assert z.shape == (4, 3) and not z.any()
    assert (cuda_matmul.launches, cuda_matmul.split_launches) == before


@pytest.mark.parametrize("n,c", [(1000, 128), (300, 37), (4096, 128),
                                 (192, 128), (5, 128), (1, 37)])
@pytest.mark.parametrize("cut", [False, True])
@pytest.mark.parametrize("p", PRIMES)
def test_panel_kernel_matches_plain(p, cut, n, c, card):
    # c = 37 takes the kernel's scalar (not int4) path; n = 4096 keeps the
    # rows in global memory; n = 5 and 1 leave CTAs of the cluster idle
    f = field(p)
    P = _rand(f, (n, c), 3, density=0.6)
    P[:, 7] = 0
    ispiv = torch.zeros(n, dtype=torch.bool)
    ispiv[::9] = True
    j0, npivcols = (384, 384 + (3 * c) // 4) if cut else (0, c)
    P, ispiv = P.to(card), ispiv.to(card)
    got = cuda_panel.panel_eliminate_cuda(f, npivcols, P, ispiv, j0)
    want = dense._panel_eliminate(f, P, ispiv, j0, npivcols)
    torch.cuda.synchronize()
    for g, w in zip(got, want):
        assert g.dtype == w.dtype and torch.equal(g, w)


@pytest.mark.parametrize("case", ["all_prepivoted", "no_column"])
def test_panel_kernel_finds_no_pivot(case, card):
    # every row pre-pivoted, or npivcols <= j0: no pivot, and the same
    # six outputs as the plain version
    f = field(42013)
    P = _rand(f, (1000, 128), 5, density=0.6).to(card)
    ispiv = torch.zeros(1000, dtype=torch.bool, device=card)
    isp, j0, npivcols = ((~ispiv, 0, 128) if case == "all_prepivoted"
                         else (ispiv, 256, 200))
    got = cuda_panel.panel_eliminate_cuda(f, npivcols, P, isp, j0)
    want = dense._panel_eliminate(f, P, isp, j0, npivcols)
    torch.cuda.synchronize()
    for g, w in zip(got, want):
        assert torch.equal(g, w)
    assert not bool(got[4].any())


def test_panel_kernel_rejects_what_it_does_not_take(card):
    f = field(42013)
    P = torch.zeros((4, 8), dtype=torch.int32, device=card)
    ispiv = torch.zeros(4, dtype=torch.bool, device=card)
    with pytest.raises(ValueError):
        cuda_panel.panel_eliminate_cuda(f, 8, P[:, :0], ispiv, 0)
    with pytest.raises(ValueError):
        cuda_panel.panel_eliminate_cuda(
            f, 5000, torch.zeros((4, 5000), dtype=torch.int32, device=card),
            ispiv, 0)
    with pytest.raises(TypeError):
        cuda_panel.panel_eliminate_cuda(f, 8, P.long(), ispiv, 0)


def test_rref_card_matches_cpu(card):
    f = field(42013)
    X = _rand(f, (600, 700), 4, density=0.5)
    X[400:] = X[:200] * 3 % f.p
    got = dense.rref(f, X.to(card), want_transform=True, host_cutoff=0)
    want = dense.rref(f, X, want_transform=True, host_cutoff=0)
    for k in want:
        assert np.array_equal(np.asarray(got[k]), np.asarray(want[k])), k


def test_echelonize_card_matches_cpu(card, monkeypatch):
    # the device-mode finish on both; the card's lower density gate off,
    # so both take the same round decisions
    monkeypatch.setattr(dense, "HOST_CUTOFF", 1)
    A = SparseGFp.rand(field(42013), 700, 400, 0.05,
                       np.random.default_rng(5))
    kw = dict(dense_block_size=256, device_sparsity_threshold=None)
    got = lu_arrays(echelonize(A, device=card, **kw))
    want = lu_arrays(echelonize(A, device="cpu", **kw))
    assert set(got) == set(want)
    for k in want:
        assert np.array_equal(got[k], want[k]), k


def _merge_tile(f, R, W, m, seed):
    """(R, W) int32 cols in [0, m] with dead slots (col == m, val 0) and
    frequent duplicates, plus an all-dead row, a row whose entries all
    cancel and a single-run row."""
    rng = np.random.default_rng(seed)
    cols = rng.integers(0, m, (R, W)).astype(np.int32)
    cols[rng.random((R, W)) < 0.3] = m
    vals = f.rand((R, W), rng).astype(np.int64)
    vals[cols == m] = 0
    cols[0], vals[0] = m, 0
    h = W // 2
    cols[1, h:2 * h] = cols[1, :h]
    vals[1, h:2 * h] = -vals[1, :h]
    cols[1, 2 * h:], vals[1, 2 * h:] = m, 0
    cols[2] = m // 2
    return torch.from_numpy(cols), torch.from_numpy(vals.astype(np.int32))


@pytest.mark.parametrize("W", [128, 512, 2048, 8192, 16384, 65536, 80, 1040,
                               40000, 1, 2, 3, 31, 32, 33, 272, 511, 513,
                               1024, 1025, 2049, 16385])
@pytest.mark.parametrize("p", PRIMES)
def test_merge_kernel_matches_plain(p, W, card):
    # the edges of the kernel's levels: 32 keys a lane from 64 slots on, a
    # row in one warp up to 32 E = 1024 slots, in one CTA up to 16384;
    # 16385, 65536 and 40000 take the global-memory variant; widths with
    # W % 16 != 0 take scalar accesses.  The plain version sorts by the same (col, val) key, so
    # all three outputs are bit-equal
    f = field(p)
    R, m = max(3, (1 << 19) // W), max(3, W // 3)
    cols, vals = _merge_tile(f, R, W, m, W + p % 97)
    cols, vals = cols.to(card), vals.to(card)
    before = cuda_merge.launches
    got = merge.merge_rows(f, cols, vals, m)     # dispatches to the kernel
    assert cuda_merge.launches == before + 1
    want = merge.merge_rows_plain(f, cols, vals, m)
    torch.cuda.synchronize()
    for g, w in zip(got, want):
        assert g.dtype == w.dtype and torch.equal(g, w)


@pytest.mark.parametrize("R,W", [(4099, 32), (1027, 272)])
def test_merge_kernel_d8_tiles(R, W, card):
    # d8's two tile widths at small R, with d8's p and m (1,562,275): rows
    # pack 16 to a warp at Wt 32, 2 at Wt 272 (padded to 512)
    f, m = field(42013), 1562275
    cols, vals = _merge_tile(f, R, W, m, W)
    cols, vals = cols.to(card), vals.to(card)
    want = merge.merge_rows_plain(f, cols, vals, m)
    # then from storage 4 bytes past a 16-byte boundary: scalar accesses
    off_c = torch.empty(R * W + 1, dtype=torch.int32, device=card)
    off_v = torch.empty_like(off_c)
    off_c[1:], off_v[1:] = cols.flatten(), vals.flatten()
    for c, v in ((cols, vals), (off_c[1:].view(R, W), off_v[1:].view(R, W))):
        got = cuda_merge.merge_rows_cuda(f, c, v, m)
        torch.cuda.synchronize()
        for g, w in zip(got, want):
            assert g.dtype == w.dtype and torch.equal(g, w)


@pytest.mark.parametrize("case", ["random", "boundary"])
def test_onepass_card_matches_cpu(case, card):
    from spasm_tpu_torch._host import elimination as E
    from spasm_tpu_torch._host.pivots import find_structural_pivots
    from spasm_tpu_torch.echelonize import _round_schur_estimate

    A = (SparseGFp.rand(field(42013), 3000, 3000, 7e-4,
                        np.random.default_rng(42)) if case == "random"
         else simplex_boundary(14, 5))
    f = A.field
    prows, pcols, _ = find_structural_pivots(A)
    _, S_rest, _, (Upart, _, levels) = _round_schur_estimate(
        f, A.to_scipy(), prows, pcols)
    Ustar, ok = E.mutual_reduce(f, Upart, pcols, levels)
    assert ok
    out = {}
    for dev in (card, "cpu"):
        stats = {}
        before = cuda_merge.launches
        D = sparse_onepass.eliminate_onepass_device(
            f, Ustar, pcols, S_rest, min_class_rows=0, device=dev,
            _stats=stats)
        out[str(dev)] = (D, stats, cuda_merge.launches - before)
    (Dg, sg, lg), (Dc, sc, lc) = out[str(card)], out["cpu"]
    assert lg == sg["device_calls"] > 0 and lc == 0
    assert all(sg[k] == sc[k] for k in ("classes", "chunks", "device_calls",
                                         "host_fallback_rows"))
    for name in ("indptr", "indices", "data"):
        assert np.array_equal(getattr(Dg, name), getattr(Dc, name)), name


def test_echelonize_device_sparse_card_matches_cpu(card):
    # simplex_boundary(16, 5) has a class of 2048+ rows: the card's round
    # goes through K3
    A = simplex_boundary(16, 5)
    before = cuda_merge.launches
    got = lu_arrays(echelonize(A, device=card, device_sparse_min_nnz=1))
    assert cuda_merge.launches > before
    want = lu_arrays(echelonize(A, device="cpu", device_sparse_min_nnz=1))
    assert set(got) == set(want)
    for k in want:
        assert np.array_equal(got[k], want[k]), k


@pytest.mark.parametrize("p", [42013, 2147483629, 4294967291])
def test_sparse_device_waves_card_matches_cpu(card, p):
    # the sort-based waves on the card against the same call on CPU
    # tensors: the same SparseGFp, and None at the same capacity
    from spasm_tpu_torch._host.elimination import compute_levels
    from spasm_tpu_torch._host.pivots import find_structural_pivots
    from spasm_tpu_torch.ops.sparse_device import eliminate_device

    f = field(p)
    A = SparseGFp.rand(f, 300, 300, 0.05, np.random.default_rng(1))
    prows, pcols, _ = find_structural_pivots(A)
    S = A.to_scipy()
    Up = S[prows].tocsr()
    scale = f.inv(np.asarray(Up[np.arange(prows.size), pcols]).ravel())
    Up.data = f.normalize(Up.data * np.repeat(scale, np.diff(Up.indptr)))
    U = SparseGFp.from_scipy(Up, p)
    levels = compute_levels(U, pcols)
    B = SparseGFp.from_scipy(S[np.setdiff1d(np.arange(300), prows)], p)
    for cf in (4, 16):
        got = eliminate_device(f, U, pcols, levels, B, cap_factor=cf,
                               device=card)
        want = eliminate_device(f, U, pcols, levels, B, cap_factor=cf,
                                device="cpu")
        assert (got is None) == (want is None)
        assert got is None or got == want


def _solve_case():
    # max_round=0: the whole matrix goes to the dense finish, so the corner
    # block is (1100, 1100), past the host cutoff: the tensor path; rank
    # 1100 < m, so random right-hand sides have no solution
    return SparseGFp.rand(field(42013), 1100, 1200, 0.06,
                          np.random.default_rng(3))


def test_solve_gesv_kernel_card_match_cpu(card):
    import spasm_tpu_torch as stt

    A = _solve_case()
    f = A.field
    rng = np.random.default_rng(4)
    b = A.xapy(f.rand(A.n, rng))
    B = (SparseGFp.rand(f, 6, A.n, 0.02, rng) @ A).vstack(
        SparseGFp.rand(f, 2, A.m, 0.5, rng))
    out = {}
    for dev in (card, "cpu"):
        fact = stt.echelonize(A, device=dev, L=True, max_round=0)
        assert fact.r - fact.dense_piv_start == 1100
        X, ok = stt.gesv(fact, B)
        out[str(dev)] = dict(
            lu=lu_arrays(fact), x=stt.solve(fact, b), X=X, ok=ok,
            K=stt.kernel(A, device=dev), R=stt.rref(fact)[0],
            cert=stt.certificate_rank_create(A, fact=fact))
    got, want = out[str(card)], out["cpu"]
    for k in want["lu"]:
        assert np.array_equal(got["lu"][k], want["lu"][k]), k
    assert np.array_equal(got["x"], want["x"])
    assert np.array_equal(A.xapy(got["x"]), b)
    assert got["X"] == want["X"] and np.array_equal(got["ok"], want["ok"])
    assert got["ok"][:6].all() and not got["ok"][6:].any()
    assert got["K"] == want["K"] and got["R"] == want["R"]
    for k in ("r", "i", "j", "x", "y"):
        assert np.array_equal(getattr(got["cert"], k),
                              getattr(want["cert"], k)), k


def test_first_solve_launches_k1_and_k2(card):
    import spasm_tpu_torch as stt

    A = _solve_case()
    fact = stt.echelonize(A, device=card, L=True, max_round=0)
    assert fact._device == "cuda"
    b = A.xapy(A.field.rand(A.n, np.random.default_rng(5)))
    counts = []
    for _ in range(2):
        before = cuda_matmul.launches, cuda_panel.launches
        x = stt.solve(fact, b)
        counts.append((cuda_matmul.launches - before[0],
                       cuda_panel.launches - before[1]))
        assert np.array_equal(A.xapy(x), b)
    # the corner-block inverse runs in the first solve; the second reads
    # it from the LU
    assert counts[0][0] > 0 and counts[0][1] > 0
    assert counts[1] == (0, 0)


def test_load_lu_solves_on_the_card(card, tmp_path):
    import spasm_tpu_torch as stt

    A = _solve_case()
    fact = stt.echelonize(A, device="cpu", L=True, max_round=0)
    stt.save_lu(str(tmp_path / "lu.npz"), fact)
    loaded = stt.load_lu(str(tmp_path / "lu.npz"), device=card)
    b = A.xapy(A.field.rand(A.n, np.random.default_rng(6)))
    before = cuda_panel.launches
    assert np.array_equal(stt.solve(loaded, b), stt.solve(fact, b))
    assert cuda_panel.launches > before


# ---- checkpoint / resume, the mesh, SpMV on the card


@pytest.mark.parametrize("p", [42013, 4294967291])
def test_spmv_card_matches_cpu(p, card):
    from spasm_tpu_torch.ops import spmv

    f = field(p)
    rng = np.random.default_rng(17)
    A = SparseGFp.rand(f, 3000, 2000, 0.01, rng)
    for op, n_in, n_out in (("xapy", A.n, A.m), ("axpy", A.m, A.n)):
        x, y = f.rand(n_in, rng), f.rand(n_out, rng)
        got, want = (getattr(spmv, op)(spmv.DeviceCOO.from_csr(A, device=d),
                                       x, y) for d in (card, "cpu"))
        assert got.is_cuda and torch.equal(got.cpu(), want)


def test_dense_finish_resumes_on_the_card(card, tmp_path, monkeypatch):
    # the streaming device loop (FUSED_BUDGET = 0: a finish over the
    # budget) saves its sidecar after every block, is stopped at its
    # fourth block, and the resumed LU is the uninterrupted one (and the
    # CPU's)
    import importlib
    import os

    ech = importlib.import_module("spasm_tpu_torch.echelonize")
    monkeypatch.setattr(dense, "FUSED_BUDGET", 0)
    monkeypatch.setattr(dense, "HOST_CUTOFF", 1)
    monkeypatch.setattr(ech, "DENSE_CKPT_INTERVAL_S", 0.0)
    A = SparseGFp.rand(field(42013), 900, 1200, 0.2,
                       np.random.default_rng(18))
    kw = dict(dense_block_size=200)
    want = lu_arrays(echelonize(A, device=card, **kw))
    path = str(tmp_path / "card.npz")
    real = dense.blocked_finish_step
    calls = []

    def stopping(*a, **k):
        calls.append(1)
        if len(calls) == 4:
            raise RuntimeError("stopped")
        return real(*a, **k)

    monkeypatch.setattr(dense, "blocked_finish_step", stopping)
    with pytest.raises(RuntimeError, match="stopped"):
        echelonize(A, device=card, checkpoint=path, **kw)
    monkeypatch.setattr(dense, "blocked_finish_step", real)
    got = lu_arrays(echelonize(A, device=card, resume=path, **kw))
    cpu = lu_arrays(echelonize(A, device="cpu", **kw))
    assert not os.path.exists(path + ".dense")
    for k in want:
        assert np.array_equal(got[k], want[k]), k
        assert np.array_equal(cpu[k], want[k]), k


def test_checkpointed_finish_is_fused_on_the_card(card, tmp_path):
    # within FUSED_BUDGET a checkpointed run takes the fused finish, as
    # the reference does: the round checkpoint and no sidecar, and the
    # LU of the run without checkpoint=
    import os

    A = SparseGFp.rand(field(42013), 900, 1200, 0.2,
                       np.random.default_rng(18))
    dense.release_finish_graphs()
    try:
        want = lu_arrays(echelonize(A, device=card))
        dense.last_finish.clear()
        path = str(tmp_path / "card.npz")
        got = lu_arrays(echelonize(A, device=card, checkpoint=path))
        assert dense.last_finish["graph"] == "captured"
    finally:
        dense.release_finish_graphs()
    assert os.listdir(tmp_path) == ["card.npz"]
    for k in want:
        assert np.array_equal(got[k], want[k]), k


def test_mesh_of_one_rank_on_the_card(card):
    # a one-process NCCL group: echelonize(mesh=) runs K3 on its class
    # tiles and equals the single-device LU; distributed_rank runs K1
    import torch.distributed as dist

    from spasm_tpu_torch import rank
    from spasm_tpu_torch.parallel import sharded

    dist.init_process_group("nccl", store=dist.HashStore(), rank=0,
                            world_size=1)
    try:
        mesh = sharded.make_mesh(1, device_type="cuda")
        A = simplex_boundary(16, 5)
        before = cuda_merge.launches
        got = lu_arrays(echelonize(A, mesh=mesh, device="cuda"))
        assert cuda_merge.launches > before
        f = field(42013)
        X = f.rand((300, 260), np.random.default_rng(19))
        X[200:] = 0
        before = cuda_matmul.launches
        r = sharded.distributed_rank(f, mesh, X, panel=32)
        assert cuda_matmul.launches > before
    finally:
        dist.destroy_process_group()
    want = lu_arrays(echelonize(A, device=card, device_sparse_min_nnz=1))
    for k in want:
        assert np.array_equal(got[k], want[k]), k
    assert r == rank(SparseGFp.from_dense(X, f.p), device="cpu") == 200


# ---- the fused finish: run flags, the captured graph, no host sync


@pytest.mark.parametrize("p", [42013, 2147483629, 4294967291])
@pytest.mark.parametrize("run", [False, True])
def test_modmatmul_kernel_out_and_run_flag(p, run, card):
    # out += a @ b mod p in place where the device flag holds; out left as
    # it is (all three kernels return at once) where it does not
    f = field(p)
    a, b = _rand(f, (1000, 512), 6).to(card), _rand(f, (512, 700), 7).to(card)
    c = _rand(f, (1000, 700), 8).to(card)
    out = c.clone()
    before = cuda_matmul.launches
    got = cuda_matmul.modmatmul_cuda(f, a, b, out=out,
                                     run=torch.tensor(run, device=card))
    assert got is out and cuda_matmul.launches == before + 1
    want = matmul.modmatmul(f, a.cpu(), b.cpu(), out=c.cpu().clone(),
                            run=torch.tensor(run))
    assert torch.equal(out.cpu(), want)


@pytest.mark.parametrize("case", ["zero", "live"])
@pytest.mark.parametrize("run", [False, True])
def test_panel_kernel_run_flag(case, run, card):
    # the device flag of the empty-panel branch: False returns P, zero G /
    # prow / pcol, no pivot and is_piv; True eliminates (an all-zero panel
    # finds nothing either way)
    f = field(42013)
    P = _rand(f, (1000, 128), 9, density=0.6)
    if case == "zero":
        P.zero_()
    ispiv = torch.zeros(1000, dtype=torch.bool)
    ispiv[::7] = True
    P, ispiv = P.to(card), ispiv.to(card)
    flag = torch.tensor(run, device=card)
    got = cuda_panel.panel_eliminate_cuda(f, 128, P, ispiv, 0, run=flag)
    want = dense._panel_eliminate(f, P, ispiv, 0, 128, flag)
    for g, w in zip(got, want):
        assert g.dtype == w.dtype and torch.equal(g, w)
    assert bool(got[4].any()) == (run and case == "live")


def _finish_case(f, seed, n=600, m=500):
    X = f.rand((n, m), np.random.default_rng(seed)).astype(np.int64)
    X[np.random.default_rng(seed + 1).random(X.shape) > 0.4] = 0
    X[:, 128:256] = 0
    X[400:] = f.normalize(X[:200] * 3)
    r, c = np.nonzero(X)
    return r, c, X[r, c].astype(np.int32)


def _dead_groups(f, seed):
    # five blocks of 128 rows over three groups of four panels (the last
    # 476 columns wide), which run 3 group bodies of 15
    X = dead_group_matrix(f, seed, bs=128, gw=512, last=476)
    r, c = np.nonzero(X)
    return r, c, X[r, c].astype(np.int32)


def _fused(f, r, c, v, device, bs=128, n=600, m=500):
    n_pad = -(-n // bs) * bs
    to = (lambda x: torch.from_numpy(x).to(device))
    out = dense.fused_blocked_finish(f, (n_pad, dense._bucket(m)), m, bs,
                                     128, to(r), to(c), to(v))
    return [x.cpu() for x in out]


def _card_grouped(monkeypatch, call):
    # call() on the CPU with the card's panel groups, for the count of
    # group bodies run (the CPU's own groups give the same bits)
    with monkeypatch.context() as mp:
        mp.setattr(dense, "_FORCE_GROUP", dense.PANEL_GROUP)
        return call()


@pytest.mark.parametrize("case", ["random", "dead_groups"])
@pytest.mark.parametrize("p", [42013, 2147483629, 4294967291])
def test_fused_finish_graph_replays_equal_eager_and_cpu(p, case, card,
                                                        monkeypatch):
    # the first call of a shape runs the loop eagerly, the second captures
    # it and replays, later ones replay the graph on new data of the same
    # shape; all equal the CPU's fused finish bit for bit (the CPU's panel
    # groups of one panel against the card's of four), and the count of
    # group bodies run equals the CPU's with the card's groups.  The
    # wrappers count the eager run's launches only: a capture runs
    # nothing, a replay bypasses them.  "dead_groups" makes most group
    # bodies dead: leading all-zero groups, a dry block, a dependent
    # block, an early exit in the middle of a block, and a block whose
    # last group is live
    f = field(p)
    shape = dict(n=600, m=500) if case == "random" else dict(n=640, m=1500)
    make = _finish_case if case == "random" else _dead_groups
    dense.release_finish_graphs()
    try:
        for seed, how in zip((11, 12, 13, 14),
                             ("eager", "captured", "replayed", "replayed")):
            r, c, v = make(f, seed)
            before = cuda_panel.launches, cuda_matmul.launches
            got = _fused(f, r, c, v, card, **shape)
            assert dense.last_finish["graph"] == how
            after = cuda_panel.launches, cuda_matmul.launches
            if how == "eager":
                assert all(a > b for a, b in zip(after, before))
            else:
                assert after == before
            want = _fused(f, r, c, v, "cpu", **shape)
            assert len(got) == len(want) == 7
            for g, w in zip(got[:6], want):
                assert torch.equal(g, w)
            grouped = _card_grouped(monkeypatch, lambda: _fused(
                f, r, c, v, "cpu", **shape))
            assert torch.equal(got[6], grouped[6])
            if case == "dead_groups":
                assert got[3].tolist() == [128, 0, 128, 0, 128]
                assert int(got[6]) == RUNS
        assert dense.last_finish["graph_bytes"] > 0
    finally:
        dense.release_finish_graphs()


def test_replays_outlive_empty_cache(card):
    # what the conditional nodes' bodies allocate at capture lives in a
    # pool held with the graph, not in the default pool: no segment of the
    # body stream is the default pool's, and after empty_cache() tensors
    # made and filled in the memory it returned are left alone by later
    # replays, which still equal the CPU
    f = field(42013)
    from spasm_tpu_torch.ops import _cuda
    dense.release_finish_graphs()
    try:
        for seed in (11, 12):
            _fused(f, *_finish_case(f, seed), card)
        assert dense.last_finish["graph"] == "captured"
        body = _cuda._body_streams[torch.cuda.current_device()].cuda_stream
        segs = [s for s in torch.cuda.memory_snapshot()
                if s["stream"] == body]
        assert all(tuple(s["segment_pool_id"]) != (0, 0) for s in segs)
        torch.cuda.synchronize()
        torch.cuda.empty_cache()
        fill = [torch.full((1 << 18,), -7, dtype=torch.int32, device=card)
                for _ in range(64)]                      # 1 MiB each
        fill.append(torch.full((1 << 28,), -7, dtype=torch.int32,
                               device=card))             # 1 GiB
        for seed in (13, 14):
            r, c, v = _finish_case(f, seed)
            got = _fused(f, r, c, v, card)
            assert dense.last_finish["graph"] == "replayed"
            want = _fused(f, r, c, v, "cpu")
            for g, w in zip(got[:6], want):
                assert torch.equal(g, w)
            assert all(bool((t == -7).all()) for t in fill), seed
    finally:
        dense.release_finish_graphs()


def test_fused_finish_makes_no_host_sync(card, monkeypatch):
    # the captured and the replayed finish (densify, capture or replay,
    # the groups' conditional nodes) under the sync debugger: any
    # synchronizing call raises
    f = field(42013)
    dense.release_finish_graphs()
    r, c, v = _finish_case(f, 14)
    up = [dense.upload(x, x.dtype, card) for x in (r, c, v)]
    n_pad, na = 640, dense._bucket(500)
    want = _fused(f, r, c, v, "cpu")
    try:
        dense.fused_blocked_finish(f, (n_pad, na), 500, 128, 128, *up)
        assert dense.last_finish["graph"] == "eager"
        torch.cuda.synchronize()
        for how in ("captured", "replayed"):
            torch.cuda.set_sync_debug_mode("error")
            try:
                up = [dense.upload(x, x.dtype, card) for x in (r, c, v)]
                out = dense.fused_blocked_finish(f, (n_pad, na), 500, 128,
                                                 128, *up)
            finally:
                torch.cuda.set_sync_debug_mode(0)
            assert dense.last_finish["graph"] == how
            # the last value, the count of group bodies run, is the card's
            for g, w in zip(out[:6], want):
                assert torch.equal(g.cpu(), w)
    finally:
        dense.release_finish_graphs()


def _sync_mode(mode, fn, record=None):
    # fn under the sync debugger's mode, the caller's mode restored after;
    # record takes the bytes of what fn returns
    def run(*a, **k):
        prev = torch.cuda.get_sync_debug_mode()
        torch.cuda.set_sync_debug_mode(mode)
        try:
            out = fn(*a, **k)
        finally:
            torch.cuda.set_sync_debug_mode(prev)
        if record is not None:
            record.append(sum(x.nbytes for x in out))
        return out
    return run


@pytest.mark.parametrize("loop", ["fused", "streaming"])
def test_finish_stages_csr_with_no_host_sync(loop, card, monkeypatch):
    # S goes up as its CSR and its COO is formed on the card: from the
    # upload to the replay nothing reads the card, whether the loop is one
    # graph (fused) or a graph a step (streaming).  The loop runs under the
    # sync debugger, which only the reads (to_host: the block pivots, U)
    # and U's construction (its count of nonzeros) leave.  U equals the
    # CPU's, and finish_copy_bytes is the CSR's bytes plus the reads
    ech = importlib.import_module("spasm_tpu_torch.echelonize")
    monkeypatch.setattr(dense, "HOST_CUTOFF", 1)
    if loop == "streaming":
        monkeypatch.setattr(dense, "FUSED_BUDGET", 0)
    A = SparseGFp.rand(field(42013), 900, 700, 0.05,
                       np.random.default_rng(21))
    S = A.to_scipy()
    assert np.unique(S.indices).size == 700      # no column map goes up
    csr_bytes = S.indptr.size * 8 + S.nnz * (4 + (
        4 if S.data.dtype == np.int32 else 8))
    kw = dict(dense_block_size=256, device_sparsity_threshold=None,
              max_round=0)
    cpu = lu_arrays(echelonize(A, device="cpu", **kw))
    u_reads = []
    dense.release_finish_graphs()
    try:
        for call in range(3):
            with monkeypatch.context() as mp:
                if call:   # the first call's eager RREFs read the card
                    name = ("_fused_device_finish" if loop == "fused"
                            else "_streaming_loop")
                    mp.setattr(ech, name,
                               _sync_mode("error", getattr(ech, name)))
                    mp.setattr(dense, "to_host",
                               _sync_mode(0, dense.to_host))
                    mp.setattr(dense, "extract_u_csr", _sync_mode(
                        0, dense.extract_u_csr, u_reads))
                got = lu_arrays(echelonize(A, device=card, **kw))
            st = last_phase_stats()
            for k in cpu:
                assert np.array_equal(got[k], cpu[k]), (call, k)
            if not call:
                continue
            if loop == "fused":
                assert dense.last_finish["graph"] == ("captured", "replayed")[
                    call - 1]
                nb = -(-900 // 256)
                meta = (nb + 2 * nb * 256 + 1) * 8
            else:
                assert st["finish_streamed"] == 1
                assert st["finish_rows_skipped"] == 0
                meta = sum((2 + 2 * min(256, 900 - b * 256)) * 8
                           for b in range(st["finish_blocks"]))
            assert st["finish_copy_bytes"] == csr_bytes + meta + u_reads[-1]
    finally:
        dense.release_finish_graphs()


def test_echelonize_fused_equals_streaming_on_the_card(card, monkeypatch):
    # the fused finish (blocks of _bucket(256) = 256 rows) against the
    # streaming loop (FUSED_BUDGET = 0, blocks of 256 rows) and the CPU
    monkeypatch.setattr(dense, "HOST_CUTOFF", 1)
    A = SparseGFp.rand(field(42013), 900, 700, 0.05,
                       np.random.default_rng(21))
    kw = dict(dense_block_size=256, device_sparsity_threshold=None)
    dense.release_finish_graphs()
    try:
        fused = [lu_arrays(echelonize(A, device=card, **kw))
                 for _ in range(3)]
        assert dense.last_finish["graph"] == "replayed"
    finally:
        dense.release_finish_graphs()
    cpu = lu_arrays(echelonize(A, device="cpu", **kw))
    monkeypatch.setattr(dense, "FUSED_BUDGET", 0)
    dense.last_finish.clear()
    streaming = lu_arrays(echelonize(A, device=card, **kw))
    assert not dense.last_finish
    for k in cpu:
        for other in (*fused, streaming):
            assert np.array_equal(other[k], cpu[k]), k


def _steps(f, X, device, bs=128):
    # the streaming finish's steps over X's blocks, on the card with the
    # buffers of stream_buffers (the graph-replayed steps)
    n, m = X.shape
    r, c = np.nonzero(X)
    v = X[r, c].astype(np.int32)
    to = (lambda x: torch.from_numpy(np.ascontiguousarray(x)).to(device))
    Ud, pc_map = dense.stream_buffers(min(n, m) + bs, m, device)
    r_d, ran = 0, []
    for b0 in range(0, n, bs):
        sel = (r >= b0) & (r < b0 + bs)
        r_d, _, _, _, k = dense.blocked_finish_step(
            f, (bs, m), 128, to(r[sel] - b0), to(c[sel]), to(v[sel]), Ud,
            pc_map, r_d)
        ran.append(k)
    return Ud[:r_d].cpu(), pc_map[:r_d].cpu(), ran


@pytest.mark.parametrize("case", ["echelonize", "dead_groups"])
@pytest.mark.parametrize("p", [42013, 2147483629])
def test_streaming_steps_replay_equal_eager_and_cpu(p, case, card,
                                                    monkeypatch):
    # the streaming loop (FUSED_BUDGET = 0) on the card: a step's first
    # sight of its key (block shape, bucketed rank K) runs eagerly, the
    # second captures a CUDA graph, later ones replay it.  Three calls equal
    # the CPU's bit for bit (its panel groups of one panel against the
    # card's of four), count the group bodies run as the CPU does with the
    # card's groups, and the third, all replays, launches no K1 or K2 of its
    # own.  "dead_groups" runs the steps alone over blocks whose groups
    # are mostly dead (as in the fused finish's test): 3 bodies of 15
    monkeypatch.setattr(dense, "HOST_CUTOFF", 1)
    monkeypatch.setattr(dense, "FUSED_BUDGET", 0)
    f = field(p)
    if case == "echelonize":
        A = SparseGFp.rand(f, 900, 700, 0.05, np.random.default_rng(21))
        kw = dict(dense_block_size=128, device_sparsity_threshold=None)
        cpu = lu_arrays(echelonize(A, device="cpu", **kw))

        def grouped_counts():
            echelonize(A, device="cpu", **kw)
            return [last_phase_stats()[k]
                    for k in ("rref_groups", "rref_groups_run")]
        counts = _card_grouped(monkeypatch, grouped_counts)
        assert 0 < counts[1] < counts[0]
    else:
        X = dead_group_matrix(f, 5, bs=128, gw=512, last=476)
        cpu = _steps(f, X, "cpu")
        ran = _card_grouped(monkeypatch, lambda: _steps(f, X, "cpu"))[2]
        assert ran == [1, 0, 1, 0, 1]
    dense.release_finish_graphs()
    try:
        for call in range(3):
            before = cuda_panel.launches, cuda_matmul.launches
            if case == "echelonize":
                got = lu_arrays(echelonize(A, device=card, **kw))
                for k in cpu:
                    assert np.array_equal(got[k], cpu[k]), (call, k)
                assert [last_phase_stats()[k] for k in (
                    "rref_groups", "rref_groups_run")] == counts, call
            else:
                got = _steps(f, X, card)
                assert torch.equal(got[0], cpu[0]), call
                assert torch.equal(got[1], cpu[1]), call
                assert got[2] == ran, call
            after = cuda_panel.launches, cuda_matmul.launches
        assert dense._stream["graphs"]
        assert after == before
    finally:
        dense.release_finish_graphs()


def test_low_rank_streaming_on_the_card_equals_cpu(card, monkeypatch):
    # a boundary whose streaming finish skips its tail: the card's tail
    # check (samples formed and reduced on the card) skips the same rows as
    # the CPU's, and the LU is the CPU's, on every call
    monkeypatch.setattr(dense, "HOST_CUTOFF", 1)
    A = subcomplex_boundary(18, 6, 0.9, seed=0)
    kw = dict(dense_block_size=256)
    cpu = lu_arrays(echelonize(A, device="cpu", **kw))
    want = last_phase_stats()
    assert want["finish_streamed"] == 1 and want["finish_rows_skipped"] > 0
    dense.release_finish_graphs()
    try:
        for call in range(3):
            got = lu_arrays(echelonize(A, device=card, **kw))
            st = last_phase_stats()
            for k in cpu:
                assert np.array_equal(got[k], cpu[k]), (call, k)
            for k in ("finish_blocks", "finish_rows_skipped"):
                assert st[k] == want[k], (call, k)
    finally:
        dense.release_finish_graphs()
