"""The port's CUDA kernels against their plain PyTorch versions on the card,
exactly (GF(p): tolerance 0).  Marked ``cuda`` and skipped without a card.

The machine with the card has no jax, and the suite's conftest imports it,
so there these tests run without it:

    python -m pytest --noconftest -q tests/test_torch_cuda.py
"""

import numpy as np
import pytest
import torch

from spasm_tpu_torch import SparseGFp, echelonize, field
from spasm_tpu_torch.interop import lu_arrays
from spasm_tpu_torch.ops import cuda_matmul, cuda_panel, dense, matmul

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


@pytest.mark.parametrize("shape", [(130, 260, 140), (1000, 1000, 1024),
                                   (1, 5, 3)])
@pytest.mark.parametrize("p", PRIMES)
def test_modmatmul_kernel_matches_plain(p, shape, card):
    f = field(p)
    n, k, m = shape
    a, b = _rand(f, (n, k), 1).to(card), _rand(f, (k, m), 2).to(card)
    before = cuda_matmul.launches
    got = matmul.modmatmul(f, a, b)          # dispatches to the kernel
    assert cuda_matmul.launches == before + 1
    want = matmul.modmatmul_plain(f, a, b)
    torch.cuda.synchronize()
    assert got.dtype == torch.int32 and torch.equal(got, want)


@pytest.mark.parametrize("n,c", [(1000, 128), (300, 37)])
@pytest.mark.parametrize("cut", [False, True])
@pytest.mark.parametrize("p", PRIMES)
def test_panel_kernel_matches_plain(p, cut, n, c, card):
    # c = 37 takes the kernel's scalar (not int4) path
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
