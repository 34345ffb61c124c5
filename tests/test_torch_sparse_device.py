"""The port's sort-based wave elimination (spasm_tpu_torch.ops.sparse_device)
against the JAX package's (spasm_tpu.ops.sparse_device, JAX on the CPU) and
the host waves, on the same inputs made from a seed: the eliminated matrix
is the same SparseGFp (tolerance 0: GF(p) is exact), and the port returns
None, or raises, in exactly the cases where the reference does."""

import numpy as np
import pytest
import scipy.sparse as sp

from spasm_tpu import SparseGFp, field
from spasm_tpu.elimination import compute_levels
from spasm_tpu.ops import sparse_device as ref_sd
from spasm_tpu.pivots import find_structural_pivots

from spasm_tpu_torch import interop
from spasm_tpu_torch._host.elimination import wave_eliminate
from spasm_tpu_torch.ops import sparse_device as port_sd

PRIMES = (42013, 2147483629, 4294967291)


def make_case(F, rng, n=50, m=60, density=0.08):
    """The round-0 pivot block (unit pivots) and remaining rows of a random
    matrix, as tests/test_sparse_device.py builds them."""
    A = SparseGFp.rand(F, n, m, density, rng)
    prows, pcols, _ = find_structural_pivots(A)
    npiv = prows.size
    S = A.to_scipy()
    Up = sp.csr_matrix(S[prows])
    vals = np.asarray(Up[np.arange(npiv), pcols]).ravel()
    scales = F.inv(vals)
    row_of = np.repeat(np.arange(npiv), np.diff(Up.indptr))
    Up.data = F.normalize(Up.data * scales[row_of])
    U = SparseGFp.from_scipy(Up, F.p)
    levels = compute_levels(U, pcols)
    rest = np.setdiff1d(np.arange(n), prows)
    B = SparseGFp.from_scipy(sp.csr_matrix(S[rest]), F.p)
    return U, pcols, levels, B


def both(U, pcols, levels, B, **kw):
    """(the reference's result, the port's result) on the same inputs."""
    want = ref_sd.eliminate_device(B.field, U, pcols, levels, B, **kw)
    pU, pB = (interop.sparse_from_reference(X) for X in (U, B))
    got = port_sd.eliminate_device(pB.field, pU, pcols, levels, pB,
                                   device="cpu", **kw)
    return want, got


def assert_same(got, want):
    """Equal SparseGFp, array for array and dtype for dtype."""
    assert got is not None and want is not None
    assert got.shape == want.shape and got.field.p == want.field.p
    for name in ("indptr", "indices", "data"):
        g, w = getattr(got, name), getattr(want, name)
        assert g.dtype == w.dtype, name
        np.testing.assert_array_equal(g, w, name)


def host_waves(U, pcols, levels, B):
    pB = interop.sparse_from_reference(B)
    D, _ = wave_eliminate(pB.field, U.to_scipy(), pcols, levels,
                          B.to_scipy())
    return type(pB).from_scipy(D, pB.field.p)


# name -> (make_case arguments, eliminate_device options, expected outcome)
CASES = {
    "matches_host": ((50, 60, 0.08), {}, "result"),
    "multilevel": ((40, 40, 0.25), {}, "result"),
    "overflow_detected": ((60, 60, 0.2),
                          dict(cap_factor=0.001, cap_hits=4), None),
    # the state cannot hold B: the reference's padding raises
    "cap_below_nnz": ((200, 200, 0.05), dict(cap_factor=0.001), "raises"),
}


@pytest.mark.parametrize("p", PRIMES)
@pytest.mark.parametrize("case", sorted(CASES))
def test_matches_reference_and_host(case, p):
    args, kw, outcome = CASES[case]
    U, pcols, levels, B = make_case(field(p), np.random.default_rng(0),
                                    *args)
    if case == "multilevel":
        assert levels.max() >= 1
    if outcome == "raises":
        with pytest.raises(ValueError):
            both(U, pcols, levels, B, **kw)
        return
    want, got = both(U, pcols, levels, B, **kw)
    if outcome is None:
        assert want is None and got is None
        return
    assert_same(got, want)
    assert_same(got, host_waves(U, pcols, levels, B))
    assert not np.isin(got.indices, pcols).any()


@pytest.mark.parametrize("p", PRIMES)
def test_empty_pivots(p, rng):
    F = field(p)
    B = SparseGFp.rand(F, 10, 12, 0.3, rng)
    U = SparseGFp.zeros(F, 0, 12)
    none = np.zeros(0, np.int64)
    want, got = both(U, none, none, B)
    assert want == B
    assert_same(got, interop.sparse_from_reference(B))


@pytest.mark.parametrize("p", PRIMES)
def test_first_cap_overflows_and_retry_fits(p):
    # echelonize's retry: the first capacity (cap_factor 4) overflows in
    # both packages, the 4x one (16) fits in both, with the same result
    U, pcols, levels, B = make_case(field(p), np.random.default_rng(0),
                                    200, 200, 0.05)
    want, got = both(U, pcols, levels, B)
    assert want is None and got is None
    want, got = both(U, pcols, levels, B, cap_factor=16)
    assert_same(got, want)
    assert_same(got, host_waves(U, pcols, levels, B))


def test_wave_stats_and_padding(rng):
    # padding slots (row == nrows) are dead, and the per-wave counts are
    # those of the result
    F = field(42013)
    U, pcols, levels, B = make_case(F, rng, 40, 40, 0.25)
    pU = interop.sparse_from_reference(U)
    u_cols, u_vals = port_sd.ell_pack(pU)
    i, j, v = B.to_coo()
    pad = 7
    stats = {}
    rows, cols, vals, overflow = port_sd.wave_eliminate_device(
        F, 1 << 16, 1 << 13, int(levels.max()) + 1,
        np.append(i, [B.n] * pad), np.append(j, [3] * pad),
        np.append(v, [5] * pad), u_cols, u_vals, levels,
        port_sd.col_to_pivot(B.m, pcols), B.n, device="cpu", _stats=stats)
    assert not overflow
    want = ref_sd.eliminate_device(F, U, pcols, levels, B)
    np.testing.assert_array_equal(rows.numpy(), want.rows_expanded())
    np.testing.assert_array_equal(cols.numpy(), want.indices)
    np.testing.assert_array_equal(vals.numpy(), want.data)
    assert len(stats["hits"]) == len(stats["kept"]) == levels.max() + 1
    assert stats["kept"][-1] == want.nnz and sum(stats["hits"]) > 0
    assert stats["max_expansion"] == max(stats["hits"]) * u_cols.shape[1]


def test_ell_pack_matches_reference(rng):
    U, _, _, _ = make_case(field(42013), rng, 40, 40, 0.25)
    for g, w in zip(port_sd.ell_pack(interop.sparse_from_reference(U)),
                    ref_sd.ell_pack(U)):
        assert g.dtype == w.dtype
        np.testing.assert_array_equal(g, w)


def test_cuda_tensor_without_a_card_raises():
    # the device is the caller's: no card, no quiet fall back to the CPU
    import torch

    if torch.cuda.is_available():
        pytest.skip("a card is visible: the CPU-only behaviour is not "
                    "observable")
    U, pcols, levels, B = make_case(field(42013), np.random.default_rng(0))
    pU, pB = (interop.sparse_from_reference(X) for X in (U, B))
    with pytest.raises((RuntimeError, AssertionError)):
        port_sd.eliminate_device(pB.field, pU, pcols, levels, pB,
                                 device="cuda")
