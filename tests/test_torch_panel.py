"""Port's plain panel Jordan elimination (spasm_tpu_torch.ops.dense.
_panel_eliminate, the plain version of the K2 CUDA kernel) against the JAX
package's _panel_eliminate, its three Pallas panel kernels in interpret
mode, and a Python big-int transcription of the same steps, bit for bit in
all six outputs."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from spasm_tpu.field import field
from spasm_tpu.ops import dense as ref_dense
from spasm_tpu.ops import pallas_panel

from spasm_tpu_torch.ops import dense

NAMES = ("P", "G", "prow", "pcol", "pfound", "is_piv")
PRIMES = [5, 42013, 65521, 65537, 92681, 104729, 2147483629, 4294967291]

# j0 and npivcols traced: one compile serves every cut of a prime
_ref_panel = jax.jit(ref_dense._panel_eliminate, static_argnums=(0,))


def make_panel(p, rng, n=64, c=32):
    """A panel with random zeros, a column with no candidate, an empty
    row, dependent rows and pre-pivoted rows."""
    f = field(p)
    P = f.rand((n, c), rng).astype(np.int32)
    P[rng.random((n, c)) < 0.3] = 0
    P[:, 2] = 0
    P[10, :] = 0
    P[3, 0] = 0
    P[20] = P[21]
    ispiv = np.zeros(n, bool)
    ispiv[[5, 7, 30]] = True
    return f, P, ispiv


def cut_of(cut, c):
    """(j0, npivcols): with a cut only the first 20 columns are eligible."""
    return (256, 256 + 20) if cut else (0, c)


def port_panel(f, P, ispiv, j0, npivcols):
    out = dense._panel_eliminate(f, torch.from_numpy(P),
                                 torch.from_numpy(ispiv), j0, npivcols)
    return [t.numpy() for t in out]


def _oracle(p, P, ispiv, j0, npivcols):
    n, c = P.shape
    P = P.astype(object)
    G = np.zeros((n, c), object)
    ispiv = ispiv.copy()
    prow, pcol, pfound = (np.zeros(c, np.int64), np.zeros(c, np.int64),
                          np.zeros(c, bool))
    kk = 0
    for jj in range(c):
        if j0 + jj >= npivcols:
            break
        cand = [i for i in range(n) if not ispiv[i] and P[i, jj] % p]
        if not cand:
            continue
        pr = cand[0]
        pinv = pow(int(P[pr, jj]) % p, p - 2, p)
        beta = (-P[:, jj] * pinv) % p
        beta[pr] = (pinv - 1) % p
        g_row = G[pr].copy()
        g_row[kk] += 1
        P = (P + beta[:, None] * P[pr][None, :]) % p
        G = (G + beta[:, None] * g_row[None, :]) % p
        ispiv[pr] = True
        prow[kk], pcol[kk], pfound[kk] = pr, jj, True
        kk += 1
    f = field(p)
    return [f.normalize(P), f.normalize(G), prow, pcol, pfound, ispiv]


def _check(got, want):
    for g, w, name in zip(got, want, NAMES):
        np.testing.assert_array_equal(np.asarray(g).astype(np.int64),
                                      np.asarray(w).astype(np.int64), name)


@pytest.mark.parametrize("cut", [False, True])
@pytest.mark.parametrize("p", PRIMES)
def test_panel_matches_bigint_transcription(p, cut, rng):
    f, P, ispiv = make_panel(p, rng)
    j0, npivcols = cut_of(cut, P.shape[1])
    got = port_panel(f, P, ispiv, j0, npivcols)
    assert got[4].sum() > 0
    _check(got, _oracle(p, P, ispiv, j0, npivcols))


@pytest.mark.parametrize("p", [5, 42013, 65537, 104729])
def test_panel_matches_jax_fallback(p, rng):
    f, P, ispiv = make_panel(p, rng)
    for cut in (False, True):
        j0, npivcols = cut_of(cut, P.shape[1])
        want = _ref_panel(f, jnp.asarray(P), jnp.asarray(ispiv), j0,
                          npivcols)
        _check(port_panel(f, P, ispiv, j0, npivcols), want)


@pytest.mark.parametrize("p,variant", [
    (42013, "scalefree"), (65521, "scalefree"), (65537, "classic"),
    (92681, "classic"), (104729, "tier_b"), (2147483629, "tier_b")])
def test_panel_matches_pallas_interpret(p, variant, rng):
    # the Pallas kernel the JAX package runs at this p, in interpret mode
    f, P, ispiv = make_panel(p, rng)
    assert pallas_panel.supported(f, P.shape[0])
    j0, npivcols = cut_of(True, P.shape[1])
    args = (f, npivcols, jnp.asarray(P), jnp.asarray(ispiv), j0)
    if variant == "scalefree":
        want = pallas_panel._panel_scalefree_jit(*args)
    elif variant == "classic":
        want = pallas_panel.panel_eliminate_pallas(*args)
    else:
        want = pallas_panel._panel_tier_b_jit(*args)
    _check(port_panel(f, P, ispiv, j0, npivcols), want)


def test_panel_correction_invariant(rng):
    # row_i_final == X_i + G_i @ X[prows] over the found slots
    f, P, ispiv = make_panel(42013, rng)
    Pf, G, prow, _, pfound, _ = port_panel(f, P, ispiv, 0, P.shape[1])
    k = int(pfound.sum())
    recon = f.normalize(P.astype(object)
                        + G[:, :k].astype(object) @ P[prow[:k]].astype(object))
    np.testing.assert_array_equal(recon.astype(np.int64),
                                  Pf.astype(np.int64))


def test_panel_inputs_untouched(rng):
    f, P, ispiv = make_panel(42013, rng)
    Pt, It = torch.from_numpy(P.copy()), torch.from_numpy(ispiv.copy())
    dense._panel_eliminate(f, Pt, It, 0, P.shape[1])
    np.testing.assert_array_equal(Pt.numpy(), P)
    np.testing.assert_array_equal(It.numpy(), ispiv)


# ---- a CPU model of the K2 CUDA kernel's algorithm (csrc/panel.cu)
#
# The kernel splits the rows over a thread-block cluster of 16 CTAs in
# contiguous tiles and runs the scale-free recurrence of the JAX package's
# _kernel_scalefree: no inverse per step, one inverse per row at the end.
# This model transcribes it step for step: each tile's first candidate and
# the min over the tiles; the pivot row as the other CTAs take it (P[pr],
# and H[pr] with s[pr], from the candidate's slot, in slot kk); the
# kernel's work skips (only rows with a nonzero in the pivot column change;
# a row not yet a pivot row is updated from column jj on, since it is zero
# to the left; H only up to slot kk); and the owner's write of H[pr, kk]
# and s[pr] in the pivot's own step.  The bit-equality below proves those
# choices on the CPU.


def cluster_model(p, P, ispiv, j0, npivcols, R):
    f = field(p)
    half = (p - 1) // 2
    assert 2 * half * half < 2 ** 63      # pv*x - col*y fits int64
    n, c = P.shape
    rpc = max(1, -(-n // R))
    tiles = [(lo, min(n, lo + rpc)) for lo in range(0, R * rpc, rpc)]
    P = P.astype(np.int64)
    H = np.zeros((n, c), np.int64)
    s = np.ones(n, np.int64)
    isp = ispiv.copy()
    prow, pcol = np.zeros(c, np.int32), np.zeros(c, np.int32)
    pfound = np.zeros(c, bool)
    kk = 0
    for jj in range(c):
        if j0 + jj >= npivcols:
            break
        colv = P[:, jj].copy()
        # each CTA's first candidate in its own tile, then the cluster min
        cands = []
        for lo, hi in tiles:
            hit = np.flatnonzero((colv[lo:hi] != 0) & ~isp[lo:hi])
            cands.append(lo + hit[0] if hit.size else n)
        pr = min(cands)
        if pr == n:
            continue
        pv, s_pr = P[pr, jj], s[pr]       # from the candidate's slot
        srow = P[pr].copy()
        hrow = H[pr].copy()
        hrow[kk] = s_pr                   # H[pr] + s[pr] e_kk; H[pr, kk] == 0
        H[pr, kk], s[pr] = f.normalize(s_pr - pv), pv   # the owner
        for lo, hi in tiles:
            for i in range(lo, hi):
                if i == pr or colv[i] == 0:
                    continue
                a = 0 if isp[i] else jj
                P[i, a:] = f.normalize(pv * P[i, a:] - colv[i] * srow[a:])
                H[i, :kk + 1] = f.normalize(pv * H[i, :kk + 1]
                                            - colv[i] * hrow[:kk + 1])
                s[i] = f.normalize(pv * s[i])
        isp[pr] = True
        prow[kk], pcol[kk], pfound[kk] = pr, jj, True
        kk += 1
    sinv = np.array([pow(int(v) % p, p - 2, p) for v in s], np.int64)
    sinv = f.normalize(sinv)
    P = f.normalize(P.astype(object) * sinv[:, None].astype(object))
    G = f.normalize(H.astype(object) * sinv[:, None].astype(object))
    return [P.astype(np.int32), G.astype(np.int32), prow, pcol, pfound, isp]


def _model_case(case, p, rng):
    """(P, ispiv, j0, npivcols) of one named case."""
    n, c = {"n1": (1, 16), "n_below_cluster": (5, 16),
            "c37": (50, 37)}.get(case, (64, 32))
    f = field(p)
    P = f.rand((n, c), rng).astype(np.int32)
    P[rng.random((n, c)) < 0.3] = 0
    ispiv = np.zeros(n, bool)
    if n > 8:
        P[:, 2] = 0
        P[10, :] = 0
        P[20] = P[21]
        ispiv[[5, 7, 30 % n]] = True
    if case == "zero_column":
        P[:, 0] = 0
    if case == "all_prepivoted":
        ispiv[:] = True
    j0, npivcols = (256, 256 + 20) if case == "cut" else (0, c)
    return P, ispiv, j0, npivcols


MODEL_CASES = ["full", "cut", "n_below_cluster", "n1", "all_prepivoted",
               "zero_column", "c37"]


@pytest.mark.parametrize("case", MODEL_CASES)
@pytest.mark.parametrize("p", [5, 42013, 92681, 2147483629, 4294967291])
def test_cluster_model_matches_panel_eliminate(p, case, rng):
    # the model at the kernel's 16 CTAs, and at 8 to show that the bits do
    # not depend on the tile split, against the port's
    # _panel_eliminate, the big-int transcription and, at the 64 x 32 panel
    # for every prime and at every shape for the small primes, the JAX
    # package's _panel_eliminate (each new shape of a large prime costs a
    # compile of several seconds)
    P, ispiv, j0, npivcols = _model_case(case, p, rng)
    f = field(p)
    want = port_panel(f, P, ispiv, j0, npivcols)
    _check(want, _oracle(p, P, ispiv, j0, npivcols))
    if P.shape == (64, 32) or p <= 92681:
        ref = _ref_panel(f, jnp.asarray(P), jnp.asarray(ispiv), j0, npivcols)
        _check(want, ref)
    if case == "all_prepivoted":
        assert not want[4].any()
    elif case != "n1" or P.any():
        assert want[4].any()
    for R in (8, 16):
        _check(cluster_model(p, P, ispiv, j0, npivcols, R), want)
