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
