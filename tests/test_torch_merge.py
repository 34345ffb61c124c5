"""The port's plain per-row merge (spasm_tpu_torch/ops/merge.py) against
the JAX package's Pallas merge kernel (spasm_tpu/ops/pallas_merge.py, in
interpret mode on the CPU, as tests/test_sparse_onepass.py runs it) and
against a brute-force per-row accumulation.  GF(p) sums are exact:
tolerance 0.

The reference's bitonic network compares columns only, so its partial sums
at slots that are not the last of their run depend on the network; the
port sorts by (col, val as uint32), which fixes them.  The comparison with
the reference is therefore the full sorted columns and the kept
(col, val) slots, which the contract defines."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

from spasm_tpu import field
from spasm_tpu.ops.pallas_merge import merge_rows_pallas

from spasm_tpu_torch.ops import merge

PRIMES = [3, 42013, 2**31 - 19, 2**32 - 5]


def make_tile(f, R, W, m, rng):
    """(R, W) int32 cols in [0, m] and balanced vals, with dead slots
    (col == m, val 0), an all-dead row, a row that cancels to zero, a
    single-run row and a row of one repeated entry."""
    p = f.p
    cols = rng.integers(0, m, (R, W)).astype(np.int32)
    cols[rng.random((R, W)) < 0.3] = m
    vals = rng.integers(-(p // 2), p // 2 + 1, (R, W)).astype(np.int64)
    vals[cols == m] = 0
    cols[0] = m                                  # all dead
    vals[0] = 0
    half = W // 2                                # every column cancels
    cols[1, :half] = rng.integers(0, m, half)
    cols[1, half:] = cols[1, :half]
    vals[1, half:] = -vals[1, :half]
    cols[2] = 7                                  # one run
    cols[3] = 5                                  # one run of equal entries
    vals[3] = vals[3, 0]
    return cols, vals.astype(np.int32)


def brute(f, cols, vals, m):
    """Per row: {col: balanced sum} over the live slots, zeros dropped."""
    p = f.p
    out = []
    for rc, rv in zip(cols, vals):
        acc = {}
        for c, v in zip(rc.tolist(), rv.tolist()):
            if c != m:
                acc[c] = (acc.get(c, 0) + v) % p
        out.append({c: (v if v <= p // 2 else v - p)
                    for c, v in acc.items() if v})
    return out


def kept(cols, vals, keep):
    return [{int(c): int(v) for c, v, k in zip(rc, rv, rk) if k}
            for rc, rv, rk in zip(cols, vals, keep)]


@pytest.mark.parametrize("W", [128, 512])
@pytest.mark.parametrize("p", PRIMES)
def test_plain_merge_matches_pallas_reference(p, W, rng):
    f = field(p)
    R, m = 16, 3 * W
    cols, vals = make_tile(f, R, W, m, rng)
    oc, ov, ok = merge.merge_rows_plain(f, torch.from_numpy(cols),
                                        torch.from_numpy(vals), m)
    oc, ov, ok = oc.numpy(), ov.numpy(), ok.numpy()
    with pltpu.force_tpu_interpret_mode():
        rc, rv, rk = merge_rows_pallas(f, jnp.asarray(cols),
                                       jnp.asarray(vals), m)
    rc, rv, rk = np.asarray(rc), np.asarray(rv), np.asarray(rk)
    assert oc.dtype == np.int32 and ov.dtype == np.int32
    assert ok.dtype == np.bool_
    np.testing.assert_array_equal(oc, rc)
    np.testing.assert_array_equal(ok, rk)
    np.testing.assert_array_equal(ov[ok], rv[rk])
    want = brute(f, cols, vals, m)
    assert kept(oc, ov, ok) == want
    assert want[0] == {} and want[1] == {} and len(want[2]) <= 1


@pytest.mark.parametrize("W", [1, 80, 272, 1040])
@pytest.mark.parametrize("p", PRIMES)
def test_plain_merge_any_width(p, W, rng):
    # the width classes need not be powers of two
    f = field(p)
    R, m = 6, 2 * W + 1
    cols, vals = make_tile(f, R, W, m, rng) if W > 1 else (
        rng.integers(0, m + 1, (R, 1)).astype(np.int32),
        f.rand((R, 1), rng).astype(np.int32))
    oc, ov, ok = merge.merge_rows(f, torch.from_numpy(cols),
                                  torch.from_numpy(vals), m)
    oc, ov, ok = oc.numpy(), ov.numpy(), ok.numpy()
    assert kept(oc, ov, ok) == brute(f, cols, vals, m)
    np.testing.assert_array_equal(oc, np.sort(cols, axis=1))
    last = np.ones_like(ok)
    last[:, :-1] = oc[:, 1:] != oc[:, :-1]
    assert not (ok & ~last).any() and not (ok & (oc == m)).any()
