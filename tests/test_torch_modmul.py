"""Port's elementwise GF(p) ops (spasm_tpu_torch.ops.modmul) against the
JAX package's (spasm_tpu.ops.modmul) and the host Field, exactly."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from spasm_tpu.field import field, num_limbs
from spasm_tpu.ops import modmul as ref

from spasm_tpu_torch.ops import modmul as mm

PRIMES = [5, 257, 42013, 92681, 104729, 16777213, 2147483629, 4294967291]
OPS = ["normalize", "add", "sub", "neg", "mul", "axpy", "inv_scalar",
       "to_limbs", "limb_weights"]


def _balanced(f, rng, size=400):
    h = f.p // 2
    edges = np.array([0, 1, -1, h, -h, h - 1, -(h - 1)], np.int64)
    return np.concatenate([edges, f.rand(size, rng)]).astype(np.int32)


def _t(x):
    return torch.from_numpy(np.asarray(x))


def _np(x):
    return np.asarray(x).astype(np.int64)


@pytest.mark.parametrize("op", OPS)
@pytest.mark.parametrize("p", PRIMES)
def test_elementwise_matches_reference(p, op, rng):
    f = field(p)
    a = _balanced(f, rng)
    b = rng.permutation(_balanced(f, rng))
    c = rng.permutation(_balanced(f, rng))
    A, B, C = _t(a), _t(b), _t(c)
    ja, jb, jc = jnp.asarray(a), jnp.asarray(b), jnp.asarray(c)
    a64, b64, c64 = (x.astype(np.int64) for x in (a, b, c))
    if op == "normalize":
        x = np.concatenate([a, rng.integers(-2**31, 2**31, 400)]).astype(
            np.int32)
        got = mm.normalize(f, _t(x))
        assert got.dtype == torch.int32
        np.testing.assert_array_equal(_np(got), _np(ref.normalize(
            f, jnp.asarray(x))))
        np.testing.assert_array_equal(_np(got), f.normalize(x))
        wide = np.array([2**62, -2**62, 3 * p + 1, -5 * p - 2], np.int64)
        np.testing.assert_array_equal(_np(mm.normalize(f, _t(wide))),
                                      f.normalize(wide))
    elif op in ("add", "sub", "mul"):
        got = _np(getattr(mm, op)(f, A, B))
        np.testing.assert_array_equal(got, _np(getattr(ref, op)(f, ja, jb)))
        np.testing.assert_array_equal(got, getattr(f, op)(a64, b64))
    elif op == "neg":
        got = _np(mm.neg(f, A))
        np.testing.assert_array_equal(got, _np(ref.neg(f, ja)))
        np.testing.assert_array_equal(got, f.neg(a64))
    elif op == "axpy":
        got = _np(mm.axpy(f, A, B, C))
        np.testing.assert_array_equal(got, _np(ref.axpy(f, ja, jb, jc)))
        np.testing.assert_array_equal(got, f.axpy(a64, b64, c64))
    elif op == "inv_scalar":
        nz = a[a != 0][:40]
        got = _np(mm.inv_scalar(f, _t(nz)))
        np.testing.assert_array_equal(got, _np(ref.inv_scalar(
            f, jnp.asarray(nz))))
        np.testing.assert_array_equal(got, f.inv(nz))
        assert int(mm.inv_scalar(f, torch.tensor(0, dtype=torch.int32))) == 0
    elif op == "to_limbs":
        nl = num_limbs(p)
        got = mm.to_limbs(f, A, nl)
        assert got.dtype == torch.int8 and got.shape == (a.size, nl)
        np.testing.assert_array_equal(_np(got), _np(ref.to_limbs(f, ja, nl)))
        w = 256 ** np.arange(nl, dtype=object)
        np.testing.assert_array_equal(
            (_np(got).astype(object) * w).sum(axis=1), a.astype(object))
    else:
        for nl in range(1, num_limbs(p) + 1):
            np.testing.assert_array_equal(_np(mm.limb_weights(f, nl)),
                                          _np(ref.limb_weights(f, nl)))


def test_check_device_prime():
    class Big:
        p = 0xFFFFFFFB + 2

    mm.check_device_prime(field(4294967291))
    with pytest.raises(NotImplementedError):
        mm.check_device_prime(Big())
