"""Port's plain mod-p matmul (spasm_tpu_torch.ops.matmul) against the
big-int oracle, the JAX package's jnp limb path and its Pallas kernel in
interpret mode, exactly."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from spasm_tpu.field import field, num_limbs
from spasm_tpu.ops import matmul as ref_matmul
from spasm_tpu.ops.pallas_matmul import modmatmul_pallas

from spasm_tpu_torch.ops import cuda_matmul
from spasm_tpu_torch.ops import matmul as mm

PRIMES = [5, 257, 1031, 42013, 92681, 104729, 16777213, 2147483629,
          4294967291]


def _oracle(f, a, b):
    return f.normalize(a.astype(object) @ b.astype(object)).astype(np.int64)


def _plain(f, a, b):
    return mm.modmatmul_plain(f, torch.from_numpy(a.astype(np.int32)),
                              torch.from_numpy(b.astype(np.int32)))


@pytest.mark.parametrize("p", PRIMES)
def test_plain_matches_oracle_and_jnp(p, rng):
    f = field(p)
    n, k, m = 130, 260, 140  # deliberately unaligned
    a, b = f.rand((n, k), rng), f.rand((k, m), rng)
    got = _plain(f, a, b)
    assert got.dtype == torch.int32 and got.shape == (n, m)
    got = got.numpy().astype(np.int64)
    np.testing.assert_array_equal(got, _oracle(f, a, b))
    want = ref_matmul.modmatmul(f, jnp.asarray(a, jnp.int32),
                                jnp.asarray(b, jnp.int32), force="jnp")
    np.testing.assert_array_equal(got, np.asarray(want))


@pytest.mark.parametrize("p", [5, 257, 42013, 92681, 104729, 2147483629])
def test_plain_matches_pallas_interpret(p, rng):
    f = field(p)
    a, b = f.rand((130, 260), rng), f.rand((260, 140), rng)
    want = np.asarray(modmatmul_pallas(f, jnp.asarray(a, jnp.int32),
                                       jnp.asarray(b, jnp.int32)))
    np.testing.assert_array_equal(_plain(f, a, b).numpy(), want)


@pytest.mark.parametrize("p", [5, 4294967291])
def test_plain_chunked_long_k(p, rng):
    # k beyond one chunk of the plain path (and beyond one pass of the
    # reference's k bound for these limb counts)
    f = field(p)
    k = mm._k_chunk(num_limbs(p)) + 77
    a, b = f.rand((3, k), rng), f.rand((k, 5), rng)
    got = _plain(f, a, b).numpy()
    np.testing.assert_array_equal(got, _oracle(f, a, b))
    want = ref_matmul.modmatmul(f, jnp.asarray(a, jnp.int32),
                                jnp.asarray(b, jnp.int32), force="jnp")
    np.testing.assert_array_equal(got, np.asarray(want))


def test_dispatch_cpu_is_plain(rng):
    f = field(42013)
    a = torch.from_numpy(f.rand((17, 33), rng).astype(np.int32))
    b = torch.from_numpy(f.rand((33, 9), rng).astype(np.int32))
    before = cuda_matmul.launches
    np.testing.assert_array_equal(mm.modmatmul(f, a, b).numpy(),
                                  mm.modmatmul_plain(f, a, b).numpy())
    assert cuda_matmul.launches == before
    with pytest.raises(ValueError):
        cuda_matmul.modmatmul_cuda(f, a, b)   # CPU tensors: no kernel


def test_plain_edge_shapes():
    f = field(42013)
    z = mm.modmatmul_plain(f, torch.zeros((4, 0), dtype=torch.int32),
                           torch.zeros((0, 3), dtype=torch.int32))
    assert z.shape == (4, 3) and not z.any()
    with pytest.raises(ValueError):
        mm.modmatmul_plain(f, torch.zeros((4, 2), dtype=torch.int32),
                           torch.zeros((3, 3), dtype=torch.int32))
