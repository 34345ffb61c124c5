"""Port's plain mod-p matmul (spasm_tpu_torch.ops.matmul) against the
big-int oracle, the JAX package's jnp limb path and its Pallas kernel in
interpret mode, exactly."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from spasm_tpu.field import field, num_limbs
from spasm_tpu.ops import matmul as ref_matmul
from spasm_tpu.ops import modmul as ref_modmul
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


# ---- the split and the fold schedule of the CUDA kernels, on the CPU

LIMB_PRIMES = [5, 42013, 92681, 2147483629, 4294967291]   # nl = 1 .. 5


def _extremes(f, shape, rng):
    """f.rand with the ends of the balanced range planted (at p =
    4294967291 they are the int32 extremes tier-C values reach)."""
    x = f.rand(shape, rng).astype(np.int32)
    half = (f.p - 1) // 2
    x.flat[:4] = (half, -half, half - 1, 0)
    return x


@pytest.mark.parametrize("transpose", [False, True])
@pytest.mark.parametrize("p", LIMB_PRIMES)
def test_pack_planes_plain_matches_jax_to_limbs(p, transpose, rng):
    # plane by plane against the JAX package's to_limbs (tolerance 0), the
    # padding zero, B transposed; x a strided view
    f = field(p)
    nl = num_limbs(p)
    assert nl == LIMB_PRIMES.index(p) + 1
    x = _extremes(f, (37, 150), rng)[:, 5:135]            # (37, 130)
    want = np.moveaxis(np.asarray(ref_modmul.to_limbs(
        f, jnp.asarray(x, jnp.int32), nl)), -1, 0)        # (nl, 37, 130)
    if transpose:
        want = want.transpose(0, 2, 1)
    rows, cols = (160, 128) if transpose else (128, 256)
    got = cuda_matmul.pack_planes_plain(f, torch.from_numpy(x), nl, rows,
                                        cols, transpose).numpy()
    assert got.dtype == np.int8 and got.shape == (nl, rows, cols)
    r, c = want.shape[1:]
    np.testing.assert_array_equal(got[:, :r, :c], want)
    assert not got[:, r:].any() and not got[:, :, c:].any()
    # the planes put the operand together again
    back = sum(got[i, :r, :c].astype(np.int64) * 256 ** i for i in range(nl))
    np.testing.assert_array_equal(back, x.T if transpose else x)


@pytest.mark.parametrize("p", LIMB_PRIMES)
def test_packed_planes_product_matches_plain_and_jax(p, rng):
    # sum over the limb diagonals of the packed planes' products, with
    # limb_weights, against modmatmul_plain and the JAX modmatmul
    f = field(p)
    nl = num_limbs(p)
    n, k, m = 130, 260, 140
    a, b = _extremes(f, (n, k), rng), _extremes(f, (k, m), rng)
    np_, kp, mp = cuda_matmul.padded(n, k, m, nl)
    assert (np_ % cuda_matmul.BM, kp % cuda_matmul.BK,
            mp % cuda_matmul.BN[nl]) == (0, 0, 0)
    ap = cuda_matmul.pack_planes_plain(f, torch.from_numpy(a), nl, np_, kp)
    bp = cuda_matmul.pack_planes_plain(f, torch.from_numpy(b), nl, mp, kp,
                                       transpose=True)
    w = [int(x) for x in np.asarray(ref_modmul.limb_weights(f, nl))]
    A, B = ap.numpy().astype(np.int64), bp.numpy().astype(np.int64)
    tot = np.zeros((np_, mp), dtype=object)
    for i in range(nl):
        for j in range(nl):
            tot = tot + (A[i] @ B[j].T).astype(object) * w[i + j]
    got = f.normalize(tot)[:n, :m].astype(np.int64)
    assert not f.normalize(tot)[n:].any() and not f.normalize(tot)[:, m:].any()
    np.testing.assert_array_equal(got, _plain(f, a, b).numpy())
    want = ref_matmul.modmatmul(f, jnp.asarray(a, jnp.int32),
                                jnp.asarray(b, jnp.int32), force="jnp")
    np.testing.assert_array_equal(got, np.asarray(want))
    np.testing.assert_array_equal(
        cuda_matmul.product_plain(f, ap, bp, n, m).numpy(), got)


@pytest.mark.parametrize("n,k,m,p", [(40, 140_000, 48, 5),
                                     (40, 30_000, 48, 4294967291)])
def test_fold_schedule_model_long_k(n, k, m, p, rng):
    # the product kernel's schedule (fold the int32 diagonals into C every
    # fold_interval of k, last fold at the end) at the two long-k shapes
    # of chip_smoke.py: at least one fold inside the loop, no diagonal
    # beyond int32 (product_plain raises), and the plain version's bits
    f = field(p)
    nl = num_limbs(p)
    step = cuda_matmul.fold_interval(nl)
    assert step % cuda_matmul.BK == 0 and step < k
    assert nl * 16384 * step < 2 ** 31 <= nl * 16384 * (step + cuda_matmul.BK)
    a, b = _extremes(f, (n, k), rng), _extremes(f, (k, m), rng)
    np_, kp, mp = cuda_matmul.padded(n, k, m, nl)
    ap = cuda_matmul.pack_planes_plain(f, torch.from_numpy(a), nl, np_, kp)
    bp = cuda_matmul.pack_planes_plain(f, torch.from_numpy(b), nl, mp, kp,
                                       transpose=True)
    got = cuda_matmul.product_plain(f, ap, bp, n, m)
    assert torch.equal(got, _plain(f, a, b))


def test_fold_interval_is_the_overflow_bound():
    # with every limb at -128 a diagonal grows by nl * 128 * 128 per unit
    # of k: one interval stays inside int32, one more k stage would not
    for nl in range(1, 6):
        step = cuda_matmul.fold_interval(nl)
        ap = torch.full((nl, 128, step), -128, dtype=torch.int8)
        f = field(LIMB_PRIMES[nl - 1])
        cuda_matmul.product_plain(f, ap[:, :1], ap[:, :1], 1, 1)
        assert nl * 16384 * (step + cuda_matmul.BK) >= 2 ** 31


def test_cuda_wrappers_raise_off_the_card(rng):
    f = field(42013)
    x = torch.zeros((4, 4), dtype=torch.int32)
    for call in (lambda: cuda_matmul.split_cuda(x, 2, 128, 128),
                 lambda: cuda_matmul.product_cuda(
                     f, torch.zeros((2, 128, 128), dtype=torch.int8),
                     torch.zeros((2, 128, 128), dtype=torch.int8), 4, 4)):
        with pytest.raises(ValueError):
            call()


@pytest.mark.parametrize("p", [5, 42013, 2147483629, 4294967291])
@pytest.mark.parametrize("helper", ["modmatvec", "modvecmat",
                                    "count_nonzero_device"])
def test_helpers_match_reference(helper, p, rng):
    from spasm_tpu.ops import dense as ref_dense

    from spasm_tpu_torch.ops import dense as port_dense

    f = field(p)
    a = f.rand((70, 90), rng)
    a[rng.random(a.shape) < 0.3] = 0
    x, y = f.rand(90, rng), f.rand(70, rng)
    ta = torch.from_numpy(a.astype(np.int32))
    ja = jnp.asarray(a, jnp.int32)
    if helper == "count_nonzero_device":
        got = port_dense.count_nonzero_device(ta)
        assert got == ref_dense.count_nonzero_device(ja) == np.count_nonzero(a)
        return
    v = x if helper == "modmatvec" else y
    tv = torch.from_numpy(v.astype(np.int32))
    jv = jnp.asarray(v, jnp.int32)
    args_t, args_j = ((ta, tv), (ja, jv)) if helper == "modmatvec" else (
        (tv, ta), (jv, ja))
    got = getattr(mm, helper)(f, *args_t)
    want = np.asarray(getattr(ref_matmul, helper)(f, *args_j))
    assert got.dtype == torch.int32 and got.shape == want.shape
    np.testing.assert_array_equal(got.numpy(), want)
    oracle = (_oracle(f, a, x[:, None])[:, 0] if helper == "modmatvec"
              else _oracle(f, y[None, :], a)[0])
    np.testing.assert_array_equal(got.numpy(), oracle)
