"""The benchmark's generators: the boundary generators equal the program's
own fixtures at small sizes, so a later change to the program cannot move
the yardstick unseen (a change to either side fails here); the random
draws are made from the seed alone and have the rank they are built to
have."""

from math import comb

import numpy as np
import pytest

import harness

rs = harness.load_module(f"{harness.HERE}/gen/random_sparse.py")
bd = harness.load_module(f"{harness.HERE}/gen/boundary.py")


def same(a, b):
    a, b = a.tocsr(), b.to_scipy().tocsr() if hasattr(b, "to_scipy") else b
    return (a.shape == b.shape and np.array_equal(a.indptr, b.indptr)
            and np.array_equal(a.indices, b.indices)
            and np.array_equal(a.data, b.data))


@pytest.mark.parametrize("p", [42013, 2147483629])
@pytest.mark.parametrize("n, m, d", [(300, 200, 0.05), (2000, 1500, 0.002)])
def test_draw_is_canonical_and_iid(p, n, m, d):
    """The pattern's density and the values: nonzero, balanced, spread over
    GF(p); indices sorted, no explicit zeros, as the program takes them."""
    A = rs.draw(p, n, m, d, 0, 11, "cpu")
    assert A.shape == (n, m) and A.has_canonical_format
    assert (A.data != 0).all() and np.abs(A.data).max() <= p // 2
    assert (A.data < 0).any() and (A.data > 0).any()
    k = n * m * d
    assert abs(A.nnz - k) < 5 * np.sqrt(k)


def test_planted_rows_are_dependent():
    import reference

    p = 42013
    A = rs.draw(p, 150, 150, 0.1, 5, 2, "cpu")
    assert A.has_canonical_format
    assert np.abs(A.data).max() <= p // 2
    assert reference.reference_rank(A, p, "cpu") == 145


@pytest.mark.parametrize("n, k", [(9, 3), (12, 5), (14, 4)])
def test_simplex_boundary_is_the_programs(n, k):
    from spasm_tpu_torch._host import fixtures

    assert same(bd.simplex_boundary(n, k), fixtures.simplex_boundary(n, k))


@pytest.mark.parametrize("n, k, keep, seed", [(9, 3, 0.8, 3),
                                              (12, 5, 0.9, 1)])
def test_subcomplex_boundary_is_the_programs(n, k, keep, seed):
    from spasm_tpu_torch._host import fixtures

    assert same(bd.subcomplex_boundary(n, k, keep, seed),
                fixtures.subcomplex_boundary(n, k, keep, seed))


def test_unit_scaling_keeps_pattern_and_rank():
    import reference

    p = 42013
    B = bd.simplex_boundary(8, 3)
    S = bd.unit_scaled(B, p, np.random.default_rng(4))
    assert np.array_equal(S.indptr, B.indptr)
    assert np.array_equal(S.indices, B.indices)
    assert (S.data != 0).all() and not np.isin(S.data, [-1, 1]).all()
    assert reference.reference_rank(S, p, "cpu") == comb(7, 3)


def test_pool_is_made_from_the_seed():
    import json

    cfg = dict(json.load(open(f"{harness.HERE}/configs/random_sparse.json")),
               n=120, m=120, density=0.05)
    tf = dict(json.load(open(
        f"{harness.HERE}/traffic/planted64-p42013.json")), planted_rows=4,
        pool=3)
    a = rs.make_pool(cfg, tf, np.random.default_rng(2**40 + 3), "cpu")
    b = rs.make_pool(cfg, tf, np.random.default_rng(2**40 + 3), "cpu")
    c = rs.make_pool(cfg, tf, np.random.default_rng(2**40 + 4), "cpu")
    assert all(same(x, y) for x, y in zip(a["matrices"], b["matrices"]))
    assert not same(a["matrices"][0], c["matrices"][0])
    assert not same(a["matrices"][0], a["matrices"][1])
