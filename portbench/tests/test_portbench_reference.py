"""The plain reference: exact ranks, the checks of an echelon form, and
the control (echelon forms with float32 products) that has to come out as
not correct through the harness's comparison."""

from math import comb

import numpy as np
import pytest
import torch

import conftest
import control
import harness
import reference

CELLS = [w["name"] for w in conftest.bench()["workloads"]]

rs = harness.load_module(f"{harness.HERE}/gen/random_sparse.py")
bd = harness.load_module(f"{harness.HERE}/gen/boundary.py")


@pytest.mark.parametrize("n, k", [(7, 2), (9, 3), (10, 4), (11, 5)])
def test_simplex_rank_is_closed_form(n, k):
    """The boundary of the full simplex has rank C(n-1, k), also scaled by
    units."""
    p = 42013
    B = bd.simplex_boundary(n, k).astype(np.int64)
    assert reference.reference_rank(B, p, "cpu") == comb(n - 1, k)
    S = bd.unit_scaled(B, p, np.random.default_rng(n))
    assert reference.reference_rank(S, p, "cpu") == comb(n - 1, k)


@pytest.mark.parametrize("p", [42013, 2147483629])
def test_matmul_mod_is_exact(p):
    rng = np.random.default_rng(1)
    a = rng.integers(0, p, size=(9, 300))
    b = rng.integers(0, p, size=(300, 7))
    want = np.array([[sum(int(x) * int(y) for x, y in zip(a[i], b[:, j]))
                      % p for j in range(7)] for i in range(9)])
    got = reference.matmul_mod(torch.from_numpy(a), torch.from_numpy(b), p)
    assert np.array_equal(got.numpy(), want)


def small_cases():
    p = 42013
    yield "random", p, rs.draw(p, 160, 160, 0.06, 6, 3, "cpu")
    q = 2147483629
    yield "random-bigp", q, rs.draw(q, 160, 160, 0.06, 6, 5, "cpu")
    B = bd.subcomplex_boundary(12, 4, 0.9, 2).astype(np.int64)
    yield "subcomplex", p, bd.unit_scaled(B, p, np.random.default_rng(7))


@pytest.mark.parametrize("case", list(small_cases()), ids=lambda c: c[0])
def test_program_output_passes_and_alterations_fail(case):
    import spasm_tpu_torch as stt

    _, p, A = case
    lu = stt.echelonize(stt.SparseGFp.from_scipy(A, p), device="cpu")
    out = harness.lu_output(lu)
    assert lu.r == reference.reference_rank(A, p, "cpu")
    assert reference.form_faults(out, *A.shape, p) == 0
    rng = np.random.default_rng(1)
    assert reference.residual_nonzeros(A, out, p, 4, rng) == 0
    # a value of U altered: the row space moves
    U = out["U"].copy()
    U.data[U.nnz // 3] = (U.data[U.nnz // 3] + 5) % p
    bad = dict(out, U=U)
    assert (reference.form_faults(bad, *A.shape, p)
            + reference.residual_nonzeros(A, bad, p, 4, rng)) > 0
    # a pivot row dropped: a row of A falls outside the row space
    keep = np.arange(1, lu.r)
    short = dict(out, r=lu.r - 1, U=out["U"][keep],
                 piv_cols=out["piv_cols"][keep], p=out["p"][keep])
    short["qinv"] = np.full(A.shape[1], -1)
    short["qinv"][short["piv_cols"]] = np.arange(lu.r - 1)
    assert reference.form_faults(short, *A.shape, p) == 0
    assert reference.residual_nonzeros(A, short, p, 4, rng) > 0


@pytest.mark.parametrize("name", CELLS)
def test_control_is_not_correct(mini, name):
    """The reference's echelon forms with float32 products (the control),
    put in the program's place on a cell's pool, come out as not correct
    through the harness's own comparison; the same forms computed exactly
    come out as correct."""
    files = harness.cell(name, here=str(mini / "portbench"), root=str(mini))
    for seed in (2**31 + 7, 12):
        ctrl = control.verdict(files, seed, "cpu")
        assert ctrl["correct"] is False
        assert ctrl["failed"] == ctrl["attempted"] > 0
        assert any(v["value"] > v["limit"] for v in ctrl["checks"].values())
        exact = control.verdict(files, seed, "cpu", arith="exact")
        assert exact["correct"] is True


@pytest.mark.parametrize("case", list(small_cases()), ids=lambda c: c[0])
def test_exact_echelon_form_passes(case):
    """``echelon_form`` computed exactly is a sound output: the control's
    failure comes from its arithmetic, not from the form it builds."""
    _, p, A = case
    out = reference.echelon_form(A, p, "cpu")
    assert out["r"] == reference.reference_rank(A, p, "cpu")
    assert reference.form_faults(out, *A.shape, p) == 0
    assert reference.residual_nonzeros(A, out, p, 4,
                                       np.random.default_rng(2)) == 0
