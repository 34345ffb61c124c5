"""The greedy cycle-free completion of the port's structural pivot search
in C (``_host/csrc/greedy_mod.c`` through ``native.greedy_pivots_native``)
against the JAX package's NumPy formulation (``spasm_tpu.pivots``): the
same pivots in the same order, the same positions, and the four state
arrays updated to the same values, on every kind of input the rule
distinguishes; the NumPy fallback where the library is unavailable; and
the counts ``last_phase_stats()`` keeps of both."""

import importlib
import importlib.util
import os
import subprocess
import sys

import numpy as np
import pytest
import scipy.sparse as sp

from spasm_tpu import pivots as ref_pivots
from spasm_tpu.csr import SparseGFp as RefSparse
from spasm_tpu_torch._host import fixtures, native, pivots
from spasm_tpu_torch._host.csr import SparseGFp

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _cell_draw(p, n, seed):
    """The benchmark cell's family (portbench/gen/random_sparse.py) at
    n x n: density 0.02, n / 128 planted rows."""
    spec = importlib.util.spec_from_file_location(
        "_random_sparse", os.path.join(ROOT, "portbench", "gen",
                                       "random_sparse.py"))
    gen = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(gen)
    return gen.draw(p, n, n, 0.02, n // 128, seed, "cpu")


def _chain(n, m, width, span, seed):
    """Overlapping windows: row k holds ``width`` columns drawn from the
    ``span`` columns after a random start (mod m), so supports overlap
    in long chains and wrap past the last column: the structure the
    fractional insertion serves, and where FL leaves the greedy work."""
    rng = np.random.default_rng(seed)
    start = rng.integers(0, m, n)
    off = np.sort(np.argsort(rng.random((n, span)), axis=1)[:, :width],
                  axis=1)
    j = (start[:, None] + off) % m
    M = sp.csr_matrix((rng.integers(1, 97, n * width),
                       (np.repeat(np.arange(n), width), j.ravel())),
                      shape=(n, m))
    M.sort_indices()
    return M


def _pair(M, p):
    M = sp.csr_matrix(M)
    return (RefSparse.from_scipy(M, p, assume_canonical=True),
            SparseGFp.from_scipy(M, p, assume_canonical=True))


def _state(A):
    """The state find_structural_pivots hands the greedy completion: the
    FL row and column pivots selected, at positions 0, 1, ..."""
    n, m = A.shape
    fl_r, fl_c = ref_pivots.fl_row_pivots(A)
    col_selected = np.zeros(m, bool)
    row_used = np.zeros(n, bool)
    col_selected[fl_c] = True
    row_used[fl_r] = True
    c_r, c_c = ref_pivots.fl_col_pivots(A, col_selected, row_used)
    rows = np.concatenate([fl_r, c_r])
    cols = np.concatenate([fl_c, c_c])
    pos = np.arange(rows.size, dtype=np.float64)
    piv_pos_of_col = np.full(m, np.inf)
    piv_pos_of_col[cols] = pos
    col_touch_max = np.full(m, -np.inf)
    pos_of_row = np.full(n, -np.inf)
    pos_of_row[rows] = pos
    touch = pos_of_row[A.rows_expanded()]
    live = np.isfinite(touch)
    np.maximum.at(col_touch_max, A.indices[live].astype(np.int64),
                  touch[live])
    return col_selected, row_used, pos, piv_pos_of_col, col_touch_max


def _copy(state):
    return tuple(x.copy() for x in state)


def _greedy_both(M, p, state=None, entries=False, **kw):
    """Both packages' greedy_pivots from the same state: equal outputs
    (values and dtypes) and equal state arrays after.  Returns the
    pivots, and the state after."""
    ref_A, port_A = _pair(M, p)
    want_state = _state(ref_A) if state is None else _copy(state)
    got_state = _copy(want_state)
    if entries:
        # the caller-shared compression, taken before the state is final
        re = ref_A.rows_expanded()
        keep = ~want_state[1][re]
        kw_ref = dict(kw, entries=(re[keep],
                                   ref_A.indices[keep].astype(np.int64)))
        re = port_A.rows_expanded()
        kw_port = dict(kw, entries=(re[keep],
                                    port_A.indices[keep].astype(np.int64)))
    else:
        kw_ref = kw_port = kw
    runs = dict(pivots.GREEDY_RUNS)
    want = ref_pivots.greedy_pivots(ref_A, *want_state, **kw_ref)
    got = pivots.greedy_pivots(port_A, *got_state, **kw_port)
    for g, w in zip(got, want):
        assert g.dtype == w.dtype
        np.testing.assert_array_equal(g, w)
    for g, w in zip(got_state, want_state):
        np.testing.assert_array_equal(g, w)
    native_ran = pivots.GREEDY_RUNS["native"] - runs["native"]
    return want, want_state, native_ran


def _find_both(M, p, **kw):
    ref_A, port_A = _pair(M, p)
    want = ref_pivots.find_structural_pivots(ref_A, **kw)
    got = pivots.find_structural_pivots(port_A, **kw)
    np.testing.assert_array_equal(got[0], want[0])
    np.testing.assert_array_equal(got[1], want[1])
    assert got[2] == want[2]
    return want


@pytest.fixture(autouse=True)
def _needs_native():
    if native._load("greedy_mod", native._configure_greedy,
                    extra_flags=("-fopenmp",)) is None:
        pytest.skip("no C compiler for the native greedy completion")


@pytest.mark.parametrize("p", [42013, 2147483629])
@pytest.mark.parametrize("n,seed", [(1024, 1), (1024, 2), (2048, 1),
                                    (2048, 2), (2048, 3)])
def test_cell_family_matches_numpy(n, seed, p):
    M = _cell_draw(p, n, seed)
    (rows, _, _), _, native_ran = _greedy_both(M, p)
    assert native_ran == 1 and rows.size > 0
    counts = _find_both(M, p)[2]
    assert counts["greedy"] == rows.size


def _schur_rounds(A):
    """Every round's Schur complement of the port's echelonize of A."""
    ech = importlib.import_module("spasm_tpu_torch.echelonize")
    seen = []
    orig = ech.find_structural_pivots

    def spy(Sw, **kw):
        seen.append(Sw.to_scipy())
        return orig(Sw, **kw)

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(ech, "find_structural_pivots", spy)
        ech.echelonize(A, device="cpu")
    return seen


@pytest.mark.parametrize("make", [
    lambda: fixtures.simplex_boundary(12, 5),
    lambda: fixtures.subcomplex_boundary(14, 5),
    lambda: fixtures.subcomplex_boundary(18, 6, 0.8),
    lambda: fixtures.subcomplex_boundary(20, 5, 0.7, seed=3),
], ids=["simplex(12,5)", "sub(14,5)", "sub(18,6,.8)", "sub(20,5,.7)"])
def test_every_schur_round_of_boundaries_matches_numpy(make):
    A = make()
    rounds = _schur_rounds(A)
    assert rounds
    for S in rounds:
        _greedy_both(S, A.field.p)
        _find_both(S, A.field.p)


def _mopup_spy(mp, stats):
    """Record, per NumPy mop-up, the pivots it took and the furthest
    candidate (in its lightest-first order) among them."""
    orig = ref_pivots._greedy_sequential

    def spy(A, col_selected, row_used, *args, cap=4096):
        lengths = args[-1]
        cand = np.flatnonzero(~row_used & (lengths > 0))
        cand = cand[np.argsort(lengths[cand], kind="stable")]
        where = np.full(A.n, -1)
        where[cand] = np.arange(cand.size)
        out = orig(A, col_selected, row_used, *args, cap=cap)
        stats.append((out[0].size, int(where[out[0]].max(initial=-1)), cap))
        return out

    mp.setattr(ref_pivots, "_greedy_sequential", spy)


def test_batched_passes_and_several_mopup_batches_match_numpy():
    """A zipf-skewed matrix: the batched passes take thousands of pivots,
    and the mop-up goes on past its first cap-sized batch."""
    M = fixtures.zipf_sparse(42013, 20000, 20000, 8.0, 2.0, 1).to_scipy()
    stats = []
    with pytest.MonkeyPatch.context() as mp:
        _mopup_spy(mp, stats)
        (rows, _, _), _, native_ran = _greedy_both(M, 42013)
    assert native_ran == 1
    ((n_mopup, furthest, cap),) = stats
    assert rows.size - n_mopup > 1000      # the batched passes' share
    assert furthest >= cap                 # a second batch ran
    _find_both(M, 42013)


@pytest.mark.parametrize("n,m,width,span,seed", [(400, 300, 4, 12, 0),
                                                 (1200, 1000, 4, 16, 1),
                                                 (300, 400, 6, 20, 2),
                                                 (3000, 2500, 3, 8, 3)])
def test_chain_matches_numpy(n, m, width, span, seed):
    M = _chain(n, m, width, span, seed)
    (rows, _, _), _, _ = _greedy_both(M, 97)
    assert rows.size > 0
    _find_both(M, 97)


def _unsorted(M):
    """M with each row's columns stored in descending order."""
    M = sp.csr_matrix(M, copy=True)
    M.sort_indices()
    for k in range(M.shape[0]):
        lo, hi = M.indptr[k], M.indptr[k + 1]
        M.indices[lo:hi] = M.indices[lo:hi][::-1].copy()
        M.data[lo:hi] = M.data[lo:hi][::-1].copy()
    M.has_sorted_indices = False
    return M


@pytest.mark.parametrize("case", ["chain", "cell"])
def test_unsorted_rows_match_numpy(case):
    """Columns stored in descending order: the mop-up takes the FIRST
    column of least count in the row's order (np.argmin), the batched
    pass the least (count, column)."""
    M, p = ((_chain(3000, 2500, 3, 8, 3), 97) if case == "chain"
            else (_cell_draw(42013, 1024, 11), 42013))
    M = _unsorted(M)
    ref_A, _ = _pair(M, p)
    assert not np.all(np.diff(ref_A.indices[:3]) > 0)
    (rows, _, _), _, _ = _greedy_both(M, p)
    assert rows.size > 0


@pytest.mark.parametrize("cap", [64, 128, 192, 256, 320, 384])
def test_mopup_batches_at_small_caps_match_numpy(cap, monkeypatch):
    """The mop-up's batch rule (stop after a batch that takes fewer than
    cap / 64 rows) at caps small enough that the draws meet it exactly."""
    orig = ref_pivots._greedy_sequential
    monkeypatch.setattr(ref_pivots, "_greedy_sequential",
                        lambda *a, **k: orig(*a, **dict(k, cap=cap)))
    for seed in (12, 13, 14):
        M = _cell_draw(42013, 1024, seed)
        ref_A, port_A = _pair(M, 42013)
        want_state = _state(ref_A)
        got_state = _copy(want_state)
        want = ref_pivots.greedy_pivots(ref_A, *want_state)
        got = native.greedy_pivots_native(
            port_A.indptr, port_A.indices, got_state[0], got_state[1],
            got_state[3], got_state[4], cap=cap)
        for g, w in zip(list(got) + list(got_state),
                        list(want) + list(want_state)):
            np.testing.assert_array_equal(g, w)


@pytest.mark.parametrize("case", ["cell", "zipf", "chain"])
def test_without_mopup_matches_numpy(case):
    M, p = {"cell": lambda: (_cell_draw(42013, 2048, 4), 42013),
            "zipf": lambda: (fixtures.zipf_sparse(
                42013, 6000, 6000, 8.0, 2.0, 2).to_scipy(), 42013),
            "chain": lambda: (_chain(1200, 1000, 4, 16, 1), 97)}[case]()
    _greedy_both(M, p, mopup=False)
    _greedy_both(M, p, max_passes=1, mopup=False)
    _find_both(M, p, greedy_mopup=False)


def test_exhausted_eligible_set_matches_numpy():
    M = _cell_draw(42013, 1024, 5)
    ref_A, _ = _pair(M, 42013)
    state = _state(ref_A)
    # after a completion, no candidate is left to a second one
    _, after, _ = _greedy_both(M, 42013, state=state)
    (rows, _, pos), after2, _ = _greedy_both(M, 42013, state=after)
    # every column selected: no eligible entry, nothing changes
    full = _copy(state)
    full[0][:] = True
    (rows, _, pos), after3, native_ran = _greedy_both(M, 42013, state=full)
    assert rows.size == 0 and pos.dtype == np.float64 and native_ran == 1
    for a, b in zip(after3, full):
        np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("case", ["cell", "chain"])
def test_from_no_pivots_matches_numpy(case):
    """No pivot selected yet: every row's p2 is +inf, and the positions
    come from the infinite cases of the gap (lo = 0 or p1, hi = lo + 2)."""
    M, p = ((_cell_draw(42013, 1024, 15), 42013) if case == "cell"
            else (_chain(1200, 1000, 4, 16, 1), 97))
    n, m = M.shape
    state = (np.zeros(m, bool), np.zeros(n, bool), np.zeros(0),
             np.full(m, np.inf), np.full(m, -np.inf))
    (rows, _, pos), _, _ = _greedy_both(M, p, state=state)
    assert rows.size > 0 and pos[0] == 1.0


def test_empty_rows_and_empty_pool_match_numpy():
    rng = np.random.default_rng(4)
    M = _cell_draw(42013, 1024, 6).tolil()
    M[rng.choice(1024, 300, replace=False)] = 0      # empty rows
    M = sp.csr_matrix(M)
    M.eliminate_zeros()
    _greedy_both(M, 42013)
    _find_both(M, 42013)
    # no unused row: the pool is empty
    ref_A, _ = _pair(M, 42013)
    state = _state(ref_A)
    state[1][:] = True
    (rows, _, _), _, native_ran = _greedy_both(M, 42013, state=state)
    assert rows.size == 0 and native_ran == 1
    # no entry at all
    Z = sp.csr_matrix((64, 48), dtype=np.int64)
    (rows, cols, pos), _, _ = _greedy_both(Z, 42013)
    assert rows.size == cols.size == pos.size == 0
    _find_both(Z, 42013)


@pytest.mark.parametrize("case", ["cell", "zipf"])
def test_shared_entries_match_numpy(case):
    """entries= (the mesh branch's caller-shared compression, taken before
    FL-cols marked its rows): the native completion reads the CSR."""
    M = (_cell_draw(2147483629, 2048, 7) if case == "cell"
         else fixtures.zipf_sparse(42013, 6000, 6000, 8.0, 2.0, 3).to_scipy())
    p = 2147483629 if case == "cell" else 42013
    _greedy_both(M, p, entries=True)


@pytest.mark.parametrize("case", ["cell", "sub", "chain", "mixed"])
def test_forced_native_scan_matches_numpy(case, monkeypatch):
    """_NATIVE_SCAN_MIN_NNZ = 0 in both packages: the fused scan, then
    the native completion (port) and the NumPy one (JAX package)."""
    monkeypatch.setattr(pivots, "_NATIVE_SCAN_MIN_NNZ", 0)
    monkeypatch.setattr(ref_pivots, "_NATIVE_SCAN_MIN_NNZ", 0)
    M, p = {"cell": lambda: (_cell_draw(42013, 1024, 8), 42013),
            "sub": lambda: (fixtures.subcomplex_boundary(
                18, 6, 0.8).to_scipy(), fixtures.DEFAULT_PRIME),
            "chain": lambda: (_chain(400, 300, 4, 12, 0), 97),
            "mixed": lambda: (fixtures.mixed_block_matrix(
                42013, 0, 2).to_scipy(), 42013)}[case]()
    runs = pivots.GREEDY_RUNS["native"]
    counts = _find_both(M, p)[2]
    assert pivots.GREEDY_RUNS["native"] == runs + (counts["greedy"] > 0)


def test_fallback_without_the_library_matches_numpy(monkeypatch):
    monkeypatch.setitem(native._libs, "greedy_mod", None)
    runs = dict(pivots.GREEDY_RUNS)
    (rows, _, _), _, native_ran = _greedy_both(_cell_draw(42013, 1024, 9),
                                               42013)
    assert native_ran == 0 and rows.size > 0
    assert pivots.GREEDY_RUNS["numpy"] == runs["numpy"] + 1


def test_fallback_for_a_state_not_updatable_in_place():
    """A strided col_touch_max cannot be handed to C to update in place:
    the NumPy body runs, and updates the view."""
    ref_A, port_A = _pair(_cell_draw(42013, 1024, 9), 42013)
    want_state = _state(ref_A)
    got_state = list(_copy(want_state))
    wide = np.empty((port_A.m, 2))
    wide[:, 0] = got_state[4]
    got_state[4] = wide[:, 0]
    runs = dict(pivots.GREEDY_RUNS)
    want = ref_pivots.greedy_pivots(ref_A, *want_state)
    got = pivots.greedy_pivots(port_A, *got_state)
    assert pivots.GREEDY_RUNS["numpy"] == runs["numpy"] + 1
    for g, w in zip(list(got) + got_state, list(want) + list(want_state)):
        np.testing.assert_array_equal(g, w)
    np.testing.assert_array_equal(wide[:, 0], want_state[4])


def test_phase_stats_count_the_native_completion():
    import spasm_tpu_torch as stt

    A = SparseGFp.from_scipy(sp.csr_matrix(_cell_draw(42013, 1024, 10)),
                             42013, assume_canonical=True)
    stt.echelonize(A, device="cpu")
    st = stt.last_phase_stats()
    assert st["greedy_native"] >= 1 and st["greedy_numpy"] == 0


def test_phase_stats_count_the_fallback_under_no_native():
    code = (
        "import numpy as np, scipy.sparse as sp\n"
        "import spasm_tpu_torch as stt\n"
        "A = stt.SparseGFp.rand(stt.field(42013), 600, 600, 0.02,\n"
        "                       np.random.default_rng(1))\n"
        "stt.echelonize(A, device='cpu')\n"
        "st = stt.last_phase_stats()\n"
        "print(st['greedy_native'], st['greedy_numpy'])\n")
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env["SPASM_TPU_NO_NATIVE"] = "1"
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    native_n, numpy_n = map(int, out.stdout.split())
    assert native_n == 0 and numpy_n >= 1
