"""The chessboard configuration (``configs/simc_ch7-9.b3.json``,
``gen/chessboard.py``) on the CPU: the generator against the closed-form
ranks of small chessboard complexes and the reference, its sign-scaled
copies, the program against the reference on them, the new metrics'
readers, and a whole mini run of the cell at a board of 5 x 7."""

import argparse
import json

import numpy as np
import pytest

import conftest
import harness
import reference
from gen import chessboard as cb

CELL = "ch7-9.b3-p42013"
CONFIG = "simc_ch7-9.b3"
P = 42013
NEW_METRICS = ("schur_reduce_s", "schur_eliminate_s", "finish_tail_s",
               "stream_block_ms", "finish_skip_share")


@pytest.mark.parametrize("m,n,d,rank", [(5, 6, 3, 929), (4, 6, 2, 157),
                                        (5, 7, 3, 1714)])
def test_closed_form_ranks(m, n, d, rank):
    """ch5-6.b3 and two more boards whose complexes are connected enough:
    the shape is the placements of d + 1 and d rooks, d + 1 entries +-1 a
    row, and the reference's rank is the closed form's."""
    B = cb.chessboard_boundary(m, n, d)
    assert B.shape == (cb.face_count(m, n, d + 1), cb.face_count(m, n, d))
    assert B.nnz == (d + 1) * B.shape[0]
    assert set(np.abs(B.data).tolist()) == {1}
    assert cb.closed_form_rank(m, n, d) == rank
    assert reference.reference_rank(B, P, "cpu") == rank


def test_boundary_of_a_boundary_is_zero():
    A, B = cb.chessboard_boundary(5, 6, 3), cb.chessboard_boundary(5, 6, 2)
    assert abs(A @ B).max() == 0


def test_configuration_file():
    """The file's shape, nonzeros and rank are the definition's."""
    cfg = harness.load_json(f"{conftest.PB}/configs/{CONFIG}.json")
    m, n, d = cfg["rows"], cfg["cols"], cfg["degree"]
    assert (m, n, d) == (7, 9, 3) and cfg["reduced"] == []
    assert cfg["rank"] == cb.closed_form_rank(m, n, d) == 16_190
    B = cb.chessboard_boundary(m, n, d)
    assert list(B.shape) == cfg["shape"] == [105_840, 17_640]
    assert B.nnz == cfg["nnz"] == 423_360
    with pytest.raises(ValueError):
        cb.closed_form_rank(m, n, 5)     # beyond the connectivity


def test_sign_scaled_copies_keep_pattern_and_rank():
    B = cb.chessboard_boundary(5, 6, 3)
    rng = np.random.default_rng(2**40 + 3)
    copies = [cb.sign_scaled(B, rng) for _ in range(2)]
    for C in copies:
        np.testing.assert_array_equal(C.indptr, B.indptr)
        np.testing.assert_array_equal(C.indices, B.indices)
        assert set(np.abs(C.data).tolist()) == {1}
        assert reference.reference_rank(C, P, "cpu") == 929
    assert (copies[0] != copies[1]).nnz > 0
    assert (copies[0] != B).nnz > 0


def test_make_pool():
    cfg = {"rows": 5, "cols": 6, "degree": 3}
    pool = cb.make_pool(cfg, {"p": P, "pool": 3},
                        np.random.default_rng(9), "cpu")
    assert pool["p"] == P and len(pool["matrices"]) == 3
    assert pool["base_of"] == [0, 0, 0] and len(pool["bases"]) == 1
    again = cb.make_pool(cfg, {"p": P, "pool": 3},
                         np.random.default_rng(9), "cpu")
    for a, b in zip(pool["matrices"], again["matrices"]):
        assert (a != b).nnz == 0


@pytest.mark.parametrize("m,n,streaming", [(5, 6, False), (5, 7, False),
                                           (5, 7, True)])
def test_program_against_the_reference(m, n, streaming, monkeypatch):
    """The program's echelon form of a sign-scaled copy, on the host block
    loop or (``streaming``) the streaming loop with its tail check, judged
    by the reference: the rank, the form and the residual."""
    import spasm_tpu_torch as program
    from spasm_tpu_torch.ops import dense

    if streaming:
        monkeypatch.setattr(dense, "HOST_CUTOFF", 1)
    B = cb.chessboard_boundary(m, n, 3)
    A = cb.sign_scaled(B, np.random.default_rng(m * n))
    lu = program.echelonize(program.SparseGFp.from_scipy(
        A, P, assume_canonical=True), device="cpu")
    st = program.last_phase_stats()
    assert st["finish_streamed"] == int(streaming)
    out = harness.lu_output(lu)
    assert out["r"] == reference.reference_rank(A, P, "cpu")
    assert reference.form_faults(out, *A.shape, P) == 0
    assert reference.residual_nonzeros(A, out, P, 4,
                                       np.random.default_rng(1)) == 0


def _reader(name):
    return harness.load_module(f"{conftest.PB}/metrics/{name}.py")


def test_new_metrics_read_nothing_without_the_program_s_keys():
    """A program without the new spans and counts (the parent's) gives
    each new metric nothing, and no error."""
    old = {"total_s": 1.0, "schur_s": 0.2, "finish_wait_s": 0.5}
    record = {"phase_stats": [old, old], "walls": [1.0, 1.0]}
    for name in NEW_METRICS:
        assert _reader(name).read(record) is None, name


def test_new_metrics_from_the_counts():
    calls = [{"schur_reduce_s": 0.1, "schur_eliminate_s": 0.4,
              "finish_wait_s": 2.0, "finish_tail_s": 0.5,
              "finish_blocks": 50, "finish_rows": 1000,
              "finish_rows_skipped": 100},
             {"schur_reduce_s": 0.3, "schur_eliminate_s": 0.6,
              "finish_wait_s": 1.0, "finish_tail_s": 0.0,
              "finish_blocks": 50, "finish_rows": 1000,
              "finish_rows_skipped": 300}]
    record = {"phase_stats": calls}
    got = {name: _reader(name).read(record) for name in NEW_METRICS}
    assert got == pytest.approx({
        "schur_reduce_s": 0.2, "schur_eliminate_s": 0.5,
        "finish_tail_s": 0.25, "stream_block_ms": 25.0,
        "finish_skip_share": 0.2})


def test_mini_run_of_the_cell(mini, monkeypatch):
    """A whole run of the cell on the CPU at a board of 5 x 7, its finish
    sent to the streaming loop: correct, the end-to-end metrics untraced,
    and with --trace 1 every per-layer metric the cell lists that the CPU
    can read."""
    import spasm_tpu_torch
    from spasm_tpu_torch.ops import dense

    monkeypatch.setattr(dense, "HOST_CUTOFF", 1)
    path = mini / "portbench" / "configs" / f"{CONFIG}.json"
    path.write_text(json.dumps(dict(json.loads(path.read_text()), rows=5,
                                    cols=7)))
    files = harness.cell(CELL, here=str(mini / "portbench"), root=str(mini))
    assert files["config"]["rows"] == 5
    per_layer = {m["name"] for m, _ in files["metrics"]["per_layer"]}
    assert set(NEW_METRICS) <= per_layer
    # the device trace's readers find no kernel of the card here
    on_host = {m["name"] for m, _ in files["metrics"]["per_layer"]
               if m["source"] != "device_trace"}
    for trace in (0, 1):
        args = argparse.Namespace(workload=CELL, seed=2**33 + 1,
                                  seconds=0.3, trace=trace)
        res = harness.run(args, device="cpu", program=spasm_tpu_torch,
                          cell_files=files, log=lambda msg: None)
        assert res["correct"] and res["failed"] == 0, res["checks"]
        got = set(res["metrics"])
        if trace:
            assert on_host <= got <= per_layer, on_host - got
            assert 0 < res["metrics"]["finish_skip_share"]["value"] < 1
            assert res["metrics"]["stream_block_ms"]["value"] > 0
        else:
            assert got == {"echelonize_s", "setup_s"}
