"""The port's CLI (python -m spasm_tpu_torch.cli, --device cpu) against the
JAX package's (python -m spasm_tpu.cli): the ten tools run in-process
through main(argv) on the same inputs give the same stdout bytes, the same
result lines on stderr, the same side files and the same exit codes; one
tool runs as a subprocess.  Modelled on tests/test_cli.py."""

import io
import os
import subprocess
import sys

import numpy as np
import pytest

import spasm_tpu as st
from spasm_tpu import SparseGFp, field
from spasm_tpu import fixtures as fx
from spasm_tpu.certificate import (certificate_rank_create,
                                   rank_certificate_save)
from spasm_tpu.cli.main import main as ref_main
from spasm_tpu.utils import logging as ref_log

from spasm_tpu_torch._host.utils import logging as port_log
from spasm_tpu_torch.cli.main import main as port_main

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
F = field(42013)
# the lines a tool prints on stderr as its result (the others are logs)
RESULT_PREFIXES = (b"rank = ", b"ok = ", b"certificate ", b"note: ")


def run(main, argv, stdin=b""):
    """(exit code, stdout bytes, result lines of stderr) of main(argv)."""
    saved = sys.stdin, sys.stdout, sys.stderr
    streams = [io.TextIOWrapper(io.BytesIO(stdin)),
               io.TextIOWrapper(io.BytesIO(), write_through=True),
               io.TextIOWrapper(io.BytesIO(), write_through=True)]
    sys.stdin, sys.stdout, sys.stderr = streams
    try:
        rc = main(argv)
    finally:
        sys.stdin, sys.stdout, sys.stderr = saved
        ref_log.set_log(None)  # the rank tool turns logging on
        port_log.set_log(None)
    for s in streams:
        s.flush()
    out, err = (s.detach().getvalue() for s in streams[1:])
    lines = [ln for ln in err.splitlines() if ln.startswith(RESULT_PREFIXES)]
    return rc, out, lines


def run_both(argv, stdin=b"", port_argv=None):
    """Run a tool in both packages; assert the same outcome; return it."""
    want = run(ref_main, argv, stdin)
    got = run(port_main, (port_argv or argv) + ["--device", "cpu"], stdin)
    assert got == want
    return got


MATRICES = {
    "readme": lambda: SparseGFp.from_dense([[1, 3], [2, 6]], 42013),
    "mixed": lambda: fx.mixed_block_matrix(F, seed=1),
    "low_rank": lambda: (SparseGFp.rand(F, 50, 7, 0.4,
                                        np.random.default_rng(40))
                         @ SparseGFp.rand(F, 7, 45, 0.4,
                                          np.random.default_rng(41))),
}


@pytest.fixture(scope="module", params=sorted(MATRICES))
def sms(request):
    return request.param, st.dumps_sms(MATRICES[request.param]())


def test_rank_tool(sms):
    name, data = sms
    rc, _, lines = run_both(["rank"], data)
    assert rc == 0 and lines == [
        f"rank = {st.rank(MATRICES[name]())}".encode()]


@pytest.mark.parametrize("tool", ["kernel", "echelonize"])
def test_kernel_and_echelonize_tools(tool, sms, tmp_path):
    _, data = sms
    qr, qp = str(tmp_path / "ref.txt"), str(tmp_path / "port.txt")
    run_both([tool, "--qinv-file", qr], data,
             port_argv=[tool, "--qinv-file", qp])
    assert open(qr, "rb").read() == open(qp, "rb").read()


@pytest.mark.parametrize("tool", ["dm", "transpose", "vertical_swap"])
def test_structural_tools(tool, sms):
    run_both([tool], sms[1])


def test_bitmap_tool(sms, tmp_path):
    pr, pp = str(tmp_path / "ref.pgm"), str(tmp_path / "port.pgm")
    run_both(["bitmap", "--x", "40", "--y", "30", "--output", pr], sms[1],
             port_argv=["bitmap", "--x", "40", "--y", "30", "--output", pp])
    assert open(pr, "rb").read() == open(pp, "rb").read()


def test_stack_tool(tmp_path):
    a, b = str(tmp_path / "a.sms"), str(tmp_path / "b.sms")
    st.save_sms(MATRICES["low_rank"](), a)
    st.save_sms(SparseGFp.rand(F, 9, 45, 0.2, np.random.default_rng(42)), b)
    want = run(ref_main, ["stack", a, b])
    assert run(port_main, ["stack", a, b]) == want
    assert want[0] == 0 and want[1]


@pytest.mark.parametrize("name", ["mixed", "low_rank"])
def test_solve_tool(name, tmp_path):
    A = MATRICES[name]()
    am = str(tmp_path / "a.sms")
    st.save_sms(A, am)
    rng = np.random.default_rng(43)
    B = SparseGFp.rand(F, 4, A.n, 0.5, rng) @ A
    rc, out, lines = run_both(["solve", "--matrix", am], st.dumps_sms(B))
    assert rc == 0 and lines == [b"ok = 1111"]
    # with a row that has no solution: exit code 1
    B = B.vstack(SparseGFp.rand(F, 1, A.m, 0.9, rng))
    rc, _, lines = run_both(["solve", "--matrix", am], st.dumps_sms(B))
    assert rc == 1 and lines == [b"ok = 11110"]


def test_check_cert_tool(tmp_path):
    A = MATRICES["mixed"]()
    path = str(tmp_path / "m.sms")
    st.save_sms(A, path)
    A2, _ = st.load_sms(path, 42013, get_hash=True)
    good = str(tmp_path / "good.txt")
    rank_certificate_save(certificate_rank_create(A2, st.matrix_hash(A2)),
                          good)
    rc, _, lines = run_both(["check_cert", "--cert", good, path])
    assert rc == 0 and lines == [b"certificate OK"]
    cert = certificate_rank_create(A2, st.matrix_hash(A2), variant="BE-MEM")
    foreign = str(tmp_path / "foreign.txt")
    rank_certificate_save(cert, foreign)
    rc, _, lines = run_both(["check_cert", "--cert", foreign, path])
    assert rc == 0 and lines[-1] == b"certificate OK"
    cert.y[0] = F.normalize(cert.y[0] + 1)
    bad = str(tmp_path / "bad.txt")
    rank_certificate_save(cert, bad)
    rc, _, lines = run_both(["check_cert", "--cert", bad, path])
    assert rc == 1 and lines == [b"certificate INVALID"]


def test_cli_subprocess_matches_reference(tmp_path):
    data = st.dumps_sms(MATRICES["mixed"]())
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    out = subprocess.run(
        [sys.executable, "-m", "spasm_tpu_torch.cli", "kernel", "--device",
         "cpu"], input=data, capture_output=True, timeout=300, cwd=REPO,
        env=env)
    assert out.returncode == 0, out.stderr
    rc, want, lines = run(ref_main, ["kernel"], data)
    assert out.stdout == want
    assert [ln for ln in out.stderr.splitlines()
            if ln.startswith(RESULT_PREFIXES)] == lines
