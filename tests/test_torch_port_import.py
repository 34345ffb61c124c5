"""The PyTorch port (spasm_tpu_torch) never imports jax."""

import os
import re
import subprocess
import sys

import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PKG = os.path.join(ROOT, "spasm_tpu_torch")


def test_import_and_readme_rank_without_jax():
    code = (
        "import sys\n"
        "import spasm_tpu_torch as stt\n"
        "A = stt.SparseGFp.from_dense([[1, 3], [2, 6]], 42013)\n"
        "r = stt.rank(A, device='cpu')\n"
        "assert r == 1, r\n"
        "from spasm_tpu_torch.ops import cuda_matmul, cuda_panel, _cuda\n"
        "from spasm_tpu_torch import interop\n"
        "assert 'jax' not in sys.modules, 'jax was imported'\n"
        "assert 'spasm_tpu' not in sys.modules\n"
        "print('ok')\n")
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip().endswith("ok")


@pytest.mark.parametrize("pattern", [r"^\s*import\s+jax\b",
                                     r"^\s*from\s+jax\b",
                                     r"^\s*(from|import)\s+spasm_tpu\b"])
def test_no_jax_import_in_sources(pattern):
    rx = re.compile(pattern, re.M)
    hits = []
    for base, _, files in os.walk(PKG):
        for name in files:
            if name.endswith(".py"):
                path = os.path.join(base, name)
                with open(path) as fh:
                    if rx.search(fh.read()):
                        hits.append(os.path.relpath(path, ROOT))
    assert not hits, hits


def test_host_modules_load_under_port_name():
    from spasm_tpu_torch._host import fixtures, pivots

    assert pivots.__name__ == "spasm_tpu_torch._host.pivots"
    B = fixtures.simplex_boundary(8, 3)
    prows, pcols, _ = pivots.find_structural_pivots(B)
    assert prows.size == pcols.size > 0
