"""CPU tests of the benchmark.  They drive whole runs on the CPU at tiny
sizes (``mini``: a copy of the benchmark's files beside a BENCHMARK.json
of tiny cells); the tests marked ``cuda`` need the card and skip here."""

import copy
import json
import os
import shutil
import sys

import pytest

HERE = os.path.dirname(os.path.abspath(__file__))
PB = os.path.dirname(HERE)
ROOT = os.path.dirname(PB)
sys.path[:0] = [PB, ROOT]


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "cuda: needs an NVIDIA card; skips without one")


@pytest.fixture
def card():
    import torch

    if not torch.cuda.is_available():
        pytest.skip("no CUDA device")
    return "cuda"


def bench() -> dict:
    with open(os.path.join(ROOT, "BENCHMARK.json")) as fh:
        return json.load(fh)


TINY_CONFIGS = {"random_sparse": {"n": 220, "m": 220, "density": 0.05}}
TINY_TRAFFIC = {"planted_rows": 6, "pool": 3}


@pytest.fixture
def mini(tmp_path):
    """A checkout-like directory: BENCHMARK.json and a copy of portbench/
    whose configurations and traffic are cut to a CPU test's size."""
    root = tmp_path / "checkout"
    here = root / "portbench"
    shutil.copytree(PB, here, ignore=shutil.ignore_patterns(
        "tests", "__pycache__"))
    b = copy.deepcopy(bench())
    (root / "BENCHMARK.json").write_text(json.dumps(b, indent=1))
    for name, cut in TINY_CONFIGS.items():
        path = here / "configs" / f"{name}.json"
        cfg = json.loads(path.read_text())
        cfg.update(cut)
        path.write_text(json.dumps(cfg))
    for path in (here / "traffic").glob("*.json"):
        tf = json.loads(path.read_text())
        tf.update({k: v for k, v in TINY_TRAFFIC.items() if k in tf})
        path.write_text(json.dumps(tf))
    return root
