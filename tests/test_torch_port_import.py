"""The PyTorch port (spasm_tpu_torch) never imports jax, nor anything of the
JAX package: its host layer is its own copy, its top-level copies of the
reference's jax-free modules differ only where listed, and its native C
kernels agree with the JAX package's on the same inputs."""

import os
import re
import subprocess
import sys

import numpy as np
import pytest
import scipy.sparse as sp

from spasm_tpu import native as ref_native
from spasm_tpu.field import field as ref_field

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PKG = os.path.join(ROOT, "spasm_tpu_torch")


def _run(code: str) -> str:
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    return out.stdout


def test_import_and_readme_rank_without_jax():
    code = (
        "import sys\n"
        "import spasm_tpu_torch as stt\n"
        "A = stt.SparseGFp.from_dense([[1, 3], [2, 6]], 42013)\n"
        "r = stt.rank(A, device='cpu')\n"
        "assert r == 1, r\n"
        "from spasm_tpu_torch.ops import cuda_matmul, cuda_panel, _cuda\n"
        "from spasm_tpu_torch import certificate, checkpoint, interop\n"
        "from spasm_tpu_torch.parallel import (multihost, sharded,\n"
        "                                      sparse_sharded)\n"
        "from spasm_tpu_torch.ops import spmv, sparse_device\n"
        "from spasm_tpu_torch.utils import profiling\n"
        "from spasm_tpu_torch.cli import main as cli_main\n"
        "import spasm_tpu_torch.cli.__main__\n"
        "assert 'jax' not in sys.modules, 'jax was imported'\n"
        "assert 'spasm_tpu' not in sys.modules\n"
        "print('ok')\n")
    assert _run(code).strip().endswith("ok")


def test_main_path_loads_nothing_outside_the_port():
    # rank, echelonize, SMS I/O, a fixture, B / LU, a kernel, a solve and
    # a certificate: no jax, no spasm_tpu, and every spasm_tpu_torch module
    # from the port's own files
    code = (
        "import io, os, sys\n"
        "import numpy as np\n"
        "import spasm_tpu_torch as stt\n"
        "from spasm_tpu_torch._host.fixtures import simplex_boundary\n"
        "B = simplex_boundary(9, 3)\n"
        "buf = io.BytesIO()\n"
        "stt.save_sms(B, buf)\n"
        "buf.seek(0)\n"
        "B2 = stt.load_sms(buf, 42013)\n"
        "assert (B2.to_scipy() != B.to_scipy()).nnz == 0\n"
        "assert stt.rank(B, device='cpu') == 56\n"
        "lu = stt.echelonize(B, device='cpu', L=True)\n"
        "X = B / lu\n"
        "assert X is not None and X.shape == (B.n, 56)\n"
        "assert (X @ lu.U).to_scipy().nnz == B.nnz\n"
        "assert stt.kernel(lu).n == B.m - 56\n"
        "b = B.xapy(np.arange(B.n) % 7)\n"
        "assert np.array_equal(B.xapy(stt.solve(lu, b)), b)\n"
        "cert = stt.certificate_rank_create(B, fact=lu)\n"
        "assert stt.certificate_rank_verify(B, stt.matrix_hash(B), cert)\n"
        "bad = [m for m in sys.modules if m.split('.')[0] in\n"
        "       ('jax', 'jaxlib', 'spasm_tpu')]\n"
        "assert not bad, bad\n"
        "pkg = os.path.dirname(os.path.abspath(stt.__file__)) + os.sep\n"
        "out = [(n, m.__file__) for n, m in sys.modules.items()\n"
        "       if n.split('.')[0] == 'spasm_tpu_torch'\n"
        "       and not os.path.abspath(m.__file__).startswith(pkg)]\n"
        "assert not out, out\n"
        "assert 'spasm_tpu_torch._host.pivots' in sys.modules\n"
        "print('ok')\n")
    assert _run(code).strip().endswith("ok")


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
    from spasm_tpu_torch._host import fixtures, native, pivots

    assert pivots.__name__ == "spasm_tpu_torch._host.pivots"
    for mod in (pivots, fixtures, native):
        assert os.path.abspath(mod.__file__).startswith(PKG + os.sep)
    assert os.path.dirname(native._CSRC) == os.path.dirname(native.__file__)
    assert native._CACHE.startswith(os.path.join(ROOT, "build") + os.sep)
    B = fixtures.simplex_boundary(8, 3)
    prows, pcols, _ = pivots.find_structural_pivots(B)
    assert prows.size == pcols.size > 0


def test_host_c_sources_are_outside_the_nvcc_build():
    from spasm_tpu_torch.ops import _cuda

    srcs = _cuda.sources()
    assert srcs and all(s.endswith((".cu", ".cuh")) for s in srcs)
    assert not any(os.sep + "_host" + os.sep in s for s in srcs)


# ---- the host copy against the JAX package's sources: a fix to one that
# does not reach the other fails here

REF_CSRC = os.path.join(ROOT, "csrc")
PORT_CSRC = os.path.join(PKG, "_host", "csrc")
# module -> what the port's copy may change: the module docstring, and
# top-level assignments and functions (methods included) by name
HOST_EDITS = {
    "field": (), "sputil": (), "elimination": (), "io": (),
    "fixtures": (), "utils/logging": (), "utils/hostmem": (),
    "graphs": (),
    "csr": ("__truediv__",),          # B / LU reaches the port's LU
    # the greedy completion runs in C (csrc/greedy_mod.c), counted
    "pivots": ("GREEDY_RUNS", "greedy_pivots", "_pivots_from_scan"),
    "native": ("<docstring>", "_CSRC", "_CACHE", "_build", "_load",
               "_configure_greedy", "greedy_pivots_native"),
}
# the port's own C sources in _host/csrc, beside the reference's copies
PORT_ONLY_C = ("greedy_mod.c",)
# the top-level copies (spasm_tpu_torch/<mod>.py against spasm_tpu/<mod>.py)
# and what each may change; their import lines are compared after
# IMPORT_REWRITE
TOP_EDITS = {
    # the port's rank keeps device=; the corner inverse runs on the LU's
    # device
    "solve": ("<docstring>", "rank", "_dense_block_inverse"),
    # load_lu(device=)
    "checkpoint": ("<docstring>", "load_lu"),
    "blocks": (),
    # certificate_rank_create(device=)
    "certificate": ("certificate_rank_create",),
    # --device; --num-devices under torchrun (rank 0 prints); the
    # program's name
    "cli/main": ("<docstring>", "_common_flags", "_ech_opts", "_mesh",
                 "tool_rank", "main"),
    "cli/__main__": (),
    "cli/__init__": (),
}
# a host module X is the port's ._host.X; spasm_tpu is spasm_tpu_torch
_HOST_MODS = ("csr|field|io|sputil|native|pivots|elimination|fixtures|"
              "graphs|utils")
IMPORT_REWRITE = [
    (re.compile(rf"^(\s*from )\.({_HOST_MODS})\b"), r"\1._host.\2"),
    (re.compile(r"^(\s*from )\.\.utils\b"), r"\1.._host.utils"),
    (re.compile(rf"^(\s*(?:from|import) )spasm_tpu\.({_HOST_MODS})\b"),
     r"\1spasm_tpu_torch._host.\2"),
    (re.compile(r"^(\s*(?:from|import) )spasm_tpu\b"), r"\1spasm_tpu_torch"),
]


def test_host_c_sources_are_the_same_files():
    assert sorted(os.listdir(PORT_CSRC)) == sorted(
        [n for n in os.listdir(REF_CSRC) if n.endswith(".c")]
        + list(PORT_ONLY_C))


@pytest.mark.parametrize("name", sorted(
    n for n in os.listdir(REF_CSRC) if n.endswith(".c")))
def test_host_c_source_matches_reference(name):
    with open(os.path.join(REF_CSRC, name), "rb") as a, \
            open(os.path.join(PORT_CSRC, name), "rb") as b:
        assert a.read() == b.read(), name


def _unmasked_lines(path, names):
    """The lines of a module's source outside the docstring and the
    top-level assignments and functions (at any depth) in ``names``, each
    with the blank and comment lines that lead into it (so that a name
    only one side has brings its own separation)."""
    import ast

    with open(path) as fh:
        src = fh.read()
    tree = ast.parse(src)
    lines = src.splitlines()
    drop = set()

    def span(node):
        start = node.lineno
        while start > 1 and lines[start - 2].strip()[:1] in ("", "#"):
            start -= 1
        drop.update(range(start, node.end_lineno + 1))

    if "<docstring>" in names and ast.get_docstring(tree) is not None:
        span(tree.body[0])
    for node in tree.body:
        if isinstance(node, ast.Assign) and any(
                isinstance(t, ast.Name) and t.id in names
                for t in node.targets):
            span(node)
    for node in ast.walk(tree):
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)) \
                and node.name in names:
            span(node)
    return [ln for i, ln in enumerate(src.splitlines(), 1) if i not in drop]


@pytest.mark.parametrize("mod", sorted(HOST_EDITS))
def test_host_module_matches_reference_outside_its_edits(mod):
    names = HOST_EDITS[mod]
    got = _unmasked_lines(os.path.join(PKG, "_host", mod + ".py"), names)
    want = _unmasked_lines(os.path.join(ROOT, "spasm_tpu", mod + ".py"),
                           names)
    assert got == want, mod


# functions of the JAX package's jax-using modules that the port copies
# verbatim: (module under both packages, function)
COPIED_FUNCTIONS = [("ops/sparse_device", "ell_pack")]


@pytest.mark.parametrize("mod,name", COPIED_FUNCTIONS)
def test_copied_function_matches_reference(mod, name):
    import ast

    def source(root):
        with open(os.path.join(root, mod + ".py")) as fh:
            src = fh.read()
        node = next(n for n in ast.parse(src).body
                    if isinstance(n, ast.FunctionDef) and n.name == name)
        return ast.get_source_segment(src, node)

    assert source(PKG) == source(os.path.join(ROOT, "spasm_tpu"))


def _rewrite_imports(line):
    for rx, sub in IMPORT_REWRITE:
        line = rx.sub(sub, line)
    return line


@pytest.mark.parametrize("mod", sorted(TOP_EDITS))
def test_top_module_matches_reference_outside_its_edits(mod):
    names = TOP_EDITS[mod]
    got = _unmasked_lines(os.path.join(PKG, mod + ".py"), names)
    want = [_rewrite_imports(ln) for ln in _unmasked_lines(
        os.path.join(ROOT, "spasm_tpu", mod + ".py"), names)]
    assert got == want, mod


def test_import_rewrite_maps_host_and_package_imports():
    assert _rewrite_imports("    from .csr import SparseGFp") == \
        "    from ._host.csr import SparseGFp"
    assert _rewrite_imports("from .solve import rank") == \
        "from .solve import rank"
    assert _rewrite_imports("from ..utils.hostmem import x") == \
        "from .._host.utils.hostmem import x"
    assert _rewrite_imports("    from spasm_tpu.graphs import dm") == \
        "    from spasm_tpu_torch._host.graphs import dm"
    assert _rewrite_imports("    import spasm_tpu as st") == \
        "    import spasm_tpu_torch as st"
    assert _rewrite_imports("x = 'spasm_tpu.cli'") == "x = 'spasm_tpu.cli'"


# ---- the port's native calls against the JAX package's, one input each


def _rand_csr(f, shape, density, rng):
    M = sp.random(*shape, density=density, random_state=rng, format="csr")
    M.data = f.rand(M.nnz, rng).astype(np.int64)
    M.data[M.data == 0] = 1
    return M


def _csr_triple(M):
    M = sp.csr_matrix(M)
    M.sort_indices()
    return [M.indptr.astype(np.int64), M.indices.astype(np.int64),
            M.data.astype(np.int64)]


def _schur(nat, f, rng):
    B = _rand_csr(f, (60, 80), 0.1, rng)
    C = _rand_csr(f, (60, 25), 0.2, rng)
    U = _rand_csr(f, (25, 80), 0.1, rng)
    return _csr_triple(nat.schur_update_native(f, B, C, U))


def _mutual(nat, f, rng):
    # a unit pivot block: row k has its pivot at column 2k and entries in
    # later pivot columns; levels from the JAX package's compute_levels
    from spasm_tpu.elimination import compute_levels

    r, m = 30, 70
    pc = 2 * np.arange(r)
    rows, cols, vals = [], [], []
    for k in range(r):
        rows.append(k), cols.append(int(pc[k])), vals.append(1)
        for c in rng.choice(np.arange(pc[k] + 1, m), 3, replace=False):
            rows.append(k), cols.append(int(c))
            vals.append(int(f.rand(1, rng)[0]) or 1)
    U = sp.csr_matrix((np.array(vals, np.int64), (rows, cols)), shape=(r, m))
    levels = compute_levels(U, pc)
    depth = int(levels.max()) + 1
    assert depth > 2
    order = np.argsort(levels, kind="stable")
    offs = np.searchsorted(levels[order], np.arange(depth + 1))
    qinv = np.full(m, -1, np.int64)
    qinv[pc[order]] = np.arange(r)
    out = nat.mutual_reduce_native(f, U, qinv, offs, depth, None,
                                   rowperm=order)
    return _csr_triple(out)


def _pivot_scan(nat, f, rng):
    A = _rand_csr(f, (90, 70), 0.08, rng)
    row_used = rng.random(90) < 0.2
    col_selected = rng.random(70) < 0.2
    pos = np.where(row_used, np.arange(90, dtype=np.float64), -np.inf)
    return list(nat.pivot_scan_native(A.indptr, A.indices, row_used,
                                      col_selected, pos))


def _parse_sms(nat, f, rng):
    n, m, k = 40, 30, 200
    i, j = rng.integers(1, n + 1, k), rng.integers(1, m + 1, k)
    v = rng.integers(-10**6, 10**6, k)
    body = "".join(f"{a} {b} {c}\n" for a, b, c in zip(i, j, v))
    raw = f"{n} {m} M\n{body}0 0 0\n".encode()
    out = nat.parse_sms_native(raw)
    return [np.asarray(out[:2])] + [np.asarray(x) for x in out[2:]]


@pytest.mark.parametrize("call", [_schur, _mutual, _pivot_scan, _parse_sms])
def test_native_calls_match_jax_package(call):
    from spasm_tpu_torch._host import native as port_native
    from spasm_tpu_torch._host.field import field as port_field

    p = 42013
    got = call(port_native, port_field(p), np.random.default_rng(3))
    want = call(ref_native, ref_field(p), np.random.default_rng(3))
    assert len(got) == len(want) > 0
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)
    assert port_native._libs and all(
        lib is not None for lib in port_native._libs.values())


def test_exports_cover_the_reference():
    # every name spasm_tpu/__init__.py imports, and its __all__
    import ast

    import spasm_tpu
    import spasm_tpu_torch

    with open(os.path.join(ROOT, "spasm_tpu", "__init__.py")) as fh:
        tree = ast.parse(fh.read())
    names = {a.asname or a.name for node in tree.body
             if isinstance(node, ast.ImportFrom) and node.level == 1
             for a in node.names}
    assert len(names) > 40
    assert not [n for n in names if not hasattr(spasm_tpu_torch, n)]
    assert set(spasm_tpu.__all__) <= set(spasm_tpu_torch.__all__)
    assert names <= set(spasm_tpu_torch.__all__)
    assert all(hasattr(spasm_tpu_torch, n) for n in spasm_tpu_torch.__all__)
