"""Build and load the port's CUDA kernels.

At first use, ``nvcc`` compiles every ``spasm_tpu_torch/csrc/*.cu`` to an
object, one process for each source, all started together, and links them
into one shared library with a plain C interface,
``build/spasm_tpu_torch/lib<hash of the sources>.so`` under the repository
root, which ``ctypes`` loads.  A build is reused while the sources are
unchanged.  Importing this module needs neither CUDA nor nvcc: the build
runs inside ``lib()``, which only the kernel wrappers call, and only for
CUDA tensors.
"""

from __future__ import annotations

import contextlib
import ctypes
import glob
import hashlib
import os
import shutil
import subprocess
import threading
import time

import torch

_PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
_CSRC = os.path.join(_PKG, "csrc")
BUILD_DIR = os.path.join(os.path.dirname(_PKG), "build", "spasm_tpu_torch")
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-Xcompiler", "-fPIC", "-Xptxas=-v"]

_lock = threading.Lock()
_lib = None
build_seconds = None  # wall of the nvcc run in this process (None: cached)
build_log = ""        # nvcc's stderr: ptxas registers / spills per kernel
lib_path = None       # the loaded shared library


def _nvcc() -> str:
    for cand in (shutil.which("nvcc"), "/usr/local/cuda/bin/nvcc"):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError("nvcc not found: the CUDA kernels are built on a "
                       "machine with the CUDA toolkit")


def sources() -> list[str]:
    return sorted(glob.glob(os.path.join(_CSRC, "*.cu"))
                  + glob.glob(os.path.join(_CSRC, "*.cuh")))


def _check_nvcc(cmd, returncode: int, stderr: str) -> None:
    if returncode != 0:
        raise RuntimeError(f"nvcc failed ({returncode}): {' '.join(cmd)}\n"
                           f"{stderr}")


def _configure(lib):
    vp, i32, i64 = ctypes.c_void_p, ctypes.c_int, ctypes.c_int64
    lib.spasm_modmatmul_tiles.restype = i32
    lib.spasm_modmatmul_tiles.argtypes = [i32, ctypes.POINTER(ctypes.c_int)]
    lib.spasm_modmatmul.restype = i32
    lib.spasm_modmatmul.argtypes = [vp, vp, vp, i32, i32, i32, i32, i32,
                                    i32, i64, vp, i32, vp, vp]
    lib.spasm_modmatmul_full.restype = i32
    lib.spasm_modmatmul_full.argtypes = [vp, i64, i64, vp, i64, i64, vp, vp,
                                         vp, i32, i32, i32, i32, i32, i32,
                                         i32, i64, vp, i32, vp, vp]
    lib.spasm_modmatmul_split.restype = i32
    lib.spasm_modmatmul_split.argtypes = [vp, i64, i64, i32, i32, vp, i32,
                                          i32, i32, i32, vp, vp]
    lib.spasm_cuda_error_string.restype = ctypes.c_char_p
    lib.spasm_cuda_error_string.argtypes = [i32]
    lib.spasm_panel_eliminate.restype = i32
    lib.spasm_panel_eliminate.argtypes = [vp, vp, vp, vp, vp, vp, vp, i32,
                                          i32, i32, i32, i64, vp, vp, vp]
    lib.spasm_merge_scratch_rows.restype = i64
    lib.spasm_merge_scratch_rows.argtypes = [i64, i32, i32]
    lib.spasm_merge_rows.restype = i32
    lib.spasm_merge_rows.argtypes = [vp, vp, vp, vp, vp, vp, i64, i32, i32,
                                     i64, i32, vp]
    lib.spasm_stream_create.restype = i32
    lib.spasm_stream_create.argtypes = [ctypes.POINTER(vp)]
    lib.spasm_graph_if_begin.restype = i32
    lib.spasm_graph_if_begin.argtypes = [vp, vp, vp]
    lib.spasm_graph_if_end.restype = i32
    lib.spasm_graph_if_end.argtypes = [vp]


def lib():
    """The loaded kernel library, built on first call."""
    global _lib, build_seconds, build_log, lib_path
    with _lock:
        if _lib is not None:
            return _lib
        srcs = sources()
        h = hashlib.sha256()
        for s in srcs:
            with open(s, "rb") as fh:
                h.update(os.path.basename(s).encode() + b"\0" + fh.read())
        h.update(" ".join(NVCC_FLAGS).encode())
        so = os.path.join(BUILD_DIR, f"lib{h.hexdigest()[:16]}.so")
        if not os.path.exists(so):
            os.makedirs(BUILD_DIR, exist_ok=True)
            tmp = f"{so}.{os.getpid()}.tmp"
            t0 = time.perf_counter()
            nvcc = _nvcc()
            objs, jobs = [], []
            for src in (s for s in srcs if s.endswith(".cu")):
                obj = f"{tmp}.{os.path.basename(src)}.o"
                cmd = [nvcc, *NVCC_FLAGS, "-c", "-o", obj, src]
                objs.append(obj)
                jobs.append((cmd, subprocess.Popen(
                    cmd, stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                    text=True)))
            logs = []
            try:
                for cmd, job in jobs:
                    _, err = job.communicate()
                    _check_nvcc(cmd, job.returncode, err)
                    logs.append(err)
            finally:
                for _, job in jobs:   # none outlives a failed build
                    if job.poll() is None:
                        job.kill()
                        job.wait()
            cmd = [nvcc, *NVCC_FLAGS, "-shared", "-o", tmp, *objs]
            res = subprocess.run(cmd, capture_output=True, text=True)
            _check_nvcc(cmd, res.returncode, res.stderr)
            build_seconds = time.perf_counter() - t0
            build_log = "".join(logs)
            os.replace(tmp, so)
            for obj in objs:
                os.remove(obj)
        handle = ctypes.CDLL(so)
        lib_path = so
        _configure(handle)
        _lib = handle
        return _lib


def check(rc: int, what: str) -> None:
    """Raise on a non-zero cudaError_t returned by a launcher."""
    if rc != 0:
        msg = _lib.spasm_cuda_error_string(rc).decode()
        raise RuntimeError(f"{what}: CUDA error {rc} ({msg}) at launch")


def on_device_of(t, call):
    """call() with t's device current (kernels launch on the current
    device); the guard is skipped where it already is."""
    if t.device.index == torch.cuda.current_device():
        return call()
    with torch.cuda.device(t.device):
        return call()


def stream_of(t) -> int:
    """The current CUDA stream of t's device, as a pointer-sized int (the
    capture stream while a CUDA graph is being captured)."""
    return torch.cuda.current_stream(t.device).cuda_stream


def flag_of(run, t) -> "int | None":
    """The device address of a one-byte flag (a 0-d bool tensor on t's
    device) that a kernel reads to skip its work, or None for no flag."""
    if run is None:
        return None
    if not (run.dtype == torch.bool and run.numel() == 1
            and run.device == t.device):
        raise ValueError("a kernel's run flag is a one-element bool tensor on "
                         f"{t.device}, got {run.dtype} {tuple(run.shape)} on "
                         f"{run.device}")
    return run.data_ptr()


def capturing() -> bool:
    """Whether the current stream is capturing a CUDA graph: a launch then
    only records a node, and the wrappers do not count it (a graph's
    replays launch those kernels without them; ``chip_smoke.py`` counts
    the replays' launches from the profiler's kernel events)."""
    return torch.cuda.is_current_stream_capturing()


_body_streams: dict = {}
_body_pools: dict = {}   # device index -> bodies' pool of the capture


@contextlib.contextmanager
def capture(graph, dev, pool, bodies):
    """Capture the work of the ``with`` block into ``graph`` on a side
    stream of ``dev``, its memory from ``pool`` (a
    ``torch.cuda.graph_pool_handle()``) and that of ``graph_if``'s bodies
    from ``bodies`` (a ``torch.cuda.MemPool``, which the caller keeps as
    long as the graph).  The current stream waits for the capture."""
    cur = torch.cuda.current_stream(dev)
    side = torch.cuda.Stream(dev)
    side.wait_stream(cur)
    with torch.cuda.stream(side):
        graph.capture_begin(pool=pool)
        _body_pools[dev.index] = bodies
        try:
            yield
        finally:
            del _body_pools[dev.index]
            graph.capture_end()
    cur.wait_stream(side)


@contextlib.contextmanager
def graph_if(pred):
    """Capture the work of the ``with`` block into a conditional (IF) node
    of the CUDA graph that ``capture`` is capturing on the current stream:
    a replay runs it only where ``pred`` (a 0-d bool tensor on that device)
    holds when the node is reached (``csrc/graph_if.cu``).  The block runs
    on a stream of the device's own, captured into the node's body.  The
    body's capture is one of its own, which the caching allocator does not
    count as the graph's, so what this thread allocates meanwhile comes
    from the capture's ``bodies`` pool: from the default pool, a block
    free once the capture ends could be handed to cudaFree (an
    ``empty_cache()``, a retry after an out-of-memory) while the graph
    still writes it."""
    dev = pred.device
    bodies = _body_pools[dev.index]
    parent = torch.cuda.current_stream(dev)
    if dev.index not in _body_streams:
        ptr = ctypes.c_void_p()
        with torch.cuda.device(dev):
            check(lib().spasm_stream_create(ctypes.byref(ptr)),
                  "body stream")
        _body_streams[dev.index] = torch.cuda.ExternalStream(ptr.value,
                                                             device=dev)
    body = _body_streams[dev.index]
    check(on_device_of(pred, lambda: lib().spasm_graph_if_begin(
        parent.cuda_stream, body.cuda_stream, pred.data_ptr())),
        "conditional node")
    try:
        with torch.cuda.use_mem_pool(bodies, dev), torch.cuda.stream(body):
            yield
    finally:
        rc = lib().spasm_graph_if_end(body.cuda_stream)
    check(rc, "conditional node body")


def body_pool(dev):
    """A new memory pool for the IF bodies of one capture (``capture``)."""
    with torch.cuda.device(dev):
        return torch.cuda.MemPool()
