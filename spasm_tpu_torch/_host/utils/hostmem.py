"""Host memory tuning for slow-first-touch environments.

Measured on this VM (round 3): anonymous-page first-touch faults run at
~10-20 MB/s (hypervisor-level lazy backing), ~1000x slower than a warm
rewrite of the same pages.  glibc returns every >=128 KiB allocation to
the OS on free (mmap/munmap), so EVERY large NumPy temporary pays the
fault cost again — this, not CPU work, dominated the d9-scale (53M nnz)
host phases and explains round 2's "2-5x iowait noise".

``tune_host_malloc()`` flips glibc to serve all allocations from the
sbrk heap and never trim it (mallopt M_MMAP_MAX=0, M_TRIM_THRESHOLD=-1):
pages are faulted once at the high-water mark and then reused at memory
speed.  Trade-off: the process's RSS stays at its high-water mark.
Applied by bench.py, the CLI, and the test suite; libraries embedding
spasm_tpu can call it explicitly.  Opt out with
SPASM_TPU_NO_MALLOC_TUNE=1.

(The reference leaves this to the platform; it is an environment lever,
not an algorithmic one — measured 400x on repeated 200 MB fills here.)
"""

from __future__ import annotations

import ctypes
import os

_done = False

_M_TRIM_THRESHOLD = -1
_M_MMAP_MAX = -4


def tune_host_malloc() -> bool:
    """Idempotent; returns True when the tuning is active."""
    global _done
    if _done:
        return True
    if os.environ.get("SPASM_TPU_NO_MALLOC_TUNE"):
        return False
    try:
        libc = ctypes.CDLL("libc.so.6", use_errno=True)
        ok = (libc.mallopt(_M_MMAP_MAX, 0) == 1
              and libc.mallopt(_M_TRIM_THRESHOLD, -1) == 1)
    except OSError:  # non-glibc platform
        return False
    _done = bool(ok)
    return _done


def prefault(nbytes: int, threads: int = 8) -> float:
    """Fault ``nbytes`` of heap into residency NOW (parallel page
    touches — faults release the GIL and parallelize ~2-5x here), then
    free the block: with tune_host_malloc() active the pages stay in the
    heap, so subsequent allocations up to the high-water mark run at
    memory speed instead of fault speed.  Returns the seconds spent.
    Call before a measured/latency-sensitive phase with its expected
    peak footprint."""
    import concurrent.futures as cf
    import time

    import numpy as np

    tune_host_malloc()
    t0 = time.time()
    x = np.empty(nbytes, np.uint8)
    step = 4096
    nt = max(1, threads)
    bounds = [nbytes * i // nt for i in range(nt + 1)]

    def touch(lo, hi):
        x[lo:hi:step] = 1

    with cf.ThreadPoolExecutor(nt) as ex:
        list(ex.map(lambda b: touch(*b),
                    [(bounds[i], bounds[i + 1]) for i in range(nt)]))
    del x
    return time.time() - t0
