"""Structured profiling hooks: the port of ``spasm_tpu/utils/profiling.py``.

``phase("name")`` is a nestable timer whose records accumulate in
``phase_records`` (and echo through the log sink when verbose);
``trace(logdir)`` wraps ``torch.profiler`` (CPU activity, and CUDA activity
where a card is visible) and writes a Chrome trace into ``logdir``, where
the reference wraps ``jax.profiler``."""

from __future__ import annotations

import contextlib
import os
import time

from .._host.utils.logging import log

phase_records: list[tuple[str, float]] = []


@contextlib.contextmanager
def phase(name: str):
    t0 = time.time()
    try:
        yield
    finally:
        dt = time.time() - t0
        phase_records.append((name, dt))
        log(f"[profile] {name}: {dt:.3f}s")


def reset_phases():
    phase_records.clear()


@contextlib.contextmanager
def trace(logdir: str):
    """torch.profiler trace around a region; yields the profiler (for
    ``key_averages()``) and writes ``logdir/trace_<pid>.json`` (Chrome
    trace format, readable by Perfetto) when the region ends."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(logdir, exist_ok=True)
    with profile(activities=activities) as prof:
        yield prof
    prof.export_chrome_trace(os.path.join(logdir,
                                          f"trace_{os.getpid()}.json"))
