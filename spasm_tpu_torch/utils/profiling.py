"""Structured profiling hooks: the port of ``spasm_tpu/utils/profiling.py``.

``phase(name, stats)`` is the program's one span: a nestable timer on
``time.perf_counter()`` (monotonic, as torch.profiler's host timeline) that
adds its seconds to ``stats`` and, only while a torch.profiler is recording,
opens ``record_function("spasm." + name)`` so that the span lands in the
same trace as the card's kernels.  Without ``stats`` its records accumulate
in ``phase_records`` (and echo through the log sink when verbose).
``trace(logdir)`` wraps ``torch.profiler`` (CPU activity, and CUDA activity
where a card is visible) and writes a Chrome trace into ``logdir``, where
the reference wraps ``jax.profiler``."""

from __future__ import annotations

import contextlib
import os
import time

import torch

from .._host.utils.logging import log

phase_records: list[tuple[str, float]] = []


@contextlib.contextmanager
def phase(name: str, stats: dict | None = None, key: str | None = None):
    """Time the block as the span ``name``.  With ``stats``, add its seconds
    to ``stats[key]`` (by default ``name`` with dots as underscores, plus
    ``_s``: "finish.prep" feeds "finish_prep_s") and log nothing.  With no
    profiler running a span costs one profiler check and two clock reads:
    ``record_function`` is not entered."""
    span = (torch.profiler.record_function("spasm." + name)
            if torch.autograd._profiler_enabled()
            else contextlib.nullcontext())
    with span:
        t0 = time.perf_counter()
        try:
            yield
        finally:
            dt = time.perf_counter() - t0
            if stats is None:
                phase_records.append((name, dt))
                log(f"[profile] {name}: {dt:.3f}s")
            else:
                key = key or name.replace(".", "_") + "_s"
                stats[key] = stats.get(key, 0.0) + dt


def reset_phases():
    phase_records.clear()


@contextlib.contextmanager
def trace(logdir: str):
    """torch.profiler trace around a region; yields the profiler (for
    ``key_averages()``) and writes ``logdir/trace_<pid>.json`` (Chrome
    trace format, readable by Perfetto) when the region ends.  The
    program's ``phase`` spans appear in it as ``spasm.*`` events of
    category ``user_annotation``."""
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(logdir, exist_ok=True)
    with profile(activities=activities) as prof:
        yield prof
    prof.export_chrome_trace(os.path.join(logdir,
                                          f"trace_{os.getpid()}.json"))
