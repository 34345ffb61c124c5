"""What a torch.profiler trace of some whole calls says about the card.

The arithmetic of the program's ``chip_smoke.profile_rank`` (device time by
kernel name, busy share), copied here so that the yardstick stays put, and
extended to the trace's timeline: the card's busy time is the union of its
kernel, copy and set intervals inside the traced calls, and an idle gap is
labelled by the innermost PyTorch operation the host was in at its middle.
The metric readers pick kernels out of ``kernels`` by name.
"""

from __future__ import annotations

import json

DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
CALL_MARK = "portbench.call"
HOST_ONLY = "host outside PyTorch (numpy / C host rounds)"


def kernel_seconds(trace: dict, names) -> float:
    """Device seconds of the kernels whose names hold one of ``names``."""
    return sum(s for k, (_, s) in trace["kernels"].items()
               if any(n in k for n in names))


def _union(intervals):
    """Disjoint sorted segments covering the (start, end) intervals."""
    out = []
    for s, e in sorted(intervals):
        if out and s <= out[-1][1]:
            if e > out[-1][1]:
                out[-1][1] = e
        else:
            out.append([s, e])
    return out


def read(path: str, top: int = 10) -> dict:
    """Reduce a Chrome trace written by ``torch.profiler`` to the numbers
    the per-layer metrics and the breakdown read (seconds)."""
    with open(path) as fh:
        events = json.load(fh)["traceEvents"]
    xs = [e for e in events if e.get("ph") == "X" and "dur" in e]
    calls = [e for e in xs if e.get("cat") == "user_annotation"
             and e.get("name") == CALL_MARK]
    if not calls:
        return {}
    t0 = min(e["ts"] for e in calls)
    t1 = max(e["ts"] + e["dur"] for e in calls)
    dev = [e for e in xs if e.get("cat") in DEVICE_CATS
           and t0 <= e["ts"] < t1]
    segs = _union((e["ts"], min(e["ts"] + e["dur"], t1)) for e in dev)
    busy_us = sum(e - s for s, e in segs)
    kernels: dict = {}
    for e in dev:
        if e["cat"] == "kernel":
            k = kernels.setdefault(e["name"], [0, 0.0])
            k[0] += 1
            k[1] += e["dur"] / 1e6
    gaps = []
    prev = t0
    for s, e in segs + [[t1, t1]]:
        if s > prev:
            gaps.append((s - prev, prev, s))
        prev = max(prev, e)
    gaps.sort(reverse=True)
    host = [e for e in xs if e.get("cat") == "cpu_op"]
    labelled = []
    for dur, s, e in gaps[:top]:
        mid = (s + e) / 2
        inner = [h for h in host if h["ts"] <= mid < h["ts"] + h["dur"]]
        name = (min(inner, key=lambda h: h["dur"])["name"] if inner
                else HOST_ONLY)
        labelled.append([name, dur / 1e6])
    ops = sorted(kernels.items(), key=lambda kv: kv[1][1], reverse=True)
    return {"calls": len(calls), "window_s": (t1 - t0) / 1e6,
            "busy_s": busy_us / 1e6, "kernels": kernels,
            "device_ops": [[n, v[1]] for n, v in ops[:top]],
            "idle_gaps": labelled}
