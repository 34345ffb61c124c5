"""One run of one cell: set-up, the timed window, the trace, the check.

Everything that belongs to one cell, configuration, generator or metric is
a file found by its name (README.md); this module holds no list of them.
``run`` takes the device and the program as arguments so that the CPU
tests can drive a whole run on the CPU; ``run.py`` gives it the card.
"""

from __future__ import annotations

import hashlib
import importlib.util
import json
import os
import statistics
import sys
import tempfile
import time

import numpy as np

import reference

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)
FORBIDDEN = ("jax", "jaxlib", "flax", "spasm_tpu")
# random combinations of A's rows reduced against each distinct U
COMBOS = 4
# set-up's calls: the first (eager) and the second, which captures the
# dense finish's CUDA graph for the shape, so the window replays it
WARM_CALLS = 2
# the window calls a --trace 1 run profiles: whole calls, after two
TRACED_FROM, TRACED_CALLS = 2, 3


def load_json(path: str) -> dict:
    with open(path) as fh:
        return json.load(fh)


def load_module(path: str):
    """Import a file of the benchmark by its path."""
    name = "portbench_" + os.path.relpath(path, HERE).replace(
        os.sep, "_").replace(".", "_")
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def cell(workload: str, here: str = HERE, root: str = ROOT) -> dict:
    """The cell's files by the names BENCHMARK.json gives it: its
    configuration, its traffic, the configuration's generator, and its
    metrics, each with its reader."""
    bench = load_json(os.path.join(root, "BENCHMARK.json"))
    entry = next((w for w in bench["workloads"] if w["name"] == workload),
                 None)
    if entry is None:
        raise SystemExit(f"portbench: no workload {workload!r} in "
                         "BENCHMARK.json")
    cfg = load_json(os.path.join(here, "configs", entry["config"] + ".json"))
    traffic = load_json(os.path.join(here, "traffic",
                                     entry["traffic"] + ".json"))
    gen = load_module(os.path.join(here, "gen", cfg["family"] + ".py"))

    def mine(entries):
        return [m for m in entries
                if workload in m.get("workloads", [workload])]

    metrics = {kind: [(m, load_module(os.path.join(
        here, "metrics", m["name"] + ".py"))) for m in mine(bench[kind])]
        for kind in ("end_to_end", "per_layer")}
    return {"entry": entry, "config": cfg, "traffic": traffic, "gen": gen,
            "metrics": metrics}


def forbidden_modules() -> list[str]:
    """Loaded modules whose top-level name is the JAX stack or the JAX
    package, compared whole (the port's name begins with the package's)."""
    return sorted({m.split(".")[0] for m in list(sys.modules)}
                  & set(FORBIDDEN))


def fingerprint(out: dict) -> str:
    h = hashlib.blake2b(digest_size=16)
    U = out["U"]
    for a in (np.int64(out["r"]), out["piv_cols"], out["p"], U.indptr,
              U.indices, U.data):
        h.update(np.ascontiguousarray(np.asarray(a, np.int64)).tobytes())
    return h.hexdigest()


def lu_output(lu) -> dict:
    """The parts of the program's LU that the check judges."""
    return {"r": int(lu.r), "U": lu.U.to_scipy().tocsr(),
            "piv_cols": np.asarray(lu.piv_cols, np.int64),
            "qinv": np.asarray(lu.qinv, np.int64),
            "p": np.asarray(lu.p, np.int64)}


def check(pool: dict, outs: list, device,
          rng: np.random.Generator) -> tuple[dict, int, int]:
    """Judge every window call's output: each distinct (matrix, output)
    pair once, against the reference.  Returns the numbers compared, each
    with its limit, the count of calls that failed and the count of
    distinct outputs judged."""
    p = pool["p"]
    by_key: dict = {}
    for i, (k, out) in enumerate(outs):
        by_key.setdefault((k, fingerprint(out)), []).append(i)
    ranks: dict = {}
    gap = faults = resid = 0
    failed = 0
    for (k, _), calls in sorted(by_key.items(), key=lambda kv: kv[1][0]):
        A = pool["matrices"][k]
        out = outs[calls[0]][1]
        b = pool["base_of"][k]
        if b not in ranks:
            ranks[b] = reference.reference_rank(pool["bases"][b], p, device)
        g = abs(out["r"] - ranks[b])
        f = reference.form_faults(out, A.shape[0], A.shape[1], p)
        z = (reference.residual_nonzeros(A, out, p, COMBOS, rng)
             if f == 0 else 0)
        gap, faults, resid = max(gap, g), faults + f, resid + z
        if g or f or z:
            failed += len(calls)
    checks = {"rank_gap": {"value": gap, "limit": 0},
              "form_faults": {"value": faults, "limit": 0},
              "residual_nonzeros": {"value": resid, "limit": 0}}
    return checks, failed, len(by_key)


def verdict(checks: dict, failed: int, attempted: int) -> bool:
    """``correct``: some output judged, none failed, every number within
    its limit."""
    return bool(attempted) and failed == 0 and all(
        v["value"] <= v["limit"] for v in checks.values())


def run(args, *, device: str, program, sync=lambda: None,
        t_start: float | None = None, cell_files: dict | None = None,
        log=lambda msg: print(msg, file=sys.stderr)) -> dict:
    """One run of ``args.workload``: the result line's object."""
    import torch

    t_start = time.perf_counter() if t_start is None else t_start
    c = cell_files or cell(args.workload)
    t_pool = time.perf_counter()
    seeds = np.random.SeedSequence(int(args.seed) % (1 << 64)).spawn(2)
    pool = c["gen"].make_pool(c["config"], c["traffic"],
                              np.random.default_rng(seeds[0]), device)
    if device == "cuda":
        # the pool's scratch on the card is not the program's memory
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
    p = pool["p"]
    mats = [program.SparseGFp.from_scipy(M, p, assume_canonical=True)
            for M in pool["matrices"]]
    n = len(mats)

    def call(k):
        lu = program.echelonize(mats[k], device=device)
        sync()
        return lu

    t = time.perf_counter()
    pool_s = t - t_pool
    call(0)
    first_call_s = time.perf_counter() - t
    for k in range(1, WARM_CALLS):
        call(k % n)
    setup_s = time.perf_counter() - t_start
    log(f"setup: {t_pool - t_start:.3f} s to the pool, pool {pool_s:.3f} s, "
        f"first call {first_call_s:.3f} s, other warm calls "
        f"{setup_s - (t - t_start) - first_call_s:.3f} s")

    from spasm_tpu_torch.ops import dense as dense_ops

    traced = int(args.trace) == 1
    prof = trace_path = None
    t_lo, t_hi = TRACED_FROM, TRACED_FROM + TRACED_CALLS
    walls, outs, phases, graphs = [], [], [], []
    i = 0
    t0 = time.perf_counter()
    while True:
        k = (WARM_CALLS + i) % n
        if traced and i == t_lo:
            prof = torch.profiler.profile(activities=[
                torch.profiler.ProfilerActivity.CPU,
                *([torch.profiler.ProfilerActivity.CUDA]
                  if device == "cuda" else [])])
            prof.start()
        dense_ops.last_finish.clear()
        c0 = time.perf_counter()
        if prof is not None and i < t_hi:
            with torch.profiler.record_function("portbench.call"):
                lu = call(k)
        else:
            lu = call(k)
        c1 = time.perf_counter()
        walls.append(c1 - c0)
        outs.append((k, lu))
        phases.append(program.last_phase_stats())
        graphs.append(dense_ops.last_finish.get("graph"))
        i += 1
        if traced and i == t_hi:
            prof.stop()
            fd, trace_path = tempfile.mkstemp(suffix=".json")
            os.close(fd)
            prof.export_chrome_trace(trace_path)
            prof = None
        if c1 - t0 >= args.seconds and (not traced or i >= t_hi):
            break
    window_s = c1 - t0

    mem_peak = (torch.cuda.max_memory_reserved() if device == "cuda"
                else 0)
    program.release_native_scratch()
    if device == "cuda":
        torch.cuda.empty_cache()

    record = {"window_s": window_s, "calls": len(walls), "walls": walls,
              "setup_s": setup_s, "first_call_s": first_call_s,
              "memory_reserved_peak": mem_peak, "phase_stats": phases,
              "finish_graph": graphs, "trace": None}
    if trace_path is not None:
        import trace_read

        record["trace"] = trace_read.read(trace_path)
        os.unlink(trace_path)
        tw = walls[t_lo:t_hi]
        rest = walls[:t_lo] + walls[t_hi:]
        log(f"trace: {len(tw)} traced calls {statistics.mean(tw):.6f} s "
            f"each, {len(rest)} untraced {statistics.mean(rest):.6f} s"
            if rest else f"trace: {len(tw)} traced calls")

    def mean_of(key):
        vals = [ph.get(key, 0.0) for ph in phases]
        return sum(vals) / len(vals)

    log(f"window: {len(walls)} calls, wall median "
        f"{statistics.median(walls):.4f} s (min {min(walls):.4f}, max "
        f"{max(walls):.4f}); pivot_s {mean_of('pivot_s'):.4f}, schur_s "
        f"{mean_of('schur_s'):.4f}, finish_s {mean_of('finish_s'):.4f}, "
        f"assemble_s {mean_of('assemble_s'):.4f}")
    kind = "per_layer" if traced else "end_to_end"
    metrics = {}
    for m, reader in c["metrics"][kind]:
        v = reader.read(record)
        if v is not None:
            metrics[m["name"]] = {"value": v, "unit": m["unit"]}

    outs = [(k, lu_output(lu)) for k, lu in outs]
    t = time.perf_counter()
    checks, failed, distinct = check(pool, outs, device,
                                     np.random.default_rng(seeds[1]))
    log(f"check: {distinct} distinct outputs of {len(outs)} calls judged "
        f"in {time.perf_counter() - t:.1f} s")
    correct = verdict(checks, failed, len(outs))
    dev = {"platform": "gpu" if device == "cuda" else device,
           "kind": (torch.cuda.get_device_name() if device == "cuda"
                    else device),
           "count": int(c["entry"]["chips"]), "memory_peak_bytes": int(mem_peak)}
    result = {"correct": correct, "attempted": len(outs), "failed": failed,
              "metrics": metrics, "device": dev}
    tr = record["trace"]
    if traced:
        dev["busy_s"] = tr["busy_s"] if tr else 0.0
        dev["window_s"] = tr["window_s"] if tr else 0.0
        if tr:
            result["breakdown"] = {"device_ops": tr["device_ops"],
                                   "idle_gaps": tr["idle_gaps"]}
    result["checks"] = checks
    return result
