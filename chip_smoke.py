#!/usr/bin/env python3
"""Smoke test of spasm_tpu_torch, the PyTorch / CUDA port, on one NVIDIA card.

    python3 chip_smoke.py            # every phase, as the acceptance run
    python3 chip_smoke.py --phases build,k1,k2,k3
    python3 chip_smoke.py --phases build,e2e --profile build/profile

Phases, one line each:

  build    the card, its power limit, and the nvcc build of
           spasm_tpu_torch/csrc/*.cu (with ptxas's register / spill lines,
           and the count of wgmma, TMA and mbarrier instructions in the
           SASS of each K1 product kernel)
  k1       the mod-p matmul kernels against their plain versions, both on
           the card: the limb split byte for byte against pack_planes_plain
           (both operands, every limb count, strided views), the product
           bit for bit against modmatmul_plain at the main path's shapes
           (those of the fused finish called as it calls K1: adding into
           out= under a run flag, True and False), at n, k, m of 1 and one
           past a tile, every limb count and k past one fold interval; at
           each main-path shape and 4096^3 the wrapper call, the split
           launches alone and the product launch alone are timed; the
           kernels line's is the fused finish's group update, also timed
           at p = 2147483629 and 4294967291 (its by_prime)
  k2       the panel elimination kernel against its plain version, both on
           the card, bit for bit in all six outputs (n = 1 .. 8192, c = 37
           .. 4096, five primes; n = 1000, 1024 (the fused finish's
           panel: the kernels line's, timed at every prime: its
           by_prime) and 4096 timed, with the time
           of each phase of a step and a latency bound: the pivot steps
           times the shortest cluster barrier of one step)
  k3       the merge kernel against its plain version, both on the card,
           bit for bit in all three outputs, at widths 31 .. 65536 (the
           edges of its levels: 64, 1024 and 16384; the global-memory
           variant above 16384), widths that are not powers of two and
           2**20, for five primes, and at the tile shapes of d8's two
           classes and random 30k's widest; those three are timed, with
           torch.sort of the same rows as a yardstick.  The build phase
           fails on a register spill in K3.
  rref    dense.rref with the transform on the card (panel group 4)
           against the same call on CPU tensors (group 1)
  e2e      rank(A, device="cuda") at real size: the 8192^2 d=0.02 random
           matrix (rank 8192), a planted-rank variant (rank 7168) and the
           simplex boundary (22, 7) (rank 116280), with the launch counts
  echelon  echelonize on the card against device="cpu": equal LU
  fused    the fused dense finish (ops/dense.fused_blocked_finish: the
           block loop with its control flow on the card, one CUDA graph
           per bucketed shape) on the flagship, its planted-rank variant,
           the 3000 x 720 echelon case and the api phase's 4000^2 case:
           the first call (eager), the second (the capture and a replay)
           and warm calls (replays) timed, the graph's memory, the
           finish's uploads and fused_blocked_finish under the sync
           debugger ("error" from the second call on, the first call's
           host reads counted), the replay's K1 / K2 launches from the
           profiler's kernel events (a replay bypasses the wrappers), the LU
           bit-equal to the streaming loop's (FUSED_BUDGET = 0) in blocks
           of the fused loop's height and, for the last two, to
           device="cpu"'s; at the default height the streaming LU is
           bit-equal or, where it takes other pivot rows, of the same
           rank and canonical RREF; K2's run flag against
           _panel_eliminate on an all-zero and a live panel, and K1
           accumulating under its run flag against the plain product
  tiers    the main path at the JAX package's large primes, p = 2147483629
           (tier B, 4 limbs) and 4294967291 (tier C, 5 limbs): the run
           flags as in fused (K1 into out= at (1024, 512, 8192), K2 on
           (1024, 128) panels); the flagship's pattern at p through the
           fused finish (eager, capture, two replays, rank 8192) bit-equal
           to the streaming loop at the fused loop's height;
           ops/dense.rref of a random 2048^2 matrix (the JAX package's
           dense_rref case), rank 2048, timed; then, the CPU sides in
           child processes, card against CPU: the 3000 x 720 echelon
           case, API_MID (echelonize with L, solve, gesv) and the 2048^2
           RREF
  sparse   the device sparse Schur path (device_sparse_min_nnz): round-0
           pairs of the d7 and d8 boundaries and the random 30k^2 matrix
           through the one-pass merge on the card against the host kernel
           (CSR-equal, one K3 launch per device call, K3's own time
           summed over its launches beside the one-pass device_s, and K3
           bit-equal to the plain merge on every tile of one more run);
           the ranks of d8 and
           the random matrix with the option on and off, with the launch
           counts; echelonize of d7 with the option, card against CPU
  waves    the sort-based wave Schur update (ops/sparse_device) on the
           card: round 0 of d7, random 30k and random 100000^2 d=2e-4
           through eliminate_device as echelonize runs it (capacity 4,
           then 16), held equal to the host kernel, timed host, card,
           card, host (where both capacities overflow, on the pivot rows
           of the levels the first one held), with the hits and kept
           entries of each wave, the peak device memory and the sorts'
           share of the device time; d8's round 0 once (finished,
           overflow, or out of memory, which fails); echelonize of the
           (29, 8) boundary, whose round 0 takes the device waves, against
           the host Schur path on the card (ranks, row spaces); and
           sharded_sparse_eliminate at world sizes 1 (NCCL) and 2 (gloo)
  api     the public surface on the card: on the planted-rank flagship,
           echelonize(L=True), kernel (1024 rows, A @ K.T == 0 by host
           SpMVs), solve (x @ A == b; None outside the row space; K1 and
           K2 launched inside the first solve, which inverts the
           dense-finish corner block), gesv on 256 rows (half
           consistent), a rank certificate (a tampered one refused) and
           factorization_verify; the kernel basis and certificate of the
           d8 boundary; at 4000^2 (corner block >= 1024 rows) the
           card's kernel, rref, solve, gesv, certificate and complete
           echelonize bit-equal to device="cpu"; the CLI's rank, kernel
           and solve with --device cuda byte-equal to --device cpu.  Each
           wall is printed beside the card's name and power limit.
  resume   checkpoint / resume on the card: a child process echelonizes the
           flagship with a checkpoint and a sidecar saved after every
           block (FUSED_BUDGET = 0 in both processes: the streaming loop
           of a finish over the budget), is killed with SIGKILL once a
           sidecar with b0 > 0 is on disk, and the resumed LU must be
           bit-equal to an uninterrupted run (the sidecar's bytes and save
           seconds, the resumed and uninterrupted walls, the K1 / K2
           launches of the resumed finish); the flagship with checkpoint=
           at the default budget takes the fused finish, writes no
           sidecar and is bit-equal to the run without; the same for the
           d8 boundary killed after the round checkpoint of round >= 1
  mesh     scale-out over torch.distributed: echelonize(d7, mesh=) at world
           size 1 (NCCL, this process) and 2 (two processes sharing the
           card over gloo), every rank's LU equal to the single-device LU
           (device_sparse_min_nnz=1), K3 launches per rank, each rank's
           tiles held against merge_rows_plain on the card;
           distributed_rank of a dense 4096^2 matrix of planted rank 3072
           at world sizes 1 and 2 against rank(A) on the card, with its K1
           launches; xapy / axpy of d8 on the card against scipy's
           product mod p on the host

With ``--profile DIR``, e2e also traces one warm flagship rank through
``spasm_tpu_torch.utils.profiling.trace`` (torch.profiler): kernel time by
name, the device's busy share, the device-to-host copies, the port's
kernel launches, and a Chrome trace in DIR; the fused phase traces one
warm flagship rank on each of the two block loops.

Every comparison is exact (GF(p) arithmetic: tolerance 0); a mismatch
raises.  The last three lines are the kernels' JSON (with each kernel's
bound at the timed shape and, for K1, an int8 tensor-core yardstick), the
card's name and power limit, and the status JSON.
Without a card, or without the spasm_tpu_torch package beside this script,
it exits non-zero before printing any result.
"""

from __future__ import annotations

import argparse
import contextlib
import dataclasses
import json
import math
import os
import pickle
import re
import shutil
import signal
import socket
import subprocess
import sys
import time

import numpy as np
import torch

PHASES = ("build", "k1", "k2", "k3", "rref", "e2e", "echelon", "fused",
          "tiers", "sparse", "waves", "api", "resume", "mesh")
DEV = "cuda"

# (n, k, m, p, acc): the K1 shapes that are timed.  With acc the wrapper is
# called as rref_inplace and the fused finish call it: adding into out=
# under a run flag, held against the plain product added to out (and, with
# the flag False, against out left as it was).  First the kernels line's
# shape, the fused finish's group update at the flagship (1024-row blocks,
# the most K1 time of its main path), and the same at 4 and 5 limbs (the
# tiers phase's primes); then its other shapes there: a
# panel's window correction, the windows of the earlier pivot rows, the
# group's 512^2 resolve and its resolved rows, the block correction early
# and late (K = 1024, 7168) and the back-elimination late; then the
# streaming loop's 1000-row shapes (resume, checkpoint, low-rank mode) and
# 4096^3
K1_TIMED = [
    (1024, 512, 8192, 42013, True),
    (1024, 512, 8192, 2147483629, True),
    (1024, 512, 8192, 4294967291, True),
    (1024, 128, 128, 42013, True),
    (128, 128, 128, 42013, True),
    (512, 512, 512, 42013, True),
    (512, 512, 8192, 42013, True),
    (1024, 1024, 8192, 42013, True),
    (1024, 7168, 8192, 42013, True),
    (7168, 1024, 8192, 42013, True),
    (1000, 128, 128, 42013, True),
    (1000, 512, 8192, 42013, True),
    (1000, 1000, 8192, 42013, False),
    (1000, 7168, 8192, 42013, False),
    (7168, 1000, 8192, 42013, False),
    (4096, 4096, 4096, 42013, False),
]
# compared only
K1_CASES = [
    (1000, 1000, 8192, 2147483629),   # tier B, 4 limbs
    (1000, 1000, 8192, 4294967291),   # tier C, 5 limbs
    (130, 260, 140, 42013),           # unaligned
    (130, 260, 140, 5),               # 1 limb
    (130, 260, 140, 92681),           # 3 limbs
    (130, 260, 140, 2147483629),      # 4 limbs
    (130, 260, 140, 4294967291),      # 5 limbs
    (1, 260, 140, 42013),             # n, k, m at 1 ...
    (130, 1, 140, 42013),
    (130, 260, 1, 42013),
    (1, 1, 1, 42013),
    (129, 260, 140, 42013),           # ... and one past a tile multiple
    (130, 129, 140, 42013),
    (130, 260, 129, 42013),
    (129, 129, 33, 4294967291),
    (40, 140_000, 48, 5),             # k past one 1-limb fold interval
    (40, 30_000, 48, 4294967291),     # k past one 5-limb fold interval
]
# the flagship: SparseGFp.rand(field(42013), N, N, 0.02, default_rng(5)),
# and its planted-rank variant keeping the first PLANTED_KEEP rows
FLAGSHIP_N, FLAGSHIP_NNZ, PLANTED_KEEP = 8192, 1_343_173, 7168
K2_PRIMES = (5, 42013, 92681, 2147483629, 4294967291)
K2_ROWS = (1000, 1024, 4096, 8192)
# K3 comparison widths: powers of two, the widths at the edges of the
# kernel's levels (32 keys a lane from 64 slots on, a row in one warp up to
# 32 E = 1024 slots, in one CTA up to 16384; 16385 and 65536 take the
# global-memory variant), the class widths that are not powers of two, and
# a wide one; each case holds about K3_SLOTS slots.
K3_WIDTHS = (128, 512, 2048, 8192, 16384, 65536, 80, 272, 1040, 40000,
             31, 32, 33, 511, 513, 1024, 1025, 2049, 16385)
K3_SLOTS = 1 << 21
# the tiles d8's one-pass gives K3, (rows, Wt) of its two classes' chunks,
# at d8's p and m, and a tile of random 30k's widest class (Wt 1040); all
# three are timed, the second is the kernels line's
K3_D8 = ((735471, 32), (262144, 272))
K3_D8_PM = (42013, 1562275)
K3_WIDE = (K3_SLOTS // 1040, 1040)
# the sparse phase's cases: simplex_boundary(n, k) with its rank, and the
# random matrix of the JAX package's tools/device_crossover.py
D7, D8 = (22, 7, 116280), (26, 8, 1081575)
RANDOM30K = (30000, 2e-4, 42)              # n, density, seed
# the waves phase: round 0 of SparseGFp.rand(field(42013), n, n, density,
# default_rng(seed)) beside d7's and random 30k's; and the case it
# echelonizes through the device waves: the smallest simplex boundary
# whose round-0 one-pass exceeds the card's 2**30 padded slots (no random
# 100000^2 matrix of a seeded scan both reaches the waves on the card and
# fits them: PERF.md section 4), with its rank
RANDOM100K = (100000, 2e-4, 42)
WAVES_E2E = (29, 8, 3108105)
# the api phase: right-hand sides of gesv on the flagship (half in the row
# space), the kernel of d8 (m - rank rows), and the case held card against
# CPU: SparseGFp.rand(field(42013), n, n, density, default_rng(seed)) with
# rows keep.. planted, whose dense-finish corner block has >= 1024 rows
API_GESV_RHS = 256
D8_KERNEL_ROWS = 480700
API_MID = (4000, 0.0013, 3, 3734)          # n, density, seed, keep
# the mesh phase's distributed_rank case: a dense n^2 matrix at p=42013
# whose rows keep.. are 3-row combinations of the rows above (seed), and
# the world sizes of the mesh runs
DIST_RANK = (4096, 3072, 15)
MESH_WORLDS = (1, 2)
# the resume phase's dense finish: rows a block (the default)
RESUME_BLOCK = 1000
# the tiers phase: the JAX package's large primes (bench.py's
# LARGE_PRIME_B and LARGE_PRIME_C: tier B, 4 limbs; tier C, 5 limbs), and
# the side of bench.py's dense_rref case (held against the CPU tensor
# path, which takes about 40 s at 2048^2 on the card's host)
TIER_PRIMES = (2147483629, 4294967291)
TIER_RREF = 2048
# the child processes of the tiers phase's CPU sides, and the torch
# threads of each
TIER_CPU_PROCS, TIER_CPU_THREADS = 3, 2
# seconds a child of the resume / mesh / tiers phases may take
CHILD_TIMEOUT_S = 600
# the settings a child process of the resume, mesh and tiers phases takes
# from this one
CHILD_KNOBS = ("DEV", "FLAGSHIP_N", "D7", "D8", "DIST_RANK", "RESUME_BLOCK",
               "API_MID", "TIER_RREF")
# the H100 SXM's published peaks (NVIDIA's data sheet, at 700 W) for the
# kernels' bounds: device memory, int8 tensor cores, and the float32 rate
# outside the tensor cores, which stands for the integer and compare work
# of K2 and K3 (two operations per multiply-add)
HBM_BYTES_S, INT8_OPS_S, ALU_OPS_S = 3.35e12, 1979e12, 67e12


def emit(phase: str, **kw) -> None:
    print(f"[{phase}] " + json.dumps(kw, default=str), flush=True)


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "-i", "0", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60)
    if out.returncode != 0:
        raise RuntimeError(f"nvidia-smi failed: {out.stderr.strip()}")
    return out.stdout.strip()


def sync() -> None:
    if DEV == "cuda":
        torch.cuda.synchronize()


def time_ms(fn, reps: int) -> float:
    """Mean ms of fn() over reps runs after one warm-up, by CUDA events."""
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def bound(nbytes: float, ops: float, ops_per_s: float):
    """(bound_ms, bound_by): the larger of bytes over the memory rate and
    operations over the peak rate for their type."""
    tb, to = nbytes / HBM_BYTES_S * 1e3, ops / ops_per_s * 1e3
    return (tb, "bytes") if tb >= to else (to, "operations")


def max_abs_diff(a: torch.Tensor, b: torch.Tensor) -> int:
    if a.shape != b.shape:
        raise AssertionError(f"shape {tuple(a.shape)} != {tuple(b.shape)}")
    if a.numel() == 0:
        return 0
    return int((a.long() - b.long()).abs().max())


_SASS_OP = re.compile(
    r"\s*/\*[0-9a-f]{4,}\*/\s+(?:@!?U?P\w+\s+)?([A-Z][\w.]*)")


def sass_census(lib_path: str, mnemonics=("IGMMA", "UTMALDG", "SYNCS")):
    """{kernel: {instruction: count}} for K1's product kernels in the
    built library, from ``cuobjdump -sass``, over the instructions that
    start with one of ``mnemonics``: IGMMA is the warpgroup integer MMA
    (wgmma), UTMALDG a TMA tensor load, SYNCS an mbarrier operation.
    None where the toolkit has no cuobjdump."""
    tool = shutil.which("cuobjdump") or "/usr/local/cuda/bin/cuobjdump"
    if not os.path.exists(tool):
        return None
    text = subprocess.run([tool, "-sass", lib_path], capture_output=True,
                          text=True, check=True).stdout
    census: dict = {}
    kernel = None
    for line in text.splitlines():
        if line.lstrip().startswith("Function :"):
            m = re.search(r"modmatmul_kernelILi(\d)E", line)
            kernel = f"modmatmul_kernel<{m[1]}>" if m else None
            continue
        m = _SASS_OP.match(line)
        if m and kernel and m.group(1).startswith(tuple(mnemonics)):
            ops = census.setdefault(kernel, {})
            ops[m.group(1)] = ops.get(m.group(1), 0) + 1
    return census


def ptxas_spills(log: str, kernel: str) -> dict:
    """{mangled name: spill store + load bytes} from ``-Xptxas=-v`` output,
    over the functions whose name holds ``kernel`` (empty when the library
    came from the cache and nothing was compiled)."""
    out, name = {}, None
    for ln in log.splitlines():
        m = re.search(r"Function properties for (\S+)", ln)
        if m:
            name = m[1]
            continue
        m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads",
                      ln)
        if m and name and kernel in name:
            out[name] = int(m[1]) + int(m[2])
    return out


def phase_build(ctx):
    from spasm_tpu_torch.ops import _cuda

    ctx["card"] = card_line()
    print(ctx["card"], flush=True)
    t0 = time.perf_counter()
    _cuda.lib()
    wall = time.perf_counter() - t0
    ptxas = [ln.strip() for ln in _cuda.build_log.splitlines()
             if any(w in ln for w in ("Used", "spill", "Compiling entry",
                                      "arning", "wgmma", "setmaxnreg"))]
    for ln in ptxas:
        print("  ptxas: " + ln)
    # K3 keeps its keys in registers: an array spilled to local memory
    # would undo the design, so a spill in any of its kernels fails
    k3_spills = ptxas_spills(_cuda.build_log, "merge_rows_kernel")
    if any(k3_spills.values()):
        raise AssertionError(f"K3 spills: {k3_spills}")
    # what the product kernels compiled to: the warpgroup s8 MMA (IGMMA,
    # never saturating) fed by TMA tensor loads (UTMALDG) on mbarriers
    sass = sass_census(_cuda.lib_path) if DEV == "cuda" else None
    for name, ops in (sass or {}).items():
        mma = [op for op in ops if op.startswith("IGMMA")]
        if (not mma or any("SAT" in op or ".S8.S8" not in op for op in mma)
                or not any(op.startswith("UTMALDG") for op in ops)):
            raise AssertionError(f"{name}: unexpected SASS {ops}")
    if sass is not None and len(sass) != 5:
        raise AssertionError(f"expected 5 product kernels: {sass}")
    emit("build", card=ctx["card"], kind=torch.cuda.get_device_name(0),
         torch=torch.__version__, cuda=torch.version.cuda,
         nvcc_s=_cuda.build_seconds, load_s=round(wall, 3),
         sources=[s.split("spasm_tpu_torch/")[-1] for s in _cuda.sources()],
         sass=sass, k3_spill_bytes=k3_spills)


def k1_operands(f, n, k, m, rng, views: bool = False):
    """Balanced int32 operands on the card, the extremes of the balanced
    range included; with ``views`` a is a column window of a wider matrix
    (row stride > k, start not 16-byte aligned) and b a transposed view
    (column stride != 1)."""
    a = f.rand((n, k + 7 if views else k), rng).astype(np.int32)
    b = f.rand((m, k) if views else (k, m), rng).astype(np.int32)
    half = (f.p - 1) // 2
    a[0, 3:5] = (half, -half) if k > 1 else half
    b[0, :2] = (half, -half) if min(b.shape) > 1 else -half
    a, b = torch.from_numpy(a).to(DEV), torch.from_numpy(b).to(DEV)
    if views:
        a, b = a[:, 3:3 + k], b.T
    return a, b


def k1_split_check(f, a, b) -> dict:
    """The split kernel against pack_planes_plain on both operands, byte
    for byte; returns the packed planes."""
    from spasm_tpu_torch._host.field import num_limbs
    from spasm_tpu_torch.ops import cuda_matmul as cm

    nl = num_limbs(f.p)
    (n, k), m = a.shape, b.shape[1]
    np_, kp, mp = cm.padded(n, k, m, nl)
    ap = cm.split_cuda(a, nl, np_, kp)
    bp = cm.split_cuda(b, nl, mp, kp, transpose=True)
    want_a = cm.pack_planes_plain(f, a, nl, np_, kp)
    want_b = cm.pack_planes_plain(f, b, nl, mp, kp, transpose=True)
    sync()
    return dict(ap=ap, bp=bp, err=max(max_abs_diff(ap, want_a),
                                      max_abs_diff(bp, want_b)))


def by_prime(ctx, name: str, p: int, rec: dict) -> None:
    """Keep a kernel's time at its kernels-line shape by prime (the
    kernels line's ``by_prime``)."""
    ctx.setdefault("by_prime", {}).setdefault(name, {})[str(p)] = {
        k: rec[k] for k in ("ms", "plain_ms", "bound_ms", "bound_by")}


def phase_k1(ctx):
    from spasm_tpu_torch import field
    from spasm_tpu_torch._host.field import num_limbs
    from spasm_tpu_torch.ops import cuda_matmul as cm
    from spasm_tpu_torch.ops import modmul
    from spasm_tpu_torch.ops.matmul import modmatmul_plain

    for nl in range(1, 6):
        want = (cm.BM, cm.BN[nl], cm.BK, cm.fold_interval(nl))
        if DEV == "cuda" and cm.tiles(nl) != want:
            raise AssertionError(f"K1 tiles at {nl} limbs: the library "
                                 f"says {cm.tiles(nl)}, the wrapper {want}")
    rng = np.random.default_rng(11)
    worst = worst_split = 0
    cases = ([(n, k, m, p, False, acc) for n, k, m, p, acc in K1_TIMED]
             + [c + (False, False) for c in K1_CASES]
             + [(130, 260, 140, p, True, False) for p in K2_PRIMES])
    for i, (n, k, m, p, views, acc) in enumerate(cases):
        f = field(p)
        nl = num_limbs(p)
        a, b = k1_operands(f, n, k, m, rng, views)
        sp = k1_split_check(f, a, b)
        ap, bp = sp["ap"], sp["bp"]
        want = modmatmul_plain(f, a, b)
        c0 = flag = None
        if acc:
            c0 = torch.from_numpy(f.rand((n, m), rng).astype(np.int32)).to(DEV)
            flag = torch.ones((), dtype=torch.bool, device=DEV)
            err = max(max_abs_diff(cm.modmatmul_cuda(
                f, a, b, out=c0.clone(), run=flag), modmul.add(f, c0, want)),
                max_abs_diff(cm.modmatmul_cuda(
                    f, a, b, out=c0.clone(), run=~flag), c0))
        else:
            err = max_abs_diff(cm.modmatmul_cuda(f, a, b), want)
        err = max(err, max_abs_diff(cm.product_cuda(f, ap, bp, n, m), want))
        sync()
        worst, worst_split = max(worst, err), max(worst_split, sp["err"])
        rec = dict(shape=[n, k, m], p=p, limbs=nl, views=views, acc=acc,
                   folds=((ap.shape[2] // cm.BK - 1)
                          // (cm.fold_interval(nl) // cm.BK)),
                   split_max_abs_err=sp["err"], max_abs_err=err)
        if i < len(K1_TIMED):
            def wrapper():
                if acc:   # out += a @ b, in place, under the run flag
                    return cm.modmatmul_cuda(f, a, b, out=c0, run=flag)
                return cm.modmatmul_cuda(f, a, b)

            def plain():
                if acc:
                    return modmul.add(f, c0, modmatmul_plain(f, a, b))
                return modmatmul_plain(f, a, b)

            def split():
                cm.split_cuda(a, nl, ap.shape[1], ap.shape[2])
                cm.split_cuda(b, nl, bp.shape[1], bp.shape[2], transpose=True)

            def split_plain():
                cm.pack_planes_plain(f, a, nl, ap.shape[1], ap.shape[2])
                cm.pack_planes_plain(f, b, nl, bp.shape[1], bp.shape[2],
                                     transpose=True)

            def product():
                return cm.product_cuda(f, ap, bp, n, m)

            # timed in turns: kernel, plain, plain, kernel
            t = [time_ms(wrapper, 10), time_ms(plain, 2), time_ms(plain, 2),
                 time_ms(wrapper, 10)]
            ts = [time_ms(split, 10), time_ms(split_plain, 2),
                  time_ms(split_plain, 2), time_ms(split, 10)]
            tp = [time_ms(product, 10), time_ms(product, 10)]
            rec.update(ms=min(t[0], t[3]), plain_ms=min(t[1], t[2]),
                       split_ms=min(ts[0], ts[3]),
                       split_plain_ms=min(ts[1], ts[2]),
                       product_ms=min(tp),
                       ms_runs=t + ts + tp)
            modp_ops = 2.0 * n * k * m
            rec["modp_tops"] = modp_ops / (rec["ms"] * 1e-3) / 1e12
            # the kernel's method: nl**2 int8 plane products on the
            # tensor cores; each operand read once, C written once (and
            # read once with acc)
            rec["bound_ms"], rec["bound_by"] = bound(
                4.0 * (n * k + k * m + (1 + acc) * n * m),
                nl * nl * modp_ops, INT8_OPS_S)
            # the split: the int32 operands read, the padded planes written
            rec["split_bound_ms"], _ = bound(
                4.0 * (n * k + k * m) + ap.numel() + bp.numel(), 0,
                ALU_OPS_S)
            rec["int8_share"] = rec["bound_ms"] / rec["product_ms"]
            if (n, k, m) == K1_TIMED[0][:3]:
                by_prime(ctx, "modmatmul", p, rec)
        if i == 0:
            # yardstick, not the same function: torch._int_mm of one int8
            # limb plane, times nl**2 (the port never calls it)
            a8 = torch.randint(-128, 128, (n, k), dtype=torch.int8,
                               device=DEV)
            b8 = torch.randint(-128, 128, (k, m), dtype=torch.int8,
                               device=DEV)
            rec["library_ms"] = nl * nl * time_ms(
                lambda: torch._int_mm(a8, b8), 5)
            del a8, b8
            ctx["k1_time"] = (rec["ms"], rec["plain_ms"], rec["bound_ms"],
                              rec["bound_by"], rec["library_ms"])
            ctx["k1_extra"] = dict(split_ms=rec["split_ms"],
                                   product_ms=rec["product_ms"])
            ctx["k1s_time"] = (rec["split_ms"], rec["split_plain_ms"],
                               rec["split_bound_ms"], "bytes", None)
        emit("k1", **rec)
        if err or sp["err"]:
            raise AssertionError(f"K1 differs from plain at {rec}")
        if k >= 30_000 and not rec["folds"]:
            raise AssertionError(f"no fold inside the k loop at {rec}")
        del a, b, ap, bp, sp, want, c0
    ctx["k1_err"], ctx["k1s_err"] = worst, worst_split


def make_panel(f, n, c, rng, kind: str = "full"):
    """An (n, c) panel with zeros, planted zero columns and rows, duplicate
    rows and pre-pivoted rows.  ``kind``: "full" (every column eligible),
    "cut" (only the first 2c/3 columns), "allpiv" (every row pre-pivoted)
    or "nocols" (npivcols <= j0: no column eligible)."""
    P = f.rand((n, c), rng).astype(np.int32)
    P[rng.random((n, c)) < 0.4] = 0
    P[:, [3, c // 2, (3 * c) // 4]] = 0
    P[rng.choice(n, n // 20, replace=False)] = 0
    P[n // 2] = P[n // 3]
    ispiv = np.zeros(n, bool)
    ispiv[rng.choice(n, n // 10, replace=False)] = True
    if kind == "allpiv":
        ispiv[:] = True
    j0, npivcols = {"cut": (256, 256 + (2 * c) // 3),
                    "nocols": (256, 200)}.get(kind, (0, c))
    return P, ispiv, j0, npivcols


def panel_work(f, P, ispiv, j0, npivcols) -> int:
    """Mod-p multiply-adds this panel needs: a replay of the per-step form
    on the host, counting at each pivot every row with a nonzero in the
    pivot column times the columns that can change (P from the pivot
    column on, G up to the slot)."""
    P = P.astype(np.int64)
    isp = ispiv.copy()
    n, c = P.shape
    kk = work = 0
    for jj in range(c):
        if j0 + jj >= npivcols:
            break
        col = P[:, jj].copy()
        cand = np.flatnonzero((col != 0) & ~isp)
        if not cand.size:
            continue
        pr = int(cand[0])
        rows = np.flatnonzero(col)
        work += rows.size * ((c - jj) + (kk + 1))
        pinv = int(f.inv(np.int64(col[pr])))
        beta = f.normalize(-col * pinv)
        beta[pr] = f.normalize(np.int64(pinv - 1))
        P[rows] = f.normalize(P[rows] + beta[rows, None] * P[pr][None, :])
        isp[pr] = True
        kk += 1
    return work


def k2_phases(f, Pt, It, j0, npivcols) -> dict:
    """Mean microseconds of a pivot step's phases, from one launch whose
    first CTA stamps the global timer at each phase's end."""
    from spasm_tpu_torch.ops import cuda_panel

    c = Pt.shape[1]
    stamps = torch.zeros((c, 1 + len(cuda_panel.PHASES)), dtype=torch.int64,
                         device=Pt.device)
    cuda_panel.panel_eliminate_cuda(f, npivcols, Pt, It, j0, stamps=stamps)
    t = stamps.cpu().numpy().astype(np.float64)
    t = t[t[:, -1] > 0]                      # the steps with a pivot
    d = np.diff(t, axis=1).mean(axis=0) / 1e3
    out = {nm: round(float(x), 4) for nm, x in zip(cuda_panel.PHASES, d)}
    out["step"] = round(float((t[:, -1] - t[:, 0]).mean() / 1e3), 4)
    out["pivot_steps"] = int(t.shape[0])
    # the shortest pass through the cluster barrier, from the first CTA's
    # push to its release: no step can take less
    out["min_barrier"] = round(float((t[:, 2] - t[:, 1]).min() / 1e3), 4)
    return out


def phase_k2(ctx):
    from spasm_tpu_torch import field
    from spasm_tpu_torch.ops import cuda_panel
    from spasm_tpu_torch.ops.dense import _panel_eliminate

    rng = np.random.default_rng(12)
    names = ("P", "G", "prow", "pcol", "pfound", "is_piv")
    # (n, c, p, kind): c = 37 takes the kernel's scalar (not int4) path;
    # n = 1024 is the fused finish's panel, 1000 the streaming loop's;
    # n = 4096 and 8192 keep the rows in global memory; n = 192 is the
    # flagship's last block, 1 and 5 leave CTAs of the 16-CTA cluster
    # without rows; c = 1000 and 4096 are the widest panels
    cases = [(n, 128, p, "full") for n in K2_ROWS for p in K2_PRIMES]
    cases += [(n, 128, 42013, "cut") for n in K2_ROWS]
    cases += [(96, 128, 42013, "full"), (300, 37, 42013, "full"),
              (300, 37, 4294967291, "cut"), (192, 128, 42013, "full"),
              (1, 128, 42013, "full"), (5, 128, 42013, "full"),
              (5, 37, 4294967291, "full"), (1000, 128, 42013, "allpiv"),
              (1000, 128, 42013, "nocols"), (64, 1000, 2147483629, "full"),
              (64, 4096, 42013, "full")]
    worst = 0
    for n, c, p, kind in cases:
        f = field(p)
        P, ispiv, j0, npivcols = make_panel(f, n, c, rng, kind)
        Pt = torch.from_numpy(P).to(DEV)
        It = torch.from_numpy(ispiv).to(DEV)

        def kernel():
            return cuda_panel.panel_eliminate_cuda(f, npivcols, Pt, It, j0)

        def plain():
            return _panel_eliminate(f, Pt, It, j0, npivcols)

        got = kernel()
        want = plain()
        sync()
        errs = {nm: max_abs_diff(g, w) for nm, g, w in zip(names, got, want)}
        err = max(errs.values())
        worst = max(worst, err)
        rec = dict(n=n, c=c, p=p, kind=kind, j0=j0, npivcols=npivcols,
                   pivots=int(want[4].sum()), max_abs_err=err)
        if c == 128 and kind == "full" and (
                n == 1024 or p == 42013 and n in (1000, 4096)):
            # timed in turns: kernel, plain, plain, kernel
            t = [time_ms(kernel, 20), time_ms(plain, 2), time_ms(plain, 2),
                 time_ms(kernel, 20)]
            rec.update(ms=min(t[0], t[3]), plain_ms=min(t[1], t[2]),
                       ms_runs=t)
            # P read, P and G written, is_piv read and written, and the
            # three pivot vectors written; two operations a multiply-add
            work = panel_work(f, P, ispiv, j0, npivcols)
            rec["muladds"] = work
            rec["bound_ms"], rec["bound_by"] = bound(
                12.0 * n * c + 2.0 * n + 9.0 * c, 2.0 * work, ALU_OPS_S)
            # the steps are a chain: each waits on one cluster barrier
            st = k2_phases(f, Pt, It, j0, npivcols)
            rec["latency_bound_ms"] = (st["pivot_steps"] * st["min_barrier"]
                                       / 1e3)
            rec["step_us"] = st
            if n == 1024:   # the fused finish's panels
                by_prime(ctx, "panel", p, rec)
            if n == 1024 and p == 42013:
                ctx["k2_time"] = (rec["ms"], rec["plain_ms"],
                                  rec["bound_ms"], rec["bound_by"], None)
        emit("k2", **rec)
        no_pivot = kind in ("allpiv", "nocols")
        if err or bool(rec["pivots"]) == no_pivot:
            raise AssertionError(f"K2 differs from plain at {rec}: {errs}")
    ctx["k2_err"] = worst


def merge_tile(f, R, W, m, rng, span=None):
    """An (R, W) merge tile: int32 cols in [0, m] (each row's live cols in
    a window of ``span`` (default m) values, so duplicates are frequent;
    30% dead slots with col == m and val 0) and balanced vals, with an
    all-dead row, a row whose entries all cancel, a single-run row and a
    row of one repeated entry."""
    span = span or m
    base = rng.integers(0, m - span + 1, (R, 1))
    cols = (base + rng.integers(0, span, (R, W))).astype(np.int32)
    cols[rng.random((R, W)) < 0.3] = m
    vals = f.rand((R, W), rng).astype(np.int64)
    vals[cols == m] = 0
    cols[0], vals[0] = m, 0
    h = W // 2
    cols[1, :h] = rng.integers(0, m, h)
    cols[1, h:2 * h] = cols[1, :h]
    vals[1, h:2 * h] = -vals[1, :h]
    cols[1, 2 * h:], vals[1, 2 * h:] = m, 0
    cols[2] = m // 2
    cols[3], vals[3] = m // 3, vals[3, 0]
    return (torch.from_numpy(cols).to(DEV),
            torch.from_numpy(vals.astype(np.int32)).to(DEV))


def k3_timed(f, c, v, m) -> dict:
    """K3, its plain version and the torch.sort yardstick on one tile, in
    turns (kernel, plain, plain, kernel)."""
    from spasm_tpu_torch.ops import cuda_merge
    from spasm_tpu_torch.ops.merge import merge_rows_plain

    R, W = c.shape

    def kernel():
        return cuda_merge.merge_rows_cuda(f, c, v, m)

    def plain():
        return merge_rows_plain(f, c, v, m)

    t = [time_ms(kernel, 5), time_ms(plain, 2), time_ms(plain, 2),
         time_ms(kernel, 5)]
    rec = dict(ms=min(t[0], t[3]), plain_ms=min(t[1], t[2]), ms_runs=t)
    # yardstick, not the same function: a library sort of the same rows
    # by the same composite key (no sum, no flags)
    key = (c.to(torch.int64) << 32) | (v.to(torch.int64) & 0xFFFFFFFF)
    rec["sort_ms"] = time_ms(lambda: torch.sort(key, dim=1), 5)
    del key
    # one read and one write of every slot: 8 bytes in, 9 out
    rec["gbps"] = R * W * 17 / (rec["ms"] * 1e-3) / 1e9
    # the bitonic network on the row padded to Wp: Wp/2 compare-exchanges
    # in each of L(L+1)/2 stages
    L = (W - 1).bit_length()
    rec["bound_ms"], rec["bound_by"] = bound(
        17.0 * R * W, R * (2 ** L // 2) * L * (L + 1) / 2, ALU_OPS_S)
    rec["bound_share"] = rec["bound_ms"] / rec["ms"]
    return rec


def phase_k3(ctx):
    from spasm_tpu_torch import field
    from spasm_tpu_torch.ops import cuda_merge
    from spasm_tpu_torch.ops.merge import merge_rows_plain

    # both versions sort each row by (col, val as uint32), so the sorted
    # row, and with it every partial sum, is unique: the contract is
    # bit-equality of cols, vals and keep at every slot
    rng = np.random.default_rng(14)
    names = ("cols", "vals", "keep")
    # (R, W, p, m, span, timed)
    cases = [(max(4, K3_SLOTS // W), W, p, max(4, W // 3), None, False)
             for W in K3_WIDTHS for p in K2_PRIMES]
    cases.append((4, 1 << 20, 42013, (1 << 20) // 3, None, False))
    p8, m8 = K3_D8_PM
    cases += [(R, W, p8, m8, max(4, W // 3), True) for R, W in K3_D8]
    cases.append(K3_WIDE + (p8, m8, max(4, K3_WIDE[1] // 3), True))
    worst = 0
    timed = {}
    for R, W, p, m, span, is_timed in cases:
        f = field(p)
        c, v = merge_tile(f, R, W, m, rng, span)
        got = cuda_merge.merge_rows_cuda(f, c, v, m)
        want = merge_rows_plain(f, c, v, m)
        sync()
        errs = {nm: max_abs_diff(g, w) for nm, g, w in zip(names, got, want)}
        err = max(errs.values())
        worst = max(worst, err)
        rec = dict(R=R, W=W, p=p, m=m, kept=int(want[2].sum()),
                   max_abs_err=err)
        del got, want
        if is_timed:
            rec.update(k3_timed(f, c, v, m))
            timed[f"{R}x{W}"] = {k: rec[k] for k in (
                "ms", "plain_ms", "sort_ms", "bound_ms", "bound_share")}
            if (R, W) == K3_D8[1]:
                ctx["k3_time"] = (rec["ms"], rec["plain_ms"],
                                  rec["bound_ms"], rec["bound_by"], None)
        emit("k3", **rec)
        if err:
            raise AssertionError(f"K3 differs from plain at {rec}: {errs}")
        del c, v
    ctx["k3_err"] = worst
    ctx["k3_extra"] = dict(tiles=timed)


def phase_rref(ctx):
    from spasm_tpu_torch import field
    from spasm_tpu_torch.ops import cuda_matmul, cuda_panel, dense

    f = field(42013)
    rng = np.random.default_rng(13)
    n = 1024
    X = f.rand((n, n), rng).astype(np.int32)
    X[rng.random((n, n)) < 0.5] = 0
    X[700:] = f.normalize(X[:324].astype(np.int64) * 5)   # rank 700
    X[:, 5] = 0
    l0, p0 = cuda_matmul.launches, cuda_panel.launches
    t0 = time.perf_counter()
    got = dense.rref(f, torch.from_numpy(X).to(DEV), want_transform=True,
                     host_cutoff=0)
    wall = time.perf_counter() - t0
    k1, k2 = cuda_matmul.launches - l0, cuda_panel.launches - p0
    want = dense.rref(f, torch.from_numpy(X), want_transform=True,
                      host_cutoff=0)
    bad = [k for k in ("R", "rank", "piv_rows", "piv_cols", "qinv", "T")
           if not np.array_equal(np.asarray(got[k]), np.asarray(want[k]))]
    emit("rref", shape=[n, n], p=f.p, rank=got["rank"], group_card=
         dense.PANEL_GROUP, k1_launches=k1, k2_launches=k2,
         card_s=round(wall, 4), mismatched=bad)
    if bad or got["rank"] != 700:
        raise AssertionError(f"rref card != cpu in {bad}, rank "
                             f"{got['rank']}")
    if DEV == "cuda" and not (k1 and k2):
        raise AssertionError("the card rref launched no kernel")


def planted_rank(A, keep: int, rng):
    """A with rows keep.. replaced by random 3-row combinations of rows
    0..keep-1, computed exactly on the host."""
    import scipy.sparse as sp

    from spasm_tpu_torch import SparseGFp

    f = A.field
    n, m = A.shape
    S = A.to_scipy().astype(np.int64)
    B = S[:keep]
    extra = n - keep
    rows = np.repeat(np.arange(extra), 3)
    cols = np.stack([rng.choice(keep, 3, replace=False)
                     for _ in range(extra)]).ravel()
    coef = rng.integers(1, f.p, rows.size) - f.p // 2
    coef[coef == 0] = 1
    C = sp.csr_matrix((coef.astype(np.int64), (rows, cols)),
                      shape=(extra, keep))
    new = (C @ B).tocsr()
    new.data = f.normalize(new.data)
    new.eliminate_zeros()
    return SparseGFp.from_scipy(sp.vstack([B, new]).tocsr(), f.p)


def timed_rank(A, reps: int = 1):
    from spasm_tpu_torch import last_phase_stats, rank

    walls, r = [], None
    for _ in range(reps):
        t0 = time.perf_counter()
        r = rank(A, device=DEV)
        sync()
        walls.append(time.perf_counter() - t0)
    return r, walls, last_phase_stats()


# the port's kernels by their function names, and the wrapper counts
# their launches go to
OWN_KERNELS = {"modmatmul_kernel": "modmatmul",
               "split_rows_kernel": "modmatmul_split",
               "split_transpose_kernel": "modmatmul_split",
               "panel_cluster_kernel": "panel"}


def profile_rank(A, out_dir, label: str = "flagship") -> dict:
    """Trace one rank(A) on the card: kernel time by name, busy share,
    device-to-host copies and the port's kernel launches.  Returns the
    launches of the port's kernels as the profiler saw them run, by
    wrapper count (a replayed graph launches them without the wrappers);
    with no ``out_dir`` the trace goes to a scratch directory."""
    from torch.autograd import DeviceType

    from spasm_tpu_torch import rank
    from spasm_tpu_torch.utils.profiling import trace

    out_dir = out_dir or work_dir("profile")
    reset_launches()
    with trace(out_dir) as prof:
        t0 = time.perf_counter()
        rank(A, device=DEV)
        sync()
        wall = time.perf_counter() - t0
    launches = read_launches()

    def dev_us(e):
        return (getattr(e, "self_device_time_total", None)
                or getattr(e, "self_cuda_time_total", 0))

    kernels = [e for e in prof.key_averages()
               if e.device_type == DeviceType.CUDA and dev_us(e) > 0]
    busy_s = sum(dev_us(e) for e in kernels) / 1e6
    top = sorted(kernels, key=dev_us, reverse=True)[:15]
    events = prof.key_averages()
    own = {nm: dict(calls=sum(e.count for e in kernels if nm in e.key),
                    device_ms=round(sum(dev_us(e) for e in kernels
                                        if nm in e.key) / 1e3, 3))
           for nm in OWN_KERNELS}
    ran = {k: 0 for k in ("modmatmul", "modmatmul_split", "panel")}
    for nm, counted in OWN_KERNELS.items():
        ran[counted] += own[nm]["calls"]
    emit("profile", label=label, wall_s=round(wall, 4),
         device_busy_s=round(busy_s, 4),
         busy_share=round(busy_s / wall, 4),
         kernel_launches=sum(e.count for e in kernels),
         # device-to-host copies: the host reads of the run
         d2h_copies=sum(e.count for e in events if "DtoH" in e.key),
         port_launches=launches,
         elementwise_launches=sum(e.count for e in kernels
                                  if "elementwise" in e.key),
         # the port's own kernels, by their function names
         own=own, profiled_launches=ran,
         top=[dict(name=e.key[:90], calls=e.count,
                   device_ms=round(dev_us(e) / 1e3, 3)) for e in top],
         trace=os.path.join(out_dir, f"trace_{os.getpid()}.json"))
    return ran


def phase_e2e(ctx):
    from spasm_tpu_torch import SparseGFp, field, rank
    from spasm_tpu_torch._host.fixtures import simplex_boundary
    from spasm_tpu_torch.ops import cuda_matmul, cuda_panel

    f = field(42013)
    N = FLAGSHIP_N
    A = SparseGFp.rand(f, N, N, 0.02, np.random.default_rng(5))
    if A.nnz != FLAGSHIP_NNZ:
        raise AssertionError(f"flagship nnz {A.nnz} != {FLAGSHIP_NNZ}")
    # the main path's launch counts: reset right before, read right after
    cuda_matmul.launches = cuda_matmul.split_launches = 0
    cuda_panel.launches = 0
    t0 = time.perf_counter()
    r = rank(A, device=DEV)
    sync()
    first = time.perf_counter() - t0
    ctx["launches"] = {"modmatmul": cuda_matmul.launches,
                       "modmatmul_split": cuda_matmul.split_launches,
                       "panel": cuda_panel.launches}
    note_path(ctx, "e2e: flagship rank (a shape's first call: eager)",
              ctx["launches"])
    r2, walls, stats = timed_rank(A, reps=2)
    emit("e2e", case=f"flagship {N}x{N} d=0.02 p=42013 seed 5", nnz=A.nnz,
         rank=r, expected=N, first_wall_s=round(first, 4),
         warm_walls_s=[round(w, 4) for w in walls], phases=stats,
         launches=ctx["launches"])
    if r != N or r2 != N:
        raise AssertionError(f"flagship rank {r}, {r2} != {N}")
    if DEV == "cuda" and not all(ctx["launches"].values()):
        raise AssertionError(f"a kernel was not launched: {ctx['launches']}")

    if ctx.get("profile_dir"):
        profile_rank(A, ctx["profile_dir"])

    Ap = planted_rank(A, PLANTED_KEEP, np.random.default_rng(6))
    r, walls, stats = timed_rank(Ap, reps=2)
    emit("e2e", case=f"planted rank: rows {PLANTED_KEEP}.. = 3-row "
         "combinations of the rows above", nnz=Ap.nnz, rank=r,
         expected=PLANTED_KEEP, walls_s=[round(w, 4) for w in walls],
         phases=stats)
    if r != PLANTED_KEEP:
        raise AssertionError(f"planted rank {r} != {PLANTED_KEEP}")

    B = simplex_boundary(22, 7)
    want = math.comb(21, 7)
    r, walls, stats = timed_rank(B, reps=2)
    emit("e2e", case="simplex boundary (22, 7)", shape=list(B.shape),
         nnz=B.nnz, rank=r, expected=want,
         walls_s=[round(w, 4) for w in walls], phases=stats)
    if B.shape != (319770, 170544) or B.nnz != 2558160 or r != want:
        raise AssertionError(f"d7: shape {B.shape} nnz {B.nnz} rank {r}")


def phase_echelon(ctx):
    echelon_card_vs_cpu(ctx, "echelon", 42013)


def echelon_run(p: int, device: str):
    """The 3000 x 720 case at p through echelonize on ``device``: its LU
    arrays, phase walls and the finish it took (the log line)."""
    from spasm_tpu_torch import SparseGFp, echelonize, field, last_phase_stats
    from spasm_tpu_torch._host.utils import logging as slog
    from spasm_tpu_torch.interop import lu_arrays

    A = SparseGFp.rand(field(p), 3000, 720, 0.05, np.random.default_rng(7))
    lines: list[str] = []
    slog.set_log(lines.append)
    try:
        fact = echelonize(A, device=device, dense_block_size=1500,
                          verbose=True)
    finally:
        slog.set_log(None)
    path = [ln for ln in lines if ln.startswith(
        "[echelonize/dense] processing")]
    return lu_arrays(fact), last_phase_stats(), path, A.nnz


def echelon_card_vs_cpu(ctx, phase: str, p: int, cpu=None) -> None:
    """echelon_run at p on the card against the CPU's (``cpu``, or run
    here): the same finish taken, bit-equal LUs."""
    got, st_g, path_g, nnz = echelon_run(p, DEV)
    want, st_c, path_c, _ = cpu or echelon_run(p, "cpu")
    bad = [k for k in want if not np.array_equal(got.get(k), want[k])]
    emit(phase, case="echelon", p=p, shape=[3000, 720], nnz=nnz,
         rank=int(got["r"]), path_card=path_g, path_cpu=path_c,
         device_s=[st_g["device_s"], st_c["device_s"]], mismatched=bad)
    if bad or set(got) != set(want):
        raise AssertionError(f"echelonize card != cpu in {bad}")
    if not (path_g and path_g == path_c and path_g[0].endswith("(device)")):
        raise AssertionError(f"the runs took different finishes: {path_g} "
                             f"vs {path_c}")


# warm calls (replays) of each fused-phase case after the first (eager)
# and the second (which captures)
FUSED_WARM = 2


def run_flag_checks(p: int = 42013) -> dict:
    """(e): K2 with its run flag against _panel_eliminate with the same
    flag, on an all-zero (1024, 128) panel (the fused finish's) and a live
    one, both flags; K1
    accumulating into out under its run flag (the group update's shape)
    against the plain product added to out; at the prime p.  Max abs
    differences."""
    from spasm_tpu_torch import field
    from spasm_tpu_torch.ops import cuda_matmul, cuda_panel, dense, matmul

    f = field(p)
    rng = np.random.default_rng(31)
    live = f.rand((1024, 128), rng).astype(np.int32)
    live[rng.random(live.shape) < 0.4] = 0
    ispiv = torch.zeros(1024, dtype=torch.bool, device=DEV)
    ispiv[::7] = True
    out = {"k2": 0, "k1": 0}
    for P in (np.zeros_like(live), live):
        Pt = torch.from_numpy(P).to(DEV)
        for run in (False, True):
            flag = torch.tensor(run, device=DEV)
            got = cuda_panel.panel_eliminate_cuda(f, 128, Pt, ispiv, 0,
                                                  run=flag)
            want = dense._panel_eliminate(f, Pt, ispiv, 0, 128, flag)
            out["k2"] = max([out["k2"]] + [max_abs_diff(g.long(), w.long())
                                           for g, w in zip(got, want)])
    a, b, c = (torch.from_numpy(f.rand(sh, rng).astype(np.int32)).to(DEV)
               for sh in ((1024, 512), (512, 8192), (1024, 8192)))
    for run in (False, True):
        flag = torch.tensor(run, device=DEV)
        got = cuda_matmul.modmatmul_cuda(f, a, b, out=c.clone(), run=flag)
        want = c.clone()
        if run:
            want = dense.modmul.add(f, c, matmul.modmatmul_plain(f, a, b))
        out["k1"] = max(out["k1"], max_abs_diff(got, want))
    return out


# the finish's upload (dense.upload_csr) and fused_blocked_finish run
# under the sync debugger inside watched_finish(): "warn" for a first call
# (its syncs counted), "error" for a capture or a replay; the two reads
# after it are outside
_WATCH = {"mode": "warn", "calls": 0, "syncs": 0, "sites": []}


def _guarded(fn, count=False):
    import warnings

    def run(*a, **k):
        _WATCH["calls"] += count
        if DEV != "cuda":
            return fn(*a, **k)
        with warnings.catch_warnings(record=True) as seen:
            warnings.simplefilter("always")
            torch.cuda.set_sync_debug_mode(_WATCH["mode"])
            try:
                return fn(*a, **k)
            finally:
                torch.cuda.set_sync_debug_mode(0)
                # not the notice that the debug mode is a prototype
                syncs = [x for x in seen if "synchronizing CUDA "
                         "operation" in str(x.message)]
                _WATCH["syncs"] += len(syncs)
                _WATCH["sites"] += [f"{os.path.basename(x.filename)}:"
                                    f"{x.lineno}" for x in syncs]
    return run


@contextlib.contextmanager
def watched_finish():
    """dense.upload_csr (S's CSR uploaded, its COO formed on the card) and
    dense.fused_blocked_finish under the sync debugger (the latter
    counted); the graph cache is freed on the way out."""
    from spasm_tpu_torch.ops import dense

    real_up, real_fb = dense.upload_csr, dense.fused_blocked_finish
    dense.upload_csr = _guarded(real_up)
    dense.fused_blocked_finish = _guarded(real_fb, count=True)
    try:
        yield
    finally:
        dense.upload_csr, dense.fused_blocked_finish = real_up, real_fb
        dense.release_finish_graphs()


def timed_finish(M, kw, mode, facts=None):
    """echelonize(M, device=DEV, **kw) inside watched_finish() with the
    sync debugger in ``mode``: (its LU arrays, a record of its walls, the
    fused finishes it called, their syncs, the wrappers' launches and
    ops/dense.last_finish)."""
    from spasm_tpu_torch import echelonize, last_phase_stats
    from spasm_tpu_torch.interop import lu_arrays
    from spasm_tpu_torch.ops import dense

    _WATCH.update(mode=mode, calls=0, syncs=0, sites=[])
    dense.last_finish.clear()
    reset_launches()
    fact, w = wall(lambda: echelonize(M, device=DEV, **kw))
    st = last_phase_stats()
    rec = dict(wall_s=w, pivot_s=st["pivot_s"], finish_s=st["finish_s"],
               device_s=st["device_s"], fused_calls=_WATCH["calls"],
               syncs=_WATCH["syncs"], sync_sites=_WATCH["sites"],
               launches=read_launches(), **dense.last_finish)
    if facts is not None:
        facts.append(fact)
    return lu_arrays(fact), rec


def check_fused_runs(name: str, recs: dict, replayed=None) -> None:
    """The runs of one case: one fused finish in each run but the
    "streaming" ones, none there; on a card the graph cache went eager,
    captured, replayed.., no capture or replay synced, the first call
    launched K1 and K2, and the profiled replay (if any) ran both."""
    fused = [k for k in recs if not k.startswith("streaming")]
    if [recs[k]["fused_calls"] for k in recs] != [int(k in fused)
                                                  for k in recs]:
        raise AssertionError(f"{name}: the finishes taken differ from "
                             "fused, fused.., streaming")
    if DEV != "cuda":
        return
    graphs = [recs[k].get("graph") for k in fused]
    if graphs != ["eager", "captured"] + ["replayed"] * (len(fused) - 2):
        raise AssertionError(f"{name}: graph cache {graphs}")
    if any(recs[k]["syncs"] for k in fused[1:]):
        raise AssertionError(f"{name}: a captured or replayed finish synced")
    if not all(recs["first"]["launches"][k] for k in ("modmatmul", "panel")):
        raise AssertionError(f"{name}: no K1 / K2 launch")
    if replayed is not None and not all(replayed[k]
                                        for k in ("modmatmul", "panel")):
        raise AssertionError(f"{name}: the replay ran no K1 / K2: "
                             f"{replayed}")


def flag_errors(ctx, phase: str, p: int) -> None:
    """run_flag_checks at p, printed, raised on, and merged into the
    kernels' errors."""
    flags = run_flag_checks(p)
    emit(phase, part="run flags", p=p, card=ctx["card"], max_abs_err=flags)
    if any(flags.values()):
        raise AssertionError(f"a kernel's run flag != its plain version at "
                             f"p = {p}: {flags}")
    for key, k in (("k2_err", "k2"), ("k1_err", "k1")):
        ctx[key] = max(ctx.get(key, 0), flags[k])


def phase_fused(ctx):
    """The fused dense finish (one CUDA graph a shape) on four cases."""
    from spasm_tpu_torch import SparseGFp, echelonize, field
    from spasm_tpu_torch.interop import lu_arrays
    from spasm_tpu_torch.ops import dense

    flag_errors(ctx, "fused", 42013)
    f = field(42013)
    A = SparseGFp.rand(f, FLAGSHIP_N, FLAGSHIP_N, 0.02,
                       np.random.default_rng(5))
    cases = [("flagship", A, {}, False),
             ("planted", planted_rank(A, PLANTED_KEEP,
                                      np.random.default_rng(6)), {}, False),
             ("echelon 3000x720", SparseGFp.rand(
                 f, 3000, 720, 0.05, np.random.default_rng(7)),
              dict(dense_block_size=1500), True),
             ("api_mid", api_mid_case(), {}, True)]
    with watched_finish():
        for name, M, kw, vs_cpu in cases:
            dense.release_finish_graphs()
            lus, recs, facts = {}, {}, []
            # the first call of a shape runs eagerly (its host reads
            # counted), the second captures and replays, later ones replay
            lus["fused first"], recs["first"] = timed_finish(M, kw, "warn",
                                                             facts)
            lus["fused second"], recs["second"] = timed_finish(M, kw,
                                                               "error")
            for i in range(FUSED_WARM):
                lus["fused warm"], recs[f"warm {i + 1}"] = timed_finish(
                    M, kw, "error")
            replayed = None
            if name == "flagship":
                # a replay launches the kernels without their wrappers:
                # its launches are the profiler's kernel events
                replayed = profile_rank(M, ctx.get("profile_dir"),
                                        "fused, warm")
            # the streaming loop, by the reference's own lever; in blocks
            # of the fused loop's height (its rows a block are
            # _bucket(dense_block_size)), then of the default height
            old = dense.FUSED_BUDGET
            dense.FUSED_BUDGET = 0
            same = dict(kw, dense_block_size=dense._bucket(
                kw.get("dense_block_size", 1000)))
            try:
                (lus["streaming, fused blocks"],
                 recs["streaming 0"]) = timed_finish(M, same, "warn")
                for i in range(2):
                    (lus["streaming"],
                     recs[f"streaming {i + 1}"]) = timed_finish(
                        M, kw, "warn", facts)
                if name == "flagship" and ctx.get("profile_dir"):
                    profile_rank(M, ctx["profile_dir"], "streaming, warm")
            finally:
                dense.FUSED_BUDGET = old
            if vs_cpu:
                lus["cpu"] = lu_arrays(echelonize(M, device="cpu", **kw))
            base = lus["fused first"]
            bad = {k: [a for a in base if not np.array_equal(v.get(a),
                                                             base[a])]
                   for k, v in lus.items()}
            row_space = None
            if bad["streaming"] and kw.get("dense_block_size", 1000) != \
                    same["dense_block_size"]:
                # other block heights may pick other pivot rows (as the
                # reference's two loops do): then the same rank and the
                # same canonical RREF of the row space
                from spasm_tpu_torch import rref_of_U

                row_space = bad.pop("streaming")
                if not (facts[0].r == facts[-1].r and rref_of_U(facts[0])
                        == rref_of_U(facts[-1])):
                    raise AssertionError(f"{name}: the streaming loop's "
                                         "row space differs")
            if name == "flagship":
                note_path(ctx, "fused: flagship rank, first (eager)",
                          recs["first"]["launches"])
                note_path(ctx, "fused: flagship rank, warm (graph replay; "
                          "torch.profiler's kernel events)", replayed)
                note_path(ctx, "fused: flagship rank, streaming loop",
                          recs["streaming 1"]["launches"])
            emit("fused", case=name, card=ctx["card"], nnz=M.nnz,
                 rank=int(base["r"]), runs=recs, compared=list(lus),
                 mismatched=bad,
                 streaming_default_blocks=(
                     "bit-equal" if row_space is None else
                     f"pivot order differs in {row_space}; same rank and "
                     "canonical RREF"))
            if any(bad.values()):
                raise AssertionError(f"{name}: LUs differ: {bad}")
            check_fused_runs(name, recs, replayed)


def csr_equal(a, b) -> bool:
    import scipy.sparse as sp

    a, b = sp.csr_matrix(a), sp.csr_matrix(b)
    for x in (a, b):
        x.sort_indices()
        x.eliminate_zeros()
    return (a.shape == b.shape and np.array_equal(a.indptr, b.indptr)
            and np.array_equal(a.indices, b.indices)
            and np.array_equal(a.data, b.data))


def sparse_cases():
    from spasm_tpu_torch import SparseGFp, field
    from spasm_tpu_torch._host.fixtures import simplex_boundary

    n, d, seed = RANDOM30K
    return [(f"d7 boundary {D7[:2]}", lambda: simplex_boundary(*D7[:2]),
             D7[2]),
            (f"d8 boundary {D8[:2]}", lambda: simplex_boundary(*D8[:2]),
             D8[2]),
            (f"random {n}^2 d={d} seed {seed}",
             lambda: SparseGFp.rand(field(42013), n, n, d,
                                    np.random.default_rng(seed)), None)]


def onepass_pair(name, A):
    """Round 0 of A as echelonize forms it; the host update
    (mutual_reduce + eliminate_against_reduced) against the one-pass
    merge on the card (mutual_reduce + eliminate_onepass_device), timed
    host, card, card, host; then one card run with K3 held against the
    plain merge on each tile the path gives it."""
    from spasm_tpu_torch._host.elimination import (eliminate_against_reduced,
                                                   mutual_reduce)
    from spasm_tpu_torch._host.pivots import find_structural_pivots
    from spasm_tpu_torch.echelonize import _round_schur_estimate
    from spasm_tpu_torch.ops import cuda_merge
    from spasm_tpu_torch.ops.merge import merge_rows_plain
    from spasm_tpu_torch.ops.sparse_onepass import eliminate_onepass_device

    f = A.field
    prows, pcols, _ = find_structural_pivots(A)
    _, S_rest, _, (Upart, _, levels) = _round_schur_estimate(
        f, A.to_scipy(), prows, pcols)

    def host():
        Ustar, ok = mutual_reduce(f, Upart, pcols, levels)
        assert ok, name
        return eliminate_against_reduced(f, Ustar, pcols, S_rest,
                                         assume_canonical=True)[0]

    def card(stats):
        """One card run; stats gets the one-pass _stats, K3's launches and
        K3's own time summed over them (CUDA events around each call)."""
        Ustar, ok = mutual_reduce(f, Upart, pcols, levels)
        assert ok, name
        kernel = cuda_merge.merge_rows_cuda
        spans = []

        def timed(f_, c, v, m_):
            ev = [torch.cuda.Event(enable_timing=True) for _ in range(2)]
            ev[0].record()
            out = kernel(f_, c, v, m_)
            ev[1].record()
            spans.append(ev)
            return out

        cuda_merge.launches = 0
        if DEV == "cuda":
            cuda_merge.merge_rows_cuda = timed
        try:
            D = eliminate_onepass_device(f, Ustar, pcols, S_rest, device=DEV,
                                         _stats=stats)
        finally:
            cuda_merge.merge_rows_cuda = kernel
        stats["k3_launches"] = cuda_merge.launches
        sync()
        stats["k3_ms"] = sum(a.elapsed_time(b) for a, b in spans)
        if stats.get("device_s"):
            stats["k3_share_of_device_s"] = (stats["k3_ms"] / 1e3
                                             / stats["device_s"])
        return D

    def checked():
        """One more, untimed, card run in which every K3 call is held
        against the plain merge on the same tile, in all three outputs."""
        kernel = cuda_merge.merge_rows_cuda
        tiles = []

        def held(f_, c, v, m_):
            got = kernel(f_, c, v, m_)
            want = merge_rows_plain(f_, c, v, m_)
            tiles.append(dict(shape=list(c.shape), kept=int(want[2].sum()),
                              max_abs_err=max(max_abs_diff(g, w)
                                              for g, w in zip(got, want))))
            return got

        cuda_merge.merge_rows_cuda = held
        try:
            return card({}), tiles
        finally:
            cuda_merge.merge_rows_cuda = kernel

    walls, runs = {"host": [], "card": []}, []
    for side in ("host", "card", "card", "host"):
        stats: dict = {}
        t0 = time.perf_counter()
        out = host() if side == "host" else card(stats)
        walls[side].append(time.perf_counter() - t0)
        runs.append((side, out, stats))
    D_checked, tiles = checked()
    Dh = runs[0][1]
    stats = runs[2][2]
    equal = (all(csr_equal(Dh, out) for _, out, _ in runs[1:])
             and csr_equal(Dh, D_checked))
    tile_err = max((t["max_abs_err"] for t in tiles), default=None)
    emit("sparse", part="round-0 pair", case=name, S_rest=list(S_rest.shape),
         S_rest_nnz=S_rest.nnz, U_rows=int(pcols.size), D_nnz=Dh.nnz,
         host_s=walls["host"], card_s=walls["card"], onepass=stats,
         equal=equal, k3_tiles_vs_plain=tiles)
    if not equal:
        raise AssertionError(f"{name}: one-pass on the card != host kernel")
    if DEV == "cuda" and (len(tiles) != stats["device_calls"] or tile_err):
        raise AssertionError(f"{name}: K3 != plain merge on the path's "
                             f"tiles: {tiles}")
    if DEV == "cuda" and not (
            stats["device_calls"] == stats["k3_launches"] > 0):
        raise AssertionError(f"{name}: device calls {stats['device_calls']}"
                             f" vs K3 launches {stats['k3_launches']}")


def phase_sparse(ctx):
    from spasm_tpu_torch import echelonize, last_phase_stats, rank
    from spasm_tpu_torch.interop import lu_arrays
    from spasm_tpu_torch.ops import cuda_matmul, cuda_merge, cuda_panel, dense

    merge_launches = 0
    for name, make, want in sparse_cases():
        t0 = time.perf_counter()
        A = make()
        emit("sparse", part="build", case=name, shape=list(A.shape),
             nnz=A.nnz, build_s=round(time.perf_counter() - t0, 3))
        onepass_pair(name, A)
        if name.startswith("d7"):
            continue
        ranks = {}
        for opt in (0, 1):
            # each rank is its dense finish shape's first call, which runs
            # eagerly (a second would capture, and a capture launches
            # nothing); the main path's launch counts: reset right before,
            # read right after
            dense.release_finish_graphs()
            cuda_matmul.launches = cuda_matmul.split_launches = 0
            cuda_panel.launches = cuda_merge.launches = 0
            t0 = time.perf_counter()
            r = rank(A, device=DEV, device_sparse_min_nnz=opt)
            sync()
            wall = time.perf_counter() - t0
            counts = {"modmatmul": cuda_matmul.launches,
                      "modmatmul_split": cuda_matmul.split_launches,
                      "panel": cuda_panel.launches,
                      "merge": cuda_merge.launches}
            ranks[opt] = r
            emit("sparse", part="rank", case=name, device_sparse_min_nnz=opt,
                 rank=r, expected=want, wall_s=round(wall, 4),
                 phases=last_phase_stats(), launches=counts)
            if opt and DEV == "cuda":
                need = ("merge",) if want else (
                    "merge", "modmatmul", "modmatmul_split", "panel")
                if not all(counts[k] for k in need):
                    raise AssertionError(f"{name}: a kernel of the path was "
                                         f"not launched: {counts}")
                merge_launches += counts["merge"]
                note_path(ctx, f"sparse: {name} rank", counts)
        if ranks[1] != ranks[0] or (want is not None and ranks[1] != want):
            raise AssertionError(f"{name}: ranks {ranks}, expected {want}")
        del A
    ctx.setdefault("launches", {})["merge"] = merge_launches

    A = sparse_cases()[0][1]()
    runs = {}
    for dev in (DEV, "cpu"):
        t0 = time.perf_counter()
        fact = echelonize(A, device=dev, device_sparse_min_nnz=1)
        runs[dev] = (lu_arrays(fact), round(time.perf_counter() - t0, 4))
    (got, wall_g), (want, wall_c) = runs[DEV], runs["cpu"]
    bad = [k for k in want if not np.array_equal(got.get(k), want[k])]
    emit("sparse", part="echelonize", case=sparse_cases()[0][0],
         rank=int(got["r"]), walls_s=[wall_g, wall_c], mismatched=bad)
    if bad or set(got) != set(want) or got["r"] != D7[2]:
        raise AssertionError(f"d7 echelonize card != cpu in {bad}")


# ---------------- waves: the sort-based wave Schur update ----------------


def round0_block(A):
    """Round 0 of A as echelonize forms it: (field, U as SparseGFp, pivot
    columns, levels, the remaining rows B as SparseGFp, and whether
    mutual_reduce holds the block within its fill cap)."""
    from spasm_tpu_torch import SparseGFp
    from spasm_tpu_torch._host.elimination import mutual_reduce
    from spasm_tpu_torch._host.pivots import find_structural_pivots
    from spasm_tpu_torch.echelonize import _round_schur_estimate

    f = A.field
    prows, pcols, _ = find_structural_pivots(A)
    _, S_rest, _, (Upart, _, levels) = _round_schur_estimate(
        f, A.to_scipy(), prows, pcols)
    ok = mutual_reduce(f, Upart, pcols, levels)[1]
    U = SparseGFp.from_scipy(Upart, f.p, assume_canonical=True)
    return f, U, pcols, levels, SparseGFp.from_scipy(S_rest, f.p), ok


def level_prefix(U, pcols, levels, k: int):
    """The pivot rows of the first k levels: the block whose waves are the
    first k waves of the whole block."""
    from spasm_tpu_torch import SparseGFp

    sel = np.flatnonzero(np.asarray(levels) < k)
    Us = U.to_scipy()[sel]
    return (SparseGFp.from_scipy(Us, U.field.p, assume_canonical=True),
            np.asarray(pcols)[sel], np.asarray(levels)[sel])


def host_update(f, U, pcols, levels, B, ok):
    """The host kernel's update of B: mutual_reduce +
    eliminate_against_reduced where the block reduces, else the host
    waves; as a SparseGFp."""
    from spasm_tpu_torch import SparseGFp
    from spasm_tpu_torch._host.elimination import (eliminate_against_reduced,
                                                   mutual_reduce,
                                                   wave_eliminate)

    Us = U.to_scipy()
    if ok:
        Ustar, _ = mutual_reduce(f, Us, pcols, levels)
        D = eliminate_against_reduced(f, Ustar, pcols, B.to_scipy(),
                                      assume_canonical=True)[0]
    else:
        D = wave_eliminate(f, Us, pcols, levels, B.to_scipy(),
                           assume_canonical=True)[0]
    return SparseGFp.from_scipy(D, f.p)


def card_waves(f, U, pcols, levels, B, cap_factor=4):
    """eliminate_device on the card, ended by a synchronize: (result, wall
    s, the waves' stats, peak device memory in bytes)."""
    from spasm_tpu_torch.ops.sparse_device import eliminate_device

    stats: dict = {}
    if DEV == "cuda":
        torch.cuda.reset_peak_memory_stats()
    D, wall_s = wall(lambda: eliminate_device(
        f, U, pcols, levels, B, cap_factor=cap_factor, device=DEV,
        _stats=stats))
    peak = torch.cuda.max_memory_allocated() if DEV == "cuda" else None
    return D, wall_s, stats, peak


def sort_share(f, U, pcols, levels, B, cap_factor) -> dict:
    """One more card run under torch.profiler: the device time of the
    sorts (CUB's radix sort kernels) against all device time and the
    wall."""
    from torch.autograd import DeviceType

    from spasm_tpu_torch.utils.profiling import trace

    if DEV != "cuda":
        return {}
    with trace(work_dir("waves_trace")) as prof:
        _, wall_s, _, _ = card_waves(f, U, pcols, levels, B, cap_factor)

    def dev_us(e):
        return (getattr(e, "self_device_time_total", None)
                or getattr(e, "self_cuda_time_total", 0))

    kernels = [e for e in prof.key_averages()
               if e.device_type == DeviceType.CUDA and dev_us(e) > 0]
    busy = sum(dev_us(e) for e in kernels) / 1e6
    sort_s = sum(dev_us(e) for e in kernels if "Sort" in e.key) / 1e6
    return dict(profiled_wall_s=wall_s, device_busy_s=round(busy, 4),
                sort_device_s=round(sort_s, 4),
                sort_share_of_wall=round(sort_s / wall_s, 4),
                sort_share_of_device=round(sort_s / max(busy, 1e-9), 4))


def waves_round(ctx, name, A) -> dict:
    """(a): round 0 of A through eliminate_device on the card as echelonize
    runs it (cap_factor 4, then 16 on overflow), then held equal to the
    host kernel, timed host, card, card, host, on the whole block, or
    where both capacities overflow on the pivot rows of the levels the
    first capacity held (the first waves of the same round)."""
    f, U, pcols, levels, B, ok = round0_block(A)
    rec = dict(case=name, card=ctx["card"], S_rest=list(B.shape),
               S_rest_nnz=B.nnz, U_rows=U.n, U_nnz=U.nnz,
               Ku=int(U.row_lengths().max()), depth=int(levels.max()) + 1,
               mutual_reduce_ok=bool(ok), tries=[])
    block, cf = (U, pcols, levels), None
    for factor in (4, 16):
        D, wall_s, stats, peak = card_waves(f, U, pcols, levels, B, factor)
        rec["tries"].append(dict(
            cap_factor=factor, outcome="overflow" if D is None else "result",
            wall_s=wall_s, hits=stats["hits"], kept=stats["kept"],
            max_expansion=stats["max_expansion"],
            overflow_wave=stats["overflow_wave"], peak_bytes=peak))
        if D is not None:
            cf = factor
            break
    if cf is None:
        k = rec["tries"][0]["overflow_wave"]
        block, cf = level_prefix(U, pcols, levels, k), 4
        rec["held_on"] = f"the pivot rows of levels < {k}"
        ok = mutual_reduce_ok(f, *block)
    walls, outs = {"host": [], "card": []}, []
    for side in ("host", "card", "card", "host"):
        if side == "host":
            out, wall_s = wall(lambda: host_update(f, *block, B, ok))
        else:
            out, wall_s, stats, peak = card_waves(f, *block, B, cf)
        walls[side].append(wall_s)
        outs.append(out)
    rec.update(held_cap_factor=cf, host_s=walls["host"],
               card_s=walls["card"], D_nnz=outs[0].nnz,
               equal=all(o is not None and o == outs[0] for o in outs[1:]),
               held_hits=stats["hits"], held_kept=stats["kept"],
               held_peak_bytes=peak,
               **sort_share(f, *block, B, cf))
    emit("waves", part="round 0", **rec)
    if not rec["equal"]:
        raise AssertionError(f"{name}: the waves on the card != the host")
    return dict(U=U, pcols=pcols, levels=levels, B=B, block=block,
                D=outs[1])


def mutual_reduce_ok(f, U, pcols, levels) -> bool:
    from spasm_tpu_torch._host.elimination import mutual_reduce

    return mutual_reduce(f, U.to_scipy(), pcols, levels)[1]


def waves_d8(ctx) -> None:
    """(b): d8's round 0 once through eliminate_device: it finishes (held
    against the host kernel), overflows (None), or runs out of memory (the
    phase fails)."""
    cases = ctx.setdefault("cases", {})
    if cases.get("d8") is None:
        cases["d8"] = make_case("d8")
    A = cases["d8"]
    f, U, pcols, levels, B, ok = round0_block(A)
    rec = dict(case=f"d8 boundary {D8[:2]}", card=ctx["card"],
               S_rest_nnz=B.nnz, U_rows=U.n, depth=int(levels.max()) + 1)
    try:
        D, wall_s, stats, peak = card_waves(f, U, pcols, levels, B)
    except torch.cuda.OutOfMemoryError as e:
        emit("waves", part="d8 round 0", outcome="out of memory",
             error=str(e)[:300], **rec)
        raise
    rec.update(outcome="overflow" if D is None else "finished",
               wall_s=wall_s, hits=stats["hits"], kept=stats["kept"],
               max_expansion=stats["max_expansion"], peak_bytes=peak)
    if D is not None:
        want, rec["host_s"] = wall(lambda: host_update(f, U, pcols, levels,
                                                       B, ok))
        rec.update(D_nnz=D.nnz, equal=D == want)
    emit("waves", part="d8 round 0", **rec)
    if rec.get("equal") is False:
        raise AssertionError("d8: the waves on the card != the host")


def waves_echelonize(ctx) -> None:
    """(c): echelonize through the device waves, card against the same call
    with the host Schur path (device_sparse_min_nnz=0): equal ranks and
    equal row spaces of U; the log and the waves' results show that round
    0 was the device waves'.  Where the LUs differ (the host path stores a
    mutual-reduced block), the row spaces are held equal by the host waves'
    residual of the first U's rows against the second U, which must be 0
    (row space contained, ranks equal): what the equality of rref_of_U
    states, without its full reduction, which exhausted a 96 GiB host on
    the LUs of a random 100000^2 round of this kind."""
    import importlib

    from spasm_tpu_torch import echelonize, last_phase_stats
    from spasm_tpu_torch._host.elimination import wave_eliminate
    from spasm_tpu_torch._host.utils import logging as slog
    from spasm_tpu_torch.interop import lu_arrays
    from spasm_tpu_torch.ops import sparse_device, sparse_onepass

    ech = importlib.import_module("spasm_tpu_torch.echelonize")
    name, A = waves_e2e_case()
    calls: list = []

    def spy(mod, attr, tag):
        real = getattr(mod, attr)

        def timed(*a, **kw):
            out, wall_s = wall(lambda: real(*a, **kw))
            ok = out[1] if tag == "mutual_reduce" else out is not None
            calls.append(dict(call=tag, wall_s=wall_s, result=bool(ok)))
            return out
        return mod, attr, real, timed

    spies = [spy(sparse_device, "eliminate_device", "device waves"),
             spy(sparse_onepass, "eliminate_onepass_device", "one-pass"),
             spy(ech, "mutual_reduce", "mutual_reduce"),
             spy(ech, "wave_eliminate", "host waves")]
    runs = {}
    for opt in (1, 0):
        lines: list[str] = []
        calls.clear()
        slog.set_log(lines.append)
        for mod, attr, _, timed in spies:
            setattr(mod, attr, timed)
        reset_launches()
        try:
            fact, wall_s = wall(lambda: echelonize(
                A, device=DEV, device_sparse_min_nnz=opt, verbose=True))
        finally:
            slog.set_log(None)
            for mod, attr, real, _ in spies:
                setattr(mod, attr, real)
        runs[opt] = dict(fact=fact, wall_s=wall_s, calls=list(calls),
                         launches=read_launches(), lines=lines,
                         phases=last_phase_stats())
        if opt:
            note_path(ctx, f"waves: {name} echelonize", runs[1]["launches"])
    F1, F0 = runs[1]["fact"], runs[0]["fact"]
    mismatched = lu_mismatch(lu_arrays(F1), lu_arrays(F0))
    residual = None
    if mismatched:
        res, residual_s = wall(lambda: wave_eliminate(
            A.field, F0.U.to_scipy(), F0.piv_cols, F0.levels,
            F1.U.to_scipy())[0])
        res.eliminate_zeros()
        residual = dict(nnz=int(res.nnz), wall_s=residual_s)
    lines = runs[1]["lines"]
    first_schur = next((i for i, ln in enumerate(lines)
                        if ln.startswith("Schur complement:")), None)
    dense_at = next((i for i, ln in enumerate(lines)
                     if "switching to dense finish" in ln), len(lines))
    rec = dict(case=name, nnz=A.nnz, card=ctx["card"],
               ranks=[F1.r, F0.r],
               walls_s=[runs[o]["wall_s"] for o in (1, 0)],
               calls=[runs[o]["calls"] for o in (1, 0)],
               launches=[runs[o]["launches"] for o in (1, 0)],
               phases=[runs[o]["phases"] for o in (1, 0)],
               schur_lines=[ln for ln in lines if ln.startswith(
                   ("[schur/device]", "Schur complement", "[echelonize] "
                    "Schur complement too dense"))],
               lu_mismatched=mismatched, U_nnz=[F1.U.nnz, F0.U.nnz],
               residual_of_U=residual)
    emit("waves", part="echelonize", **rec)
    device = [c for c in runs[1]["calls"] if c["call"] == "device waves"]
    waves_ran = (first_schur is not None and first_schur < dense_at
                 and device and device[-1]["result"]
                 and not any(c["call"] == "host waves"
                             for c in runs[1]["calls"])
                 and "[schur/device] one-pass unavailable; wave fallback"
                 in lines[:first_schur])
    if not waves_ran:
        raise AssertionError(f"{name}: round 0 did not go through the "
                             f"device waves: {rec['calls']}")
    if F1.r != F0.r or F1.r != WAVES_E2E[2] or (
            residual and residual["nnz"]):
        raise AssertionError(f"{name}: device waves != host Schur path")


def waves_mesh_work(mesh, inputs) -> dict:
    """This rank's sharded_sparse_eliminate of the round (cap_factor 8,
    then 32, as echelonize) and of its level prefix."""
    from spasm_tpu_torch.interop import sparse_from_arrays
    from spasm_tpu_torch.parallel.sparse_sharded import (
        sharded_sparse_eliminate)

    def sparse(a):
        return sparse_from_arrays(*a)

    out: dict = {"rank": mesh.get_local_rank()}
    for key in ("round", "prefix"):   # prefix: the block (a) held
        U, pcols, levels, B = inputs[key]
        U, B = sparse(U), sparse(B)
        got = []
        for cf in ((8, 32) if key == "round" else (8,)):
            D, wall_s = wall(lambda: sharded_sparse_eliminate(
                B.field, mesh, U, pcols, levels, B, cap_factor=cf))
            got.append(dict(cap_factor=cf, wall_s=wall_s,
                            csr=None if D is None else (
                                D.shape, D.indptr, D.indices, D.data)))
        out[key] = got
    return out


def waves_child(rank: int, world: int, port: int, kn: dict, inp: str,
                out: str) -> None:
    """One gloo rank of the waves' mesh (the ranks share the card)."""
    import torch.distributed as dist

    from spasm_tpu_torch.parallel.sharded import make_mesh

    globals().update(kn)
    torch.set_num_threads(max(1, (os.cpu_count() or 1) // world))
    if DEV == "cuda":
        torch.cuda.set_device(0)
    with open(inp, "rb") as fh:
        inputs = pickle.load(fh)
    dist.init_process_group("gloo", init_method=f"tcp://127.0.0.1:{port}",
                            rank=rank, world_size=world)
    try:
        res = waves_mesh_work(make_mesh(world, device_type=DEV), inputs)
    finally:
        dist.destroy_process_group()
    with open(out, "wb") as fh:
        pickle.dump(res, fh)


def waves_mesh(ctx, rnd) -> None:
    """(d): sharded_sparse_eliminate of (a)'s 100000^2 round at world size
    1 (NCCL, this process) and 2 (two gloo processes on the card): one
    overflow decision on all ranks of a world, and on the block (a) held
    the same matrix as eliminate_device."""
    import torch.distributed as dist

    from spasm_tpu_torch.parallel.sharded import make_mesh

    def arrays(M):
        return (M.field.p, M.shape, M.indptr, M.indices, M.data)

    Up, pp, lp = rnd["block"]
    inputs = dict(round=(arrays(rnd["U"]), rnd["pcols"], rnd["levels"],
                         arrays(rnd["B"])),
                  prefix=(arrays(Up), pp, lp, arrays(rnd["B"])))
    want = rnd["D"]
    for world in MESH_WORLDS:
        if world == 1:
            dist.init_process_group(
                "nccl" if DEV == "cuda" else "gloo",
                init_method=f"tcp://127.0.0.1:{free_port()}", rank=0,
                world_size=1)
            try:
                backend = dist.get_backend()
                ranks = [waves_mesh_work(make_mesh(1, device_type=DEV),
                                         inputs)]
            finally:
                dist.destroy_process_group()
        else:
            backend = "gloo"
            ranks = mesh_children(world, waves_child, inputs)
        decisions = {tuple(t["csr"] is None for t in r["round"])
                     for r in ranks}
        for r in ranks:
            got = r["prefix"][0]["csr"]
            equal = got is not None and (
                tuple(got[0]) == want.shape
                and all(np.array_equal(g, w) for g, w in zip(
                    got[1:], (want.indptr, want.indices, want.data))))
            emit("waves", part="mesh", world=world, backend=backend,
                 rank_of_mesh=r["rank"], card=ctx["card"],
                 round_overflow=[t["csr"] is None for t in r["round"]],
                 round_walls_s=[t["wall_s"] for t in r["round"]],
                 held_wall_s=r["prefix"][0]["wall_s"], held_equal=equal)
            if not equal:
                raise AssertionError(f"world {world} rank {r['rank']}: "
                                     "sharded waves != eliminate_device")
        if len(decisions) != 1:
            raise AssertionError(f"world {world}: the ranks' overflow "
                                 f"decisions differ: {decisions}")


def waves_100k_case():
    n, d, seed = RANDOM100K
    from spasm_tpu_torch import SparseGFp, field

    return (f"random {n}^2 d={d} seed {seed}",
            SparseGFp.rand(field(42013), n, n, d, np.random.default_rng(seed)))


def waves_e2e_case():
    from spasm_tpu_torch._host.fixtures import simplex_boundary

    return (f"boundary {WAVES_E2E[:2]}", simplex_boundary(*WAVES_E2E[:2]))


def phase_waves(ctx):
    t_phase = time.perf_counter()
    for name, make, _ in sparse_cases()[::2]:
        waves_round(ctx, name, make())
    rnd = waves_round(ctx, *waves_100k_case())
    waves_d8(ctx)
    waves_echelonize(ctx)
    waves_mesh(ctx, rnd)
    emit("waves", part="phase", card=ctx["card"],
         wall_s=round(time.perf_counter() - t_phase, 3))


def note_path(ctx, path: str, counts: dict) -> None:
    """Record each kernel's launches on one path of the run (the kernels
    line's ``launches_by_path``)."""
    for name, n in counts.items():
        ctx.setdefault("paths", {}).setdefault(name, {})[path] = n


def reset_launches() -> None:
    from spasm_tpu_torch.ops import cuda_matmul, cuda_merge, cuda_panel

    cuda_matmul.launches = cuda_matmul.split_launches = 0
    cuda_panel.launches = cuda_merge.launches = 0


def read_launches() -> dict:
    from spasm_tpu_torch.ops import cuda_matmul, cuda_merge, cuda_panel

    return {"modmatmul": cuda_matmul.launches,
            "modmatmul_split": cuda_matmul.split_launches,
            "panel": cuda_panel.launches, "merge": cuda_merge.launches}


def wall(fn):
    """(fn(), its wall in s, ended by a synchronize)."""
    t0 = time.perf_counter()
    out = fn()
    sync()
    return out, round(time.perf_counter() - t0, 4)


def null_rows_check(A, K, chunk: int = 128) -> None:
    """A @ K.T == 0 mod p, by host SpMVs over the rows of K (chunks of K
    made dense)."""
    f = A.field
    As, Ks = A.to_scipy().astype(np.int64), K.to_scipy()
    for r0 in range(0, K.n, chunk):
        Kd = Ks[r0:r0 + chunk].toarray().astype(np.int64)
        if f.normalize(As @ Kd.T).any():
            raise AssertionError(f"A @ K.T != 0 in kernel rows {r0}..")


def rows_times(X, A, rows):
    """(X[rows] @ A) mod p as a dense array, by host SpMVs."""
    Xd = X.to_scipy()[rows].toarray().astype(np.int64)
    return A.field.normalize((A.to_scipy().astype(np.int64).T @ Xd.T).T)


def api_flagship(ctx):
    from spasm_tpu_torch import (SparseGFp, certificate_rank_create,
                                 certificate_rank_verify, echelonize,
                                 factorization_verify, field, gesv, kernel,
                                 matrix_hash, solve)

    f = field(42013)
    N = FLAGSHIP_N
    A = planted_rank(SparseGFp.rand(f, N, N, 0.02, np.random.default_rng(5)),
                     PLANTED_KEEP, np.random.default_rng(6))
    rng = np.random.default_rng(7)
    walls = {}
    # the slice's path on the card: counts set to 0 right before, read
    # right after
    reset_launches()
    fact, walls["echelonize_L"] = wall(
        lambda: echelonize(A, L=True, device=DEV))
    ds = fact.dense_piv_start
    corner = 0 if ds is None else fact.r - ds
    K, walls["kernel"] = wall(lambda: kernel(fact))
    b = A.xapy(f.rand(N, rng))
    before = read_launches()
    x, walls["solve_first"] = wall(lambda: solve(fact, b))
    in_solve = {k: v - before[k] for k, v in read_launches().items()}
    b2 = A.xapy(f.rand(N, rng))
    x2, walls["solve_cached"] = wall(lambda: solve(fact, b2))
    bad = f.rand(N, rng)
    none, walls["solve_outside"] = wall(lambda: solve(fact, bad))
    half = API_GESV_RHS // 2
    B = (SparseGFp.rand(f, half, N, 0.001, rng) @ A).vstack(
        SparseGFp.rand(f, half, N, 0.01, rng))
    (X, ok), walls["gesv"] = wall(lambda: gesv(fact, B))
    h = matrix_hash(A)
    cert, walls["certificate_create"] = wall(
        lambda: certificate_rank_create(A, h, device=DEV))
    good, walls["certificate_verify"] = wall(
        lambda: certificate_rank_verify(A, h, cert))
    launches = read_launches()
    y = cert.y.copy()
    y[len(y) // 2] = f.normalize(y[len(y) // 2] + 1)
    tampered = certificate_rank_verify(A, h, dataclasses.replace(cert, y=y))
    fv, walls["factorization_verify"] = wall(
        lambda: factorization_verify(A, fact))
    emit("api", case=f"planted-rank flagship {N}x{N}, rank {PLANTED_KEEP}",
         card=ctx["card"], nnz=A.nnz, rank=fact.r,
         dense_piv_start=ds, corner_block=[corner, corner],
         kernel_rows=K.n, kernel_nnz=K.nnz, gesv_ok=int(ok.sum()),
         certificate_r=cert.r, walls_s=walls, launches_in_first_solve=
         in_solve, launches=launches)
    if fact.r != PLANTED_KEEP or K.n != N - PLANTED_KEEP:
        raise AssertionError(f"rank {fact.r}, kernel rows {K.n}")
    null_rows_check(A, K)
    for xx, bb in ((x, b), (x2, b2)):
        if xx is None or not np.array_equal(A.xapy(xx), bb):
            raise AssertionError("solve: x @ A != b")
    if none is not None:
        raise AssertionError("solve found x for b outside the row space")
    if not (ok[:half].all() and not ok[half:].any()):
        raise AssertionError(f"gesv ok marks {np.flatnonzero(ok)}")
    Bd = B.to_scipy()[:half].toarray()
    if not np.array_equal(rows_times(X, A, slice(0, half)), f.normalize(Bd)):
        raise AssertionError("gesv: X @ A != B on the consistent rows")
    if X.to_scipy()[half:].nnz:
        raise AssertionError("gesv: rows without a solution are not zero")
    if not good or tampered or cert.r != PLANTED_KEEP:
        raise AssertionError(f"certificate: verify {good}, tampered "
                             f"{tampered}, r {cert.r}")
    if not fv:
        raise AssertionError("factorization_verify(A, fact) failed")
    if DEV == "cuda" and not (in_solve["modmatmul"] and in_solve["panel"]):
        raise AssertionError(f"the first solve launched no K1 or K2: "
                             f"{in_solve}")


def api_d8(ctx):
    from spasm_tpu_torch import (certificate_rank_create,
                                 certificate_rank_verify, kernel,
                                 matrix_hash)
    from spasm_tpu_torch._host.fixtures import simplex_boundary

    B, t_build = wall(lambda: simplex_boundary(*D8[:2]))
    f = B.field
    walls = {}
    reset_launches()
    K, walls["kernel"] = wall(lambda: kernel(B, device=DEV))
    h = matrix_hash(B)
    cert, walls["certificate_create"] = wall(
        lambda: certificate_rank_create(B, h, device=DEV))
    good, walls["certificate_verify"] = wall(
        lambda: certificate_rank_verify(B, h, cert))
    launches = read_launches()
    # Freivalds: B @ (v @ K) == 0 for random v
    rng = np.random.default_rng(8)
    zero = all(not B.axpy(K.xapy(f.rand(K.n, rng))).any() for _ in range(2))
    emit("api", case=f"d8 boundary {D8[:2]}", card=ctx["card"],
         shape=list(B.shape), nnz=B.nnz, build_s=t_build, rank=cert.r,
         kernel_rows=K.n, kernel_nnz=K.nnz, walls_s=walls,
         launches=launches)
    if K.n != D8_KERNEL_ROWS or cert.r != D8[2] or not good or not zero:
        raise AssertionError(f"d8: kernel rows {K.n}, rank {cert.r}, "
                             f"verify {good}, B @ K.T == 0 {zero}")


def api_mid_case(p: int = 42013):
    from spasm_tpu_torch import SparseGFp, field

    n, d, seed, keep = API_MID
    return planted_rank(SparseGFp.rand(field(p), n, n, d,
                                       np.random.default_rng(seed)),
                        keep, np.random.default_rng(seed + 1))


def api_outputs(A, device, full: bool = True):
    """Every output array of the public calls on ``device``, by name, and
    their walls: echelonize(L=True), solve and gesv, and with ``full``
    also kernel, rref, a rank certificate and the complete echelonize
    (kernel, rref and the complete echelonize run the host's rref_of_U,
    whose products are chunked to 4 columns at p = 2147483629 and to 1 at
    4294967291: minutes at API_MID)."""
    from spasm_tpu_torch import (SparseGFp, certificate_rank_create,
                                 echelonize, gesv, kernel, rref, solve)
    from spasm_tpu_torch.interop import lu_arrays

    f = A.field
    rng = np.random.default_rng(9)
    out, walls = {}, {}

    def put(prefix, M):
        for k in ("indptr", "indices", "data"):
            out[f"{prefix}_{k}"] = np.asarray(getattr(M, k))

    if full:
        K, walls["kernel"] = wall(lambda: kernel(A, device=device))
        put("kernel", K)
    fact, walls["echelonize_L"] = wall(
        lambda: echelonize(A, L=True, device=device))
    out.update({f"L_{k}": v for k, v in lu_arrays(fact).items()})
    if full:
        (R, q), walls["rref"] = wall(lambda: rref(fact))
        put("rref", R)
        out["rref_qinv"] = q
    b = A.xapy(f.rand(A.n, rng))
    x, walls["solve_first"] = wall(lambda: solve(fact, b))
    out["solve_x"] = x
    B = (SparseGFp.rand(f, 16, A.n, 0.01, rng) @ A).vstack(
        SparseGFp.rand(f, 16, A.m, 0.01, rng))
    (X, ok), walls["gesv"] = wall(lambda: gesv(fact, B))
    put("gesv_X", X)
    out["gesv_ok"] = ok
    if not full:
        return out, walls, fact
    cert, walls["certificate_create"] = wall(
        lambda: certificate_rank_create(A, device=device))
    for k in ("r", "prime", "i", "j", "x", "y"):
        out[f"cert_{k}"] = np.asarray(getattr(cert, k))
    comp, walls["echelonize_complete"] = wall(
        lambda: echelonize(A, complete=True, L=True, device=device))
    out.update({f"complete_{k}": v for k, v in lu_arrays(comp).items()})
    return out, walls, fact


def api_card_vs_cpu(ctx, phase: str = "api", p: int = 42013,
                    full: bool = True, cpu=None):
    """API_MID at p through api_outputs on the card and on the CPU (``cpu``:
    its arrays and walls, or run here): every array bit-equal, the corner
    block on the tensor path."""
    from spasm_tpu_torch.ops import dense

    A = api_mid_case(p)
    reset_launches()
    got, walls_g, fact = api_outputs(A, DEV, full)
    launches = read_launches()
    want, walls_c = cpu or api_outputs(A, "cpu", full)[:2]
    bad = sorted(k for k in set(got) | set(want)
                 if k not in got or k not in want
                 or not np.array_equal(got[k], want[k]))
    ds = fact.dense_piv_start
    corner = 0 if ds is None else fact.r - ds
    emit(phase, case=f"rand {API_MID[0]}^2 d={API_MID[1]} seed "
         f"{API_MID[2]}, rows {API_MID[3]}.. planted", p=p, full=full,
         card=ctx["card"],
         nnz=A.nnz, rank=fact.r, corner_block=[corner, corner],
         arrays=len(want), mismatched=bad, walls_card_s=walls_g,
         walls_cpu_s=walls_c, launches=launches)
    if bad:
        raise AssertionError(f"api card != cpu in {bad}")
    if corner * corner < dense.host_cutoff_for(A.field):
        raise AssertionError(f"corner block {corner}^2 under the host "
                             "cutoff: the inverse did not take the tensor "
                             "path")
    if DEV == "cuda" and not (launches["modmatmul"] and launches["panel"]):
        raise AssertionError(f"no K1 or K2 launch: {launches}")
    return A


def api_cli(ctx, A):
    from spasm_tpu_torch import SparseGFp, save_sms

    f = A.field
    d = os.path.join(os.path.dirname(os.path.abspath(__file__)), "build",
                     "chip_smoke_api")
    os.makedirs(d, exist_ok=True)
    a_path = os.path.join(d, "a.sms")
    save_sms(A, a_path)
    rng = np.random.default_rng(10)
    B = (SparseGFp.rand(f, 4, A.n, 0.01, rng) @ A).vstack(
        SparseGFp.rand(f, 4, A.m, 0.01, rng))
    b_path = os.path.join(d, "b.sms")
    save_sms(B, b_path)
    root = os.path.dirname(os.path.abspath(__file__))
    runs, walls = {}, {}
    # one process at a time: two at once oversubscribe the host kernels'
    # OpenMP threads
    for tool, args, stdin in (("rank", [a_path], None),
                              ("kernel", [a_path], None),
                              ("solve", ["--matrix", a_path], b_path)):
        for dev in (DEV, "cpu"):
            t0 = time.perf_counter()
            with open(stdin or os.devnull, "rb") as fh:
                out = subprocess.run(
                    [sys.executable, "-m", "spasm_tpu_torch.cli", tool,
                     "--device", dev] + args, stdin=fh, capture_output=True,
                    timeout=600, cwd=root)
            walls[f"{tool}_{dev}"] = round(time.perf_counter() - t0, 3)
            result = [ln for ln in out.stderr.decode().splitlines()
                      if ln.startswith(("rank = ", "ok = "))]
            if out.returncode not in (0, 1) or not result:
                raise AssertionError(f"cli {tool} --device {dev}: exit "
                                     f"{out.returncode}\n"
                                     f"{out.stderr.decode()[-2000:]}")
            runs[tool, dev] = (out.returncode, out.stdout, result)
    same = {tool: runs[tool, DEV] == runs[tool, "cpu"]
            for tool in ("rank", "kernel", "solve")}
    emit("api", case="cli rank, kernel, solve: --device "
         f"{DEV} against --device cpu", card=ctx["card"], same=same,
         stdout_bytes={t: len(runs[t, DEV][1]) for t in same},
         results={t: runs[t, DEV][2] for t in same}, walls_s=walls)
    if not all(same.values()):
        raise AssertionError(f"cli card != cpu: {same}")
    if runs["solve", DEV][2] != ["ok = 11110000"]:
        raise AssertionError(f"cli solve: {runs['solve', DEV][2]}")


def phase_api(ctx):
    api_flagship(ctx)
    api_d8(ctx)
    A = api_card_vs_cpu(ctx)
    api_cli(ctx, A)


# ---------------- tiers: the main path at the large primes ----------------


def tier_flagship(ctx, p: int) -> None:
    """(a): the flagship's pattern at p through echelonize on the card:
    the first call (eager), the second (capture), warm replays, each of
    rank N, and the streaming loop at the fused loop's block height, all
    bit-equal to the first."""
    from spasm_tpu_torch import SparseGFp, field
    from spasm_tpu_torch._host.field import num_limbs
    from spasm_tpu_torch.ops import dense

    N = FLAGSHIP_N
    A = SparseGFp.rand(field(p), N, N, 0.02, np.random.default_rng(5))
    lus, recs = {}, {}
    with watched_finish():
        dense.release_finish_graphs()
        lus["first"], recs["first"] = timed_finish(A, {}, "warn")
        lus["second"], recs["second"] = timed_finish(A, {}, "error")
        for i in range(FUSED_WARM):
            lus[f"warm {i + 1}"], recs[f"warm {i + 1}"] = timed_finish(
                A, {}, "error")
        old = dense.FUSED_BUDGET
        dense.FUSED_BUDGET = 0
        try:
            lus["streaming"], recs["streaming"] = timed_finish(
                A, dict(dense_block_size=dense._bucket(1000)), "warn")
        finally:
            dense.FUSED_BUDGET = old
    bad = {k: lu_mismatch(v, lus["first"]) for k, v in lus.items()}
    ranks = {k: int(v["r"]) for k, v in lus.items()}
    nl = num_limbs(p)
    note_path(ctx, f"tiers: flagship rank at p = {p} ({nl} limbs), first "
              "(eager)", recs["first"]["launches"])
    keep = ("wall_s", "pivot_s", "finish_s", "device_s", "graph",
            "capture_s", "graph_bytes", "input_bytes", "syncs", "launches")
    emit("tiers", part="flagship", p=p, limbs=nl, card=ctx["card"],
         nnz=A.nnz, ranks=ranks,
         runs={k: {x: r[x] for x in keep if x in r} for k, r in recs.items()},
         mismatched=bad)
    if any(bad.values()) or set(ranks.values()) != {N}:
        raise AssertionError(f"flagship at p = {p}: ranks {ranks}, LUs "
                             f"differ: {bad}")
    check_fused_runs(f"flagship at p = {p}", recs)


def tier_rref_matrix(p: int) -> np.ndarray:
    from spasm_tpu_torch import field

    return field(p).rand((TIER_RREF, TIER_RREF),
                         np.random.default_rng(2)).astype(np.int64)


def tier_rref_cpu(p: int):
    """The CPU tensor path's RREF of tier_rref_matrix(p), and its wall."""
    from spasm_tpu_torch import field
    from spasm_tpu_torch.ops import dense

    return wall(lambda: dense.rref(field(p), tier_rref_matrix(p),
                                   device="cpu", host_cutoff=0))


def tier_rref(ctx, p: int) -> dict:
    """(d): ops/dense.rref of a random TIER_RREF^2 matrix at p on the card
    (the JAX package's dense_rref case), timed twice, rank TIER_RREF."""
    from spasm_tpu_torch import field
    from spasm_tpu_torch.ops import dense

    f = field(p)
    X = tier_rref_matrix(p)
    n = TIER_RREF
    reset_launches()
    got, first_s = wall(lambda: dense.rref(f, X, device=DEV))
    launches = read_launches()
    _, warm_s = wall(lambda: dense.rref(f, X, device=DEV))
    rec = dict(part="dense rref", p=p, card=ctx["card"], shape=[n, n],
               rank=got["rank"], card_first_s=first_s, card_warm_s=warm_s,
               launches=launches)
    if got["rank"] != n:
        raise AssertionError(f"dense rref at p = {p}: rank {got['rank']}")
    if DEV == "cuda" and not (launches["modmatmul"] and launches["panel"]):
        raise AssertionError(f"dense rref at p = {p}: no K1 / K2 launch")
    return dict(rec=rec, got=got)


def tier_rref_vs_cpu(rr: dict, cpu) -> None:
    """tier_rref's card RREF against tier_rref_cpu's, bit for bit."""
    (want, cpu_s), got = cpu, rr["got"]
    keys = ("R", "rank", "piv_rows", "piv_cols", "qinv")
    bad = [k for k in keys if not np.array_equal(np.asarray(got[k]),
                                                 np.asarray(want[k]))]
    emit("tiers", **rr["rec"], cpu_s=cpu_s, mismatched=bad)
    if bad:
        raise AssertionError(f"dense rref at p = {rr['rec']['p']}: card != "
                             f"cpu in {bad}")


def tier_cpu_job(kind: str, p: int, kn: dict):
    """A child process of the tiers phase: the CPU side of one card
    against CPU comparison at p ("echelon", "api" or "rref")."""
    from spasm_tpu_torch._host.utils.hostmem import tune_host_malloc
    from spasm_tpu_torch.ops import dense

    cutoffs = kn.pop("cutoffs")
    globals().update(kn)
    dense.HOST_CUTOFF, dense.HOST_CUTOFF_BIGP = cutoffs
    tune_host_malloc()
    torch.set_num_threads(TIER_CPU_THREADS)
    if kind == "echelon":
        return echelon_run(p, "cpu")
    if kind == "api":
        return api_outputs(api_mid_case(p), "cpu", full=False)[:2]
    return tier_rref_cpu(p)


def phase_tiers(ctx):
    """The main path at the JAX package's large primes: tier B (4 limbs)
    and tier C (5 limbs).  The timed card work runs first, alone; then the
    CPU sides of the card against CPU comparisons run in child processes
    while the card runs its sides."""
    import multiprocessing as mp

    import spasm_tpu_torch
    from spasm_tpu_torch.ops import dense

    rrefs = {}
    for p in TIER_PRIMES:
        flag_errors(ctx, "tiers", p)
        tier_flagship(ctx, p)
        rrefs[p] = tier_rref(ctx, p)
        spasm_tpu_torch.release_native_scratch()
    kn = dict(knobs(), cutoffs=(dense.HOST_CUTOFF, dense.HOST_CUTOFF_BIGP))
    with mp.get_context("spawn").Pool(TIER_CPU_PROCS) as pool:
        # the longest first
        jobs = {(kind, p): pool.apply_async(tier_cpu_job, (kind, p, kn))
                for kind in ("api", "rref", "echelon")
                for p in TIER_PRIMES[::-1]}
        for p in TIER_PRIMES:
            echelon_card_vs_cpu(ctx, "tiers", p, cpu=jobs["echelon", p].get(
                CHILD_TIMEOUT_S))
            api_card_vs_cpu(ctx, "tiers", p, full=False,
                            cpu=jobs["api", p].get(CHILD_TIMEOUT_S))
            tier_rref_vs_cpu(rrefs[p], jobs["rref", p].get(CHILD_TIMEOUT_S))


# ---------------- resume: checkpoint / resume on the card ----------------


def work_dir(name: str) -> str:
    d = os.path.join(os.path.dirname(os.path.abspath(__file__)), "build",
                     f"chip_smoke_{name}")
    shutil.rmtree(d, ignore_errors=True)
    os.makedirs(d)
    return d


def make_case(name: str):
    """The flagship or a simplex boundary by name ("flagship", "d7", "d8"),
    built the same way in every process."""
    from spasm_tpu_torch import SparseGFp, field
    from spasm_tpu_torch._host.fixtures import simplex_boundary

    if name == "flagship":
        return SparseGFp.rand(field(42013), FLAGSHIP_N, FLAGSHIP_N, 0.02,
                              np.random.default_rng(5))
    n, k, _ = {"d7": D7, "d8": D8}[name]
    return simplex_boundary(n, k)


def knobs() -> dict:
    return {k: globals()[k] for k in CHILD_KNOBS}


def checkpoint_child(case: str, path: str, log_path: str, kn: dict) -> None:
    """A child process: echelonize(case, checkpoint=path) with a sidecar
    saved after every block (the streaming loop: FUSED_BUDGET = 0, as
    over the budget), each log line flushed to log_path."""
    import importlib

    from spasm_tpu_torch import echelonize, set_log
    from spasm_tpu_torch._host.utils.hostmem import tune_host_malloc
    from spasm_tpu_torch.ops import dense

    globals().update(kn)
    tune_host_malloc()
    importlib.import_module(
        "spasm_tpu_torch.echelonize").DENSE_CKPT_INTERVAL_S = 0.0
    dense.FUSED_BUDGET = 0
    A = make_case(case)
    with open(log_path, "a", buffering=1) as fh:
        set_log(lambda msg: fh.write(f"{time.time():.3f} {msg}\n"))
        echelonize(A, checkpoint=path, device=DEV, verbose=True,
                   dense_block_size=RESUME_BLOCK)
    set_log(None)


def killed_checkpoint_run(case: str, path: str, ready) -> dict:
    """Run checkpoint_child in a process of its own and SIGKILL it as soon
    as ready(log lines) holds; returns its log lines and whether the kill
    landed before the child ended."""
    import multiprocessing as mp

    log_path = path + ".log"
    child = mp.get_context("spawn").Process(
        target=checkpoint_child, args=(case, path, log_path, knobs()))
    t0 = time.perf_counter()
    child.start()
    lines: list[str] = []
    try:
        while child.is_alive():
            if time.perf_counter() - t0 > CHILD_TIMEOUT_S:
                raise AssertionError(f"{case}: the checkpoint child ran "
                                     f"past {CHILD_TIMEOUT_S} s")
            if os.path.exists(log_path):
                with open(log_path) as fh:
                    lines = fh.read().splitlines()
                if ready(lines):
                    child.kill()
                    break
            time.sleep(0.05)
    finally:
        if child.is_alive():
            child.kill()
        child.join(60)
    with open(log_path) as fh:
        lines = fh.read().splitlines()
    return dict(killed=child.exitcode == -signal.SIGKILL,
                exitcode=child.exitcode, lines=lines,
                child_s=round(time.perf_counter() - t0, 3))


_SAVED = re.compile(r"checkpoint saved at (round|block offset) (\d+) "
                    r"\((\d+) bytes, ([\d.]+)s\)")


def saves_of(lines) -> list:
    """(kind, round or b0, bytes, seconds) of each save the log records."""
    return [(m[1], int(m[2]), int(m[3]), float(m[4]))
            for m in map(_SAVED.search, lines) if m]


def lu_mismatch(got: dict, want: dict) -> list:
    return sorted(k for k in set(got) | set(want)
                  if k not in got or k not in want
                  or not np.array_equal(got[k], want[k]))


def resume_case(ctx, case: str, ready, expected_rank: int) -> None:
    from spasm_tpu_torch import echelonize, last_phase_stats
    from spasm_tpu_torch.interop import lu_arrays
    from spasm_tpu_torch.ops import dense

    A = make_case(case)
    ctx.setdefault("cases", {})[case] = A
    reset_launches()
    fact, uninterrupted_s = wall(lambda: echelonize(
        A, device=DEV, dense_block_size=RESUME_BLOCK))
    full_launches = read_launches()
    want = lu_arrays(fact)
    d = work_dir(f"resume_{case}")
    path = os.path.join(d, f"{case}.npz")
    run = killed_checkpoint_run(case, path, ready)
    saves = saves_of(run["lines"])
    sidecar = path + ".dense"
    sidecar_bytes = (os.path.getsize(sidecar) if os.path.exists(sidecar)
                     else None)
    # the resumed path's launches: counts set to 0 right before.  The
    # streaming steps the uninterrupted run took would be captured and
    # replayed, which the wrappers do not count: forget them, so that the
    # resumed steps run eagerly
    dense.release_finish_graphs()
    reset_launches()
    fact, resumed_s = wall(lambda: echelonize(
        A, resume=path, device=DEV, dense_block_size=RESUME_BLOCK))
    launches = read_launches()
    stats = last_phase_stats()
    got = lu_arrays(fact)
    bad = lu_mismatch(got, want)
    note_path(ctx, f"resume: {case}", launches)
    emit("resume", case=case, card=ctx["card"], nnz=A.nnz, rank=fact.r,
         expected=expected_rank, killed=run["killed"],
         child_exitcode=run["exitcode"], child_s=run["child_s"],
         saves=[dict(at=k, index=i, bytes=b, save_s=t)
                for k, i, b, t in saves],
         sidecar_bytes_at_kill=sidecar_bytes,
         uninterrupted_s=uninterrupted_s, resumed_s=resumed_s,
         phases=stats, launches=launches,
         launches_uninterrupted=full_launches, mismatched=bad,
         sidecar_left=os.path.exists(sidecar))
    if bad or fact.r != expected_rank:
        raise AssertionError(f"{case}: resumed LU != uninterrupted in {bad}, "
                             f"rank {fact.r}")
    if not ready(run["lines"]):
        raise AssertionError(f"{case}: the child ended before its "
                             f"checkpoint: {run['lines'][-5:]}")
    if os.path.exists(sidecar):
        raise AssertionError(f"{case}: the sidecar outlived the finish")
    shutil.rmtree(d, ignore_errors=True)
    return launches


def phase_resume(ctx):
    from spasm_tpu_torch.ops import dense

    def sidecar_saved(lines):
        return any(k == "block offset" and b0 > 0
                   for k, b0, _, _ in saves_of(lines))

    def round_saved(lines):
        return any(k == "round" and r >= 1 for k, r, _, _ in saves_of(lines))

    # the killed runs stream as a finish over FUSED_BUDGET does (here and
    # in the children): within it a checkpointed run takes the fused
    # finish, which saves no sidecar
    old = dense.FUSED_BUDGET
    dense.FUSED_BUDGET = 0
    try:
        launches = resume_case(ctx, "flagship", sidecar_saved, FLAGSHIP_N)
        if DEV == "cuda" and not (launches["modmatmul"]
                                  and launches["panel"]):
            raise AssertionError(f"the resumed finish launched no K1 or "
                                 f"K2: {launches}")
        resume_case(ctx, "d8", round_saved, D8[2])
    finally:
        dense.FUSED_BUDGET = old
    checkpointed_fused(ctx)


def checkpointed_fused(ctx) -> None:
    """The flagship with checkpoint= at the default budget: it takes the
    fused finish (one call of dense.fused_blocked_finish), writes the
    round checkpoint and no sidecar, and its LU is bit-equal to the run
    without checkpoint=."""
    from spasm_tpu_torch import set_log
    from spasm_tpu_torch.ops import dense

    A = ctx["cases"]["flagship"]
    d = work_dir("resume_fused")
    path = os.path.join(d, "flagship.npz")
    lines: list[str] = []
    with watched_finish():
        want, plain = timed_finish(A, {}, "warn")
        set_log(lines.append)
        try:
            got, ckpt = timed_finish(A, dict(checkpoint=path, verbose=True),
                                     "warn")
        finally:
            set_log(None)
    bad = lu_mismatch(got, want)
    files = sorted(os.listdir(d))
    emit("resume", case="flagship, checkpoint= at the default budget",
         card=ctx["card"], fused_budget=dense.FUSED_BUDGET,
         rank=int(got["r"]), fused_calls=ckpt["fused_calls"],
         graph=ckpt.get("graph"), saves=saves_of(lines), files=files,
         wall_s=ckpt["wall_s"], finish_s=ckpt["finish_s"],
         wall_without_s=plain["wall_s"], finish_without_s=plain["finish_s"],
         mismatched=bad)
    if bad or int(got["r"]) != FLAGSHIP_N:
        raise AssertionError(f"checkpointed flagship != unchecked in {bad}")
    if (ckpt["fused_calls"] != 1 or files != ["flagship.npz"]
            or any(k != "round" for k, _, _, _ in saves_of(lines))):
        raise AssertionError(f"the checkpointed flagship did not take the "
                             f"fused finish alone: {ckpt['fused_calls']} "
                             f"fused calls, files {files}")
    shutil.rmtree(d, ignore_errors=True)


# ---------------- mesh: scale-out over torch.distributed ----------------


def free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def planted_dense(n: int, keep: int, seed: int) -> np.ndarray:
    """A dense (n, n) matrix at p=42013 whose rows keep.. are random 3-row
    combinations of rows 0..keep-1."""
    from spasm_tpu_torch import field

    f = field(42013)
    rng = np.random.default_rng(seed)
    X = f.rand((n, n), rng).astype(np.int64)
    idx = rng.integers(0, keep, (n - keep, 3))
    coef = f.rand((n - keep, 3), rng).astype(np.int64)
    X[keep:] = f.normalize(sum(coef[:, j, None] * X[idx[:, j]]
                               for j in range(3)))
    return X


def mesh_work(mesh, d7, X) -> dict:
    """This rank's mesh runs: echelonize(d7, mesh=) with every K3 tile held
    against the plain merge, then distributed_rank(X); the launch counts
    of each set to 0 right before and read right after."""
    from spasm_tpu_torch import echelonize, field, last_phase_stats
    from spasm_tpu_torch.interop import lu_arrays
    from spasm_tpu_torch.ops import cuda_merge
    from spasm_tpu_torch.ops.merge import merge_rows_plain
    from spasm_tpu_torch.parallel.sharded import distributed_rank
    out: dict = {"rank": mesh.get_local_rank()}
    kernel = cuda_merge.merge_rows_cuda
    tiles = []

    def held(f_, c, v, m_):
        got = kernel(f_, c, v, m_)
        want = merge_rows_plain(f_, c, v, m_)
        tiles.append(dict(shape=list(c.shape), kept=int(want[2].sum()),
                          max_abs_err=max(max_abs_diff(g, w)
                                          for g, w in zip(got, want))))
        return got

    cuda_merge.merge_rows_cuda = held
    reset_launches()
    try:
        fact, out["d7_s"] = wall(lambda: echelonize(d7, mesh=mesh,
                                                    device=DEV))
    finally:
        cuda_merge.merge_rows_cuda = kernel
    out["d7_launches"] = read_launches()
    out["d7_phases"] = last_phase_stats()
    out["d7_lu"] = lu_arrays(fact)
    out["d7_tiles"] = tiles
    reset_launches()
    out["dist_rank"], out["dist_rank_s"] = wall(
        lambda: distributed_rank(field(42013), mesh, X))
    out["dist_rank_launches"] = read_launches()
    return out


def mesh_child(rank: int, world: int, port: int, kn: dict,
               out: str) -> None:
    """One rank of a gloo group whose ranks share the card (NCCL refuses
    two ranks on one card)."""
    import torch.distributed as dist

    from spasm_tpu_torch._host.utils.hostmem import tune_host_malloc
    from spasm_tpu_torch.parallel.sharded import make_mesh

    globals().update(kn)
    tune_host_malloc()
    # the ranks share the host's cores: spinning thread pools of two
    # processes on every core slow each other down many times over
    torch.set_num_threads(max(1, (os.cpu_count() or 1) // world))
    if DEV == "cuda":
        torch.cuda.set_device(0)
    dist.init_process_group("gloo", init_method=f"tcp://127.0.0.1:{port}",
                            rank=rank, world_size=world)
    try:
        res = mesh_work(make_mesh(world, device_type=DEV), make_case("d7"),
                        planted_dense(*DIST_RANK))
    finally:
        dist.destroy_process_group()
    with open(out, "wb") as fh:
        pickle.dump(res, fh)


def mesh_children(world: int, target=None, inputs=None) -> list:
    """Run ``target`` (mesh_child by default) as ``world`` spawned gloo
    ranks and return their pickled results in rank order; ``inputs``, if
    given, reach each rank through a pickle file."""
    import multiprocessing as mp

    from spasm_tpu_torch import release_native_scratch

    # the ranks share the card: no cached graph of this process holds it
    release_native_scratch()
    target = target or mesh_child
    d = work_dir(f"{target.__name__}_{world}")
    extra = ()
    if inputs is not None:
        extra = (os.path.join(d, "inputs.pkl"),)
        with open(extra[0], "wb") as fh:
            pickle.dump(inputs, fh)
    port = free_port()
    outs = [os.path.join(d, f"rank{r}.pkl") for r in range(world)]
    ctx = mp.get_context("spawn")
    procs = [ctx.Process(target=target, args=(r, world, port, knobs(),
                                              *extra, outs[r]))
             for r in range(world)]
    for p in procs:
        p.start()
    t0 = time.perf_counter()
    for p in procs:
        p.join(max(1.0, CHILD_TIMEOUT_S - (time.perf_counter() - t0)))
    for p in procs:
        if p.is_alive():
            p.kill()
            p.join()
    if any(p.exitcode != 0 for p in procs):
        raise AssertionError(f"{target.__name__} world {world}: exit codes "
                             f"{[p.exitcode for p in procs]}")
    res = []
    for o in outs:
        with open(o, "rb") as fh:
            res.append(pickle.load(fh))
    shutil.rmtree(d, ignore_errors=True)
    return res


def phase_mesh(ctx):
    import torch.distributed as dist

    from spasm_tpu_torch import SparseGFp, echelonize, rank
    from spasm_tpu_torch.interop import lu_arrays
    from spasm_tpu_torch.parallel.sharded import make_mesh

    d7 = make_case("d7")
    want, single_s = wall(lambda: lu_arrays(echelonize(
        d7, device=DEV, device_sparse_min_nnz=1)))
    X = planted_dense(*DIST_RANK)
    want_rank, rank_s = wall(lambda: rank(SparseGFp.from_dense(X, 42013),
                                          device=DEV))
    emit("mesh", part="single device", card=ctx["card"], d7_rank=int(
        want["r"]), d7_s=single_s, dense_shape=list(X.shape),
         dense_rank=want_rank, dense_rank_s=rank_s)
    if want["r"] != D7[2] or want_rank != DIST_RANK[1]:
        raise AssertionError(f"d7 rank {want['r']}, dense rank {want_rank}")
    for world in MESH_WORLDS:
        if world == 1:
            # NCCL in this process
            dist.init_process_group(
                "nccl" if DEV == "cuda" else "gloo",
                init_method=f"tcp://127.0.0.1:{free_port()}", rank=0,
                world_size=1)
            try:
                backend = dist.get_backend()
                ranks = [mesh_work(make_mesh(1, device_type=DEV), d7, X)]
            finally:
                dist.destroy_process_group()
        else:
            backend = "gloo"
            ranks = mesh_children(world)
        for r in ranks:
            bad = lu_mismatch(r["d7_lu"], want)
            tile_err = max((t["max_abs_err"] for t in r["d7_tiles"]),
                           default=None)
            path = f"mesh: d7 echelonize, world {world}, rank {r['rank']}"
            note_path(ctx, path, r["d7_launches"])
            note_path(ctx, f"mesh: distributed_rank, world {world}, rank "
                      f"{r['rank']}", r["dist_rank_launches"])
            emit("mesh", part="d7 echelonize", world=world, backend=backend,
                 rank_of_mesh=r["rank"], card=ctx["card"],
                 rank=int(r["d7_lu"]["r"]), wall_s=r["d7_s"],
                 single_device_s=single_s, phases=r["d7_phases"],
                 launches=r["d7_launches"], k3_tiles_vs_plain=r["d7_tiles"],
                 mismatched=bad)
            emit("mesh", part="distributed_rank", world=world,
                 backend=backend, rank_of_mesh=r["rank"], card=ctx["card"],
                 shape=list(X.shape), rank=r["dist_rank"],
                 expected=want_rank, wall_s=r["dist_rank_s"],
                 rank_wall_s=rank_s, launches=r["dist_rank_launches"])
            if bad:
                raise AssertionError(f"world {world} rank {r['rank']}: mesh "
                                     f"LU != single-device LU in {bad}")
            if r["dist_rank"] != want_rank:
                raise AssertionError(f"distributed_rank {r['dist_rank']} != "
                                     f"{want_rank}")
            if DEV == "cuda" and not (
                    r["d7_launches"]["merge"] == len(r["d7_tiles"]) > 0
                    and not tile_err
                    and r["dist_rank_launches"]["modmatmul"]):
                raise AssertionError(f"world {world} rank {r['rank']}: K3 "
                                     f"{r['d7_tiles']}, launches "
                                     f"{r['d7_launches']}, "
                                     f"{r['dist_rank_launches']}")
    mesh_spmv(ctx)


def mesh_spmv(ctx):
    """xapy / axpy of d8 on the card against scipy's product mod p."""
    from spasm_tpu_torch.ops import spmv

    B = ctx.get("cases", {}).get("d8")
    if B is None:
        B = make_case("d8")
    f = B.field
    S = B.to_scipy().astype(np.int64)
    rng = np.random.default_rng(16)
    D, upload_s = wall(lambda: spmv.DeviceCOO.from_csr(B, device=DEV))
    rec = dict(case=f"d8 boundary {D8[:2]}", card=ctx["card"], nnz=B.nnz,
               upload_s=upload_s)
    for op, n_in, n_out, host in (("xapy", B.n, B.m, lambda x: S.T @ x),
                                  ("axpy", B.m, B.n, lambda x: S @ x)):
        x = f.rand(n_in, rng).astype(np.int64)
        y = f.rand(n_out, rng).astype(np.int64)
        fn = getattr(spmv, op)
        got, card_s = wall(lambda: fn(D, x, y).cpu().numpy())
        want, host_s = wall(lambda: f.normalize(host(x) + y))
        rec[op] = dict(card_s=card_s, host_s=host_s,
                       equal=bool(np.array_equal(got, want)))
        if DEV == "cuda":
            xd, yd = (torch.from_numpy(v).to(DEV) for v in (x, y))
            rec[op]["card_ms"] = time_ms(lambda: fn(D, xd, yd), 5)
        if not rec[op]["equal"]:
            raise AssertionError(f"{op} on the card != scipy mod p")
    emit("mesh", part="spmv", **rec)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--phases", default=",".join(PHASES),
                    help="comma-separated subset of " + ",".join(PHASES))
    ap.add_argument("--profile", metavar="DIR", default=None,
                    help="trace one flagship rank; Chrome trace into DIR")
    args = ap.parse_args(argv)
    phases = [p for p in args.phases.split(",") if p]
    unknown = set(phases) - set(PHASES)
    if unknown:
        ap.error(f"unknown phases {sorted(unknown)}")
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device visible to torch", file=sys.stderr)
        return 2
    try:
        import spasm_tpu_torch  # noqa: F401
    except ImportError as e:
        print(f"chip_smoke: spasm_tpu_torch is not importable ({e}); run "
              "from the repository root", file=sys.stderr)
        return 2
    from spasm_tpu_torch._host.utils.hostmem import tune_host_malloc

    tune_host_malloc()
    ctx: dict = {"profile_dir": args.profile}
    t_all = time.perf_counter()
    if "build" not in phases:
        phases.insert(0, "build")
    phase_s = {}
    for ph in PHASES:
        if ph in phases:
            t_ph = time.perf_counter()
            globals()[f"phase_{ph}"](ctx)
            # no cached graph of the fused finish keeps its card memory
            # into the next phase (whose ranks may share the card)
            spasm_tpu_torch.release_native_scratch()
            phase_s[ph] = round(time.perf_counter() - t_ph, 1)
    kernels = []
    launches = ctx.get("launches", {})
    for name, src, rep, tkey, ekey in (
            ("modmatmul", "spasm_tpu_torch/csrc/modmatmul_product.cuh",
             "spasm_tpu/ops/pallas_matmul.py:125", "k1_time", "k1_err"),
            # the limb split the TPU wrapper does in jnp before its kernel
            ("modmatmul_split", "spasm_tpu_torch/csrc/modmatmul.cu",
             "spasm_tpu/ops/pallas_matmul.py:218", "k1s_time", "k1s_err"),
            ("panel", "spasm_tpu_torch/csrc/panel.cu",
             "spasm_tpu/ops/pallas_panel.py:167", "k2_time", "k2_err"),
            ("merge", "spasm_tpu_torch/csrc/merge.cu",
             "spasm_tpu/ops/pallas_merge.py:45", "k3_time", "k3_err")):
        if ekey not in ctx:
            continue
        ms, plain_ms, bound_ms, bound_by, library_ms = ctx.get(
            tkey, (None,) * 5)
        kernels.append(dict(name=name, route="cuda", source=src,
                            replaces=rep, launches=launches.get(name),
                            max_abs_err=ctx[ekey], ms=ms, plain_ms=plain_ms,
                            bound_ms=bound_ms, bound_by=bound_by,
                            library_ms=library_ms))
        if name == "modmatmul":
            # ms is the wrapper call (both splits and the product)
            kernels[-1].update(ctx.get("k1_extra", {}))
        if name == "merge":
            # every timed tile, with the torch.sort yardstick beside it
            kernels[-1].update(ctx.get("k3_extra", {}))
        # the launches on each path this run drove, counts set to 0 right
        # before each and read right after
        kernels[-1]["launches_by_path"] = ctx.get("paths", {}).get(name, {})
        if name in ctx.get("by_prime", {}):
            # K1 and K2 at the kernels line's shape at every prime timed
            kernels[-1]["by_prime"] = ctx["by_prime"][name]
    print(f"[done] phases={','.join(p for p in PHASES if p in phases)} "
          f"wall_s={time.perf_counter() - t_all:.1f} "
          f"phase_s={json.dumps(phase_s)}", flush=True)
    print(json.dumps({"kernels": kernels}), flush=True)
    print(ctx["card"], flush=True)
    if set(phases) != set(PHASES):
        print("chip_smoke: partial run (--phases); no status line",
              flush=True)
        return 0
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
