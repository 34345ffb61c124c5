"""Multi-round echelonization driver: the port of ``spasm_tpu/echelonize.py``.

The round loop is the reference's, line for line, and runs on the port's
copy of the reference's host code in ``._host`` (structural pivots,
density estimate, mutual reduce, Schur updates, GPLU).  What changes is the blocked dense
finish: it runs on torch tensors (the K1 / K2 CUDA kernels on a card), in
the reference's two block loops.  Its main path is the fused finish
(``ops/dense.fused_blocked_finish``) on ``device``: the whole loop with
its control flow on the device, one CUDA graph on a card, then two reads.
A host read inside the loop is not cheap on a card: each one drains the
queue of small launches behind it, and the card then idles while the host
issues the next ones (on an H100 the 8192^2 flagship's card was busy
14-16% of a streaming finish that read back a value per panel; PERF.md).
The streaming loop, which reads each block's rank, serves what needs it,
as in the reference: low-rank mode, resume from a dense sidecar, and
inputs over ``FUSED_BUDGET``.  It also runs every finish under
``ops/dense.host_cutoff_for(f)`` elements a block, on CPU tensors and one
torch thread (the reference's NumPy host loop): those never take the fused
finish and never reach the card.  A run with ``checkpoint=`` takes the fused finish where
the reference does, and like it saves no dense sidecar there.

The device is chosen by the caller: ``device="cuda"`` (the default) or
``device="cpu"`` by name.  Without a card, ``device="cuda"`` raises.

With ``device_sparse_min_nnz=N`` a round whose remaining rows hold at
least N nonzeros takes the device sparse Schur update instead of the host
kernel, as in the reference: the one-pass merge (``ops/sparse_onepass.py``:
the K3 merge on a card, its plain version on the CPU), or where that is
unavailable the sort-based waves (``ops/sparse_device.py``).

``opts.complete`` replaces the factorization by the canonical RREF of its
row space, as in the reference (``solve.rref_of_U``).

``checkpoint=`` saves the round state after every round, and the
streaming loop's block state into ``<checkpoint>.dense`` at most every
``DENSE_CKPT_INTERVAL_S`` seconds; ``resume=`` continues from such files
(``checkpoint.py``, the reference's format: a checkpoint moves between
the two packages).  A dense sidecar that does not load is logged and
ignored, and both sidecars (of ``checkpoint`` and ``resume``) are deleted
once the finish is done: two faults of the reference left out.

``mesh=`` (a 1-D ``DeviceMesh``, ``parallel/``) runs the structural pivot
elections and the round Schur updates row-sharded over the ranks; every
rank calls with the same A and returns the same LU.  The dense finish runs
replicated on every rank's device, and only rank 0 writes checkpoints.
"""

from __future__ import annotations

import contextlib
import dataclasses
import functools
import math
import os
import time
import zipfile

import numpy as np
import scipy.sparse as sp
import torch

from ._host import pivots
from ._host.csr import SparseGFp
from ._host.elimination import (compute_levels, eliminate_against_reduced,
                                mutual_reduce, wave_eliminate)
from ._host.field import Field
from ._host.pivots import find_structural_pivots
from ._host.sputil import mod_reduce
from ._host.utils.logging import log, push_verbose, wtime
from .ops import dense as dense_ops
from .ops import modmul, sparse_device, sparse_onepass
from .ops.matmul import modmatmul
from .parallel import sparse_sharded
from .utils.profiling import phase


@dataclasses.dataclass
class EchelonizeOptions:
    """The reference's options struct (``spasm_tpu.echelonize
    .EchelonizeOptions``), with the same defaults, less
    ``low_rank_start_weight``: the port's tail check combines every
    unprocessed row (``_tail_is_dependent``), so it has no
    sample weight to set."""

    enable_greedy_pivot_search: bool = True
    enable_tall_and_skinny: bool = True
    enable_dense: bool = True
    enable_GPLU: bool = True
    L: bool = False
    complete: bool = False
    min_pivot_proportion: float = 0.1
    max_round: int = 3
    sparsity_threshold: float = 0.05
    dense_block_size: int = 1000
    low_rank_ratio: float = 0.5
    tall_and_skinny_ratio: float = 5.0
    # max dense elements for the dense finish; None = auto: 35% of the
    # card's memory in int32 elements, floor 2e8 (the CPU value)
    dense_budget: "int | None" = None
    # device sparse Schur when the remaining rows hold at least this many
    # nonzeros; 0 disables (ignored with L)
    device_sparse_min_nnz: int = 0
    # on a card, switch to the dense finish at this LOWER estimated Schur
    # density whenever it fits the dense budget; None disables
    device_sparsity_threshold: "float | None" = 0.02
    # Markowitz-style fill filter (see the reference); None disables
    pivot_fill_filter: "float | None" = 4.0


def parse_echelonize_opts(opts=None, device="cuda", **kwargs):
    opts = dataclasses.replace(opts) if opts else EchelonizeOptions()
    for k, v in kwargs.items():
        if not hasattr(opts, k):
            raise TypeError(f"unknown echelonize option {k!r}")
        setattr(opts, k, v)
    if opts.dense_budget is None:
        opts.dense_budget = _auto_dense_budget(torch.device(device))
    return opts


_AUTO_DENSE_BUDGET: dict = {}


def _auto_dense_budget(device: torch.device) -> int:
    """dense_budget resolution: 35% of the card's memory in int32 elements
    (cached per device), floor 2e8; 2e8 on the CPU."""
    key = str(device)
    if key not in _AUTO_DENSE_BUDGET:
        budget = 200_000_000
        if device.type == "cuda":
            total = torch.cuda.get_device_properties(device).total_memory
            budget = max(budget, int(total * 0.35) // 4)
        _AUTO_DENSE_BUDGET[key] = budget
    return _AUTO_DENSE_BUDGET[key]


@dataclasses.dataclass
class LU:
    """Echelonization result, field for field the reference's ``LU``
    (U rows in pivot order, unit pivots located by qinv, p maps U rows to
    rows of A, L with A == L @ U when requested).  ``_device`` is the
    device it was computed on (or loaded for): the solves invert its
    dense-finish corner block there."""

    field: Field
    n: int
    m: int
    r: int
    complete: bool
    U: SparseGFp
    qinv: np.ndarray
    p: np.ndarray
    piv_cols: np.ndarray
    L: "SparseGFp | None"
    _levels: "np.ndarray | None" = None
    dense_piv_start: "int | None" = None
    lp_order: "np.ndarray | None" = None
    _device: str = "cuda"

    @property
    def rank(self) -> int:
        return self.r

    @property
    def levels(self) -> np.ndarray:
        if self._levels is None:
            self._levels = compute_levels(self.U, self.piv_cols)
        return self._levels

    def __repr__(self):
        return (f"LU: rank {self.r}, complete {self.complete}, "
                f"U {self.U.shape}, L "
                f"{self.L.shape if self.L is not None else None}")


_LAST_STATS: dict = {}


def last_phase_stats() -> dict:
    """Per-phase walls (seconds, ``time.perf_counter``) of the most recent
    ``echelonize`` call in this process.  Each key but device_s is fed by
    one span of ``utils/profiling.phase``, which a running torch.profiler
    also records as ``spasm.<span>``:

    - total_s: ``echelonize``, the whole call, from entry to return;
    - convert_s: ``convert``, ``A.to_scipy()`` and each round's
      ``SparseGFp.from_scipy`` of the Schur complement;
    - pivot_s: ``pivots``, each round's structural pivot search;
    - estimate_s: ``estimate``, each round's pivot count test, Schur
      density estimate, dense-switch test and fill filter (its second
      estimate included);
    - schur_s: ``schur``, each round's Schur update, without the estimate;
    - schur_reduce_s: ``schur.reduce``, inside ``schur``: each round's
      ``mutual_reduce`` of its pivot block;
    - schur_eliminate_s: ``schur.eliminate``, inside ``schur``: each round's
      ``eliminate_against_reduced`` or ``wave_eliminate`` of the remaining
      rows (the device sparse rounds have neither child);
    - finish_s: ``finish``, the finish after the rounds (dense or GPLU),
      with its checkpoint sidecars' removal;
    - finish_prep_s: ``finish.prep``, the finish's alive columns and
      density gate, and the dense finish's choice of loop, up to the first
      upload;
    - finish_wait_s: ``finish.wait``, the dense finish's block loop: on the
      fused path S's CSR uploaded and its COO formed on the device
      (``dense_ops.upload_csr``), and ``fused_blocked_finish`` up to the
      return of the first readback; the whole streaming loop otherwise;
    - finish_tail_s: ``finish.tail``, inside ``finish.wait``: the
      streaming loop's tail checks (``_tail_is_dependent``);
    - finish_extract_s: ``finish.extract``, the dense finish's pivot lists
      and U's canonical CSR, built on the finish's device and read back
      (``dense_ops.extract_u_csr``; the fused path's second readback);
    - assemble_s: ``assemble``, U, qinv, L and the canonical RREF;
    - device_s: no span; the dense finish's block loop on the device, ended
      by a synchronize (0 for a finish under the cutoff, whose loop runs on
      CPU tensors), plus, with device_sparse_min_nnz, the whole wall of
      each device sparse round, its host work included (the one-pass
      ``_stats`` device_s is the card's span).

    The top-level spans (convert, pivots, estimate, schur, finish,
    assemble) leave out only the call's bookkeeping between them and the
    round checkpoints; finish.prep, .wait and .extract tile the dense
    finish.  Keys of spans not entered in the call are 0.

    Two counts of the call's structural pivot searches (the rounds' and
    the GPLU finish's) whose greedy completion ran (``pivots.GREEDY_RUNS``):

    - greedy_native: those whose completion ran in C
      (``native.greedy_pivots_native``);
    - greedy_numpy: those that fell back to the NumPy body, where the
      native library could not be built or SPASM_TPU_NO_NATIVE is set.

    Counts of the rounds and the dense finish (0 where none ran):

    - rounds: the Schur updates the call ran (the round loop's rounds that
      did not stop before their update);
    - finish_rows: the rows handed to the dense finish;
    - finish_streamed: 1 where a finish at or over the cutoff took the
      streaming loop on ``device`` (``_streaming_loop``, not the fused
      finish); 0 for a finish under the cutoff, which streams on CPU
      tensors (the benchmark's chessboard test asserts 0 there);
    - finish_blocks: the row blocks the streaming loop eliminated
      (``dense_ops.blocked_finish_step`` calls), on the device or, under
      the cutoff, on CPU tensors;
    - finish_rows_skipped: the rows that the streaming loop's tail check
      certified as lying in the row space found so far, which no block
      then eliminated;
    - rref_groups: the panel groups that the dense finish's RREFs reach
      (``dense_ops.rref_groups`` a block, dead or alive; on CPU tensors a
      group is one panel);
    - rref_groups_run: those whose body ran, counted on the card by a
      replayed graph (one add of a group's predicate, read back with the
      block's pivots) and otherwise by an eager RREF;
    - finish_copy_bytes: the bytes the dense finish copied between the
      host and a card (``dense_ops.COPY_BYTES``): every ``upload`` (S's
      CSR, the column map where a column is dead, a resumed sidecar's
      panel) and every ``to_host`` (each read of block pivots, the tail
      checks' values, U's CSR, a sidecar's panel); 0 for a finish on CPU
      tensors and for a call without a dense finish."""
    return dict(_LAST_STATS)


def echelonize(A: SparseGFp, opts: EchelonizeOptions | None = None,
               verbose=False, checkpoint: str | None = None,
               resume: str | None = None, mesh=None, *, device="cuda",
               **kwargs) -> LU:
    """Echelonize A on ``device`` ("cuda" or "cpu").  ``verbose`` may be a
    bool or an nnz threshold (verbose = nnz(A) >= threshold).

    checkpoint: path to persist the round state after every round (and
    the dense finish's block state beside it); resume: path of a previous
    checkpoint to continue from (the same A must be passed).  mesh: a 1-D
    ``torch.distributed.device_mesh.DeviceMesh``; every rank calls with
    the same A, and ``device`` names the mesh's device type (each rank
    computes on its own device of that type)."""
    stats = {"total_s": 0.0, "convert_s": 0.0, "pivot_s": 0.0,
             "estimate_s": 0.0, "schur_s": 0.0, "schur_reduce_s": 0.0,
             "schur_eliminate_s": 0.0, "finish_s": 0.0,
             "finish_prep_s": 0.0, "finish_wait_s": 0.0,
             "finish_tail_s": 0.0, "finish_extract_s": 0.0,
             "assemble_s": 0.0, "device_s": 0.0, "rounds": 0,
             "finish_rows": 0, "finish_streamed": 0, "finish_blocks": 0,
             "finish_rows_skipped": 0, "rref_groups": 0,
             "rref_groups_run": 0, "finish_copy_bytes": 0}
    runs = dict(pivots.GREEDY_RUNS)
    with phase("echelonize", stats, key="total_s"):
        device = torch.device(device)
        if mesh is not None:
            if mesh.device_type != device.type:
                raise ValueError(f"device={str(device)!r} is not the mesh's "
                                 f"device type {mesh.device_type!r}")
            device = sparse_sharded.mesh_device(mesh)
        if device.type == "cuda":
            torch.zeros(0, device=device)  # raises here when there is no card
        opts = parse_echelonize_opts(opts, device=device, **kwargs)
        if not isinstance(verbose, bool):
            verbose = A.nnz >= verbose
        with push_verbose(verbose):
            fact = _echelonize_impl(A, opts, device, stats, checkpoint,
                                    resume, mesh)
    for k in ("native", "numpy"):
        stats["greedy_" + k] = pivots.GREEDY_RUNS[k] - runs[k]
    global _LAST_STATS
    _LAST_STATS = stats
    return fact


def _echelonize_impl(A: SparseGFp, opts: EchelonizeOptions,
                     device: torch.device, stats: dict,
                     checkpoint: str | None = None,
                     resume: str | None = None, mesh=None) -> LU:
    """The body of ``echelonize``; its spans add to ``stats``
    (``last_phase_stats``)."""
    f = A.field
    n, m = A.shape
    t_start = wtime()
    log(f"[echelonize] Start on {n} x {m} matrix with {A.nnz} nnz")

    with phase("convert", stats):
        S = A.to_scipy()                # current Schur complement
    row_origin = np.arange(n, dtype=np.int64)

    U_blocks: list[sp.csr_matrix] = []  # scaled pivot row blocks
    piv_cols_all: list[np.ndarray] = []
    piv_origin_all: list[np.ndarray] = []
    L_parts: list[tuple] = []           # (rows_orig, piv_idx, value)
    # rounds whose L was recorded against the REDUCED pivot block: their
    # (start, npiv) slot ranges have an upper-triangular L block
    L_rev_segments: list[tuple[int, int]] = []
    r = 0
    round_idx = 0
    # on a mesh, rank 0 alone writes (and deletes) the checkpoint files
    writer = mesh is None or mesh.get_local_rank() == 0
    dense_resume = None
    if resume:
        from . import checkpoint as ckpt

        state = ckpt.load_state(resume)
        if state["field_p"] != f.p:
            raise ValueError("checkpoint prime differs from matrix prime")
        S = state["S"]
        row_origin = state["row_origin"]
        r = state["r"]
        round_idx = state["round_idx"]
        if r:
            U_blocks.append(state["U"])
            piv_cols_all.append(state["piv_cols"])
            piv_origin_all.append(state["piv_origin"])
        L_parts.extend(state["L_parts"])
        L_rev_segments.extend(state.get("L_rev_segments", []))
        log(f"[echelonize] resumed at round {round_idx}, rank {r}")
        # the dense finish's block state, validated against the finish's
        # inputs in _dense_finish_blocked
        dense_resume = _load_dense_sidecar(resume + ".dense")
        if mesh is not None:
            # every rank has read the files before rank 0 replaces them
            sparse_sharded.barrier(mesh)

    if checkpoint and not resume and writer:
        # initial checkpoint: a run that dense-switches at round 0 (or
        # crashes mid-round) still leaves a resumable state on disk
        _save_checkpoint(checkpoint, f, opts, round_idx, r, S, row_origin,
                         m, U_blocks, piv_cols_all, piv_origin_all, L_parts)

    force_dense = False  # set when a round's density gate trips
    fill_filter_rejects = 0  # Markowitz probe strikes (2 = stop probing)
    while round_idx < opts.max_round:
        if S.shape[0] == 0 or S.nnz == 0:
            break
        log(f"[echelonize] round {round_idx}")
        with phase("convert", stats):
            Sw = SparseGFp.from_scipy(S, f.p, assume_canonical=True)
        with phase("pivots", stats, key="pivot_s"):
            t0 = wtime()
            fl = col_election = None
            if mesh is not None:
                # the FL row and column elections over the mesh,
                # bit-identical to the host strategies; the greedy
                # completion runs on the host on every rank
                fl = sparse_sharded.sharded_fl_election(f, mesh, Sw)
                col_election = functools.partial(
                    sparse_sharded.sharded_fl_col_election, f, mesh, Sw)
            prows, pcols, counts = find_structural_pivots(
                Sw, enable_greedy=opts.enable_greedy_pivot_search, fl=fl,
                col_election=col_election)
            log(f"[pivots] Faugère-Lachartre: "
                f"{counts['faugere-lachartre']} pivots found "
                f"[{wtime() - t0:.1f}s]")
            log(f"[pivots] ``Faugère-Lachartre on columns'': "
                f"{counts['faugere-lachartre-cols']} pivots found "
                f"[{wtime() - t0:.1f}s]")
            log(f"[pivots] greedy cycle-free completion: "
                f"{counts['greedy']} pivots found [{wtime() - t0:.1f}s]")
            log(f"[pivots] {prows.size} pivots found")
        t0 = wtime()  # the Schur log line's clock: estimate and update
        with phase("estimate", stats):
            npiv = prows.size
            row_lens = np.diff(S.indptr)
            nrows_active = int((row_lens > 0).sum())
            minkeep = opts.min_pivot_proportion * max(
                1, min(nrows_active, S.shape[1]))
            if npiv < minkeep:
                log("[echelonize] not enough pivots found; stopping")
                break

            # Monte-Carlo density estimate BEFORE paying for the full
            # Schur; the rest-row gather is only needed by the L path and
            # the device sparse path
            need_rest = (opts.L or mesh is not None
                         or bool(opts.device_sparse_min_nnz))
            est, S_rest, rest_rows, blk = _round_schur_estimate(
                f, S, prows, pcols, need_rest=need_rest)
            Upart, piv_vals, levels_blk = blk
            del blk
            log(f"Schur complement is {rest_rows.size} x {S.shape[1]}, "
                f"estimated density : {est:.2f}")
            thresh = opts.sparsity_threshold
            if (opts.device_sparsity_threshold is not None
                    and opts.enable_dense
                    and opts.device_sparsity_threshold <= est < thresh
                    and _on_accelerator(device)
                    and _dense_feasible(S, opts, device)):
                thresh = min(thresh, opts.device_sparsity_threshold)
            if (est >= thresh and opts.enable_dense
                    and (round_idx > 0
                         or _dense_feasible(S, opts, device))):
                log("[echelonize] Schur complement too dense; "
                    "switching to dense finish")
                force_dense = True
                break
            if (opts.pivot_fill_filter and fill_filter_rejects < 2
                    and est * rest_rows.size * S.shape[1]
                    > opts.pivot_fill_filter * max(1, S.nnz)):
                # predicted fill blow-up: drop the high-Markowitz-cost
                # pivots
                cc = np.bincount(S.indices, minlength=S.shape[1])
                cost = ((row_lens[prows] - 1)
                        * (cc[pcols] - 1)).astype(np.float64)
                keep = cost <= 2.0 * max(1.0, float(np.median(cost)))
                if keep.sum() >= minkeep and not keep.all():
                    pr2, pc2 = prows[keep], pcols[keep]
                    est2, S_rest2, rest2, blk2 = _round_schur_estimate(
                        f, S, pr2, pc2, need_rest=need_rest)
                    if est2 * rest2.size <= 0.75 * est * rest_rows.size:
                        log(f"[pivots] fill filter: deferring "
                            f"{int((~keep).sum())} high-fill pivots "
                            f"(predicted fill "
                            f"{est * rest_rows.size:.0f} -> "
                            f"{est2 * rest2.size:.0f} row-equivalents)")
                        prows, pcols = pr2, pc2
                        npiv = prows.size
                        est, S_rest, rest_rows = est2, S_rest2, rest2
                        Upart, piv_vals, levels_blk = blk2
                    else:
                        fill_filter_rejects += 1
                    del blk2
        with phase("schur", stats):
            reduced_L = False
            piv_L = None
            S_new = C = None
            if not opts.L and (mesh is not None or (
                    opts.device_sparse_min_nnz
                    and S_rest.nnz >= opts.device_sparse_min_nnz)):
                # the round's U block stays the unreduced Upart, as in the
                # reference
                t_dev = time.perf_counter()
                S_new = _device_sparse_schur(f, mesh, Upart, pcols,
                                             levels_blk, S_rest, device)
                stats["device_s"] += time.perf_counter() - t_dev
            if S_new is None:
                # mutual-reduce the round's pivot block once, then the Schur
                # update of the remaining rows is a single product; with L,
                # every row's coefficients against the REDUCED block are its
                # values at the pivot columns (see the reference for the
                # lp_order argument)
                with phase("schur.reduce", stats):
                    Ustar, ok = mutual_reduce(f, Upart, pcols, levels_blk)
                if ok:
                    if opts.L:
                        cmap = np.full(S.shape[1], -1, np.int64)
                        cmap[pcols] = np.arange(npiv)
                        Uc = sp.coo_matrix(Upart)
                        pm = cmap[Uc.col] >= 0
                        piv_L = (row_origin[prows][Uc.row[pm]],
                                 r + cmap[Uc.col[pm]],
                                 f.normalize(Uc.data[pm].astype(np.int64)
                                             * piv_vals[Uc.row[pm]]))
                        reduced_L = True
                    with phase("schur.eliminate", stats):
                        if S_rest is not None:
                            S_new, C = eliminate_against_reduced(
                                f, Ustar, pcols, S_rest,
                                record_coeffs=opts.L, assume_canonical=True)
                        else:
                            S_new, C = eliminate_against_reduced(
                                f, Ustar, pcols, S, record_coeffs=False,
                                assume_canonical=True, rows=rest_rows)
                    Upart = Ustar
                else:  # fill blow-up guard: wave cascade
                    if S_rest is None:
                        S_rest = _gather_rest(S, rest_rows)
                    with phase("schur.eliminate", stats):
                        S_new, C = wave_eliminate(
                            f, Upart, pcols, levels_blk, S_rest,
                            record_coeffs=opts.L, assume_canonical=True)
            dens = S_new.nnz / max(1, S_new.shape[0] * S_new.shape[1])
            log(f"Schur complement: {S_new.shape[0]} * {S_new.shape[1]} "
                f"[{S_new.nnz} nz / density= {dens:.3f}], "
                f"{wtime() - t0:.1f}s")

        if opts.L:
            if reduced_L:
                L_parts.append(piv_L)
                L_rev_segments.append((r, npiv))
            else:
                L_parts.append((row_origin[prows], r + np.arange(npiv),
                                piv_vals))
            Cc = C.tocoo()
            L_parts.append((row_origin[rest_rows][Cc.row], r + Cc.col,
                            Cc.data))

        U_blocks.append(Upart)
        piv_cols_all.append(pcols.astype(np.int64))
        piv_origin_all.append(row_origin[prows])
        r += npiv
        S = S_new
        row_origin = row_origin[rest_rows]
        round_idx += 1
        stats["rounds"] += 1
        if checkpoint and writer:
            _save_checkpoint(checkpoint, f, opts, round_idx, r, S,
                             row_origin, m, U_blocks, piv_cols_all,
                             piv_origin_all, L_parts, L_rev_segments)

    # ---------------- finish ----------------
    dense_piv_start = None
    with phase("finish", stats):
        if S.shape[0] and S.nnz:
            with phase("finish.prep", stats):
                nrows = int((np.diff(S.indptr) > 0).sum())
                alive_mask = np.zeros(S.shape[1], bool)
                alive_mask[S.indices] = True
                alive_cols = np.flatnonzero(alive_mask)
                dens = S.nnz / max(1, nrows * alive_cols.size)
                aspect = S.shape[0] / max(1, S.shape[1])
                log(f"[echelonize] finishing; density = {dens:.3f}; "
                    f"aspect ratio = {aspect:.1f}")
                dense_elems = nrows * alive_cols.size
                na = alive_cols.size
                # on a card the finish's density gate drops to
                # device_sparsity_threshold, like the round loop's dense
                # switch
                thresh_fin = opts.sparsity_threshold
                if (opts.device_sparsity_threshold is not None
                        and opts.enable_dense and _on_accelerator(device)):
                    thresh_fin = min(thresh_fin,
                                     opts.device_sparsity_threshold)
                use_dense = (
                    opts.enable_dense
                    and (opts.dense_block_size + min(nrows, na)) * na
                    <= opts.dense_budget
                    and (force_dense
                         or dens >= thresh_fin
                         or not opts.enable_GPLU
                         or dense_elems <= 1_000_000
                         or (opts.enable_tall_and_skinny
                             and nrows > opts.tall_and_skinny_ratio * na)))
            if use_dense:
                # a resume-only run keeps saving (and finally deletes) the
                # sidecar it was resumed from
                ckpt_base = (checkpoint or resume) if writer else None
                blk = _dense_finish_blocked(
                    f, S, row_origin, alive_cols, r, opts, L_parts, device,
                    stats,
                    ckpt_path=(ckpt_base + ".dense" if ckpt_base else None),
                    dense_resume=dense_resume)
                if blk is not None:
                    dense_piv_start = r
            else:
                if not opts.enable_GPLU:
                    log("[echelonize] enable_GPLU=False but the dense finish "
                        "is unavailable (enable_dense/dense_budget); falling "
                        "back to GPLU anyway")
                blk = _gplu_finish(f, S, row_origin, r, opts, L_parts)
            if blk is not None:
                Upart, pcols, porig = blk
                U_blocks.append(Upart)
                piv_cols_all.append(pcols)
                piv_origin_all.append(porig)
                r += pcols.size
        if writer:
            # the finish is done: both sidecars are stale, whichever finish
            # ran
            for base in {checkpoint, resume} - {None}:
                if os.path.exists(base + ".dense"):
                    os.unlink(base + ".dense")
        if mesh is not None and (checkpoint or resume):
            # no rank returns (and maybe reads the files again) before rank
            # 0 has written and deleted them
            sparse_sharded.barrier(mesh)

    # ---------------- assemble ----------------
    with phase("assemble", stats):
        if U_blocks:
            U_sp = sp.vstack([sp.csr_matrix(b) for b in U_blocks],
                             format="csr")
            piv_cols = np.concatenate(piv_cols_all)
            p_vec = np.concatenate(piv_origin_all)
        else:
            U_sp = sp.csr_matrix((0, m), dtype=np.int64)
            piv_cols = np.zeros(0, np.int64)
            p_vec = np.zeros(0, np.int64)
        U = SparseGFp.from_scipy(U_sp, f.p, assume_canonical=True)
        qinv = np.full(m, -1, np.int64)
        qinv[piv_cols] = np.arange(r)

        L = None
        lp_order = None
        if opts.L:
            if L_parts:
                li = np.concatenate([np.asarray(t[0], np.int64)
                                     for t in L_parts])
                lj = np.concatenate([np.asarray(t[1], np.int64)
                                     for t in L_parts])
                lv = np.concatenate([np.asarray(t[2], np.int64)
                                     for t in L_parts])
            else:
                li = lj = lv = np.zeros(0, np.int64)
            L = SparseGFp.from_coo(f, n, r, li, lj, lv,
                                   sum_duplicates=False)
            if L_rev_segments:
                lp_order = np.arange(r, dtype=np.int64)
                for s0, ln in L_rev_segments:
                    lp_order[s0:s0 + ln] = lp_order[s0:s0 + ln][::-1]

        fact = LU(field=f, n=n, m=m, r=r, complete=False, U=U, qinv=qinv,
                  p=p_vec, piv_cols=piv_cols, L=L,
                  dense_piv_start=dense_piv_start, lp_order=lp_order,
                  _device=str(device))
        if opts.complete:
            from .solve import rref_of_U, rref_qinv_of  # cycle-free import

            # the canonical RREF's pivot columns are its rows' leading
            # columns (they can differ from the factorization's pivot
            # choices); against an RREF any row's elimination coefficients
            # are its values at the pivot columns, so L becomes a column
            # selection of A.
            R = rref_of_U(fact)
            qinv_c = rref_qinv_of(R)
            piv_cols_c = np.flatnonzero(qinv_c >= 0)[
                np.argsort(qinv_c[qinv_c >= 0], kind="stable")]
            L_c = None
            if opts.L:
                sel = np.full(m, -1, np.int64)
                sel[piv_cols_c] = np.arange(r)
                L_c = A.select_cols(sel, r)
            # provenance: RREF rows are combinations, keep the original
            # pivot rows sorted by their columns as representatives
            order = np.argsort(piv_cols, kind="stable")
            fact = dataclasses.replace(
                fact, U=R, complete=True, qinv=qinv_c, piv_cols=piv_cols_c,
                p=p_vec[order], _levels=np.zeros(r, np.int64), L=L_c,
                # L_c is not triangular
                dense_piv_start=0 if opts.L else None,
                lp_order=None)
    log(f"[echelonize] Done in {wtime() - t_start:.1f}s. Rank {r}, "
        f"{U.nnz} nz in basis")
    return fact


def _save_checkpoint(path, f, opts, round_idx, r, S, row_origin, m,
                     U_blocks, piv_cols_all, piv_origin_all, L_parts,
                     L_rev_segments=()):
    from . import checkpoint as ckpt

    t0 = wtime()
    U_cat = sp.vstack(U_blocks, format="csr") if U_blocks else \
        sp.csr_matrix((0, m), dtype=np.int64)
    ckpt.save_state(
        path, field_p=f.p, round_idx=round_idx, r=r, S=S,
        row_origin=row_origin, U_sp=U_cat,
        piv_cols=(np.concatenate(piv_cols_all) if piv_cols_all
                  else np.zeros(0, np.int64)),
        piv_origin=(np.concatenate(piv_origin_all)
                    if piv_origin_all else np.zeros(0, np.int64)),
        opts_dict={k: v for k, v in dataclasses.asdict(opts).items()
                   if isinstance(v, (int, float, bool))},
        L_parts=L_parts if opts.L else None,
        L_rev_segments=L_rev_segments if opts.L else ())
    log(f"[echelonize] checkpoint saved at round {round_idx} "
        f"({os.path.getsize(path)} bytes, {wtime() - t0:.3f}s)")


def _load_dense_sidecar(path):
    """The dense finish's block state saved at ``path``, or None when there
    is none or it does not load (a corrupt file, an unknown schema): then
    the finish starts at block 0."""
    if not os.path.exists(path):
        return None
    from . import checkpoint as ckpt

    try:
        state = ckpt.load_dense_state(path)
    except (OSError, ValueError, KeyError, EOFError,
            zipfile.BadZipFile) as e:
        log(f"[echelonize] dense-finish sidecar {path} does not load "
            f"({type(e).__name__}: {e}); ignored")
        return None
    log(f"[echelonize] dense-finish sidecar found (b0={state['b0']}, "
        f"{len(state['piv_cols_loc'])} pivots)")
    return state


def _gather_rest(S, rest_rows):
    from ._host.native import gather_rows_native

    out = gather_rows_native(S, rest_rows)
    return out if out is not None else sp.csr_matrix(S[rest_rows])


def _round_schur_estimate(f: Field, S, prows, pcols, need_rest=True):
    """Scale the round's pivot rows to unit pivots, derive the block's
    elimination levels, split off the non-pivot rows, and Monte-Carlo
    estimate the Schur complement density (the reference's function of the
    same name).  Returns (est, S_rest, rest_rows, (Upart, piv_vals,
    levels_blk)); S_rest is None unless need_rest."""
    from ._host.native import gather_rows_native, scale_rows_native

    npiv = prows.size
    Upart = gather_rows_native(S, prows)  # (npiv, m) in pivot order
    if Upart is None:
        Upart = sp.csr_matrix(S[prows])
    row_starts = Upart.indptr[:-1]
    is_left = Upart.indices[row_starts] == pcols
    piv_vals = np.empty(npiv, np.int64)
    piv_vals[is_left] = Upart.data[row_starts[is_left]]
    rest = np.flatnonzero(~is_left)
    if rest.size:
        piv_vals[rest] = np.asarray(
            Upart[rest, pcols[rest]]).ravel().astype(np.int64)
    if piv_vals.size and np.abs(piv_vals).max() <= 1:
        scales, norm = piv_vals, False
    else:
        scales, norm = f.inv(piv_vals), True
    if scale_rows_native(f, Upart, scales, norm) is None:
        row_of_entry = np.repeat(np.arange(npiv), np.diff(Upart.indptr))
        if norm:
            Upart.data = f.normalize(Upart.data * scales[row_of_entry])
        else:
            Upart.data = Upart.data * scales[row_of_entry]
    levels_blk = compute_levels(Upart, pcols)
    rest_mask = np.ones(S.shape[0], bool)
    rest_mask[prows] = False
    rest_rows = np.flatnonzero(rest_mask)
    if need_rest:
        S_rest = gather_rows_native(S, rest_rows)
        if S_rest is None:
            S_rest = S[rest_rows]
        est = schur_estimate_density(f, Upart, pcols, levels_blk, S_rest)
    else:
        S_rest = None
        est = schur_estimate_density(f, Upart, pcols, levels_blk, S,
                                     rest_rows=rest_rows)
    return est, S_rest, rest_rows, (Upart, piv_vals, levels_blk)


def _on_accelerator(device: torch.device) -> bool:
    return device.type == "cuda"


def _dense_feasible(S, opts, device: torch.device) -> bool:
    """Would the blocked dense finish fit the dense budget for S?  Same
    memory model as the finish dispatch: O((block + rank_tail) * na).  On
    the CPU the early switch is only taken at host-RREF-friendly sizes."""
    nrows = int((np.diff(S.indptr) > 0).sum())
    alive = np.zeros(S.shape[1], bool)
    alive[S.indices] = True
    na = int(alive.sum())
    budget = opts.dense_budget
    if device.type == "cpu":
        budget = min(budget, 2_000_000)
    return (opts.dense_block_size + min(nrows, na)) * na <= budget


def _device_sparse_schur(f: Field, mesh, Upart, pcols, levels, S_rest,
                         device: torch.device):
    """Round Schur update on ``device`` (the reference's function of the
    same name, with its branches): mutual-reduce the round's pivot block on
    the host, then the one-pass batched merge of ``ops/sparse_onepass``
    (with a mesh, each rank merges its rows of every class tile), whose
    padded work may reach 1 << 30 slots on a card and 1 << 27 on the CPU.
    Where the block does not reduce within its fill cap or the merge is
    over its budget, the sort-based waves eliminate against the unreduced
    block on the device (``ops/sparse_device``; with a mesh,
    ``sharded_sparse_eliminate``, each rank on its rows), and once more at
    4x the capacity if they overflow.  Returns None when that overflows
    too (every rank of a mesh alike): the caller's host path runs.  A
    kernel, launch or allocation that fails raises."""
    budget = (1 << 30) if _on_accelerator(device) else (1 << 27)
    Ustar, ok = mutual_reduce(f, Upart, pcols, levels)
    if ok:
        D = sparse_onepass.eliminate_onepass_device(
            f, Ustar, pcols, S_rest, work_budget=budget, device=device,
            mesh=mesh)
        if D is not None:
            return D
    log("[schur/device] one-pass unavailable; wave fallback")
    U = SparseGFp.from_scipy(Upart, f.p, assume_canonical=True)
    B = SparseGFp.from_scipy(S_rest, f.p)
    if mesh is not None:   # first cap_factor 8
        waves = functools.partial(sparse_sharded.sharded_sparse_eliminate,
                                  f, mesh)
        retry = 32
    else:                  # first cap_factor 4
        waves = functools.partial(sparse_device.eliminate_device, f,
                                  device=device)
        retry = 16
    out = waves(U, pcols, levels, B)
    if out is None:
        log("[schur/device] capacity overflow; retrying at 4x cap")
        out = waves(U, pcols, levels, B, cap_factor=retry)
    return None if out is None else out.to_scipy()


def schur_estimate_density(f: Field, U_sp, piv_cols, levels, S_rest,
                           samples: int = 100, rng=None, rest_rows=None):
    """Monte-Carlo Schur density estimate (the reference's function of the
    same name, with the same seeded draw): eliminate a random sample of
    the remaining rows and measure the resulting fill."""
    m = S_rest.shape[1]
    q = rest_rows.size if rest_rows is not None else S_rest.shape[0]
    if q == 0 or m == 0:
        return 0.0
    if q <= samples:
        rows_sel = rest_rows  # None = all rows
    else:
        rng = np.random.default_rng(0) if rng is None else rng
        rows = np.sort(rng.choice(q, size=samples, replace=False))
        rows_sel = rest_rows[rows] if rest_rows is not None else rows
    if rows_sel is None:
        sample = S_rest
    else:
        from ._host.native import gather_rows_native

        sample = gather_rows_native(sp.csr_matrix(S_rest), rows_sel)
        if sample is None:
            sample = S_rest[rows_sel]
    piv_cols = np.asarray(piv_cols, np.int64)
    r = U_sp.shape[0]
    from ._host.native import cascade_nnz_native

    out_nnz = cascade_nnz_native(f, sp.csr_matrix(sample), U_sp, piv_cols)
    if out_nnz is not None:
        return out_nnz / max(1, sample.shape[0] * m)
    if r > 4 * samples:
        pc_of_col = np.full(m, -1, np.int64)
        pc_of_col[piv_cols] = np.arange(r)
        need = np.zeros(r, bool)
        frontier = np.unique(sample.indices)
        while frontier.size:
            k = pc_of_col[frontier]
            k = k[k >= 0]
            k = k[~need[k]]
            if k.size == 0:
                break
            need[k] = True
            lo, hi = U_sp.indptr[k], U_sp.indptr[k + 1]
            lens = hi - lo
            total = int(lens.sum())
            if total == 0:
                break
            starts = np.repeat(np.cumsum(lens) - lens, lens)
            idx = np.repeat(lo, lens) + (np.arange(total) - starts)
            frontier = np.unique(U_sp.indices[idx])
        sel = np.flatnonzero(need)
        if sel.size < r:
            U_sp = U_sp[sel]
            piv_cols = piv_cols[sel]
            levels = levels[sel]
    out, _ = wave_eliminate(f, U_sp, piv_cols, levels, sample,
                            assume_canonical=True)
    return out.nnz / max(1, out.shape[0] * m)


# minimum seconds between dense-finish sidecar saves (tests set 0 so every
# block saves; a long finish pays at most one compressed write of the
# accumulated RREF per interval)
DENSE_CKPT_INTERVAL_S = 60.0


def _dense_finish_blocked(f: Field, S, row_origin, alive_cols, r0, opts,
                          L_parts, device: torch.device, stats: dict,
                          ckpt_path=None, dense_resume=None):
    """Blocked dense finish (the reference's function of the same name):
    the remaining rows are processed in dense row blocks against an
    accumulated dense RREF kept in full mutual reduced form, so eliminating
    a block is ONE exact modular matmul and the block's rank comes from the
    Jordan RREF.  Memory is O((block + rank_tail) * na).  Here alone is it
    decided where the finish runs and which loop runs it: a finish of
    ``host_cutoff_for(f)`` or more elements a block runs on ``device``,
    whose wall is added to stats["device_s"], in ``_fused_device_finish``
    where the reference takes its single-dispatch finish and in
    ``_streaming_loop`` otherwise; a smaller one runs ``_streaming_loop``
    on CPU tensors, on one torch thread (``_one_thread``).  In low-rank
    mode the streaming loop's randomized check certifies the tail
    dependent and skips it (not with L).  Its spans
    ``finish.prep``, ``finish.wait`` and ``finish.extract`` add to
    ``stats`` (``last_phase_stats``).

    With ``ckpt_path`` the block state is saved there; ``dense_resume`` (a
    loaded sidecar) continues from it when it matches this finish's inputs
    and is ignored otherwise."""
    with phase("finish.prep", stats):
        n_s = S.shape[0]
        stats["finish_rows"] += n_s
        na = alive_cols.size
        bs = min(n_s, max(128, opts.dense_block_size))

        # a sidecar of another matrix, round or tail is ignored, not resumed
        ckpt_meta = dict(field_p=f.p, r0=r0, s_nnz=int(S.nnz), n_s=n_s, na=na)
        if dense_resume is not None:
            if any(dense_resume.get(k) != v for k, v in ckpt_meta.items()):
                log("[echelonize/dense] sidecar does not match this finish; "
                    "starting from block 0")
                dense_resume = None
            else:
                log(f"[echelonize/dense] resuming at block offset "
                    f"{dense_resume['b0']}")

        # fused where the reference takes its single-dispatch finish, with
        # or without a checkpoint; a finish under the cutoff streams on the
        # CPU
        device_sized = bs * na >= dense_ops.host_cutoff_for(f)
        low_rank = _low_rank_possible(opts, n_s, na)
        bs_b, na_b = dense_ops._bucket(bs), dense_ops._bucket(na)
        fused = (device_sized and dense_resume is None and not low_rank
                 and -(-n_s // bs_b) * bs_b * na_b <= dense_ops.FUSED_BUDGET)
        stats["finish_streamed"] = int(device_sized and not fused)
        log(f"[echelonize/dense] processing {n_s} x {na} in blocks of {bs} "
            f"({'device' if device_sized else 'host'})")
    t_dev = time.perf_counter()
    copied = dense_ops.COPY_BYTES["card"]
    if fused:
        result = _fused_device_finish(f, S, alive_cols, na_b, bs_b, device,
                                      stats=stats)
    else:
        with contextlib.nullcontext() if device_sized else _one_thread():
            result = _streaming_loop(
                f, S, alive_cols, bs, opts,
                device if device_sized else torch.device("cpu"), low_rank,
                stats=stats, ckpt_path=ckpt_path, resume_state=dense_resume,
                ckpt_meta=ckpt_meta)
    stats["finish_copy_bytes"] = (stats.get("finish_copy_bytes", 0)
                                  + dense_ops.COPY_BYTES["card"] - copied)
    if device_sized:
        if device.type == "cuda":
            torch.cuda.synchronize(device)
        stats["device_s"] += time.perf_counter() - t_dev
    if result is None:
        return None
    with phase("finish.extract", stats):
        (indptr, indices, data), piv_cols_loc, piv_rows_glob = result
        r_d = piv_cols_loc.size
        log(f"[echelonize/dense] done, {r_d} pivots")
        # canonical as built on the device: mod_reduce would change nothing
        Usp = sp.csr_matrix((data, indices, indptr), shape=(r_d, S.shape[1]))
        pcols = alive_cols[piv_cols_loc]
        porig = row_origin[piv_rows_glob]
        if opts.L:
            # the dense U block is a full RREF: every S row reduces against
            # it with coefficients = its values at the pivot columns
            Csub = sp.csc_matrix(S)[:, pcols].tocoo()
            L_parts.append((row_origin[Csub.row], r0 + Csub.col, Csub.data))
        return Usp, pcols.astype(np.int64), porig


@contextlib.contextmanager
def _one_thread():
    """One torch thread for a finish under the cutoff, as the NumPy loop it
    replaced ran: its ops are too small to gain from a thread pool, and a
    pool in each of several processes sharing the cores made them hundreds
    of times slower."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        yield
    finally:
        torch.set_num_threads(n)


def _save_dense_ckpt(ckpt_path, ckpt_meta, b0, Uh, piv_cols_loc,
                     piv_rows_glob, dry_blocks):
    from . import checkpoint as ckpt

    t0 = wtime()
    ckpt.save_dense_state(ckpt_path, b0=b0, Uh=Uh,
                          piv_cols_loc=piv_cols_loc,
                          piv_rows_glob=piv_rows_glob,
                          dry_blocks=dry_blocks, **ckpt_meta)
    log(f"[echelonize/dense] checkpoint saved at block offset {b0} "
        f"({os.path.getsize(ckpt_path)} bytes, {wtime() - t0:.3f}s)")


def _low_rank_possible(opts, n_s, na):
    """Whether a finish of n_s rows over na columns is in low-rank mode
    (enable_tall_and_skinny, tall and skinny, no L), where the tail check
    may run: the fused finish is not taken there."""
    return (opts.enable_tall_and_skinny and not opts.L
            and n_s > opts.tall_and_skinny_ratio * na)


def _low_rank_mode(opts, rank_so_far, rows_processed, n_s):
    """The randomized tail shortcut engages only in genuinely low-rank
    situations (``low_rank_ratio``) and with low-rank mode
    (enable_tall_and_skinny) on."""
    if not opts.enable_tall_and_skinny or rows_processed >= n_s:
        return False
    return rank_so_far < opts.low_rank_ratio * max(1, rows_processed)


def _streaming_loop(f, S, alive_cols, bs, opts, device: torch.device,
                    low_rank_possible: bool, ckpt_path=None,
                    resume_state=None, ckpt_meta=None, stats=None):
    """The dense finish's streaming block loop over S (scipy CSR) on its
    columns ``alive_cols``, on ``device`` (a card, or the CPU for a finish
    under the cutoff): S's CSR uploaded once and its COO formed there
    (``dense_ops.upload_csr``), then one
    ``dense_ops.blocked_finish_step`` per row block of ``bs`` rows against
    the accumulated mutual RREF ``Ud`` (``dense_ops.stream_buffers``: the
    rank bound min(n_s, na) plus a block of rows), updated in place; on a
    card each step replays a CUDA graph.  Each block's rank is read back,
    so the loop stops once every column holds a pivot, and where
    ``low_rank_possible`` (the caller's ``_low_rank_possible``) a dry block
    triggers the randomized tail check on ``device``
    (``_tail_is_dependent``).  A sidecar save pulls
    ``Ud[:r_d]`` to the host; a resume puts it back.  ``stats`` takes the
    spans ``finish.wait`` (the loop), its child ``finish.tail`` (the tail
    checks) and ``finish.extract``, and the counts ``finish_blocks``,
    ``finish_rows_skipped``, ``rref_groups`` and ``rref_groups_run``.
    Returns None where no pivot was found, else ((indptr, indices, data)
    of U's block, ``dense_ops.extract_u_csr`` over S's columns, its pivot
    columns among ``alive_cols``' positions, its pivot rows of S)."""
    stats = {} if stats is None else stats
    n_s, na = S.shape[0], alive_cols.size
    for k in ("finish_blocks", "finish_rows_skipped", "rref_groups",
              "rref_groups_run"):
        stats.setdefault(k, 0)
    groups = dense_ops.rref_groups(na, dense_ops.DEFAULT_PANEL, device)
    with phase("finish.wait", stats):
        # the COO is formed once; each block and tail check takes a slice,
        # from each row's first entry, S.indptr
        *coo, alive = dense_ops.upload_csr(f, S, alive_cols, device)
        starts = S.indptr
        # bs rows beyond the rank bound min(n_s, na), for the card's steps
        Ud, pc_map = dense_ops.stream_buffers(min(n_s, na) + bs, na, device)
        r_d = 0
        piv_cols_loc: list[int] = []
        piv_rows_glob: list[int] = []
        dry_blocks = 0
        b0 = 0
        if resume_state is not None:
            piv_cols_loc = list(resume_state["piv_cols_loc"])
            piv_rows_glob = list(resume_state["piv_rows_glob"])
            dry_blocks = resume_state["dry_blocks"]
            b0 = resume_state["b0"]
            r_d = len(piv_cols_loc)
            if r_d:
                Ud[:r_d] = dense_ops.upload(resume_state["Uh"], np.int32,
                                            device)
                pc_map[:r_d] = dense_ops.upload(piv_cols_loc, np.int64,
                                                device)
        last_save = wtime()
        while b0 < n_s and r_d < na:
            b1 = min(n_s, b0 + bs)
            lo, hi = starts[b0], starts[b1]
            r_d, new_rank, prow_of, pcol_of, ran = (
                dense_ops.blocked_finish_step(
                    f, (b1 - b0, na), dense_ops.DEFAULT_PANEL,
                    coo[0][lo:hi] - b0, coo[1][lo:hi], coo[2][lo:hi], Ud,
                    pc_map, r_d))
            stats["finish_blocks"] += 1
            stats["rref_groups"] += groups
            stats["rref_groups_run"] += ran
            if new_rank:
                piv_cols_loc.extend(pcol_of[:new_rank].tolist())
                piv_rows_glob.extend((b0 + prow_of[:new_rank]).tolist())
                dry_blocks = 0
            else:
                dry_blocks += 1
            b0 = b1
            if (ckpt_path and b0 < n_s
                    and wtime() - last_save >= DENSE_CKPT_INTERVAL_S):
                _save_dense_ckpt(ckpt_path, ckpt_meta, b0,
                                 dense_ops.to_host(Ud[:r_d]).numpy()
                                 .astype(np.int64),
                                 piv_cols_loc, piv_rows_glob, dry_blocks)
                last_save = wtime()
            if (low_rank_possible and dry_blocks >= 1 and piv_cols_loc
                    and _low_rank_mode(opts, len(piv_cols_loc), b0, n_s)):
                with phase("finish.tail", stats):
                    dependent = _tail_is_dependent(
                        f, *(x[starts[b0]:] for x in coo), b0, n_s, na,
                        Ud[:r_d], pc_map[:r_d])
                if dependent:
                    log(f"[echelonize/dense] randomized check: remaining "
                        f"{n_s - b0} rows dependent; skipping")
                    stats["finish_rows_skipped"] += n_s - b0
                    break
    del coo
    if r_d == 0:
        return None
    with phase("finish.extract", stats):
        U = dense_ops.extract_u_csr(Ud, pc_map, r_d, na, alive)
        return (U, np.array(piv_cols_loc, np.int64),
                np.array(piv_rows_glob, np.int64))


def _fused_device_finish(f, S, alive_cols, na_b, bs, device, stats=None):
    """The reference's single-dispatch dense finish of S (scipy CSR) on its
    columns ``alive_cols``: S's CSR uploaded and its COO formed on
    ``device`` (``dense_ops.upload_csr``), the whole block loop in
    ``dense_ops.fused_blocked_finish`` (one CUDA graph on a card), then
    exactly two reads: every block's rank and pivots (with the count of
    panel groups run) in one copy, and U's canonical CSR
    (``dense_ops.extract_u_csr``).  Returns what ``_streaming_loop``
    returns.  ``stats`` takes the spans ``finish.wait`` (the uploads
    to the first read's return) and ``finish.extract`` (the rest), and the
    counts ``rref_groups`` and ``rref_groups_run``.  It writes no sidecar,
    as the reference's: a resume from a checkpoint it left finds none and
    runs it again."""
    stats = {} if stats is None else stats
    n_s, na = S.shape[0], alive_cols.size
    n_pad = -(-n_s // bs) * bs
    nb = n_pad // bs
    with phase("finish.wait", stats):
        rows, cols, vals, alive = dense_ops.upload_csr(f, S, alive_cols,
                                                       device)
        Ud, pc_map, _, ranks, prows, pcols, ran = (
            dense_ops.fused_blocked_finish(
                f, (n_pad, na_b), na, bs, dense_ops.DEFAULT_PANEL, rows,
                cols, vals))
        del rows, cols, vals
        meta = torch.cat([ranks, prows.reshape(-1), pcols.reshape(-1),
                          ran.view(1)])
        meta = dense_ops.to_host(meta).numpy()
    stats["rref_groups"] = stats.get("rref_groups", 0) + nb * (
        dense_ops.rref_groups(na, dense_ops.DEFAULT_PANEL, device))
    stats["rref_groups_run"] = (stats.get("rref_groups_run", 0)
                                + int(meta[-1]))
    with phase("finish.extract", stats):
        ranks = meta[:nb]
        prows = meta[nb:nb + nb * bs].reshape(nb, bs)
        pcols = meta[nb + nb * bs:-1].reshape(nb, bs)
        piv_cols_loc: list[int] = []
        piv_rows_glob: list[int] = []
        for b in np.flatnonzero(ranks):
            k = int(ranks[b])
            piv_cols_loc.extend(pcols[b, :k].tolist())
            piv_rows_glob.extend((b * bs + prows[b, :k]).tolist())
        r_d = len(piv_cols_loc)
        if r_d == 0:
            return None
        U = dense_ops.extract_u_csr(Ud, pc_map, r_d, na, alive)
        return (U, np.array(piv_cols_loc, np.int64),
                np.array(piv_rows_glob, np.int64))


def _tail_samples(p: int) -> int:
    """The tail check's samples at prime p: each misses a tail outside the
    row space with probability at most 1/p, so p**-samples <= 2**-64 (5 at
    p = 42013, 3 from p = 2**31 on)."""
    return math.ceil(64 / math.log2(p))


# tail entries a sample product gathers at a time (int64 temporaries of
# samples x TAIL_CHUNK)
TAIL_CHUNK = 1 << 22


def _combine_rows_on(f: Field, C: torch.Tensor, rows, cols, vals,
                     na: int) -> torch.Tensor:
    """C @ T mod p on C's device, balanced int32, for C (s, k) balanced
    int64 and T (k, na) as COO (rows int64, cols int32 or int64, vals
    balanced int32).  One gather, product and scatter-add per TAIL_CHUNK
    entries, exact in int64: each term is at most (p/2)**2 < 2**62 and is
    reduced mod p before it is summed, and the sums after each chunk."""
    X = torch.zeros((C.shape[0], na), dtype=torch.int64, device=C.device)
    for i in range(0, rows.numel(), TAIL_CHUNK):
        j = i + TAIL_CHUNK
        terms = C[:, rows[i:j]] * vals[i:j].to(torch.int64)
        X.index_add_(1, cols[i:j], torch.remainder(terms, f.p))
        X.remainder_(f.p)
    return modmul.normalize(f, X)


def _tail_is_dependent(f, rows, cols, vals, b0, n_s, na, U, piv_cols):
    """Whether the finish's unprocessed rows b0..n_s-1 lie in the row space
    of the dense mutual RREF ``U`` with pivot columns ``piv_cols``: rows,
    cols, vals the COO of those rows (int64, int32, balanced int32 tensors
    on U's device), U and piv_cols tensors.  Each of ``_tail_samples(p)``
    samples combines every tail row with its own uniform coefficient,
    drawn on U's device from a fixed seed, all in one sparse product
    (``_combine_rows_on``); the samples are reduced against U by one
    ``modmatmul``, and one value is read.  A dependent tail reduces to zero
    in every sample; a tail outside the row space makes a sample's
    coefficients a nonzero linear form, zero with probability at most 1/p,
    so a wrong True has probability at most 2**-64.  (The reference's
    samples combine 16 rows each: where few tail rows lie outside the row
    space, every sample can miss them.)"""
    dev = U.device
    p = f.p
    gen = torch.Generator(device=dev)
    gen.manual_seed(12345)
    C = torch.randint(0, p, (_tail_samples(p), n_s - b0), generator=gen,
                      device=dev, dtype=torch.int64)
    C = torch.where(C > p // 2, C - p, C)
    X = _combine_rows_on(f, C, rows - b0, cols, vals, na)
    res = modmul.sub(f, X, modmatmul(f, X[:, piv_cols], U))
    return not bool(dense_ops.to_host(res.any()))


def _gplu_finish(f: Field, S, row_origin, r0, opts, L_parts):
    """Sparse left-looking finish (the reference's GPLU role), batch-wise:
    structural-pivot rounds with no stopping threshold, handing degraded
    residues to the per-row left-looking elimination."""
    n_s, m = S.shape
    log(f"[echelonize/GPLU] processing matrix of dimension {n_s} x {m}")
    S = mod_reduce(S, f)
    U_blocks = []
    piv_cols_all = []
    piv_orig_all = []
    r_local = 0
    round_cap = 64 + 2 * (min(n_s, m) // 4096 + 1)
    rounds_done = 0
    lean_rounds = 0
    while S.shape[0] and S.nnz:
        rounds_done += 1
        Sw = SparseGFp.from_scipy(S, f.p, assume_canonical=True)
        prows, pcols, _ = find_structural_pivots(Sw, enable_greedy=True)
        if prows.size == 0:
            raise RuntimeError("FL found no pivot in a nonzero matrix")
        npiv = prows.size
        active = int((np.diff(S.indptr) > 0).sum())
        lean_rounds = lean_rounds + 1 if npiv * 16 < active else 0
        if lean_rounds >= 3 or rounds_done >= round_cap:
            log(f"[echelonize/GPLU] batched rounds degraded "
                f"({npiv} pivots / {active} active rows); switching to "
                "per-row left-looking elimination")
            seq = _gplu_sequential(f, S, row_origin, r0 + r_local, opts,
                                   L_parts)
            if seq is not None:
                Useq, pcols_seq, porig_seq = seq
                U_blocks.append(Useq)
                piv_cols_all.append(pcols_seq)
                piv_orig_all.append(porig_seq)
                r_local += pcols_seq.size
            S = sp.csr_matrix((0, m), dtype=S.dtype)
            break
        Upart = sp.csr_matrix(S[prows])
        piv_vals = np.asarray(
            Upart[np.arange(npiv), pcols]).ravel().astype(np.int64)
        scales = f.inv(piv_vals)
        row_of = np.repeat(np.arange(npiv), np.diff(Upart.indptr))
        Upart.data = f.normalize(Upart.data * scales[row_of])
        levels_blk = compute_levels(
            SparseGFp.from_scipy(Upart, f.p, assume_canonical=True), pcols)
        rest_mask = np.ones(S.shape[0], bool)
        rest_mask[prows] = False
        rest_rows = np.flatnonzero(rest_mask)
        ok = False
        if not opts.L:
            Ustar, ok = mutual_reduce(f, Upart, pcols, levels_blk)
        if ok:
            S_new, C = eliminate_against_reduced(
                f, Ustar, pcols, S[rest_rows], assume_canonical=True)
            Upart = Ustar
        else:
            S_new, C = wave_eliminate(f, Upart, pcols, levels_blk,
                                      S[rest_rows], record_coeffs=opts.L,
                                      assume_canonical=True)
        if opts.L:
            L_parts.append((row_origin[prows],
                            r0 + r_local + np.arange(npiv), piv_vals))
            Cc = C.tocoo()
            L_parts.append((row_origin[rest_rows][Cc.row],
                            r0 + r_local + Cc.col, Cc.data))
        U_blocks.append(Upart)
        piv_cols_all.append(pcols.astype(np.int64))
        piv_orig_all.append(row_origin[prows])
        r_local += npiv
        S = S_new
        row_origin = row_origin[rest_rows]
    if r_local == 0:
        log("[echelonize/GPLU] empty tail")
        return None
    log("[echelonize/GPLU] full rank reached" if r_local == n_s
        else f"[echelonize/GPLU] rank {r_local}")
    Usp = sp.vstack(U_blocks, format="csr")
    return (mod_reduce(Usp, f), np.concatenate(piv_cols_all),
            np.concatenate(piv_orig_all))


def _gplu_sequential(f: Field, S, row_origin, r0, opts, L_parts):
    """Per-row left-looking sparse elimination (the reference's GPLU):
    the C kernel (_host/csrc/gplu_mod.c), or the reference's Python heap
    loop where no C compiler is available.  Returns (U csr, pcols, porig)
    or None for a zero tail; L coefficients appended when opts.L."""
    import heapq

    from ._host.native import gplu_native

    n_s, m = S.shape
    out = gplu_native(f, S, bool(opts.L))
    if out is not None:
        indptr, indices, data, pcol, prow, ltrip = out
        r_new = pcol.size
        log(f"[echelonize/GPLU] sequential pass: {r_new} pivots from "
            f"{n_s} rows")
        if opts.L and ltrip is not None:
            li, lk, lv = ltrip
            L_parts.append((row_origin[li], r0 + lk, lv))
        if r_new == 0:
            return None
        Usp = sp.csr_matrix((data, indices, indptr), shape=(r_new, m))
        Usp.has_sorted_indices = True
        return Usp, pcol, row_origin[prow]
    indptr, indices, data = S.indptr, S.indices, S.data
    x = np.zeros(m, np.int64)
    piv_col = []                  # pivot column of pivot k
    u_cols: list = []             # unit-scaled pivot row supports
    u_vals: list = []
    porig = []
    qinv = np.full(m, -1, np.int64)
    for i in range(n_s):
        ji = indices[indptr[i]:indptr[i + 1]].astype(np.int64)
        if ji.size == 0:
            continue
        x[ji] = data[indptr[i]:indptr[i + 1]]
        touched = [ji]
        inq = np.zeros(max(1, len(piv_col)), bool)
        heap = [int(k) for k in qinv[ji] if k >= 0]
        inq[heap] = True
        heapq.heapify(heap)
        coefs_k, coefs_v = [], []
        while heap:
            k = heapq.heappop(heap)
            c = x[piv_col[k]]
            if c == 0:
                continue
            uc, uv = u_cols[k], u_vals[k]
            x[uc] = f.normalize(x[uc] - c * uv)
            touched.append(uc)
            if opts.L:
                coefs_k.append(k)
                coefs_v.append(c)
            hits = qinv[uc]
            for k2 in hits[(hits > k) & ~inq[np.clip(hits, 0, inq.size - 1)]]:
                inq[k2] = True           # only later pivots can appear
                heapq.heappush(heap, int(k2))
        cols_t = np.unique(np.concatenate(touched))
        vals_t = x[cols_t]
        nz = vals_t != 0
        cols_nz, vals_nz = cols_t[nz], vals_t[nz]
        if opts.L and coefs_k:
            L_parts.append((np.full(len(coefs_k), row_origin[i]),
                            r0 + np.array(coefs_k, np.int64),
                            np.array(coefs_v, np.int64)))
        if cols_nz.size:
            j = cols_nz[0]               # leftmost residual column
            v = vals_nz[np.searchsorted(cols_nz, j)]
            k_new = len(piv_col)
            qinv[j] = k_new
            piv_col.append(int(j))
            u_cols.append(cols_nz)
            u_vals.append(f.normalize(vals_nz * int(f.inv(
                np.array([v], np.int64))[0])))
            porig.append(row_origin[i])
            if opts.L:
                L_parts.append((np.array([row_origin[i]]),
                                np.array([r0 + k_new], np.int64),
                                np.array([v], np.int64)))
        x[cols_t] = 0
    r_new = len(piv_col)
    log(f"[echelonize/GPLU] sequential pass: {r_new} pivots from "
        f"{n_s} rows")
    if r_new == 0:
        return None
    lens = np.array([c.size for c in u_cols], np.int64)
    Usp = sp.csr_matrix(
        (np.concatenate(u_vals), np.concatenate(u_cols),
         np.concatenate([[0], np.cumsum(lens)])), shape=(r_new, m))
    return (Usp, np.array(piv_col, np.int64), np.array(porig, np.int64))
