"""Ranks for the port's multi-process tests: gloo process groups on the
CPU, spawned through torch.multiprocessing, with a FileStore rendezvous in
a directory of the caller's (so concurrent test workers never share one).

This module imports no jax: the spawned ranks import it by name, and they
run only spasm_tpu_torch.  Each job takes (mesh, inputs) and returns plain
numpy results, which the parent reads back from one pickle a rank."""

from __future__ import annotations

import os
import pickle
import time
import traceback

import numpy as np
import torch
import torch.distributed as dist
import torch.multiprocessing as mp


class Ranks:
    """``world`` gloo ranks running JOBS[job](mesh, inputs), started at
    once; ``results()`` waits for them (killing them all past ``timeout``
    seconds) and returns their results in rank order, or raises with the
    ranks' tracebacks when one failed."""

    def __init__(self, world: int, job: str, inputs, workdir: str,
                 timeout: float = 240.0):
        ctx = mp.get_context("spawn")
        tag = f"{job}_{world}_{time.monotonic_ns()}"
        store = os.path.join(workdir, f"store_{tag}")
        self.job, self.world = job, world
        self.outs = [os.path.join(workdir, f"out_{tag}_{r}.pkl")
                     for r in range(world)]
        self.procs = [ctx.Process(target=_rank_main,
                                  args=(r, world, store, job, inputs,
                                        self.outs[r]))
                      for r in range(world)]
        for p in self.procs:
            p.start()
        self.deadline = time.monotonic() + timeout

    def close(self) -> list:
        """Kill the ranks still alive; returns them."""
        hung = [p for p in self.procs if p.is_alive()]
        for p in hung:
            p.kill()
            p.join()
        return hung

    def results(self) -> list:
        try:
            for p in self.procs:
                p.join(max(0.0, self.deadline - time.monotonic()))
        finally:
            hung = self.close()
        errors = []
        for r, p in enumerate(self.procs):
            if os.path.exists(self.outs[r] + ".err"):
                with open(self.outs[r] + ".err") as fh:
                    errors.append(f"rank {r}:\n{fh.read()}")
            elif p.exitcode != 0:
                errors.append(f"rank {r}: exit code {p.exitcode}")
        if hung or errors:
            raise RuntimeError(f"{self.job} on {self.world} ranks: "
                               f"{len(hung)} timed out\n" + "\n".join(errors))
        results = []
        for out in self.outs:
            with open(out, "rb") as fh:
                results.append(pickle.load(fh))
        return results


def _rank_main(rank, world, store, job, inputs, out):
    try:
        torch.set_num_threads(1)
        dist.init_process_group("gloo", init_method=f"file://{store}",
                                rank=rank, world_size=world)
        from spasm_tpu_torch.parallel.sharded import make_mesh

        mesh = make_mesh(world, device_type="cpu")
        result = JOBS[job](mesh, inputs)
        dist.destroy_process_group()
        with open(out, "wb") as fh:
            pickle.dump(result, fh)
    except BaseException:
        with open(out + ".err", "w") as fh:
            fh.write(traceback.format_exc())
        raise


def _sparse(d):
    from spasm_tpu_torch import interop

    return interop.sparse_from_arrays(d["p"], d["shape"], d["indptr"],
                                      d["indices"], d["data"])


def _csr(M):
    return (np.asarray(M.indptr), np.asarray(M.indices), np.asarray(M.data))


def parallel_suite(mesh, inputs):
    """Every distributed function of the port on this rank: the two
    elections, one elimination round (this rank's X' block), distributed
    ranks, the one-pass update with its classes on the merge, echelonize
    with the mesh (with a checkpoint and its resume), and host_local_rows."""
    import scipy.sparse as sp

    from spasm_tpu_torch import checkpoint, echelonize, field, interop
    from spasm_tpu_torch.ops import sparse_onepass
    from spasm_tpu_torch.parallel import multihost, sharded, sparse_sharded

    f = field(inputs["p"])
    out = {}
    A = _sparse(inputs["elect"])
    out["fl"] = sparse_sharded.sharded_fl_election(f, mesh, A)
    cs, ru = inputs["col_selected"].copy(), inputs["row_used"].copy()
    out["fl_cols"] = sparse_sharded.sharded_fl_col_election(f, mesh, A, cs,
                                                            ru)
    out["fl_cols_masks"] = (cs, ru)
    X = inputs["round_X"]
    nloc = X.shape[0] // mesh.size()
    lo = mesh.get_local_rank() * nloc
    Xl = torch.from_numpy(X[lo:lo + nloc].astype(np.int32))
    X2, U, cols, valid, npiv = sharded.elimination_round(
        f, mesh, Xl, panel=inputs["round_panel"])
    out["round"] = tuple(t.numpy() for t in (X2, U, cols, valid, npiv))
    out["ranks"] = [sharded.distributed_rank(f, mesh, M, panel=pn)
                    for M, pn in inputs["rank_cases"]]
    Ustar, pcols, B = inputs["onepass"]
    stats = {}
    D = sparse_onepass.eliminate_onepass_device(
        f, sp.csr_matrix(Ustar), pcols, sp.csr_matrix(B), min_class_rows=0,
        device="cpu", mesh=mesh, _stats=stats)
    out["onepass"] = _csr(D)
    out["onepass_stats"] = stats
    E = _sparse(inputs["echelon"])
    out["echelon"] = interop.lu_arrays(echelonize(E, mesh=mesh,
                                                  device="cpu"))
    # rank 0 alone writes the checkpoint; every rank resumes from it
    saves = []
    real = checkpoint.save_state

    def counting(path, **kw):
        saves.append(kw["round_idx"])
        return real(path, **kw)

    checkpoint.save_state = counting
    try:
        path = inputs["ckpt_path"]
        first = echelonize(E, mesh=mesh, device="cpu", checkpoint=path,
                           max_round=1)
        out["resumed"] = interop.lu_arrays(echelonize(
            E, mesh=mesh, device="cpu", resume=path))
    finally:
        checkpoint.save_state = real
    out["ckpt_saves"] = saves
    out["ckpt_first_r"] = first.r
    out["local_rows"] = multihost.host_local_rows(103, mesh)
    return out


def waves_suite(mesh, inputs):
    """sharded_sparse_eliminate on this rank: a round at the default
    capacity; a block whose rows all lie in rank 0's shard, at a capacity
    that overflows on rank 0 alone (every rank must return None) and at
    4x that capacity."""
    from spasm_tpu_torch import field
    from spasm_tpu_torch.parallel import sparse_sharded

    f = field(inputs["p"])
    world = mesh.size()
    out = {}
    for name, factors in (("round", (8,)), ("skewed", (4, 16))):
        U, pcols, levels, B = inputs[name]
        U, B = _sparse(U), _sparse(B)
        for cf in factors:
            # the per-shard capacity of cap_factor x (nnz / world) is the
            # single device's of cf x nnz
            D = sparse_sharded.sharded_sparse_eliminate(
                f, mesh, U, pcols, levels, B,
                cap_factor=cf * (world if name == "skewed" else 1))
            out[f"{name}_{cf}"] = None if D is None else _csr(D)
    return out


JOBS = {"parallel_suite": parallel_suite, "waves_suite": waves_suite}
