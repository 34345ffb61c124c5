"""Process-group initialization and the global mesh: the port of
``spasm_tpu/parallel/multihost.py``.

torch runs one process a rank.  ``initialize`` brings up the default
process group (``torch.distributed.init_process_group``), ``global_mesh``
is a 1-D ``DeviceMesh`` over all its ranks, and ``host_local_rows`` is the
row range this process owns.  The rounds in ``sharded.py`` and the
elections in ``sparse_sharded.py`` only see the mesh, so the same code runs
on one card, on several cards of one host (NCCL), or on ranks that share a
card or run on CPUs (gloo).
"""

from __future__ import annotations

import os

import torch
import torch.distributed as dist


def _default_backend(device_type: str) -> str:
    return "nccl" if device_type == "cuda" else "gloo"


def require_card(device_type: str) -> None:
    """Raise where ``device_type`` is "cuda" and no card is visible, as
    ``echelonize(device="cuda")`` does: a mesh never falls back to the
    CPU on its own."""
    if device_type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("a CUDA mesh needs a visible card; pass "
                           "device_type='cpu' (backend 'gloo') for one on "
                           "the CPU")


def initialize(coordinator_address: "str | None" = None,
               num_processes: "int | None" = None,
               process_id: "int | None" = None,
               backend: "str | None" = None):
    """Bring up the default process group; a no-op for one process.

    ``coordinator_address`` ("host:port") with ``num_processes`` and
    ``process_id`` initializes over TCP.  Without them, a launcher's
    environment (``torchrun``: ``WORLD_SIZE`` > 1, ``RANK``,
    ``MASTER_ADDR``, ``MASTER_PORT``) is used.  ``backend`` defaults to
    NCCL, which needs a visible card (pass "gloo" for ranks on CPUs).
    Returns (world size, rank).
    """
    if dist.is_initialized():
        return dist.get_world_size(), dist.get_rank()
    env_world = int(os.environ.get("WORLD_SIZE", "1"))
    if not (coordinator_address or (num_processes or 1) > 1
            or env_world > 1):
        return 1, 0
    if backend is None:
        require_card("cuda")
        backend = _default_backend("cuda")
    if coordinator_address:
        dist.init_process_group(
            backend, init_method=f"tcp://{coordinator_address}",
            world_size=num_processes, rank=process_id)
    else:
        dist.init_process_group(backend)
    return dist.get_world_size(), dist.get_rank()


def global_mesh(axis: str = "rows", device_type: "str | None" = None):
    """1-D mesh named ``axis`` over every rank of the job.  In a single
    process with no process group, a one-process group (gloo on the CPU,
    NCCL on a card) is started first.  ``device_type`` defaults to "cuda",
    which raises without a card."""
    from .sharded import make_mesh

    if device_type is None:
        device_type = "cuda"
    require_card(device_type)
    if not dist.is_initialized():
        dist.init_process_group(_default_backend(device_type),
                                store=dist.HashStore(), world_size=1,
                                rank=0)
    return make_mesh(axis=axis, device_type=device_type)


def host_local_rows(n: int, mesh):
    """The row range [lo, hi) this process owns under even row sharding
    padded to the mesh size."""
    per = -(-n // mesh.size())
    lo = mesh.get_local_rank() * per
    return lo, min(lo + per, n)
