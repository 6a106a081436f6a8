"""Joining the ranks of a mesh (counterpart of
``coda_tpu/parallel/distributed.py``).

The reference joins ``jax.distributed`` and lets XLA choose the
collectives. Here each shard is a process of one ``torch.distributed``
group, started by ``torchrun``::

    python -m torch.distributed.run --nproc-per-node 2 \\
        -m coda_tpu_torch.cli --synthetic 1000,50000,10 --method coda \\
        --mesh data=2

:func:`initialize` reads torchrun's environment (``RANK``, ``WORLD_SIZE``,
``LOCAL_RANK``, ``LOCAL_WORLD_SIZE``, ``MASTER_ADDR``/``MASTER_PORT``
through ``env://``) or explicit arguments — the counterparts of
``JAX_PROCESS_ID``, ``JAX_NUM_PROCESSES`` and ``JAX_COORDINATOR``. One
process is a no-op, as in the reference.

The backend follows the layout, never a failure: NCCL when every local
rank has a card of its own, gloo when ranks share a card or run on the
CPU (NCCL refuses two ranks on one device). gloo is not a fallback from
NCCL: no ``try`` turns one into the other. Every group gets a timeout, so
a rank that dies fails the others' next collective instead of hanging
them.
"""

from __future__ import annotations

import datetime
import os
from typing import Optional

DEFAULT_TIMEOUT_S = 300.0


def choose_backend(device_type: str, local_world: int,
                   device_count: int) -> str:
    """``nccl`` when every local rank has a card of its own, else
    ``gloo`` (ranks sharing a card, or on the CPU)."""
    if device_type == "cuda" and local_world <= device_count:
        return "nccl"
    return "gloo"


def initialize(init_method: Optional[str] = None,
               world_size: Optional[int] = None,
               rank: Optional[int] = None, device: str = "cuda",
               timeout_s: float = DEFAULT_TIMEOUT_S) -> bool:
    """Join the process group; returns True if there is more than one
    rank. Arguments default to torchrun's environment (``WORLD_SIZE``,
    ``RANK``; ``init_method`` ``env://``, which reads ``MASTER_ADDR`` and
    ``MASTER_PORT``). A one-process configuration is a no-op returning
    False; an existing group is kept. ``device`` (``cuda`` or ``cpu``)
    picks the backend (:func:`choose_backend`); on a card each rank binds
    ``cuda:(LOCAL_RANK % device_count)``."""
    import torch
    import torch.distributed as dist

    if world_size is None:
        world_size = int(os.environ.get("WORLD_SIZE", "1"))
    if rank is None:
        rank = int(os.environ.get("RANK", "0"))
    if world_size <= 1 and init_method is None:
        return False
    if dist.is_initialized():
        return dist.get_world_size() > 1
    device_type = "cuda" if str(device).startswith("cuda") else "cpu"
    count = torch.cuda.device_count() if device_type == "cuda" else 0
    local_world = int(os.environ.get("LOCAL_WORLD_SIZE", str(world_size)))
    backend = choose_backend(device_type, local_world, count)
    if device_type == "cuda":
        torch.cuda.set_device(int(os.environ.get("LOCAL_RANK", "0"))
                              % count)
    dist.init_process_group(
        backend=backend, init_method=init_method or "env://",
        world_size=world_size, rank=rank,
        timeout=datetime.timedelta(seconds=timeout_s))
    return world_size > 1


def is_primary() -> bool:
    """True on the process that owns printing, tracking and checkpoint
    writes: rank 0, or the only process."""
    import torch.distributed as dist

    return not (dist.is_available() and dist.is_initialized()) \
        or dist.get_rank() == 0


def shutdown() -> None:
    """Leave the process group (a no-op without one)."""
    import torch.distributed as dist

    if dist.is_available() and dist.is_initialized():
        dist.destroy_process_group()
