"""The mesh of ranks the ``(H, N, C)`` prediction tensor is sharded over
(counterpart of ``coda_tpu/parallel/mesh.py``).

The reference shards the tensor over a ``jax.sharding.Mesh`` and lets
GSPMD insert the collectives. PyTorch has no GSPMD, so here a mesh is SPMD
over ``torch.distributed``: one process a shard, each holding its own
``(H, N/d, C)`` block, with explicit collectives
(``parallel/collectives.py``) at the few places where CODA and the
baselines reduce over N — the pi-hat marginal, the confusion prior, the
true losses, and the arg-max of the acquisition. Everything that does not
depend on N (the Dirichlet posteriors, pi-hat, the P(best) rows, the
losses) is replicated, bitwise equal on every rank.

Axes keep the reference's names: ``data`` shards N (the scoring pass is
embarrassingly parallel over items, so each rank scores its block and
only the arg-max crosses ranks), ``model`` would shard H. At ImageNet
scale (M=500 x N=50k x C=1000 fp32, about 100 GB) one card cannot hold the
tensor; on ``data=d`` each rank holds 1/d of it and of CODA's
``(C, N, H)`` cache.

This slice runs the data axis; a ``model`` size above 1 raises
``NotImplementedError``: sharding H splits the per-item sums over models
inside the scoring kernels, and the reference itself refuses its kernels
there.
"""

from __future__ import annotations

import os
from dataclasses import dataclass, field
from typing import NamedTuple, Optional

import torch

MODEL_AXIS = "model"  # shards H (the candidate-model pool)
DATA_AXIS = "data"    # shards N (the unlabeled data points)

MESH_NEXT = ("the next mesh slice of the port (slice 5 ported the data "
             "axis alone)")


@dataclass(frozen=True)
class Mesh:
    """A ``(data, model)`` mesh over the ranks of the process group.

    ``rank`` is this process's coordinate on the data axis, ``device`` the
    device its shard lives on and ``group`` its process group (None: the
    default group, or no group at all for a one-rank mesh)."""

    data: int
    model: int = 1
    rank: int = 0
    device: torch.device = field(default_factory=lambda: torch.device("cpu"))
    group: object = None
    backend: str = "none"

    @property
    def shape(self) -> dict:
        return {DATA_AXIS: self.data, MODEL_AXIS: self.model}

    @property
    def size(self) -> int:
        return self.data * self.model

    @property
    def spec(self) -> str:
        return f"{DATA_AXIS}={self.data}"

    def start(self, n_local: int) -> int:
        """The global index of this rank's first item, for a block of
        ``n_local`` items a rank."""
        return self.rank * n_local


def world() -> tuple[int, int]:
    """``(rank, world size)`` of the default process group; ``(0, 1)``
    without one."""
    import torch.distributed as dist

    if dist.is_available() and dist.is_initialized():
        return dist.get_rank(), dist.get_world_size()
    return 0, 1


def shard_device(device=None) -> torch.device:
    """This rank's device: ``cuda:(LOCAL_RANK % device_count)`` for a CUDA
    request (ranks share the cards round robin), else the CPU."""
    from coda_tpu_torch.utils.platform import resolve_device

    dev = resolve_device(device)
    if dev.type != "cuda":
        return dev
    local = int(os.environ.get("LOCAL_RANK", "0"))
    return torch.device("cuda", local % torch.cuda.device_count())


def make_mesh(data: int = 1, model: int = 1, device=None) -> Mesh:
    """A ``(data, model)`` mesh over the ranks of the default process
    group, which must hold exactly ``data * model`` of them (one a shard;
    a one-rank mesh needs no group). ``device``: the device request (the
    card unless ``"cpu"``)."""
    if model != 1:
        raise NotImplementedError(
            f"mesh model={model}: sharding H comes with {MESH_NEXT}; the "
            "scoring kernels sum over every model of an item, so a model "
            "axis needs collectives inside every selector's H reductions")
    if data < 1:
        raise ValueError(f"mesh axis sizes must be >= 1 (got data={data})")
    rank, size = world()
    n = data * model
    if n > size:
        raise ValueError(f"mesh {data}x{model} needs {n} ranks, have {size}")
    if n < size:
        raise ValueError(
            f"mesh {data}x{model} spans {n} of the {size} ranks; start one "
            f"rank a shard (python -m torch.distributed.run "
            f"--nproc-per-node {n} ...)")
    dev = shard_device(device)
    backend = "none"
    if size > 1:
        import torch.distributed as dist

        backend = str(dist.get_backend())
    mesh = Mesh(data=data, model=model, rank=rank, device=dev,
                backend=backend)
    if rank == 0 and size > 1:
        where = (f"{torch.cuda.device_count()} card"
                 + ("s" if torch.cuda.device_count() > 1 else "")
                 if dev.type == "cuda" else "the CPU")
        print(f"mesh {mesh.spec}: {backend}, {size} ranks on {where}",
              flush=True)
    return mesh


def parse_spec(spec: str) -> dict:
    """``'data=4'`` / ``'data=4,model=2'`` -> the axis sizes (the
    reference's syntax and errors)."""
    sizes = {DATA_AXIS: 1, MODEL_AXIS: 1}
    for part in spec.split(","):
        k, v = part.split("=")
        k = k.strip()
        if k not in sizes:
            raise ValueError(f"unknown mesh axis {k!r} (use data/model)")
        sizes[k] = int(v)
    return sizes


def mesh_from_spec(spec: str, device=None) -> Mesh:
    """The mesh of a spec (:func:`parse_spec`; ``model=`` above 1
    raises)."""
    sizes = parse_spec(spec)
    return make_mesh(data=sizes[DATA_AXIS], model=sizes[MODEL_AXIS],
                     device=device)


class Shard(NamedTuple):
    """This rank's block of a tensor sharded over N and the global index
    of its first item."""

    local: torch.Tensor
    start: int


def check_divisible(N: int, mesh: Mesh) -> None:
    """N must split evenly over the data axis."""
    if N % mesh.data:
        raise ValueError(
            f"mesh {mesh.spec!r}: N={N} not divisible by the data axis "
            f"({mesh.data}); pad the task or run it unsharded")


def shard_preds(preds, mesh: Mesh, dim: int = 1) -> Shard:
    """This rank's contiguous block of ``preds`` along N (``dim``; 1 for
    the ``(H, N, C)`` tensor, 0 for an ``(N,)`` label vector), on the
    mesh's device — the counterpart of ``preds_sharding``. Accepts a
    tensor or a numpy array (sliced on the host, so only the block is
    copied to the device)."""
    N = preds.shape[dim]
    check_divisible(N, mesh)
    n = N // mesh.data
    start = mesh.start(n)
    index = [slice(None)] * len(preds.shape)
    index[dim] = slice(start, start + n)
    block = preds[tuple(index)]
    if not isinstance(block, torch.Tensor):
        import numpy as np

        # a copy: the array may be a read-only memory map of the file
        block = torch.from_numpy(np.array(block))
    return Shard(block.to(mesh.device).contiguous(), start)


def replicated(mesh: Optional[Mesh]) -> Optional[torch.device]:
    """Where a replicated value lives: the mesh's device (every rank keeps
    its own bitwise-equal copy)."""
    return None if mesh is None else mesh.device
