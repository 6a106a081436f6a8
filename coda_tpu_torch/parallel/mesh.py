"""The mesh of ranks the ``(H, N, C)`` prediction tensor is sharded over
(counterpart of ``coda_tpu/parallel/mesh.py``).

The reference shards the tensor over a ``jax.sharding.Mesh`` and lets
GSPMD insert the collectives. PyTorch has no GSPMD, so here a mesh is SPMD
over ``torch.distributed``: one process a shard, each holding its own
``(H/b, N/a, C)`` block on a ``data=a,model=b`` mesh, with explicit
collectives (``parallel/collectives.py``) at the places where CODA and
the baselines reduce over N or over H.

Axes keep the reference's names and layout: rank ``r = i * model + j``
holds H block ``j`` and N block ``i`` (the reference's
``devices.reshape(data, model)``). ``data`` shards N: the scoring pass is
embarrassingly parallel over items, so each rank scores its block and the
arg-max crosses the ranks of its *data group* (the ranks with the same
``j``). ``model`` shards H (a pool of many candidate models, the HF
zero-shot pool of 1000-2000+): every sum over models — the exclusive
log-CDF product of P(best), its normalisation, the entropies, the pi-hat
contraction — adds the parts of the ranks of the *model group* (the ranks
with the same ``i``). State with an H axis (the Dirichlets, the P(best)
rows, the ``(C, N/a, H/b)`` cache, the true losses) is the rank's H
block, bitwise equal across its data group; state without one (pi-hat,
the scores, the pick) is bitwise equal across its model group. At
ImageNet scale (M=500 x N=50k x C=1000 fp32, about 100 GB) one card cannot
hold the tensor; on ``data=a,model=b`` each rank holds 1/(ab) of it and of
CODA's ``(C, N, H)`` cache.
"""

from __future__ import annotations

import os
from dataclasses import dataclass, field
from typing import NamedTuple, Optional

import torch

MODEL_AXIS = "model"  # shards H (the candidate-model pool)
DATA_AXIS = "data"    # shards N (the unlabeled data points)


@dataclass(frozen=True)
class Mesh:
    """A ``(data, model)`` mesh over the ranks of the process group.

    ``rank`` is this process's rank, ``i * model + j`` for N block ``i``
    and H block ``j``; ``device`` the device its shard lives on;
    ``groups`` the process group of each axis that spans more than one
    rank (None, the default group, when it spans the world; absent for an
    axis of one rank, which needs no collective)."""

    data: int
    model: int = 1
    rank: int = 0
    device: torch.device = field(default_factory=lambda: torch.device("cpu"))
    groups: dict = field(default_factory=dict)
    backend: str = "none"

    @property
    def shape(self) -> dict:
        return {DATA_AXIS: self.data, MODEL_AXIS: self.model}

    @property
    def size(self) -> int:
        return self.data * self.model

    @property
    def spec(self) -> str:
        if self.model == 1:
            return f"{DATA_AXIS}={self.data}"
        if self.data == 1:
            return f"{MODEL_AXIS}={self.model}"
        return f"{DATA_AXIS}={self.data},{MODEL_AXIS}={self.model}"

    @property
    def data_index(self) -> int:
        """This rank's N block ``i``."""
        return self.rank // self.model

    @property
    def model_index(self) -> int:
        """This rank's H block ``j``."""
        return self.rank % self.model

    def axis_size(self, axis: Optional[str]) -> int:
        """The ranks along ``axis`` (None: the whole mesh)."""
        return self.size if axis is None else self.shape[axis]

    def axis_index(self, axis: Optional[str]) -> int:
        """This rank's coordinate along ``axis`` (None: its rank)."""
        if axis is None:
            return self.rank
        return self.data_index if axis == DATA_AXIS else self.model_index

    def axis_group(self, axis: Optional[str]):
        """The process group of this rank's ranks along ``axis``."""
        return None if axis is None else self.groups.get(axis)

    def start(self, n_local: int) -> int:
        """The global index of this rank's first item, for a block of
        ``n_local`` items a rank."""
        return self.data_index * n_local

    def h_start(self, h_local: int) -> int:
        """The global index of this rank's first model, for a block of
        ``h_local`` models a rank."""
        return self.model_index * h_local


def axis_ranks(data: int, model: int, axis: str) -> list:
    """The rank lists of the groups along ``axis``, in the order every
    rank creates them: a data group holds the ranks with the same H block
    ``j`` (``[j, model + j, ...]``), a model group the ranks with the same
    N block ``i`` (``[i * model, ..., i * model + model - 1]``)."""
    if axis == DATA_AXIS:
        return [[i * model + j for i in range(data)] for j in range(model)]
    return [[i * model + j for j in range(model)] for i in range(data)]


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
    card unless ``"cpu"``). Every rank creates every group of both axes,
    members or not, in the same order (``torch.distributed.new_group``
    asks that of all ranks)."""
    if data < 1 or model < 1:
        raise ValueError(f"mesh axis sizes must be >= 1 (got data={data}, "
                         f"model={model})")
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
    groups = {}
    if size > 1:
        import torch.distributed as dist

        backend = str(dist.get_backend())
        for axis, k in ((DATA_AXIS, data), (MODEL_AXIS, model)):
            if k == size:
                groups[axis] = None          # the default group
            elif k > 1:
                for ranks in axis_ranks(data, model, axis):
                    g = dist.new_group(ranks)
                    if rank in ranks:
                        groups[axis] = g
    mesh = Mesh(data=data, model=model, rank=rank, device=dev,
                groups=groups, backend=backend)
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
    """The mesh of a spec (:func:`parse_spec`)."""
    sizes = parse_spec(spec)
    return make_mesh(data=sizes[DATA_AXIS], model=sizes[MODEL_AXIS],
                     device=device)


class Shard(NamedTuple):
    """This rank's block of a tensor sharded over N (and H) and the global
    index of its first item (and model)."""

    local: torch.Tensor
    start: int
    h_start: int = 0


def check_divisible(N: int, mesh: Mesh, H: Optional[int] = None) -> None:
    """N must split evenly over the data axis, and H (when given) over the
    model axis."""
    if N % mesh.data:
        raise ValueError(
            f"mesh {mesh.spec!r}: N={N} not divisible by the data axis "
            f"({mesh.data}); pad the task or run it unsharded")
    if H is not None and H % mesh.model:
        raise ValueError(
            f"mesh {mesh.spec!r}: H={H} not divisible by the model axis "
            f"({mesh.model}); drop models or run it unsharded")


def shard_preds(preds, mesh: Mesh, dim: int = 1) -> Shard:
    """This rank's contiguous block of ``preds`` along N (``dim``; 1 for
    the ``(H, N, C)`` tensor, 0 for an ``(N,)`` label vector) and, for a
    3-d tensor, along H (dim 0), on the mesh's device — the counterpart
    of ``preds_sharding`` (``P(model, data, None)``). Accepts a tensor or
    a numpy array (sliced on the host, H first, so only the block is read
    from a memory map and copied to the device)."""
    N = preds.shape[dim]
    h_sharded = len(preds.shape) == 3 and dim == 1
    H = preds.shape[0] if h_sharded else None
    check_divisible(N, mesh, H)
    n = N // mesh.data
    start = mesh.start(n)
    index = [slice(None)] * len(preds.shape)
    index[dim] = slice(start, start + n)
    h0 = 0
    if h_sharded:
        h = H // mesh.model
        h0 = mesh.h_start(h)
        index[0] = slice(h0, h0 + h)
    block = preds[tuple(index)]
    if not isinstance(block, torch.Tensor):
        import numpy as np

        # a copy: the array may be a read-only memory map of the file
        block = torch.from_numpy(np.array(block))
    return Shard(block.to(mesh.device).contiguous(), start, h0)


def replicated(mesh: Optional[Mesh]) -> Optional[torch.device]:
    """Where a replicated value lives: the mesh's device (every rank keeps
    its own bitwise-equal copy)."""
    return None if mesh is None else mesh.device
