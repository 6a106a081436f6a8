"""The port's few collectives over a mesh's data axis.

Replicated state (the Dirichlets, pi-hat, the P(best) rows, the true
losses) must stay bitwise equal on every rank: if one rank's copy drifted
by an ulp, two ranks could pick different points and the next collective
would pair mismatched calls. So every sum over N is an ``all_gather`` of
the ranks' partial sums, added in rank order on every rank
(:func:`gather_sum`) — never a backend ``all_reduce``, whose order
depends on the topology. The vectors are small ((C,), (S, C), (H, C, C)).

Only ``all_gather`` in list form is used: gloo (CPU and CUDA tensors) and
NCCL both take it; ``reduce_scatter`` (gloo has none) and
``all_gather_into_tensor`` are avoided. A row that one rank owns reaches
the others as that same ``all_gather`` followed by a pick of the owner's
part on the device (:func:`broadcast_from_owner`): a ``broadcast`` needs
its source rank on the host, which would wait for the stream a round.

A mesh of one rank needs no group: each function is then the local
computation.
"""

from __future__ import annotations

from typing import Optional

import torch

from coda_tpu_torch.parallel.mesh import Mesh


def all_gather_stack(t: torch.Tensor, mesh: Mesh) -> torch.Tensor:
    """``(d, *t.shape)``: every rank's ``t`` in rank order (the same
    tensor on every rank). Booleans travel as bytes."""
    if mesh.size == 1:
        return t[None]
    import torch.distributed as dist

    is_bool = t.dtype == torch.bool
    src = (t.to(torch.uint8) if is_bool else t).contiguous()
    parts = [torch.empty_like(src) for _ in range(mesh.size)]
    dist.all_gather(parts, src, group=mesh.group)
    out = torch.stack(parts)
    return out.to(torch.bool) if is_bool else out


def gather_sum(t: torch.Tensor, mesh: Mesh) -> torch.Tensor:
    """The sum over ranks of ``t``, added in rank order (``((t_0 + t_1) +
    t_2) + ...``), bitwise the same on every rank."""
    if mesh.size == 1:
        return t
    parts = all_gather_stack(t, mesh)
    acc = parts[0]
    for p in parts[1:]:
        acc = acc + p
    return acc


def broadcast_from_owner(local: torch.Tensor, idx: torch.Tensor,
                         mesh: Mesh, dim: int = 0) -> torch.Tensor:
    """Item ``idx`` (global indices, any shape, the same on every rank)
    of a tensor sharded over N along ``dim``, read on the rank that holds
    it and sent to all: ``local.index_select(dim, idx)`` of the unsharded
    tensor, moved to the front (``(*idx.shape, *rest)``). No host
    synchronisation: every rank sends its (clamped) rows, and each takes
    the owner's part on the device."""
    idx = idx.to(torch.int64)
    n = local.shape[dim]
    loc = torch.clamp(idx - mesh.start(n), 0, n - 1)
    rows = torch.movedim(local.index_select(dim, loc.reshape(-1)), dim, 0)
    rest = rows.shape[1:]
    rows = rows.reshape(idx.shape + rest)
    if mesh.size == 1:
        return rows
    parts = all_gather_stack(rows, mesh)               # (d, *idx, *rest)
    owner = torch.div(idx, n, rounding_mode="floor")   # the holding rank
    pick = owner.reshape((1,) + idx.shape + (1,) * len(rest))
    return parts.gather(0, pick.expand((1,) + idx.shape + rest))[0]


def any_over(flag: torch.Tensor, mesh: Optional[Mesh]) -> torch.Tensor:
    """``flag`` (a bool of this rank's block, e.g. ``mask.any(-1)``) or'd
    over the mesh's ranks."""
    if mesh is None or mesh.size == 1:
        return flag
    return gather_sum(flag.to(torch.int32), mesh) > 0


def count_over(mask: torch.Tensor, mesh: Optional[Mesh]) -> torch.Tensor:
    """``mask.sum(-1)`` over every rank's block (exact: integers)."""
    n = mask.sum(-1)
    return n if mesh is None else gather_sum(n, mesh)


def clear_items(mask: torch.Tensor, idx: torch.Tensor,
                mesh: Optional[Mesh] = None) -> None:
    """``mask[idx] = False`` IN PLACE: an ``(N,)`` mask and indices of any
    shape, or an ``(S, N)`` mask and ``(S,)`` indices, one a row. Under a
    mesh the indices are global and ``mask`` this rank's block: only the
    rank that holds an item clears it (no host synchronisation)."""
    idx = idx.to(torch.int64)
    if mesh is None:
        if mask.dim() == 1:
            mask.index_fill_(0, idx.reshape(-1), False)
        else:
            mask[torch.arange(idx.shape[0], device=mask.device), idx] = False
        return
    n = mask.shape[-1]
    rel = idx - mesh.start(n)
    items = torch.arange(n, device=mask.device)
    if mask.dim() == 1:
        hit = (items[:, None] == rel.reshape(1, -1)).any(1)
    else:
        hit = items[None, :] == rel[:, None]
    mask &= ~hit
