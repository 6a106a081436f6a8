"""The port's few collectives over a mesh's axes.

Each collective runs along one axis (``axis``): ``data`` (the ranks of
this rank's data group, which share its H block and split N: the sums
over N, the arg-max over items, a labelled item's row), ``model`` (the
ranks of its model group, which share its N block and split H: the sums
over models, the arg-max over models, a model's loss) or None (every rank
of the mesh). The default is ``data``.

Replicated state must stay bitwise equal on the ranks that hold it: if
one rank's copy drifted by an ulp, two ranks could pick different points
and the next collective would pair mismatched calls. So every sum is an
``all_gather`` of the ranks' partial sums, added in rank order on every
rank (:func:`gather_sum`) — never a backend ``all_reduce``, whose order
depends on the topology. The tensors are small ((C,), (S, C), (H, C, C),
an (N/a,) score part, the (H/b, G) Beta tables of a class row).

Only ``all_gather`` in list form is used: gloo (CPU and CUDA tensors) and
NCCL both take it; ``reduce_scatter`` (gloo has none) and
``all_gather_into_tensor`` are avoided. A row that one rank owns reaches
the others as that same ``all_gather`` followed by a pick of the owner's
part on the device (:func:`broadcast_from_owner`): a ``broadcast`` needs
its source rank on the host, which would wait for the stream a round.

An axis of one rank needs no group: each function is then the local
computation.
"""

from __future__ import annotations

from typing import Optional

import torch

from coda_tpu_torch.parallel.mesh import DATA_AXIS, MODEL_AXIS, Mesh

# bytes this rank has sent into the all_gathers along each axis ("world":
# every rank of the mesh), for the measurement scripts; a rank receives
# (k - 1) times what it sends along an axis of k ranks
traffic = {DATA_AXIS: 0, MODEL_AXIS: 0, "world": 0}


def all_gather_stack(t: torch.Tensor, mesh: Mesh,
                     axis: Optional[str] = DATA_AXIS) -> torch.Tensor:
    """``(k, *t.shape)``: the ``t`` of every rank along ``axis`` in rank
    order (the same tensor on each of them). Booleans and int16 (which
    gloo does not take) travel as bytes."""
    k = mesh.axis_size(axis)
    if k == 1:
        return t[None]
    import torch.distributed as dist

    src = t.contiguous()
    if t.dtype == torch.bool:
        src = src.to(torch.uint8)
    elif t.dtype == torch.int16:
        src = src.view(torch.uint8)        # the last axis twice as long
    parts = [torch.empty_like(src) for _ in range(k)]
    dist.all_gather(parts, src, group=mesh.axis_group(axis))
    traffic[axis or "world"] += src.numel() * src.element_size()
    out = torch.stack(parts)
    if t.dtype == torch.bool:
        return out.to(torch.bool)
    return out.view(t.dtype) if t.dtype == torch.int16 else out


def all_gather_cat(t: torch.Tensor, mesh: Mesh, axis: Optional[str],
                   dim: int) -> torch.Tensor:
    """The blocks of ``t`` of every rank along ``axis`` joined along
    ``dim`` in rank order: the unsharded tensor of a block sharded there
    (e.g. the ``(..., H, G)`` table of ``(..., H/b, G)`` blocks)."""
    if mesh.axis_size(axis) == 1:
        return t
    parts = all_gather_stack(t, mesh, axis)
    return torch.cat(list(parts.unbind(0)), dim)


def gather_sum(t: torch.Tensor, mesh: Mesh,
               axis: Optional[str] = DATA_AXIS,
               chunk: Optional[int] = None) -> torch.Tensor:
    """The sum over the ranks along ``axis`` of ``t``, added in rank order
    (``((t_0 + t_1) + t_2) + ...``), bitwise the same on each of them.

    ``chunk``: gather and add at most ``chunk`` rows of ``t``'s first axis
    at a time, writing each sum back into ``t`` IN PLACE (the return value
    is ``t``). The sums are elementwise and in the same rank order, so the
    result is bitwise the unchunked one; a rank then holds one chunk of
    every rank's part at a time instead of every rank's whole ``t`` (the
    ``(H, C, C)`` confusion prior at C = 1000 is 2.0 GB a part)."""
    if mesh.axis_size(axis) == 1:
        return t
    if chunk is not None and chunk < t.shape[0]:
        for s in range(0, t.shape[0], chunk):
            t[s:s + chunk] = gather_sum(t[s:s + chunk], mesh, axis)
        return t
    parts = all_gather_stack(t, mesh, axis)
    acc = parts[0]
    for p in parts[1:]:
        acc = acc + p
    return acc


def local_positions(idx: torch.Tensor, n: int, mesh: Mesh,
                    axis: str = DATA_AXIS) -> torch.Tensor:
    """Global indices ``idx`` as positions in this rank's block of ``n``
    along ``axis``, clamped into it (an index another rank holds reads a
    row this rank has, which :func:`from_owner` then discards)."""
    return torch.clamp(idx.to(torch.int64) - n * mesh.axis_index(axis), 0,
                       n - 1)


def from_owner(rows: torch.Tensor, idx: torch.Tensor, n: int, mesh: Mesh,
               axis: str = DATA_AXIS) -> torch.Tensor:
    """The owner's ``rows``: ``rows`` (``(*idx.shape, *rest)``) is what
    this rank read at :func:`local_positions` of ``idx`` over its block of
    ``n``; each entry is replaced by the row the rank holding ``idx``
    read, on the device (one ``all_gather`` along ``axis``)."""
    if mesh.axis_size(axis) == 1:
        return rows
    idx = idx.to(torch.int64)
    rest = rows.shape[idx.dim():]
    parts = all_gather_stack(rows, mesh, axis)          # (k, *idx, *rest)
    owner = torch.div(idx, n, rounding_mode="floor")   # the holding rank
    pick = owner.reshape((1,) + idx.shape + (1,) * len(rest))
    return parts.gather(0, pick.expand((1,) + idx.shape + rest))[0]


def broadcast_from_owner(local: torch.Tensor, idx: torch.Tensor,
                         mesh: Mesh, dim: int = 0,
                         axis: str = DATA_AXIS) -> torch.Tensor:
    """Entry ``idx`` (global indices, any shape, the same on every rank)
    of a tensor sharded along ``dim`` over ``axis`` — items over ``data``,
    models over ``model`` — read on the rank that holds it and sent to
    the others: ``local.index_select(dim, idx)`` of the unsharded tensor,
    moved to the front (``(*idx.shape, *rest)``). No host
    synchronisation: every rank sends its (clamped) rows, and each takes
    the owner's part on the device."""
    n = local.shape[dim]
    loc = local_positions(idx, n, mesh, axis)
    rows = torch.movedim(local.index_select(dim, loc.reshape(-1)), dim, 0)
    rows = rows.reshape(idx.shape + rows.shape[1:])
    return from_owner(rows, idx, n, mesh, axis)


def any_over(flag: torch.Tensor, mesh: Optional[Mesh],
             axis: str = DATA_AXIS) -> torch.Tensor:
    """``flag`` (a bool of this rank's block, e.g. ``mask.any(-1)``) or'd
    over the ranks along ``axis``."""
    if mesh is None or mesh.axis_size(axis) == 1:
        return flag
    return gather_sum(flag.to(torch.int32), mesh, axis) > 0


def count_over(mask: torch.Tensor, mesh: Optional[Mesh],
               axis: str = DATA_AXIS) -> torch.Tensor:
    """``mask.sum(-1)`` over every block along ``axis`` (exact:
    integers)."""
    n = mask.sum(-1)
    return n if mesh is None else gather_sum(n, mesh, axis)


def min_over(t: torch.Tensor, mesh: Optional[Mesh],
             axis: str = DATA_AXIS) -> torch.Tensor:
    """The smallest of ``t`` over the ranks along ``axis`` (exact)."""
    if mesh is None or mesh.axis_size(axis) == 1:
        return t
    return all_gather_stack(t, mesh, axis).amin(0)


def max_over(t: torch.Tensor, mesh: Optional[Mesh],
             axis: str = DATA_AXIS) -> torch.Tensor:
    """The largest of ``t`` over the ranks along ``axis`` (exact)."""
    if mesh is None or mesh.axis_size(axis) == 1:
        return t
    return all_gather_stack(t, mesh, axis).amax(0)


def host_ints(values: list, mesh: Mesh) -> list:
    """Every rank's list of Python ints ``values`` (each rank passes its
    own, of any length), in rank order over the whole mesh: two
    ``all_gather``s, the lengths first. Every rank calls this; it also
    serves as a barrier."""
    n = all_gather_stack(torch.tensor([len(values)], device=mesh.device),
                         mesh, axis=None).cpu()
    mine = torch.full((max(1, int(n.max())),), -1, dtype=torch.int64)
    mine[:len(values)] = torch.tensor(values, dtype=torch.int64)
    rows = all_gather_stack(mine.to(mesh.device), mesh, axis=None).cpu()
    return [row[:int(k)].tolist() for row, k in zip(rows, n[:, 0])]


def raise_together(error: Optional[str], mesh: Optional[Mesh]) -> None:
    """``ValueError(error)`` on every rank when any rank has an error
    (each rank raises its own message, one without the lowest failing
    rank's number), so no rank is left waiting in a collective for one
    that gave up. Every rank calls this."""
    if mesh is not None and mesh.size > 1:
        failed = [r for r, (f,) in enumerate(host_ints([int(bool(error))],
                                                        mesh)) if f]
        if failed and not error:
            error = f"rank {failed[0]} refused (see its error)"
    if error:
        raise ValueError(error)


def clear_items(mask: torch.Tensor, idx: torch.Tensor,
                mesh: Optional[Mesh] = None) -> None:
    """``mask[idx] = False`` IN PLACE: an ``(N,)`` mask and indices of any
    shape, or an ``(S, N)`` mask and ``(S,)`` indices, one a row. Under a
    mesh the indices are global and ``mask`` this rank's block of N: only
    the ranks that hold an item clear it (no host synchronisation, no
    collective)."""
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
