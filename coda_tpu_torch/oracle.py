"""Ground truth: per-model true mean losses (counterpart of
``coda_tpu/oracle.py``). The engine reads labels straight from the
device-resident label vector, so only ``true_losses`` is needed here."""

from __future__ import annotations

from typing import Callable, Optional

import torch

from coda_tpu_torch.losses import accuracy_loss
from coda_tpu_torch.parallel.collectives import (
    broadcast_from_owner,
    gather_sum,
    min_over,
)
from coda_tpu_torch.parallel.mesh import DATA_AXIS, MODEL_AXIS, Mesh


def true_losses(preds: torch.Tensor, labels: torch.Tensor,
                loss_fn: Callable = accuracy_loss,
                mesh: Optional[Mesh] = None) -> torch.Tensor:
    """Mean loss of every model over all N points: (H, N, C) x (N,) -> (H,).
    With a ``mesh``, ``preds`` and ``labels`` are this rank's block of N
    (and ``preds`` its models): the data group's loss sums added in rank
    order (:func:`gather_sum`) over the global N — this rank's models'
    ``(H/b,)`` losses, the same on every rank of its data group, within
    an ulp or so of the unsharded mean."""
    losses = loss_fn(preds, labels[None, :])
    if mesh is None:
        return losses.mean(dim=1)
    # a device-tensor divisor: one IEEE division on every device (CUDA
    # multiplies by the reciprocal of a host scalar)
    total = gather_sum(losses.sum(dim=1), mesh, DATA_AXIS)
    return total / torch.full((), losses.shape[1] * mesh.data,
                              dtype=total.dtype, device=total.device)


def best_loss(losses: torch.Tensor,
              mesh: Optional[Mesh] = None) -> torch.Tensor:
    """The smallest true loss of every model (a 0-d tensor): under a
    ``mesh`` ``losses`` is this rank's block of models and the minimum
    crosses the model group (exact)."""
    return min_over(losses.min(), mesh, MODEL_AXIS)


def regret_fn(losses: torch.Tensor, mesh: Optional[Mesh] = None):
    """``best -> loss of model best - the best loss``, ``best`` global
    model indices of any shape; under a ``mesh`` each model's loss is read
    from the rank of the model group that holds it."""
    lowest = best_loss(losses, mesh)
    if mesh is None or mesh.model == 1:
        return lambda best: losses.take(best) - lowest
    return lambda best: broadcast_from_owner(
        losses, best, mesh, axis=MODEL_AXIS) - lowest
