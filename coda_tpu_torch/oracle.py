"""Ground truth: per-model true mean losses and the label server
(counterpart of ``coda_tpu/oracle.py``). The engine reads labels straight
from the device-resident label vector; :class:`Oracle` answers a caller
that drives a selector from the host (a hand-driven
``InteractiveSelector``)."""

from __future__ import annotations

from typing import Callable, Optional

import numpy as np
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


class Oracle:
    """Label server over a dataset with known ground truth (the
    reference's ``Oracle``)."""

    def __init__(self, dataset, loss_fn: Callable = accuracy_loss):
        if dataset.labels is None:
            raise ValueError("Oracle needs labels!")
        self.dataset = dataset
        self.labels = dataset.labels
        self.loss_fn = loss_fn

    def true_losses(self, preds: torch.Tensor) -> torch.Tensor:
        labels = torch.as_tensor(self.labels)
        return true_losses(preds, labels.to(preds.device), self.loss_fn)

    def __call__(self, idx) -> int:
        return int(self.labels[int(idx)])

    def answer_batch(self, idxs) -> list[int]:
        """The labels of ``idxs`` with ONE host read: one gather on the
        labels' device, then one copy of the q answers (equal to
        ``[self(i) for i in idxs]``)."""
        labels = torch.as_tensor(self.labels)
        idx = (idxs.reshape(-1) if isinstance(idxs, torch.Tensor)
               else torch.from_numpy(np.asarray(idxs, dtype=np.int64)))
        idx = idx.to(labels.device, torch.int64)
        return [int(v) for v in labels.index_select(0, idx).cpu().tolist()]
