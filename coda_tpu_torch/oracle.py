"""Ground truth: per-model true mean losses (counterpart of
``coda_tpu/oracle.py``). The engine reads labels straight from the
device-resident label vector, so only ``true_losses`` is needed here."""

from __future__ import annotations

from typing import Callable, Optional

import torch

from coda_tpu_torch.losses import accuracy_loss
from coda_tpu_torch.parallel.collectives import gather_sum
from coda_tpu_torch.parallel.mesh import Mesh


def true_losses(preds: torch.Tensor, labels: torch.Tensor,
                loss_fn: Callable = accuracy_loss,
                mesh: Optional[Mesh] = None) -> torch.Tensor:
    """Mean loss of every model over all N points: (H, N, C) x (N,) -> (H,).
    With a ``mesh``, ``preds`` and ``labels`` are this rank's block of N:
    the blocks' loss sums added in rank order (:func:`gather_sum`) over
    the global N — the same (H,) vector on every rank, within an ulp or so
    of the unsharded mean."""
    losses = loss_fn(preds, labels[None, :])
    if mesh is None:
        return losses.mean(dim=1)
    return gather_sum(losses.sum(dim=1), mesh) / (losses.shape[1]
                                                  * mesh.data)
