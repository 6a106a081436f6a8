"""Ground truth: per-model true mean losses (counterpart of
``coda_tpu/oracle.py``). The engine reads labels straight from the
device-resident label vector, so only ``true_losses`` is needed here."""

from __future__ import annotations

from typing import Callable

import torch

from coda_tpu_torch.losses import accuracy_loss


def true_losses(preds: torch.Tensor, labels: torch.Tensor,
                loss_fn: Callable = accuracy_loss) -> torch.Tensor:
    """Mean loss of every model over all N points: (H, N, C) x (N,) -> (H,)."""
    return loss_fn(preds, labels[None, :]).mean(dim=1)
