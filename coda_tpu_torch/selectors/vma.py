"""VMA: Variance Minimization for Active Model Selection (Matsuura & Hara
2023; counterpart of ``coda_tpu/selectors/vma.py``).

A point's acquisition weight is the summed pairwise loss disagreement
``Σ_{h'>h} |loss_h(x) - loss_h'(x)|`` under the ensemble surrogate, sampled
proportionally; the LURE risk readout is ActiveTesting's. The scores come
from the sorted-values identity

    Σ_{i<j} |a_i - a_j| = Σ_k (2k - H + 1) · a_(k)   (a_(k) ascending)

— one sort over H per point, never an ``(H, H, N)`` tensor (2e11 elements
at H = 1000, N = 50,000). They are static, computed once in the factory.
"""

from __future__ import annotations

from typing import Callable

import torch

from coda_tpu_torch.losses import accuracy_loss
from coda_tpu_torch.selectors.activetesting import (
    make_activetesting,
    surrogate_expected_losses,
)
from coda_tpu_torch.selectors.protocol import Selector
from coda_tpu_torch.utils.platform import DeviceLike, resolve_device


def pairwise_absdiff_sum(values: torch.Tensor, dim: int = 0) -> torch.Tensor:
    """``Σ_{i<j} |v_i - v_j|`` along ``dim`` by the sorted identity."""
    v = torch.movedim(values, dim, -1)
    H = v.shape[-1]
    v_sorted = torch.sort(v, dim=-1).values
    coeff = 2.0 * torch.arange(H, dtype=v.dtype, device=v.device) - (H - 1.0)
    return (coeff * v_sorted).sum(-1)


def vma_scores(preds: torch.Tensor) -> torch.Tensor:
    """(N,) pairwise-disagreement acquisition scores."""
    return pairwise_absdiff_sum(surrogate_expected_losses(preds), dim=0)


def make_vma(preds: torch.Tensor, loss_fn: Callable = accuracy_loss,
             budget: int = 128, name: str = "vma",
             device: DeviceLike = None) -> Selector:
    """The VMA selector over a ``(H, N, C)`` prediction tensor, on
    ``device`` (default: the card)."""
    dev = resolve_device(device)
    preds = torch.as_tensor(preds, dtype=torch.float32).to(dev)
    return make_activetesting(preds, loss_fn=loss_fn, budget=budget,
                              name=name, acquisition_scores=vma_scores(preds),
                              device=dev)
