"""VMA: Variance Minimization for Active Model Selection (Matsuura & Hara
2023; counterpart of ``coda_tpu/selectors/vma.py``).

A point's acquisition weight is the summed pairwise loss disagreement
``Σ_{h'>h} |loss_h(x) - loss_h'(x)|`` under the ensemble surrogate, sampled
proportionally; the LURE risk readout is ActiveTesting's. The scores come
from the sorted-values identity

    Σ_{i<j} |a_i - a_j| = Σ_k (2k - H + 1) · a_(k)   (a_(k) ascending)

— one sort over H per point, never an ``(H, H, N)`` tensor (2e11 elements
at H = 1000, N = 50,000). They are static, computed once in the factory.
Under a mesh's model axis the sort needs every model's value at an item:
the model group gathers its ``(H/b, N/a)`` expected losses once, at
build time, and each rank scores its items over all H.
"""

from __future__ import annotations

from typing import Callable, Optional

import torch

from coda_tpu_torch.losses import accuracy_loss
from coda_tpu_torch.selectors.activetesting import (
    make_activetesting,
    surrogate_expected_losses,
)
from coda_tpu_torch.parallel.collectives import all_gather_cat
from coda_tpu_torch.parallel.mesh import MODEL_AXIS, Mesh
from coda_tpu_torch.selectors.protocol import Selector
from coda_tpu_torch.utils.platform import DeviceLike, resolve_device


def pairwise_absdiff_sum(values: torch.Tensor, dim: int = 0) -> torch.Tensor:
    """``Σ_{i<j} |v_i - v_j|`` along ``dim`` by the sorted identity."""
    v = torch.movedim(values, dim, -1)
    H = v.shape[-1]
    v_sorted = torch.sort(v, dim=-1).values
    coeff = 2.0 * torch.arange(H, dtype=v.dtype, device=v.device) - (H - 1.0)
    return (coeff * v_sorted).sum(-1)


def vma_scores(preds: torch.Tensor,
               mesh: Optional[Mesh] = None) -> torch.Tensor:
    """(N,) pairwise-disagreement acquisition scores (``mesh``: ``preds``
    this rank's block; the expected losses of every model of its items
    gathered over the model group)."""
    losses = surrogate_expected_losses(preds, mesh)
    if mesh is not None and mesh.model > 1:
        losses = all_gather_cat(losses, mesh, MODEL_AXIS, 0)
    return pairwise_absdiff_sum(losses, dim=0)


def make_vma(preds: torch.Tensor, loss_fn: Callable = accuracy_loss,
             budget: int = 128, name: str = "vma",
             device: DeviceLike = None,
             mesh: Optional[Mesh] = None) -> Selector:
    """The VMA selector over a ``(H, N, C)`` prediction tensor, on
    ``device`` (default: the card); ``mesh``: see ``make_iid`` (the
    scores are per item, so a block's are its own)."""
    dev = mesh.device if mesh is not None else resolve_device(device)
    preds = torch.as_tensor(preds, dtype=torch.float32).to(dev)
    return make_activetesting(preds, loss_fn=loss_fn, budget=budget,
                              name=name, acquisition_scores=vma_scores(preds, mesh),
                              device=dev, mesh=mesh)
