"""Consensus pseudo-labels and Dirichlet confusion-matrix priors
(counterpart of ``coda_tpu/ops/confusion.py``).

Every contraction runs in full fp32: the reference's automatic demotion of
huge operands to DEFAULT precision is a workaround for a TPU compile limit
and does not apply on the card (TF32 is off, see
``utils/platform.pin_fp32_matmul``).
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F

from coda_tpu_torch.parallel.collectives import gather_sum
from coda_tpu_torch.parallel.mesh import DATA_AXIS, MODEL_AXIS, Mesh


# bytes of one rank's part the confusion prior's data-group sum gathers at
# a time
_PRIOR_CHUNK_BYTES = 64 << 20


def _prior_chunk(C: int) -> int:
    """Models of the ``(H, C, C)`` prior a chunk of its data-group sum
    holds (:data:`_PRIOR_CHUNK_BYTES` a rank's part)."""
    return max(1, _PRIOR_CHUNK_BYTES // (4 * C * C))


def ensemble_preds(preds: torch.Tensor,
                   mesh: Optional[Mesh] = None) -> torch.Tensor:
    """Mean prediction over models: ``(H, N, C) -> (N, C)``. Under a
    ``mesh`` with a model axis ``preds`` holds this rank's models: the
    model group's sums added in rank order, over the global H."""
    if mesh is None or mesh.model == 1:
        return preds.mean(0)
    # a device-tensor divisor: one IEEE division on every device (CUDA
    # multiplies by the reciprocal of a host scalar)
    total = gather_sum(preds.sum(0), mesh, MODEL_AXIS)
    return total / torch.full((), preds.shape[0] * mesh.model,
                              dtype=total.dtype, device=total.device)


def create_confusion_matrices(true_labels: torch.Tensor,
                              model_predictions: torch.Tensor,
                              mode: str = "hard",
                              mesh: Optional[Mesh] = None) -> torch.Tensor:
    """Row-normalised ``(H, C, C)`` confusion matrices vs (pseudo-)labels.

    ``mode='hard'`` uses one-hot argmax predictions; ``'soft'`` the scores.
    Rows are normalised with a 1e-6 floor. With a ``mesh`` the operands
    are this rank's block (its models of ``model_predictions``, its items
    of both) and the counts over N are the data group's blocks added in
    rank order (:func:`gather_sum`, a chunk of models at a time): this
    rank's models' matrices, the same on every rank of its data group.
    """
    H, N, C = model_predictions.shape
    true_one_hot = F.one_hot(true_labels.to(torch.int64), C).to(torch.float32)
    if mode == "hard":
        p = F.one_hot(model_predictions.argmax(-1), C).to(torch.float32)
    elif mode == "soft":
        p = model_predictions
    else:
        raise ValueError(mode)
    conf = torch.einsum("nc,hnj->hcj", true_one_hot, p)
    if mesh is not None:
        # summed in place a chunk of models at a time (bitwise the whole
        # sum, whose parts come out contiguous too): a rank never holds
        # every rank's whole (H, C, C) part
        conf = gather_sum(conf.contiguous(), mesh, DATA_AXIS,
                          chunk=_prior_chunk(C))
    return conf / torch.clamp_min(conf.sum(-1, keepdim=True), 1e-6)


def initialize_dirichlets(soft_confusion: torch.Tensor,
                          prior_strength: float,
                          disable_diag_prior: bool = False) -> torch.Tensor:
    """Diag-favouring base (diag 1.0, off-diag 1/(C-1); or uniform 2/C for
    the ablation) plus ``prior_strength`` x the soft confusion."""
    H, C, _ = soft_confusion.shape
    kw = dict(dtype=soft_confusion.dtype, device=soft_confusion.device)
    if disable_diag_prior:
        base = torch.full((C, C), 2.0 / C, **kw)
    else:
        base = torch.full((C, C), 1.0 / (C - 1), **kw)
        base.fill_diagonal_(1.0)
    return base[None] + prior_strength * soft_confusion
