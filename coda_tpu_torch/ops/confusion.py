"""Consensus pseudo-labels and Dirichlet confusion-matrix priors
(counterpart of ``coda_tpu/ops/confusion.py``).

Every contraction runs in full fp32: the reference's automatic demotion of
huge operands to DEFAULT precision is a workaround for a TPU compile limit
and does not apply on the card (TF32 is off, see
``utils/platform.pin_fp32_matmul``).
"""

from __future__ import annotations

import torch
import torch.nn.functional as F


def ensemble_preds(preds: torch.Tensor) -> torch.Tensor:
    """Mean prediction over models: ``(H, N, C) -> (N, C)``."""
    return preds.mean(0)


def create_confusion_matrices(true_labels: torch.Tensor,
                              model_predictions: torch.Tensor,
                              mode: str = "hard") -> torch.Tensor:
    """Row-normalised ``(H, C, C)`` confusion matrices vs (pseudo-)labels.

    ``mode='hard'`` uses one-hot argmax predictions; ``'soft'`` the scores.
    Rows are normalised with a 1e-6 floor.
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
