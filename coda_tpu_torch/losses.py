"""Loss registry (counterpart of ``coda_tpu/losses.py``).

``'acc'`` is 1 - accuracy; ``'ce'`` is ``-log p[label]`` on post-softmax
scores with a floor clamp. Every loss is elementwise over the leading
axes: ``loss_fn(preds (..., C), labels (...)) -> (...)`` float32.
"""

from __future__ import annotations

import torch


def accuracy_loss(preds: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
    """1 - accuracy, unreduced. ``labels`` may be int classes or one-hot."""
    pred_cls = preds.argmax(-1)
    if labels.ndim == preds.ndim:  # one-hot / soft labels
        label_cls = labels.argmax(-1)
    else:
        label_cls = labels
    return 1.0 - (pred_cls == label_cls).to(torch.float32)


def cross_entropy_loss(preds: torch.Tensor, labels: torch.Tensor,
                       eps: float = 1e-12) -> torch.Tensor:
    """-log p[label] on post-softmax scores, unreduced."""
    if labels.ndim == preds.ndim:
        p = (preds * labels).sum(-1)
    else:
        idx = labels.to(torch.int64).expand(preds.shape[:-1])
        p = torch.gather(preds, -1, idx[..., None])[..., 0]
    return -torch.log(torch.clamp_min(p, eps))


LOSS_FNS = {
    "acc": accuracy_loss,
    "ce": cross_entropy_loss,
}
