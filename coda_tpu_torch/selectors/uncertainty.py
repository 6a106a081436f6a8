"""Committee-uncertainty baseline (counterpart of
``coda_tpu/selectors/uncertainty.py``).

Selects the unlabeled point with the highest entropy of the ensemble-mean
prediction (natural log, 1e-8 epsilon); the best-model readout is IID's.
The acquisition does not adapt, so the scores are computed once in the
factory. ``update`` works in place (see ``selectors/iid.py``).
"""

from __future__ import annotations

from typing import Callable

import torch

from coda_tpu_torch.losses import accuracy_loss
from coda_tpu_torch.ops.masked import masked_argmax_tiebreak
from coda_tpu_torch.selectors.iid import RiskState, make_risk_readout
from coda_tpu_torch.selectors.protocol import Selector, SelectResult
from coda_tpu_torch.utils.platform import DeviceLike, resolve_device


def uncertainty_scores(preds: torch.Tensor,
                       epsilon: float = 1e-8) -> torch.Tensor:
    """(N,) entropy in nats of the mean-over-models prediction."""
    mean_p = preds.mean(0)
    return -(mean_p * torch.log(mean_p + epsilon)).sum(-1)


def make_uncertainty(preds: torch.Tensor, loss_fn: Callable = accuracy_loss,
                     name: str = "uncertainty",
                     device: DeviceLike = None) -> Selector:
    """The Uncertainty selector over a ``(H, N, C)`` prediction tensor, on
    ``device`` (default: the card)."""
    dev = resolve_device(device)
    preds = torch.as_tensor(preds, dtype=torch.float32).to(dev)
    scores = uncertainty_scores(preds)
    init_state, risk, best, update = make_risk_readout(preds, loss_fn)

    def init(key=None) -> RiskState:
        del key
        return init_state()

    def select(state: RiskState, key) -> SelectResult:
        idx, n_ties = masked_argmax_tiebreak(key, scores, state.unlabeled)
        return SelectResult(idx=idx, prob=scores.take(idx),
                            stochastic=n_ties > 1,
                            scores=torch.where(state.unlabeled, scores,
                                               float("-inf")))

    return Selector(name=name, init=init, select=select, update=update,
                    best=best, always_stochastic=False,
                    extras={"risk": risk})
