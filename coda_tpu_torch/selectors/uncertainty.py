"""Committee-uncertainty baseline (counterpart of
``coda_tpu/selectors/uncertainty.py``).

Selects the unlabeled point with the highest entropy of the ensemble-mean
prediction (natural log, 1e-8 epsilon); the best-model readout is IID's.
The acquisition does not adapt, so the scores are computed once in the
factory. ``update`` works in place (see ``selectors/iid.py``). Under a
mesh the scores are this rank's block's (the ensemble mean a rank-order
sum over the model group) and the pick the mesh arg-max.
"""

from __future__ import annotations

from typing import Callable, Optional

import torch

from coda_tpu_torch.losses import accuracy_loss
from coda_tpu_torch.ops.confusion import ensemble_preds
from coda_tpu_torch.ops.masked import (
    masked_argmax_tiebreak,
    mesh_masked_argmax_tiebreak,
)
from coda_tpu_torch.parallel.mesh import Mesh
from coda_tpu_torch.selectors.iid import RiskState, make_risk_readout
from coda_tpu_torch.selectors.protocol import Selector, SelectResult
from coda_tpu_torch.utils.platform import DeviceLike, resolve_device


def uncertainty_scores(preds: torch.Tensor, epsilon: float = 1e-8,
                       mesh: Optional[Mesh] = None) -> torch.Tensor:
    """(N,) entropy in nats of the mean-over-models prediction (``mesh``:
    ``preds`` this rank's models, :func:`~coda_tpu_torch.ops.confusion.
    ensemble_preds`)."""
    mean_p = ensemble_preds(preds, mesh)
    return -(mean_p * torch.log(mean_p + epsilon)).sum(-1)


def make_uncertainty(preds: torch.Tensor, loss_fn: Callable = accuracy_loss,
                     name: str = "uncertainty",
                     device: DeviceLike = None,
                     mesh: Optional[Mesh] = None) -> Selector:
    """The Uncertainty selector over a ``(H, N, C)`` prediction tensor, on
    ``device`` (default: the card); ``mesh``: see ``make_iid``."""
    dev = mesh.device if mesh is not None else resolve_device(device)
    preds = torch.as_tensor(preds, dtype=torch.float32).to(dev)
    scores = uncertainty_scores(preds, mesh=mesh)
    init_state, risk, best, update = make_risk_readout(preds, loss_fn, mesh)

    def init(key=None) -> RiskState:
        del key
        return init_state()

    def select(state: RiskState, key) -> SelectResult:
        if mesh is not None:
            idx, n_ties, prob = mesh_masked_argmax_tiebreak(
                key, scores, state.unlabeled, mesh)
        else:
            idx, n_ties = masked_argmax_tiebreak(key, scores,
                                                 state.unlabeled)
            prob = scores.take(idx)
        return SelectResult(idx=idx, prob=prob,
                            stochastic=n_ties > 1,
                            scores=torch.where(state.unlabeled, scores,
                                               float("-inf")))

    return Selector(name=name, init=init, select=select, update=update,
                    best=best, always_stochastic=False,
                    extras={"risk": risk})
