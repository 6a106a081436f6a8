"""IID random-sampling baseline (counterpart of
``coda_tpu/selectors/iid.py``).

Uniform random acquisition over the unlabeled points; the best model is
the argmin of the empirical mean loss on the labeled set, ties broken
uniformly at random. The risk is kept incrementally: ``update`` adds the
``(H,)`` loss vector of the one new point to a running total, so a round
costs O(H) besides the ``(N,)`` draw.

``update`` modifies the state's tensors IN PLACE (the unlabeled mask, the
loss total and the label count), as CODA's does; the reference returned
new arrays.

Under a mesh (``mesh=``, ``parallel/mesh.py``) ``preds`` is this rank's
``(H/b, N/a)`` block: the draw is the mesh form of ``categorical`` over
every rank's block of N, the labelled item's predictions come from the
rank that holds it, the risk is this rank's models' (bitwise equal across
its data group), and the best model is the mesh arg-min over the model
group, its tie-break drawn at the models' global positions.
"""

from __future__ import annotations

from typing import Callable, NamedTuple, Optional

import torch

from coda_tpu_torch import random as trandom
from coda_tpu_torch.losses import accuracy_loss
from coda_tpu_torch.ops.masked import masked_argmin_tiebreak, mesh_categorical
from coda_tpu_torch.parallel.collectives import (
    broadcast_from_owner,
    clear_items,
    count_over,
)
from coda_tpu_torch.parallel.mesh import MODEL_AXIS, Mesh
from coda_tpu_torch.selectors.protocol import Selector, SelectResult
from coda_tpu_torch.utils.platform import DeviceLike, resolve_device


class RiskState(NamedTuple):
    """Shared state of the risk-readout selectors (IID, Uncertainty)."""

    unlabeled: torch.Tensor   # (N,) bool
    loss_total: torch.Tensor  # (H,) summed loss of each model on labeled pts
    n_labeled: torch.Tensor   # 0-d int32


def loss_at(preds: torch.Tensor, loss_fn: Callable, idx: torch.Tensor,
            true_class: torch.Tensor, mesh: Optional[Mesh] = None
            ) -> torch.Tensor:
    """(H,) float32: every model's loss on point ``idx`` labeled
    ``true_class`` (0-d device tensors; no host synchronisation). Under a
    ``mesh`` the point's predictions come from the rank that holds it."""
    H = preds.shape[0]
    if mesh is not None:
        at = broadcast_from_owner(preds, idx.reshape(1), mesh, dim=1)[0]
    else:
        at = preds.index_select(1, idx.reshape(1).to(torch.int64))[:, 0]
    return loss_fn(at, true_class.reshape(1).expand(H)).to(torch.float32)


def make_risk_readout(preds: torch.Tensor, loss_fn: Callable,
                      mesh: Optional[Mesh] = None):
    """``(init_state, risk, best, update)`` over :class:`RiskState`, on
    ``preds``' device. Shared by IID and Uncertainty (they differ only in
    acquisition). ``mesh``: ``preds`` is this rank's block."""
    H, N, C = preds.shape
    dev = preds.device
    every_model = torch.ones(H, dtype=torch.bool, device=dev)

    def init_state() -> RiskState:
        return RiskState(
            unlabeled=torch.ones(N, dtype=torch.bool, device=dev),
            loss_total=torch.zeros(H, dtype=torch.float32, device=dev),
            n_labeled=torch.zeros((), dtype=torch.int32, device=dev),
        )

    def risk(state: RiskState) -> torch.Tensor:
        n = torch.clamp_min(state.n_labeled.to(torch.float32), 1.0)
        return state.loss_total / n

    def best(state: RiskState, key):
        idx, n_ties = masked_argmin_tiebreak(key, risk(state), every_model,
                                             mesh=mesh, axis=MODEL_AXIS)
        # risk ties (common early on with few labels) are broken randomly
        # and make the run stochastic
        return idx, n_ties > 1

    def update(state: RiskState, idx, true_class, prob=None) -> RiskState:
        del prob
        state.loss_total.add_(loss_at(preds, loss_fn, idx, true_class,
                                      mesh))
        clear_items(state.unlabeled, idx.reshape(1), mesh)
        state.n_labeled.add_(1)
        return state

    return init_state, risk, best, update


def make_iid(preds: torch.Tensor, loss_fn: Callable = accuracy_loss,
             name: str = "iid", device: DeviceLike = None,
             mesh: Optional[Mesh] = None) -> Selector:
    """The IID selector over a ``(H, N, C)`` prediction tensor, on
    ``device`` (default: the card); with a ``mesh``, over this rank's
    ``(H/b, N/a, C)`` block on the mesh's device (indices global)."""
    dev = mesh.device if mesh is not None else resolve_device(device)
    preds = torch.as_tensor(preds, dtype=torch.float32).to(dev)
    init_state, risk, best, update = make_risk_readout(preds, loss_fn, mesh)
    always = torch.ones((), dtype=torch.bool, device=dev)

    def init(key=None) -> RiskState:
        del key
        return init_state()

    def select(state: RiskState, key) -> SelectResult:
        inv = 1.0 / count_over(state.unlabeled, mesh).to(torch.float32)
        logits = torch.where(state.unlabeled, 0.0, float("-inf"))
        if mesh is not None:
            idx = mesh_categorical(key, logits, mesh)[..., 1].to(torch.int64)
        else:
            idx = trandom.categorical(key, logits)
        # uniform acquisition: each candidate's utility is its selection
        # probability (the flight recorder's top-k then reads all-equal
        # scores, which the triage treats as a maximal tie)
        return SelectResult(idx=idx, prob=inv, stochastic=always,
                            scores=torch.where(state.unlabeled, inv,
                                               float("-inf")))

    return Selector(name=name, init=init, select=select, update=update,
                    best=best, always_stochastic=True,
                    extras={"risk": risk})
