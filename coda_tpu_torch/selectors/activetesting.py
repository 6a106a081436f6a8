"""ActiveTesting (Kossen et al. 2021) with LURE risk estimation
(counterpart of ``coda_tpu/selectors/activetesting.py``).

  * The surrogate is the mean ensemble of all candidates; a point's
    acquisition weight is the summed expected loss ``Σ_h (1 - π_ens(ŷ_h))``,
    sampled proportionally over the unlabeled points.
  * The best model is the argmin of the LURE importance-weighted risk
    (Farquhar et al. 2021): ``v_m = 1 + (N-M)/(N-m) * (1/((N-m+1) q_m) -
    1)``.

The acquisition weights are a static ``(N,)`` vector (the surrogate never
changes), so a round renormalises over the unlabeled mask and draws one
categorical sample. The per-round loss vectors and selection
probabilities live in fixed ``(H, T)`` / ``(T,)`` ring buffers (T = the
label budget), so the LURE readout is a masked reduction. ``update``
writes the mask, the buffers and the label count IN PLACE.
"""

from __future__ import annotations

from typing import Callable, NamedTuple, Optional

import torch

from coda_tpu_torch import random as trandom
from coda_tpu_torch.losses import accuracy_loss
from coda_tpu_torch.ops.masked import masked_argmin_tiebreak, masked_categorical
from coda_tpu_torch.selectors.iid import loss_at
from coda_tpu_torch.selectors.protocol import Selector, SelectResult
from coda_tpu_torch.utils.platform import DeviceLike, resolve_device


class LUREState(NamedTuple):
    unlabeled: torch.Tensor   # (N,) bool
    losses: torch.Tensor      # (H, T) per-step losses of each model at picks
    qs: torch.Tensor          # (T,) selection probabilities
    n_labeled: torch.Tensor   # 0-d int32 (M)


def surrogate_expected_losses(preds: torch.Tensor) -> torch.Tensor:
    """(H, N): the surrogate's probability that model h is wrong on
    point n."""
    pi_y = preds.mean(0)                              # (N, C) ensemble
    pred_cls = preds.argmax(2)                        # (H, N)
    y_star = pi_y.gather(1, pred_cls.T).T             # (H, N)
    return 1.0 - y_star


def lure_risks_and_vars(losses: torch.Tensor, qs: torch.Tensor,
                        M: torch.Tensor, N: int
                        ) -> tuple[torch.Tensor, torch.Tensor]:
    """LURE risk estimates and estimator variances, both (H,), over the
    first M buffer slots: the mean of the v-weighted losses, and the
    unbiased sample variance of the weighted losses over M. At M <= 1 the
    variance is 0, as the JAX package returns (the unbiased estimate is
    0/0 there)."""
    T = qs.shape[0]
    m_idx = torch.arange(1, T + 1, dtype=torch.float32, device=qs.device)
    Mf = M.to(torch.float32)
    valid = m_idx <= Mf
    v = 1.0 + ((N - Mf) / (N - m_idx)) * (
        1.0 / ((N - m_idx + 1.0) * torch.clamp_min(qs, 1e-30)) - 1.0)
    v = torch.where(valid, v, 0.0)
    weighted = v[None, :] * losses                    # (H, T)
    mean = weighted.sum(1) / torch.clamp_min(Mf, 1.0)
    sq_dev = torch.where(valid[None, :], (weighted - mean[:, None]) ** 2,
                         0.0)
    sample_var = sq_dev.sum(1) / torch.clamp_min(Mf - 1.0, 1.0)
    return mean, sample_var / torch.clamp_min(Mf, 1.0)


def lure_risks(losses: torch.Tensor, qs: torch.Tensor, M: torch.Tensor,
               N: int) -> torch.Tensor:
    """LURE risk estimates (H,) over the first M buffer slots."""
    return lure_risks_and_vars(losses, qs, M, N)[0]


def make_activetesting(preds: torch.Tensor,
                       loss_fn: Callable = accuracy_loss, budget: int = 128,
                       name: str = "activetesting",
                       acquisition_scores: Optional[torch.Tensor] = None,
                       device: DeviceLike = None) -> Selector:
    """The ActiveTesting selector over a ``(H, N, C)`` prediction tensor,
    on ``device`` (default: the card). ``budget`` is the label buffer's
    length: a run may take at most that many labels. VMA passes its own
    ``acquisition_scores``."""
    dev = resolve_device(device)
    preds = torch.as_tensor(preds, dtype=torch.float32).to(dev)
    H, N, C = preds.shape
    if acquisition_scores is None:
        acquisition_scores = surrogate_expected_losses(preds).sum(0)  # (N,)
    acquisition_scores = acquisition_scores.to(dev)
    every_model = torch.ones(H, dtype=torch.bool, device=dev)
    always = torch.ones((), dtype=torch.bool, device=dev)

    def init(key=None) -> LUREState:
        del key
        return LUREState(
            unlabeled=torch.ones(N, dtype=torch.bool, device=dev),
            losses=torch.zeros((H, budget), dtype=torch.float32, device=dev),
            qs=torch.zeros(budget, dtype=torch.float32, device=dev),
            n_labeled=torch.zeros((), dtype=torch.int32, device=dev),
        )

    def select(state: LUREState, key) -> SelectResult:
        idx, prob = masked_categorical(key, acquisition_scores,
                                       state.unlabeled)
        # proportional sampling: the utility is the (unnormalised)
        # acquisition weight, whose order the recorder's top-k captures
        return SelectResult(idx=idx, prob=prob, stochastic=always,
                            scores=torch.where(state.unlabeled,
                                               acquisition_scores,
                                               float("-inf")))

    def update(state: LUREState, idx, true_class, prob) -> LUREState:
        m = state.n_labeled.reshape(1).to(torch.int64)
        state.losses.index_copy_(
            1, m, loss_at(preds, loss_fn, idx, true_class)[:, None])
        state.qs.index_copy_(0, m, prob.reshape(1).to(torch.float32))
        state.unlabeled.index_fill_(0, idx.reshape(1).to(torch.int64), False)
        state.n_labeled.add_(1)
        return state

    def select_q(state: LUREState, key, q: int) -> SelectResult:
        """q proportional draws without replacement from the static
        weights, draw t with key t of ``split(key, q)``: each draw's
        probability is conditional on the picks before it (the q_m the
        LURE weights need)."""
        keys = trandom.split(key, q)
        mask = state.unlabeled.clone()
        idxs, probs = [], []
        for t in range(q):
            idx_t, prob_t = masked_categorical(keys[t], acquisition_scores,
                                               mask)
            mask.index_fill_(0, idx_t.reshape(1), False)
            idxs.append(idx_t)
            probs.append(prob_t.to(torch.float32))
        return SelectResult(idx=torch.stack(idxs), prob=torch.stack(probs),
                            stochastic=always,
                            scores=torch.where(state.unlabeled,
                                               acquisition_scores,
                                               float("-inf")))

    def update_q(state: LUREState, idxs, true_classes, probs) -> LUREState:
        """The q answers' loss vectors and probabilities into buffer slots
        ``m..m+q-1``, IN PLACE."""
        for j in range(idxs.shape[0]):
            update(state, idxs[j], true_classes[j], probs[j])
        return state

    def best(state: LUREState, key):
        risk = lure_risks(state.losses, state.qs, state.n_labeled, N)
        k_tie, k_rand = trandom.split(key)
        idx, n_ties = masked_argmin_tiebreak(k_tie, risk, every_model)
        # no labels yet: a uniformly random model (the reference's rule),
        # drawn on the host from the host key
        rand_idx = int(trandom.randint(k_rand, (), 0, H))
        labeled = state.n_labeled > 0
        return (torch.where(labeled, idx, rand_idx),
                ~labeled | (n_ties > 1))

    return Selector(
        name=name, init=init, select=select, update=update, best=best,
        select_q=select_q, update_q=update_q,
        always_stochastic=True,
        hyperparams={"budget": budget},
        extras={
            "lure_risks": lambda s: lure_risks(s.losses, s.qs, s.n_labeled,
                                               N),
            "lure_risks_and_vars": lambda s: lure_risks_and_vars(
                s.losses, s.qs, s.n_labeled, N),
        },
    )
