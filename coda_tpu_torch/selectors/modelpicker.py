"""ModelPicker (Karimi et al.): a multiplicative-weights posterior over
models (counterpart of ``coda_tpu/selectors/modelpicker.py``).

  * The posterior is updated multiplicatively by ``γ^agreement`` with
    ``γ = (1-ε)/ε`` and a per-task tuned ε (:data:`TASK_EPS`).
  * Acquisition: the unlabeled *disagreement* point with the least
    expected posterior entropy over hypothetical labels (uniform over the
    classes), in closed form (:func:`expected_entropies`), over all N
    points every round, as the reference's CLI path scores them.
  * The best model is the argmax of the correct-prediction counts, ties
    broken at random.

``update`` writes the mask, the counts and the label count IN PLACE and
replaces the posterior. Under a mesh the expected entropies are per item,
so each rank scores its block; the disagreement fallback and the pick
cross ranks, and the labelled item's predictions come from its owner.
Under the model axis the posterior and the counts are this rank's models'
(bitwise equal across its data group): the float64 bucket sums and
totals over H add the model group's parts before they are rounded to
float32, the posterior's normalisation adds its sums, the disagreement
test reads model 0's predictions from its owner, and the best model is
the mesh arg-min over the model group.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import torch

from coda_tpu_torch import random as trandom
from coda_tpu_torch.ops.masked import masked_argmin_tiebreak
from coda_tpu_torch.ops.pbest import sum_h
from coda_tpu_torch.parallel.collectives import (
    all_gather_cat,
    any_over,
    broadcast_from_owner,
    clear_items,
    count_over,
)
from coda_tpu_torch.parallel.mesh import MODEL_AXIS, Mesh
from coda_tpu_torch.selectors.protocol import Selector, SelectResult
from coda_tpu_torch.utils.platform import DeviceLike, resolve_device

# Per-task tuned epsilons: the JAX package's table (its source's
# modelpicker.py:5-35 and its own grid search on the committed real tasks)
TASK_EPS = {
    "imagenet_v2_matched-frequency": 0.48,
    "cifar10_4070": 0.47,
    "cifar10_5592": 0.47,
    "pacs": 0.45,
    "glue/cola": 0.45,
    "glue/mnli": 0.43,
    "glue/qnli": 0.44,
    "glue/qqp": 0.47,
    "glue/rte": 0.39,
    "glue/sst2": 0.36,
    "real_clipart": 0.42,
    "real_painting": 0.35,
    "real_sketch": 0.45,
    "sketch_real": 0.35,
    "sketch_clipart": 0.35,
    "sketch_painting": 0.37,
    "clipart_painting": 0.45,
    "clipart_real": 0.45,
    "clipart_sketch": 0.43,
    "painting_sketch": 0.39,
    "painting_real": 0.44,
    "painting_clipart": 0.39,
    "iwildcam": 0.49,
    "civilcomments": 0.46,
    "fmow": 0.44,
    "camelyon": 0.47,
    "digits": 0.39,
    "breast_cancer": 0.35,
    "wine": 0.37,
    "iris": 0.36,
    "digits_shift": 0.44,
    "pyfiles": 0.36,
    "digits_h80": 0.36,
}
DEFAULT_EPS = 0.46


def _bucket_sums(hard_preds: torch.Tensor, w: torch.Tensor,
                 wlw: torch.Tensor, C: int, mesh: Optional[Mesh] = None):
    """``t1[n, c] = Σ_{h: pred=c} w_h`` and ``t2`` (the same with
    ``w·ln w``), two (N, C) float32 tensors (``mesh``: this rank's
    models, the float64 sums completed over the model group).

    A one-hot product a class at a time: the (N, H) indicator of class c
    times the (H, 2) weights, in float64, rounded once to float32. A
    matrix product adds in a fixed order, so two runs on the card give the
    same bits (the reference's scatter-add would be ``index_add_`` here,
    whose CUDA atomics add in no fixed order); in float64 the rounded sums
    hardly depend on that order, so two points whose buckets hold the same
    models get the same sums, as the reference's in-order scatter gives
    them, and the card and the CPU agree."""
    ww = torch.stack([w, wlw], 1).to(torch.float64)               # (H, 2)
    t = torch.stack([(hard_preds == c).to(torch.float64) @ ww
                     for c in range(C)], 1)                       # (N, C, 2)
    t = sum_h(t, mesh).to(torch.float32)
    return t[..., 0], t[..., 1]


def _mean_bits_in_order(x: torch.Tensor) -> torch.Tensor:
    """The mean over the last (short) axis in bits, as the reference's
    lowering takes it: a float32 sum in index order times the one folded
    constant ``(1/C) / ln 2``. Two points whose per-class values are the
    same set in another order then tie or not as they do in the
    reference."""
    acc = x[..., 0]
    for c in range(1, x.shape[-1]):
        acc = acc + x[..., c]
    # folded on the host in float32; a Python float enters the product
    # without a copy to the device
    scale = (torch.tensor(1.0 / x.shape[-1], dtype=torch.float32)
             / torch.log(torch.tensor(2.0, dtype=torch.float32)))
    return acc * float(scale)


class ModelPickerState(NamedTuple):
    unlabeled: torch.Tensor       # (N,) bool
    posterior: torch.Tensor       # (H,)
    correct_counts: torch.Tensor  # (H,) int32
    n_labeled: torch.Tensor       # 0-d int32


def expected_entropies(hard_preds: torch.Tensor, posterior: torch.Tensor,
                       gamma: float, C: int,
                       mesh: Optional[Mesh] = None) -> torch.Tensor:
    """(N,) mean posterior entropy in bits over hypothetical class labels.

    A hypothetical label moves each model's logit by ``log γ`` where it
    agrees and leaves it where it does not, so with the bucket sums

        T1[n, c] = Σ_{h: pred_h(n)=c} w_h,  T2[n, c] = Σ_{h: pred_h(n)=c}
        w_h·ln w_h,  W = Σ_h w_h,  L = Σ_h w_h·ln w_h,  Z = W + (γ-1)·T1

    the post-update entropy is ``ln Z − (L + (γ-1)·T2 + γ·ln γ·T1) / Z``
    nats: O(N·H) work a round instead of a softmax per (point, class).
    ``mesh``: ``hard_preds`` (N, H/b) and ``posterior`` (H/b,) are this
    rank's models; every sum over H adds the model group's float64
    parts."""
    # a fill on the device, not a copy from the host (which would wait for
    # the stream every round)
    g = torch.full((), gamma, dtype=torch.float32, device=posterior.device)
    log_gamma = torch.log(g)
    w = torch.clamp_min(posterior, 1e-38).to(torch.float32)
    wlw = w * torch.log(w)
    W = sum_h(w.sum(dtype=torch.float64), mesh).to(torch.float32)
    L = sum_h(wlw.sum(dtype=torch.float64), mesh).to(torch.float32)
    t1, t2 = _bucket_sums(hard_preds, w, wlw, C, mesh)
    Z = W + (g - 1.0) * t1
    ent_nat = torch.log(Z) - (L + (g - 1.0) * t2 + g * log_gamma * t1) / Z
    return _mean_bits_in_order(ent_nat)


def make_modelpicker(preds: torch.Tensor, epsilon: float = DEFAULT_EPS,
                     name: str = "model_picker",
                     device: DeviceLike = None,
                     mesh: Optional[Mesh] = None) -> Selector:
    """The ModelPicker selector over a ``(H, N, C)`` prediction tensor, on
    ``device`` (default: the card); ``mesh``: this rank's block of N on
    the mesh's device (indices global; ``preds`` its ``(H/b, N/a, C)``
    block)."""
    dev = mesh.device if mesh is not None else resolve_device(device)
    preds = torch.as_tensor(preds, dtype=torch.float32).to(dev)
    H, N, C = preds.shape
    h_all = H * (mesh.model if mesh is not None else 1)    # global H
    epsilon = float(epsilon)
    gamma = (1.0 - epsilon) / epsilon
    gamma32 = torch.full((), gamma, dtype=torch.float32, device=dev)
    hard_preds = preds.argmax(-1).T.to(torch.int32).contiguous()   # (N, H)
    # points where any model disagrees with model 0
    if mesh is not None and mesh.model > 1:
        first = broadcast_from_owner(
            hard_preds, torch.zeros(1, dtype=torch.int64, device=dev), mesh,
            dim=1, axis=MODEL_AXIS)[0]                             # (N,)
        disagree = any_over((hard_preds != first[:, None]).any(1), mesh,
                            MODEL_AXIS)
    else:
        disagree = (hard_preds != hard_preds[:, :1]).any(1)
    every_model = torch.ones(H, dtype=torch.bool, device=dev)
    always = torch.ones((), dtype=torch.bool, device=dev)

    def init(key=None) -> ModelPickerState:
        del key
        return ModelPickerState(
            unlabeled=torch.ones(N, dtype=torch.bool, device=dev),
            posterior=torch.full((H,), 1.0 / h_all, dtype=torch.float32,
                                 device=dev),
            correct_counts=torch.zeros(H, dtype=torch.int32, device=dev),
            n_labeled=torch.zeros((), dtype=torch.int32, device=dev),
        )

    def select(state: ModelPickerState, key) -> SelectResult:
        ent = expected_entropies(hard_preds, state.posterior, gamma, C,
                                 mesh)
        # restrict to disagreement points while any remains unlabeled
        cand0 = disagree & state.unlabeled
        cand = torch.where(any_over(cand0.any(), mesh), cand0,
                           state.unlabeled)
        idx, _ = masked_argmin_tiebreak(key, ent, cand, mesh=mesh)
        return SelectResult(
            idx=idx,
            prob=1.0 / count_over(state.unlabeled, mesh).to(torch.float32),
            stochastic=always,
            # argmin acquisition, negated for the recorder's
            # higher-is-better top-k
            scores=torch.where(cand, -ent, float("-inf")))

    def update(state: ModelPickerState, idx, true_class, prob=None
               ) -> ModelPickerState:
        del prob
        if mesh is not None:
            pred_i = broadcast_from_owner(hard_preds, idx.reshape(1),
                                          mesh)[0]                 # (H,)
        else:
            pred_i = hard_preds.index_select(
                0, idx.reshape(1).to(torch.int64))[0]              # (H,)
        agree = pred_i == true_class.to(torch.int32)
        post = state.posterior * torch.pow(gamma32, agree.to(torch.float32))
        state.correct_counts.add_(agree.to(torch.int32))
        clear_items(state.unlabeled, idx.reshape(1), mesh)
        state.n_labeled.add_(1)
        return state._replace(posterior=post / sum_h(post.sum(), mesh))

    def select_q(state: ModelPickerState, key, q: int) -> SelectResult:
        """Argmin top-q: the q lowest expected entropies of one scoring
        pass, pick t breaking its ties with key t of ``split(key, q)``; a
        candidate set smaller than q falls back to any unlabeled point.
        ``mesh``: each pick the mesh arg-min, cleared on its owner."""
        ent = expected_entropies(hard_preds, state.posterior, gamma, C,
                                 mesh)
        cand0 = disagree & state.unlabeled
        cand = torch.where(any_over(cand0.any(), mesh), cand0,
                           state.unlabeled)
        prob = 1.0 / count_over(state.unlabeled, mesh).to(torch.float32)
        keys = trandom.split(key, q)
        unpicked = torch.ones(N, dtype=torch.bool, device=dev)
        idxs = []
        for t in range(q):
            avail = cand & unpicked
            use = torch.where(any_over(avail.any(), mesh), avail,
                              state.unlabeled & unpicked)
            idx_t, _ = masked_argmin_tiebreak(keys[t], ent, use, mesh=mesh)
            clear_items(unpicked, idx_t.reshape(1), mesh)
            idxs.append(idx_t)
        return SelectResult(
            idx=torch.stack(idxs), prob=prob.expand(q).clone(),
            stochastic=always,
            scores=torch.where(cand, -ent, float("-inf")))

    def update_q(state: ModelPickerState, idxs, true_classes, probs=None
                 ) -> ModelPickerState:
        """One multiplicative update for all q answers: the posterior
        moves by ``gamma^(sum of agreements)`` and is normalised once
        (``mesh``: the answers' predictions from their owners, the norm
        over the model group)."""
        del probs
        if mesh is not None:
            pred_q = broadcast_from_owner(hard_preds, idxs, mesh)  # (q, H)
        else:
            pred_q = hard_preds.index_select(0, idxs.to(torch.int64))
        agree = (pred_q == true_classes.to(torch.int32)[:, None]).to(
            torch.float32)
        a_sum = agree.sum(0)                                       # (H,)
        post = state.posterior * torch.pow(gamma32, a_sum)
        state.correct_counts.add_(a_sum.to(torch.int32))
        clear_items(state.unlabeled, idxs, mesh)
        state.n_labeled.add_(idxs.shape[0])
        return state._replace(posterior=post / sum_h(post.sum(), mesh))

    def best(state: ModelPickerState, key):
        k_tie, k_rand = trandom.split(key)
        idx, n_ties = masked_argmin_tiebreak(
            k_tie, -state.correct_counts.to(torch.float32), every_model,
            mesh=mesh, axis=MODEL_AXIS)
        # drawn on the host from the host key
        rand_idx = int(trandom.randint(k_rand, (), 0, h_all))
        labeled = state.n_labeled > 0
        return (torch.where(labeled, idx, rand_idx),
                ~labeled | (n_ties > 1))

    def get_pbest(state: ModelPickerState) -> torch.Tensor:
        if mesh is None or mesh.model == 1:
            return state.posterior
        return all_gather_cat(state.posterior, mesh, MODEL_AXIS, -1)

    return Selector(
        name=name, init=init, select=select, update=update, best=best,
        select_q=select_q, update_q=update_q,
        always_stochastic=True,
        hyperparams={"epsilon": epsilon},
        # the multiplicative-weights posterior is this method's P(best),
        # under the key CODA uses, so the recorder digests both; under a
        # model axis every model's, gathered over the model group
        extras={"get_pbest": get_pbest},
    )
