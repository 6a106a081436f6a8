"""The jointly learned annotator-reliability posterior, Dawid-Skene style
(counterpart of ``coda_tpu/crowd/reliability.py``).

Each annotator ``a`` carries a Dirichlet posterior over its ``(C, C)``
confusion matrix: ``counts[a, z, r]`` is the (soft) number of times it
answered ``r`` when the aggregated label said ``z``, plus a symmetric
Laplace prior. Per labeling round with votes ``(a_v, r_v, answered_v)``:

  1. **E-step**: ``log p(z) = sum_v answered_v * log conf_{a_v}[z, r_v] +
     log(1 + tally_z)``, the vote likelihood under the posterior-mean
     confusion anchored by the majority tally as a log-prior; the
     aggregated label is its argmax, the label's mass the learned weight.
  2. **Trust gate**: until the pool has seen ``cfg.trust_votes`` answered
     votes, aggregation is majority vote (label = modal response, weight =
     modal fraction). Both branches are computed and ``torch.where`` picks
     on the device: the gate is never read back to the host.
  3. **M-step**: ``counts[a_v, z, r_v] += answered_v * p(z)``, the votes
     applied one after another in vote order (as XLA's scatter applies
     them on the CPU), so two votes of one annotator with one response add
     to their cell in a fixed order on every device.

All-abstain rounds aggregate to weight 0: with the weighted update's w = 0
no-op the model posterior is untouched while the round still spends its
point. Sums over the votes run in vote order from zero, the reference's
reduction; every division is by a tensor.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch
import torch.nn.functional as F

from coda_tpu_torch.crowd.oracle import CrowdConfig
from coda_tpu_torch.utils.platform import DeviceLike, resolve_device


class ReliabilityState(NamedTuple):
    """The carried annotator posterior."""

    counts: torch.Tensor   # (A, C, C) float32 — confusion Dirichlet counts
    n_votes: torch.Tensor  # 0-d float32 — answered votes seen by the pool


def init_reliability(cfg: CrowdConfig, n_classes: int,
                     device: DeviceLike = None) -> ReliabilityState:
    """Symmetric Laplace prior (one pseudo-count a cell) on ``device``
    (default: the card): the posterior-mean confusion starts uniform."""
    dev = resolve_device(device)
    A, C = cfg.annotators, n_classes
    return ReliabilityState(
        counts=torch.ones((A, C, C), dtype=torch.float32, device=dev),
        n_votes=torch.zeros((), dtype=torch.float32, device=dev))


def _sum_classes(x: torch.Tensor) -> torch.Tensor:
    """``x.sum(-1, keepdim=True)`` over the class axis in class order."""
    return sum(x.unbind(-1), torch.zeros_like(x[..., 0]))[..., None]


def _confusion_mean(counts: torch.Tensor) -> torch.Tensor:
    return counts / _sum_classes(counts)


def annotator_accuracy(rel: ReliabilityState) -> torch.Tensor:
    """Posterior-mean diagonal accuracy per annotator, (A,); counts with
    leading axes (a run's rounds, a batch's replicas) give them too, each
    bitwise its own call (the sums run in class order, elementwise)."""
    diag = torch.diagonal(_confusion_mean(rel.counts), dim1=-2, dim2=-1)
    C = diag.shape[-1]
    return _sum_classes(diag)[..., 0] / torch.full(
        (), C, dtype=diag.dtype, device=diag.device)


def accuracy_movement(prev_acc, acc) -> float:
    """Mean |change| of posterior-mean accuracy per annotator between two
    reads of :func:`annotator_accuracy` (host float64)."""
    def host(x):
        return (x.detach().cpu().numpy() if isinstance(x, torch.Tensor)
                else np.asarray(x)).astype(np.float64)

    return float(np.abs(host(acc) - host(prev_acc)).mean())


def _sum_votes(x: torch.Tensor) -> torch.Tensor:
    """``x.sum(0)`` over the (V, ...) vote axis, in vote order from zero."""
    return sum(x.unbind(0), torch.zeros_like(x[0]))


def aggregate_votes(rel: ReliabilityState, ann_ids: torch.Tensor,
                    responses: torch.Tensor, answered: torch.Tensor,
                    cfg: CrowdConfig):
    """One round's E-step, trust gate and M-step.

    ``ann_ids``/``responses``/``answered`` are the (V,) vote tensors of
    :func:`coda_tpu_torch.crowd.oracle.sample_votes`. Returns ``(label,
    weight, rel')``: the aggregated label (0-d int64), its reliability
    weight in [0, 1] (0-d float32, 0 when every vote abstained) and the
    updated posterior (new tensors; ``rel`` is left as it was)."""
    counts = rel.counts
    A, C = counts.shape[0], counts.shape[-1]
    ann_ids = ann_ids.to(torch.int64)
    responses = responses.to(torch.int64)
    ans_f = answered.to(torch.float32)                           # (V,)
    n_ans = ans_f.sum()

    # -- majority-vote tally ----------------------------------------------
    onehot = F.one_hot(responses, C).to(torch.float32)           # (V, C)
    tally = _sum_votes(ans_f[:, None] * onehot)                  # (C,)
    z_maj = torch.argmax(tally)            # ties -> the smallest class
    w_maj = tally.take(z_maj) / torch.clamp(n_ans, min=1.0)

    # -- learned (Dawid-Skene) aggregation --------------------------------
    conf = _confusion_mean(counts)                               # (A, C, C)
    ll_votes = torch.log(torch.clamp(conf[ann_ids, :, responses],
                                     min=1e-30))                 # (V, C)
    # majority-anchored E-step: the tally's log-prior makes the cold-start
    # label majority vote until the learned confusions are sharp
    ll = _sum_votes(ans_f[:, None] * ll_votes) + torch.log1p(tally)
    e = torch.exp(ll - ll.max())
    p_z = e / _sum_classes(e)                                            # (C,)
    z_ds = torch.argmax(p_z)
    w_ds = p_z.take(z_ds)

    # -- trust gate (on the device) ---------------------------------------
    maj_teach = F.one_hot(z_maj, C).to(torch.float32)
    if cfg.reliability == "learned":
        trusted = rel.n_votes >= cfg.trust_votes
        label = torch.where(trusted, z_ds, z_maj)
        weight = torch.where(trusted, w_ds, w_maj)
        # teach with the distribution of the branch actually applied
        p_teach = torch.where(trusted, p_z, maj_teach)
    else:
        label, weight, p_teach = z_maj, w_maj, maj_teach
    # all-abstain round: weight 0, the update's structural no-op
    weight = torch.where(n_ans > 0, weight, torch.zeros_like(weight))

    # -- M-step: the votes' soft increments, one after another ------------
    inc = ans_f[:, None] * p_teach                                # (V, C)
    cell = (ann_ids[:, None] * (C * C)
            + torch.arange(C, device=counts.device) * C
            + responses[:, None])                                 # (V, C)
    flat = counts.reshape(A * C * C).clone()
    for v in range(ann_ids.shape[0]):
        # one vote's C cells are distinct: each takes exactly one add
        flat.index_add_(0, cell[v], inc[v])
    rel2 = ReliabilityState(counts=flat.reshape(A, C, C),
                            n_votes=rel.n_votes + n_ans)
    return label, weight, rel2
