"""Fixed-shape selection primitives (counterpart of
``coda_tpu/ops/masked.py``): masked argmax/argmin with random
tie-breaking, masked categorical sampling and base-2 entropy, including
the bit-manipulation ``log2_approx``.

Tie-break semantics are the reference's: a unique extremum gives its
(first) index; among ties the choice is uniform, drawn from the same
threefry bits as ``jax.random.uniform`` (``coda_tpu_torch/random.py``).
Everything stays on the device — no host synchronisation.
"""

from __future__ import annotations

import torch

from coda_tpu_torch import random as trandom

# Degree-6 fitted polynomial for log2(m) on the mantissa m in [1, 2),
# evaluated in t = m - 1 (Horner, ascending coefficients) — the
# reference's constants, so the approx flavour agrees bit for bit in form.
_LOG2_POLY = (
    5.065333097742375e-06,
    1.4423954826705712,
    -0.7169868747328294,
    0.45385624123395407,
    -0.27235315795334314,
    0.11790518317842658,
    -0.0248256066155325,
)


def log2_approx(x: torch.Tensor) -> torch.Tensor:
    """Fast fp32 log2 for positive normal floats (callers clamp first):
    exponent from the IEEE-754 bits, ``log2`` of the mantissa from
    :data:`_LOG2_POLY`. NaN/inf/zero/denormal inputs are not handled."""
    x = x.to(torch.float32)
    xi = x.view(torch.int32)
    e = (xi >> 23) - 127
    m = ((xi & 0x007FFFFF) | 0x3F800000).view(torch.float32)
    t = m - 1.0
    p = torch.full_like(t, _LOG2_POLY[-1])
    for c in _LOG2_POLY[-2::-1]:
        p = p * t + c
    return e.to(torch.float32) + p


def entropy2(p: torch.Tensor, dim: int = -1, floor: float = 1e-12,
             approx: bool = False) -> torch.Tensor:
    """Shannon entropy in bits with the reference's 1e-12 floor clamp."""
    pc = torch.clamp_min(p, floor)
    if approx:
        return -(pc * log2_approx(pc)).sum(dim)
    return -(pc * torch.log2(pc)).sum(dim)


def masked_argmax_tiebreak(key: torch.Tensor, scores: torch.Tensor,
                           mask: torch.Tensor, rtol: float = 0.0,
                           atol: float = 0.0):
    """Argmax of ``scores`` over positions where ``mask``; uniform among
    ties (``isclose(score, max, rtol, atol)`` when a tolerance is given,
    else exact equality). ``key`` is a ``(2,)`` threefry key, usually on
    the host; the ``(N,)`` draw runs on ``scores``' device.

    Seed-batched: ``scores`` and ``mask`` ``(S, N)`` with ``(S, 2)`` keys
    (on ``scores``' device: the engine uploads a run's keys once) pick one
    index per row, with the same semantics row by row.

    Returns ``(idx, tie_count)`` as device tensors (0-d, or ``(S,)``);
    ``tie_count > 1`` means the choice was stochastic.
    """
    masked = torch.where(mask, scores, float("-inf"))
    best = masked.amax(-1, keepdim=True)
    if rtol > 0 or atol > 0:
        ties = torch.isclose(masked, best, rtol=rtol, atol=atol) & mask
    else:
        ties = (masked == best) & mask
    n_ties = ties.sum(-1)
    idx_first = masked.argmax(-1)
    u = trandom.uniform(key, ties.shape[-1:], device=scores.device)
    idx_rand = torch.where(ties, u, -1.0).argmax(-1)
    idx = torch.where(n_ties > 1, idx_rand, idx_first)
    return idx, n_ties


def masked_argmin_tiebreak(key: torch.Tensor, scores: torch.Tensor,
                           mask: torch.Tensor, rtol: float = 0.0,
                           atol: float = 0.0):
    """Argmin counterpart of :func:`masked_argmax_tiebreak`."""
    return masked_argmax_tiebreak(key, -scores, mask, rtol=rtol, atol=atol)


def masked_categorical(key: torch.Tensor, weights: torch.Tensor,
                       mask: torch.Tensor):
    """Sample an index proportionally to ``weights`` restricted to
    ``mask`` (``jax.random.categorical`` over the log-probabilities, the
    same threefry Gumbel noise). Where the masked weights sum to at most
    1e-12 the draw is uniform over the mask (the reference's degenerate
    fallback). ``key`` is a ``(2,)`` threefry key, usually on the host; the
    ``(N,)`` draw runs on ``weights``' device.

    Returns ``(idx, prob)`` as 0-d device tensors, ``prob`` the normalised
    probability of the sampled index (the selection probability the LURE
    estimator needs).
    """
    w = torch.where(mask, torch.clamp_min(weights, 0.0), 0.0)
    total = w.sum()
    n_mask = torch.clamp_min(mask.sum(), 1)
    probs = torch.where(total > 1e-12, w / torch.clamp_min(total, 1e-30),
                        mask.to(w.dtype) / n_mask)
    logits = torch.log(torch.clamp_min(probs, 1e-38))
    logits = torch.where(probs > 0, logits, float("-inf"))
    idx = trandom.categorical(key, logits)
    return idx, probs.take(idx)
