"""Fixed-shape selection primitives (counterpart of
``coda_tpu/ops/masked.py``): masked argmax/argmin with random
tie-breaking, masked categorical sampling and base-2 entropy, including
the bit-manipulation ``log2_approx``.

Tie-break semantics are the reference's: a unique extremum gives its
(first) index; among ties the choice is uniform, drawn from the same
threefry bits as ``jax.random.uniform`` (``coda_tpu_torch/random.py``).
Everything stays on the device — no host synchronisation.

Mesh forms (``mesh=``, ``parallel/mesh.py``): the scores, mask and
weights are this rank's block along a mesh axis (``axis``: of N over
``data``, the default; of H over ``model``, for a baseline's readout of
the best model), and the result is the global index the unsharded
function picks on the same values, the same on every rank of the axis.
The global maximum, the tie count and the tie-break's draw (at the items'
global positions, so each rank draws its slice of the unsharded draw)
reach every rank as an ``all_gather`` of one small candidate row a rank;
among equal candidates the lowest rank wins, which is the lowest index,
as the unsharded ``argmax`` takes it.
"""

from __future__ import annotations

from typing import Optional

import torch

from coda_tpu_torch import random as trandom
from coda_tpu_torch.parallel.collectives import (
    all_gather_cat,
    all_gather_stack,
    gather_sum,
)
from coda_tpu_torch.parallel.mesh import DATA_AXIS, Mesh

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


def top_k(scores: torch.Tensor, k: int, mesh: Optional[Mesh] = None
          ) -> tuple:
    """``(values, positions)`` of the ``k`` largest of ``scores`` over the
    last axis, the lower position first among equal values (the order of
    ``lax.top_k``): a stable descending sort. With a ``mesh`` the scores
    are this rank's block of N and the positions global: each rank's top
    ``min(k, N/a)`` at global indices, joined over the data group in rank
    order (rank order is index order, so a stable sort of the joined
    candidates breaks ties across a block boundary as the unsharded sort
    does), then the top k of those — the same on every rank."""
    n = scores.shape[-1]
    values, order = torch.sort(scores, dim=-1, descending=True, stable=True)
    values, pos = values[..., :min(k, n)], order[..., :min(k, n)]
    if mesh is None:
        return values, pos
    pos = pos + mesh.start(n)
    values = all_gather_cat(values, mesh, DATA_AXIS, -1)
    pos = all_gather_cat(pos, mesh, DATA_AXIS, -1)
    top, order = top_k(values, k)
    return top, pos.gather(-1, order)


def _first_max(parts: torch.Tensor) -> torch.Tensor:
    """The candidate row of the rank whose value (column 0) is largest,
    the lowest such rank among equals: ``(d, ..., k) -> (..., k)``."""
    vals = parts[..., 0]
    rank = (vals == vals.amax(0)).to(torch.int32).argmax(0)
    k = parts.shape[-1]
    pick = rank.reshape((1,) + rank.shape + (1,)).expand(
        (1,) + rank.shape + (k,))
    return parts.gather(0, pick)[0]


def _local_max(values: torch.Tensor, start: int, *extras) -> torch.Tensor:
    """``(..., 2 + len(extras))`` float64 candidate row of a block: its
    largest value (first among equals), that item's global index, and each
    of ``extras`` at it."""
    val, at = values.max(-1)
    cols = [val.to(torch.float64), (at + start).to(torch.float64)]
    cols += [e.gather(-1, at[..., None])[..., 0].to(torch.float64)
             for e in extras]
    return torch.stack(cols, -1)


def mesh_masked_argmax_tiebreak(key: torch.Tensor, scores: torch.Tensor,
                                mask: torch.Tensor, mesh: Mesh,
                                rtol: float = 0.0, atol: float = 0.0,
                                axis: str = DATA_AXIS):
    """:func:`masked_argmax_tiebreak` over a mesh: ``scores`` and ``mask``
    this rank's ``(..., n)`` block along ``axis``. Two ``all_gather``
    calls of one row a rank: the block maxima (with their global index
    and score), then each block's tie count and its largest tie-break
    draw among the global maximum's ties. Returns ``(idx, tie_count,
    score at idx)``, global and the same on every rank of the axis."""
    n = scores.shape[-1]
    start = n * mesh.axis_index(axis)
    total = n * mesh.axis_size(axis)
    masked = torch.where(mask, scores, float("-inf"))
    first = _first_max(all_gather_stack(_local_max(masked, start, scores),
                                        mesh, axis))
    best = first[..., 0].to(scores.dtype)[..., None]
    if rtol > 0 or atol > 0:
        ties = torch.isclose(masked, best, rtol=rtol, atol=atol) & mask
    else:
        ties = (masked == best) & mask
    u = trandom.uniform(key, (n,), device=scores.device, start=start,
                        total=total)
    cand = torch.cat([ties.sum(-1, keepdim=True).to(torch.float64),
                      _local_max(torch.where(ties, u, -1.0), start, scores)],
                     -1)
    parts = all_gather_stack(cand, mesh, axis)
    n_ties = parts[..., 0].sum(0).to(torch.int64)
    rand = _first_max(parts[..., 1:])
    chosen = torch.where((n_ties > 1)[..., None], rand, first)
    return chosen[..., 1].to(torch.int64), n_ties, \
        chosen[..., 2].to(scores.dtype)


def masked_argmax_tiebreak(key: torch.Tensor, scores: torch.Tensor,
                           mask: torch.Tensor, rtol: float = 0.0,
                           atol: float = 0.0, mesh: Optional[Mesh] = None,
                           axis: str = DATA_AXIS):
    """Argmax of ``scores`` over positions where ``mask``; uniform among
    ties (``isclose(score, max, rtol, atol)`` when a tolerance is given,
    else exact equality). ``key`` is a ``(2,)`` threefry key, usually on
    the host; the ``(N,)`` draw runs on ``scores``' device.

    Seed-batched: ``scores`` and ``mask`` ``(S, N)`` with ``(S, 2)`` keys
    (on ``scores``' device: the engine uploads a run's keys once) pick one
    index per row, with the same semantics row by row.

    Returns ``(idx, tie_count)`` as device tensors (0-d, or ``(S,)``);
    ``tie_count > 1`` means the choice was stochastic. With a ``mesh``
    the operands are this rank's block along ``axis`` and ``idx`` is
    global (:func:`mesh_masked_argmax_tiebreak`).
    """
    if mesh is not None:
        return mesh_masked_argmax_tiebreak(key, scores, mask, mesh, rtol,
                                           atol, axis)[:2]
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
                           atol: float = 0.0, mesh: Optional[Mesh] = None,
                           axis: str = DATA_AXIS):
    """Argmin counterpart of :func:`masked_argmax_tiebreak` (``mesh`` and
    ``axis`` too)."""
    return masked_argmax_tiebreak(key, -scores, mask, rtol=rtol, atol=atol,
                                  mesh=mesh, axis=axis)


def mesh_categorical(key: torch.Tensor, logits: torch.Tensor, mesh: Mesh,
                     *extras) -> torch.Tensor:
    """``jax.random.categorical`` over a mesh: ``logits`` this rank's
    ``(..., N/d)`` block, its Gumbel noise drawn at the global positions.
    Returns the ``(..., 2 + len(extras))`` float64 row of the winner: the
    noisy logit, the global index, and each of ``extras`` (blocks like
    ``logits``) at it; the same on every rank (one ``all_gather``)."""
    n = logits.shape[-1]
    z = trandom.categorical_scores(key, logits, start=mesh.start(n),
                                   total=n * mesh.data)
    return _first_max(all_gather_stack(
        _local_max(z, mesh.start(n), *extras), mesh))


def masked_categorical(key: torch.Tensor, weights: torch.Tensor,
                       mask: torch.Tensor, mesh: Optional[Mesh] = None):
    """Sample an index proportionally to ``weights`` restricted to
    ``mask`` (``jax.random.categorical`` over the log-probabilities, the
    same threefry Gumbel noise). Where the masked weights sum to at most
    1e-12 the draw is uniform over the mask (the reference's degenerate
    fallback). ``key`` is a ``(2,)`` threefry key, usually on the host; the
    ``(N,)`` draw runs on ``weights``' device.

    Returns ``(idx, prob)`` as 0-d device tensors, ``prob`` the normalised
    probability of the sampled index (the selection probability the LURE
    estimator needs). With a ``mesh`` the operands are this rank's block;
    the weights' total and the mask's count add the blocks' in rank order
    (:func:`gather_sum`; the probabilities may differ from the unsharded
    ones in the last bits) and ``idx`` is global.
    """
    w = torch.where(mask, torch.clamp_min(weights, 0.0), 0.0)
    total = w.sum() if mesh is None else gather_sum(w.sum(), mesh)
    n_mask = torch.clamp_min(mask.sum() if mesh is None
                             else gather_sum(mask.sum(), mesh), 1)
    probs = torch.where(total > 1e-12, w / torch.clamp_min(total, 1e-30),
                        mask.to(w.dtype) / n_mask)
    logits = torch.log(torch.clamp_min(probs, 1e-38))
    logits = torch.where(probs > 0, logits, float("-inf"))
    if mesh is not None:
        row = mesh_categorical(key, logits, mesh, probs)
        return row[..., 1].to(torch.int64), row[..., 2].to(probs.dtype)
    idx = trandom.categorical(key, logits)
    return idx, probs.take(idx)
