"""Batched acquisition: q oracle labels a round (counterpart of
``coda_tpu/selectors/batch.py``).

Given any :class:`~coda_tpu_torch.selectors.protocol.Selector`, this
module resolves the q-wide pair the engine drives instead of
``select``/``update`` under ``--acq-batch q``:

  * ``select_q(state, key) -> SelectResult`` whose ``idx``/``prob`` carry a
    trailing ``(q,)`` axis: q distinct points from one scoring pass. A
    selector's own ``select_q`` (CODA's overlap-penalised greedy EIG,
    ModelPicker's argmin top-q, ActiveTesting's draws without replacement)
    is used as it is; otherwise :func:`generic_select_q` takes the method's
    own pick first and re-ranks the same score vector for picks 2..q.
  * ``update_q(state, idxs, true_classes, probs) -> state``: all q answers
    at once. A selector's own ``update_q`` is the fused path; the fallback
    applies ``update`` q times in order.

``q == 1`` never comes here: the engine runs the one-label round.

Under a mesh (``mesh=``, ``parallel/mesh.py``) the generic re-rank runs on
this rank's block of the score vector: each pick is the mesh arg-max over
every block, its score read on the rank that holds it, and only that rank
marks it picked; the picks are global and the same on every rank. The
weighted pair of the crowd's rounds (:func:`resolve_batch_wfns`) takes
the same mesh.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Optional

import torch

from coda_tpu_torch import random as trandom
from coda_tpu_torch.ops.masked import masked_argmax_tiebreak
from coda_tpu_torch.parallel.collectives import (
    any_over,
    broadcast_from_owner,
    clear_items,
)
from coda_tpu_torch.parallel.mesh import Mesh
from coda_tpu_torch.selectors.protocol import Selector, SelectResult

# the tie tolerance of the generic re-rank's picks 2..q: CODA's argmax
# rule (isclose, rtol = atol = 1e-8)
_TIE_RTOL = 1e-8
_TIE_ATOL = 1e-8

# the data folded into the round's select key for the re-rank picks
# (the reference's constant, so the draws are the same bits)
_FOLD = 0x6ba7c9


def generic_select_q(selector: Selector, q: int,
                     mesh: Optional[Mesh] = None) -> Callable:
    """Greedy top-q over the selector's own score vector, one scoring
    pass: pick 1 is the method's ``select`` (its key, its tie-break or
    sampling); picks 2..q are masked argmaxes over the same scores with
    the picked points removed, each tie broken by its own key of
    ``split(fold_in(key, 0x6ba7c9), q - 1)``. When the finite-score
    candidates run out, later picks fall back to the unlabeled points
    (scored -inf): the picks are always distinct. ``mesh``: the scores
    and the unlabeled mask are this rank's block (see the module
    docstring)."""
    if q < 2:
        raise ValueError("generic_select_q is the q >= 2 path")

    def select_q(state, key) -> SelectResult:
        res = selector.select(state, key)
        scores = res.scores
        if scores is None:
            raise ValueError(
                f"selector {selector.name!r} emits no score vector; "
                "--acq-batch > 1 needs one (SelectResult.scores) for the "
                "greedy top-q re-rank")
        N = scores.shape[-1]
        # every point unpicked, then the pick cleared (on its owner)
        unpicked = torch.ones(N, dtype=torch.bool, device=scores.device)
        clear_items(unpicked, res.idx.reshape(1), mesh)
        keys = trandom.split(trandom.fold_in(key, _FOLD), q - 1)
        finite = torch.isfinite(scores)
        any_tie = torch.zeros((), dtype=torch.bool, device=scores.device)
        idxs, probs = [res.idx.to(torch.int64)], [res.prob.to(torch.float32)]
        for t in range(q - 1):
            avail = finite & unpicked
            cand = torch.where(any_over(avail.any(), mesh), avail,
                               state.unlabeled & unpicked)
            idx_t, n_ties = masked_argmax_tiebreak(
                keys[t], torch.where(avail, scores, float("-inf")), cand,
                rtol=_TIE_RTOL, atol=_TIE_ATOL, mesh=mesh)
            clear_items(unpicked, idx_t.reshape(1), mesh)
            any_tie = any_tie | (n_ties > 1)
            idxs.append(idx_t)
            probs.append((scores.take(idx_t) if mesh is None
                          else broadcast_from_owner(scores, idx_t, mesh))
                         .to(torch.float32))
        return SelectResult(idx=torch.stack(idxs), prob=torch.stack(probs),
                            stochastic=res.stochastic | any_tie,
                            scores=scores)

    return select_q


def generic_update_q(update: Callable) -> Callable:
    """The sequential fallback: ``update`` once per answer, in order
    (correct for any selector, q refreshes instead of one). ``update`` is
    a selector's ``update`` (``(q,)`` answers) or a seed-batched form's
    (``(S, q)`` answers, one column at a time)."""

    def update_q(state, idxs, true_classes, probs):
        for j in range(idxs.shape[-1]):
            state = update(state, idxs[..., j], true_classes[..., j],
                           probs[..., j])
        return state

    return update_q


def generic_update_qw(selector: Selector) -> Callable:
    """The sequential fallback of the weighted q-wide update: ``update_w``
    once per answer, in order. On a mesh it is the mesh selector's
    ``update_w`` (global indices, every rank calling) once per answer."""
    if selector.update_w is None:
        raise ValueError(
            f"selector {selector.name!r} has no weighted update "
            "(update_w); reliability-weighted crowd rounds need one")

    def update_qw(state, idxs, true_classes, probs, ws):
        for j in range(idxs.shape[-1]):
            state = selector.update_w(state, idxs[..., j],
                                      true_classes[..., j], probs[..., j],
                                      ws[..., j])
        return state

    return update_qw


def resolve_batch_fns(selector: Selector, q: int,
                      mesh: Optional[Mesh] = None):
    """``(select_q(state, key), update_q(state, idxs, tcs, probs))`` for a
    batch width ``q >= 2``: the selector's own where it has them, the
    generic forms otherwise (``mesh``: the selector's, for the generic
    re-rank)."""
    if q < 2:
        raise ValueError(f"acq_batch={q}: the batched pair is the q >= 2 "
                         "path (q == 1 runs the one-label round)")
    if selector.select_q is not None:
        def sel_q(state, key, _f=selector.select_q):
            return _f(state, key, q)
    else:
        sel_q = generic_select_q(selector, q, mesh)
    upd_q = (selector.update_q if selector.update_q is not None
             else generic_update_q(selector.update))
    return sel_q, upd_q


def resolve_batch_wfns(selector: Selector, q: int,
                       mesh: Optional[Mesh] = None):
    """The weighted analogue of :func:`resolve_batch_fns`: ``(select_q,
    update_qw)``, the selector's fused ``update_qw`` where it has one, the
    sequential ``update_w`` otherwise (``mesh``: the selector's, for the
    generic re-rank)."""
    sel_q, _ = resolve_batch_fns(selector, q, mesh)
    upd_qw = (selector.update_qw if selector.update_qw is not None
              else generic_update_qw(selector))
    return sel_q, upd_qw


def make_batched_selector(selector: Selector, q: int) -> Selector:
    """A :class:`Selector` whose ``select``/``update`` are the q-wide pair
    (shapes carry a trailing ``(q,)``), for callers that know nothing of
    q; it has no seed-batched form (its seeds run one after another)."""
    sel_q, upd_q = resolve_batch_fns(selector, q)
    return dataclasses.replace(
        selector, select=sel_q, update=upd_q, select_q=None, update_q=None,
        update_w=None, update_qw=None, batched=None,
        hyperparams=dict(selector.hyperparams, acq_batch=q))


__all__ = [
    "generic_select_q",
    "generic_update_q",
    "generic_update_qw",
    "make_batched_selector",
    "resolve_batch_fns",
    "resolve_batch_wfns",
]
