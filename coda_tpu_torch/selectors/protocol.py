"""The functional selector protocol (counterpart of
``coda_tpu/selectors/protocol.py``).

A method is four functions over a state object:

    init(key)                          -> state
    select(state, key)                 -> SelectResult(idx, prob, stochastic)
    update(state, idx, true_class, p)  -> state
    best(state, key)                   -> (best model index, stochastic)

``key`` is an explicit ``(2,)`` threefry key tensor
(``coda_tpu_torch/random.py``). Results are device tensors, so a round
never waits on the host. Unlike the reference's pure functions, ``update``
may modify the state's tensors in place; each method says so.

A method may also have a seed-batched form (:class:`BatchedSelector`): the
same functions over one state whose tensors carry a leading replica axis
S, so the engine runs S seeds in one round loop — where the reference
``vmap``s the four functions over seeds.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Any, Callable, NamedTuple, Optional

import torch


class SelectResult(NamedTuple):
    idx: torch.Tensor         # 0-d int64 — chosen data point
    prob: torch.Tensor        # 0-d float32 — selection probability / q-value
    stochastic: torch.Tensor  # 0-d bool — did randomness affect this choice?
    # (N,) acquisition vector (higher = preferred, non-candidates -inf) for
    # the flight recorder, or None
    scores: Any = None


@dataclass(frozen=True)
class Selector:
    """A bundle of functions implementing one selection method."""

    name: str
    init: Callable[[torch.Tensor], Any]
    select: Callable[[Any, torch.Tensor], SelectResult]
    update: Callable[[Any, torch.Tensor, torch.Tensor, torch.Tensor], Any]
    best: Callable[[Any, torch.Tensor], tuple]
    # True when the method is stochastic by construction (e.g. IID sampling)
    always_stochastic: bool = False
    hyperparams: dict = field(default_factory=dict)
    hyperparam_defaults: dict = field(default_factory=dict)
    # method-specific functions (e.g. CODA's get_pbest) for diagnostics
    extras: dict = field(default_factory=dict)
    # the seed-batched form, or None where the method has none (the engine
    # then runs seeds one after another)
    batched: Any = None
    # -- batched acquisition (--acq-batch q) -------------------------------
    # select_q(state, key, q): q distinct points from one scoring pass, a
    # SelectResult whose idx/prob carry a trailing (q,) axis. None: the
    # method has no native form and ``selectors/batch.py`` derives a
    # greedy top-q from the score vector ``select`` returns.
    # update_q(state, idxs, true_classes, probs) with (q,) tensors: all q
    # answers as one fused update. None: ``batch.py`` applies ``update``
    # q times in order.
    select_q: Optional[Callable] = None
    update_q: Optional[Callable] = None
    # -- weighted updates (the crowd oracle's protocol) --------------------
    # update_w(state, idx, true_class, prob, w): ``update`` with the
    # posterior increment scaled by w (w = 1 is ``update``; w = 0 leaves
    # the posterior as it was); update_qw its q-wide form
    update_w: Optional[Callable] = None
    update_qw: Optional[Callable] = None


@dataclass(frozen=True)
class BatchedSelector:
    """A method's seed-batched form: S replicas in one state.

        init(S)                            -> state (leading axis S)
        select_keys(keys)                  -> host tensor (..., 2[, 2])
        select(state, keys)                -> SelectResult of (S,) tensors
        update(state, idx, true_class, p)  -> state
        best(state)                        -> ((S,) best models, (S,) bool)

    ``select_keys`` is the host side of ``select``'s key use: it maps a
    run's per-replica select keys ``(..., 2)`` (the engine's schedule) to
    the keys ``select`` draws from (CODA's: both halves of its split,
    ``(..., 2, 2)``), so the engine can compute them for
    every round before the loop and upload them to the device once;
    ``select`` then takes one round's ``(S, 2)`` rows of them. Replica s
    follows the trajectory the single-replica functions give seed s.
    There is no q-wide form: under ``--acq-batch`` seeds run one after
    another. ``update_w(state, idx, true_class, p, w)`` with ``(S,)``
    weights is ``update`` with replica s's increment scaled by ``w[s]``
    (the crowd oracle's), or None where the method has none."""

    init: Callable[[int], Any]
    select_keys: Callable[[torch.Tensor], torch.Tensor]
    select: Callable[[Any, torch.Tensor], SelectResult]
    update: Callable[[Any, torch.Tensor, torch.Tensor, torch.Tensor], Any]
    best: Callable[[Any], tuple]
    update_w: Optional[Callable] = None
