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
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Any, Callable, NamedTuple

import torch


class SelectResult(NamedTuple):
    idx: torch.Tensor         # 0-d int64 — chosen data point
    prob: torch.Tensor        # 0-d float32 — selection probability / q-value
    stochastic: torch.Tensor  # 0-d bool — did randomness affect this choice?
    # (N,) acquisition vector (higher = preferred, non-candidates -inf) for
    # the flight recorder, or None; the recorder is a later slice
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
