"""Experiment loop: the labeling rounds on the card (counterpart of
``coda_tpu/engine/loop.py``).

The reference compiles a whole experiment into one ``lax.scan`` and
batches seeds under ``vmap``. Here a seed is a Python loop of rounds over
device-resident state, and seeds run one after another, each a
single-replica experiment through the same kernels. The key schedule is
the reference's — ``PRNGKey(seed)`` split into init/prior/scan keys, the
scan key split once per round, each round key split into select/best
keys — computed on the host with the same threefry bits, so per-seed
trajectories are comparable with the reference's. No round reads a value
back to the host: labels, regrets and indices stay on the device and are
stacked once at the end.
"""

from __future__ import annotations

import time
from typing import Callable, NamedTuple, Optional

import numpy as np
import torch

from coda_tpu_torch import random as trandom
from coda_tpu_torch.losses import accuracy_loss
from coda_tpu_torch.oracle import true_losses as compute_true_losses
from coda_tpu_torch.selectors.protocol import Selector
from coda_tpu_torch.utils.platform import DeviceLike, resolve_device


class ExperimentResult(NamedTuple):
    """Per-round traces (leading axis = round; ``run_seeds_compiled``
    adds a leading seed axis)."""

    chosen_idx: torch.Tensor         # (T,) int32 — which point was labeled
    true_class: torch.Tensor         # (T,) int32 — its oracle label
    best_model: torch.Tensor         # (T,) int32 — current best-model guess
    regret: torch.Tensor             # (T,) float32
    cumulative_regret: torch.Tensor  # (T,) float32
    select_prob: torch.Tensor        # (T,) float32 — selection prob / q-value
    regret_at_0: torch.Tensor        # 0-d — prior regret before any labels
    stochastic: torch.Tensor         # 0-d bool — did RNG affect the run?


def make_step_fn(selector: Selector, labels: torch.Tensor,
                 model_losses: torch.Tensor):
    """One labeling round: ``(state, cum, key) -> (state, cum, outs)`` with
    ``outs = (idx, true_class, best, regret, cum, prob, stochastic)``, all
    0-d device tensors."""
    best_loss = model_losses.min()

    def step(state, cum, k):
        k_sel, k_best = trandom.split(k)
        res = selector.select(state, k_sel)
        tc = labels.take(res.idx)
        state = selector.update(state, res.idx, tc, res.prob)
        best, b_stoch = selector.best(state, k_best)
        regret = model_losses.take(best) - best_loss
        cum = cum + regret
        return state, cum, (res.idx, tc, best, regret, cum, res.prob,
                            res.stochastic | b_stoch)

    return step


def _validate_rounds(N: int, iters: int) -> None:
    if iters > N:
        raise ValueError(f"iters={iters} labels exceeds the {N} labelable "
                         "points; the unlabeled set would be exhausted")


def build_experiment_fn(selector: Selector, labels: torch.Tensor,
                        model_losses: torch.Tensor, iters: int = 100,
                        timings: Optional[list] = None
                        ) -> Callable[[torch.Tensor], ExperimentResult]:
    """``key -> ExperimentResult`` for one seed.

    ``timings``: when a list is given, each call appends ``{"init_ms",
    "rounds_ms"}`` measured on the host clock with the device synchronised
    at the phase boundaries (two synchronisations per seed)."""
    best_loss = model_losses.min()
    _validate_rounds(labels.shape[0], iters)
    step = make_step_fn(selector, labels, model_losses)
    dev = labels.device

    def _sync():
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)

    def experiment(key: torch.Tensor) -> ExperimentResult:
        k_init, k_prior, k_scan = trandom.split(key, 3)
        if timings is not None:
            _sync()
            t0 = time.perf_counter()
        state = selector.init(k_init)
        best0, stoch0 = selector.best(state, k_prior)
        regret0 = model_losses.take(best0) - best_loss
        if timings is not None:
            _sync()
            t1 = time.perf_counter()
        keys = trandom.split(k_scan, iters)
        cum = torch.zeros((), dtype=torch.float32, device=dev)
        outs = []
        for t in range(iters):
            state, cum, o = step(state, cum, keys[t])
            outs.append(o)
        if timings is not None:
            _sync()
            t2 = time.perf_counter()
            timings.append({"init_ms": 1e3 * (t1 - t0),
                            "rounds_ms": 1e3 * (t2 - t1)})
        cols = [torch.stack(c) for c in zip(*outs)]
        idxs, tcs, bests, regrets, cums, probs, stoch = cols
        return ExperimentResult(
            chosen_idx=idxs.to(torch.int32),
            true_class=tcs.to(torch.int32),
            best_model=bests.to(torch.int32),
            regret=regrets,
            cumulative_regret=cums,
            select_prob=probs,
            regret_at_0=regret0,
            stochastic=stoch.any() | stoch0 | selector.always_stochastic,
        )

    return experiment


def _as_tensor(x) -> torch.Tensor:
    if isinstance(x, torch.Tensor):
        return x
    # a read-only array (e.g. a view of a JAX array) is copied first
    return torch.from_numpy(np.require(x, requirements="W"))


def run_seeds_compiled(selector_factory: Callable[[torch.Tensor], Selector],
                       preds, labels, iters: int = 100, seeds: int = 5,
                       loss_fn: Callable = accuracy_loss,
                       device: DeviceLike = None,
                       timings: Optional[list] = None) -> ExperimentResult:
    """All seeds of one method: the CLI's entry point.

    ``preds`` ``(H, N, C)`` and ``labels`` ``(N,)`` (tensors or numpy
    arrays) move to ``device`` (default: the card). The selector is built
    once by ``selector_factory(preds)``; seeds ``0..seeds-1`` then run one
    after another as single-replica experiments. Returns an
    :class:`ExperimentResult` with a leading ``(seeds,)`` axis.
    ``timings``: see :func:`build_experiment_fn` (one entry per seed).
    """
    dev = resolve_device(device)
    preds = _as_tensor(preds).to(dev, torch.float32)
    labels = _as_tensor(labels).to(dev)
    selector = selector_factory(preds)
    losses = compute_true_losses(preds, labels, loss_fn)
    exp = build_experiment_fn(selector, labels, losses, iters,
                              timings=timings)
    runs = [exp(trandom.PRNGKey(s)) for s in range(seeds)]
    return ExperimentResult(*(torch.stack(f) for f in zip(*runs)))
