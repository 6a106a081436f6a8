"""Experiment loop: the labeling rounds on the card (counterpart of
``coda_tpu/engine/loop.py``).

The reference compiles a whole experiment into one ``lax.scan`` and
batches seeds under ``vmap``. Here an experiment is a Python loop of
rounds over device-resident state. Seeds run as one batch where the
selector has a seed-batched form (``Selector.batched``): one loop over a
state with a leading replica axis S, each round one pass for all S seeds
(:func:`build_batched_experiment_fn`). Otherwise — one seed, or a
selector without a batched form — seeds run one after another, each a
single-replica experiment (:func:`build_experiment_fn`). The key schedule
is the reference's — ``PRNGKey(seed)`` split into init/prior/scan keys,
the scan key split once per round, each round key split into select/best
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


def make_batched_step_fn(selector: Selector, labels: torch.Tensor,
                         model_losses: torch.Tensor):
    """One labeling round of all S replicas through ``selector.batched``:
    ``(state, cum (S,), keys (S, 2)) -> (state, cum, outs)``, ``keys`` the
    round's rows of ``select_keys`` on the device, ``outs`` as in
    :func:`make_step_fn` with each entry ``(S,)``."""
    bsel = selector.batched
    if bsel is None:
        raise ValueError(f"selector {selector.name!r} has no seed-batched "
                         "form; run its seeds with build_experiment_fn")
    best_loss = model_losses.min()

    def step(state, cum, keys):
        res = bsel.select(state, keys)
        tc = labels.take(res.idx)
        state = bsel.update(state, res.idx, tc, res.prob)
        best, b_stoch = bsel.best(state)
        regret = model_losses.take(best) - best_loss
        cum = cum + regret
        return state, cum, (res.idx, tc, best, regret, cum, res.prob,
                            res.stochastic | b_stoch)

    return step


def batched_select_keys(selector: Selector, keys: torch.Tensor, iters: int,
                        device) -> torch.Tensor:
    """The keys every round of every replica's select draws from,
    ``(iters, S, 2)`` on ``device``: seed s's schedule of
    :func:`build_experiment_fn` (``keys[s]`` split into init/prior/scan
    keys, the scan key once per round, each round key into select/best
    keys), computed on the host and uploaded once."""
    k_scan = trandom.split(keys, 3)[:, 2]                        # (S, 2)
    k_sel = trandom.split(trandom.split(k_scan, iters))[..., 0, :]
    return selector.batched.select_keys(k_sel).transpose(0, 1) \
        .contiguous().to(device)


def _synchronizer(dev: torch.device) -> Callable[[], None]:
    def sync():
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)
    return sync


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
    _sync = _synchronizer(dev)

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


def build_batched_experiment_fn(selector: Selector, labels: torch.Tensor,
                                model_losses: torch.Tensor, iters: int = 100,
                                timings: Optional[list] = None
                                ) -> Callable[[torch.Tensor], ExperimentResult]:
    """``keys (S, 2) -> ExperimentResult`` with a leading ``(S,)`` axis:
    all S seeds in one round loop through ``selector.batched``.

    Each seed's key schedule is the single-seed one of
    :func:`build_experiment_fn`, computed for every seed and round on the
    host before the loop; the keys the rounds draw from are uploaded to the
    device once. ``timings``: one ``{"init_ms", "rounds_ms"}`` entry for
    the whole batch (host clock, device synchronised at the phase
    boundaries)."""
    step = make_batched_step_fn(selector, labels, model_losses)
    bsel = selector.batched
    best_loss = model_losses.min()
    _validate_rounds(labels.shape[0], iters)
    dev = labels.device
    _sync = _synchronizer(dev)

    def experiment(keys: torch.Tensor) -> ExperimentResult:
        S = keys.shape[0]
        sel_keys = batched_select_keys(selector, keys, iters, dev)
        if timings is not None:
            _sync()
            t0 = time.perf_counter()
        state = bsel.init(S)
        best0, stoch0 = bsel.best(state)
        regret0 = model_losses.take(best0) - best_loss
        if timings is not None:
            _sync()
            t1 = time.perf_counter()
        cum = torch.zeros(S, dtype=torch.float32, device=dev)
        outs = []
        for t in range(iters):
            state, cum, o = step(state, cum, sel_keys[t])
            outs.append(o)
        if timings is not None:
            _sync()
            t2 = time.perf_counter()
            timings.append({"init_ms": 1e3 * (t1 - t0),
                            "rounds_ms": 1e3 * (t2 - t1)})
        cols = [torch.stack(c, dim=1) for c in zip(*outs)]      # (S, T)
        idxs, tcs, bests, regrets, cums, probs, stoch = cols
        return ExperimentResult(
            chosen_idx=idxs.to(torch.int32),
            true_class=tcs.to(torch.int32),
            best_model=bests.to(torch.int32),
            regret=regrets,
            cumulative_regret=cums,
            select_prob=probs,
            regret_at_0=regret0,
            stochastic=stoch.any(1) | stoch0 | selector.always_stochastic,
        )

    return experiment


def make_batched_experiment_fn(selector_factory: Callable[[torch.Tensor],
                                                          Selector],
                               iters: int, loss_fn: Callable = accuracy_loss,
                               timings: Optional[list] = None):
    """``(preds, labels, keys (S, 2)) -> ExperimentResult`` with a leading
    seed axis, under the reference's name.

    The selector is built once by ``selector_factory(preds)``. A width-1
    batch runs as one single-replica experiment, as the reference skips
    its ``vmap`` there; S > 1 seeds run as one batch where the selector
    has a seed-batched form, else one after another. ``timings``: see
    :func:`build_experiment_fn` (one entry per seed) and
    :func:`build_batched_experiment_fn` (one for the batch)."""
    def fn(preds, labels, keys):
        sel = selector_factory(preds)
        losses = compute_true_losses(preds, labels, loss_fn)
        if keys.shape[0] > 1 and sel.batched is not None:
            return build_batched_experiment_fn(sel, labels, losses, iters,
                                               timings=timings)(keys)
        exp = build_experiment_fn(sel, labels, losses, iters,
                                  timings=timings)
        runs = [exp(k) for k in keys]
        return ExperimentResult(*(torch.stack(f) for f in zip(*runs)))

    return fn


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
    arrays) move to ``device`` (default: the card). Seeds ``0..seeds-1``
    run through :func:`make_batched_experiment_fn`: one batch of all seeds
    where the selector has a seed-batched form and ``seeds > 1``, else one
    after another. Returns an :class:`ExperimentResult` with a leading
    ``(seeds,)`` axis. ``timings``: one entry per seed when seeds run one
    after another, one for the whole batch otherwise.
    """
    dev = resolve_device(device)
    preds = _as_tensor(preds).to(dev, torch.float32)
    labels = _as_tensor(labels).to(dev)
    keys = torch.stack([trandom.PRNGKey(s) for s in range(seeds)])
    fn = make_batched_experiment_fn(selector_factory, iters, loss_fn,
                                    timings=timings)
    return fn(preds, labels, keys)
