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

With ``trace_k > 0`` each round also yields a :class:`RoundTrace`, the
flight recorder's provenance of the round (``telemetry/recorder.py``):
the recording run takes the unrecorded run's decisions, reads the values
the round computes, and keeps them on the device until the run ends.

With ``acq_batch = q > 1`` a round acquires q points from one scoring
pass and applies the q answers as one update (``selectors/batch.py``):
the decision fields carry a trailing ``(q,)`` axis and the cumulative
regret counts each round's regret q times (label-weighted, so budgets
line up with q = 1 runs). ``q = 1`` runs the one-label round unchanged.

Under a mesh (``mesh=``, ``parallel/mesh.py``) every rank runs the same
loop on its ``(H/b, N/a)`` block: ``preds`` and ``labels`` are the rank's
blocks, the selector picks global indices (items and models), the
oracle's answer is read on the rank that holds the item and sent to all
(``broadcast_from_owner``), and the true losses are this rank's models',
rank-order sums over the data group's blocks; the regret takes the best
loss over the model group and the chosen model's loss from its owner
(``oracle.regret_fn``). Every result is the same on every rank, the
recorder's :class:`RoundTrace` too (each rank's top k of its block at
global indices, merged over the data group; the chosen score read on the
rank that holds the pick; P(best) gathered over the model group). A
q-wide round runs there too: its q answers are read from their owners,
and the selector's q-wide pair is the mesh's (``selectors/batch.py``).
"""

from __future__ import annotations

import time
from typing import Callable, NamedTuple, Optional

import numpy as np
import torch

from coda_tpu_torch import random as trandom
from coda_tpu_torch.losses import accuracy_loss
from coda_tpu_torch.ops.masked import entropy2, top_k
from coda_tpu_torch.oracle import regret_fn
from coda_tpu_torch.oracle import true_losses as compute_true_losses
from coda_tpu_torch.parallel.collectives import broadcast_from_owner
from coda_tpu_torch.parallel.mesh import Mesh
from coda_tpu_torch.selectors.batch import resolve_batch_fns
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


class RoundTrace(NamedTuple):
    """Flight-recorder provenance of one labeling round (a leading round
    axis once stacked; the seed-batched engine's fields carry the replica
    axis first)."""

    round_key: torch.Tensor       # (2,) the round's key before its split
    topk_idx: torch.Tensor        # (k,) int64 — top-k candidate indices
    topk_score: torch.Tensor      # (k,) float32 — their acquisition scores
    chosen_score: torch.Tensor    # 0-d float32 — score of the picked point
    runner_up_gap: torch.Tensor   # 0-d float32 — top1 - top2 score margin
    pbest_max: torch.Tensor       # 0-d float32 — max of P(best); NaN when
    #                               the method exposes no posterior
    pbest_entropy: torch.Tensor   # 0-d float32 — entropy (bits) of P(best)
    surrogate_fallback: torch.Tensor  # 0-d bool — did the surrogate scorer
    #                               fall back to the full exact pass this
    #                               round (False for exact scorers)


class RunTraceAux(NamedTuple):
    """A run's round traces and the key material of its set-up."""

    trace: RoundTrace
    root_key: torch.Tensor    # (2,) PRNGKey(seed)
    init_key: torch.Tensor    # (2,) consumed by selector.init
    prior_key: torch.Tensor   # (2,) consumed by the round-0 best()


def _score_digest(res, trace_k: int, mesh: Optional[Mesh] = None) -> tuple:
    """``(topk_idx, topk_score, chosen_score, runner_up_gap)`` of a
    round's select result, over the last axis (a leading replica axis is
    kept). A method without a score vector records its chosen index and
    probability in slot 0 and -inf/-1 elsewhere, as the reference does.
    ``mesh``: ``res.scores`` is this rank's block of N (``res.idx``
    global); the top k and the chosen score are the unsharded ones, the
    same on every rank."""
    idx = res.idx.to(torch.int64)
    if res.scores is None:
        prob = res.prob.to(torch.float32)
        topk_score = torch.full(prob.shape + (trace_k,), float("-inf"),
                                device=prob.device)
        topk_score[..., 0] = prob
        topk_idx = torch.full(idx.shape + (trace_k,), -1, dtype=torch.int64,
                              device=idx.device)
        topk_idx[..., 0] = idx
        chosen = prob
    elif mesh is None:
        scores = res.scores.to(torch.float32)
        topk_score, topk_idx = top_k(scores, trace_k)
        chosen = scores.gather(-1, idx[..., None])[..., 0]
    else:
        scores = res.scores.to(torch.float32)
        topk_score, topk_idx = top_k(scores, trace_k, mesh)
        # read on the rank that holds the pick: (S, S) for a replica
        # axis (row i: every replica's score of replica i's pick)
        chosen = broadcast_from_owner(scores.movedim(-1, 0), idx, mesh)
        if idx.dim():
            chosen = torch.diagonal(chosen)
    gap = (topk_score[..., 0] - topk_score[..., 1] if trace_k >= 2
           else torch.zeros_like(chosen))
    return topk_idx, topk_score, chosen, gap


def _posterior_digest(selector: Selector, state_after,
                      like: torch.Tensor) -> tuple:
    """``(pbest_max, pbest_entropy)`` of the post-update posterior
    (``extras["get_pbest"]``); NaN, shaped ``like``, for a method without
    one."""
    get_pbest = selector.extras.get("get_pbest")
    if get_pbest is None:
        nan = torch.full_like(like, float("nan"))
        return nan, nan
    pb = get_pbest(state_after).to(torch.float32)
    if pb.dim() == 2:
        # one replica at a time: a batched reduction may sum in another
        # order than the one-seed run's
        return pb.amax(-1), torch.stack([entropy2(p) for p in pb])
    return pb.amax(-1), entropy2(pb)


def _first_pick(res):
    """A q-wide select result as its first pick (the unpenalised argmax),
    the round's "chosen" slot in the trace."""
    return res._replace(idx=res.idx[..., 0], prob=res.prob[..., 0])


def make_round_trace(selector: Selector, res, state_after, k: torch.Tensor,
                     trace_k: int, scored: Optional[tuple] = None,
                     mesh: Optional[Mesh] = None) -> RoundTrace:
    """One round's :class:`RoundTrace`. ``state_after`` is the post-update
    state (the posterior digest describes the round's outcome, aligned
    with its ``best_model``). ``scored`` is the score half
    (:func:`_score_digest`) when the caller took it before an in-place
    ``update``; it is computed from ``res`` (on ``mesh``) otherwise. The
    surrogate scorer's fallback flag is ``extras["scorer_round_stats"]``
    of the post-update state (False for a method without it). Under a
    mesh ``get_pbest`` returns every model's P(best) (gathered over the
    model group), so the posterior digest reduces the unsharded vector."""
    scored = _score_digest(res, trace_k, mesh) if scored is None else scored
    chosen = scored[2]
    pbest_max, pbest_entropy = _posterior_digest(selector, state_after,
                                                 chosen)
    stats_fn = selector.extras.get("scorer_round_stats")
    fallback = (stats_fn(state_after).to(torch.bool) if stats_fn is not None
                else torch.zeros_like(chosen, dtype=torch.bool))
    return RoundTrace(k, *scored, pbest_max, pbest_entropy, fallback)


def answer(labels: torch.Tensor, idx: torch.Tensor,
           mesh: Optional[Mesh] = None) -> torch.Tensor:
    """The oracle's labels of the items ``idx``; under a ``mesh`` read on
    the rank that holds each item (``labels`` is this rank's block)."""
    if mesh is None:
        return labels.take(idx)
    return broadcast_from_owner(labels, idx, mesh)


def make_step_fn(selector: Selector, labels: torch.Tensor,
                 model_losses: torch.Tensor, trace_k: int = 0,
                 acq_batch: int = 1, mesh: Optional[Mesh] = None):
    """One labeling round: ``(state, cum, key) -> (state, cum, outs)`` with
    ``outs = (idx, true_class, best, regret, cum, prob, stochastic)``, all
    0-d device tensors (``idx``, ``true_class``, ``prob`` ``(q,)`` under
    ``acq_batch = q > 1``, whose ``cum`` adds ``q * regret``);
    ``trace_k > 0`` appends the round's :class:`RoundTrace` (its scores
    read before ``update``, which may rewrite the state in place).
    ``mesh``: ``labels`` is this rank's block (:func:`answer`); the
    q-wide pair is the mesh's (:func:`~coda_tpu_torch.selectors.batch.
    resolve_batch_fns`)."""
    regret_of = regret_fn(model_losses, mesh)
    select, update = selector.select, selector.update
    first = (lambda r: r)
    if acq_batch > 1:
        select, update = resolve_batch_fns(selector, acq_batch, mesh)
        first = _first_pick

    def step(state, cum, k):
        k_sel, k_best = trandom.split(k)
        res = select(state, k_sel)
        scored = (_score_digest(first(res), trace_k, mesh) if trace_k
                  else None)
        tc = answer(labels, res.idx, mesh)
        state = update(state, res.idx, tc, res.prob)
        best, b_stoch = selector.best(state, k_best)
        regret = regret_of(best)
        # label-weighted: a round of q answers counts its regret q times
        cum = cum + (acq_batch * regret if acq_batch > 1 else regret)
        outs = (res.idx, tc, best, regret, cum, res.prob,
                res.stochastic | b_stoch)
        if trace_k:
            outs += (make_round_trace(selector, first(res), state, k,
                                      trace_k, scored, mesh),)
        return state, cum, outs

    return step


def make_batched_step_fn(selector: Selector, labels: torch.Tensor,
                         model_losses: torch.Tensor, trace_k: int = 0,
                         mesh: Optional[Mesh] = None):
    """One labeling round of all S replicas through ``selector.batched``:
    ``(state, cum (S,), keys (S, 2), round_keys=None) -> (state, cum,
    outs)``, ``keys`` the round's rows of ``select_keys`` on the device,
    ``outs`` as in :func:`make_step_fn` with each entry ``(S,)``;
    ``trace_k > 0`` appends the round's :class:`RoundTrace` with the
    replicas' ``round_keys`` (S, 2). ``mesh``: see :func:`make_step_fn`."""
    bsel = selector.batched
    if bsel is None:
        raise ValueError(f"selector {selector.name!r} has no seed-batched "
                         "form; run its seeds with build_experiment_fn")
    regret_of = regret_fn(model_losses, mesh)

    def step(state, cum, keys, round_keys=None):
        res = bsel.select(state, keys)
        scored = _score_digest(res, trace_k, mesh) if trace_k else None
        tc = answer(labels, res.idx, mesh)
        state = bsel.update(state, res.idx, tc, res.prob)
        best, b_stoch = bsel.best(state)
        regret = regret_of(best)
        cum = cum + regret
        outs = (res.idx, tc, best, regret, cum, res.prob,
                res.stochastic | b_stoch)
        if trace_k:
            outs += (make_round_trace(selector, res, state, round_keys,
                                      trace_k, scored, mesh),)
        return state, cum, outs

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


def _validate_rounds(selector: Selector, N: int, iters: int,
                     acq_batch: int = 1) -> None:
    """``iters`` rounds of ``acq_batch`` labels must fit the pool and any
    fixed label buffer (the reference's messages)."""
    n_labels = iters * acq_batch
    if n_labels > N:
        raise ValueError(
            f"iters={iters} x acq_batch={acq_batch} = {n_labels} labels "
            f"exceeds the {N} labelable points; the unlabeled set would "
            "be exhausted mid-run")
    budget = selector.hyperparams.get("budget")
    if budget is not None and n_labels > budget:
        raise ValueError(
            f"selector '{selector.name}' has a fixed label buffer of "
            f"{budget} but iters={iters} x acq_batch={acq_batch} = "
            f"{n_labels} labels; rebuild it with budget >= {n_labels}")


def _trace_k(trace_k: int, N: int) -> int:
    return max(1, min(int(trace_k), N)) if trace_k else 0


def _stack_trace(traces: list, dim: int = 0) -> RoundTrace:
    """A run's per-round traces stacked along a round axis at ``dim``."""
    return RoundTrace(*(torch.stack(f, dim) for f in zip(*traces)))


def build_experiment_fn(selector: Selector, labels: torch.Tensor,
                        model_losses: torch.Tensor, iters: int = 100,
                        timings: Optional[list] = None, trace_k: int = 0,
                        acq_batch: int = 1, mesh: Optional[Mesh] = None
                        ) -> Callable[[torch.Tensor], ExperimentResult]:
    """``key -> ExperimentResult`` for one seed; with ``trace_k > 0``,
    ``key -> (ExperimentResult, RunTraceAux)`` (the same decisions, the
    flight recorder's top-``trace_k`` scores of every round).

    ``timings``: when a list is given, each call appends ``{"init_ms",
    "rounds_ms"}`` measured on the host clock with the device synchronised
    at the phase boundaries (two synchronisations per seed). ``acq_batch``:
    labels a round (:func:`make_step_fn`). ``mesh``: ``labels`` is this
    rank's block."""
    regret_of = regret_fn(model_losses, mesh)
    n_items = labels.shape[0] * (mesh.data if mesh is not None else 1)
    _validate_rounds(selector, n_items, iters, acq_batch)
    trace_k = _trace_k(trace_k, n_items)
    step = make_step_fn(selector, labels, model_losses, trace_k=trace_k,
                        acq_batch=acq_batch, mesh=mesh)
    dev = labels.device
    _sync = _synchronizer(dev)

    def experiment(key: torch.Tensor):
        k_init, k_prior, k_scan = trandom.split(key, 3)
        if timings is not None:
            _sync()
            t0 = time.perf_counter()
        state = selector.init(k_init)
        best0, stoch0 = selector.best(state, k_prior)
        regret0 = regret_of(best0)
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
        cols = [torch.stack(c) for c in zip(*(o[:7] for o in outs))]
        idxs, tcs, bests, regrets, cums, probs, stoch = cols
        result = ExperimentResult(
            chosen_idx=idxs.to(torch.int32),
            true_class=tcs.to(torch.int32),
            best_model=bests.to(torch.int32),
            regret=regrets,
            cumulative_regret=cums,
            select_prob=probs,
            regret_at_0=regret0,
            stochastic=stoch.any() | stoch0 | selector.always_stochastic,
        )
        if not trace_k:
            return result
        return result, RunTraceAux(_stack_trace([o[7] for o in outs]),
                                   key, k_init, k_prior)

    return experiment


def build_recording_experiment_fn(selector: Selector, labels: torch.Tensor,
                                  model_losses: torch.Tensor,
                                  iters: int = 100, trace_k: int = 8,
                                  acq_batch: int = 1):
    """``key -> (ExperimentResult, RunTraceAux)``: the flight-recorder
    form of :func:`build_experiment_fn` under the reference's name — the
    same decisions, with every round's :class:`RoundTrace` (at least one
    candidate a round, as the reference clamps ``trace_k``)."""
    return build_experiment_fn(selector, labels, model_losses, iters,
                               trace_k=max(1, int(trace_k)),
                               acq_batch=acq_batch)


def build_batched_experiment_fn(selector: Selector, labels: torch.Tensor,
                                model_losses: torch.Tensor, iters: int = 100,
                                timings: Optional[list] = None,
                                trace_k: int = 0, mesh: Optional[Mesh] = None
                                ) -> Callable[[torch.Tensor], ExperimentResult]:
    """``keys (S, 2) -> ExperimentResult`` with a leading ``(S,)`` axis:
    all S seeds in one round loop through ``selector.batched``; with
    ``trace_k > 0`` also the :class:`RunTraceAux` of every seed (leading
    axis S).

    Each seed's key schedule is the single-seed one of
    :func:`build_experiment_fn`, computed for every seed and round on the
    host before the loop; the keys the rounds draw from are uploaded to the
    device once. ``timings``: one ``{"init_ms", "rounds_ms"}`` entry for
    the whole batch (host clock, device synchronised at the phase
    boundaries)."""
    n_items = labels.shape[0] * (mesh.data if mesh is not None else 1)
    trace_k = _trace_k(trace_k, n_items)
    step = make_batched_step_fn(selector, labels, model_losses,
                                trace_k=trace_k, mesh=mesh)
    bsel = selector.batched
    regret_of = regret_fn(model_losses, mesh)
    _validate_rounds(selector, n_items, iters)
    dev = labels.device
    _sync = _synchronizer(dev)

    def experiment(keys: torch.Tensor):
        S = keys.shape[0]
        sel_keys = batched_select_keys(selector, keys, iters, dev)
        k_init, k_prior, k_scan = trandom.split(keys, 3).unbind(1)
        round_keys = trandom.split(k_scan, iters).transpose(0, 1)  # (T, S, 2)
        if timings is not None:
            _sync()
            t0 = time.perf_counter()
        state = bsel.init(S)
        best0, stoch0 = bsel.best(state)
        regret0 = regret_of(best0)
        if timings is not None:
            _sync()
            t1 = time.perf_counter()
        cum = torch.zeros(S, dtype=torch.float32, device=dev)
        outs = []
        for t in range(iters):
            state, cum, o = step(state, cum, sel_keys[t], round_keys[t])
            outs.append(o)
        if timings is not None:
            _sync()
            t2 = time.perf_counter()
            timings.append({"init_ms": 1e3 * (t1 - t0),
                            "rounds_ms": 1e3 * (t2 - t1)})
        cols = [torch.stack(c, dim=1) for c in zip(*(o[:7] for o in outs))]
        idxs, tcs, bests, regrets, cums, probs, stoch = cols   # (S, T)
        result = ExperimentResult(
            chosen_idx=idxs.to(torch.int32),
            true_class=tcs.to(torch.int32),
            best_model=bests.to(torch.int32),
            regret=regrets,
            cumulative_regret=cums,
            select_prob=probs,
            regret_at_0=regret0,
            stochastic=stoch.any(1) | stoch0 | selector.always_stochastic,
        )
        if not trace_k:
            return result
        return result, RunTraceAux(_stack_trace([o[7] for o in outs], 1),
                                   keys, k_init, k_prior)

    return experiment


def make_batched_experiment_fn(selector_factory: Callable[[torch.Tensor],
                                                          Selector],
                               iters: int, loss_fn: Callable = accuracy_loss,
                               timings: Optional[list] = None,
                               trace_k: int = 0, acq_batch: int = 1,
                               mesh: Optional[Mesh] = None):
    """``(preds, labels, keys (S, 2)) -> ExperimentResult`` with a leading
    seed axis, under the reference's name; with ``trace_k > 0``,
    ``(ExperimentResult, RunTraceAux)``, both with the seed axis.

    The selector is built once by ``selector_factory(preds)``. A width-1
    batch runs as one single-replica experiment, as the reference skips
    its ``vmap`` there; S > 1 seeds run as one batch where the selector
    has a seed-batched form and ``acq_batch`` is 1, else one after
    another. ``timings``: see
    :func:`build_experiment_fn` (one entry per seed) and
    :func:`build_batched_experiment_fn` (one for the batch).

    ``mesh``: ``preds`` and ``labels`` are this rank's blocks of N, and
    the factory is called as ``selector_factory(preds, mesh=mesh)``."""

    def fn(preds, labels, keys):
        sel = (selector_factory(preds) if mesh is None
               else selector_factory(preds, mesh=mesh))
        losses = compute_true_losses(preds, labels, loss_fn, mesh=mesh)
        return _run_keys(sel, labels, losses, keys, iters, timings=timings,
                         trace_k=trace_k, acq_batch=acq_batch, mesh=mesh)

    return fn


def _run_keys(sel: Selector, labels: torch.Tensor, losses: torch.Tensor,
              keys: torch.Tensor, iters: int, timings: Optional[list] = None,
              trace_k: int = 0, acq_batch: int = 1,
              mesh: Optional[Mesh] = None):
    """Every seed of ``keys (S, 2)`` through ``sel``: one batch where
    :func:`seeds_batch` allows and S > 1, else one after another; the
    result (and with ``trace_k > 0`` its :class:`RunTraceAux`) with a
    leading seed axis."""
    if keys.shape[0] > 1 and seeds_batch(sel, acq_batch):
        return build_batched_experiment_fn(sel, labels, losses, iters,
                                           timings=timings, trace_k=trace_k,
                                           mesh=mesh)(keys)
    exp = build_experiment_fn(sel, labels, losses, iters, timings=timings,
                              trace_k=trace_k, acq_batch=acq_batch, mesh=mesh)
    runs = [exp(k) for k in keys]
    if not trace_k:
        return ExperimentResult(*(torch.stack(f) for f in zip(*runs)))
    results, auxes = zip(*runs)
    aux = RunTraceAux(
        _stack_trace([a.trace for a in auxes]),
        *(torch.stack(f) for f in list(zip(*auxes))[1:]))
    return (ExperimentResult(*(torch.stack(f) for f in zip(*results))), aux)


def seeds_batch(selector: Selector, acq_batch: int = 1) -> bool:
    """Whether more than one seed of ``selector`` runs as one batch: it
    has a seed-batched form and a round takes one label. A q-wide round
    has none: a batch would refresh each replica's q class rows on its
    own (seed 0 bitwise its one-seed run), and such a batch ran slower on
    the card than the seeds in turn."""
    return selector.batched is not None and acq_batch == 1


def _as_tensor(x) -> torch.Tensor:
    if isinstance(x, torch.Tensor):
        return x
    # a read-only array (e.g. a view of a JAX array) is copied first
    return torch.from_numpy(np.require(x, requirements="W"))


def key_bits(k) -> torch.Tensor:
    """A key's raw words. The port's keys are raw ``(..., 2)`` words
    already (``random.PRNGKey``), so this is the identity; the reference
    unwraps JAX's typed keys here."""
    return torch.as_tensor(k, dtype=torch.int64)


def _dataset_tensors(dataset, loss_fn: Callable, model_losses):
    """``(labels, model_losses)`` of ``dataset`` on the device of its
    ``preds`` tensor: the true losses computed from the whole task unless
    the caller passes them."""
    dev = dataset.preds.device
    labels = _as_tensor(dataset.labels).to(dev)
    if model_losses is None:
        model_losses = compute_true_losses(dataset.preds, labels, loss_fn)
    return labels, _as_tensor(model_losses).to(dev)


def run_experiment(selector: Selector, dataset, iters: int = 100,
                   seed: int = 0, loss_fn: Callable = accuracy_loss,
                   model_losses=None) -> ExperimentResult:
    """One seed of the labeling experiment through an already built
    ``selector`` (the reference's entry point): the result of
    :func:`build_experiment_fn` at ``PRNGKey(seed)``. ``dataset`` has a
    ``preds`` tensor on the selector's device, and ``labels``."""
    labels, losses = _dataset_tensors(dataset, loss_fn, model_losses)
    return build_experiment_fn(selector, labels, losses, iters)(
        trandom.PRNGKey(seed))


def run_seeds(selector: Selector, dataset, iters: int = 100, seeds: int = 5,
              loss_fn: Callable = accuracy_loss, model_losses=None
              ) -> ExperimentResult:
    """Seeds ``0..seeds-1`` through an already built ``selector``, with a
    leading ``(seeds,)`` axis: one batch with a replica axis where the
    selector has a seed-batched form (:func:`seeds_batch`), as
    :func:`make_batched_experiment_fn` runs them, else one after another.
    Replica s is bitwise :func:`run_experiment` at ``seed=s``."""
    labels, losses = _dataset_tensors(dataset, loss_fn, model_losses)
    keys = torch.stack([trandom.PRNGKey(s) for s in range(seeds)])
    return _run_keys(selector, labels, losses, keys, iters)


def _engine_cost_name(preds, seeds: int, iters: int, factory, label,
                      recorded: bool, acq_batch: int) -> str:
    """The cost book's name of an engine entry (the reference's):
    ``engine/run_seeds/<method>/<H>x<N>x<C>/s<seeds>x<iters>[/q<q>][/rec]``."""
    if label is None:
        label = getattr(factory, "__name__", None) or "anon"
    shape = "x".join(str(int(s)) for s in preds.shape)
    return (f"engine/run_seeds/{label}/{shape}/s{seeds}x{iters}"
            + (f"/q{acq_batch}" if acq_batch > 1 else "")
            + ("/rec" if recorded else ""))


def run_seeds_compiled(selector_factory: Callable[[torch.Tensor], Selector],
                       preds, labels, iters: int = 100, seeds: int = 5,
                       loss_fn: Callable = accuracy_loss,
                       device: DeviceLike = None,
                       timings: Optional[list] = None,
                       trace_k: int = 0, acq_batch: int = 1,
                       cost_label: Optional[str] = None,
                       mesh: Optional[Mesh] = None
                       ) -> ExperimentResult:
    """All seeds of one method: the CLI's entry point.

    ``preds`` ``(H, N, C)`` and ``labels`` ``(N,)`` (tensors or numpy
    arrays) move to ``device`` (default: the card). Seeds ``0..seeds-1``
    run through :func:`make_batched_experiment_fn`: one batch of all seeds
    where the selector has a seed-batched form and ``seeds > 1``, else one
    after another. Returns an :class:`ExperimentResult` with a leading
    ``(seeds,)`` axis (and its :class:`RunTraceAux` with ``trace_k > 0``).
    ``timings``: one entry per seed when seeds run one after another, one
    for the whole batch otherwise. ``acq_batch``: labels a round (``iters``
    counts rounds). ``cost_label`` (the CLI's method name): harvest the
    run's analytic kernel cost into the cost book
    (``telemetry/costs.aot_call``; host counters only).

    ``mesh``: ``preds`` and ``labels`` are this rank's blocks of N
    (``parallel.shard_preds``), placed on the mesh's device; every rank
    calls this with the same arguments and gets the same result.
    """
    dev = mesh.device if mesh is not None else resolve_device(device)
    preds = _as_tensor(preds).to(dev, torch.float32)
    labels = _as_tensor(labels).to(dev)
    keys = torch.stack([trandom.PRNGKey(s) for s in range(seeds)])
    fn = make_batched_experiment_fn(selector_factory, iters, loss_fn,
                                    timings=timings, trace_k=trace_k,
                                    acq_batch=acq_batch, mesh=mesh)
    if cost_label is None:
        return fn(preds, labels, keys)
    from coda_tpu_torch.telemetry.costs import aot_call

    return aot_call(fn, (preds, labels, keys), _engine_cost_name(
        preds, seeds, iters, selector_factory, cost_label, bool(trace_k),
        acq_batch), site="engine")


def run_seeds_recorded(selector_factory: Callable[[torch.Tensor], Selector],
                       preds, labels, iters: int = 100, seeds: int = 5,
                       loss_fn: Callable = accuracy_loss, trace_k: int = 8,
                       device: DeviceLike = None,
                       timings: Optional[list] = None, acq_batch: int = 1,
                       cost_label: Optional[str] = None,
                       mesh: Optional[Mesh] = None):
    """:func:`run_seeds_compiled` with the flight recorder on: returns
    ``(ExperimentResult, RunTraceAux)``, both with a leading seed axis,
    the decisions those of the unrecorded run (under a ``mesh`` the same
    on every rank)."""
    return run_seeds_compiled(selector_factory, preds, labels, iters=iters,
                              seeds=seeds, loss_fn=loss_fn, device=device,
                              timings=timings, trace_k=max(1, int(trace_k)),
                              acq_batch=acq_batch, cost_label=cost_label,
                              mesh=mesh)
