"""The crowd experiment loop: the joint (model, annotator) posterior rounds
(counterpart of ``coda_tpu/crowd/loop.py``).

The engine's round is ``select -> oracle -> update -> best`` with the
oracle a table lookup. Here the oracle is a crowd: the chosen point's TRUE
label seeds a deterministic vote draw from the annotator pool, the
Dawid-Skene reliability posterior aggregates the votes into an applied
label and a reliability weight, and the selector's weighted update
(``update_w``, or the q-wide ``update_qw``) applies it. The reliability
posterior rides next to the model posterior on the device; no round reads
a value back to the host.

The key schedule is the engine's exactly (``engine/loop.py``): the vote
randomness comes from ``fold_in(round key, CROWD_SALT + j)``, a key the
plain program never consumes, so select and best see the clean run's
stream. A run's vote draws (annotator ids, Gumbel noise, abstentions)
depend on its keys alone: they are drawn on the host for every round
before the first and uploaded once (:func:`run_draws`), as the seed-batched
engine uploads its select keys; a round turns its draws and the true class
into responses on the device.

Seeds run the way the engine runs them (``engine/loop.seeds_batch``): as
one batch where the selector has a seed-batched form with a weighted
update and a round takes one label, else one after another. In a batch the
responses are drawn for every replica at once and each replica's votes
are aggregated on its own reliability state, so seed s of a batch is
bitwise its one-seed run. **A clean config runs the engine's own
program** (``build_experiment_fn``, ``make_batched_experiment_fn``), with
``CrowdAux = None``.
"""

from __future__ import annotations

import time
from typing import Callable, NamedTuple, Optional

import torch

from coda_tpu_torch import random as trandom
from coda_tpu_torch.crowd.oracle import (
    CROWD_SALT,
    CrowdConfig,
    VoteDraws,
    draw_votes,
    log_confusions,
    make_annotators,
    votes_from_draws,
)
from coda_tpu_torch.crowd.reliability import (
    ReliabilityState,
    aggregate_votes,
    annotator_accuracy,
    init_reliability,
)
from coda_tpu_torch.engine.loop import (
    ExperimentResult,
    RunTraceAux,
    _as_tensor,
    _engine_cost_name,
    _first_pick,
    _score_digest,
    _stack_trace,
    _synchronizer,
    _trace_k,
    _validate_rounds,
    batched_select_keys,
    build_experiment_fn,
    make_batched_experiment_fn,
    make_round_trace,
    seeds_batch,
)
from coda_tpu_torch.losses import accuracy_loss
from coda_tpu_torch.oracle import true_losses as compute_true_losses
from coda_tpu_torch.selectors.batch import resolve_batch_wfns
from coda_tpu_torch.selectors.protocol import Selector
from coda_tpu_torch.utils.platform import DeviceLike, resolve_device


class CrowdAux(NamedTuple):
    """Per-round crowd provenance (leading axis = round, after the seed
    axis of a run of seeds; with ``acq_batch`` q the first three carry a
    trailing (q,) answer axis)."""

    oracle_label: torch.Tensor        # ground-truth label of the chosen point
    applied_label: torch.Tensor       # the aggregated label the update saw
    label_weight: torch.Tensor        # its reliability weight in [0, 1]
    annotator_accuracy: torch.Tensor  # (T, A) posterior-mean accuracies


def _require_weighted(selector: Selector) -> None:
    if selector.update_w is None:
        raise ValueError(
            f"selector {selector.name!r} has no reliability-weighted "
            "update (update_w); the crowd oracle needs one — run the "
            "clean oracle instead")


def n_classes_of(labels) -> int:
    """The pool's class count, ``labels.max() + 1``, read on the host once
    before the rounds (the reference sizes its confusions the same way)."""
    return int(labels.max()) + 1


def run_draws(round_keys: torch.Tensor, cfg: CrowdConfig, n_classes: int,
              acq_batch: int, device) -> VoteDraws:
    """Every round's vote draws from the run's round keys ``(..., 2)`` (on
    the host), uploaded to ``device`` once: ``(..., V)``-shaped fields, or
    ``(..., q, V)`` at ``acq_batch`` q > 1 (answer j salted ``CROWD_SALT +
    j``)."""
    per_answer = [draw_votes(trandom.fold_in(round_keys, CROWD_SALT + j),
                             cfg, n_classes)
                  for j in range(acq_batch)]
    dim = round_keys.dim() - 1
    fields = (per_answer[0] if acq_batch == 1 else
              VoteDraws(*(torch.stack(f, dim) for f in zip(*per_answer))))
    return VoteDraws(*(f.to(device) for f in fields))


def _round(draws: VoteDraws, t: int) -> VoteDraws:
    return VoteDraws(*(f[t] for f in draws))


def make_crowd_step_fn(selector: Selector, labels: torch.Tensor,
                       model_losses: torch.Tensor, cfg: CrowdConfig,
                       confusions: torch.Tensor, trace_k: int = 0,
                       acq_batch: int = 1):
    """One crowd round: ``(state, rel, cum, key, draws) -> (state, rel,
    cum, outs)`` with ``draws`` the round's :class:`VoteDraws` on the
    device and ``outs`` the engine's (``true_class`` the applied label),
    the optional :class:`RoundTrace`, then the round's crowd fields: the
    true class, applied label, weight and the reliability counts (the
    run turns a round's counts into its :class:`CrowdAux` accuracies after
    the last round, :func:`_crowd_aux`). At ``acq_batch`` q > 1 the
    reliability posterior chains through the q answers in order."""
    assert not cfg.clean, "clean configs run the engine step"
    _require_weighted(selector)
    best_loss = model_losses.min()
    log_conf = log_confusions(confusions)

    def crowd_answer(rel, draws: VoteDraws, true_class):
        responses = votes_from_draws(draws, log_conf, true_class)
        return aggregate_votes(rel, draws.ann_ids, responses,
                               draws.answered, cfg)

    if acq_batch > 1:
        sel_q, upd_qw = resolve_batch_wfns(selector, acq_batch)

        def step_q(state, rel, cum, k, draws):
            k_sel, k_best = trandom.split(k)
            res = sel_q(state, k_sel)
            first = _first_pick(res)
            scored = _score_digest(first, trace_k) if trace_k else None
            tcs = labels.take(res.idx)                 # (q,) ground truth
            zs, ws = [], []
            for j in range(acq_batch):
                z_j, w_j, rel = crowd_answer(rel, _round(draws, j), tcs[j])
                zs.append(z_j)
                ws.append(w_j)
            applied, weights = torch.stack(zs), torch.stack(ws)
            state = upd_qw(state, res.idx, applied, res.prob, weights)
            best, b_stoch = selector.best(state, k_best)
            regret = model_losses.take(best) - best_loss
            cum = cum + acq_batch * regret             # label-weighted
            outs = (res.idx, applied, best, regret, cum, res.prob,
                    res.stochastic | b_stoch)
            if trace_k:
                outs += (make_round_trace(selector, first, state, k,
                                          trace_k, scored),)
            aux = (tcs, applied, weights, rel.counts)
            return state, rel, cum, outs + (aux,)

        return step_q

    def step(state, rel, cum, k, draws):
        k_sel, k_best = trandom.split(k)
        res = selector.select(state, k_sel)
        scored = _score_digest(res, trace_k) if trace_k else None
        tc = labels.take(res.idx)                      # ground truth
        applied, weight, rel = crowd_answer(rel, draws, tc)
        state = selector.update_w(state, res.idx, applied, res.prob, weight)
        best, b_stoch = selector.best(state, k_best)
        regret = model_losses.take(best) - best_loss
        cum = cum + regret
        outs = (res.idx, applied, best, regret, cum, res.prob,
                res.stochastic | b_stoch)
        if trace_k:
            outs += (make_round_trace(selector, res, state, k, trace_k,
                                      scored),)
        aux = (tc, applied, weight, rel.counts)
        return state, rel, cum, outs + (aux,)

    return step


def make_batched_crowd_step_fn(selector: Selector, labels: torch.Tensor,
                               model_losses: torch.Tensor, cfg: CrowdConfig,
                               confusions: torch.Tensor, trace_k: int = 0):
    """One crowd round of all S replicas through ``selector.batched``:
    ``(state, rels, cum (S,), keys (S, 2, 2), draws, round_keys=None) ->
    (state, rels, cum, outs)``, ``rels`` the S replicas' reliability
    states (a list), ``draws`` the round's ``(S, ...)`` draws. Responses
    are drawn for all replicas at once; each replica's votes aggregate on
    its own state; one weighted update applies the S answers."""
    bsel = selector.batched
    if bsel is None or bsel.update_w is None:
        raise ValueError(f"selector {selector.name!r} has no seed-batched "
                         "weighted update; run its seeds one after another")
    best_loss = model_losses.min()
    log_conf = log_confusions(confusions)

    def step(state, rels, cum, keys, draws, round_keys=None):
        res = bsel.select(state, keys)
        scored = _score_digest(res, trace_k) if trace_k else None
        tc = labels.take(res.idx)                      # (S,)
        responses = votes_from_draws(draws, log_conf, tc)   # (S, V)
        answers = [aggregate_votes(rel, draws.ann_ids[s], responses[s],
                                   draws.answered[s], cfg)
                   for s, rel in enumerate(rels)]
        applied = torch.stack([a[0] for a in answers])
        weights = torch.stack([a[1] for a in answers])
        rels = [a[2] for a in answers]
        state = bsel.update_w(state, res.idx, applied, res.prob, weights)
        best, b_stoch = bsel.best(state)
        regret = model_losses.take(best) - best_loss
        cum = cum + regret
        outs = (res.idx, applied, best, regret, cum, res.prob,
                res.stochastic | b_stoch)
        if trace_k:
            outs += (make_round_trace(selector, res, state, round_keys,
                                      trace_k, scored),)
        aux = (tc, applied, weights, torch.stack([r.counts for r in rels]))
        return state, rels, cum, outs + (aux,)

    return step


def _crowd_aux(auxes: list, dim: int) -> CrowdAux:
    """A run's per-round crowd fields stacked along the round axis; the
    rounds' posterior-mean accuracies from their reliability counts in one
    pass after the run (each round's bitwise its own)."""
    tcs, applied, weights, counts = (torch.stack(f, dim)
                                     for f in zip(*auxes))
    acc = annotator_accuracy(ReliabilityState(counts, None))
    return CrowdAux(tcs.to(torch.int32), applied.to(torch.int32),
                    weights.to(torch.float32), acc)


def _result(cols, regret0, stoch0, selector) -> ExperimentResult:
    idxs, tcs, bests, regrets, cums, probs, stoch = cols
    return ExperimentResult(
        chosen_idx=idxs.to(torch.int32),
        true_class=tcs.to(torch.int32),
        best_model=bests.to(torch.int32),
        regret=regrets,
        cumulative_regret=cums,
        select_prob=probs,
        regret_at_0=regret0,
        stochastic=(stoch.any(-1) if stoch.dim() > 1 else stoch.any())
        | stoch0 | selector.always_stochastic,
    )


def _crowd_experiment(selector: Selector, labels: torch.Tensor,
                      model_losses: torch.Tensor, cfg: CrowdConfig,
                      iters: int, trace_k: int, acq_batch: int,
                      timings: Optional[list]):
    """The single-replica driver behind both build_* variants: ``key ->
    (result, crowd)`` or, with ``trace_k``, ``(result, run_aux, crowd)``."""
    best_loss = model_losses.min()
    _validate_rounds(selector, labels.shape[0], iters, acq_batch)
    n_classes = n_classes_of(labels)
    dev = labels.device
    confusions = make_annotators(cfg, n_classes, dev)
    step = make_crowd_step_fn(selector, labels, model_losses, cfg,
                              confusions, trace_k=trace_k,
                              acq_batch=acq_batch)
    _sync = _synchronizer(dev)

    def experiment(key: torch.Tensor):
        k_init, k_prior, k_scan = trandom.split(key, 3)
        keys = trandom.split(k_scan, iters)
        draws = run_draws(keys, cfg, n_classes, acq_batch, dev)
        if timings is not None:
            _sync()
            t0 = time.perf_counter()
        state = selector.init(k_init)
        best0, stoch0 = selector.best(state, k_prior)
        regret0 = model_losses.take(best0) - best_loss
        rel = init_reliability(cfg, n_classes, dev)
        if timings is not None:
            _sync()
            t1 = time.perf_counter()
        cum = torch.zeros((), dtype=torch.float32, device=dev)
        outs = []
        for t in range(iters):
            state, rel, cum, o = step(state, rel, cum, keys[t],
                                      _round(draws, t))
            outs.append(o)
        if timings is not None:
            _sync()
            t2 = time.perf_counter()
            timings.append({"init_ms": 1e3 * (t1 - t0),
                            "rounds_ms": 1e3 * (t2 - t1)})
        cols = [torch.stack(c) for c in zip(*(o[:7] for o in outs))]
        result = _result(cols, regret0, stoch0, selector)
        crowd = _crowd_aux([o[-1] for o in outs], 0)
        if not trace_k:
            return result, crowd
        return (result, RunTraceAux(_stack_trace([o[7] for o in outs]),
                                    key, k_init, k_prior), crowd)

    return experiment


def build_crowd_experiment_fn(selector: Selector, labels: torch.Tensor,
                              model_losses: torch.Tensor, cfg: CrowdConfig,
                              iters: int = 100, acq_batch: int = 1,
                              timings: Optional[list] = None) -> Callable:
    """``key -> (ExperimentResult, CrowdAux)`` for one seed. A clean config
    returns ``(engine result, None)``: the engine's own program."""
    if cfg.clean:
        base = build_experiment_fn(selector, labels, model_losses, iters,
                                   timings=timings, acq_batch=acq_batch)
        return lambda key: (base(key), None)
    return _crowd_experiment(selector, labels, model_losses, cfg, iters,
                             trace_k=0, acq_batch=acq_batch, timings=timings)


def build_recording_crowd_experiment_fn(
        selector: Selector, labels: torch.Tensor,
        model_losses: torch.Tensor, cfg: CrowdConfig, iters: int = 100,
        trace_k: int = 8, acq_batch: int = 1,
        timings: Optional[list] = None) -> Callable:
    """``key -> (ExperimentResult, RunTraceAux, CrowdAux)``, the flight
    recorder's variant; a clean config runs the engine's recording
    program with ``CrowdAux = None``."""
    trace_k = _trace_k(max(1, int(trace_k)), labels.shape[0])
    if cfg.clean:
        base = build_experiment_fn(selector, labels, model_losses, iters,
                                   timings=timings, trace_k=trace_k,
                                   acq_batch=acq_batch)

        def clean(key):
            result, aux = base(key)
            return result, aux, None

        return clean
    return _crowd_experiment(selector, labels, model_losses, cfg, iters,
                             trace_k=trace_k, acq_batch=acq_batch,
                             timings=timings)


def build_batched_crowd_experiment_fn(selector: Selector,
                                      labels: torch.Tensor,
                                      model_losses: torch.Tensor,
                                      cfg: CrowdConfig, iters: int = 100,
                                      timings: Optional[list] = None,
                                      trace_k: int = 0) -> Callable:
    """``keys (S, 2) -> (ExperimentResult[, RunTraceAux], CrowdAux)``, all
    with a leading ``(S,)`` axis: the S seeds in one round loop through
    ``selector.batched`` (its weighted update). Each seed's key schedule
    and vote draws are its one-seed run's. ``timings``: one ``{"init_ms",
    "rounds_ms"}`` entry for the batch."""
    trace_k = _trace_k(trace_k, labels.shape[0])
    _validate_rounds(selector, labels.shape[0], iters)
    n_classes = n_classes_of(labels)
    dev = labels.device
    confusions = make_annotators(cfg, n_classes, dev)
    step = make_batched_crowd_step_fn(selector, labels, model_losses, cfg,
                                      confusions, trace_k=trace_k)
    bsel = selector.batched
    best_loss = model_losses.min()
    _sync = _synchronizer(dev)

    def experiment(keys: torch.Tensor):
        S = keys.shape[0]
        sel_keys = batched_select_keys(selector, keys, iters, dev)
        k_init, k_prior, k_scan = trandom.split(keys, 3).unbind(1)
        round_keys = trandom.split(k_scan, iters).transpose(0, 1)  # (T, S, 2)
        draws = run_draws(round_keys, cfg, n_classes, 1, dev)
        if timings is not None:
            _sync()
            t0 = time.perf_counter()
        state = bsel.init(S)
        best0, stoch0 = bsel.best(state)
        regret0 = model_losses.take(best0) - best_loss
        rels = [init_reliability(cfg, n_classes, dev) for _ in range(S)]
        if timings is not None:
            _sync()
            t1 = time.perf_counter()
        cum = torch.zeros(S, dtype=torch.float32, device=dev)
        outs = []
        for t in range(iters):
            state, rels, cum, o = step(state, rels, cum, sel_keys[t],
                                       _round(draws, t), round_keys[t])
            outs.append(o)
        if timings is not None:
            _sync()
            t2 = time.perf_counter()
            timings.append({"init_ms": 1e3 * (t1 - t0),
                            "rounds_ms": 1e3 * (t2 - t1)})
        cols = [torch.stack(c, dim=1) for c in zip(*(o[:7] for o in outs))]
        result = _result(cols, regret0, stoch0, selector)
        crowd = _crowd_aux([o[-1] for o in outs], 1)
        if not trace_k:
            return result, crowd
        return (result, RunTraceAux(_stack_trace([o[7] for o in outs], 1),
                                    keys, k_init, k_prior), crowd)

    return experiment


def crowd_seeds_batch(selector: Selector, acq_batch: int = 1) -> bool:
    """Whether more than one seed of a crowd run runs as one batch: the
    engine's rule (:func:`engine.loop.seeds_batch`) and a seed-batched
    weighted update."""
    return (seeds_batch(selector, acq_batch)
            and selector.batched.update_w is not None)


def make_batched_crowd_experiment_fn(
        selector_factory: Callable[[torch.Tensor], Selector],
        cfg: CrowdConfig, iters: int, loss_fn: Callable = accuracy_loss,
        timings: Optional[list] = None, trace_k: int = 0,
        acq_batch: int = 1):
    """``(preds, labels, keys (S, 2)) -> (ExperimentResult, CrowdAux |
    None)`` with a leading seed axis (``(ExperimentResult, RunTraceAux,
    CrowdAux | None)`` with ``trace_k > 0``): the crowd counterpart of
    :func:`engine.loop.make_batched_experiment_fn`, whose program a clean
    config runs."""
    if cfg.clean:
        base = make_batched_experiment_fn(selector_factory, iters, loss_fn,
                                          timings=timings, trace_k=trace_k,
                                          acq_batch=acq_batch)

        def clean(preds, labels, keys):
            out = base(preds, labels, keys)
            return (*out, None) if trace_k else (out, None)

        return clean

    def fn(preds, labels, keys):
        sel = selector_factory(preds)
        _require_weighted(sel)
        losses = compute_true_losses(preds, labels, loss_fn)
        if keys.shape[0] > 1 and crowd_seeds_batch(sel, acq_batch):
            return build_batched_crowd_experiment_fn(
                sel, labels, losses, cfg, iters, timings=timings,
                trace_k=trace_k)(keys)
        exp = (build_recording_crowd_experiment_fn(
                   sel, labels, losses, cfg, iters, trace_k=trace_k,
                   acq_batch=acq_batch, timings=timings)
               if trace_k else
               build_crowd_experiment_fn(sel, labels, losses, cfg, iters,
                                         acq_batch=acq_batch,
                                         timings=timings))
        runs = [exp(k) for k in keys]
        result = ExperimentResult(*(torch.stack(f) for f in
                                    zip(*(r[0] for r in runs))))
        crowd = CrowdAux(*(torch.stack(f) for f in
                           zip(*(r[-1] for r in runs))))
        if not trace_k:
            return result, crowd
        auxes = [r[1] for r in runs]
        aux = RunTraceAux(
            _stack_trace([a.trace for a in auxes]),
            *(torch.stack(f) for f in list(zip(*auxes))[1:]))
        return result, aux, crowd

    return fn


def _run_crowd(selector_factory, preds, labels, cfg, iters, seeds, loss_fn,
               trace_k, acq_batch, device, timings, cost_label):
    dev = resolve_device(device)
    preds = _as_tensor(preds).to(dev, torch.float32)
    labels = _as_tensor(labels).to(dev)
    keys = torch.stack([trandom.PRNGKey(s) for s in range(seeds)])
    fn = make_batched_crowd_experiment_fn(selector_factory, cfg, iters,
                                          loss_fn, timings=timings,
                                          trace_k=trace_k,
                                          acq_batch=acq_batch)
    if cost_label is None:
        return fn(preds, labels, keys)
    from coda_tpu_torch.telemetry.costs import aot_call

    name = _engine_cost_name(preds, seeds, iters, selector_factory,
                             cost_label, bool(trace_k), acq_batch)
    return aot_call(fn, (preds, labels, keys), name + "/crowd",
                    site="engine")


def run_seeds_crowd(selector_factory: Callable[[torch.Tensor], Selector],
                    preds, labels, cfg: CrowdConfig, iters: int = 100,
                    seeds: int = 5, loss_fn: Callable = accuracy_loss,
                    acq_batch: int = 1, device: DeviceLike = None,
                    timings: Optional[list] = None,
                    cost_label: Optional[str] = None):
    """All seeds of the crowd experiment on ``device`` (default: the
    card): ``(ExperimentResult, CrowdAux | None)``, seed axis leading.
    ``cost_label``: harvest the run's kernel cost, as
    ``engine.run_seeds_compiled`` does."""
    return _run_crowd(selector_factory, preds, labels, cfg, iters, seeds,
                      loss_fn, 0, acq_batch, device, timings, cost_label)


def run_seeds_crowd_recorded(selector_factory: Callable[[torch.Tensor],
                                                         Selector],
                             preds, labels, cfg: CrowdConfig,
                             iters: int = 100, seeds: int = 5,
                             loss_fn: Callable = accuracy_loss,
                             trace_k: int = 8, acq_batch: int = 1,
                             device: DeviceLike = None,
                             timings: Optional[list] = None,
                             cost_label: Optional[str] = None):
    """:func:`run_seeds_crowd` with the flight recorder on:
    ``(ExperimentResult, RunTraceAux, CrowdAux | None)``."""
    return _run_crowd(selector_factory, preds, labels, cfg, iters, seeds,
                      loss_fn, max(1, int(trace_k)), acq_batch, device,
                      timings, cost_label)
