"""In-process benchmark suite: all tasks x methods x seeds in one process
(counterpart of ``coda_tpu/engine/suite.py``).

The reference's source fans the sweep out as one cluster job per
task-method pair, each paying process start-up, data load and warm-up.
Here the whole sweep runs in one process on the card:

  * each method's experiment callable (``make_batched_experiment_fn``
    over a selector factory) is built once per configuration and width and
    reused for every task — the counterpart of the reference's compile
    cache, keyed as its ``_fn_for`` keys it; ``cold`` marks a key's first
    dispatch (which pays the kernels' first load);
  * **seed dedup**: seed 0 runs alone (the probe); the other seeds run only
    when the method reports that randomness mattered (reference
    ``main.py:128-130``). The probe (width 1) and the remaining seeds
    (width ``seeds - 1``) are separate programs, and the auto EIG tier sees
    each one's own width;
  * tasks are loaded one at a time, and every pair logs to the tracking
    store (``tracking/store.py``) in the reference's layout, so a rerun
    skips finished pairs and the reference's analysis SQL reads the
    database.

``run_batched`` takes groups of same-shape tasks and dispatches a
(group chunk, method) pair at a time, as the reference does. The reference
``vmap``s a chunk's tasks into one program; here the chunk's tasks run one
after another through the same per-task callables as ``run``, so its
results are bitwise ``run``'s (a deliberate difference: a stacked form
would change the auto tier's width and the reductions' order). As in the
reference it computes the remaining seeds of every task and discards them
for a deterministic probe. With ``devices=`` the dispatch loop goes to the
task-parallel scheduler (``engine/scheduler.py``).

ModelPicker's per-task ``epsilon`` (:data:`RUNTIME_HYPERPARAMS`) is an
argument of the callable, not part of its key: same-shape tasks with
different tuned values share one callable. With a ``record_dir`` every
pair's seed-0 probe is written as a flight-recorder record under
``<record_dir>/<family>__<method>/<task>/``, replayable with ``python -m
coda_tpu_torch.cli replay``. With a ``telemetry`` every dispatch is a
span on its device's lane (``device:<index>``) and each experiment
callable's first call per signature lands in the cost book
(``cost_capture``).

Under a mesh (``mesh=``, one process a rank) every rank runs ``run`` on
the same tasks: a task sharded over the mesh (``Dataset.mesh``) runs
through the mesh forms of the selectors, a task the mesh does not divide
(loaded unsharded) runs whole on every rank; rank 0 decides which pairs
a rerun skips (its store) and tells the others.
"""

from __future__ import annotations

import contextlib
import time
from dataclasses import dataclass, field
from typing import Callable, Optional, Sequence

import numpy as np
import torch

from coda_tpu_torch import random as trandom
from coda_tpu_torch.engine.loop import (
    ExperimentResult,
    make_batched_experiment_fn,
)
from coda_tpu_torch.losses import LOSS_FNS
from coda_tpu_torch.utils.platform import resolve_device

@dataclass
class PendingBatch:
    """One dispatched ``run_batched`` chunk awaiting its host harvest.

    ``r0``/``rest``/``aux`` hold a result per task (``rest`` None at one
    seed). Under scheduled placement they are pinned host copies issued
    with ``non_blocking=True`` and ``event`` is the CUDA event recorded
    after them: ``event.query()`` says whether the harvest would wait.
    Serial and CPU dispatches have no event (their results are ready)."""

    names: list
    method: str
    shape: tuple
    cold: bool
    r0: list
    rest: Optional[list]
    t_start: float          # perf_counter at dispatch
    device: object = None   # torch.device under scheduled placement
    lane: int = 0           # the device's index in the scheduler's list
    cost: float = 0.0       # scheduler's relative LPT weight
    heavy: bool = False     # memory-heavy (method has a batch_caps entry)
    t_end: float = field(default=0.0)  # set by harvest
    aux: Optional[list] = None   # flight-recorder RunTraceAux per task
    resolved: list = field(default_factory=list)  # per-task hyperparams
    event: object = None


def family_of(name: str) -> str:
    """Task-name family: the prefix before a trailing ``_<index>``
    (``domainnet_3`` -> ``domainnet``); a name without a numeric suffix is
    its own family. Shared by the warm profiles and the scheduler's LPT
    cost model."""
    fam, _, idx = name.rpartition("_")
    return fam if fam and idx.isdigit() else name


def _warm_profile(pairs) -> tuple[dict, dict]:
    """Per-method and per-family WARM seconds from the pair records
    (pairs that were not a key's first dispatch)."""
    per_method: dict = {}
    per_family: dict = {}
    for p in pairs:
        if p.get("cold"):
            continue
        fam = family_of(p["task"])
        per_method[p["method"]] = per_method.get(p["method"], 0.0) \
            + p["seconds"]
        per_family[fam] = per_family.get(fam, 0.0) + p["seconds"]
    return ({k: round(v, 3) for k, v in per_method.items()},
            {k: round(v, 3) for k, v in per_family.items()})


# Hyperparams passed to the experiment callable as ARGUMENTS instead of
# keying it: ModelPicker's per-task tuned epsilon (the reference's traced
# runtime scalar), so tasks with different tuned values share a callable
RUNTIME_HYPERPARAMS = {"model_picker": ("epsilon",)}


def _to_host(res):
    """A result's fields as host numpy arrays (waits for the device)."""
    return type(res)(*[x.cpu().numpy() if isinstance(x, torch.Tensor)
                       else np.asarray(x) for x in res])


def _pinned_copy(tree):
    """``tree``'s tensors copied into pinned host memory, ``non_blocking``
    (the copies run on the current stream; an event recorded after them
    tells when they are done)."""
    if isinstance(tree, torch.Tensor):
        out = torch.empty(tree.shape, dtype=tree.dtype, pin_memory=True)
        out.copy_(tree, non_blocking=True)
        return out
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        return type(tree)(*[_pinned_copy(x) for x in tree])
    if isinstance(tree, (list, tuple)):
        return type(tree)(_pinned_copy(x) for x in tree)
    return tree


class SuiteRunner:
    """Runs (task, method) pairs on ``device`` (default: the card),
    reusing each method's experiment callable across tasks."""

    def __init__(self, iters: int = 100, seeds: int = 5, loss: str = "acc",
                 dedup_seeds: bool = True, telemetry=None,
                 record_dir: Optional[str] = None, record_topk: int = 8,
                 cost_capture: bool = True, device=None, mesh=None):
        self.iters = iters
        self.seeds = seeds
        self.loss_fn = LOSS_FNS[loss]
        self._loss_name = loss
        self.device = resolve_device(device)
        self.record_dir = record_dir
        self.record_topk = int(record_topk)
        self.dedup_seeds = dedup_seeds
        # the world's mesh: its ranks agree on every skip (rank 0's store)
        self.mesh = mesh
        # an optional telemetry.Telemetry: every dispatch becomes a span on
        # its device lane, first dispatches feed the cold counter, and the
        # device memory is sampled after each harvest
        self.telemetry = telemetry
        # each experiment callable is a CostTracked (telemetry/costs.py):
        # its first call per argument signature lands in the cost book;
        # harvesting happens when this and the process switch are both on
        self.cost_capture = bool(cost_capture)
        self._digests: dict = {}   # task name -> dataset digest (hash once)
        self._jitted: dict = {}    # _fn_for key -> experiment callable
        # first dispatches seen, across run()/run_batched() calls, so a
        # warm rerun on one runner marks no pair cold
        self._seen_shapes: set = set()
        self._keys = torch.stack([trandom.PRNGKey(s) for s in range(seeds)])

    def _tele_cold(self, cold: bool) -> None:
        """Count a callable's first dispatch (the cold attribution)."""
        if cold and self.telemetry is not None:
            self.telemetry.counter(
                "suite_cold_dispatches_total",
                "Suite dispatches that were a callable's first (the "
                "kernels' first load)").inc()

    def _tele_span(self, name: str, device, t_start: float, t_end: float,
                   attrs: Optional[dict] = None) -> None:
        """One finished dispatch as a span on its device's lane
        (``device:<index>``), then that device's memory sampled (no-op
        without telemetry)."""
        tele = self.telemetry
        if tele is None:
            return
        dev = torch.device(self.device if device is None else device)
        tele.spans.record(name, lane=f"device:{dev.index or 0}",
                          t_start=t_start, t_end=t_end, attrs=attrs)
        tele.sample_devices([dev])

    def _dataset_digest(self, name: str, dataset=None):
        """The task's recorder digest (the whole task's under a mesh),
        computed once a task."""
        if name not in self._digests and dataset is not None:
            self._digests[name] = dataset.digest()
        return self._digests.get(name)

    def _write_record_stream(self, task: str, method: str, shape, result,
                             aux, resolved: Optional[dict],
                             n_parallel: int, dataset=None) -> Optional[str]:
        """One probe record into the per-(family, method) stream
        ``<record_dir>/<family>__<method>/<task>/``, the task's mesh among
        its knobs; under the runner's mesh rank 0 alone writes it (every
        rank recorded the same rounds)."""
        from coda_tpu_torch.telemetry.recorder import (
            RunRecord,
            environment_fingerprint,
            stream_dir,
        )

        if self.mesh is not None and self.mesh.rank != 0:
            return None
        digest = self._dataset_digest(task, dataset)
        knobs = dict(resolved or {})
        knobs.update(method=method, loss=self._loss_name, iters=self.iters,
                     n_parallel=n_parallel)
        mesh = getattr(dataset, "mesh", None)
        if mesh is not None:
            knobs["mesh"] = mesh.spec
        fp = environment_fingerprint(knobs=knobs, device=self.device)
        fp["dataset"] = {"name": task, "shape": list(shape),
                         "digest": digest}
        seeds_rec = int(np.asarray(result.chosen_idx).shape[0])
        rec = RunRecord.from_result(
            result, aux, fp,
            run={"task": task, "method": method, "iters": self.iters,
                 "loss": self._loss_name, "seeds": seeds_rec,
                 "stream": "suite"})
        out = stream_dir(self.record_dir, f"{family_of(task)}__{method}",
                         task)
        rec.save(out, registry=(self.telemetry.registry
                                if self.telemetry is not None else None))
        return out

    def _resolved_args(self, method: str, method_args: Optional[dict],
                       task_name: str) -> dict:
        """Method hyperparams with the task-dependent ones resolved
        (ModelPicker's tuned epsilon, :data:`TASK_EPS`)."""
        resolved = dict(method_args or {})
        if method == "model_picker" and "epsilon" not in resolved:
            from coda_tpu_torch.selectors import DEFAULT_EPS, TASK_EPS

            resolved["epsilon"] = TASK_EPS.get(task_name, DEFAULT_EPS)
        return resolved

    def _static_resolved(self, resolved: dict, method: str) -> dict:
        """The resolved hyperparams that key a callable (the runtime ones
        excluded)."""
        runtime = RUNTIME_HYPERPARAMS.get(method, ())
        return {k: v for k, v in resolved.items() if k not in runtime}

    def _extra_args(self, method: str, resolved: dict) -> tuple:
        """The runtime hyperparams of one task's call, as Python floats
        (what the single-task command line passes)."""
        return tuple(float(resolved[k])
                     for k in RUNTIME_HYPERPARAMS.get(method, ()))

    def _fn_for(self, method: str, method_args: Optional[dict],
                task_name: str, width: int = 1, record: bool = False,
                device=None, mesh=None):
        """The experiment callable ``(preds, labels, keys, *runtime) ->
        ExperimentResult`` (``(result, aux)`` with ``record``) of
        ``width`` seed replicas on ``device`` (default: the runner's).
        ``width`` keys the cache and is the auto tier's replica count;
        ``mesh``: the task's (its blocks of N), which keys it too."""
        from coda_tpu_torch.cli import build_selector_factory, parse_args

        dev = self.device if device is None else torch.device(device)
        runtime = RUNTIME_HYPERPARAMS.get(method, ())
        static = self._static_resolved(
            self._resolved_args(method, method_args, task_name), method)
        trace_k = self.record_topk if record else 0
        key = self._key(method, method_args, task_name, width, record, dev,
                        mesh)
        if key not in self._jitted:
            args = parse_args([])
            args.method = method
            args.loss = self._loss_name
            args.iters = self.iters
            args.seeds = width
            args.n_parallel = max(1, width)
            args.device = str(dev)
            args.mesh = mesh.spec if mesh is not None else None
            for k, v in static.items():
                setattr(args, k, v)
            if method == "model_picker" and "epsilon" in runtime:
                from coda_tpu_torch.selectors import make_modelpicker

                def fn(preds, labels, keys, eps):
                    return make_batched_experiment_fn(
                        lambda p, mesh=None: make_modelpicker(
                            p, epsilon=eps, device=dev, mesh=mesh),
                        self.iters, self.loss_fn,
                        trace_k=trace_k, mesh=mesh)(preds, labels, keys)
            else:
                fn = make_batched_experiment_fn(
                    build_selector_factory(args, task_name), self.iters,
                    self.loss_fn, trace_k=trace_k, mesh=mesh)
            if self.cost_capture:
                import hashlib

                from coda_tpu_torch.telemetry.costs import CostTracked

                label = f"suite/{method}/w{width}" + ("/rec" if trace_k
                                                      else "")
                if static:
                    # two configurations of a method keep their own entries
                    label += "/h" + hashlib.sha256(
                        repr(sorted(static.items())).encode()
                    ).hexdigest()[:6]
                fn = CostTracked(
                    fn, name=label, site="suite",
                    registry=(self.telemetry.registry
                              if self.telemetry is not None else None),
                    extra={"method": method, "width": width})
            self._jitted[key] = fn
        return self._jitted[key]

    def _key(self, method, method_args, task_name, width, record,
             dev, mesh=None) -> tuple:
        """The experiment callable's key: the method, its static resolved
        hyperparams, the width, the recorder's top-k, the device and the
        task's mesh."""
        static = self._static_resolved(
            self._resolved_args(method, method_args, task_name), method)
        return (method, tuple(sorted(static.items())), width,
                self.record_topk if record else 0, str(dev),
                None if mesh is None else mesh.spec)

    def _cold(self, *key_args) -> bool:
        """Whether this is the first dispatch of the callable's key."""
        key = self._key(*key_args)
        cold = key not in self._seen_shapes
        self._seen_shapes.add(key)
        return cold

    def run_one(self, method: str, dataset,
                method_args: Optional[dict] = None) -> ExperimentResult:
        """One task-method pair, every seed; an ``ExperimentResult`` of
        host arrays with a leading seed axis. Under ``dedup_seeds`` the
        seed-0 probe runs alone and a deterministic probe is broadcast;
        otherwise the remaining seeds run as their own program (the auto
        tier sees width ``seeds - 1`` there, 1 for the probe)."""
        resolved = self._resolved_args(method, method_args, dataset.name)
        extra = self._extra_args(method, resolved)
        record = bool(self.record_dir)
        dev = self.device
        mesh = getattr(dataset, "mesh", None)
        preds = dataset.preds.to(dev, torch.float32)
        labels = dataset.labels.to(dev)
        if self.dedup_seeds and self.seeds > 1:
            fn = self._fn_for(method, method_args, dataset.name, width=1,
                              record=record, mesh=mesh)
            r0 = fn(preds, labels, self._keys[:1], *extra)
            if record:
                r0, aux = r0
                self._write_record_stream(dataset.name, method,
                                          dataset.shape, r0, aux, resolved,
                                          n_parallel=1, dataset=dataset)
            r0 = _to_host(r0)
            if not bool(r0.stochastic[0]):
                return type(r0)(*[np.repeat(x, self.seeds, axis=0)
                                  for x in r0])
            rest_fn = self._fn_for(method, method_args, dataset.name,
                                   width=self.seeds - 1, mesh=mesh)
            rest = _to_host(rest_fn(preds, labels, self._keys[1:], *extra))
            return type(r0)(*[np.concatenate([a, b], axis=0)
                              for a, b in zip(r0, rest)])
        fn = self._fn_for(method, method_args, dataset.name,
                          width=self.seeds, record=record, mesh=mesh)
        res = fn(preds, labels, self._keys, *extra)
        if record:
            res, aux = res
            self._write_record_stream(dataset.name, method, dataset.shape,
                                      res, aux, resolved,
                                      n_parallel=self.seeds,
                                      dataset=dataset)
        return _to_host(res)

    def run(self, datasets: Sequence, methods: Sequence[str], store=None,
            force_rerun: bool = False, method_args: Optional[dict] = None,
            progress: Callable[[str], None] = print) -> dict:
        """The full sweep: ``{(task, method): ExperimentResult}``.

        ``datasets`` are Datasets or zero-argument loaders (loaded one at a
        time; Datasets are ordered by shape). With a tracking ``store``,
        finished pairs are skipped (the reference launcher's resume) and
        results land in the experiment -> parent -> seed-child layout the
        analysis SQL expects."""
        results: dict = {}
        datasets = sorted(
            datasets,
            key=lambda d: (0,) + tuple(d.shape) if hasattr(d, "shape")
            else (1,))
        t_start = time.perf_counter()
        t_load = 0.0
        t_compute = 0.0
        pairs: list = []
        for ds_or_loader in datasets:
            lazy = callable(ds_or_loader)
            t0 = time.perf_counter()
            ds = ds_or_loader() if lazy else ds_or_loader
            t_load += time.perf_counter() - t0
            for method in methods:
                if self._agreed(store is not None and not force_rerun
                                and _finished(store, ds.name, method,
                                              self.seeds)):
                    progress(f"skip {ds.name}/{method} (finished)")
                    continue
                dedup = self.dedup_seeds and self.seeds > 1
                cold = self._cold(method, method_args, ds.name,
                                  1 if dedup else self.seeds,
                                  bool(self.record_dir), self.device,
                                  getattr(ds, "mesh", None))
                self._tele_cold(cold)
                t0 = time.perf_counter()
                res = self.run_one(method, ds, method_args)
                t1 = time.perf_counter()
                dt = t1 - t0
                t_compute += dt
                self._tele_span(f"{ds.name}/{method}", None, t0, t1,
                                {"task": ds.name, "method": method,
                                 "cold": cold})
                pairs.append({"task": ds.name, "method": method,
                              "shape": list(ds.shape), "seconds": dt,
                              "cold": cold})
                progress(f"{ds.name}/{method}: {self.seeds} seeds x "
                         f"{self.iters} iters in {dt:.2f}s"
                         f"{' (first dispatch)' if cold else ''}")
                results[(ds.name, method)] = res
                if store is not None:
                    _log(store, ds.name, method, res, self.seeds, self.iters)
            if lazy:
                del ds
        total = time.perf_counter() - t_start
        warm_m, warm_f = _warm_profile(pairs)
        self.last_stats = {"total_s": total, "load_s": t_load,
                           "compute_s": t_compute,
                           "compute_device_s": t_compute, "pairs": pairs,
                           "per_method_warm_s": warm_m,
                           "per_family_warm_s": warm_f}
        progress(f"suite: {len(results)} task-method pairs in {total:.2f}s "
                 f"(compute {t_compute:.2f}s, data load {t_load:.2f}s)")
        return results

    def _agreed(self, flag: bool) -> bool:
        """``flag`` as rank 0 of the runner's mesh has it (every rank runs
        the same pairs); the flag itself without a mesh."""
        if self.mesh is None or self.mesh.size == 1:
            return flag
        from coda_tpu_torch.parallel.collectives import all_gather_stack

        t = torch.tensor(int(flag), dtype=torch.int32,
                         device=self.mesh.device)
        return bool(all_gather_stack(t, self.mesh, axis=None)[0])

    def run_batched(self, groups: Sequence[Sequence],
                    methods: Sequence[str], store=None,
                    force_rerun: bool = False,
                    method_args: Optional[dict] = None,
                    batch_caps: Optional[dict] = None,
                    progress: Callable[[str], None] = print, devices=None,
                    schedule: str = "lpt",
                    cost_profile: Optional[dict] = None,
                    max_inflight: int = 2, hosts=None) -> dict:
        """The sweep dispatched a (group chunk, method) at a time.

        ``groups``: lists of datasets-or-loaders; a group's tasks must share
        their (H, N, C) shape and resolve identical static hyperparams
        (ModelPicker's per-task epsilon rides along). Each chunk runs, task
        by task, the width-1 probe and the remaining seeds; a
        deterministic probe is broadcast and its remaining seeds dropped,
        so the results are bitwise ``run``'s. With a ``store`` only a
        group's unfinished tasks are dispatched. ``batch_caps`` maps a
        method to its most tasks a chunk (an int, or a callable ``(H, N,
        C) -> int``); a method with an entry is memory-heavy to the
        scheduler.

        ``devices`` (``'auto'`` = the visible CUDA devices, an int count,
        or a list) hands the loop to ``engine/scheduler.run_scheduled``:
        chunks placed on devices in ``schedule`` order (``lpt`` from
        ``cost_profile``, or ``fifo``), at most ``max_inflight`` queued a
        device, results harvested later; ``hosts`` adds the two-level
        fleet placement. Placement is a pure copy: the results are
        bitwise the serial path's."""
        if devices is not None:
            from coda_tpu_torch.engine.scheduler import run_scheduled

            return run_scheduled(
                self, groups, methods, store=store, force_rerun=force_rerun,
                method_args=method_args, batch_caps=batch_caps,
                progress=progress, devices=devices, schedule=schedule,
                cost_profile=cost_profile, max_inflight=max_inflight,
                hosts=hosts)
        results: dict = {}
        t_start = time.perf_counter()
        t_load = 0.0
        t_compute = 0.0
        pairs: list = []
        for group in groups:
            t0 = time.perf_counter()
            datasets = [d() if callable(d) else d for d in group]
            t_load += time.perf_counter() - t0
            names, planned = self._plan_group(
                datasets, methods, store, force_rerun, batch_caps, progress)
            for method, chunk in planned:
                pend = self._launch_batch(chunk, names, datasets, method,
                                          method_args, datasets[0].shape)
                self._harvest_batch(pend, store, pairs, results, progress)
                t_compute += pend.t_end - pend.t_start
        total = time.perf_counter() - t_start
        warm_m, warm_f = _warm_profile(pairs)
        self.last_stats = {"total_s": total, "load_s": t_load,
                           "compute_s": t_compute,
                           "compute_device_s": t_compute, "pairs": pairs,
                           "per_method_warm_s": warm_m,
                           "per_family_warm_s": warm_f,
                           "n_devices": 1, "schedule": "serial",
                           "device_timeline": {}, "occupancy": {}}
        progress(f"suite[batched]: {len(results)} task-method pairs in "
                 f"{total:.2f}s (compute {t_compute:.2f}s, data load "
                 f"{t_load:.2f}s)")
        return results

    def _plan_group(self, datasets, methods, store, force_rerun,
                    batch_caps, progress):
        """Validate one loaded group and enumerate its chunks as
        ``(method, todo_indices)``: the resume skip and the batch_caps
        split, shared by the serial loop and the scheduler's plan."""
        shapes = {tuple(d.shape) for d in datasets}
        if len(shapes) != 1:
            raise ValueError(
                f"run_batched group mixes shapes {sorted(shapes)}; "
                "group tasks by shape")
        names = [d.name for d in datasets]
        planned = []
        for method in methods:
            todo = [i for i, n in enumerate(names)
                    if force_rerun or not (store is not None and _finished(
                        store, n, method, self.seeds))]
            for i, n in enumerate(names):
                if i not in todo:
                    progress(f"skip {n}/{method} (finished)")
            if not todo:
                continue
            cap = (batch_caps or {}).get(method)
            if callable(cap):
                cap = cap(*datasets[0].shape)
            cap = cap or len(todo)
            planned += [(method, todo[j:j + cap])
                        for j in range(0, len(todo), cap)]
        return names, planned

    def _launch_batch(self, todo, names, datasets, method, method_args,
                      shape, device=None, lane: int = 0,
                      cost: float = 0.0) -> PendingBatch:
        """Dispatch one chunk: per task, its operands copied to ``device``
        (default: the runner's), the width-1 probe and the remaining
        seeds. On a CUDA device under placement the results are copied to
        pinned host memory without blocking and an event is recorded, so
        the call returns with the work queued."""
        resolved = [self._resolved_args(method, method_args, names[i])
                    for i in todo]
        statics = [self._static_resolved(r, method) for r in resolved]
        if any(s != statics[0] for s in statics[1:]):
            raise ValueError(
                f"run_batched: method {method!r} resolves different "
                f"static hyperparams across the group "
                f"{[names[i] for i in todo]}; run these tasks unbatched")
        dev = self.device if device is None else torch.device(device)
        names_m = [names[i] for i in todo]
        record = bool(self.record_dir)
        cold = self._cold(method, method_args, names_m[0], 1, record, dev)
        self._tele_cold(cold)
        if record:
            # hash each task once while its tensors are at hand
            for i in todo:
                self._dataset_digest(names[i], datasets[i])
        t0 = time.perf_counter()
        probe_fn = self._fn_for(method, method_args, names_m[0], width=1,
                                record=record, device=dev)
        rest_fn = (self._fn_for(method, method_args, names_m[0],
                                width=self.seeds - 1, device=dev)
                   if self.seeds > 1 else None)
        r0 = []
        rest = [] if rest_fn is not None else None
        aux = [] if record else None
        with (torch.cuda.device(dev) if dev.type == "cuda"
              else contextlib.nullcontext()):
            for i, res in zip(todo, resolved):
                extra = self._extra_args(method, res)
                preds = datasets[i].preds.to(dev, torch.float32)
                labels = datasets[i].labels.to(dev)
                out = probe_fn(preds, labels, self._keys[:1], *extra)
                if record:
                    out, a = out
                    aux.append(a)
                r0.append(out)
                if rest_fn is not None:
                    rest.append(rest_fn(preds, labels, self._keys[1:],
                                        *extra))
            event = None
            if device is not None and dev.type == "cuda":
                r0, rest, aux = _pinned_copy((r0, rest, aux))
                event = torch.cuda.Event()
                event.record()
        return PendingBatch(names=names_m, method=method,
                            shape=tuple(shape), cold=cold, r0=r0, rest=rest,
                            t_start=t0, device=device, lane=lane, cost=cost,
                            aux=aux, resolved=resolved, event=event)

    def _harvest_batch(self, pend: PendingBatch, store, pairs, results,
                       progress) -> None:
        """Wait for one dispatched chunk, unpack each task (probe broadcast
        or probe + remaining seeds), write its probe record, log it and
        append the timing records. Under the scheduler a chunk's
        ``seconds`` spans dispatch to harvest on its device."""
        if pend.event is not None:
            pend.event.synchronize()
        r0 = [_to_host(r) for r in pend.r0]
        rest = ([_to_host(r) for r in pend.rest]
                if pend.rest is not None else None)
        pend.t_end = time.perf_counter()
        dt = pend.t_end - pend.t_start
        self._tele_span(
            f"{pend.method}[x{len(pend.names)}]", pend.device, pend.t_start,
            pend.t_end, {"method": pend.method, "tasks": list(pend.names),
                         "cold": pend.cold, "est_cost": round(pend.cost, 4)})
        T = len(pend.names)
        method = pend.method
        for t, name in enumerate(pend.names):
            r0_t = r0[t]
            if pend.aux is not None:
                self._write_record_stream(
                    name, method, pend.shape, r0_t, pend.aux[t],
                    pend.resolved[t], n_parallel=1)
            if rest is None or not bool(r0_t.stochastic[0]):
                res = type(r0_t)(*[np.repeat(x, self.seeds, axis=0)
                                   for x in r0_t])
            else:
                res = type(r0_t)(*[np.concatenate([a, b], axis=0)
                                   for a, b in zip(r0_t, rest[t])])
            results[(name, method)] = res
            rec = {"task": name, "method": method,
                   "shape": list(pend.shape), "seconds": dt / T,
                   "cold": pend.cold, "batched": T}
            if pend.device is not None:
                rec["device"] = pend.lane
            pairs.append(rec)
            if store is not None:
                _log(store, name, method, res, self.seeds, self.iters)
        where = f" @dev{pend.lane}" if pend.device is not None else ""
        progress(f"[batch x{T}]{where} {'/'.join(pend.names[:3])}"
                 f"{'...' if T > 3 else ''}/{method}: "
                 f"{self.seeds} seeds x {self.iters} iters in "
                 f"{dt:.2f}s{' (first dispatch)' if pend.cold else ''}")


def _finished(store, task: str, method: str, seeds: int) -> bool:
    return all(store.is_finished(task, f"{task}-{method}-{s}")
               for s in range(seeds))


def _log(store, task: str, method: str, res, seeds: int, iters: int) -> None:
    """Log every seed child, always (the reference's layout): a
    deterministic pair logs its broadcast copies, so the all-children
    resume check and the analysis SQL's mean over child runs need no
    special case."""
    regrets = np.asarray(res.regret)
    cums = np.asarray(res.cumulative_regret)
    stoch = np.asarray(res.stochastic)
    with store.run(task, f"{task}-{method}",
                   params={"method": method, "iters": iters}) as parent:
        for s in range(seeds):
            with store.run(task, f"{task}-{method}-{s}", parent=parent,
                           params={"seed": s,
                                   "stochastic": bool(stoch[s])}) as r:
                r.log_metric_series("regret", regrets[s], start_step=1)
                r.log_metric_series("cumulative regret", cums[s],
                                    start_step=1)
