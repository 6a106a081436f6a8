"""Task-parallel scheduler of the in-process suite (counterpart of
``coda_tpu/engine/scheduler.py``).

``SuiteRunner.run_batched`` dispatches every (group chunk, method) pair
in turn and waits for its results before the next dispatch. The pairs are
independent, so this module places them on devices and keeps several in
flight:

  * **placement**: a chunk's operands are copied to its device and its
    experiment callables built there; a copy changes no bit, so scheduled
    results are bitwise the serial path's (same programs, same seed keys);
  * **LPT order**: chunks go longest-processing-time first onto the least
    loaded device, costs estimated from a prior run's
    ``per_family_warm_s`` / ``per_method_warm_s`` profile (uniform where
    none is known); ``fifo`` keeps the input order;
  * **deferred harvest**: a chunk's results are copied to pinned host
    memory with ``non_blocking=True`` and a CUDA event is recorded after
    them; the harvest of a chunk whose event has fired (``event.query()``)
    overlaps the next dispatches, and the store logging with them;
  * **memory**: at most ``max_inflight`` chunks queued a device, and two
    memory-heavy chunks (a method with a ``batch_caps`` entry) never
    resident together on one device.

The planners (:func:`plan_schedule`, :func:`plan_fleet_schedule`,
:func:`partition_hosts`, :func:`plan_two_level`, :func:`estimate_cost`)
are pure host code and give the reference's outputs. Devices are
``torch.device`` objects; ``'auto'`` names the visible CUDA devices. On
the CPU (a runner on ``device='cpu'``) the list may name the CPU more
than once: that runs the deferred harvest and places nothing. Device
lanes in the timeline are the devices' positions in the list.
"""

from __future__ import annotations

import time
from dataclasses import dataclass
from typing import Optional, Sequence

import torch

from coda_tpu_torch.engine.suite import _warm_profile, family_of


def resolve_devices(spec, device_type: str = "cuda") -> list:
    """The ``torch.device`` list of a ``devices=`` spec.

    On ``cuda``: ``'auto'`` (or None) is every visible CUDA device; an int
    (or int-like string) the first N; a sequence of indices or devices
    exactly those. A count the machine cannot satisfy raises. On ``cpu``
    (asked for explicitly): ``'auto'`` is one CPU and an int N names the
    CPU N times."""
    cpu = device_type == "cpu"
    if cpu:
        local = None
    else:
        n = torch.cuda.device_count()
        if n == 0:
            raise RuntimeError(
                "no CUDA device is visible; schedule a suite on the CPU "
                "with a runner on device='cpu'")
        local = [torch.device("cuda", i) for i in range(n)]
    if spec is None or spec == "auto":
        return [torch.device("cpu")] if cpu else local
    if isinstance(spec, str):
        spec = int(spec)  # ValueError on junk is the right error
    if isinstance(spec, int):
        if cpu:
            if spec < 1:
                raise ValueError(f"devices={spec} must be >= 1")
            return [torch.device("cpu")] * spec
        if not 1 <= spec <= len(local):
            raise ValueError(
                f"devices={spec} but this process has {len(local)} local "
                "devices")
        return local[:spec]
    out = []
    for d in spec:
        if isinstance(d, int):
            if cpu:
                out.append(torch.device("cpu"))
            elif not 0 <= d < len(local):
                raise ValueError(f"no local device with id {d}")
            else:
                out.append(local[d])
        else:
            out.append(torch.device(d))
    if not out:
        raise ValueError("empty device list")
    return out


def estimate_cost(family: str, method: str, n_tasks: int,
                  cost_profile: Optional[dict],
                  family_task_counts: Optional[dict] = None) -> float:
    """Relative LPT weight of one chunk (``n_tasks`` tasks of one family
    under one method): the family's profiled seconds over its task count
    in this run (a per-task rate; the mean known rate for an unseen
    family, 1 with no profile), times the method's weight normalised to
    mean 1, times ``n_tasks``."""
    prof = cost_profile or {}
    fam_p = prof.get("per_family_warm_s", prof)
    meth_p = prof.get("per_method_warm_s", {})
    fam_p = {k: float(v) for k, v in fam_p.items()
             if isinstance(v, (int, float))}
    rates = {}
    for fam, total in fam_p.items():
        cnt = (family_task_counts or {}).get(fam, 0)
        if cnt > 0:
            rates[fam] = total / cnt
    fallback = (sum(rates.values()) / len(rates)) if rates else 1.0
    rate = rates.get(family, fallback)
    w_m = 1.0
    if meth_p:
        vals = [float(v) for v in meth_p.values()]
        mean = sum(vals) / len(vals)
        if mean > 0 and method in meth_p:
            w_m = float(meth_p[method]) / mean
    return max(rate * w_m * n_tasks, 1e-9)


def plan_fleet_schedule(costs: Sequence[float],
                        host_weights: Sequence[float],
                        schedule: str = "lpt"):
    """Chunks to HOSTS by weighted least-normalised-load greedy (weights:
    the hosts' relative capacities; all 1 reduces to
    :func:`plan_schedule`). Returns ``(order, host_assignment, loads)``,
    the loads un-normalised."""
    if schedule not in ("lpt", "fifo"):
        raise ValueError(f"unknown schedule {schedule!r}; use 'lpt'|'fifo'")
    weights = [float(w) for w in host_weights]
    if not weights or any(w <= 0 for w in weights):
        raise ValueError(f"host weights must be positive, got {weights}")
    idx = list(range(len(costs)))
    if schedule == "lpt":
        idx.sort(key=lambda i: (-costs[i], i))
    loads = [0.0] * len(weights)
    assignment = [0] * len(costs)
    for i in idx:
        h = min(range(len(weights)),
                key=lambda j: (loads[j] / weights[j], j))
        assignment[i] = h
        loads[h] += costs[i]
    return idx, assignment, loads


def partition_hosts(n_devices: int, hosts) -> list[list[int]]:
    """Device-index groups of a ``hosts`` spec: an int splits the devices
    into that many near-equal contiguous groups; a sequence of sequences
    names each host's device indices (disjoint, covering all)."""
    if isinstance(hosts, int):
        if not 1 <= hosts <= n_devices:
            raise ValueError(f"hosts={hosts} but only {n_devices} devices")
        base, rem = divmod(n_devices, hosts)
        groups, i = [], 0
        for h in range(hosts):
            n = base + (1 if h < rem else 0)
            groups.append(list(range(i, i + n)))
            i += n
        return groups
    groups = [list(g) for g in hosts]
    flat = [d for g in groups for d in g]
    if not groups or any(not g for g in groups):
        raise ValueError("every host needs at least one device")
    if len(set(flat)) != len(flat) or any(
            not 0 <= d < n_devices for d in flat):
        raise ValueError(f"host device groups {groups} must be disjoint "
                         f"indices into the {n_devices} local devices")
    if len(flat) != n_devices:
        raise ValueError(f"host device groups {groups} must cover all "
                         f"{n_devices} devices exactly")
    return groups


def plan_two_level(costs: Sequence[float], host_groups: Sequence[Sequence],
                   schedule: str = "lpt"):
    """Fleet placement flattened to devices: chunks to hosts by
    :func:`plan_fleet_schedule` (weight = device count), then within each
    host by :func:`plan_schedule`. Returns :func:`plan_schedule`'s
    ``(order, assignment, loads)`` over the global device list."""
    weights = [len(g) for g in host_groups]
    order, h_assign, _ = plan_fleet_schedule(costs, weights, schedule)
    n_dev = sum(weights)
    assignment = [0] * len(costs)
    loads = [0.0] * n_dev
    for hi, group in enumerate(host_groups):
        mine = [i for i in order if h_assign[i] == hi]
        if not mine:
            continue
        _, sub_assign, _ = plan_schedule([costs[i] for i in mine],
                                         len(group), schedule)
        for j, i in enumerate(mine):
            d = group[sub_assign[j]]
            assignment[i] = d
            loads[d] += costs[i]
    return order, assignment, loads


def plan_schedule(costs: Sequence[float], n_devices: int,
                  schedule: str = "lpt"):
    """Dispatch order and device assignment of chunk ``costs``: ``lpt``
    by descending cost (ties in input order) onto the least-loaded device
    (the longest-processing-time makespan heuristic); ``fifo`` in input
    order with the same placement. Returns ``(order, assignment,
    loads)``."""
    if schedule not in ("lpt", "fifo"):
        raise ValueError(f"unknown schedule {schedule!r}; use 'lpt'|'fifo'")
    idx = list(range(len(costs)))
    if schedule == "lpt":
        idx.sort(key=lambda i: (-costs[i], i))
    loads = [0.0] * n_devices
    assignment = [0] * len(costs)
    for i in idx:
        d = min(range(n_devices), key=lambda j: (loads[j], j))
        assignment[i] = d
        loads[d] += costs[i]
    return idx, assignment, loads


@dataclass
class _Chunk:
    """One schedulable dispatch: a todo-subset of one group, one method."""

    group: int
    todo: list
    method: str
    names: list        # the full group's names (todo indexes into it)
    shape: tuple
    family: str
    heavy: bool
    cost: float = 0.0


@dataclass
class _HostTask:
    """A loaded task staged on the host while the plan holds every group
    (device memory then only ever holds in-flight chunks)."""

    name: str
    preds: torch.Tensor
    labels: torch.Tensor

    @property
    def shape(self):
        return tuple(self.preds.shape)


def _all_ready(pend) -> bool:
    return pend.event is None or pend.event.query()


def run_scheduled(runner, groups, methods, *, store=None, force_rerun=False,
                  method_args=None, batch_caps=None, progress=print,
                  devices="auto", schedule="lpt", cost_profile=None,
                  max_inflight=2, hosts=None) -> dict:
    """``SuiteRunner.run_batched`` with task-parallel placement: the same
    chunking, resume and result layout, bitwise the same numbers.

    Every group is loaded (onto the host) before the compute phase so the
    whole work list is LPT-ordered at once. ``hosts`` (an int, or device
    index groups) adds the two-level fleet placement
    (:func:`plan_two_level`)."""
    devs = resolve_devices(devices, runner.device.type)
    max_inflight = max(1, int(max_inflight))
    results: dict = {}
    pairs: list = []
    t_suite0 = time.perf_counter()
    t_load = 0.0

    # ---- plan: load groups, enumerate chunks (the serial chunking)
    group_data: list = []
    chunks: list = []
    fam_counts: dict = {}
    for gi, group in enumerate(groups):
        t0 = time.perf_counter()
        datasets = [d() if callable(d) else d for d in group]
        names, planned = runner._plan_group(
            datasets, methods, store, force_rerun, batch_caps, progress)
        datasets = [_HostTask(name=d.name, preds=d.preds.cpu(),
                              labels=d.labels.cpu()) for d in datasets]
        t_load += time.perf_counter() - t0
        group_data.append(datasets)
        for n in names:
            fam = family_of(n)
            fam_counts[fam] = fam_counts.get(fam, 0) + 1
        for method, todo in planned:
            chunks.append(_Chunk(
                group=gi, todo=list(todo), method=method, names=names,
                shape=tuple(datasets[0].shape),
                family=family_of(names[todo[0]]),
                heavy=method in (batch_caps or {})))
    for ch in chunks:
        ch.cost = estimate_cost(ch.family, ch.method, len(ch.todo),
                                cost_profile, fam_counts)
    host_groups = None
    if hosts is not None:
        host_groups = partition_hosts(len(devs), hosts)
        order, assignment, est_loads = plan_two_level(
            [c.cost for c in chunks], host_groups, schedule)
    else:
        order, assignment, est_loads = plan_schedule(
            [c.cost for c in chunks], len(devs), schedule)

    # ---- compute: throttled dispatch, deferred harvest
    pending: dict = {i: [] for i in range(len(devs))}
    harvested: list = []
    timeline: dict = {i: [] for i in range(len(devs))}
    remaining = [sum(1 for c in chunks if c.group == gi)
                 for gi in range(len(group_data))]
    for gi, n in enumerate(remaining):
        if n == 0:   # a fully finished group (resume)
            group_data[gi] = None
    t_compute0 = None

    def _harvest(di: int, pend) -> None:
        runner._harvest_batch(pend, store, pairs, results, progress)
        harvested.append(pend)
        timeline[di].append({
            "method": pend.method, "tasks": list(pend.names),
            "start": round(pend.t_start - t_compute0, 4),
            "end": round(pend.t_end - t_compute0, 4),
            "est_cost": round(pend.cost, 4), "cold": pend.cold,
        })

    for ci in order:
        ch = chunks[ci]
        di = assignment[ci]
        q = pending[di]
        # at most max_inflight chunks queued a device, never two heavy
        while len(q) >= max_inflight or (
                ch.heavy and any(p.heavy for p in q)):
            _harvest(di, q.pop(0))
        # whatever has finished anywhere is harvested now
        for dj, qj in pending.items():
            while qj and _all_ready(qj[0]):
                _harvest(dj, qj.pop(0))
        if t_compute0 is None:
            t_compute0 = time.perf_counter()
        pend = runner._launch_batch(
            ch.todo, ch.names, group_data[ch.group], ch.method,
            method_args, ch.shape, device=devs[di], lane=di, cost=ch.cost)
        pend.heavy = ch.heavy
        q.append(pend)
        remaining[ch.group] -= 1
        if remaining[ch.group] == 0:
            group_data[ch.group] = None  # free the group's tensors
    # final drain, oldest dispatch first
    tail = sorted(((di, p) for di, q in pending.items() for p in q),
                  key=lambda t: t[1].t_start)
    for di, p in tail:
        _harvest(di, p)

    t_end = time.perf_counter()
    compute_wall = (t_end - t_compute0) if t_compute0 is not None else 0.0
    compute_device_s = sum(p.t_end - p.t_start for p in harvested)
    occupancy = {}
    for di in range(len(devs)):
        busy, last = 0.0, None
        for rec in sorted(timeline[di], key=lambda r: r["start"]):
            s, e = rec["start"], rec["end"]
            if last is None or s > last:
                busy += e - s
                last = e
            elif e > last:   # overlapping in-flight intervals: count once
                busy += e - last
                last = e
        occupancy[di] = round(busy / compute_wall, 4) if compute_wall \
            else 0.0

    total = t_end - t_suite0
    warm_m, warm_f = _warm_profile(pairs)
    runner.last_stats = {
        "total_s": total, "load_s": t_load,
        "compute_s": compute_wall,
        "compute_device_s": compute_device_s,
        "pairs": pairs,
        "per_method_warm_s": warm_m, "per_family_warm_s": warm_f,
        "n_devices": len(devs), "schedule": schedule,
        "device_timeline": timeline, "occupancy": occupancy,
        "devices": [str(d) for d in devs],
        "est_device_load": {i: round(est_loads[i], 4)
                            for i in range(len(devs))},
    }
    if host_groups is not None:
        runner.last_stats["hosts"] = host_groups
        runner.last_stats["host_load"] = [
            round(sum(est_loads[d] for d in g), 4) for g in host_groups]
    progress(f"suite[scheduled x{len(devs)}]: {len(results)} task-method "
             f"pairs in {total:.2f}s (compute wall {compute_wall:.2f}s, "
             f"device-seconds {compute_device_s:.2f}s, data load "
             f"{t_load:.2f}s, occupancy "
             f"{ {k: v for k, v in sorted(occupancy.items())} })")
    return results
