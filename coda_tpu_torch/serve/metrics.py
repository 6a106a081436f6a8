"""Serving metrics: per-dispatch counters and latency percentiles
(counterpart of ``coda_tpu/serve/metrics.py``).

The serving layer's one hot loop is the batcher tick (drain queue -> build
masked inputs -> one compiled slab step), so the metrics that matter are
per-dispatch: how many requests rode each program launch (batch occupancy —
the whole point of the subsystem), how deep the queue ran, and how long a
request waited end-to-end. Everything is recorded into fixed-size rings on
the host — O(1) per event, no allocation in the request path — and reduced
to percentiles only when a snapshot is asked for (the ``/stats`` endpoint,
or an end-of-run flush into the MLflow-schema tracking store).
"""

from __future__ import annotations

import collections
import threading
import time

import numpy as np

# ring capacity: big enough that p99 over the recent window is stable, small
# enough that a snapshot reduction is microseconds
_RING = 4096


def _percentiles(ring) -> dict:
    """{p50, p99, mean, max} of a ring of seconds, as milliseconds."""
    if not ring:
        return {"p50_ms": None, "p99_ms": None, "mean_ms": None,
                "max_ms": None}
    a = np.asarray(ring, np.float64) * 1e3
    return {
        "p50_ms": float(np.percentile(a, 50)),
        "p99_ms": float(np.percentile(a, 99)),
        "mean_ms": float(a.mean()),
        "max_ms": float(a.max()),
    }


class ServeMetrics:
    """Thread-safe counters + latency rings for the serving layer."""

    def __init__(self):
        self._lock = threading.Lock()
        # monotonic baseline: uptime is a DURATION, and wall clock jumps
        # (NTP slew, suspend) must not produce negative or inflated uptimes
        self.started = time.monotonic()
        # monotonically increasing counters
        self.dispatches = 0
        self.requests = 0
        self.sessions_opened = 0
        self.sessions_closed = 0
        self.sessions_rejected = 0   # admission-control refusals (slab full)
        self.requests_rejected = 0   # draining / bad-session refusals
        self.fencing_rejections = 0  # stale-epoch verbs refused (StaleOwner)
        # warm pool: AOT-precompiled executables vs lazy-jit fallbacks
        self.warm_hits = 0           # dispatches served by an AOT executable
        self.warm_misses = 0         # dispatches that fell back to lazy jit
        self.warm_pool_size = 0      # precompiled executables in the pool
        self.warm_pool_seconds = None  # warm-up wall time (None = no warm)
        # tiered posterior state (serve/tiering.py): paging events and the
        # hot/warm/cold occupancy gauges, plus a wake-latency ring — the
        # "wake-from-warm p99 under one batcher tick" claim's evidence
        self.demotions = 0           # hot -> warm (slab slot freed)
        self.hibernates = 0          # warm -> cold (payload spilled to disk)
        self.peer_pages = 0          # warm -> a less-loaded peer replica
        self.wakes = 0               # warm/cold -> hot (transparent restore)
        self.wakes_from_warm = 0
        self.wakes_from_cold = 0
        self.wakes_via_replay = 0    # digest mismatch -> stream replay path
        self.wake_failures = 0       # wakes that raised (payload re-parked)
        self.tier_occupancy = {"hot": 0, "warm": 0, "cold": 0}
        self._wake_s = collections.deque(maxlen=_RING)
        # fault tolerance: checkpoint/restore + bucket self-healing events
        self.recovery = {
            "exported": 0,     # sessions serialized for migration
            "imported": 0,     # sessions restored from export payloads
            "restored": 0,     # sessions rebuilt from streams after crash
            "quarantined": 0,  # buckets quarantined by a step failure
            "healed": 0,       # slab rebuilds that digest-verified
            "heal_failed": 0,  # rebuilds degraded to terminal
        }
        # gauges / rings
        self.max_occupancy = 0       # most requests ever served by one dispatch
        self._occupancy = collections.deque(maxlen=_RING)   # reqs per dispatch
        self._queue_depth = collections.deque(maxlen=_RING)  # at tick start
        self._dispatch_s = collections.deque(maxlen=_RING)  # dispatch wall
        self._step_s = collections.deque(maxlen=_RING)      # slab-step exec
        self._request_s = collections.deque(maxlen=_RING)   # submit->result
        self._queue_wait_s = collections.deque(maxlen=_RING)  # submit->tick
        # crowd-oracle answer path (POST /session/{id}/answer): per-slot
        # parking, abstentions, fault-injected poisons, and the async
        # delivery evidence — how many rounds completed out of the parked
        # path, the deepest arrival reorder observed, and how many
        # duplicate answers the dedupe refused (the committed
        # ROBUSTNESS artifact's 0-double-apply bound reads this)
        self.oracle = {
            "answers_parked": 0,     # per-slot answers accepted into a park
            "abstentions": 0,        # abstain verbs (slot left open)
            "poisoned": 0,           # answers corrupted by oracle_poison
            "deferred_rounds_completed": 0,  # rounds dispatched via parking
            "reorder_depth_max": 0,  # deepest out-of-order arrival seen
            "double_apply_rejects": 0,  # duplicate answers refused
        }
        # surrogate-scorer evidence provider (--eig-scorer surrogate:k):
        # set by the app to a () -> dict callback summing the slab-carried
        # fit counters over its buckets, so /stats and /metrics read
        # CURRENT counters on demand without a per-tick device sync. The
        # returned keys (surrogate_rounds, surrogate_fallbacks,
        # surrogate_fit_refreshes, surrogate_contract_margin) merge into
        # the snapshot; {} when no surrogate bucket exists.
        self.surrogate_provider = None
        # cross-session prior evidence provider (--surrogate-prior pool):
        # set by the app to a () -> dict callback merging the pool's
        # contribution counters with the slab-read warmup-credit/
        # gate-rejection counters (prior_sessions_contributed,
        # prior_warmup_rounds_skipped, prior_gate_rejections). None when
        # the prior is off — the families are then ABSENT from /stats
        # and /metrics, not zero, exactly like the surrogate's.
        self.prior_provider = None
        # cold-tier spill store stats provider (serve/tiering.py): a
        # () -> dict of the v3 store's segment/index/compaction gauges,
        # surfaced under snapshot["spill"]. None when no spill dir.
        self.spill_provider = None
        # decision-quality plane provider (telemetry/quality.py): a
        # () -> dict of calibration / drift / shadow-audit evidence,
        # surfaced under snapshot["quality"]. None when --no-quality —
        # the families are then ABSENT, not zero (spill's contract).
        self.quality_provider = None
        # OpenMetrics exemplars: per-ring, the most recent TRACED sample
        # whose latency cleared the ring's p99 (gate lazily refreshed from
        # the percentile reduction each snapshot — the record path stays a
        # compare + tuple store, no reduction). A slow request on /metrics
        # is then one hop from its stitched trace.
        self._exemplars: dict[str, tuple] = {}   # ring -> (seconds, trace_id)
        self._exemplar_gate: dict[str, float] = {}  # ring -> p99 seconds

    def _note_exemplar(self, ring: str, seconds: float,
                       trace_id) -> None:
        """Keep (seconds, trace_id) if it clears the ring's last-known p99
        (or no gate exists yet). Caller holds the lock."""
        if not trace_id:
            return
        gate = self._exemplar_gate.get(ring)
        if gate is None or seconds >= gate:
            self._exemplars[ring] = (float(seconds), str(trace_id))

    # -- recording (request path: O(1), no reductions) ---------------------
    def record_dispatch(self, n_requests: int, queue_depth: int,
                        seconds: float, step_seconds: float = None,
                        warm: bool = None) -> None:
        with self._lock:
            self.dispatches += 1
            self.requests += n_requests
            self.max_occupancy = max(self.max_occupancy, n_requests)
            self._occupancy.append(n_requests)
            self._queue_depth.append(queue_depth)
            self._dispatch_s.append(seconds)
            if step_seconds is not None:
                self._step_s.append(step_seconds)
            if warm is not None:
                if warm:
                    self.warm_hits += 1
                else:
                    self.warm_misses += 1

    def record_request_latency(self, seconds: float,
                               trace_id=None) -> None:
        with self._lock:
            self._request_s.append(seconds)
            self._note_exemplar("request_latency", seconds, trace_id)

    def record_queue_wait(self, seconds: float, trace_id=None) -> None:
        with self._lock:
            self._queue_wait_s.append(seconds)
            self._note_exemplar("queue_wait", seconds, trace_id)

    def record_warm_pool(self, size: int, seconds: float) -> None:
        """One warm-up pass finished: pool size + wall time it took."""
        with self._lock:
            self.warm_pool_size = int(size)
            self.warm_pool_seconds = float(seconds)

    def record_tier(self, event: str, src: str = None,
                    seconds: float = None, via: str = None) -> None:
        """One tiering event: ``demote`` | ``hibernate`` | ``wake`` (with
        its source tier, wall seconds, and restore path) | ``wake_failed``."""
        with self._lock:
            if event == "demote":
                self.demotions += 1
            elif event == "hibernate":
                self.hibernates += 1
            elif event == "peer_page":
                self.peer_pages += 1
            elif event == "wake":
                self.wakes += 1
                if src == "warm":
                    self.wakes_from_warm += 1
                elif src == "cold":
                    self.wakes_from_cold += 1
                if via == "replay":
                    self.wakes_via_replay += 1
                if seconds is not None:
                    self._wake_s.append(seconds)
            elif event == "wake_failed":
                self.wake_failures += 1
            else:
                raise ValueError(f"unknown tier event {event!r}")

    def set_tier_occupancy(self, hot: int, warm: int, cold: int) -> None:
        with self._lock:
            self.tier_occupancy = {"hot": int(hot), "warm": int(warm),
                                   "cold": int(cold)}

    def record_recovery(self, event: str) -> None:
        """One fault-tolerance event (see the ``recovery`` counter keys)."""
        with self._lock:
            if event not in self.recovery:
                raise ValueError(f"unknown recovery event {event!r}")
            self.recovery[event] += 1

    def record_oracle(self, event: str, depth: int = None) -> None:
        """One crowd-oracle answer event: ``parked`` | ``abstain`` |
        ``poisoned`` | ``round_completed`` | ``double_apply_reject``;
        ``depth`` updates the reorder-depth high-water mark."""
        with self._lock:
            if event == "parked":
                self.oracle["answers_parked"] += 1
            elif event == "abstain":
                self.oracle["abstentions"] += 1
            elif event == "poisoned":
                self.oracle["poisoned"] += 1
            elif event == "round_completed":
                self.oracle["deferred_rounds_completed"] += 1
            elif event == "double_apply_reject":
                self.oracle["double_apply_rejects"] += 1
            else:
                raise ValueError(f"unknown oracle event {event!r}")
            if depth is not None:
                self.oracle["reorder_depth_max"] = max(
                    self.oracle["reorder_depth_max"], int(depth))

    def record_fencing_rejection(self) -> None:
        """One stale-epoch verb refused (the ownership fence held)."""
        with self._lock:
            self.fencing_rejections += 1

    def record_session(self, event: str) -> None:
        with self._lock:
            if event == "open":
                self.sessions_opened += 1
            elif event == "close":
                self.sessions_closed += 1
            elif event == "reject":
                self.sessions_rejected += 1
            elif event == "request_reject":
                self.requests_rejected += 1
            else:
                raise ValueError(f"unknown session event {event!r}")

    # -- reading -----------------------------------------------------------
    def snapshot(self) -> dict:
        """One JSON-able dict: counters + reduced percentiles (the /stats
        payload and the loadgen report's server-side half)."""
        with self._lock:
            occ = list(self._occupancy)
            depth = list(self._queue_depth)
            snap = {
                "uptime_s": time.monotonic() - self.started,
                "dispatches": self.dispatches,
                "requests": self.requests,
                "sessions_opened": self.sessions_opened,
                "sessions_closed": self.sessions_closed,
                "sessions_rejected": self.sessions_rejected,
                "requests_rejected": self.requests_rejected,
                "fencing_rejections": self.fencing_rejections,
                "max_occupancy": self.max_occupancy,
                "mean_occupancy": (float(np.mean(occ)) if occ else None),
                "mean_queue_depth": (float(np.mean(depth)) if depth
                                     else None),
                "dispatch_latency": _percentiles(self._dispatch_s),
                "request_latency": _percentiles(self._request_s),
                # the p99 attribution triplet: where a request's wall time
                # went — queued behind a tick, host-side dispatch fan-out,
                # or the compiled slab step itself
                "queue_wait": _percentiles(self._queue_wait_s),
                "step_latency": _percentiles(self._step_s),
                "warm_pool": {
                    "size": self.warm_pool_size,
                    "warm_s": self.warm_pool_seconds,
                    "hits": self.warm_hits,
                    "misses": self.warm_misses,
                },
                "recovery": dict(self.recovery),
                "oracle": dict(self.oracle),
                # tiered-state evidence: occupancy per tier, paging
                # counters, and the wake-latency ring percentiles
                "tiers": dict(self.tier_occupancy),
                "demotions": self.demotions,
                "hibernates": self.hibernates,
                "peer_pages": self.peer_pages,
                "wakes": self.wakes,
                "wakes_from_warm": self.wakes_from_warm,
                "wakes_from_cold": self.wakes_from_cold,
                "wakes_via_replay": self.wakes_via_replay,
                "wake_failures": self.wake_failures,
                "wake_latency": _percentiles(self._wake_s),
                # ring fill: how much recent-window evidence backs the
                # percentiles above (fill == capacity -> the ring has
                # wrapped and older events have been evicted)
                # traced p99 outliers per latency ring (OpenMetrics
                # exemplar source; absent ring -> no traced outlier yet)
                "exemplars": {
                    ring: {"value_s": v, "trace_id": tid}
                    for ring, (v, tid) in self._exemplars.items()
                },
                "ring_capacity": _RING,
                "ring_fill": {
                    "occupancy": len(self._occupancy),
                    "queue_depth": len(self._queue_depth),
                    "dispatch_latency": len(self._dispatch_s),
                    "request_latency": len(self._request_s),
                    "queue_wait": len(self._queue_wait_s),
                    "step_latency": len(self._step_s),
                    "wake_latency": len(self._wake_s),
                },
            }
            # refresh the exemplar gates from the reduction just paid: the
            # NEXT traced samples are compared against the current p99
            for ring in ("request_latency", "queue_wait"):
                p99 = snap[ring]["p99_ms"]
                if p99 is not None:
                    self._exemplar_gate[ring] = p99 / 1e3
        # outside the lock: the provider takes bucket dispatch locks of
        # its own, and a lock inversion against record_dispatch (batcher
        # thread holding a bucket lock while recording) must be impossible
        provider = self.surrogate_provider
        if provider is not None:
            try:
                snap.update(provider() or {})
            except Exception:
                pass  # stats must never fail on a mid-teardown bucket
        provider = self.prior_provider
        if provider is not None:
            try:
                snap.update(provider() or {})
            except Exception:
                pass
        provider = self.spill_provider
        if provider is not None:
            try:
                spill = provider()
                if spill:
                    snap["spill"] = spill
            except Exception:
                pass
        provider = self.quality_provider
        if provider is not None:
            try:
                quality = provider()
                if quality:
                    snap["quality"] = quality
            except Exception:
                pass
        return snap

    def log_to_store(self, store, experiment: str = "serve",
                     run_name: str | None = None, params: dict | None = None):
        """Flush a snapshot into the tracking store (one run, flat metrics).

        Uses the same experiment -> run layout the benchmark CLI writes, so
        serving runs sit next to experiment runs in one sqlite DB and the
        analysis SQL can join them. Returns the run_uuid."""
        snap = self.snapshot()
        name = run_name or f"{experiment}-metrics"
        with store.run(experiment, name, params=params or {}) as run:
            for key, val in snap.items():
                if isinstance(val, dict):
                    for sub, v in val.items():
                        if isinstance(v, (int, float)):
                            run.log_metric(f"{key}.{sub}", float(v))
                elif isinstance(val, (int, float)):
                    run.log_metric(key, float(val))
        return run.run_uuid
