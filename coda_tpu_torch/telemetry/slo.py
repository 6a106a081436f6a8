"""SLO watchtower: declarative objectives + multi-window burn-rate alerts
(counterpart of ``coda_tpu/telemetry/slo.py``, stdlib only; the router
that runs the sweeper comes with the fleet, slice 9 of the port).

The serve stack commits to service objectives in its artifacts (label p99
under a bound, wake p99 under one batcher tick, migrations digest-verified,
0 unaudited argmax picks) but until now nothing evaluated them *online*.
This module is the sensor plane the future autoscaler subscribes to:

  * :class:`SLObjective` — one declarative objective: a ``probe`` mapping
    the router's aggregated fleet snapshot (``SessionRouter.stats()``) to a
    *bad fraction* in [0, 1] (or ``None`` when the underlying family has no
    data yet), plus the long-run error ``budget`` the burn rate is
    normalized against.
  * :class:`SloSweeper` — evaluates every objective on each observation,
    maintains fast/slow rolling windows (Google SRE multi-window
    multi-burn-rate: default 5 m / 1 h), and runs the alert state machine:
    **fire** when BOTH windows burn above ``fire_threshold`` (the fast
    window makes the alert responsive, the slow window makes it ignore
    blips), **clear** when the fast window burns below ``clear_threshold``
    (hysteresis — a freshly-fired alert does not flap while the slow
    window drains). Typed alert events are retained, mirrored into
    ``coda_slo_*`` registry families (rendered lint-clean by
    ``render_fleet``), and flushed to the MLflow-schema tracking store.

Burn rate = (windowed mean bad fraction) / budget: 1.0 burns the error
budget exactly at the sustainable rate; the default fire threshold of 8
corresponds to a fast, page-worthy burn. Time comes from an injectable
monotonic clock (``time.monotonic``) so unit tests drive synthetic streams
across the windows without sleeping.
"""

from __future__ import annotations

import collections
import threading
import time
from dataclasses import dataclass
from typing import Callable, Optional

__all__ = [
    "SLObjective",
    "SloSweeper",
    "default_fleet_slos",
]


@dataclass(frozen=True)
class SLObjective:
    """One declarative objective over the aggregated fleet snapshot."""

    name: str
    description: str
    #: fleet snapshot -> bad fraction in [0, 1]; None = no data (objective
    #: reports ``no_data`` and never burns)
    probe: Callable[[dict], Optional[float]]
    #: long-run allowed bad fraction (burn rate 1.0 == spending exactly this)
    budget: float = 0.01


class _Window:
    """Rolling (t, bad) samples over a fixed horizon; O(1) amortized."""

    def __init__(self, horizon_s: float):
        self.horizon_s = horizon_s
        self._samples: collections.deque = collections.deque()

    def add(self, t: float, bad: float) -> None:
        self._samples.append((t, bad))
        cutoff = t - self.horizon_s
        while self._samples and self._samples[0][0] < cutoff:
            self._samples.popleft()

    def mean(self) -> Optional[float]:
        if not self._samples:
            return None
        return sum(b for _, b in self._samples) / len(self._samples)

    def __len__(self) -> int:
        return len(self._samples)


class _ObjectiveState:
    def __init__(self, obj: SLObjective, fast_s: float, slow_s: float):
        self.obj = obj
        self.fast = _Window(fast_s)
        self.slow = _Window(slow_s)
        self.firing = False
        self.fired_total = 0
        self.cleared_total = 0
        self.last_bad: Optional[float] = None
        self.burn_fast: Optional[float] = None
        self.burn_slow: Optional[float] = None


class SloSweeper:
    """Evaluate objectives on fleet snapshots; fire/clear burn-rate alerts.

    Thread-safe: the router's poll thread calls :meth:`observe` while HTTP
    handlers read :meth:`snapshot`. ``registry`` (optional) receives the
    ``slo_*`` gauge/counter families; ``store`` (optional, MLflow-schema
    :class:`~coda_tpu_torch.tracking.store.TrackingStore`-like, or a zero-arg
    factory returning one — resolved lazily on the flushing thread because
    sqlite connections are thread-bound) receives one run per alert
    transition under the ``serve_slo`` experiment.
    """

    def __init__(self, objectives: list[SLObjective],
                 registry=None, store=None,
                 fast_s: float = 300.0, slow_s: float = 3600.0,
                 fire_threshold: float = 8.0, clear_threshold: float = 1.0,
                 min_samples: int = 3,
                 clock: Callable[[], float] = time.monotonic):
        if clear_threshold > fire_threshold:
            raise ValueError("clear_threshold must not exceed fire_threshold")
        self.objectives = list(objectives)
        self.registry = registry
        self.store = store
        self.fast_s = float(fast_s)
        self.slow_s = float(slow_s)
        self.fire_threshold = float(fire_threshold)
        self.clear_threshold = float(clear_threshold)
        self.min_samples = int(min_samples)
        self._clock = clock
        self._lock = threading.Lock()
        self._states = {o.name: _ObjectiveState(o, self.fast_s, self.slow_s)
                        for o in self.objectives}
        self.observations = 0
        # every fire/clear transition ever (bounded: alerts are rare by
        # construction; the deque guards against a flapping objective)
        self.alerts: collections.deque = collections.deque(maxlen=1024)
        self._store_flushed = 0
        self._store_errors = 0

    # -- evaluation --------------------------------------------------------
    def observe(self, snapshot: dict, t: Optional[float] = None) -> list:
        """Evaluate every objective against one fleet snapshot.

        Returns the alert transitions produced by THIS observation (also
        retained in :attr:`alerts` and flushed to the store)."""
        t = self._clock() if t is None else float(t)
        transitions = []
        with self._lock:
            self.observations += 1
            for st in self._states.values():
                try:
                    bad = st.obj.probe(snapshot)
                except Exception:
                    bad = None  # a broken probe must not kill the sweeper
                st.last_bad = bad
                if bad is None:
                    continue
                bad = min(1.0, max(0.0, float(bad)))
                st.fast.add(t, bad)
                st.slow.add(t, bad)
                budget = max(st.obj.budget, 1e-12)
                fmean, smean = st.fast.mean(), st.slow.mean()
                st.burn_fast = None if fmean is None else fmean / budget
                st.burn_slow = None if smean is None else smean / budget
                if len(st.fast) < self.min_samples:
                    continue
                ev = self._step_alert(st, t)
                if ev is not None:
                    transitions.append(ev)
        for ev in transitions:
            self._flush_alert(ev)
        self._export_registry()
        return transitions

    def _step_alert(self, st: _ObjectiveState, t: float) -> Optional[dict]:
        """Fire/clear state machine for one objective (lock held)."""
        bf = st.burn_fast if st.burn_fast is not None else 0.0
        bs = st.burn_slow if st.burn_slow is not None else 0.0
        ev = None
        if not st.firing and bf >= self.fire_threshold \
                and bs >= self.fire_threshold:
            st.firing = True
            st.fired_total += 1
            ev = self._alert(st, "firing", t)
        elif st.firing and bf < self.clear_threshold:
            st.firing = False
            st.cleared_total += 1
            ev = self._alert(st, "resolved", t)
        if ev is not None:
            self.alerts.append(ev)
        return ev

    def _alert(self, st: _ObjectiveState, state: str, t: float) -> dict:
        return {
            "slo": st.obj.name,
            "state": state,
            "burn_fast": st.burn_fast,
            "burn_slow": st.burn_slow,
            "budget": st.obj.budget,
            "t_monotonic": t,
            "seq": st.fired_total + st.cleared_total,
        }

    # -- export ------------------------------------------------------------
    def _export_registry(self) -> None:
        if self.registry is None:
            return
        reg = self.registry
        burn_f = reg.gauge("slo_burn_rate_fast",
                           "Fast-window burn rate per objective "
                           "(windowed bad fraction / budget)")
        burn_s = reg.gauge("slo_burn_rate_slow",
                           "Slow-window burn rate per objective")
        bad = reg.gauge("slo_bad_fraction",
                        "Instantaneous bad fraction per objective")
        firing = reg.gauge("slo_firing",
                           "1 while the objective's burn-rate alert fires")
        with self._lock:
            for st in self._states.values():
                name = st.obj.name
                if st.burn_fast is not None:
                    burn_f.set(st.burn_fast, slo=name)
                if st.burn_slow is not None:
                    burn_s.set(st.burn_slow, slo=name)
                if st.last_bad is not None:
                    bad.set(st.last_bad, slo=name)
                firing.set(1.0 if st.firing else 0.0, slo=name)

    def _flush_alert(self, ev: dict) -> None:
        """One tracking-store run per alert transition (typed event)."""
        # registry counter ALWAYS steps, store flush is best-effort
        if self.registry is not None:
            self.registry.counter(
                "slo_alerts_total",
                "Burn-rate alert transitions by objective and state").inc(
                    1.0, slo=ev["slo"], state=ev["state"])
        if self.store is None:
            return
        try:
            if not hasattr(self.store, "run"):
                # zero-arg factory: the TrackingStore's sqlite connection is
                # bound to its creating thread, and alerts flush from the
                # router's poll thread — so the store must be BORN here, not
                # on whatever thread built the sweeper
                self.store = self.store()
            with self.store.run(
                    "serve_slo", f"alert-{ev['slo']}-{ev['state']}",
                    params={"slo": ev["slo"], "state": ev["state"],
                            "budget": str(ev["budget"])}) as run:
                run.log_metric("burn_fast", float(ev["burn_fast"] or 0.0))
                run.log_metric("burn_slow", float(ev["burn_slow"] or 0.0))
                run.log_metric("firing",
                               1.0 if ev["state"] == "firing" else 0.0)
            self._store_flushed += 1
        except Exception:
            self._store_errors += 1  # alerting must survive a broken store

    # -- reading -----------------------------------------------------------
    def snapshot(self) -> dict:
        """The ``GET /fleet/slo`` payload."""
        with self._lock:
            objectives = {}
            for st in self._states.values():
                objectives[st.obj.name] = {
                    "description": st.obj.description,
                    "budget": st.obj.budget,
                    "bad_fraction": st.last_bad,
                    "no_data": st.last_bad is None,
                    "burn_fast": st.burn_fast,
                    "burn_slow": st.burn_slow,
                    "firing": st.firing,
                    "fired_total": st.fired_total,
                    "cleared_total": st.cleared_total,
                    "window_samples": [len(st.fast), len(st.slow)],
                }
            return {
                "windows_s": {"fast": self.fast_s, "slow": self.slow_s},
                "thresholds": {"fire": self.fire_threshold,
                               "clear": self.clear_threshold},
                "observations": self.observations,
                "objectives": objectives,
                "alerts": list(self.alerts)[-64:],
                "alerts_total": len(self.alerts),
                "store": {"flushed": self._store_flushed,
                          "errors": self._store_errors},
            }


# -- default objective set ---------------------------------------------------

def _agg(snapshot: dict) -> dict:
    return snapshot.get("aggregate") or {}


def _router(snapshot: dict) -> dict:
    return snapshot.get("router") or {}


def _replica_snaps(snapshot: dict) -> list[dict]:
    reps = snapshot.get("replicas") or {}
    return [s for s in reps.values()
            if isinstance(s, dict) and "error" not in s]


def _max_p99_ms(snapshot: dict, ring: str) -> Optional[float]:
    """Worst per-replica p99 of one latency ring, ms (None = no data)."""
    worst = None
    for snap in _replica_snaps(snapshot):
        summ = snap.get(ring) or {}
        p99 = summ.get("p99_ms")
        if p99 is None:
            continue
        worst = p99 if worst is None else max(worst, p99)
    return worst


def default_fleet_slos(label_p99_ms: float = 250.0,
                       wake_p99_ms: float = 50.0) -> list[SLObjective]:
    """The committed objective set from the fleet artifacts, as probes over
    ``SessionRouter.stats()``. Bounds are deployment knobs: ``wake_p99_ms``
    should be one batcher tick (`max_wait_ms` + dispatch)."""

    def label_p99(snapshot):
        p99 = _max_p99_ms(snapshot, "request_latency")
        return None if p99 is None else (1.0 if p99 > label_p99_ms else 0.0)

    def error_ratio(snapshot):
        agg = _agg(snapshot)
        total = agg.get("requests") or 0
        if not total:
            return None
        bad = (agg.get("requests_rejected") or 0) + \
            (agg.get("requests_failed") or 0)
        return min(1.0, bad / total)

    def wake_p99(snapshot):
        p99 = _max_p99_ms(snapshot, "wake_latency")
        return None if p99 is None else (1.0 if p99 > wake_p99_ms else 0.0)

    def warm_misses(snapshot):
        # post-start contract: a warm-pool MISS after the pool is primed
        # (size > 0) means a shape fell out of the AOT cache — a recompile
        # in the hot path
        saw = None
        for snap in _replica_snaps(snapshot):
            wp = snap.get("warm_pool") or {}
            if not (wp.get("size") or 0):
                continue
            saw = saw or 0.0
            if (wp.get("misses") or 0) > 0:
                saw = 1.0
        return saw

    def unaudited_argmax(snapshot):
        # the surrogate trust gate makes unaudited picks structurally 0
        # (escape/audit-rank/score-contract all force an exact fallback);
        # the probe watches the counter so a gate regression burns
        # immediately. No surrogate bucket anywhere -> no data.
        saw = None
        for snap in _replica_snaps(snapshot):
            if "surrogate_rounds" not in snap:
                continue
            saw = saw or 0.0
            if (snap.get("surrogate_unaudited_picks") or 0) > 0:
                saw = 1.0
        return saw

    def migrations_verified(snapshot):
        r = _router(snapshot)
        migrations = (r.get("counters") or {}).get("migrations")
        if migrations is None:
            migrations = r.get("migrations")
        if not migrations:
            return None
        verified = r.get("migration_verified") or 0
        return 0.0 if verified >= migrations else 1.0

    return [
        SLObjective("label_p99",
                    f"label request p99 <= {label_p99_ms:g} ms "
                    "(worst replica)", label_p99, budget=0.05),
        SLObjective("error_ratio",
                    "rejected+failed requests / total requests",
                    error_ratio, budget=0.01),
        SLObjective("wake_p99",
                    f"tier wake p99 <= {wake_p99_ms:g} ms (one batcher "
                    "tick)", wake_p99, budget=0.05),
        SLObjective("warm_pool_misses",
                    "0 warm-pool misses after the pool is primed",
                    warm_misses, budget=0.001),
        SLObjective("unaudited_argmax",
                    "0 argmax picks driven by an unaudited surrogate score",
                    unaudited_argmax, budget=0.001),
        SLObjective("migrations_verified",
                    "every migration digest-verified "
                    "(migration_verified == migrations)",
                    migrations_verified, budget=0.001),
    ]
