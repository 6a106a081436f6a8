"""Decision-quality observability: calibration, drift, and shadow audits
(counterpart of ``coda_tpu/telemetry/quality.py``).

The port's one change is the pre-dispatch read (:meth:`QualityPlane.
pre_dispatch`): the labeled slots' P(best) rows come off the card with one
stacked gather and ONE copy (``Bucket.pbest_rows``) instead of one device
read per slot — the same fp32 words, so the same evidence — and the
consensus ``pi_hat`` indexes only the labeled items' columns of the
task's host float32 predictions. Everything after the read is the
reference's host arithmetic (float64 numpy), so the calibration
accumulators, the ECE and Brier means and the drift statistics are the
reference's for the same inputs.

The serving telemetry watches whether the service is *fast and alive*;
this plane watches whether its *decisions* are statistically healthy — a
miscalibrated P(best), a drifting surrogate residual, or a stale prior
pool serves perfectly fast, perfectly wrong answers. This module is the
decision-quality plane, three organs behind one facade:

  * :class:`CalibrationMonitor` — O(1) streaming reliability buckets over
    the flight recorder's per-round evidence: the probability the
    session's consensus posterior ``pi_hat`` assigned to the realized
    oracle label (the new additive-optional ``pred_label_prob`` row
    field), its argmax-hit indicator, and the P(best) digest. Yields
    ECE / Brier per (task, bucket) online — the amortized-gate and
    surrogate rungs get a live calibration curve, not just the 2.34e-4
    static bound. :func:`pbest_calibration` is the ground-truth variant
    for suite/bench records (P(best)-vs-realized-best).
  * :class:`CusumDetector` / :class:`PageHinkley` (+ :class:`DriftBank`)
    — one-sided drift state machines with injectable clocks over the
    surrogate's audit-gate pressure, the prior pool's staleness-regret
    estimate (the exact sensor the ROADMAP's learned-decay item needs),
    and the crowd reliability posterior's movement.
  * :class:`ShadowAuditor` — re-replays a sampled fraction of closing
    sessions' recorder streams through a scratch slab slot OFF the
    batcher thread, verifying every round bitwise with the existing
    replay machinery (``serve/recovery.py``). A clean fleet holds 0
    divergences; a single-ulp stream tamper (the ``stream_tamper``
    fault site) is caught and attributed to the exact session + round.
    For pool-seeded sessions it additionally measures the seeded-vs-cold
    warmup gap — the other half of the staleness-regret sensor.

:class:`QualityPlane` bundles the three for the serving layer (the
``--no-quality`` flag disables it wholesale), publishes lint-clean
``quality_*`` families on ``/metrics``, the ``GET /fleet/quality``
scorecard, and tracking-store snapshots, and :func:`quality_slos` registers
calibration/divergence/drift objectives into the existing
:class:`~coda_tpu_torch.telemetry.slo.SloSweeper` burn-rate machinery.

Contract (same as tracing): quality on-vs-off leaves decision rows
bitwise identical — the plane only READS posterior state (the consensus
``pi_hat`` is computed from a pre-dispatch ``pbest`` read plus the task's
prediction tensor) and replays scratch slots that no live session owns.
"""

from __future__ import annotations

import collections
import hashlib
import queue
import threading
import time
from typing import Callable, Optional

import numpy as np

__all__ = [
    "CalibrationBuckets",
    "CalibrationMonitor",
    "CusumDetector",
    "DriftBank",
    "PageHinkley",
    "QualityPlane",
    "ShadowAuditor",
    "pbest_calibration",
    "quality_slos",
    "reliability_curve",
    "tamper_rows_ulp",
]

#: reliability-diagram resolution: 10 equal-width confidence bins is the
#: standard ECE binning (Guo et al.) and keeps the accumulators O(1)
N_CALIBRATION_BINS = 10

#: a calibration verdict below this many labeled rounds is noise, not
#: evidence — snapshots report the ECE but SLO probes treat it as no-data
CALIBRATION_MIN_SAMPLES = 50


# ---------------------------------------------------------------------------
# streaming calibration
# ---------------------------------------------------------------------------

class CalibrationBuckets:
    """O(1) reliability accumulators for one (task, channel) stream.

    Per observation: the model's confidence (probability it put on its
    own argmax), whether that argmax was realized (``hit``), and
    optionally the probability assigned to the realized label itself.
    Everything downstream (ECE, Brier, the reliability curve) is a pure
    read of the per-bin sums — no per-round lists, so a million-round
    session costs the same 3 small arrays."""

    def __init__(self, bins: int = N_CALIBRATION_BINS):
        self.bins = int(bins)
        self.n = np.zeros(self.bins, np.int64)
        self.conf_sum = np.zeros(self.bins, np.float64)
        self.hit_sum = np.zeros(self.bins, np.float64)
        self.brier_sum = 0.0
        self.p_label_sum = 0.0
        self.p_label_n = 0

    def observe(self, conf: float, hit: bool,
                p_label: Optional[float] = None) -> None:
        conf = float(min(1.0, max(0.0, conf)))
        b = min(self.bins - 1, int(conf * self.bins))
        self.n[b] += 1
        self.conf_sum[b] += conf
        self.hit_sum[b] += 1.0 if hit else 0.0
        self.brier_sum += (conf - (1.0 if hit else 0.0)) ** 2
        if p_label is not None:
            self.p_label_sum += float(p_label)
            self.p_label_n += 1

    @property
    def total(self) -> int:
        return int(self.n.sum())

    def ece(self) -> Optional[float]:
        """Expected calibration error: Σ_b (n_b/n)·|acc_b − conf_b|."""
        n = self.total
        if n == 0:
            return None
        live = self.n > 0
        acc = self.hit_sum[live] / self.n[live]
        conf = self.conf_sum[live] / self.n[live]
        return float(np.sum(self.n[live] * np.abs(acc - conf)) / n)

    def brier(self) -> Optional[float]:
        n = self.total
        return None if n == 0 else self.brier_sum / n

    def snapshot(self) -> dict:
        n = self.total
        out = {
            "n": n,
            "ece": self.ece(),
            "brier": self.brier(),
            "mean_pred_label_prob": (self.p_label_sum / self.p_label_n
                                     if self.p_label_n else None),
            "bins": [],
        }
        for b in range(self.bins):
            nb = int(self.n[b])
            out["bins"].append({
                "lo": b / self.bins, "hi": (b + 1) / self.bins, "n": nb,
                "confidence": (self.conf_sum[b] / nb) if nb else None,
                "accuracy": (self.hit_sum[b] / nb) if nb else None,
            })
        return out


class CalibrationMonitor:
    """Thread-safe per-task calibration accumulators (batcher thread
    writes, HTTP workers read)."""

    def __init__(self, bins: int = N_CALIBRATION_BINS):
        self.bins = bins
        self._lock = threading.Lock()
        self._tasks: dict[str, CalibrationBuckets] = {}

    def observe(self, task: str, conf: float, hit: bool,
                p_label: Optional[float] = None) -> None:
        with self._lock:
            bk = self._tasks.get(task)
            if bk is None:
                bk = self._tasks[task] = CalibrationBuckets(self.bins)
            bk.observe(conf, hit, p_label)

    def snapshot(self) -> dict:
        with self._lock:
            return {task: bk.snapshot()
                    for task, bk in sorted(self._tasks.items())}

    def worst_ece(self, min_samples: int = CALIBRATION_MIN_SAMPLES
                  ) -> Optional[float]:
        """The worst per-task ECE among tasks with enough evidence, or
        None when no task has any (the SLO probe's no-data case)."""
        worst = None
        with self._lock:
            for bk in self._tasks.values():
                if bk.total < min_samples:
                    continue
                e = bk.ece()
                if e is not None:
                    worst = e if worst is None else max(worst, e)
        return worst


def reliability_curve(conf, hit, bins: int = N_CALIBRATION_BINS) -> dict:
    """One-shot calibration verdict over paired arrays (offline twin of
    the streaming monitor — bench/suite calls it on ground-truth runs)."""
    bk = CalibrationBuckets(bins)
    for c, h in zip(np.asarray(conf, np.float64).ravel(),
                    np.asarray(hit).ravel()):
        bk.observe(float(c), bool(h))
    return bk.snapshot()


def pbest_calibration(pbest_max, regret, bins: int = N_CALIBRATION_BINS
                      ) -> dict:
    """P(best)-vs-realized-best calibration for ground-truth runs.

    ``pbest_max`` is the per-round posterior mass on the current argmax
    model; the argmax *was* (one of) the realized best models exactly
    when that round's ``regret`` is 0 — both arrays ride every flight
    record (``engine/replay.record_calibration`` adapts a
    :class:`~coda_tpu_torch.telemetry.recorder.RunRecord` onto this)."""
    conf = np.asarray(pbest_max, np.float64).ravel()
    hit = np.asarray(regret, np.float64).ravel() <= 0.0
    keep = np.isfinite(conf)
    return reliability_curve(conf[keep], hit[keep], bins)


# ---------------------------------------------------------------------------
# drift detectors
# ---------------------------------------------------------------------------

class CusumDetector:
    """One-sided CUSUM over a scalar stream: ``s ← max(0, s + x − μ0 − k)``,
    fire at ``s ≥ h``, clear once the statistic drains back to ``≤ clear``
    (in-control samples shrink it by ``μ0 + k − x`` each). Injectable
    clock so tests drive fire/clear without sleeping."""

    def __init__(self, name: str, mu0: float, k: float, h: float,
                 clear: float = 0.0,
                 clock: Callable[[], float] = time.monotonic):
        self.name = name
        self.mu0 = float(mu0)
        self.k = float(k)
        self.h = float(h)
        self.clear = float(clear)
        self._clock = clock
        self.s = 0.0
        self.firing = False
        self.fired_total = 0
        self.cleared_total = 0
        self.observations = 0
        self.last_value: Optional[float] = None
        self.last_transition_t: Optional[float] = None

    def observe(self, x: float, t: Optional[float] = None) -> Optional[str]:
        """Feed one sample; returns ``"fired"`` / ``"cleared"`` on a
        transition, else None."""
        t = self._clock() if t is None else float(t)
        self.observations += 1
        self.last_value = float(x)
        self.s = max(0.0, self.s + float(x) - self.mu0 - self.k)
        if not self.firing and self.s >= self.h:
            self.firing = True
            self.fired_total += 1
            self.last_transition_t = t
            return "fired"
        if self.firing and self.s <= self.clear:
            self.firing = False
            self.cleared_total += 1
            self.last_transition_t = t
            return "cleared"
        return None

    def snapshot(self) -> dict:
        return {"kind": "cusum", "statistic": self.s, "firing": self.firing,
                "fired_total": self.fired_total,
                "cleared_total": self.cleared_total,
                "observations": self.observations,
                "last_value": self.last_value,
                "mu0": self.mu0, "k": self.k, "h": self.h}


class PageHinkley:
    """Page-Hinkley mean-shift test: ``m ← m + x − x̄ − δ``; fire when
    ``m − min(m) > λ``; clearing resets the statistic (the classic PH has
    no clear — after a confirmed shift the new regime is the baseline)."""

    def __init__(self, name: str, delta: float, lam: float,
                 clock: Callable[[], float] = time.monotonic):
        self.name = name
        self.delta = float(delta)
        self.lam = float(lam)
        self._clock = clock
        self.mean = 0.0
        self.m = 0.0
        self.m_min = 0.0
        self.firing = False
        self.fired_total = 0
        self.cleared_total = 0
        self.observations = 0
        self.last_value: Optional[float] = None
        self.last_transition_t: Optional[float] = None

    def observe(self, x: float, t: Optional[float] = None) -> Optional[str]:
        t = self._clock() if t is None else float(t)
        x = float(x)
        self.observations += 1
        self.last_value = x
        self.mean += (x - self.mean) / self.observations
        self.m += x - self.mean - self.delta
        self.m_min = min(self.m_min, self.m)
        ph = self.m - self.m_min
        if not self.firing and ph > self.lam:
            self.firing = True
            self.fired_total += 1
            self.last_transition_t = t
            return "fired"
        if self.firing and ph <= self.lam * 0.5:
            # the shifted stream settled (or reverted): re-baseline so the
            # detector arms for the NEXT shift instead of latching forever
            self.firing = False
            self.cleared_total += 1
            self.last_transition_t = t
            self.mean = x
            self.m = self.m_min = 0.0
            self.observations = 1
            return "cleared"
        return None

    def snapshot(self) -> dict:
        return {"kind": "page_hinkley", "statistic": self.m - self.m_min,
                "firing": self.firing, "fired_total": self.fired_total,
                "cleared_total": self.cleared_total,
                "observations": self.observations,
                "last_value": self.last_value,
                "delta": self.delta, "lambda": self.lam}


class DriftBank:
    """A named set of drift detectors behind one thread-safe feed."""

    def __init__(self, detectors=()):
        self._lock = threading.Lock()
        self._detectors = {d.name: d for d in detectors}

    def add(self, detector) -> None:
        with self._lock:
            self._detectors[detector.name] = detector

    def observe(self, name: str, x: float,
                t: Optional[float] = None) -> Optional[str]:
        with self._lock:
            d = self._detectors.get(name)
            if d is None:
                return None
            return d.observe(x, t)

    def any_firing(self) -> bool:
        with self._lock:
            return any(d.firing for d in self._detectors.values())

    def snapshot(self) -> dict:
        with self._lock:
            return {name: d.snapshot()
                    for name, d in sorted(self._detectors.items())}


def default_drift_bank(clock: Callable[[], float] = time.monotonic
                       ) -> DriftBank:
    """The serve plane's stock detectors, one per approximation contract:

    * ``surrogate_residual`` — CUSUM over the live gate-pressure signal
      (:func:`~coda_tpu_torch.selectors.surrogate.gate_pressure`): healthy
      fits hold pressure near 0; sustained pressure toward 1 means the
      audit-set residual is eating the 2.34e-4 contract.
    * ``prior_staleness`` — CUSUM over the pool's staleness-regret
      estimate (gate rejections per credited warmup round, fused with
      the auditor's seeded-vs-cold gap): the learned-decay sensor.
    * ``crowd_reliability`` — Page-Hinkley over the annotator posterior's
      accuracy movement (:func:`~coda_tpu_torch.crowd.reliability
      .accuracy_movement`): a sustained shift means the crowd changed
      under the fleet.
    """
    return DriftBank([
        CusumDetector("surrogate_residual", mu0=0.1, k=0.05, h=2.0,
                      clear=0.5, clock=clock),
        CusumDetector("prior_staleness", mu0=0.05, k=0.05, h=1.5,
                      clear=0.25, clock=clock),
        PageHinkley("crowd_reliability", delta=0.005, lam=0.25,
                    clock=clock),
    ])


# ---------------------------------------------------------------------------
# shadow auditor
# ---------------------------------------------------------------------------

def tamper_rows_ulp(rows: list, round_i: Optional[int] = None) -> list:
    """Flip ONE float quantity of one decision row by a single ulp — the
    smallest representable stream corruption, the tamper the auditor must
    still catch (bitwise replay admits nothing less). Returns a deep-ish
    copy; the caller's rows are untouched."""
    rows = [dict(r) for r in rows]
    if not rows:
        return rows
    i = len(rows) // 2 if round_i is None else int(round_i)
    i = min(max(i, 0), len(rows) - 1)
    row = rows[i]
    for q in ("next_prob", "pbest_max", "pbest_entropy"):
        v = row.get(q)
        if v is None:
            continue
        if isinstance(v, (list, tuple)):
            v2 = list(v)
            v2[0] = float(np.nextafter(np.float32(v2[0]), np.float32(np.inf)))
            row[q] = v2
        else:
            row[q] = float(np.nextafter(np.float32(v), np.float32(np.inf)))
        return rows
    # all-None digests (method without get_pbest): flip the int pick
    row["next_idx"] = (int(row["next_idx"]) + 1
                       if not isinstance(row["next_idx"], list)
                       else [int(row["next_idx"][0]) + 1]
                       + [int(v) for v in row["next_idx"][1:]])
    return rows


class ShadowAuditor:
    """Bitwise re-replay of sampled session streams through scratch slots.

    Reuses the recovery machinery verbatim — ``stage_fresh`` +
    per-round ``dispatch`` + ``check_row`` — so the auditor's verdict IS
    the restore/import contract, continuously enforced in production.
    Replay runs on the caller's (worker) thread; each round takes the
    bucket's dispatch lock like any label request, so live sessions are
    never perturbed (masked dispatch touches only the scratch slot's
    state/key rows).

    ``faults`` (optional :class:`~coda_tpu_torch.serve.faults.FaultInjector`)
    arms the ``stream_tamper`` site: when it fires, the auditor's
    in-memory copy of the rows is ulp-tampered BEFORE replay — the
    end-to-end detection drill the bench runs (the session's real stream
    is untouched)."""

    def __init__(self, faults=None, registry=None, recent_s: float = 600.0,
                 clock: Callable[[], float] = time.monotonic,
                 measure_prior_gap: bool = True):
        self.faults = faults
        self.registry = registry
        self.recent_s = float(recent_s)
        self._clock = clock
        self.measure_prior_gap = measure_prior_gap
        self._lock = threading.Lock()
        self.audits_total = 0
        self.audits_skipped = 0      # SlabFull / empty stream / quarantine
        self.rounds_verified = 0
        self.divergences_total = 0
        self.tampered_total = 0      # audits whose rows the fault corrupted
        # (t, {"session", "round", "detail"}) — recent() drives the SLO
        # probe, the bounded deque keeps the /fleet/quality evidence
        self._divergences: collections.deque = collections.deque(maxlen=256)
        # seeded-vs-cold warmup gap EWMA over audited pool-seeded sessions
        self.prior_gap: Optional[float] = None
        self.prior_gap_sessions = 0

    # -- verdict plumbing --------------------------------------------------
    def _record_divergence(self, sid: str, round_i: Optional[int],
                           detail: str) -> None:
        t = self._clock()
        with self._lock:
            self.divergences_total += 1
            self._divergences.append(
                (t, {"session": sid, "round": round_i, "detail": detail}))
        if self.registry is not None:
            # distinct name from the snapshot-driven exposition family
            # (quality_audit_divergences_total) — the registry copy rides
            # the telemetry.json shutdown artifact
            self.registry.counter(
                "quality_shadow_divergences_total",
                "Shadow-audit replays that diverged bitwise from their "
                "recorded stream").inc()

    def recent_divergences(self, now: Optional[float] = None) -> int:
        now = self._clock() if now is None else float(now)
        cutoff = now - self.recent_s
        with self._lock:
            return sum(1 for t, _ in self._divergences if t >= cutoff)

    # -- the audit ---------------------------------------------------------
    def audit(self, bucket, sid: str, seed: int, rows,
              prior: Optional[dict] = None,
              task: Optional[str] = None) -> dict:
        """Replay one closed session's stream through a scratch slot and
        verify every round bitwise. Returns the verdict dict (also folded
        into the counters)."""
        from coda_tpu_torch.serve.recovery import (
            ReplayMismatch,
            _request_from_row,
            check_row,
            data_rows,
        )
        from coda_tpu_torch.serve.state import SlabFull

        rows = data_rows(rows)
        if not rows:
            with self._lock:
                self.audits_skipped += 1
            return {"session": sid, "status": "skipped", "reason": "empty"}
        tampered = False
        if self.faults is not None and "stream_tamper" in \
                self.faults.fire("audit_pre", task=task):
            rows = tamper_rows_ulp(rows)
            tampered = True
            with self._lock:
                self.tampered_total += 1
        try:
            slot = bucket.allocate(seed, prior=prior)
        except SlabFull:
            # a full slab means live traffic owns every slot — auditing is
            # strictly lower priority, skip rather than block admission
            with self._lock:
                self.audits_skipped += 1
            return {"session": sid, "status": "skipped", "reason": "full"}
        verdict: dict = {"session": sid, "status": "ok",
                         "rounds": len(rows), "tampered": tampered}
        try:
            # allocate() already staged the fresh init for (seed, prior) —
            # the same stage_fresh choreography import_session replays from
            replayed = []
            for k, row in enumerate(rows):
                with bucket.lock:
                    res = bucket.dispatch({slot: _request_from_row(row)})[slot]
                replayed.append(res)
                try:
                    check_row(row, res, k, sid=sid)
                except ReplayMismatch as e:
                    self._record_divergence(sid, k, str(e))
                    verdict.update(status="diverged", round=k, detail=str(e))
                    break
            if verdict["status"] == "ok" and prior is not None \
                    and self.measure_prior_gap:
                verdict["prior_gap"] = self._cold_gap(bucket, seed, rows,
                                                      replayed)
        except Exception as e:  # quarantine/step failure: not a divergence
            with self._lock:
                self.audits_skipped += 1
            return {"session": sid, "status": "skipped", "reason": repr(e)}
        finally:
            bucket.release(slot)
        with self._lock:
            self.audits_total += 1
            if verdict["status"] == "ok":
                self.rounds_verified += len(rows)
        if self.registry is not None:
            self.registry.counter(
                "quality_shadow_audits_total",
                "Sessions re-replayed by the shadow auditor").inc()
        return verdict

    def _cold_gap(self, bucket, seed: int, rows, seeded_results) -> float:
        """Fraction of rounds where a COLD replay (no pool prior) picks a
        different point than the recorded seeded run — the seeded-vs-cold
        warmup gap, the live estimate of what the pool prior is actually
        changing (a stale prior's gap collapses toward noise)."""
        from coda_tpu_torch.serve.recovery import _request_from_row
        from coda_tpu_torch.serve.state import SlabFull

        try:
            slot = bucket.allocate(seed, prior=None)
        except SlabFull:
            return self.prior_gap if self.prior_gap is not None else 0.0
        try:
            diff = 0
            for row, seeded in zip(rows, seeded_results):
                with bucket.lock:
                    res = bucket.dispatch(
                        {slot: _request_from_row(row)})[slot]
                if res["next_idx"] != seeded["next_idx"]:
                    diff += 1
        finally:
            bucket.release(slot)
        gap = diff / max(1, len(rows))
        with self._lock:
            self.prior_gap_sessions += 1
            self.prior_gap = gap if self.prior_gap is None \
                else 0.8 * self.prior_gap + 0.2 * gap
        return gap

    def snapshot(self, now: Optional[float] = None) -> dict:
        with self._lock:
            recent = list(self._divergences)[-8:]
            snap = {
                "audits_total": self.audits_total,
                "audits_skipped": self.audits_skipped,
                "rounds_verified": self.rounds_verified,
                "divergences_total": self.divergences_total,
                "tampered_total": self.tampered_total,
                "prior_gap": self.prior_gap,
                "prior_gap_sessions": self.prior_gap_sessions,
                "recent_window_s": self.recent_s,
            }
        snap["divergences_recent"] = self.recent_divergences(now)
        snap["last_divergences"] = [d for _, d in recent]
        return snap


# ---------------------------------------------------------------------------
# the plane
# ---------------------------------------------------------------------------

def _sample_hash(sid: str) -> float:
    """Deterministic [0, 1) coordinate of a session id — the audit
    sampling decision is a property of the sid, reproducible across
    replicas and restarts (no RNG state to carry)."""
    h = hashlib.sha1(sid.encode()).digest()
    return int.from_bytes(h[:8], "big") / float(1 << 64)


class QualityPlane:
    """The serving layer's decision-quality facade.

    ``preds_fn(task) -> (H, N, C) ndarray`` resolves the task's prediction
    tensor (``SessionStore.task_preds``); everything else is optional.
    The batcher calls :meth:`pre_dispatch` under the bucket lock just
    before each dispatch — a pure read (pre-update ``pbest`` + the static
    preds tensor) that computes the consensus ``pi_hat`` evidence, feeds
    the calibration monitor, and hands back the per-slot
    ``pred_label_prob`` the recorder row carries. Close-time,
    :meth:`maybe_enqueue_audit` samples sessions into the background
    audit worker."""

    def __init__(self, preds_fn=None, faults=None, registry=None,
                 audit_frac: float = 0.25, recent_s: float = 600.0,
                 clock: Callable[[], float] = time.monotonic,
                 measure_prior_gap: bool = True):
        self.preds_fn = preds_fn
        self.registry = registry
        self.audit_frac = float(audit_frac)
        self._clock = clock
        self.calibration = CalibrationMonitor()
        self.drift = default_drift_bank(clock)
        self.auditor = ShadowAuditor(faults=faults, registry=registry,
                                     recent_s=recent_s, clock=clock,
                                     measure_prior_gap=measure_prior_gap)
        self._queue: queue.Queue = queue.Queue(maxsize=256)
        self._worker: Optional[threading.Thread] = None
        self._stop = threading.Event()
        self.audit_queue_drops = 0
        self.pre_dispatch_errors = 0
        self._lock = threading.Lock()

    # -- batcher seam ------------------------------------------------------
    def pre_dispatch(self, bucket, task: str, labeled: list) -> dict:
        """Consensus-posterior evidence for one tick's labeled requests.

        ``labeled`` is ``[(slot, idx, label), ...]`` where ``idx``/
        ``label`` are scalars or q-wide lists (the batch-label rows).
        Called UNDER the bucket's dispatch lock so the ``pbest`` read is
        the exact pre-update posterior the recorded round was decided
        under. Returns ``{slot: pred_label_prob}`` (scalar or q-wide
        list, matching the row shape); slots whose method exposes no
        posterior are absent."""
        out: dict = {}
        if not labeled:
            return out
        try:
            preds = self.preds_fn(task) if self.preds_fn else None
            if preds is None:
                return out
            # every labeled slot's P(best) in one gather and one copy when
            # the bucket offers it; plain pbest() keeps other buckets
            rows_at = getattr(bucket, "pbest_rows", None)
            if rows_at is not None:
                got = rows_at([slot for slot, _, _ in labeled])
                rows = ([None] * len(labeled) if got is None
                        else list(got))
            else:
                rows = [bucket.pbest(slot) for slot, _, _ in labeled]
            for (slot, idx, label), pb in zip(labeled, rows):
                if pb is None:
                    continue
                pb = np.asarray(pb, np.float64)
                s = pb.sum()
                if not np.isfinite(s) or s <= 0:
                    continue
                pb = pb / s
                idxs = idx if isinstance(idx, (list, tuple)) else [idx]
                labs = label if isinstance(label, (list, tuple)) else [label]
                probs = []
                for i, y in zip(idxs, labs):
                    pi = pb @ preds[:, int(i), :]        # (C,) consensus
                    z = pi.sum()
                    pi = pi / z if z > 0 else pi
                    y = int(y)
                    p_label = float(pi[y]) if 0 <= y < pi.shape[0] else 0.0
                    probs.append(p_label)
                    conf = float(pi.max())
                    self.calibration.observe(task, conf,
                                             int(np.argmax(pi)) == y,
                                             p_label)
                out[slot] = (probs if isinstance(idx, (list, tuple))
                             else probs[0])
        except Exception:
            # evidence collection must never fail a label request; the
            # counter keeps the failure visible instead of silent
            with self._lock:
                self.pre_dispatch_errors += 1
            return {}
        return out

    # -- audit sampling ----------------------------------------------------
    def should_audit(self, sid: str) -> bool:
        return _sample_hash(sid) < self.audit_frac

    def maybe_enqueue_audit(self, bucket, sid: str, seed: int, rows,
                            prior: Optional[dict] = None,
                            task: Optional[str] = None) -> bool:
        """Close-time hook: sample the session, snapshot its stream, and
        hand it to the worker thread. Never blocks (a full queue drops
        the audit and counts it)."""
        if not rows or not self.should_audit(sid):
            return False
        job = {"bucket": bucket, "sid": sid, "seed": int(seed),
               "rows": [dict(r) for r in rows], "prior": prior,
               "task": task}
        try:
            self._queue.put_nowait(job)
        except queue.Full:
            with self._lock:
                self.audit_queue_drops += 1
            return False
        self._ensure_worker()
        return True

    def _ensure_worker(self) -> None:
        with self._lock:
            if self._worker is not None and self._worker.is_alive():
                return
            self._worker = threading.Thread(
                target=self._worker_loop, name="quality-audit", daemon=True)
            self._worker.start()

    def _worker_loop(self) -> None:
        while not self._stop.is_set():
            try:
                job = self._queue.get(timeout=0.5)
            except queue.Empty:
                continue
            try:
                self.auditor.audit(job["bucket"], job["sid"], job["seed"],
                                   job["rows"], prior=job["prior"],
                                   task=job["task"])
            except Exception:
                pass  # the auditor is advisory; a crash must not recur-kill
            finally:
                self._queue.task_done()

    def drain(self, timeout: float = 10.0) -> bool:
        """Block until every queued audit ran (bench/test determinism)."""
        deadline = time.monotonic() + timeout
        while time.monotonic() < deadline:
            if self._queue.unfinished_tasks == 0:
                return True
            time.sleep(0.01)
        return self._queue.unfinished_tasks == 0

    def stop(self) -> None:
        self._stop.set()

    # -- drift feed --------------------------------------------------------
    def observe_drift(self, name: str, x: float,
                      t: Optional[float] = None) -> Optional[str]:
        return self.drift.observe(name, x, t)

    def feed_serve_stats(self, buckets: list, prior_totals: dict) -> None:
        """Fold one /stats pass's live signals into the detectors:
        surrogate gate pressure (worst bucket) and the prior pool's
        live staleness-regret estimate (gate rejections per credited
        warmup round, blended with the auditor's seeded-vs-cold gap
        complement when it has evidence)."""
        from coda_tpu_torch.selectors.surrogate import gate_pressure

        pressures = [gate_pressure(b["surrogate"].get("contract_margin"))
                     for b in buckets or ()
                     if isinstance(b.get("surrogate"), dict)]
        if pressures:
            self.observe_drift("surrogate_residual", max(pressures))
        credited = (prior_totals or {}).get("prior_warmup_rounds_skipped")
        rejects = (prior_totals or {}).get("prior_gate_rejections")
        if credited:
            regret = min(1.0, (rejects or 0) / max(1, credited))
            gap = self.auditor.prior_gap
            if gap is not None:
                # a HEALTHY prior shows a large seeded-vs-cold gap (it is
                # actually steering warmup); staleness is the complement
                regret = 0.5 * regret + 0.5 * (1.0 - gap)
            self.observe_drift("prior_staleness", regret)

    # -- reading -----------------------------------------------------------
    def snapshot(self) -> dict:
        """The ``/stats``-embedded (and metrics-provider) payload."""
        with self._lock:
            drops = self.audit_queue_drops
            errors = self.pre_dispatch_errors
        return {
            "audit_frac": self.audit_frac,
            "calibration": self.calibration.snapshot(),
            "drift": self.drift.snapshot(),
            "audit": self.auditor.snapshot(),
            "audit_queue_drops": drops,
            "pre_dispatch_errors": errors,
        }

    def scorecard(self) -> dict:
        """The ``GET /fleet/quality`` verdict: the snapshot plus one
        summary grade per organ."""
        snap = self.snapshot()
        ece = self.calibration.worst_ece()
        audit = snap["audit"]
        snap["verdict"] = {
            "calibration": ("no_data" if ece is None
                            else ("ok" if ece <= 0.25 else "miscalibrated")),
            "worst_ece": ece,
            "audit": ("diverged" if audit["divergences_recent"] > 0
                      else ("ok" if audit["audits_total"] else "no_data")),
            "drift": "firing" if self.drift.any_firing() else "ok",
        }
        return snap

    def log_to_store(self, store, run_name: str = "quality-snapshot",
                     params: Optional[dict] = None) -> str:
        """Flush the scalar quality evidence into the MLflow-schema
        tracking store (experiment ``serve_quality``), next to the SLO
        transitions and telemetry counters."""
        snap = self.snapshot()
        with store.run("serve_quality", run_name,
                       params=params or {}) as run:
            audit = snap["audit"]
            for key in ("audits_total", "rounds_verified",
                        "divergences_total", "tampered_total"):
                run.log_metric(f"audit_{key}", float(audit[key]))
            if audit["prior_gap"] is not None:
                run.log_metric("audit_prior_gap", float(audit["prior_gap"]))
            for task, cal in snap["calibration"].items():
                if cal["ece"] is not None:
                    run.log_metric(f"ece.{task}", float(cal["ece"]))
                    run.log_metric(f"brier.{task}", float(cal["brier"]))
                run.log_metric(f"calibration_n.{task}", float(cal["n"]))
            for name, det in snap["drift"].items():
                run.log_metric(f"drift_firing.{name}",
                               1.0 if det["firing"] else 0.0)
                run.log_metric(f"drift_fired_total.{name}",
                               float(det["fired_total"]))
        return run.run_uuid


# ---------------------------------------------------------------------------
# SLO objectives
# ---------------------------------------------------------------------------

def quality_slos(max_ece: float = 0.25) -> list:
    """Quality objectives over ``SessionRouter.stats()`` snapshots, for
    registration next to :func:`~coda_tpu_torch.telemetry.slo
    .default_fleet_slos` in the same :class:`SloSweeper`. Each replica's
    /stats embeds the plane's snapshot under ``"quality"`` (absent with
    ``--no-quality`` → the objectives report no-data, never burn)."""
    from coda_tpu_torch.telemetry.slo import SLObjective, _replica_snaps

    def _quality_snaps(snapshot):
        return [s["quality"] for s in _replica_snaps(snapshot)
                if isinstance(s.get("quality"), dict)]

    def audit_divergence(snapshot):
        saw = None
        for q in _quality_snaps(snapshot):
            audit = q.get("audit") or {}
            if not audit.get("audits_total"):
                continue
            saw = saw or 0.0
            if (audit.get("divergences_recent") or 0) > 0:
                saw = 1.0
        return saw

    def calibration_ece(snapshot):
        saw = None
        for q in _quality_snaps(snapshot):
            for cal in (q.get("calibration") or {}).values():
                if (cal.get("n") or 0) < CALIBRATION_MIN_SAMPLES:
                    continue
                saw = saw or 0.0
                if (cal.get("ece") or 0.0) > max_ece:
                    saw = 1.0
        return saw

    def drift_firing(snapshot):
        saw = None
        for q in _quality_snaps(snapshot):
            drift = q.get("drift") or {}
            if not drift:
                continue
            saw = saw or 0.0
            if any(d.get("firing") for d in drift.values()):
                saw = 1.0
        return saw

    return [
        SLObjective("quality_audit_divergence",
                    "0 bitwise divergences from shadow-audited session "
                    "replays (recent window)", audit_divergence,
                    budget=0.001),
        SLObjective("quality_calibration_ece",
                    f"per-task streaming ECE <= {max_ece:g} once "
                    f"{CALIBRATION_MIN_SAMPLES} rounds of evidence exist",
                    calibration_ece, budget=0.01),
        SLObjective("quality_drift",
                    "no decision-quality drift detector firing "
                    "(surrogate residual / prior staleness / crowd "
                    "reliability)", drift_firing, budget=0.01),
    ]
