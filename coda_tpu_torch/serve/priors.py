"""Cross-session surrogate prior pool (``--surrogate-prior pool``;
counterpart of ``coda_tpu/serve/priors.py``: host-side float64 numpy,
the reference's arithmetic).

Every session that runs the surrogate scorer rung carries a private
:class:`~coda_tpu_torch.selectors.surrogate.SurrogateFit` seeded from zeros and
pays :data:`~coda_tpu_torch.selectors.surrogate.SURROGATE_WARMUP_ROUNDS` exact
rounds before the first surrogate-scored round can even be proposed. At
serve scale that warmup tax dominates cold-start cost — and it buys
nothing that a PREVIOUS session on the same (task, pool) did not already
pay for, because the fit is a ridge regression in normal-equation form:
its sufficient statistics ``(A = ΣFᵀF, b = ΣFᵀy, n)`` are pure sums,
mergeable across sessions by construction.

This module is the serve-side pool of those statistics:

  * sessions CONTRIBUTE at close and at demotion (exactly once each —
    ``Session.prior_contributed``), only when their fit saw at least
    :data:`~coda_tpu_torch.selectors.surrogate.SURROGATE_PRIOR_MIN_ROUNDS`
    audited rounds;
  * new sessions SEED from the merged pool (``Bucket.set_prior`` →
    admission applies :func:`~coda_tpu_torch.selectors.surrogate.seed_fit`),
    which grants warmup credit — but the per-round trust gate (escape
    hatch, audit rank, the score contract) is unchanged, so a selection
    is still never driven by an unaudited score: a prior that transfers
    badly fails its audits, increments ``prior_rejects`` on the slab
    carry, and the session falls back to exact scoring exactly as a
    cold session would;
  * replicas EXCHANGE deltas through the router, piggybacked on the
    health poll (the fleet's router, slice 9 of the port): each poll drains the replica's
    since-last-poll contributions, folds them into the router's global
    pool, and pushes the merged pool back — replicas REPLACE their pool
    with the router's so a contribution is never double-counted;
  * the pool SURVIVES restart via the tracking store
    (``log_artifact_bytes`` of :meth:`PriorPool.snapshot`).

Pools are keyed per (task, pool fingerprint): dataset digest + selector
method + spec kwargs MINUS the knobs that do not change the feature
space (the scorer's ``k``, ``surrogate_prior`` itself, ``acq_batch`` —
a q=8 session's fit statistics live in the same 16-feature space as a
q=1 session's and transfer across).

Staleness evidence: the pool timestamps every per-key touch
(contribute / merged delta / adopted snapshot) so ``/stats`` and
``/metrics`` carry ``prior_pool_staleness_seconds`` (the age of the
LEAST recently refreshed pool) and per-pool contribution ages — one half
of the learned-decay sensor the ROADMAP asks for; the decision-quality
plane's ``prior_staleness`` drift detector and the shadow auditor's
seeded-vs-cold gap (``telemetry/quality.py``) are the other half.
"""

from __future__ import annotations

import hashlib
import json
import threading
import time
from typing import Callable, Optional

from coda_tpu_torch.selectors.surrogate import (
    SURROGATE_PRIOR_DECAY,
    SURROGATE_PRIOR_MIN_ROUNDS,
    PriorStats,
    empty_prior,
    fold_prior,
    merge_fits,
    prior_from_dict,
    prior_from_fit,
    prior_to_dict,
)

#: spec kwargs that do NOT change the fit's feature space — excluded
#: from the pool fingerprint so statistics transfer across them
_FINGERPRINT_EXCLUDED = ("eig_scorer", "surrogate_prior", "acq_batch")


def pool_key(task: str, method: str, spec_kwargs, dataset_digest) -> str:
    """Stable pool key: task + dataset digest + method + the kwargs that
    shape the feature space."""
    kept = sorted((str(k), str(v)) for k, v in (spec_kwargs or ())
                  if str(k) not in _FINGERPRINT_EXCLUDED)
    h = hashlib.blake2b(digest_size=8)
    h.update(json.dumps([task, str(dataset_digest), method, kept],
                        separators=(",", ":")).encode())
    return f"{task}:{h.hexdigest()}"


def bucket_pool_key(app, bucket) -> str:
    """The pool key of one serve bucket (its task's dataset digest is in
    the store's task meta)."""
    meta = app.store.task_meta(bucket.task)
    return pool_key(bucket.task, bucket.spec.method, bucket.spec.kwargs,
                    meta.get("digest"))


class PriorPool:
    """Thread-safe map of pool key -> merged :class:`PriorStats`, plus
    the since-last-drain delta the router exchange ships.

    ``clock`` is injectable (wall-clock seconds) so staleness tests
    drive synthetic ages without sleeping."""

    def __init__(self, decay: float = SURROGATE_PRIOR_DECAY,
                 min_rounds: float = SURROGATE_PRIOR_MIN_ROUNDS,
                 clock: Callable[[], float] = time.time):
        self.decay = float(decay)
        self.min_rounds = float(min_rounds)
        self._clock = clock
        self._lock = threading.Lock()
        self._pools: dict[str, PriorStats] = {}
        self._delta: dict[str, PriorStats] = {}
        # key -> wall-clock second of the last statistic fold (the
        # staleness axis a learned decay schedule regresses against)
        self._touched: dict[str, float] = {}
        self.sessions_contributed = 0   # accepted contributions
        self.contributions_skipped = 0  # below min_rounds / degenerate

    # -- contribution ------------------------------------------------------
    def contribute(self, key: str, fit_stats: Optional[dict]) -> bool:
        """Fold one session's fit statistics (``{"A","b","n","rounds"}``
        — Bucket.fit_from_leaves' output, or a host read of the slot
        fit) into the pool. False (counted) when the fit is too green to
        teach anything: fewer than ``min_rounds`` audited rounds, or a
        degenerate pair count."""
        if fit_stats is None:
            return False
        try:
            rounds = float(fit_stats["rounds"])
            contrib = prior_from_fit(fit_stats["A"], fit_stats["b"],
                                     fit_stats["n"], rounds)
        except (KeyError, TypeError, ValueError):
            self.contributions_skipped += 1
            return False
        if rounds < self.min_rounds or contrib.n <= 0:
            self.contributions_skipped += 1
            return False
        with self._lock:
            self._pools[key] = fold_prior(
                self._pools.get(key, empty_prior()), contrib,
                decay=self.decay)
            # the delta is the raw sum of contributions since the last
            # drain — the router applies its own fold (decay + clip) when
            # it merges, so decay is never applied twice to one statistic
            self._delta[key] = merge_fits(
                self._delta.get(key, empty_prior()), contrib)
            self._touched[key] = self._clock()
            self.sessions_contributed += 1
        return True

    # -- seeding reads -----------------------------------------------------
    def get(self, key: str) -> Optional[PriorStats]:
        with self._lock:
            p = self._pools.get(key)
        if p is None or p.n <= 0 or p.rounds < self.min_rounds:
            # a pool that has seen less than one full warmup's worth of
            # audited rounds grants no credit worth recording
            return None
        return p

    def keys(self) -> list:
        with self._lock:
            return sorted(self._pools)

    # -- router exchange ---------------------------------------------------
    def drain_delta(self) -> dict:
        """The contributions since the last drain, JSON-safe; clears the
        delta (the replica side of the health-poll piggyback)."""
        with self._lock:
            delta, self._delta = self._delta, {}
        return {k: prior_to_dict(p) for k, p in delta.items()}

    def merge_delta(self, delta: dict, count: bool = True) -> int:
        """Fold a drained delta into this pool (the ROUTER side: one
        fold per drain, so each contribution is decayed once here).
        ``count=False`` skips the sessions_contributed bump — the
        replica's re-fold of its OWN just-drained delta after a pool
        push (sync_prior), where contribute() already counted it."""
        n = 0
        for key, d in (delta or {}).items():
            try:
                contrib = prior_from_dict(d)
            except (KeyError, TypeError, ValueError):
                continue
            if contrib.n <= 0:
                continue
            with self._lock:
                self._pools[key] = fold_prior(
                    self._pools.get(key, empty_prior()), contrib,
                    decay=self.decay)
                self._touched[key] = self._clock()
                if count:
                    self.sessions_contributed += max(
                        1, int(contrib.sessions))
            n += 1
        return n

    # -- persistence / replacement ----------------------------------------
    def snapshot(self) -> dict:
        """JSON-safe full-pool snapshot (tracking-store persistence and
        the router's push half of the exchange). ``touched`` carries the
        per-key contribution timestamps so staleness survives the
        exchange/restart round-trip — a pool that comes back from the
        router is as old as its statistics, not reborn at adoption."""
        with self._lock:
            return {"v": 1,
                    "sessions_contributed": self.sessions_contributed,
                    "touched": dict(self._touched),
                    "pools": {k: prior_to_dict(p)
                              for k, p in self._pools.items()}}

    def replace(self, snap: dict) -> int:
        """Adopt a snapshot wholesale (the REPLICA side of the exchange,
        and restart restore): replacing — not merging — is what keeps a
        replica's own just-drained contributions from double-counting
        when the router's merged pool comes back."""
        pools = {}
        for key, d in (snap or {}).get("pools", {}).items():
            try:
                pools[key] = prior_from_dict(d)
            except (KeyError, TypeError, ValueError):
                continue
        touched_in = (snap or {}).get("touched") or {}
        now = self._clock()
        with self._lock:
            self._pools = pools
            # keep the snapshot's ages where it has them; a key the
            # snapshot never timestamped (an older snapshot) reads as
            # touched now — fresh-by-assumption beats infinitely-stale
            self._touched = {
                key: float(touched_in[key])
                if isinstance(touched_in.get(key), (int, float)) else now
                for key in pools
            }
            n = len(pools)
            sc = (snap or {}).get("sessions_contributed")
            if isinstance(sc, (int, float)):
                self.sessions_contributed = max(
                    self.sessions_contributed, int(sc))
        return n

    # -- staleness ---------------------------------------------------------
    def pool_ages(self) -> dict:
        """Per-pool seconds since the last statistic fold."""
        now = self._clock()
        with self._lock:
            return {key: max(0.0, now - t)
                    for key, t in self._touched.items()}

    def staleness_seconds(self) -> Optional[float]:
        """Age of the LEAST recently refreshed pool (None when empty) —
        the scalar ``prior_pool_staleness_seconds`` gauge: the worst-case
        decay target a learned schedule has to answer for."""
        ages = self.pool_ages()
        return max(ages.values()) if ages else None

    def stats(self) -> dict:
        ages = self.pool_ages()
        with self._lock:
            return {
                "pools": len(self._pools),
                "sessions_contributed": self.sessions_contributed,
                "contributions_skipped": self.contributions_skipped,
                "pending_delta": len(self._delta),
                "rounds_pooled": float(sum(p.rounds
                                           for p in self._pools.values())),
                "staleness_seconds": (max(ages.values()) if ages else None),
                "pool_ages_seconds": {k: round(v, 3)
                                      for k, v in sorted(ages.items())},
            }
