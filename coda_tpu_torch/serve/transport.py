"""Hardened replica transport: deadlines, retries, budgets, breakers
(counterpart of ``coda_tpu/serve/transport.py``: pure host code, the same
logic, so one call sequence gives the same breaker states, retries and
jitter in both packages).

``HttpReplica`` started life as a bare ``urlopen`` with one fixed 60 s
timeout — fine inside one container, fatal across real hosts: a slow
``/healthz`` probe deserves 2 s, an import replaying a long stream
deserves minutes, a dropped packet deserves a retry, and a replica that
has failed five calls in a row deserves to stop being called at all.
This module is the shared policy layer both replica handle types route
every verb through:

  * **per-verb deadlines** (:data:`VERB_DEADLINES`) — each verb carries
    its own timeout instead of one blanket number; overridable per
    handle.
  * **bounded retries with jittered exponential backoff** — transport
    failures (connection refused/reset, deadline expired) retry only
    when the verb is idempotent at the replica: reads always; labels
    only when they carry a ``request_id`` (the dedupe cache makes the
    replay exactly-once); ``open``/``import``/``close``/``fence`` only
    on *not-sent* failures (connection refused — the request provably
    never reached the replica). The jitter is deterministic (counter-
    addressed hash, the ``serve/faults.py`` trick) so a failure replay
    is a replay.
  * **a per-replica retry budget** — a token bucket (retries spend,
    successes slowly refill) so a black-holed replica costs a bounded
    number of extra requests, not retries-times-traffic; exhaustion
    degrades to the typed retryable :class:`ReplicaUnavailable` (a 503
    at the front door), never a hang.
  * **a per-replica circuit breaker** — trip after K *consecutive*
    transport failures, fail fast while open, allow one half-open probe
    after the cooldown (the router's health poll is the natural probe),
    close on success. Breaker state feeds the router's eviction next to
    ``/healthz``, and is reported distinctly on ``/stats``.

The **in-process handle rides the same wrapper** for parity — which is
also what makes the fleet fault matrix honest: the per-edge transport
faults (``net_drop``/``net_delay``/``net_dup``/``partition``/
``flap_healthz``, ``serve/faults.py``) fire inside :meth:`ReplicaTransport
.call`, so an in-process fleet exercises the exact retry/breaker/fencing
machinery a cross-host one would.
"""

from __future__ import annotations

import hashlib
import time
from typing import Callable, Optional

from coda_tpu_torch.serve.state import (
    BucketQuarantined,
    SlabFull,
    StaleOwner,
    UnknownSession,
)

#: per-verb deadlines (seconds) — the replacement for the fixed 60 s
#: blanket timeout. ``import``/``export`` budget for stream replay of a
#: long session; ``healthz`` must fail fast (it gates eviction).
VERB_DEADLINES = {
    "open": 60.0,
    "label": 60.0,
    "labels": 60.0,
    "best": 30.0,
    "trace": 60.0,
    "close": 30.0,
    "export": 120.0,
    "import": 180.0,
    "fence": 30.0,
    "stats": 30.0,
    "healthz": 5.0,
    "sessions": 60.0,
    "epoch": 10.0,
    # distributed-trace span fetch (GET /trace/id/{id}): a small read
    # the router's stitcher fans out per replica
    "trace_by_id": 10.0,
    # the prior-pool exchange rides the health cadence but moves a
    # payload (the merged pool), so it gets stats-class headroom
    "prior_sync": 30.0,
}

#: verbs that are idempotent at the replica regardless of payload: a
#: duplicate delivery (retry after a lost response) changes nothing
_IDEMPOTENT_VERBS = frozenset(
    {"best", "trace", "stats", "healthz", "sessions", "export", "epoch",
     "trace_by_id"})

#: verbs retried only when the caller proves idempotency (request_id
#: dedupe for labels); otherwise only not-sent failures retry
_GATED_VERBS = frozenset({"label", "labels"})


class ReplicaUnavailable(SlabFull):
    """Typed fast-fail: the replica's circuit is open or its retry
    budget is exhausted. Subclasses :class:`SlabFull` so the HTTP front
    door answers the same retryable 503 as every other backpressure
    signal, and the router's failover path treats it like a dead edge."""


class TransportDrop(ConnectionError):
    """An injected transport fault (net_drop / partition) ate the call —
    raised where a real lossy edge would raise ``ConnectionError``."""


def _jitter(replica_id: str, verb: str, n: int) -> float:
    """Deterministic backoff jitter in [0.5, 1.5): a counter-addressed
    hash draw (same trick as ``serve/faults.py``), so a chaos run with a
    fixed fault spec retries at reproducible instants."""
    h = hashlib.sha256(f"{replica_id}:{verb}:{n}".encode()).digest()
    return 0.5 + int.from_bytes(h[:8], "big") / float(1 << 64)


class CircuitBreaker:
    """Trip after ``threshold`` consecutive failures; half-open one probe
    after ``cooldown_s``; close on the probe's success. Locked: the
    router's verb pool and the health poller share one breaker per
    replica, and exactly-one-probe / trip-at-exactly-K are
    check-then-act sequences a race would corrupt."""

    def __init__(self, threshold: int = 5, cooldown_s: float = 1.0):
        import threading

        self.threshold = int(threshold)
        self.cooldown_s = float(cooldown_s)
        self.consecutive_failures = 0
        self.trips = 0
        self._opened_at: Optional[float] = None
        self._probing = False
        self._lock = threading.Lock()

    @property
    def state(self) -> str:
        with self._lock:
            if self._opened_at is None:
                return "closed"
            if self._probing or (time.monotonic() - self._opened_at
                                 >= self.cooldown_s):
                return "half_open"
            return "open"

    def allow(self) -> bool:
        """Whether a call may proceed now. In the half-open window only
        ONE caller gets through (the probe); the rest fail fast until it
        resolves."""
        with self._lock:
            if self._opened_at is None:
                return True
            if self._probing:
                return False  # a probe is in flight; everyone else waits
            if time.monotonic() - self._opened_at >= self.cooldown_s:
                self._probing = True
                return True
            return False

    def record_success(self) -> None:
        with self._lock:
            self.consecutive_failures = 0
            self._opened_at = None
            self._probing = False

    def record_failure(self) -> None:
        with self._lock:
            self.consecutive_failures += 1
            if self._probing:
                # failed probe: re-open for a fresh cooldown
                self._opened_at = time.monotonic()
                self._probing = False
                self.trips += 1
            elif self._opened_at is None and \
                    self.consecutive_failures >= self.threshold:
                self._opened_at = time.monotonic()
                self.trips += 1


class RetryBudget:
    """Token bucket bounding the retry amplification one replica can
    cost: each retry spends one token, each success refunds a fraction,
    capped. An unreachable replica under heavy traffic burns the budget
    once and then fails fast instead of multiplying every request.
    Locked: take() is a read-modify-write shared across the verb pool."""

    def __init__(self, capacity: float = 16.0, refund: float = 0.1):
        import threading

        self.capacity = float(capacity)
        self.refund = float(refund)
        self.tokens = float(capacity)
        self.exhaustions = 0
        self._lock = threading.Lock()

    def take(self) -> bool:
        with self._lock:
            if self.tokens >= 1.0:
                self.tokens -= 1.0
                return True
            self.exhaustions += 1
            return False

    def credit(self) -> None:
        with self._lock:
            self.tokens = min(self.capacity, self.tokens + self.refund)


class ReplicaTransport:
    """The per-replica call policy both handle types share (see module
    docstring). ``faults`` is the edge's deterministic injector (usually
    the router's, installed by ``add_replica``); ``spans`` likewise — a
    retry shows up as a ``retry/<verb>`` span nested under the router's
    ``route/<verb>`` lane, so retry cost is attributed in the same trace
    vocabulary as everything else."""

    #: exceptions that mean THE TRANSPORT failed (vs. the app answering)
    TRANSPORT_ERRORS = (ConnectionError, TimeoutError, OSError)

    def __init__(self, replica_id: str, deadlines: Optional[dict] = None,
                 max_retries: int = 2, backoff_s: float = 0.02,
                 breaker_threshold: int = 5, breaker_cooldown_s: float = 1.0,
                 retry_budget: float = 16.0, faults=None, spans=None):
        import threading

        self.replica_id = replica_id
        self.deadlines = dict(VERB_DEADLINES)
        if deadlines:
            self.deadlines.update(deadlines)
        self.max_retries = int(max_retries)
        self.backoff_s = float(backoff_s)
        self.breaker = CircuitBreaker(breaker_threshold, breaker_cooldown_s)
        self.budget = RetryBudget(retry_budget)
        self.faults = faults
        self.spans = spans
        # counters below mutate under this lock (verb pool + poller)
        self._lock = threading.Lock()
        self.calls = 0
        self.failures = 0
        self.retries_total = 0
        self.retries_by_verb: dict[str, int] = {}
        self._jitter_n = 0

    # -- policy ------------------------------------------------------------
    def deadline(self, verb: str) -> float:
        return float(self.deadlines.get(verb, 60.0))

    def _retryable(self, verb: str, err: BaseException,
                   idempotent: bool) -> bool:
        if isinstance(err, (ConnectionRefusedError, TransportDrop)):
            return True  # provably never reached the replica (the drop
            #              fault fires before the send, like a refusal)
        if verb in _IDEMPOTENT_VERBS:
            return True
        if verb in _GATED_VERBS:
            return idempotent  # request_id present -> replica dedupes
        if verb == "fence":
            return idempotent  # a drop-fence replays safely (close twice)
        return False  # open/import/close: ambiguous-outcome verbs

    # -- fault injection (the per-edge chaos sites) ------------------------
    def _fire_edge(self, verb: str):
        """One arrival at this router↔replica edge. Returns the fired
        names (``net_dup``/``flap_healthz`` are applied by the caller);
        raises :class:`TransportDrop` for drop/partition; sleeps for
        ``net_delay``."""
        if self.faults is None:
            return []
        fired = self.faults.fire("edge_call", task=verb,
                                 edge=self.replica_id)
        if verb == "healthz":
            fired += self.faults.fire("edge_healthz",
                                      edge=self.replica_id)
        if "net_drop" in fired or "partition" in fired:
            self.breaker.record_failure()
            raise TransportDrop(
                f"injected {'partition' if 'partition' in fired else 'drop'}"
                f" on edge ->{self.replica_id} ({verb})")
        return fired

    # -- the call path -----------------------------------------------------
    def call(self, verb: str, fn: Callable[[float], object],
             idempotent: bool = False):
        """Run one verb through the full policy. ``fn(deadline_s)`` does
        the actual send (an HTTP request, or the in-process method);
        app-level answers — including app-level *errors* like
        ``UnknownSession`` or the :class:`~coda_tpu_torch.serve.state
        .StaleOwner` fencing rejection — count as transport SUCCESS (the
        edge worked; the answer is the answer)."""
        deadline = self.deadline(verb)
        attempt = 0
        while True:
            if not self.breaker.allow():
                raise ReplicaUnavailable(
                    f"replica {self.replica_id}: circuit "
                    f"{self.breaker.state} after "
                    f"{self.breaker.consecutive_failures} consecutive "
                    "transport failures")
            with self._lock:
                self.calls += 1
            try:
                fired = self._fire_edge(verb)
                if verb == "healthz" and "flap_healthz" in fired:
                    # the injected flap: the probe "answers" unready
                    # without touching the replica — the hysteresis
                    # scenario's whole point
                    self.breaker.record_success()
                    return {"ok": False, "ready": False,
                            "status": "unready", "draining": False,
                            "problems": ["flap_healthz_injected"]}
                out = fn(deadline)
                if "net_dup" in fired:
                    # duplicate delivery: the request reaches the replica
                    # twice (a retransmitted packet) — the second copy's
                    # answer is discarded, and the replica's request_id
                    # dedupe is what keeps the posterior exactly-once
                    try:
                        fn(deadline)
                    except Exception:
                        pass
                self.breaker.record_success()
                self.budget.credit()
                return out
            except (UnknownSession, StaleOwner, SlabFull,
                    BucketQuarantined, ValueError, KeyError) as e:
                # the replica ANSWERED (with an app-level error): the
                # transport is healthy — but not if we fast-failed before
                # sending (ReplicaUnavailable is transport state)
                if not isinstance(e, ReplicaUnavailable):
                    self.breaker.record_success()
                raise
            except self.TRANSPORT_ERRORS as e:
                with self._lock:
                    self.failures += 1
                if not isinstance(e, TransportDrop):
                    self.breaker.record_failure()
                if attempt >= self.max_retries or \
                        not self._retryable(verb, e, idempotent):
                    raise
                if not self.budget.take():
                    raise ReplicaUnavailable(
                        f"replica {self.replica_id}: retry budget "
                        f"exhausted retrying {verb} ({e!r})") from e
                with self._lock:
                    self.retries_total += 1
                    self.retries_by_verb[verb] = \
                        self.retries_by_verb.get(verb, 0) + 1
                    n_jit = self._jitter_n
                    self._jitter_n += 1
                delay = self.backoff_s * (2 ** attempt) * _jitter(
                    self.replica_id, verb, n_jit)
                if self.spans is not None:
                    with self.spans.span(f"retry/{verb}",
                                         lane="host:router"):
                        time.sleep(delay)
                else:
                    time.sleep(delay)
                attempt += 1

    def snapshot(self) -> dict:
        with self._lock:
            calls, failures = self.calls, self.failures
            retries = self.retries_total
            by_verb = dict(self.retries_by_verb)
        return {
            "replica": self.replica_id,
            "breaker_state": self.breaker.state,
            "breaker_trips": self.breaker.trips,
            "consecutive_failures": self.breaker.consecutive_failures,
            "calls": calls,
            "failures": failures,
            "retries_total": retries,
            "retries_by_verb": by_verb,
            "retry_budget_remaining": round(self.budget.tokens, 2),
            "retry_budget_exhaustions": self.budget.exhaustions,
        }
