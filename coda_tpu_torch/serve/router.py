"""Fleet session router: rendezvous sharding, health-driven re-routing
(counterpart of ``coda_tpu/serve/router.py``).

What the port decides afresh for a 2.0 GB headline slot: an in-process
migration carries the slot's carries as raw host arrays (the source's
``begin_migration(raw=True)``, the destination's ``import_session``),
and base64 JSON only at the HTTP edge, coded by
``recovery.payload_to_json``/``payload_from_json`` in the router's verb
threads (:class:`HttpReplica`), never on an event loop.

Every serve headline number before this module was a single-process
ceiling: one slab, one batcher thread, one front door. The router is the
fleet's front door — it speaks the exact same HTTP/JSON surface as one
replica (``make_server(router, port)`` reuses ``AsyncHTTPServer``
unchanged), and shards sessions across N serve replicas:

  * **Placement is rendezvous (HRW) hashing** on the session id:
    ``owner(sid) = argmax_r blake2b(sid, r)`` over the routable replica
    set. Deterministic across processes (keyed hash, never Python's
    salted ``hash``), and minimal under topology change — adding or
    removing one of N replicas re-owns only ~1/N of the id space, which
    is exactly the set of sessions a rebalance has to move.
  * **Health drives the routing set**: each replica's ``/healthz``
    (ok | degraded | unready) is polled; an unready or
    unreachable replica is evicted from routing (its verbs re-route),
    a recovered one rejoins — each transition triggering a minimal
    rebalance.
  * **Rebalancing is drain-and-migrate on the export/import path**:
    a session moves by being quiesced (the tiering demotion protocol —
    an in-flight label ticket pins the session and the demotion loses
    cleanly, so the payload always contains every committed label),
    exported, and imported on its new owner, where the snapshot fast
    path verifies the posterior digest bitwise against the stream's
    last recorded digest (or falls back to bitwise stream replay) —
    EVERY migration is digest-verified by construction. The router
    holds a per-sid migration gate while a session is in flight;
    requests for it wait out the move and then land on the new owner,
    and a label retried across the move is absorbed by the replica's
    idempotent request-id dedupe.
  * **Added latency is attributed span-by-span**: every routed verb
    records a ``route/<verb>`` span on the ``host:router`` lane nesting
    a ``dispatch/<replica>`` span for the replica call — router overhead
    is the outer minus the inner, mechanically, in the same trace.json
    vocabulary as the batcher's tick/step spans.

Observability does not regress to per-replica curl loops: the router's
``/stats`` merges every replica's snapshot (plus aggregate sums and the
router's own counters), and ``/metrics`` renders the serve gauge
families once each with a ``replica`` label per sample (lint-clean
under ``telemetry/prometheus.lint``).

``serve/fleet.py`` owns replica lifecycle (spawn, rolling restart, peer
paging); this module owns addressing, health, and migration mechanics.
"""

from __future__ import annotations

import collections
import hashlib
import re
import threading
import time
import uuid
from typing import Optional, Sequence

from coda_tpu_torch.serve.state import (
    BucketQuarantined,
    SlabFull,
    StaleOwner,
    UnknownSession,
)
from coda_tpu_torch.serve.transport import ReplicaTransport, ReplicaUnavailable

#: how long a verb waits out an in-flight migration of its session
MIGRATION_WAIT_S = 30.0


# ---------------------------------------------------------------------------
# rendezvous (highest-random-weight) hashing
# ---------------------------------------------------------------------------

def rendezvous_score(sid: str, replica_id: str) -> int:
    """The HRW weight of (session, replica): a keyed 64-bit digest.

    ``blake2b`` (not Python's ``hash``, which is salted per process):
    owners must agree across the router, every replica, and any offline
    tool that recomputes the shard map."""
    h = hashlib.blake2b(digest_size=8)
    h.update(sid.encode())
    h.update(b"\x00")
    h.update(replica_id.encode())
    return int.from_bytes(h.digest(), "big")


def rendezvous_rank(sid: str, replica_ids: Sequence[str]) -> list[str]:
    """Replicas by descending HRW score (ties broken by id — total order
    so every process ranks identically). ``[0]`` is the owner; the rest
    is the failover order."""
    return sorted(replica_ids,
                  key=lambda rid: (-rendezvous_score(sid, rid), rid))


def rendezvous_owner(sid: str, replica_ids: Sequence[str]) -> str:
    if not replica_ids:
        raise SlabFull("no routable replicas")
    best = None
    best_key = None
    for rid in replica_ids:
        key = (-rendezvous_score(sid, rid), rid)
        if best_key is None or key < best_key:
            best, best_key = rid, key
    return best


# ---------------------------------------------------------------------------
# replica handles: in-process and HTTP
# ---------------------------------------------------------------------------

class InprocReplica:
    """One fleet member served by a ServeApp in this process
    (``build_fleet``'s replicas; also what the tests drive). A migration
    carries the payload's raw host arrays (``begin_migration(raw=True)``)
    straight into the peer's ``import_session``.

    Every verb rides the same :class:`~coda_tpu_torch.serve.transport.
    ReplicaTransport` policy layer the HTTP handle uses — transport
    can't actually fail in-process, but the parity buys two things: the
    per-edge chaos faults (``net_drop``/``net_delay``/``net_dup``/
    ``partition``/``flap_healthz``) inject here exactly as they would on
    a real socket, and the breaker/retry accounting the router reports
    is one code path, not two."""

    def __init__(self, replica_id: str, app, transport=None):
        self.replica_id = replica_id
        self.app = app
        self.transport = transport or ReplicaTransport(replica_id)

    # -- verbs (the router forwards these; exceptions flow through) --------
    def open(self, task=None, seed=None, sid=None, trace=None):
        return self.transport.call(
            "open", lambda t: self.app.open_session(task=task, seed=seed,
                                                    sid=sid,
                                                    trace_ctx=trace))

    def label(self, sid, label, idx=None, request_id=None, epoch=None,
              trace=None):
        return self.transport.call(
            "label",
            lambda t: self.app.label(sid, label, idx=idx,
                                     request_id=request_id, epoch=epoch,
                                     trace_ctx=trace),
            idempotent=request_id is not None)

    def labels(self, sid, labels, idx=None, request_id=None, epoch=None,
               trace=None):
        return self.transport.call(
            "labels",
            lambda t: self.app.labels(sid, labels, idx=idx,
                                      request_id=request_id, epoch=epoch,
                                      trace_ctx=trace),
            idempotent=request_id is not None)

    def best(self, sid, epoch=None, trace=None):
        return self.transport.call(
            "best", lambda t: self.app.best(sid, epoch=epoch,
                                            trace_ctx=trace))

    def trace(self, sid, epoch=None):
        return self.transport.call(
            "trace", lambda t: self.app.trace(sid, epoch=epoch))

    def trace_by_id(self, trace_id):
        # this replica's retained spans for one distributed trace (the
        # router's stitcher fans this out across the fleet)
        return self.transport.call(
            "trace_by_id", lambda t: self.app.trace_by_id(trace_id),
            idempotent=True)

    def close(self, sid, epoch=None):
        return self.transport.call(
            "close", lambda t: self.app.close_session(sid, epoch=epoch))

    def export(self, sid, close=False, hold=False, raw=False):
        return self.transport.call(
            "export", lambda t: self.app.export_session(sid, close=close,
                                                        hold=hold, raw=raw))

    def fence(self, sid, drop=True):
        return self.transport.call(
            "fence", lambda t: self.app.end_migration(sid, drop=drop),
            idempotent=True)

    def import_payload(self, payload):
        return self.transport.call(
            "import", lambda t: self.app.import_session(payload))

    def stats(self):
        return self.transport.call("stats", lambda t: self.app.stats())

    def sync_prior(self, pool_snap=None):
        return self.transport.call(
            "prior_sync", lambda t: self.app.sync_prior(pool_snap))

    def healthz(self):
        return self.transport.call("healthz",
                                   lambda t: self.app.healthz())

    # -- fleet bookkeeping -------------------------------------------------
    def has_session(self, sid) -> bool:
        return self.app.store.alive(sid) or (
            self.app.tiers is not None and self.app.tiers.parked(sid))

    def session_epoch(self, sid) -> Optional[int]:
        """The ownership epoch of this replica's copy, or None when it
        holds none (the journal-recovery probe)."""
        try:
            return int(self.app.session_epoch(sid)["epoch"])
        except UnknownSession:
            return None

    def open_sids(self) -> list[str]:
        return self.app.list_sessions()["sessions"]

    def open_count(self) -> int:
        n = self.app.store.live_sessions()
        if self.app.tiers is not None:
            c = self.app.tiers.counts()
            n = c["hot"] + c["warm"] + c["cold"]
        return n

    def export_for_migration(self, sid) -> dict:
        """The migration PREPARE: quiesce + hold + export WITHOUT close
        (``ServeApp.begin_migration``). The source keeps a recoverable —
        but held, uncommittable — copy until :meth:`fence` commits or
        aborts the move, so a crash or lost response anywhere in the
        window degrades to "didn't move", never "gone"."""
        return self.transport.call(
            "export", lambda t: self.app.begin_migration(sid, raw=True),
            idempotent=True)


class DeadReplica:
    """The handle of a SIGKILLed in-process replica: every verb raises
    ``ConnectionError``, exactly what a real dead host's socket would do
    (``Fleet.kill_replica`` swaps this in; the health poller and the
    breaker then discover the death the same way they would cross-host)."""

    def __init__(self, replica_id: str):
        self.replica_id = replica_id
        self.transport = ReplicaTransport(replica_id)

    def _dead(self, *a, **k):
        raise ConnectionError(
            f"replica {self.replica_id} is dead (killed)")

    open = label = labels = best = trace = close = _dead
    export = fence = import_payload = stats = healthz = _dead
    export_for_migration = sync_prior = trace_by_id = _dead

    def has_session(self, sid) -> bool:
        raise ConnectionError(
            f"replica {self.replica_id} is dead (killed)")

    def session_epoch(self, sid):
        raise ConnectionError(
            f"replica {self.replica_id} is dead (killed)")

    def open_sids(self) -> list[str]:
        raise ConnectionError(
            f"replica {self.replica_id} is dead (killed)")

    def open_count(self) -> int:
        raise ConnectionError(
            f"replica {self.replica_id} is dead (killed)")


#: parses the epoch pair out of a StaleOwner error's HTTP message
_STALE_RE = re.compile(r"session ([0-9a-f]+):.*epoch (\d+).*epoch (\d+)")


class HttpReplica:
    """One fleet member behind a base URL (a real multi-process fleet).

    Maps the HTTP error envelope back onto the exceptions the in-process
    verbs raise, so the router's own front door re-encodes them
    identically no matter which handle type served the request. Every
    request rides the hardened transport (``serve/transport.py``): the
    per-verb deadline replaces the old fixed 60 s blanket, transport
    failures retry only when the verb is provably idempotent at the
    replica, a per-replica budget bounds the retry amplification, and a
    circuit breaker fails fast on a black-holed host."""

    def __init__(self, replica_id: str, url: str,
                 timeout: Optional[float] = None, transport=None,
                 deadlines: Optional[dict] = None, **transport_kw):
        self.replica_id = replica_id
        self.url = url.rstrip("/")
        dl = dict(deadlines or {})
        if timeout is not None:
            # legacy blanket timeout: now just a floor-raise on every
            # verb's deadline rather than the one number for everything
            from coda_tpu_torch.serve.transport import VERB_DEADLINES

            for verb, d in VERB_DEADLINES.items():
                dl.setdefault(verb, max(d, float(timeout)))
        self.transport = transport or ReplicaTransport(
            replica_id, deadlines=dl, **transport_kw)

    def _req(self, method, path, body=None, timeout=60.0, trace=None,
             payload=False):
        """One request. ``payload`` sends an export payload ``body`` (raw
        arrays or base64) coded by ``recovery.payload_to_json``, and reads
        a reply that may be one with ``recovery.payload_from_json``, so a
        headline slot's base64 is written and read by child processes."""
        import json as _json
        import socket
        import urllib.error
        import urllib.request

        from coda_tpu_torch.serve.recovery import (payload_from_json,
                                                   payload_to_json)

        if body is None:
            data = None
        elif payload:
            data = payload_to_json(body)
        else:
            data = _json.dumps(body).encode()
        headers = {"Content-Type": "application/json"}
        if data is not None:
            headers["Content-Length"] = str(len(data))
        if trace is not None:
            # the wire form of the trace context: the replica's serve
            # span parents to OUR span, so cross-process stitching gets
            # one causal chain (same header both handle types speak)
            from coda_tpu_torch.telemetry.trace import TRACE_HEADER

            headers[TRACE_HEADER] = trace.header()
        req = urllib.request.Request(
            self.url + path, data=data, method=method, headers=headers)
        try:
            with urllib.request.urlopen(req, timeout=timeout) as r:
                raw = r.read()
            return payload_from_json(raw) if payload else _json.loads(raw)
        except urllib.error.HTTPError as e:
            try:
                msg = _json.loads(e.read()).get("error", "")
            except Exception:
                msg = str(e)
            if e.code == 404:
                raise UnknownSession(msg or path)
            if e.code == 503:
                raise BucketQuarantined(msg) if "healing" in msg \
                    else SlabFull(msg)
            if e.code == 409:
                if msg.startswith("stale owner"):
                    m = _STALE_RE.search(msg)
                    raise StaleOwner(m.group(1) if m else path,
                                     have=int(m.group(2)) if m else 0,
                                     want=int(m.group(3)) if m else 0)
                from coda_tpu_torch.serve.recovery import ImportRejected

                raise ImportRejected(msg)
            if e.code == 504:
                raise TimeoutError(msg)
            raise RuntimeError(f"{e.code}: {msg}")
        except urllib.error.URLError as e:
            # normalize the urllib wrapper onto the transport-error types
            # the retry/breaker policy classifies
            reason = getattr(e, "reason", e)
            if isinstance(reason, (ConnectionError, socket.timeout,
                                   TimeoutError, OSError)):
                raise reason
            raise ConnectionError(str(e))

    def _call(self, verb, method, path, body=None, idempotent=False,
              trace=None, payload=False):
        return self.transport.call(
            verb, lambda t: self._req(method, path, body, timeout=t,
                                      trace=trace, payload=payload),
            idempotent=idempotent)

    @staticmethod
    def _stamp(body: dict, epoch) -> dict:
        if epoch is not None:
            body["epoch"] = int(epoch)
        return body

    def open(self, task=None, seed=None, sid=None, trace=None):
        body = {}
        if task is not None:
            body["task"] = task
        if seed is not None:
            body["seed"] = seed
        if sid is not None:
            body["session"] = sid
        return self._call("open", "POST", "/session", body, trace=trace)

    def label(self, sid, label, idx=None, request_id=None, epoch=None,
              trace=None):
        body = self._stamp({"label": label}, epoch)
        if idx is not None:
            body["idx"] = idx
        if request_id is not None:
            body["request_id"] = request_id
        return self._call("label", "POST", f"/session/{sid}/label", body,
                          idempotent=request_id is not None, trace=trace)

    def labels(self, sid, labels, idx=None, request_id=None, epoch=None,
               trace=None):
        body = self._stamp({"labels": list(labels)}, epoch)
        if idx is not None:
            body["idx"] = idx
        if request_id is not None:
            body["request_id"] = request_id
        return self._call("labels", "POST", f"/session/{sid}/labels", body,
                          idempotent=request_id is not None, trace=trace)

    def best(self, sid, epoch=None, trace=None):
        q = f"?epoch={int(epoch)}" if epoch is not None else ""
        return self._call("best", "GET", f"/session/{sid}/best{q}",
                          trace=trace)

    def trace(self, sid, epoch=None):
        q = f"?epoch={int(epoch)}" if epoch is not None else ""
        return self._call("trace", "GET", f"/session/{sid}/trace{q}")

    def trace_by_id(self, trace_id):
        return self._call("trace_by_id", "GET", f"/trace/id/{trace_id}",
                          idempotent=True)

    def close(self, sid, epoch=None):
        return self._call("close", "DELETE", f"/session/{sid}",
                          self._stamp({}, epoch) or None)

    def export(self, sid, close=False, hold=False, raw=False):
        """The payload as ``export_session`` gives it: base64 JSON, or
        with ``raw`` the decoded bytes ``import_session`` takes as they
        are."""
        return self._call("export", "POST", f"/session/{sid}/export",
                          {"close": bool(close), "hold": bool(hold)},
                          payload=raw)

    def fence(self, sid, drop=True):
        return self._call("fence", "POST", f"/session/{sid}/fence",
                          {"drop": bool(drop)}, idempotent=True)

    def import_payload(self, payload):
        return self._call("import", "POST", "/session/import", payload,
                          payload=True)

    def stats(self):
        return self._call("stats", "GET", "/stats")

    def sync_prior(self, pool_snap=None):
        body = {} if pool_snap is None else {"pool": pool_snap}
        return self._call("prior_sync", "POST", "/prior/sync", body)

    def healthz(self):
        try:
            return self._call("healthz", "GET", "/healthz")
        except ReplicaUnavailable:
            # breaker/budget fast-fail is TRANSPORT state, not the
            # replica answering unready — let check_health report (and
            # evict) it as breaker_open, distinctly
            raise
        except SlabFull:
            # a 503 here is the replica saying "unready" — report it as
            # the healthz body would
            return {"ok": False, "ready": False, "status": "unready",
                    "draining": False, "problems": ["unready"]}

    def has_session(self, sid) -> bool:
        try:
            self.best(sid)
            return True
        except UnknownSession:
            return False
        except (SlabFull, BucketQuarantined):
            return True  # restoring/healing/migrating: it exists

    def session_epoch(self, sid) -> Optional[int]:
        try:
            out = self._call("epoch", "GET", f"/session/{sid}/epoch")
            return int(out.get("epoch") or 0)
        except UnknownSession:
            return None
        except (SlabFull, BucketQuarantined):
            return None  # exists but unreadable right now

    def open_sids(self) -> list[str]:
        return list((self._call("sessions", "GET", "/sessions") or {})
                    .get("sessions", []))

    def open_count(self) -> int:
        st = self.stats()
        return int(st.get("open_sessions") or 0)

    def export_for_migration(self, sid) -> dict:
        # the PREPARE half of the hold protocol (see InprocReplica)
        return self.export(sid, close=False, hold=True, raw=True)


# ---------------------------------------------------------------------------
# the router
# ---------------------------------------------------------------------------

class SessionRouter:
    """The fleet's front door (duck-types ServeApp's verb surface, so
    ``make_server(router, port)`` serves it over the same asyncio HTTP
    stack a single replica uses).

    Construction takes ``{replica_id: handle}``; :meth:`start` begins
    health polling. Topology changes (eviction, rejoin,
    :meth:`add_replica` / :meth:`remove_replica`) trigger
    :meth:`rebalance` — drain-and-migrate of exactly the minimal re-owned
    key range."""

    def __init__(self, replicas: Optional[dict] = None, telemetry=None,
                 auto_rebalance: bool = True,
                 journal_path: Optional[str] = None,
                 faults=None, health_hysteresis: int = 2,
                 tracing: bool = True,
                 slo_fast_s: float = 300.0, slo_slow_s: float = 3600.0,
                 slo_store=None):
        from concurrent.futures import ThreadPoolExecutor

        from coda_tpu_torch.serve.metrics import ServeMetrics
        from coda_tpu_torch.telemetry import Telemetry
        from coda_tpu_torch.telemetry.slo import SloSweeper, default_fleet_slos

        self._lock = threading.RLock()
        self.replicas: dict[str, object] = dict(replicas or {})
        self._routable: set[str] = set(self.replicas)
        self._health: dict[str, str] = {rid: "ok" for rid in self.replicas}
        # deliberate off-owner placements (peer paging, mid-rebalance):
        # sid -> replica id; consulted before the HRW owner
        self._placed: dict[str, str] = {}
        # ownership epochs: sid -> the epoch of the CURRENT owner's copy
        # (bumped per migration/peer-page, stamped on every routed verb
        # so a stale copy fences itself; the journal's committed records
        # are the durable half — recover_from_journal rebuilds this)
        self._epochs: dict[str, int] = {}
        # operator-evicted replicas the health poller must NOT re-admit
        # (a draining replica's /healthz still answers ok until it
        # stops; rejoin() lifts the cordon explicitly)
        self._cordoned: set[str] = set()
        # per-sid migration gates: verbs wait these out, then re-locate
        self._migrating: dict[str, threading.Event] = {}
        # health hysteresis: consecutive same-direction probe outcomes
        # required before a membership change (a single flapping probe
        # must not churn the HRW keyspace); rid -> (direction, streak)
        self.health_hysteresis = max(1, int(health_hysteresis))
        self._streaks: dict[str, tuple] = {}
        self.telemetry = telemetry if telemetry is not None else Telemetry()
        self.metrics = ServeMetrics()   # router-level request accounting
        self.draining = False
        self.auto_rebalance = auto_rebalance
        # per-edge fault injection (serve/faults.py net_* names) — shared
        # with every handle's transport by add_replica
        self.faults = faults
        # Fleet installs this: kill_hook(rid) SIGKILLs a replica (the
        # kill_replica fault's applier)
        self.kill_hook = None
        self.counters = {
            "requests_routed": 0, "reroutes": 0, "migrations": 0,
            "migration_failures": 0, "evictions": 0, "rejoins": 0,
            "rebalances": 0, "peer_pages": 0, "sessions_dropped": 0,
            "fencing_rejections": 0, "fence_failures": 0,
            "journal_replays": 0, "migrations_in_doubt": 0,
            "prior_syncs": 0, "prior_deltas_merged": 0,
        }
        # the fleet's merged surrogate-prior pool (serve/priors.py),
        # created lazily on the first replica delta; exchange rides the
        # health poll — see check_health
        self.prior_pool = None
        self._prior_unsupported: set[str] = set()
        self.migrations_via: dict[str, int] = {}   # snapshot vs replay
        self.routed_to: dict[str, int] = {rid: 0 for rid in self.replicas}
        self._executor = ThreadPoolExecutor(
            max_workers=32, thread_name_prefix="router-verb")
        self._running = False
        self._poll_thread: Optional[threading.Thread] = None
        self._wakeup = threading.Event()
        self.ready = threading.Event()
        if self.replicas:
            self.ready.set()
        # the span vocabulary the trace-based attribution keys on
        self._spans = self.telemetry.spans
        # distributed tracing: the router is the fleet's front door, so
        # it MINTS the trace context when the client didn't send one —
        # every label decision gets exactly one causal trace. Purely
        # observational (spans + retention), never read by routing.
        self.tracing = bool(tracing)
        # adopted trace payloads: a replica about to be rebuilt (rolling
        # restart) hands its retained per-trace spans to the router so
        # traces survive the restart — trace_id -> [wire payloads].
        # Bounded FIFO like the recorders' own retention; a crash-killed
        # replica hands off nothing (its spans are honestly lost).
        self._adopted_traces: "collections.OrderedDict[str, list]" = \
            collections.OrderedDict()
        self._adopted_capacity = 4096
        # the SLO watchtower: declarative objectives evaluated against
        # the aggregated fleet snapshot on the health-poll thread;
        # multi-window burn rates, typed fire/clear alerts (flushed to
        # ``slo_store`` when given), coda_slo_* gauges on /metrics
        # availability/latency/recovery objectives PLUS the decision-
        # quality plane's (shadow-audit divergence, calibration ECE,
        # drift firing) — quality probes read each replica snapshot's
        # "quality" section and report no-data when --no-quality hid it
        from coda_tpu_torch.telemetry.quality import quality_slos

        self.slo = SloSweeper(default_fleet_slos() + quality_slos(),
                              registry=self.telemetry.registry,
                              store=slo_store,
                              fast_s=slo_fast_s, slow_s=slo_slow_s)
        # the migration journal: crash-consistent move records (intent/
        # exported/imported/committed), replayed by recover_from_journal
        self.journal = None
        if journal_path is not None:
            from coda_tpu_torch.serve.journal import MigrationJournal

            self.journal = MigrationJournal(journal_path)
            # the committed records are the durable epoch map: a
            # restarted router must stamp verbs at least as new as the
            # last committed move or a stale copy could serve again
            for sid, rec in self.journal.committed().items():
                self._epochs[sid] = rec["epoch"]
        for rid in self.replicas:
            self._wire_handle(self.replicas[rid])

    def _wire_handle(self, handle) -> None:
        """Share the router's fault injector + span recorder with a
        handle's transport (one fault domain, one trace vocabulary)."""
        t = getattr(handle, "transport", None)
        if t is not None:
            if t.faults is None:
                t.faults = self.faults
            t.spans = self._spans

    # -- topology ----------------------------------------------------------
    def add_replica(self, replica_id: str, handle, rebalance: bool = True
                    ) -> None:
        self._wire_handle(handle)
        with self._lock:
            self.replicas[replica_id] = handle
            self._routable.add(replica_id)
            self._health[replica_id] = "ok"
            self._streaks.pop(replica_id, None)
            self.routed_to.setdefault(replica_id, 0)
            self.ready.set()
        if rebalance:
            self.rebalance()

    def remove_replica(self, replica_id: str, migrate: bool = True) -> dict:
        """Drain one replica out of the fleet: evict it from routing,
        migrate every session it holds to the sessions' new HRW owners
        (each digest-verified), then forget the handle. Returns the
        migration report."""
        with self._lock:
            if replica_id not in self.replicas:
                return {"migrated": 0}
            self._routable.discard(replica_id)
        report = (self._migrate_all_off(replica_id) if migrate
                  else {"migrated": 0})
        with self._lock:
            self.replicas.pop(replica_id, None)
            self._health.pop(replica_id, None)
        return report

    def evict(self, replica_id: str, cordon: bool = False) -> None:
        """Take a replica out of routing without forgetting it (health
        eviction: it may recover and rejoin). ``cordon`` additionally
        bars the health poller from re-admitting it — the drain flow,
        where the replica's /healthz keeps answering ok until it
        actually stops."""
        with self._lock:
            if cordon:
                self._cordoned.add(replica_id)
            if replica_id in self._routable:
                self._routable.discard(replica_id)
                self.counters["evictions"] += 1

    def rejoin(self, replica_id: str) -> None:
        with self._lock:
            self._cordoned.discard(replica_id)
            if replica_id in self.replicas and \
                    replica_id not in self._routable:
                self._routable.add(replica_id)
                self.counters["rejoins"] += 1

    def routable(self) -> list[str]:
        with self._lock:
            return sorted(self._routable)

    def owner_of(self, sid: str) -> str:
        return rendezvous_owner(sid, self.routable())

    # -- health ------------------------------------------------------------
    def check_health(self) -> dict:
        """One poll of every replica's /healthz: unreachable or unready
        replicas leave the routing set, recovered ones rejoin — but only
        after ``health_hysteresis`` CONSECUTIVE same-direction outcomes
        (a single flapping probe must not churn the HRW keyspace and
        trigger needless migrations). A replica whose transport breaker
        is open is reported (and evicted) as ``breaker_open`` — distinct
        from health eviction on ``/stats``; the breaker's half-open
        window makes this same poll the recovery probe. Returns
        {replica: status}; topology changes trigger a rebalance when
        ``auto_rebalance``."""
        statuses: dict[str, str] = {}
        with self._lock:
            items = list(self.replicas.items())
        changed = False
        for rid, handle in items:
            breaker = getattr(getattr(handle, "transport", None),
                              "breaker", None)
            if breaker is not None and breaker.state == "open":
                # fail fast: K consecutive transport failures already ARE
                # the hysteresis — don't burn a probe the breaker would
                # refuse anyway
                status = "breaker_open"
            else:
                try:
                    hz = handle.healthz()
                    status = hz.get("status") or (
                        "ok" if hz.get("ready") else "unready")
                    if hz.get("draining"):
                        status = "draining"
                except ReplicaUnavailable:
                    status = "breaker_open"
                except Exception:
                    status = "unreachable"
            statuses[rid] = status
            if status in ("ok", "degraded"):
                self._sync_prior_with(rid, handle)
            routable = status in ("ok", "degraded")
            with self._lock:
                was = rid in self._routable
                cordoned = rid in self._cordoned
                self._health[rid] = status
                if routable == was:
                    self._streaks.pop(rid, None)
                    flip = False
                else:
                    d, n = self._streaks.get(rid, (routable, 0))
                    n = n + 1 if d == routable else 1
                    self._streaks[rid] = (routable, n)
                    # a breaker-open edge needs no further confirmation:
                    # the K consecutive failures that tripped it are the
                    # hysteresis
                    flip = n >= self.health_hysteresis or \
                        status == "breaker_open"
            if not flip:
                continue
            with self._lock:
                self._streaks.pop(rid, None)
            if routable and not cordoned:
                self.rejoin(rid)
                changed = True
            elif not routable:
                self.evict(rid)
                changed = True
        if changed and self.auto_rebalance:
            try:
                self.rebalance()
            except Exception:
                pass  # the poller must survive a mid-rebalance hiccup
        return statuses

    def _sync_prior_with(self, rid: str, handle) -> None:
        """The prior-pool exchange piggybacked on one healthy probe:
        push the router's merged pool, fold the replica's drained delta
        back in. Never fails the poll — a replica that doesn't speak the
        verb (older build, pool off) is remembered and skipped."""
        if rid in self._prior_unsupported:
            return
        sync = getattr(handle, "sync_prior", None)
        if sync is None:
            self._prior_unsupported.add(rid)
            return
        try:
            snap = (self.prior_pool.snapshot()
                    if self.prior_pool is not None else None)
            delta = (sync(snap) or {}).get("delta") or {}
        except (ConnectionError, OSError, TimeoutError,
                ReplicaUnavailable):
            return  # transport trouble: the delta stays queued replica-
            #         side (drain happens inside a successful call only)
        except Exception:
            # an app-level rejection (404 on an old server): permanent
            self._prior_unsupported.add(rid)
            return
        with self._lock:
            self.counters["prior_syncs"] += 1
        if not delta:
            return
        if self.prior_pool is None:
            from coda_tpu_torch.serve.priors import PriorPool

            with self._lock:
                if self.prior_pool is None:
                    self.prior_pool = PriorPool()
        n = self.prior_pool.merge_delta(delta)
        if n:
            with self._lock:
                self.counters["prior_deltas_merged"] += n

    def start(self, poll_s: float = 0.25) -> "SessionRouter":
        if self._poll_thread is not None:
            return self
        self._running = True

        def _loop():
            ticks = 0
            while self._running:
                try:
                    self.check_health()
                except Exception:
                    pass
                ticks += 1
                if ticks % 4 == 0:
                    # SLO sweep at 1/4 the health cadence: stats() fans
                    # out to every replica, so it rides a slower beat
                    # than the cheap healthz probes
                    try:
                        self.slo.observe(self.stats())
                    except Exception:
                        pass  # the poller survives a mid-sweep hiccup
                self._wakeup.wait(poll_s)
                self._wakeup.clear()

        self._poll_thread = threading.Thread(
            target=_loop, daemon=True, name="router-health")
        self._poll_thread.start()
        return self

    def stop(self) -> None:
        self._running = False
        self._wakeup.set()
        t, self._poll_thread = self._poll_thread, None
        if t is not None:
            t.join(timeout=5.0)

    def drain(self, timeout: float = 30.0) -> None:
        self.draining = True
        self.stop()
        self._executor.shutdown(wait=False)
        if self.journal is not None:
            self.journal.close()

    # -- location ----------------------------------------------------------
    def _locate(self, sid: str) -> str:
        gate = None
        with self._lock:
            gate = self._migrating.get(sid)
        if gate is not None:
            gate.wait(MIGRATION_WAIT_S)
        with self._lock:
            rid = self._placed.get(sid)
            if rid is not None and rid in self.replicas:
                # an off-owner placement on an evicted-but-known replica
                # still resolves: it serves its sessions while draining
                return rid
            routable = sorted(self._routable)
        return rendezvous_owner(sid, routable)

    def _find(self, sid: str, exclude=()) -> tuple:
        """Search the fleet for a session that is not where the shard map
        says (a topology change the rebalance has not caught up with).
        ALL known replicas are probed — an evicted-but-draining replica
        still serves its existing sessions until they migrate off it —
        in rendezvous-rank order, the most likely ex-owners first.
        Returns ``(replica_id_or_None, n_unreachable)``: a failed find
        with unreachable probes is NOT proof of absence — the session
        may live behind a partition, and the caller must answer
        retryable, not 404."""
        with self._lock:
            candidates = [r for r in self.replicas if r not in exclude]
        unreachable = 0
        for rid in rendezvous_rank(sid, candidates):
            try:
                if self.replicas[rid].has_session(sid):
                    return rid, unreachable
            except Exception:
                unreachable += 1
                continue
        return None, unreachable

    def _trace_root(self, trace_ctx):
        """The fleet front door's trace context: continue the client's,
        or MINT one (tracing on) so every label decision has a causal
        trace even from untraced clients. None when tracing is off."""
        if not self.tracing:
            return None
        if trace_ctx is not None:
            return trace_ctx.child()
        from coda_tpu_torch.telemetry.trace import mint

        return mint()

    def _forward(self, verb: str, sid: str, fn, trace_ctx=None):
        """Route one verb: locate -> dispatch (with the route span
        nesting the replica dispatch span, the router's epoch stamped on
        the call) -> on UnknownSession, search the fleet and re-route
        once; on a StaleOwner fencing rejection, the answering replica
        holds a pre-migration copy — exclude it and re-locate; on a dead
        replica (or an open breaker), evict and fail over.

        ``fn(handle, epoch, trace)`` gets a per-dispatch child context —
        each failover attempt carries its own span, so a request retried
        across a migration leaves BOTH replicas' lanes in one trace."""
        ctx = self._trace_root(trace_ctx)
        with self._spans.span(f"route/{verb}", lane="host:router",
                              **(ctx.attrs() if ctx is not None else {})):
            last_err: Optional[BaseException] = None
            stale: set = set()
            for attempt in range(4):
                rid = self._locate(sid)
                with self._lock:
                    handle = self.replicas.get(rid)
                    epoch = self._epochs.get(sid)
                if handle is None:
                    continue
                dctx = ctx.child() if ctx is not None else None
                dattrs = dict(dctx.attrs(), replica=rid) \
                    if dctx is not None else {}
                try:
                    with self._spans.span(f"dispatch/{rid}",
                                          lane="host:router", **dattrs):
                        out = fn(handle, epoch, dctx)
                    with self._lock:
                        self.counters["requests_routed"] += 1
                        self.routed_to[rid] = \
                            self.routed_to.get(rid, 0) + 1
                    return out
                except StaleOwner as e:
                    # the fence held: rid serves a pre-migration copy
                    # (healed partition / crash-restored unsealed
                    # stream). Never commit there — find the copy whose
                    # epoch matches the stamp and re-route.
                    last_err = e
                    stale.add(rid)
                    with self._lock:
                        self.counters["fencing_rejections"] += 1
                        if self._placed.get(sid) == rid:
                            self._placed.pop(sid, None)
                    found, unreachable = self._find(sid, exclude=stale)
                    if found is None:
                        if unreachable:
                            raise ReplicaUnavailable(
                                f"session {sid}: current owner "
                                f"unreachable while re-locating after a "
                                f"fencing rejection ({unreachable} "
                                "replica(s) down); retry")
                        raise
                    with self._lock:
                        self._placed[sid] = found
                        self.counters["reroutes"] += 1
                except UnknownSession as e:
                    last_err = e
                    with self._lock:
                        gate = self._migrating.get(sid)
                    if gate is not None:
                        # we located the source BEFORE its migration gate
                        # went up and dispatched after the fence landed:
                        # mid-move the payload exists only in the
                        # migrating thread's hands, so neither side
                        # answers. Wait the move out, then re-locate —
                        # never a 404 for a session that is merely in
                        # transit.
                        gate.wait(MIGRATION_WAIT_S)
                        continue
                    found, unreachable = self._find(sid,
                                                    exclude=stale | {rid})
                    if found is None:
                        if unreachable:
                            # an unreachable replica may HOLD the
                            # session: absence is unproven, so the
                            # answer is retryable backpressure (503),
                            # never a 404 for a session a partition is
                            # merely hiding
                            raise ReplicaUnavailable(
                                f"session {sid}: not found on reachable "
                                f"replicas and {unreachable} replica(s) "
                                "unreachable; retry after the fleet "
                                "heals") from e
                        if attempt < 3:
                            # a migration's gate may have been popped
                            # between our dispatch and the check above —
                            # one short beat, then re-locate
                            time.sleep(0.01)
                            continue
                        raise
                    with self._lock:
                        self._placed[sid] = found
                        self.counters["reroutes"] += 1
                except ReplicaUnavailable as e:
                    # breaker open / retry budget gone: the edge is
                    # black-holed — evict and fail over like a dead host
                    last_err = e
                    self.evict(rid)
                except (ConnectionError, OSError) as e:
                    # replica went away under us: evict, let health/
                    # rebalance recover it, and fail over this request
                    last_err = e
                    self.evict(rid)
            raise (last_err or SlabFull("no routable replica answered"))

    # -- the front-door verb surface (ServeApp-compatible) -----------------
    def open_session(self, task: Optional[str] = None,
                     seed: Optional[int] = None, trace_ctx=None) -> dict:
        if self.draining:
            from coda_tpu_torch.serve.server import Draining

            raise Draining()
        # the router mints the sid so placement is HRW on the id BEFORE
        # the replica admits it (the replica honors the pinned id)
        sid = uuid.uuid4().hex
        ctx = self._trace_root(trace_ctx)
        with self._spans.span("route/open", lane="host:router",
                              **(ctx.attrs() if ctx is not None else {})):
            last_err: Optional[BaseException] = None
            for _ in range(3):
                owner = rendezvous_owner(sid, self.routable())
                with self._lock:
                    handle = self.replicas.get(owner)
                if handle is None:
                    continue  # removed between routable() and lookup
                dctx = ctx.child() if ctx is not None else None
                dattrs = dict(dctx.attrs(), replica=owner) \
                    if dctx is not None else {}
                try:
                    with self._spans.span(f"dispatch/{owner}",
                                          lane="host:router", **dattrs):
                        out = handle.open(task=task, seed=seed, sid=sid,
                                          trace=dctx)
                except (ConnectionError, OSError) as e:
                    # dead owner inside the health-poll window: evict it
                    # (like every _forward verb does) and re-own the sid
                    # over the survivors instead of bouncing the client
                    last_err = e
                    self.evict(owner)
                    continue
                with self._lock:
                    self.counters["requests_routed"] += 1
                    self.routed_to[owner] = \
                        self.routed_to.get(owner, 0) + 1
                return out
            raise (last_err or SlabFull("no routable replica answered"))

    async def open_session_async(self, task=None, seed=None,
                                 trace_ctx=None) -> dict:
        import asyncio

        loop = asyncio.get_running_loop()
        return await loop.run_in_executor(
            self._executor,
            lambda: self.open_session(task, seed, trace_ctx=trace_ctx))

    def label(self, sid: str, label, idx=None, request_id=None,
              epoch=None, trace_ctx=None) -> dict:
        # ``epoch`` is accepted for surface parity with ServeApp (the
        # shared front door); the ROUTER's own epoch map is what gets
        # stamped on the replica call — that map is the fence.
        return self._forward(
            "label", sid,
            lambda h, e, t: h.label(sid, label, idx=idx,
                                    request_id=request_id, epoch=e,
                                    trace=t),
            trace_ctx=trace_ctx)

    async def label_async(self, sid, label, idx=None,
                          request_id=None, epoch=None,
                          trace_ctx=None) -> dict:
        import asyncio

        loop = asyncio.get_running_loop()
        return await loop.run_in_executor(
            self._executor,
            lambda: self.label(sid, label, idx=idx, request_id=request_id,
                               trace_ctx=trace_ctx))

    def labels(self, sid: str, labels, idx=None, request_id=None,
               epoch=None, trace_ctx=None) -> dict:
        return self._forward(
            "labels", sid,
            lambda h, e, t: h.labels(sid, labels, idx=idx,
                                     request_id=request_id, epoch=e,
                                     trace=t),
            trace_ctx=trace_ctx)

    async def labels_async(self, sid, labels, idx=None,
                           request_id=None, epoch=None,
                           trace_ctx=None) -> dict:
        import asyncio

        loop = asyncio.get_running_loop()
        return await loop.run_in_executor(
            self._executor,
            lambda: self.labels(sid, labels, idx=idx,
                                request_id=request_id,
                                trace_ctx=trace_ctx))

    def best(self, sid: str, epoch=None, trace_ctx=None) -> dict:
        return self._forward("best", sid,
                             lambda h, e, t: h.best(sid, epoch=e, trace=t),
                             trace_ctx=trace_ctx)

    def trace(self, sid: str, epoch=None) -> dict:
        return self._forward("trace", sid,
                             lambda h, e, t: h.trace(sid, epoch=e))

    def close_session(self, sid: str, epoch=None) -> dict:
        out = self._forward("close", sid,
                            lambda h, e, t: h.close(sid, epoch=e))
        with self._lock:
            self._placed.pop(sid, None)
            self._epochs.pop(sid, None)
        return out

    def export_session(self, sid: str, close: bool = False,
                       hold: bool = False, raw: bool = False) -> dict:
        out = self._forward("export", sid,
                            lambda h, e, t: h.export(sid, close=close,
                                                     hold=hold, raw=raw))
        if close:
            with self._lock:
                self._placed.pop(sid, None)
                self._epochs.pop(sid, None)
        return out

    def end_migration(self, sid: str, drop: bool = False) -> dict:
        # router-mediated fence (surface parity with ServeApp)
        return self._forward("fence", sid,
                             lambda h, e, t: h.fence(sid, drop=drop))

    def session_epoch(self, sid: str) -> dict:
        """Front-door twin of ``ServeApp.session_epoch``: the router's
        own epoch map answers when it has an entry (it is the fence's
        authority); otherwise the located replica's copy does."""
        with self._lock:
            ep = self._epochs.get(sid)
        if ep is not None:
            return {"session": sid, "epoch": int(ep)}
        rid = self._locate(sid)
        with self._lock:
            handle = self.replicas.get(rid)
        e = handle.session_epoch(sid) if handle is not None else None
        if e is None:
            raise UnknownSession(sid)
        return {"session": sid, "epoch": int(e)}

    def import_body_cap(self) -> int:
        """The largest ``POST /session/import`` body the front door reads:
        the largest of the in-process replicas' caps (1 MiB plus one
        slot's carries in base64), 1 MiB when none is in process."""
        with self._lock:
            apps = [getattr(h, "app", None) for h in self.replicas.values()]
        caps = [1 << 20]
        for app in apps:
            cap = getattr(app, "import_body_cap", None)
            if cap is not None:
                try:
                    caps.append(int(cap()))
                except Exception:
                    continue
        return max(caps)

    def import_session(self, payload: dict) -> dict:
        if self.draining:
            from coda_tpu_torch.serve.server import Draining

            raise Draining()
        sid = str(payload.get("session") or "")
        owner = rendezvous_owner(sid, self.routable())
        with self._spans.span("route/import", lane="host:router"):
            with self._lock:
                handle = self.replicas[owner]
            with self._spans.span(f"dispatch/{owner}", lane="host:router"):
                return handle.import_payload(payload)

    # -- migration ---------------------------------------------------------
    def _commit_migration(self, sid: str, src, src_rid: str, dst_rid: str,
                          epoch_next: int, via: str, mid) -> dict:
        """The commit half of a move whose import landed: fence the
        source copy (best-effort — a fence the partition eats leaves a
        STALE copy behind, which the epoch stamp defends until recovery
        re-fences it), adopt the epoch + placement, count, journal."""
        fenced = True
        try:
            src.fence(sid, drop=True)
        except UnknownSession:
            pass
        except Exception:
            fenced = False
            with self._lock:
                self.counters["fence_failures"] += 1
        with self._lock:
            self._epochs[sid] = epoch_next
            # home placement needs no override; an off-owner
            # destination (peer paging) keeps one
            owner = rendezvous_owner(sid, sorted(self._routable))
            if dst_rid == owner:
                self._placed.pop(sid, None)
            else:
                self._placed[sid] = dst_rid
            self.counters["migrations"] += 1
            self.migrations_via[via] = \
                self.migrations_via.get(via, 0) + 1
        if mid is not None:
            self.journal.record(mid, "committed", epoch=epoch_next,
                                fenced=fenced)
        info = {"migrated": sid, "from": src_rid, "to": dst_rid,
                "via": via, "epoch": epoch_next}
        if not fenced:
            info["fence_pending"] = True
        return info

    def _kill_point(self, src_rid: str, dst_rid: str) -> None:
        """The seeded mid-migration process-fault site: between the
        export and the import, ``kill_replica`` (edge-addressed) fires
        the fleet's kill hook — SIGKILL semantics for whichever end the
        fault spec names."""
        if self.faults is None or self.kill_hook is None:
            return
        for rid in (src_rid, dst_rid):
            if "kill_replica" in self.faults.fire("migrate_mid", edge=rid):
                self.kill_hook(rid)

    def migrate_session(self, sid: str, src_rid: str, dst_rid: str) -> dict:
        """Move one session with the journaled prepare/commit protocol:

          1. journal ``intent`` (src, dst, the bumped epoch);
          2. PREPARE on the source (quiesce + hold + export WITHOUT
             close — the source keeps a recoverable, uncommittable
             copy); journal ``exported`` with the payload digest;
          3. import on the destination at the bumped ownership epoch
             (digest-verified snapshot or bitwise stream replay);
             journal ``imported``;
          4. FENCE the source (drop its copy, seal its stream), commit
             the router's epoch/placement maps, journal ``committed``.

        A crash — of the router or either replica — between any two
        steps degrades to *didn't move* (the source's held copy resumes
        on abort or journal recovery) or *moved exactly once* (journal
        recovery finalizes the fence); and even an unfenced stale copy
        can never commit a label, because every routed verb carries the
        bumped epoch the stale copy fails. On an import failure the
        source is un-held and the session resumes there — never gone."""
        gate = threading.Event()
        with self._lock:
            if self._migrating.get(sid) is not None:
                return {"skipped": "already migrating"}
            self._migrating[sid] = gate
            src = self.replicas.get(src_rid)
            dst = self.replicas.get(dst_rid)
            epoch_next = self._epochs.get(sid, 0) + 1
        info: dict = {}
        mid = None
        try:
            if src is None or dst is None:
                return {"skipped": "replica gone"}
            if self.journal is not None:
                mid = self.journal.begin(sid, src_rid, dst_rid, epoch_next)
            try:
                payload = src.export_for_migration(sid)
            except UnknownSession:
                if mid is not None:
                    self.journal.record(mid, "aborted", reason="closed")
                return {"skipped": "closed"}
            # the ownership bump happens HERE, under the router's hand:
            # demote/wake round trips preserve the epoch, only a
            # committed move advances it
            payload = dict(payload)
            payload["epoch"] = epoch_next
            if mid is not None:
                from coda_tpu_torch.serve.journal import payload_digest

                self.journal.record(mid, "exported",
                                    digest=payload_digest(payload),
                                    n_labeled=payload.get("n_labeled"))
            self._kill_point(src_rid, dst_rid)
            try:
                res = None
                for i in range(8):
                    try:
                        res = dst.import_payload(payload)
                        break
                    except SlabFull as e:
                        # transient admission pressure on the peer
                        # (every slot momentarily pinned): a migration
                        # must out-wait it, not fail the move — but a
                        # black-holed edge (breaker open) fails NOW
                        if isinstance(e, ReplicaUnavailable) or i == 7:
                            raise
                        time.sleep(0.01 * (i + 1))
                if mid is not None:
                    self.journal.record(mid, "imported")
                info = self._commit_migration(
                    sid, src, src_rid, dst_rid, epoch_next,
                    res.get("restored_via", "?"), mid)
            except BaseException as e:
                # before restoring the source, probe the destination: a
                # lost import RESPONSE is not a lost import — if the
                # copy landed at the bumped epoch, the move COMMITTED
                # and must finalize, or two live copies would serve
                # under one sid
                landed = False
                try:
                    ep = dst.session_epoch(sid)
                    landed = ep is not None and ep >= epoch_next
                except Exception:
                    landed = False
                if landed:
                    if mid is not None:
                        self.journal.record(mid, "imported",
                                            ack_lost=True)
                    info = self._commit_migration(
                        sid, src, src_rid, dst_rid, epoch_next,
                        "recovered", mid)
                    return info
                # the import never landed (or was refused): the source
                # still holds the session — lift the hold and the move
                # degrades to "didn't move", never to "gone"
                with self._lock:
                    self.counters["migration_failures"] += 1
                try:
                    src.fence(sid, drop=False)
                    with self._lock:
                        self._placed[sid] = src_rid
                except BaseException:
                    # even the abort couldn't reach the source: its held
                    # copy stays parked (and crash restore resurrects it
                    # from the unsealed stream). Leave the journal at its
                    # last NON-terminal phase so recover_from_journal
                    # resolves the doubt — recording 'aborted' here would
                    # terminally hide a move recovery must still settle.
                    with self._lock:
                        self.counters["migrations_in_doubt"] += 1
                    info = {"failed": sid, "error": repr(e),
                            "in_doubt": True}
                    return info
                if mid is not None:
                    self.journal.record(mid, "aborted", reason=repr(e))
                info = {"failed": sid, "error": repr(e)}
            return info
        finally:
            with self._lock:
                self._migrating.pop(sid, None)
            gate.set()

    def recover_from_journal(self) -> dict:
        """Resolve every in-doubt migration after a router restart (call
        once the replicas are registered, before serving): probe the
        destination for the journaled copy — present at the bumped epoch
        means the move committed on the target, so FINALIZE (fence the
        source, adopt epoch + placement); absent means the import never
        landed, so RESTORE (lift the source's hold; its copy — or its
        crash-restored stream — serves again). Either way each in-doubt
        SIGKILL window degrades to didn't-move or moved-exactly-once."""
        if self.journal is None:
            return {"resolved": 0}
        report: dict = {"resolved": 0, "finalized": [], "restored": [],
                       "in_doubt": []}
        for move in self.journal.in_doubt():
            sid = move.get("sid")
            mid = move.get("mid")
            epoch = int(move.get("epoch") or 0)
            with self._lock:
                src = self.replicas.get(move.get("src"))
                dst = self.replicas.get(move.get("dst"))
            on_dst = False
            if dst is not None:
                try:
                    ep = dst.session_epoch(sid)
                    on_dst = ep is not None and ep >= epoch
                except Exception:
                    on_dst = False
            with self._lock:
                self.counters["journal_replays"] += 1
            if on_dst:
                fenced = True
                if src is not None:
                    try:
                        src.fence(sid, drop=True)
                    except UnknownSession:
                        pass
                    except Exception:
                        fenced = False
                        with self._lock:
                            self.counters["fence_failures"] += 1
                with self._lock:
                    self._epochs[sid] = max(self._epochs.get(sid, 0),
                                            epoch)
                    routable = sorted(self._routable)
                    if routable and rendezvous_owner(
                            sid, routable) == move.get("dst"):
                        self._placed.pop(sid, None)
                    else:
                        self._placed[sid] = move.get("dst")
                self.journal.record(mid, "committed", epoch=epoch,
                                    fenced=fenced, replayed=True)
                report["finalized"].append(sid)
            else:
                restored = False
                if src is not None:
                    try:
                        src.fence(sid, drop=False)  # lift any hold
                        restored = src.has_session(sid)
                    except Exception:
                        restored = False
                self.journal.record(mid, "aborted",
                                    reason="journal recovery: import "
                                           "never landed", replayed=True)
                if restored:
                    report["restored"].append(sid)
                else:
                    # neither end answers for it right now — the source's
                    # crash restore (its stream is unsealed) resurrects
                    # it; record the doubt attributably
                    report["in_doubt"].append(sid)
            report["resolved"] += 1
        return report

    def _migrate_all_off(self, src_rid: str) -> dict:
        """Drain-and-migrate every session off one replica to the
        sessions' HRW owners over the remaining routable set."""
        with self._lock:
            handle = self.replicas.get(src_rid)
            routable = sorted(self._routable - {src_rid})
        if handle is None or not routable:
            return {"migrated": 0}
        moved = failed = 0
        fail_errors: list = []
        for sid in handle.open_sids():
            dst = rendezvous_owner(sid, routable)
            info = self.migrate_session(sid, src_rid, dst)
            if "migrated" in info:
                moved += 1
            elif "failed" in info:
                failed += 1
                fail_errors.append(info.get("error"))
        out = {"migrated": moved, "failed": failed}
        if fail_errors:
            out["errors"] = fail_errors[:10]
        return out

    def rebalance(self, full: bool = False) -> dict:
        """Move every session to its HRW owner over the CURRENT routable
        set — after a topology change this is exactly the minimal
        re-owned key range (sessions whose owner is unchanged never
        move). ``full=True`` also re-homes deliberate off-owner
        placements (peer-paged sessions); the default leaves them where
        the pressure balancing put them."""
        moved = failed = 0
        fail_errors: list = []
        with self._lock:
            items = [(rid, self.replicas[rid])
                     for rid in sorted(self._routable)]
            routable = sorted(self._routable)
            placed = dict(self._placed)
        for rid, handle in items:
            try:
                sids = handle.open_sids()
            except Exception:
                continue
            for sid in sids:
                if not full and placed.get(sid) == rid:
                    continue  # deliberately placed here (peer paging)
                owner = rendezvous_owner(sid, routable)
                if owner == rid:
                    continue
                info = self.migrate_session(sid, rid, owner)
                if "migrated" in info:
                    moved += 1
                elif "failed" in info:
                    failed += 1
                    fail_errors.append(info.get("error"))
        with self._lock:
            self.counters["rebalances"] += 1
        out = {"moved": moved, "failed": failed}
        if fail_errors:
            out["errors"] = fail_errors[:10]
        return out

    def list_sessions(self) -> dict:
        """Union of every replica's addressable sessions (GET /sessions
        on the router — the fleet-wide worklist)."""
        out: list[str] = []
        seen: set = set()
        with self._lock:
            items = list(self.replicas.items())
        for rid, handle in items:
            try:
                fresh = [s for s in handle.open_sids() if s not in seen]
            except Exception:
                continue
            out += fresh
            seen.update(fresh)
        return {"sessions": out}

    # -- observability -----------------------------------------------------
    def healthz(self) -> dict:
        with self._lock:
            health = dict(self._health)
            routable = sorted(self._routable)
            n_replicas = len(self.replicas)
        ready = bool(routable) and not self.draining
        problems = [f"replica_{rid}_{st}" for rid, st in sorted(
            health.items()) if st not in ("ok",)]
        status = ("unready" if not routable
                  else "degraded" if len(routable) < n_replicas or problems
                  else "ok")
        return {"ok": ready, "ready": bool(routable),
                "draining": self.draining, "status": status,
                "role": "router", "replicas": health,
                "routable": routable, "problems": problems}

    def stats(self) -> dict:
        """The merged fleet snapshot: per-replica /stats sections, the
        aggregate sums a dashboard wants, and the router's own routing/
        migration counters — one endpoint, not a per-replica curl loop."""
        with self._lock:
            items = list(self.replicas.items())
            counters = dict(self.counters)
            via = dict(self.migrations_via)
            routed = dict(self.routed_to)
            routable = sorted(self._routable)
            health = dict(self._health)
            placed = len(self._placed)
            epochs = len(self._epochs)
        per_replica: dict[str, dict] = {}
        transports: dict[str, dict] = {}
        for rid, handle in items:
            t = getattr(handle, "transport", None)
            if t is not None:
                transports[rid] = t.snapshot()
            try:
                per_replica[rid] = handle.stats()
            except Exception as e:
                per_replica[rid] = {"error": repr(e)}
        agg_keys = ("open_sessions", "slab_occupancy", "dispatches",
                    "requests", "sessions_opened", "sessions_closed",
                    "demotions", "wakes", "hibernates", "peer_pages")
        aggregate = {k: sum(int(s.get(k) or 0) for s in per_replica.values()
                            if "error" not in s) for k in agg_keys}
        # breaker-open vs health-evicted, reported DISTINCTLY: the
        # breakers section is transport state, the health map is probe
        # state — an operator can tell a black-holed edge from an
        # unready process at a glance
        breakers = {rid: {"state": t["breaker_state"],
                          "trips": t["breaker_trips"],
                          "consecutive_failures":
                              t["consecutive_failures"]}
                    for rid, t in transports.items()}
        out = {
            "role": "router",
            "replicas": per_replica,
            "aggregate": aggregate,
            "router": {
                "routable": routable,
                "health": health,
                "health_hysteresis": self.health_hysteresis,
                "counters": counters,
                "migrations_via": via,
                "requests_to": routed,
                "placed_overrides": placed,
                "epoch_overrides": epochs,
                "migration_verified": sum(via.values()),
                "breakers": breakers,
                "transport": transports,
                "transport_retries": {
                    rid: t["retries_total"]
                    for rid, t in transports.items()},
            },
        }
        if self.journal is not None:
            out["router"]["journal"] = self.journal.stats()
        if self.prior_pool is not None:
            out["router"]["prior_pool"] = self.prior_pool.stats()
        return out

    def render_metrics(self) -> str:
        """The merged /metrics exposition: router registry families plus
        every serve family rendered ONCE with per-replica labels."""
        from coda_tpu_torch.telemetry.prometheus import render_fleet

        st = self.stats()
        return render_fleet(st["replicas"],
                            registry=self.telemetry.registry,
                            router_stats=st["router"])

    def slo_snapshot(self) -> dict:
        """``GET /fleet/slo``: objectives, burn rates, firing state,
        recent alerts (the SLO watchtower's JSON face)."""
        return self.slo.snapshot()

    def quality_scorecard(self) -> dict:
        """``GET /fleet/quality`` at the fleet front door: each replica's
        decision-quality scorecard plus one fleet-level verdict (worst
        replica wins per organ — one diverged auditor grades the fleet
        diverged). Replicas running ``--no-quality`` are listed as
        disabled rather than silently dropped."""
        from coda_tpu_torch.telemetry.quality import CALIBRATION_MIN_SAMPLES

        st = self.stats()
        per: dict[str, dict] = {}
        worst_ece = None
        any_audit = False
        diverged = firing = False
        for rid, snap in st["replicas"].items():
            if "error" in snap:
                per[rid] = {"error": snap["error"]}
                continue
            q = snap.get("quality")
            if not isinstance(q, dict):
                per[rid] = {"enabled": False}
                continue
            per[rid] = q
            audit = q.get("audit") or {}
            if audit.get("audits_total"):
                any_audit = True
                if (audit.get("divergences_recent") or 0) > 0:
                    diverged = True
            for cal in (q.get("calibration") or {}).values():
                ece = cal.get("ece")
                # same evidence floor as CalibrationMonitor.worst_ece:
                # thin per-replica buckets must not grade the fleet
                if (cal.get("n") or 0) < CALIBRATION_MIN_SAMPLES:
                    continue
                if ece is not None and (worst_ece is None
                                        or ece > worst_ece):
                    worst_ece = ece
            if any(d.get("firing")
                   for d in (q.get("drift") or {}).values()):
                firing = True
        return {
            "role": "router",
            "replicas": per,
            "verdict": {
                "calibration": ("no_data" if worst_ece is None else
                                ("ok" if worst_ece <= 0.25
                                 else "miscalibrated")),
                "worst_ece": worst_ece,
                "audit": ("diverged" if diverged
                          else ("ok" if any_audit else "no_data")),
                "drift": "firing" if firing else "ok",
            },
        }

    def adopt_trace_payloads(self, payloads: list) -> int:
        """Take custody of per-trace span payloads from a replica that is
        about to lose its recorder (rolling restart rebuilds the app):
        :meth:`collect_trace` keeps stitching these into the trace after
        the donor's in-memory rings are gone. Bounded FIFO per trace_id,
        same shape as :meth:`SpanRecorder.trace_payload`."""
        kept = 0
        with self._lock:
            for p in payloads or ():
                tid = (p or {}).get("trace_id")
                if not tid or not p.get("events"):
                    continue
                bucket = self._adopted_traces.get(tid)
                if bucket is None:
                    while len(self._adopted_traces) >= \
                            self._adopted_capacity:
                        self._adopted_traces.popitem(last=False)
                    bucket = []
                    self._adopted_traces[tid] = bucket
                bucket.append(p)
                kept += 1
        return kept

    @staticmethod
    def _merge_process_payloads(payloads: list) -> list:
        """Coalesce payloads sharing a process name (an adopted pre-restart
        payload plus the live replica's post-restart one) into ONE lane
        group, rebasing events onto the earliest payload's clock anchor so
        the stitched timeline stays aligned."""
        by_proc: dict = {}
        order = []
        for p in payloads:
            key = p.get("process") or ""
            if key not in by_proc:
                by_proc[key] = []
                order.append(key)
            by_proc[key].append(p)
        merged = []
        for key in order:
            group = by_proc[key]
            if len(group) == 1:
                merged.append(group[0])
                continue
            anchor = min(g["t0_unix"] for g in group)
            events = []
            for g in group:
                off = g["t0_unix"] - anchor
                for e in g["events"]:
                    events.append(dict(e, t0=e["t0"] + off,
                                       t1=e["t1"] + off))
            events.sort(key=lambda e: e["t0"])
            merged.append({"trace_id": group[0].get("trace_id"),
                           "process": key, "t0_unix": anchor,
                           "events": events})
        return merged

    def collect_trace(self, trace_id: str) -> dict:
        """``GET /trace/id/{id}`` at the fleet front door: stitch the
        router's own retained spans for one trace with every replica's
        (fetched over the normal verb transport — in-process or HTTP)
        plus any payloads adopted from restarted replicas, into ONE
        Chrome/Perfetto file with a process lane per member. A replica
        that can't answer contributes nothing rather than failing the
        stitch — a partial trace beats no trace."""
        from coda_tpu_torch.telemetry.spans import stitch_traces

        tid = str(trace_id)
        payloads = [self.telemetry.spans.trace_payload(tid,
                                                       process="router")]
        with self._lock:
            items = sorted(self.replicas.items())
            payloads += [dict(p) for p in
                         self._adopted_traces.get(tid, ())]
        for rid, handle in items:
            fetch = getattr(handle, "trace_by_id", None)
            if fetch is None:
                continue
            try:
                p = fetch(tid)
            except Exception:
                continue
            if p and p.get("events"):
                p = dict(p)
                p["process"] = p.get("process") or str(rid)
                payloads.append(p)
        payloads = self._merge_process_payloads(
            [p for p in payloads if p.get("events")])
        out = stitch_traces(payloads)
        out["trace_id"] = tid
        # the per-process payload census: which fleet members retained
        # spans for this trace (a completeness check reads this instead
        # of re-deriving it from Chrome pid metadata)
        out["processes"] = [p["process"] for p in payloads
                            if p.get("events")]
        return out
