"""Replicated serve fleet: lifecycle, rolling restarts, peer paging
(counterpart of ``coda_tpu/serve/fleet.py``).

``serve/router.py`` owns addressing (rendezvous sharding, health-driven
routing, per-session migration mechanics); this module owns the
replicas themselves:

  * **Spawn** — :class:`Fleet` builds N replicas from an ``app_factory``
    (each a full :class:`~coda_tpu_torch.serve.ServeApp`: own slab, batcher,
    tier manager, recorder), registers them with a
    :class:`~coda_tpu_torch.serve.router.SessionRouter`, and wires the
    fleet-level hooks.
  * **Rolling restart** — :meth:`rolling_restart` cycles every replica
    in sequence: evict from routing → drain-and-migrate its sessions to
    their new owners (each digest-verified on the export/import
    path) → stop the old process state → stand up a fresh replica from
    the factory → wait for its warm pool (the ``/healthz`` readiness
    gate) → rejoin → minimal rebalance pulls its key range back, with
    zero dropped sessions and zero double-applied labels through the
    whole cycle.
  * **Device memory between replicas** — the replicas share one card,
    and a dead or restarted replica's slab would otherwise live on for
    as long as anything references its app (its objects form reference
    cycles, and a client's traceback of a call into it can hold it for
    seconds). :meth:`Fleet.kill_replica` and :meth:`Fleet.restart_replica`
    drop the fleet's and the router's references to the old app, free
    its buckets' device memory, collect, and return the cached blocks to
    the card (:func:`_release_device_memory`) before the factory builds
    its successor.
  * **No degraded replica** — one ``ServeApp`` whose warm-up fails (a
    kernel that does not build or launch, the card out of memory) serves
    on with lazy warm-up; a fleet replica fails instead. :meth:`Fleet.start`,
    :meth:`Fleet.restart_replica` and :meth:`Fleet.revive_replica` stop
    it, free its device memory and raise :class:`ReplicaWarmupFailed`
    naming it (the reference's fleet serves on with it).
  * **Demotion-aware peer paging** — each replica's
    :class:`~coda_tpu_torch.serve.tiering.TierManager` gets a ``page_out``
    hook: a watermark- or age-pressured warm session is offered to the
    least-loaded OTHER routable replica (imported there digest-verified,
    router re-pointed) before it is spilled to local disk. Fleet RAM
    becomes one pool instead of N silos.

:func:`build_fleet` runs the whole fleet in one process with
:class:`~coda_tpu_torch.serve.router.InprocReplica` handles (raw arrays
move between replicas); a multi-process deployment points the same
router at ``HttpReplica`` URLs — the router and this lifecycle logic are
handle-type agnostic.
"""

from __future__ import annotations

import gc
import threading
import time
from typing import Callable, Optional

from coda_tpu_torch.serve.router import (DeadReplica, InprocReplica,
                                         SessionRouter)


class _DeadApp:
    """What a captured handle sees after its replica is SIGKILLed: every
    attribute access — any verb, any bookkeeping read — raises
    ``ConnectionError``, the way a dead process's socket would."""

    def __init__(self, rid: str):
        object.__setattr__(self, "_rid", rid)

    def __getattr__(self, name):
        raise ConnectionError(
            f"replica {self._rid} is dead (killed)")


def _release_device_memory(app) -> None:
    """Free what a dropped replica held before its successor allocates:
    its buckets' device memory, explicitly (a client's traceback of a
    call into the old app can keep the app itself alive for seconds),
    then its reference cycles, then the allocator's cached blocks, handed
    back to the card."""
    for bucket in app.store.buckets():
        bucket.free()
    gc.collect()
    import torch

    if torch.cuda.is_available():
        torch.cuda.empty_cache()


def _stop_threads(app) -> None:
    """Stop a killed replica's remaining threads without a drain (the
    caller stops the batcher and the tiers): the quality plane's auditor
    and the verb executor."""
    quality = getattr(app, "quality", None)
    if quality is not None:
        try:
            quality.stop()
        except Exception:
            pass
    try:
        app._executor.shutdown(wait=False)
    except Exception:
        pass


class ReplicaWarmupFailed(RuntimeError):
    """A replica's warm-up failed; the fleet does not serve with it."""


def _start_replica(rid: str, app, warm: bool) -> None:
    """Start one replica and hold it to its warm-up: on a failure the
    replica is stopped, its device memory freed, and the start raises."""
    app.start(warm=warm)
    err = app.warm_error if warm else None
    if err is None:
        return
    try:
        app.batcher.stop(drain=False, timeout=0.5)
        if getattr(app, "tiers", None) is not None:
            app.tiers.stop()
        _stop_threads(app)
    finally:
        _release_device_memory(app)
    raise ReplicaWarmupFailed(f"replica {rid} warm-up failed: {err}")


class Fleet:
    """N serve replicas + one session router, managed together.

    ``app_factory(replica_id)`` returns an UNSTARTED ServeApp for that
    replica (the same factory serves initial spawn and rolling-restart
    respawn, so a restarted replica is configured identically).

    ``journal_path`` arms the router's migration journal (crash-
    consistent moves — see ``serve/journal.py``); ``fault_spec`` arms
    per-edge transport chaos (``serve/faults.py`` net_* names) shared by
    every replica handle's transport."""

    def __init__(self, app_factory: Callable, n_replicas: int = 3,
                 replica_ids: Optional[list] = None, telemetry=None,
                 peer_paging: bool = True, auto_rebalance: bool = True,
                 journal_path: Optional[str] = None,
                 fault_spec: Optional[str] = None,
                 health_hysteresis: int = 2,
                 tracing: bool = True,
                 slo_fast_s: float = 300.0, slo_slow_s: float = 3600.0,
                 slo_store=None):
        from coda_tpu_torch.serve.faults import FaultInjector

        self.app_factory = app_factory
        self.replica_ids = list(replica_ids or
                                [f"r{i}" for i in range(n_replicas)])
        self.apps: dict[str, object] = {}
        self.router = SessionRouter(
            telemetry=telemetry, auto_rebalance=auto_rebalance,
            journal_path=journal_path,
            faults=FaultInjector(fault_spec) if fault_spec else None,
            health_hysteresis=health_hysteresis,
            tracing=tracing, slo_fast_s=slo_fast_s, slo_slow_s=slo_slow_s,
            slo_store=slo_store)
        self.router.kill_hook = self.kill_replica
        self.peer_paging = peer_paging
        self.kills: dict[str, int] = {}
        for rid in self.replica_ids:
            self._spawn(rid)
        if journal_path is not None:
            # resolve any in-doubt moves a previous incarnation left
            # behind BEFORE this fleet serves a verb. Recovery PROBES
            # replica state, and a freshly spawned fleet has not crash-
            # restored its streams yet — resolving against empty stores
            # would terminally misjudge a move whose import actually
            # landed (and later crash restore would resurrect BOTH
            # copies). Restore first, then resolve.
            if self.router.journal is not None and \
                    self.router.journal.in_doubt():
                for rid, app in self.apps.items():
                    rdir = getattr(app.recorder, "out_dir", None)
                    if rdir:
                        try:
                            app.restore_sessions(rdir)
                        except Exception:
                            pass  # recovery still probes; worst case a
                            #       move resolves as restored-at-source
            self.journal_recovery = self.router.recover_from_journal()

    @property
    def peer_pages(self) -> int:
        """Fleet-wide successful peer pages (the router's counter is the
        single source of truth — one event, one counter)."""
        return self.router.counters["peer_pages"]

    # -- lifecycle ---------------------------------------------------------
    def _spawn(self, rid: str):
        app = self.app_factory(rid)
        self.apps[rid] = app
        if self.peer_paging and getattr(app, "tiers", None) is not None:
            app.tiers.page_out = self._make_pager(rid)
        self.router.add_replica(rid, InprocReplica(rid, app),
                                rebalance=False)
        return app

    def start_replicas(self, warm: bool = True) -> "Fleet":
        """Start every replica, each held to its warm-up; the router's
        health poll stays off. A failed warm-up stops every replica and
        raises :class:`ReplicaWarmupFailed`."""
        started = []
        try:
            for rid, app in self.apps.items():
                _start_replica(rid, app, warm)
                started.append(app)
        except ReplicaWarmupFailed:
            for app in started:
                app.drain(timeout=5.0)
            raise
        return self

    def start(self, warm: bool = True, poll_s: float = 0.25) -> "Fleet":
        self.start_replicas(warm)
        self.router.start(poll_s=poll_s)
        return self

    def drain(self, timeout: float = 30.0) -> None:
        self.router.drain()
        for app in self.apps.values():
            if not isinstance(app, _DeadApp):
                app.drain(timeout=timeout)

    def close(self, timeout: float = 30.0) -> None:
        """The fleet's end: :meth:`drain`, then free every replica's
        device memory (:func:`_release_device_memory`) so a fleet built
        next on the card can allocate at once. A drained replica's audit
        worker finishes its audit, and a client's traceback can outlive
        the call; either would otherwise hold the replica's slab."""
        self.drain(timeout=timeout)
        for app in self.apps.values():
            if not isinstance(app, _DeadApp):
                _release_device_memory(app)

    # -- SIGKILL semantics (the in-process fleet's process fault) ----------
    def kill_replica(self, rid: str) -> None:
        """Abrupt replica death: no drain, no export, no goodbye — the
        batcher stops mid-queue, the handle becomes a dead socket, and
        the router discovers the death exactly as it would cross-host
        (connection errors, breaker, health poll). Any handle reference
        captured BEFORE the kill (a mid-migration router) dies too — the
        old handle's app is swapped for a connection-refusing tombstone,
        because a SIGKILLed process answers nobody, however old their
        socket. The replica's record streams and spill log stay on disk
        for :meth:`revive_replica`'s crash restore; its device memory is
        released."""
        app = self.apps.get(rid)
        if app is None or isinstance(app, _DeadApp):
            return
        self.kills[rid] = self.kills.get(rid, 0) + 1
        with self.router._lock:
            old = self.router.replicas.get(rid)
            self.router.replicas[rid] = DeadReplica(rid)
        if isinstance(old, InprocReplica):
            old.app = _DeadApp(rid)
        # stop the compute threads without any drain/flush (SIGKILL
        # leaves no time for either); the recorder's per-row flush is
        # the only durability, which is exactly the contract
        try:
            app.batcher.stop(drain=False, timeout=0.5)
        except Exception:
            pass
        if getattr(app, "tiers", None) is not None:
            try:
                app.tiers.stop()
            except Exception:
                pass
        _stop_threads(app)
        self.apps[rid] = _DeadApp(rid)
        del old
        _release_device_memory(app)

    def revive_replica(self, rid: str, warm: bool = True,
                       restore_dir: Optional[str] = None) -> dict:
        """Stand a killed replica back up from the factory (+ optional
        crash restore from its record dir) and let health re-admit it."""
        new_app = self.app_factory(rid)
        if self.peer_paging and getattr(new_app, "tiers", None) is not None:
            new_app.tiers.page_out = self._make_pager(rid)
        _start_replica(rid, new_app, warm)   # raises: the replica stays dead
        report = {}
        rdir = restore_dir or getattr(new_app.recorder, "out_dir", None)
        if rdir:
            report = new_app.restore_sessions(rdir)
        self.apps[rid] = new_app
        with self.router._lock:
            self.router.replicas[rid] = InprocReplica(rid, new_app)
        self.router._wire_handle(self.router.replicas[rid])
        return report

    # -- peer paging -------------------------------------------------------
    def _make_pager(self, src_rid: str):
        def _page_out(sid: str, payload: dict) -> bool:
            dst_rid = self._least_loaded(exclude={src_rid})
            if dst_rid is None:
                return False  # no routable peer: fall back to disk
            handle = self.router.replicas.get(dst_rid)
            if handle is None:
                return False
            # the move rides the router's migration gate like any other
            # migration: the tier manager already popped the warm entry,
            # so until the peer's import lands the session exists only
            # in this thread's hands — a verb arriving now must wait the
            # gate out, not 404
            gate = threading.Event()
            with self.router._lock:
                if self.router._migrating.get(sid) is not None:
                    return False  # a real migration owns the sid: yield
                self.router._migrating[sid] = gate
                # a peer page is an ownership change like any migration:
                # bump the epoch so the (sealed, but crash-restorable)
                # local stream can never serve a commit again
                epoch_next = self.router._epochs.get(sid, 0) + 1
            journal = self.router.journal
            mid = None
            if journal is not None:
                mid = journal.begin(sid, src_rid, dst_rid, epoch_next)
            payload = dict(payload, epoch=epoch_next)
            try:
                if mid is not None:
                    from coda_tpu_torch.serve.journal import payload_digest

                    journal.record(mid, "exported",
                                   digest=payload_digest(payload),
                                   n_labeled=payload.get("n_labeled"))
                try:
                    handle.import_payload(payload)
                except Exception as e:
                    if mid is not None:
                        journal.record(mid, "aborted", reason=repr(e))
                    return False
                if mid is not None:
                    journal.record(mid, "imported")
                with self.router._lock:
                    self.router._placed[sid] = dst_rid
                    self.router._epochs[sid] = epoch_next
                    self.router.counters["peer_pages"] += 1
                if mid is not None:
                    # the page's "fence" is the tier manager's own
                    # cleanup (it pops the warm entry + seals the
                    # stream on our True), so commit right away
                    journal.record(mid, "committed", epoch=epoch_next,
                                   fenced=True)
                return True
            finally:
                with self.router._lock:
                    self.router._migrating.pop(sid, None)
                gate.set()

        return _page_out

    def _least_loaded(self, exclude=()) -> Optional[str]:
        best, best_n = None, None
        for rid in self.router.routable():
            if rid in exclude:
                continue
            handle = self.router.replicas.get(rid)
            if handle is None:
                continue
            try:
                n = handle.open_count()
            except Exception:
                continue
            if best_n is None or n < best_n:
                best, best_n = rid, n
        return best

    # -- rolling restart ---------------------------------------------------
    def restart_replica(self, rid: str, warm: bool = True,
                        ready_timeout: float = 120.0) -> dict:
        """One replica's zero-drop restart cycle (see module docstring).
        Returns the migration accounting for the gate's evidence."""
        t0 = time.perf_counter()
        # cordoned eviction: the health poller must not re-admit a
        # replica we are deliberately draining (its /healthz answers ok
        # until the old app actually stops); rejoin() lifts the cordon
        self.router.evict(rid, cordon=True)
        # drain-and-migrate: ONLY this replica's sessions move (their
        # owner over the remaining set), each export/import
        # digest-verified; the other replicas' sessions never move
        out_report = self.router._migrate_all_off(rid)
        # a failed migration left its session on THIS replica (the hold
        # was lifted, "didn't move"), and a session the listing missed (a
        # wake or a demotion in flight at that instant) is still here too
        # — draining now would discard them. More passes (transient peer
        # pressure usually clears) while the replica still lists any, then
        # ABORT the restart: the replica rejoins with its sessions intact,
        # and the restart fails attributably instead of dropping anyone.
        left = self.apps[rid].list_sessions()["sessions"]
        for _ in range(3):
            if not left:
                break
            retry = self.router._migrate_all_off(rid)
            out_report = {
                "migrated": out_report.get("migrated", 0)
                + retry.get("migrated", 0),
                "failed": retry.get("failed", 0),
                "errors": retry.get("errors"),
            }
            left = self.apps[rid].list_sessions()["sessions"]
        if left:
            self.router.rejoin(rid)
            raise RuntimeError(
                f"replica {rid} restart aborted: {len(left)} session(s) "
                f"could not be migrated off ({out_report.get('errors')}); "
                "the replica rejoined with its sessions intact")
        old = self.apps[rid]
        # span hand-off: the rebuild below discards the old app's
        # in-memory trace retention, so the router adopts every retained
        # per-trace payload first — a trace that crossed this replica
        # stays complete through the rolling restart (a CRASH-killed
        # replica hands off nothing; that loss is honest)
        spans = getattr(getattr(old, "telemetry", None), "spans", None)
        if spans is not None:
            self.router.adopt_trace_payloads(
                [spans.trace_payload(tid, process=rid)
                 for tid in spans.trace_ids()])
        old.drain(timeout=30.0)
        # let go of the drained app before its successor allocates: the
        # router's handle becomes a dead socket (the replica is cordoned,
        # so nothing routes there), a captured handle a tombstone
        with self.router._lock:
            handle = self.router.replicas.get(rid)
            self.router.replicas[rid] = DeadReplica(rid)
        if isinstance(handle, InprocReplica):
            handle.app = _DeadApp(rid)
        self.apps[rid] = _DeadApp(rid)
        del handle, spans
        _release_device_memory(old)
        del old
        new_app = self.app_factory(rid)
        if self.peer_paging and getattr(new_app, "tiers", None) is not None:
            new_app.tiers.page_out = self._make_pager(rid)
        # a failed warm-up raises here: the replica stays cordoned and
        # dead, and its sessions are already on their new owners
        _start_replica(rid, new_app, warm)
        if not new_app.ready.wait(ready_timeout):
            raise TimeoutError(f"replica {rid} warm pool not ready after "
                               f"{ready_timeout}s")
        self.apps[rid] = new_app
        with self.router._lock:
            self.router.replicas[rid] = InprocReplica(rid, new_app)
        self.router._wire_handle(self.router.replicas[rid])
        self.router.rejoin(rid)
        # minimal rebalance: exactly the sids whose HRW owner is the
        # rejoined replica come home
        back_report = self.router.rebalance()
        out = {"replica": rid,
               "migrated_out": out_report.get("migrated", 0),
               "migrated_back": back_report.get("moved", 0),
               "failed": out_report.get("failed", 0)
               + back_report.get("failed", 0),
               "seconds": round(time.perf_counter() - t0, 3)}
        errors = (out_report.get("errors") or []) + \
            (back_report.get("errors") or [])
        if errors:
            out["errors"] = errors
        return out

    def rolling_restart(self, warm: bool = True) -> dict:
        """Restart EVERY replica in sequence — the fleet's zero-downtime
        deploy. The router keeps serving throughout; each replica's
        sessions ride two digest-verified migrations (out, then home)."""
        rounds = []
        for rid in list(self.replica_ids):
            rounds.append(self.restart_replica(rid, warm=warm))
        c = self.router.counters
        return {
            "replicas_restarted": len(rounds),
            "rounds": rounds,
            "migrations": c["migrations"],
            "migration_failures": c["migration_failures"],
            "sessions_dropped": c["sessions_dropped"],
            "migrations_via": dict(self.router.migrations_via),
        }

    # -- reads -------------------------------------------------------------
    def stats(self) -> dict:
        return self.router.stats()


def build_fleet(args, n_replicas: int, record_dir: Optional[str] = None,
                fault_spec: Optional[str] = None, dataset=None) -> Fleet:
    """A fleet from serve CLI args (``server.parse_args``): each replica
    is ``build_app(args)`` with its own spill/record sub-directories so
    replicas never share mutable disk state. The task is loaded once for
    every replica (the reference loads it a replica: at the headline,
    tens of seconds of host work each); ``dataset`` serves one already
    loaded. A record dir also arms the router's migration journal
    (``<record_dir>/router_migrations.log``); ``fault_spec`` arms
    per-edge transport chaos."""
    import copy
    import os

    from coda_tpu_torch.cli import load_dataset
    from coda_tpu_torch.serve.server import build_app

    base_record = record_dir or getattr(args, "record_dir", None)
    if dataset is None and (args.task or args.synthetic):
        dataset = load_dataset(args)

    def factory(rid: str):
        a = copy.copy(args)
        if getattr(args, "tier_spill_dir", None):
            a.tier_spill_dir = os.path.join(args.tier_spill_dir, rid)
        if base_record:
            a.record_dir = os.path.join(base_record, rid)
        return build_app(a, dataset=dataset)

    journal_path = (os.path.join(base_record, "router_migrations.log")
                    if base_record else None)
    # SLO alert flushes happen on the router's poll thread; hand the
    # sweeper a factory (not a live store) because TrackingStore's sqlite
    # connection is bound to the thread that creates it
    slo_store = None
    tracking_db = getattr(args, "tracking_db", None)
    if tracking_db:
        from coda_tpu_torch.tracking.store import TrackingStore
        slo_store = (lambda db=tracking_db: TrackingStore(db))
    return Fleet(factory, n_replicas=n_replicas,
                 journal_path=journal_path, fault_spec=fault_spec,
                 tracing=not getattr(args, "no_trace", False),
                 slo_fast_s=getattr(args, "slo_fast_s", 300.0),
                 slo_slow_s=getattr(args, "slo_slow_s", 3600.0),
                 slo_store=slo_store)
