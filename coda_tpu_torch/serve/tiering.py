"""Tiered posterior state: hot/warm/cold session paging with wake-on-label
(counterpart of ``coda_tpu/serve/tiering.py``).

What the port decides afresh for a 2.0 GB headline slot: the warm tier
keeps a demoted session's carries as the raw host arrays of its snapshot
(``recovery._pack(..., raw=True)``: the payload's keys, no base64, no
copy; :meth:`TierManager.parked_payload` encodes base64 only for the
export surfaces), the snapshot copies only the demoted slots on a side
stream (``Bucket.snapshot_slots``), and hibernation deflates a large leaf
in parallel pieces (``serve/spill.py``). The fleet's ``page_out`` hook
(peer paging) is slice 9 of the port: :meth:`TierManager.page_to_peer` is
here, and installing a hook raises ``NotImplementedError``.

Before this module a session existed only while it held a device slab
slot, so the open-session ceiling was the slab capacity and admission past
it answered 503 — even though production traffic is Zipf-shaped and most
sessions idle most of the time. The fix treats posterior state as a paged
cache hierarchy (the direction arXiv 2202.10522 takes for NVM-accelerated
posterior estimation):

  * **hot** — resident in a device slab slot (`serve/state.py`), served by
    the batched masked step exactly as before;
  * **warm** — demoted to a host-RAM export payload: the SAME
    digest-verified serialization `POST /session/{id}/export` produces
    (`recovery.build_export_payload`), minus the HTTP hop. The slab slot
    is freed; the recorder stream is *parked* (fd closed, in-memory
    history dropped — the payload carries the rows) but NOT closed, so a
    crash still restores the session from its stream;
  * **cold** — hibernated to disk: the payload lands in the spill dir's
    append-log store (``serve/spill.py`` — zlib-compressed frames + an
    in-memory index, compacted at startup; the v1 one-file-per-session
    layout is still readable) and the recorder stream gets its close
    marker (the spill store is now the authority; ``--restore`` must not
    double-restore it). A restarted TierManager re-indexes the spill
    log, so cold sessions survive process death.

In a replica fleet (``serve/fleet.py``) the warm→cold transition gets a
third option: when a ``page_out`` hook is installed, a watermark- or
age-pressured warm session is offered to a less-loaded PEER replica
first (the payload imports there, digest-verified, and the fleet router
re-points the sid) and only hits the local disk when no peer takes it.

A label, ``best``, or ``trace`` arriving for a non-resident session
transparently **wakes** it through the import fast path — snapshot
restore accepted on a bitwise posterior-digest match against the stream's
last recorded digest, stream replay only as the fallback — instead of
404/503. Admission past capacity becomes "demote the coldest, then
admit" (:meth:`TierManager.make_room`) instead of ``SlabFull`` → 503.

Race rules (the part that must be exactly right):

  * every session verb holds a **pin** (``Session.pins``, taken atomically
    with the store lookup) for its whole slab interaction — a label
    ticket's pin lives until the ticket resolves. Demotion snapshots the
    session, then atomically re-checks ``pins == 1 (ours)`` and
    ``n_labeled`` unchanged under the store lock before unpublishing the
    sid; any in-flight ticket or completed label makes demotion LOSE
    cleanly (abort, state untouched) — never a lost or double-applied
    label, never a ticket dispatched into a freed slot.
  * wake rides the existing staged lock-free admission (`Bucket.allocate`
    + `restore_slot` stage their slab writes), so a thundering herd of
    wakes never convoys the dispatch lock; concurrent wakes of the SAME
    sid coalesce on one waker (the rest wait on its event).
  * demotion vs ``POST /export``: export pins too, so a demotion either
    completes before the export (which then serves the parked payload
    directly) or aborts — the payload a client receives is always a
    consistent snapshot of a quiescent posterior.

Observability: ``sessions_hot/warm/cold`` gauges, ``demotions/wakes/
hibernates_total`` counters, and a wake-latency ring (p50/p99) ride
``/stats`` and ``/metrics`` (`serve/metrics.py`); the sweeper samples
``process_rss_bytes`` so the host memory a large warm tier holds is
observable.
"""

from __future__ import annotations

import threading
import time
from collections import OrderedDict
from typing import Optional

from coda_tpu_torch.serve.spill import SpillStore
from coda_tpu_torch.serve.state import SlabFull


class TierManager:
    """Hot/warm/cold paging policy + mechanics around one ServeApp.

    ``spill_dir`` enables the cold tier (None = warm-only paging).
    ``idle_warm_s`` / ``idle_cold_s`` drive idle demotion (hot→warm) and
    hibernation (warm→cold); ``max_warm`` bounds host-RAM payloads (LRU
    overflow hibernates); ``free_fraction`` > 0 makes the sweeper keep
    that fraction of each slab free ahead of admission bursts (watermark
    demotion — LRU on last-label time, only sessions idle at least
    ``min_idle_s`` so a briefly-paused closed-loop client is never paged
    out under it). Admission-pressure demotion (:meth:`make_room`) has no
    idle floor — when the alternative is 503, the coldest session goes.
    """

    def __init__(self, app, spill_dir: Optional[str] = None,
                 idle_warm_s: float = 30.0, idle_cold_s: float = 120.0,
                 max_warm: int = 8192, free_fraction: float = 0.0,
                 sweep_interval_s: float = 0.25, min_idle_s: float = 1.0,
                 wake_attempts: int = 16):
        self.app = app
        self.spill_dir = spill_dir
        self.idle_warm_s = float(idle_warm_s)
        self.idle_cold_s = float(idle_cold_s)
        self.max_warm = int(max_warm)
        self.free_fraction = float(free_fraction)
        self.sweep_interval_s = float(sweep_interval_s)
        self.min_idle_s = float(min_idle_s)
        self.wake_attempts = int(wake_attempts)
        # tier maps: sid -> {payload, task, last_used} (warm, LRU-ordered)
        # and the cold append-log store (spill.py, its own sid index).
        # _waking holds one event per in-flight wake so a thundering herd
        # of requests for one sid rides a single restore.
        self._lock = threading.Lock()
        # demotions in flight, and their end (a headline slot's snapshot
        # takes a good part of a second: a wake or an admission that finds
        # every slot pinned by another thread's demotion waits for it to
        # free them instead of spending its retries)
        self._demoting = 0
        self._demoted = threading.Condition(self._lock)
        self._warm: "OrderedDict[str, dict]" = OrderedDict()
        self._waking: dict[str, threading.Event] = {}
        self.spill_errors = 0        # hibernate writes that failed (stayed warm)
        # demotion snapshots that raised (every candidate then lost), and
        # the last such error: a full slab that cannot page out says why
        self.snapshot_errors = 0
        self.last_snapshot_error: Optional[str] = None
        # the fleet's hook (slice 9 of the port): page_out(sid, payload)
        # -> bool offers a warm payload to a less-loaded peer replica
        # before the disk; None on one server
        self._page_out = None
        self._running = False
        self._wakeup = threading.Event()
        self._thread: Optional[threading.Thread] = None
        # the cold tier: append-log + index + compression; re-indexes (and
        # startup-compacts) a previous incarnation's log AND any v1
        # hibernated_<sid>.json files, so cold sessions survive process
        # death across both layouts
        self._spill = SpillStore(spill_dir) if spill_dir else None
        if self._spill is not None:
            # the v3 store's segment/index/compaction gauges ride every
            # /stats and /metrics snapshot (read on demand, no sync)
            self.app.metrics.spill_provider = self._spill.stats

    @property
    def page_out(self):
        return self._page_out

    @page_out.setter
    def page_out(self, hook) -> None:
        if hook is not None:
            raise NotImplementedError(
                "the page_out hook (peer paging) comes with the fleet, "
                "slice 9 of the port")
        self._page_out = None

    # -- lifecycle ---------------------------------------------------------
    def start(self) -> "TierManager":
        if self._thread is not None:
            return self
        self._running = True
        self._thread = threading.Thread(target=self._loop, daemon=True,
                                        name="serve-tier-sweeper")
        self._thread.start()
        return self

    def stop(self) -> None:
        self._running = False
        self._wakeup.set()
        t, self._thread = self._thread, None
        if t is not None:
            t.join(timeout=5.0)
        if self._spill is not None:
            # flush the sidecar index so the next start is O(index)
            self._spill.close()

    # -- reads -------------------------------------------------------------
    def counts(self) -> dict:
        with self._lock:
            warm = len(self._warm)
        cold = len(self._spill) if self._spill is not None else 0
        return {"hot": self.app.store.live_sessions(), "warm": warm,
                "cold": cold}

    def parked(self, sid: str) -> bool:
        """Whether the sid lives in a non-resident tier (or is mid-wake)."""
        with self._lock:
            if sid in self._warm or sid in self._waking:
                return True
        return self._spill is not None and sid in self._spill

    def parked_sids(self) -> list[str]:
        """Every non-resident session id, warm first then cold — the one
        tier-union enumeration (``/sessions``, ``export_parked``, the
        fleet worklist all read this, so the tier map layout has a
        single reader)."""
        with self._lock:
            sids = list(self._warm)
        if self._spill is not None:
            seen = set(sids)
            sids += [s for s in self._spill.sids() if s not in seen]
        return sids

    def parked_payload(self, sid: str, materialized: bool = True
                       ) -> Optional[dict]:
        """The export payload of a parked session, without waking it (the
        migration sweep and ``POST /export`` read this directly — a warm
        session IS its payload), JSON-safe (base64 arrays); with
        ``materialized=False`` the tier's own form (raw host arrays, or
        the spill store's lazy view) for a caller that reads only meta
        keys. None when the sid is hot, mid-wake, or unknown."""
        from coda_tpu_torch.serve.spill import materialize

        with self._lock:
            entry = self._warm.get(sid)
        if entry is not None:
            p = entry["payload"]
        elif self._spill is not None:
            p = self._spill.get(sid)
        else:
            return None
        return materialize(p) if materialized else p

    def export_parked(self) -> list:
        """Every parked session's payload (the drain/migrate sweep's
        off-slab half — rolling restarts must carry all three tiers)."""
        out = []
        for sid in self.parked_sids():
            p = self.parked_payload(sid)
            if p is not None:
                out.append(p)
        return out

    # -- demotion (hot -> warm) --------------------------------------------
    def try_demote(self, sid: str) -> bool:
        """Demote one resident session to the warm tier; False when it
        cannot be demoted RIGHT NOW (unknown, restoring, pinned by an
        in-flight verb/ticket, no completed first dispatch, or a label
        landed while the payload was being built). Losing those races is
        the contract, not a failure — the caller just moves on."""
        with self.app.store.lock:
            sess = self.app.store._sessions.get(sid)
            bucket = sess.bucket if sess is not None else None
        if bucket is None:
            return False
        return self.demote_batch(bucket, [sid]) == 1

    def demote_batch(self, bucket, sids, allow_unstarted: bool = False
                     ) -> int:
        """Demote many of one bucket's sessions in one sweep: candidates
        are pinned, the slab is snapshotted ONCE for all of them
        (`Bucket.snapshot_slots` — one lock acquisition instead of one
        per session), and each is then atomically unpublished under the
        same pins-and-label-count re-check as a single demotion. Returns
        how many demoted; each loser aborted cleanly with its state
        untouched.

        ``allow_unstarted`` admits sessions with no completed dispatch
        (``sess.last`` empty) — the restore-wave path only, where a
        zero-row stream legitimately restores to that state; live
        traffic keeps the guard because a brand-new open's session is
        briefly unpinned before its start ticket is submitted."""
        store = self.app.store
        cands = []
        with store.lock:
            for sid in sids:
                sess = store._sessions.get(sid)
                if sess is None or sess.bucket is not bucket \
                        or sess.restoring or sess.pins > 0 \
                        or (not sess.last and not allow_unstarted):
                    continue
                sess.pins += 1          # our own pin: blocks other demoters
                cands.append((sess, sess.n_labeled))
        if not cands:
            return 0
        with self._lock:
            self._demoting += 1
        try:
            return self._demote_cands(bucket, cands)
        finally:
            with self._lock:
                self._demoting -= 1
                self._demoted.notify_all()

    def wait_for_demotions(self, timeout: float = 60.0) -> bool:
        """Wait while another thread's demotion is in flight (it frees its
        slots when it publishes); True when one was."""
        with self._lock:
            if self._demoting == 0:
                return False
            self._demoted.wait_for(lambda: self._demoting == 0, timeout)
            return True

    def _demote_cands(self, bucket, cands) -> int:
        """The rest of :meth:`demote_batch` over pinned candidates."""
        from coda_tpu_torch.serve import recovery

        app, store = self.app, self.app.store
        try:
            snaps = bucket.snapshot_slots([s.slot for s, _ in cands])
        except Exception as e:
            # slab unreadable (quarantined, healed mid-copy, ...): all abort
            snaps = {}
            self.snapshot_errors += 1
            self.last_snapshot_error = repr(e)
        n_demoted = 0
        for sess, n0 in cands:
            published = False
            try:
                snap = snaps.get(sess.slot)
                if snap is None:
                    continue
                payload = recovery.build_export_payload(app, sess,
                                                        snapshot=snap,
                                                        raw=True)
                with store.lock:
                    if sess.pins != 1 or sess.n_labeled != n0:
                        # an in-flight ticket holds a pin, or a label
                        # committed since the snapshot: demotion loses
                        continue
                    if store._sessions.pop(sess.sid, None) is None:
                        # closed concurrently (close never pins): the
                        # session is gone, nothing to demote
                        continue
                    sess.pins = 0
                    published = True
            except Exception:
                continue  # only THIS candidate aborts — an escape here
                #           would strand the remaining candidates pinned
            finally:
                if not published:
                    store.unpin(sess)
            if not published:
                continue
            # from here no verb can reach the session (get raises):
            # release the slot, park the stream, publish the payload
            sess.bucket.release(sess.slot)
            if getattr(app, "prior_pool", None) is not None:
                # the demotion snapshot is the last host view of the fit:
                # contribute it now (close of a parked session never wakes)
                try:
                    if app.contribute_prior(sess,
                                            bucket.fit_from_leaves(snap[0])):
                        # the payload was built pre-contribution: mark it
                        # so a wake (or a migration of the parked copy)
                        # restores the once-flag and never re-contributes
                        payload["prior_contributed"] = True
                except Exception:
                    pass
            app.recorder.park(sess.sid)
            with self._lock:
                self._warm[sess.sid] = {"payload": payload,
                                        "task": sess.task,
                                        "last_used": time.monotonic()}
            app.metrics.record_tier("demote")
            n_demoted += 1
        if n_demoted:
            self._publish_gauges()
        return n_demoted

    def make_room(self, bucket) -> bool:
        """Admission-pressure demotion: page out the coldest demotable
        sessions on ``bucket`` (LRU on last-label/last-touch time). True
        when at least one slot was freed. Demotes a small LRU batch, not
        one session — the slab snapshot behind a demotion waits out any
        in-flight dispatch, so under an admission herd the wait must buy
        more than one slot."""
        sessions = self.app.store.sessions_on(bucket)
        sessions.sort(key=lambda s: s.last_used)
        batch = max(1, bucket.capacity // 16)
        while sessions:
            lru, sessions = sessions[:batch], sessions[batch:]
            if self.demote_batch(bucket, [s.sid for s in lru]) > 0:
                return True
        return False

    def make_room_for(self, task: str, spec) -> bool:
        for b in self.app.store.buckets():
            if b.task == task and b.spec == spec:
                if self.make_room(b):
                    return True
        return False

    # -- hibernation (warm -> cold) ----------------------------------------
    def hibernate(self, sid: str) -> bool:
        """Move one warm payload into the spill store. Compression runs
        OUTSIDE the tier lock (the old end-to-end hold stalled concurrent
        wakes behind zlib for the whole demotion batch); the commit
        window re-checks the entry is the SAME object — a wake or a
        re-park between the two lock windows aborts the move, so the sid
        is never unreachable and never spilled stale. A failed disk
        write leaves the session warm, counted, never lost."""
        if self._spill is None:
            return False
        with self._lock:
            entry = self._warm.get(sid)
        if entry is None:
            return False
        encoded = self._spill.encode(entry["payload"])
        with self._lock:
            if self._warm.get(sid) is not entry:
                return False  # woke (or was re-parked fresh) mid-encode
            if not self._spill.put_encoded(sid, encoded):
                self.spill_errors += 1
                return False
            del self._warm[sid]
        # the spilled frame is now the authority: seal the recorder
        # stream (close marker) so --restore skips it instead of
        # rebuilding a second live copy next to the cold one
        self.app.recorder.seal(sid)
        self.app.metrics.record_tier("hibernate")
        self._publish_gauges()
        return True

    def page_to_peer(self, sid: str) -> bool:
        """Offer one warm payload to a peer replica via the fleet's
        ``page_out`` hook (demotion-aware peer paging): the entry leaves
        the warm map FIRST (atomically — a concurrent wake then misses
        locally and the router finds the session on the peer), the peer
        imports it digest-verified, and on any failure the entry is
        re-parked warm, never lost. The local stream gets its close
        marker exactly like a migration away — the peer owns the session
        now."""
        hook = self.page_out
        if hook is None:
            return False
        with self._lock:
            entry = self._warm.pop(sid, None)
        if entry is None:
            return False
        ok = False
        try:
            ok = bool(hook(sid, entry["payload"]))
        except Exception:
            ok = False
        if not ok:
            with self._lock:
                self._warm[sid] = entry
            return False
        self.app.recorder.seal(sid)
        self.app.metrics.record_tier("peer_page")
        self._publish_gauges()
        return True

    # -- wake (warm/cold -> hot) -------------------------------------------
    def wake_if_parked(self, sid: str, timeout: float = 60.0) -> bool:
        """Wake a parked session (or wait out a wake already in flight).
        False when the sid is in no tier — the caller's UnknownSession
        stands. Raises what the wake raised (SlabFull when no slot could
        be freed, ImportRejected when the payload cannot be verified)."""
        if self.app.held(sid):
            # mid-migration (serve/server.py hold protocol): the export
            # payload is in the router's hands — a wake now would revive
            # a copy the destination may already own. Retryable: the
            # move commits (retry re-routes) or aborts (retry lands).
            from coda_tpu_torch.serve.state import BucketQuarantined

            raise BucketQuarantined(
                f"session {sid} is migrating; retry shortly")
        with self._lock:
            ev = self._waking.get(sid)
            if ev is not None:
                mine = False
            else:
                if sid not in self._warm and not (
                        self._spill is not None and sid in self._spill):
                    return False
                ev = self._waking[sid] = threading.Event()
                mine = True
        if not mine:
            ev.wait(timeout)  # coalesced: ride the in-flight wake
            return True
        try:
            self._wake(sid)
        finally:
            with self._lock:
                self._waking.pop(sid, None)
            ev.set()
        return True

    def _wake(self, sid: str) -> None:
        """One wake: pop the payload, admit through the import fast path
        (snapshot digest-match; stream replay fallback), demoting the
        coldest resident session when the slab is full."""
        from coda_tpu_torch.serve import recovery

        t0 = time.perf_counter()
        with self._lock:
            entry = self._warm.pop(sid, None)
        payload = None
        if entry is not None:
            src, payload = "warm", entry["payload"]
        elif self._spill is not None:
            src, payload = "cold", self._spill.get(sid)
        if payload is None:
            return  # discarded between the caller's check and ours
        try:
            info = None
            for _ in range(self.wake_attempts):
                try:
                    info = recovery.import_session(self.app, payload,
                                                   count=False)
                    break
                except SlabFull:
                    if not self.make_room_for(payload["task"],
                                              self.app.spec) \
                            and not self.wait_for_demotions():
                        # every resident session is pinned by an in-flight
                        # verb: brief, retry after a beat
                        time.sleep(0.005)
            if info is None:
                raise SlabFull(
                    f"wake of session {sid}: no slab slot could be freed "
                    f"after {self.wake_attempts} demotion attempts"
                    + (f" (last snapshot error: {self.last_snapshot_error})"
                       if self.last_snapshot_error else ""))
        except BaseException:
            # keep the session reachable: re-park the payload (warm) /
            # leave the hibernate file (cold), and kick the healer in
            # case a replay dispatch quarantined the bucket
            if src == "warm":
                with self._lock:
                    self._warm[sid] = entry
            self.app.metrics.record_tier("wake_failed")
            self.app._heal_quarantined()
            raise
        if src == "cold":
            self._spill.delete(sid)
        self.app.metrics.record_tier(
            "wake", src=src, seconds=time.perf_counter() - t0,
            via=(info or {}).get("restored_via"))
        self._publish_gauges()

    # -- discard (close of a parked session) -------------------------------
    def discard(self, sid: str) -> bool:
        """Drop a parked session (its DELETE): payload and hibernate file
        go away; the caller writes the stream's close marker."""
        with self._lock:
            had_warm = self._warm.pop(sid, None) is not None
        had_cold = (self._spill is not None and self._spill.delete(sid))
        if had_warm or had_cold:
            self._publish_gauges()
            return True
        return False

    # -- the sweeper -------------------------------------------------------
    def _loop(self) -> None:
        while self._running:
            try:
                self.sweep()
            except Exception:
                pass  # the sweeper must never die to a transient race
            self._wakeup.wait(self.sweep_interval_s)
            self._wakeup.clear()

    def sweep(self) -> dict:
        """One pass of the demotion policy: idle hot→warm, watermark
        hot→warm (LRU, only past ``min_idle_s``), aged/overflow warm→cold.
        Returns counts (the test hook); also refreshes the tier gauges and
        the process-RSS sample the memory claim is gated on."""
        now = time.monotonic()
        store = self.app.store
        n_demoted = n_hibernated = 0
        for bucket in store.buckets():
            sessions = store.sessions_on(bucket)
            idle = [s.sid for s in sessions
                    if now - s.last_used > self.idle_warm_s]
            if idle:
                n_demoted += self.demote_batch(bucket, idle)
            if self.free_fraction > 0:
                target = max(1, int(bucket.capacity * self.free_fraction))
                deficit = target - (bucket.capacity - bucket.live)
                if deficit > 0:
                    cands = sorted(store.sessions_on(bucket),
                                   key=lambda s: s.last_used)
                    lru = [s.sid for s in cands[:deficit]
                           if now - s.last_used >= self.min_idle_s]
                    if lru:
                        n_demoted += self.demote_batch(bucket, lru)
        if self._spill is not None or self.page_out is not None:
            with self._lock:
                aged = [sid for sid, e in self._warm.items()
                        if now - e["last_used"] > self.idle_cold_s]
                over = len(self._warm) - self.max_warm
                if over > 0:
                    # LRU overflow: insertion order ≈ demotion order
                    aged_set = set(aged)
                    lru = [sid for sid in self._warm
                           if sid not in aged_set][:over]
                else:
                    lru = []
            for sid in aged + lru:
                if self.app.held(sid):
                    continue  # mid-migration: the router owns this move
                # demotion-aware peer paging: a pressured replica offers
                # the payload to a less-loaded peer first; disk is the
                # fallback, not the only exit
                if self.page_to_peer(sid):
                    n_hibernated += 1
                    continue
                n_hibernated += self.hibernate(sid)
        if self._spill is not None:
            # per-segment compaction rides the sweeper, not startup —
            # it copies raw frame bytes forward one short lock window at
            # a time, so it never stops wakes or demotions
            self._spill.maybe_compact()
        self._publish_gauges()
        from coda_tpu_torch.telemetry.registry import sample_process_rss

        sample_process_rss(self.app.telemetry.registry)
        return {"demoted": n_demoted, "hibernated": n_hibernated}

    def _publish_gauges(self) -> None:
        c = self.counts()
        self.app.metrics.set_tier_occupancy(c["hot"], c["warm"], c["cold"])
