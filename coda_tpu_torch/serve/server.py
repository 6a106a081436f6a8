"""Asyncio HTTP/JSON front door over the batched session store
(counterpart of ``coda_tpu/serve/server.py``).

Dependency-free (stdlib ``asyncio``): one event loop multiplexes every
connection, handlers do pure host work — parse JSON, admission control,
enqueue a ticket, ``await`` the rendezvous — while ALL device work
funnels through the single batcher thread (tickets bridge back into the
loop via ``call_soon_threadsafe``), so N concurrent users cost one slab
step per tick, not N device round trips. Blocking host sections
(admission's bucket build, posterior reads) run on an executor.

    POST   /session                  {task?, seed?}    -> admit + first item
    POST   /session/{id}/label       {label, idx?,
                                      request_id?}     -> update, next item
                                                          (idempotent on
                                                          request_id)
    POST   /session/{id}/labels      {labels, idx?,
                                      request_id?}     -> the q answers of a
                                                          round (acq_batch q)
    GET    /session/{id}/best                          -> best (+ pbest)
    POST   /session/{id}/answer      {slot, label?,
                                      abstain?,
                                      request_id?}     -> one crowd answer,
                                                          any order (parked
                                                          until the round
                                                          is complete)
    GET    /session/{id}/trace                         -> per-round decision
                                                          history (recorder)
    POST   /session/{id}/export      {close?}          -> migration payload
    POST   /session/import           <export payload>  -> restore, same id
    DELETE /session/{id}                               -> close, free slot
    POST   /prior/sync               {pool?}           -> prior-pool delta
    GET    /stats                                      -> metrics snapshot
    GET    /metrics                                    -> Prometheus text
    GET    /fleet/quality                              -> decision-quality
                                                          scorecard
    GET    /healthz                                    -> readiness/liveness
                                                          (ok|degraded|
                                                          unready)

Admission control: with tiering (the default, ``serve/tiering.py``) a
full slab demotes its coldest idle session to the warm tier and admits;
a label/best/trace/answer for a demoted session wakes it. 503 remains
the backpressure signal when nothing is demotable (every slot pinned by
an in-flight request), with ``--no-tiering``, and on a draining server.
``ServeApp.drain()`` stops admitting, finishes the queued work and closes
the streams.

Warm pool: ``ServeApp.start()`` warms every (task, spec) bucket — builds
and loads the kernels, caches the init state (``Bucket.warm``) — and
``/healthz`` answers 503 until then.

Refused until the fleet, slice 9 of the port (``NotImplementedError`` in
process, HTTP 501 over the wire): ``begin_migration``/``end_migration``
(``POST /session/{id}/fence``, ``export`` with ``hold``) and the tiers'
``page_out`` hook.

Run:  python -m coda_tpu_torch.cli serve [--task T | --synthetic H,N,C]
          [--record-dir D [--restore]] [--tier-spill-dir S] [--port P]
          [--device cuda|cpu]
"""

from __future__ import annotations

import argparse
import asyncio
import contextlib
import json
import os
import re
import socket
import threading
import time
from typing import Optional

import numpy as np

from coda_tpu_torch.serve.batcher import Batcher, Ticket
from coda_tpu_torch.serve.metrics import ServeMetrics
from coda_tpu_torch.serve.recovery import _SID_RE, ImportRejected
from coda_tpu_torch.serve.state import (
    BucketQuarantined,
    SelectorSpec,
    SessionStore,
    SlabFull,
    StaleOwner,
    UnknownSession,
)
from coda_tpu_torch.utils.platform import DeviceLike, resolve_device

# how long a front-door handler waits on its ticket before giving up (a
# stuck device should surface as 504s, not piled-up waiters)
REQUEST_TIMEOUT_S = 60.0


def _slice_9(what: str):
    return NotImplementedError(
        f"{what} comes with the fleet, slice 9 of the port")


class ServeApp:
    """Store + batcher + metrics + admission policy + warm pool, bundled
    for the front door (and for in-process embedding: tests drive a
    ServeApp directly). Runs on ``device`` (default the card; raises
    without one unless ``device="cpu"``)."""

    def __init__(self, capacity: int = 64, bucket_n: int = 1,
                 max_batch: int = 256, max_wait: float = 0.002,
                 max_linger: Optional[float] = None,
                 default_task: Optional[str] = None,
                 spec: Optional[SelectorSpec] = None,
                 step_impl: Optional[str] = None, donate: bool = True,
                 telemetry=None, recorder=None,
                 fault_spec: Optional[str] = None,
                 tiering: bool = True,
                 tier_spill_dir: Optional[str] = None,
                 idle_warm_s: float = 30.0, idle_cold_s: float = 120.0,
                 max_warm: int = 8192, tier_free_fraction: float = 0.0,
                 tracing: bool = True, quality: bool = True,
                 quality_audit_frac: float = 0.25,
                 device: DeviceLike = None):
        from coda_tpu_torch.serve.faults import FaultInjector
        from coda_tpu_torch.serve.recovery import BucketHealer
        from coda_tpu_torch.serve.tiering import TierManager
        from coda_tpu_torch.telemetry import SessionRecorder, Telemetry

        self.device = resolve_device(device)
        self.faults = FaultInjector(fault_spec) if fault_spec else None
        # distributed tracing (telemetry/trace.py): read by spans, metrics
        # and recorder rows only, never by the step's math
        self.tracing = bool(tracing)
        # the slab step writes in place: donation has no counterpart
        del donate
        self.store = SessionStore(capacity=capacity, bucket_n=bucket_n,
                                  step_impl=step_impl, faults=self.faults,
                                  device=self.device)
        self.metrics = ServeMetrics()
        self.telemetry = telemetry if telemetry is not None else Telemetry()
        # per-session decision streams: always live in memory (the
        # GET /session/{id}/trace payload); --record-dir adds the JSONL
        self.recorder = recorder if recorder is not None \
            else SessionRecorder(faults=self.faults)
        if self.faults is not None and \
                getattr(self.recorder, "faults", None) is None:
            self.recorder.faults = self.faults   # record_eio
        # decision-quality plane (telemetry/quality.py): live calibration
        # of the served posterior, drift detectors, and the shadow auditor
        # that replays a sample of closed sessions off the batcher thread.
        # Never read by the step's math: quality on and off give bitwise
        # the same decision rows (the only stream delta is the additive
        # ``pred_label_prob`` field)
        self.quality = None
        if quality:
            from coda_tpu_torch.telemetry.quality import QualityPlane

            self.quality = QualityPlane(
                preds_fn=self.store.task_preds, faults=self.faults,
                registry=self.telemetry.registry,
                audit_frac=quality_audit_frac)
            self.metrics.quality_provider = self.quality.snapshot
        self.batcher = Batcher(self.store, self.metrics,
                               max_batch=max_batch, max_wait=max_wait,
                               max_linger=max_linger,
                               telemetry=self.telemetry,
                               recorder=self.recorder,
                               faults=self.faults,
                               quality=self.quality)
        self.metrics.surrogate_provider = self._surrogate_totals
        # bucket self-healing: a dispatch that quarantines a bucket
        # schedules a slab rebuild from the sessions' recorder streams
        self.healer = BucketHealer(self.store, self.recorder,
                                   metrics=self.metrics)
        self.batcher.on_bucket_failure = self.healer.schedule
        # tiered posterior state (serve/tiering.py): hot sessions on the
        # slab, warm ones as host export payloads, cold ones hibernated to
        # tier_spill_dir; admission past capacity demotes the coldest
        # instead of a 503, and a verb for a parked session wakes it
        self.tiers = TierManager(
            self, spill_dir=tier_spill_dir, idle_warm_s=idle_warm_s,
            idle_cold_s=idle_cold_s, max_warm=max_warm,
            free_fraction=tier_free_fraction) if tiering else None
        self.spec = spec or SelectorSpec.create("coda", n_parallel=capacity)
        self.spec.factory(self.device)   # a bad knob raises here
        # cross-session surrogate prior pool (serve/priors.py): live only
        # under surrogate_prior='pool'; under 'off' there is no pool and
        # admission seeds nothing
        self.prior_pool = None
        from coda_tpu_torch.selectors.surrogate import parse_prior

        if parse_prior(str(dict(self.spec.kwargs).get("surrogate_prior",
                                                      "off"))):
            from coda_tpu_torch.serve.priors import (PriorPool,
                                                     bucket_pool_key)

            self.prior_pool = PriorPool()
            self.metrics.prior_provider = self._prior_totals
            # lazily built buckets resolve their seed prior at build time
            self.store.prior_resolver = (
                lambda b: self.prior_pool.get(bucket_pool_key(self, b)))
        self.default_task = default_task
        self.draining = False
        # migration holds come with the fleet (slice 9): always empty here
        self._holds: set = set()
        self.warm_error: Optional[str] = None  # last warm-up failure
        # readiness: set once the warm pool is ready (or warm-up was
        # skipped); /healthz answers 503 until then
        self.ready = threading.Event()
        self.warm_info: dict = {}
        self._warm_requested = False
        self._seed_lock = threading.Lock()
        self._next_seed = 0
        from concurrent.futures import ThreadPoolExecutor

        self._executor = ThreadPoolExecutor(
            max_workers=32, thread_name_prefix="serve-verb")
        # the record/replay counters exist at 0 on /metrics from the start
        self.telemetry.counter(
            "serve_record_rows_total",
            "Per-round decision rows streamed by the serving recorder")
        self.telemetry.counter(
            "records_written_total",
            "Flight-recorder run records written")
        self.telemetry.counter(
            "replay_verified_total",
            "Replay verifications that matched their record")

    def add_task(self, name: str, preds, class_names=None, model_names=None,
                 default: bool = False) -> None:
        self.store.register_task(name, preds, class_names=class_names,
                                 model_names=model_names)
        if default or self.default_task is None:
            self.default_task = name

    # -- warm pool ---------------------------------------------------------
    def warm(self) -> dict:
        """Warm every (task, spec) bucket (``Bucket.warm``: the kernels
        built and loaded, the init state cached). Sets readiness; returns
        {size, warm_s, buckets}."""
        t0 = time.perf_counter()
        n_exec = 0
        tasks = self.store.tasks()
        for task in tasks:
            bucket = self.store._bucket_for(task, self.spec)
            n_exec += bucket.warm()["executables"]
        wall = time.perf_counter() - t0
        self.metrics.record_warm_pool(n_exec, wall)
        self.warm_info = {"size": n_exec, "warm_s": wall,
                          "buckets": len(tasks)}
        self.ready.set()
        return dict(self.warm_info)

    def _warm_background(self) -> None:
        try:
            info = self.warm()
            print(f"warm pool ready: {info['size']} callables in "
                  f"{info['warm_s']:.1f}s", flush=True)
        except Exception as e:  # degraded but serviceable: the first
            # dispatch warms lazily; visible on /metrics, /stats, /healthz
            self._record_warm_failure(e)
            self.ready.set()

    def _record_warm_failure(self, e: BaseException) -> None:
        self.warm_error = repr(e)
        reg = self.telemetry.registry
        reg.counter("serve_warmup_failures_total",
                    "Warm-pool builds that failed (server degraded to "
                    "lazy warm-up)").inc()
        reg.gauge("serve_warmup_last_failure_timestamp",
                  "Unix time of the last warm-pool failure").set(
                      time.time())
        print(f"warm-up failed ({e}); serving with lazy warm-up",
              flush=True)

    def start(self, warm: bool = True,
              warm_async: bool = False) -> "ServeApp":
        self._warm_requested = warm
        self.batcher.start()
        if self.tiers is not None:
            self.tiers.start()
        if not warm:
            self.ready.set()
        elif warm_async:
            threading.Thread(target=self._warm_background, daemon=True,
                             name="serve-warmup").start()
        else:
            self._warm_background()
        return self

    def quiesce(self, timeout: float = 30.0, hard: bool = False) -> None:
        """Stop admitting and stop ticking, keeping sessions, streams and
        the executor alive. Default: finish queued work first; ``hard``
        fails queued tickets with a retryable error."""
        self.draining = True
        if self.tiers is not None:
            self.tiers.stop()  # no demotions mid-migration sweep
        self.batcher.stop(drain=not hard, timeout=timeout)

    def drain(self, timeout: float = 30.0) -> None:
        """Graceful shutdown: refuse new sessions, finish queued requests,
        close the streams."""
        self.quiesce(timeout=timeout)
        self.recorder.close_all()
        if self.quality is not None:
            self.quality.stop()
        self._executor.shutdown(wait=False)

    def _auto_seed(self) -> int:
        with self._seed_lock:
            s = self._next_seed
            self._next_seed += 1
            return s

    # -- distributed tracing glue ------------------------------------------
    def _trace_child(self, trace_ctx):
        """Continue the caller's trace: a fresh span under the same trace.
        None when untraced or tracing is off."""
        if trace_ctx is None or not self.tracing:
            return None
        return trace_ctx.child()

    @contextlib.contextmanager
    def _serve_span(self, verb: str, ctx):
        """Record ``serve/<verb>`` on the ``host:serve`` lane under
        ``ctx`` on every exit (no-op when untraced)."""
        if ctx is None:
            yield
            return
        t0 = time.perf_counter()
        attrs = ctx.attrs()
        try:
            yield
        except BaseException as e:
            attrs["error"] = type(e).__name__
            raise
        finally:
            self.telemetry.spans.record(f"serve/{verb}", lane="host:serve",
                                        t_start=t0,
                                        t_end=time.perf_counter(),
                                        attrs=attrs)

    def trace_by_id(self, trace_id: str) -> dict:
        """This process's retained spans for one trace (the ``GET
        /trace/id/{trace_id}`` payload; empty events when unknown)."""
        return self.telemetry.spans.trace_payload(str(trace_id))

    # -- fencing (the holds come with the fleet, slice 9) ------------------
    def held(self, sid: str) -> bool:
        with self.store.lock:
            return sid in self._holds

    def _check_hold(self, sid: str) -> None:
        if self.held(sid):
            raise BucketQuarantined(
                f"session {sid} is migrating; retry shortly")

    def _check_epoch(self, sess, epoch) -> None:
        """The fencing check of the fleet's routed verbs: a verb stamped
        with a NEWER ownership epoch than this copy's is refused."""
        if epoch is not None and int(epoch) > sess.epoch:
            self.metrics.record_fencing_rejection()
            raise StaleOwner(sess.sid, have=sess.epoch, want=int(epoch))

    def session_epoch(self, sid: str) -> dict:
        """The ownership epoch of this replica's copy, without waking it."""
        try:
            return {"session": sid, "epoch": self.store.get(sid).epoch}
        except UnknownSession:
            if self.tiers is not None:
                p = self.tiers.parked_payload(sid, materialized=False)
                if p is not None:
                    return {"session": sid,
                            "epoch": int(p.get("epoch") or 0)}
            raise

    def begin_migration(self, sid: str) -> dict:
        raise _slice_9("the migration hold (begin_migration)")

    def end_migration(self, sid: str, drop: bool) -> dict:
        raise _slice_9("the migration fence (end_migration)")

    # -- tiering glue: wake-through lookup + demote-then-admit -------------
    def _resolve_pinned(self, sid: str, wake: bool = True):
        """Session lookup that pages a non-resident session back in: a
        label/best/trace for a warm or cold sid wakes it through the
        import fast path instead of 404-ing. Returns the session PINNED
        (undemotable) — every caller unpins on every exit path.
        ``wake=False`` skips paging (the event-loop fast path, which
        must never run a wake's disk/replay work inline)."""
        misses = 0
        for _ in range(8):
            try:
                return self.store.get_pinned(sid)
            except UnknownSession:
                if self.tiers is None or not wake:
                    raise
                if self.tiers.wake_if_parked(sid):
                    continue
                # in no tier map — either truly unknown, or inside a
                # demotion's unpublish→publish window (store pop, slot
                # release, stream park all precede the warm-map insert):
                # wait that window out before answering 404
                misses += 1
                if misses > 3:
                    raise
                time.sleep(0.002)
        return self.store.get_pinned(sid)

    def _admit(self, task: str, seed: int, sid: Optional[str] = None,
               restoring: bool = False):
        """``store.open`` with tiering admission: past slab capacity the
        coldest resident session is demoted and the open retried —
        ``SlabFull`` (503) only when nothing is demotable (every slot
        pinned by an in-flight verb), which is genuine backpressure."""
        attempts = 16 if self.tiers is not None else 1
        for i in range(attempts):
            try:
                return self.store.open(task, self.spec, seed=seed, sid=sid,
                                       restoring=restoring)
            except SlabFull:
                if self.tiers is None or i == attempts - 1:
                    raise
                if not self.tiers.make_room_for(task, self.spec) \
                        and not self.tiers.wait_for_demotions(
                            REQUEST_TIMEOUT_S):
                    # transient: every candidate is pinned by a concurrent
                    # verb — wait a beat for the herd to clear instead of
                    # bouncing a 503 the client would only retry anyway
                    # (another demoter mid-sweep is waited out above)
                    time.sleep(0.002)

    # -- the session verbs (*_begin/_abort split out so the asyncio path
    #    runs the blocking host half on an executor and awaits the ticket)
    def _open_begin(self, task: Optional[str], seed: Optional[int],
                    sid: Optional[str] = None, trace=None):
        if self.draining:
            self.metrics.record_session("reject")
            raise Draining()
        task = task or self.default_task
        if task is None:
            raise KeyError("no task registered")
        if sid is not None:
            if not _SID_RE.match(str(sid)):
                raise ValueError(f"invalid session id {sid!r}: expected "
                                 "lowercase hex")
            if self.tiers is not None and self.tiers.parked(sid):
                # the store collides only against LIVE sids: re-opening a
                # parked id would put two states under one identity
                raise ValueError(f"session id {sid!r} already exists "
                                 "(parked in the warm/cold tier)")
        try:
            sess = self._admit(task, self._auto_seed() if seed is None
                               else int(seed), sid=sid)
        except SlabFull:
            self.metrics.record_session("reject")
            raise
        self.metrics.record_session("open")
        tm = self.store.task_meta(sess.task)
        # everything a heal or an offline replay needs to rebuild this
        # session from its stream alone
        self.recorder.open(sess.sid, meta={
            "task": sess.task, "method": self.spec.method,
            "spec_kwargs": [list(kv) for kv in self.spec.kwargs],
            "acq_batch": self.spec.acq_batch,
            "seed": sess.seed, "shape": tm.get("shape"),
            "digest": tm.get("digest"),
            # the applied-prior record ONLY when this admission was seeded:
            # cold sessions keep the exact pre-prior meta
            **({"surrogate_prior": dict(sess.prior_fit)}
               if sess.prior_fit is not None else {})})
        self.store.pin(sess)
        ticket = Ticket(session=sess, do_update=False, trace=trace)
        ticket.on_resolve = lambda: self.store.unpin(sess)
        return sess, self.batcher.submit(ticket)

    def _open_abort(self, sess) -> None:
        # the first dispatch failed: the client never learns the session
        # id, so free the slot here or it leaks until restart
        self.store.close(sess.sid)
        self.recorder.close(sess.sid)
        self.metrics.record_session("close")

    def open_session(self, task: Optional[str] = None,
                     seed: Optional[int] = None,
                     sid: Optional[str] = None, trace_ctx=None) -> dict:
        my = self._trace_child(trace_ctx)
        with self._serve_span("open", my):
            sess, ticket = self._open_begin(task, seed, sid=sid, trace=my)
            try:
                res = ticket.wait(REQUEST_TIMEOUT_S)
            except BaseException:
                self._open_abort(sess)
                raise
            return self._payload(sess, res)

    async def open_session_async(self, task: Optional[str] = None,
                                 seed: Optional[int] = None,
                                 sid: Optional[str] = None,
                                 trace_ctx=None) -> dict:
        loop = asyncio.get_running_loop()
        my = self._trace_child(trace_ctx)
        with self._serve_span("open", my):
            if (self.recorder.out_dir is None
                    and self.store.has_fast_admission(
                        task or self.default_task or "", self.spec)):
                # warm-pool fast path: admission is host work (a free-slot
                # pop and a staged write of the cached init), inline
                sess, ticket = self._open_begin(task, seed, sid=sid,
                                                trace=my)
            else:
                sess, ticket = await loop.run_in_executor(
                    self._executor,
                    lambda: self._open_begin(task, seed, sid=sid, trace=my))
            try:
                res = await ticket.wait_async(REQUEST_TIMEOUT_S)
            except BaseException:
                await loop.run_in_executor(self._executor, self._open_abort,
                                           sess)
                raise
            return self._payload(sess, res)

    def _label_begin(self, sid: str, label, idx=None,
                     request_id: Optional[str] = None, wake: bool = True,
                     epoch: Optional[int] = None, trace=None):
        if self.faults is not None and self.tiers is not None and \
                "demote_during_label" in self.faults.fire("label_pre"):
            # injected demotion at the exact moment a label arrives: it
            # either wins (and the lookup below wakes the session) or
            # loses cleanly to an in-flight pin — never both
            self.tiers.try_demote(sid)
        self._check_hold(sid)
        # wake-through lookup, PINNED: the pin is handed to the ticket
        # below; every non-ticket exit unpins in `finally`
        sess = self._resolve_pinned(sid, wake=wake)
        handoff = False
        try:
            # the fence: a stale copy must refuse BEFORE the dedupe
            # lookup — its cache predates the migration, and answering
            # from it would commit a label the new owner also commits
            self._check_epoch(sess, epoch)
            if sess.restoring:
                # import/restore mid-replay: the posterior and the dedupe
                # cache are not rebuilt yet — a retryable 503
                raise BucketQuarantined(
                    f"session {sid} is being restored; retry shortly")
            # idempotent retries: a request_id the session has already
            # applied (or has in flight) is answered from the committed
            # result / the live ticket — the oracle answer is applied to
            # the posterior EXACTLY once no matter how many times the
            # client retries. Checked BEFORE the stale-idx guard: a retry
            # of an applied label is stale by definition, and that
            # staleness is precisely what it means to have already been
            # applied.
            if request_id is not None:
                with self.store.lock:
                    done = sess.recent.get(request_id)
                    inflight = None if done is not None else \
                        sess.pending.get(request_id)
                    if inflight is not None and inflight.done.is_set() \
                            and inflight.error is not None:
                        inflight = None  # dead ticket: retry resubmits
                if done is not None:
                    t = Ticket(session=sess, do_update=True,
                               request_id=request_id)
                    t.complete(dict(done))
                    return sess, t
                if inflight is not None:
                    return sess, inflight
            cur = sess.last
            if not cur:
                raise UnknownSession(sid)  # start dispatch never completed
            # batch-label sessions (acq_batch q > 1): the session proposes
            # q items per round and ``label`` arrives as a length-q list —
            # all q oracle answers resolve through this ONE ticket/dispatch
            q = sess.bucket.acq_batch
            if q > 1:
                if not isinstance(label, (list, tuple)):
                    raise ValueError(
                        f"session {sid} batches {q} labels per round; "
                        "POST /session/{id}/labels with a 'labels' list")
                if len(label) != q:
                    raise ValueError(
                        f"session {sid} expects exactly {q} labels per "
                        f"round, got {len(label)}")
                if idx is not None:
                    if (not isinstance(idx, (list, tuple))
                            or [int(i) for i in idx]
                            != [int(i) for i in cur["next_idx"]]):
                        raise StaleItem(
                            f"session {sid} proposed items "
                            f"{cur['next_idx']}, got labels for {idx}")
                label = [int(v) for v in label]
                for v in label:
                    if not 0 <= v < sess.bucket.n_classes:
                        raise ValueError(
                            f"label {v} out of range "
                            f"[0, {sess.bucket.n_classes})")
            else:
                if isinstance(label, (list, tuple)):
                    if len(label) != 1:
                        raise ValueError(
                            f"session {sid} labels one item per round, "
                            f"got {len(label)} labels")
                    label = label[0]
                    if isinstance(idx, (list, tuple)):
                        idx = idx[0] if idx else None
                if idx is not None and int(idx) != cur["next_idx"]:
                    raise StaleItem(
                        f"session {sid} proposed item {cur['next_idx']}, "
                        f"got a label for {idx}")
                label = int(label)
                if not 0 <= label < sess.bucket.n_classes:
                    raise ValueError(f"label {label} out of range "
                                     f"[0, {sess.bucket.n_classes})")
            ticket = Ticket(session=sess, do_update=True,
                            idx=cur["next_idx"],
                            label=label, prob=cur["next_prob"],
                            request_id=request_id, trace=trace)
            if request_id is not None:
                # registration is atomic with a re-check, so two
                # concurrent retries of the same request_id can never
                # BOTH submit
                with self.store.lock:
                    done = sess.recent.get(request_id)
                    if done is None:
                        existing = sess.pending.get(request_id)
                        if existing is not None and not (
                                existing.done.is_set()
                                and existing.error is not None):
                            return sess, existing
                        sess.pending[request_id] = ticket
                if done is not None:
                    ticket.complete(dict(done))
                    return sess, ticket
            # the ticket inherits our pin; resolution releases it
            ticket.on_resolve = lambda: self.store.unpin(sess)
            handoff = True
            return sess, self.batcher.submit(ticket)
        finally:
            if not handoff:
                self.store.unpin(sess)

    def label(self, sid: str, label: int, idx: Optional[int] = None,
              request_id: Optional[str] = None,
              epoch: Optional[int] = None, trace_ctx=None) -> dict:
        my = self._trace_child(trace_ctx)
        with self._serve_span("label", my):
            sess, ticket = self._label_begin(sid, label, idx, request_id,
                                             epoch=epoch, trace=my)
            return self._payload(sess, ticket.wait(REQUEST_TIMEOUT_S))

    async def label_async(self, sid: str, label: int,
                          idx: Optional[int] = None,
                          request_id: Optional[str] = None,
                          epoch: Optional[int] = None,
                          trace_ctx=None) -> dict:
        my = self._trace_child(trace_ctx)
        with self._serve_span("label", my):
            try:
                # host-dict work (lookup, bounds checks, queue.put) inline,
                # with waking DISABLED: a wake's disk read or replay must
                # never run on the event loop
                sess, ticket = self._label_begin(sid, label, idx,
                                                 request_id, wake=False,
                                                 epoch=epoch, trace=my)
            except UnknownSession:
                if self.tiers is None:
                    raise
                # non-resident (or mid-demotion): the wake-through path on
                # the executor
                loop = asyncio.get_running_loop()
                sess, ticket = await loop.run_in_executor(
                    self._executor,
                    lambda: self._label_begin(sid, label, idx, request_id,
                                              epoch=epoch, trace=my))
            return self._payload(
                sess, await ticket.wait_async(REQUEST_TIMEOUT_S))

    def labels(self, sid: str, labels, idx=None,
               request_id: Optional[str] = None,
               epoch: Optional[int] = None, trace_ctx=None) -> dict:
        """The batch-label verb behind ``POST /session/{id}/labels``: all
        q oracle answers of one round, resolved through ONE ticket and
        ONE fused dispatch (the q-wide bucket's compiled step applies
        them as a single multi-row posterior update and proposes the next
        q items). Idempotent per ``request_id`` exactly like ``label`` —
        the batch commits to the posterior at most once no matter how
        many times the client retries. On an acq_batch=1 session a
        single-element list degrades to the plain label path.

        ``_label_begin`` is list-aware, so both verbs ARE the label
        verbs with a list payload — no second copy of the pin/dedupe
        choreography to keep in lockstep."""
        return self.label(sid, list(labels), idx=idx,
                          request_id=request_id, epoch=epoch,
                          trace_ctx=trace_ctx)

    async def labels_async(self, sid: str, labels, idx=None,
                           request_id: Optional[str] = None,
                           epoch: Optional[int] = None,
                           trace_ctx=None) -> dict:
        return await self.label_async(sid, list(labels), idx=idx,
                                      request_id=request_id, epoch=epoch,
                                      trace_ctx=trace_ctx)

    def answer(self, sid: str, slot, label=None,
               request_id: Optional[str] = None,
               epoch: Optional[int] = None, abstain: bool = False,
               trace_ctx=None) -> dict:
        my = self._trace_child(trace_ctx)
        with self._serve_span("answer", my):
            return self._answer_impl(sid, slot, label=label,
                                     request_id=request_id, epoch=epoch,
                                     abstain=abstain, trace=my)

    def _answer_impl(self, sid: str, slot, label=None,
                     request_id: Optional[str] = None,
                     epoch: Optional[int] = None, abstain: bool = False,
                     trace=None) -> dict:
        """The asynchronous oracle verb (``POST /session/{id}/answer``):
        ONE per-slot crowd answer of the current round, in ANY order.

        Where ``labels`` demands all q answers at once, a crowd delivers
        them one by one — noisy, late, out of order, some abstaining.
        Each arriving answer is PARKED per slot (a park row rides the
        recorder stream, so a crash loses nothing); when all ``acq_batch``
        slots are filled the park drains through ONE batch-label dispatch
        in slot order under a deterministic synthetic request_id — so an
        out-of-order delivery commits the exact bytes the in-order one
        does, and the dedupe cache makes redelivery of any answer (or of
        the fused round) idempotent. An ``abstain`` leaves its slot open.
        Injectable at the ``oracle_answer`` fault site (``oracle_poison``
        corrupts the label to the adversarial family, ``oracle_abstain``
        converts the answer into an abstention)."""
        self._check_hold(sid)
        sess = self._resolve_pinned(sid)
        to_dispatch = None
        round_idx = 0
        try:
            self._check_epoch(sess, epoch)
            if sess.restoring:
                raise BucketQuarantined(
                    f"session {sid} is being restored; retry shortly")
            if not sess.last:
                raise UnknownSession(sid)
            q = sess.bucket.acq_batch
            slot = int(slot)
            if not 0 <= slot < q:
                raise ValueError(
                    f"slot {slot} out of range [0, {q}) for session {sid}")
            fired = (self.faults.fire("oracle_answer", task=sess.task)
                     if self.faults is not None else [])
            if "oracle_abstain" in fired:
                abstain = True
            if not abstain:
                if label is None:
                    raise ValueError(
                        "missing 'label' (or set 'abstain': true)")
                label = int(label)
                if "oracle_poison" in fired:
                    label = (label + 1) % sess.bucket.n_classes
                    self.metrics.record_oracle("poisoned")
                if not 0 <= label < sess.bucket.n_classes:
                    raise ValueError(f"label {label} out of range "
                                     f"[0, {sess.bucket.n_classes})")
            round_idx = sess.n_labeled // q
            park_row = None
            with self.store.lock:
                if request_id is not None:
                    done = sess.recent.get(request_id)
                    if done is not None:
                        # the round this answer was part of has already
                        # committed — answer from the cached result, never
                        # re-apply (redelivery of a deferred answer)
                        out = self._payload(sess, dict(done))
                        out.update({"verb": "committed", "slot": slot,
                                    "duplicate": True})
                        return out
                missing = [j for j in range(q) if j not in sess.parked]
                if abstain:
                    self.metrics.record_oracle("abstain")
                    return {"session": sid, "verb": "abstain",
                            "slot": slot, "round": round_idx,
                            "parked": q - len(missing), "missing": missing}
                entry = sess.parked.get(slot)
                if entry is not None:
                    if request_id is not None and \
                            entry.get("request_id") == request_id:
                        return {"session": sid, "verb": "parked",
                                "slot": slot, "round": round_idx,
                                "duplicate": True,
                                "parked": q - len(missing),
                                "missing": missing}
                    self.metrics.record_oracle("double_apply_reject")
                    raise ValueError(
                        f"session {sid} round {round_idx} slot {slot} "
                        "already has a parked answer (duplicate delivery "
                        "refused)")
                # reorder depth: how many LATER slots arrived before this
                # one — the loadgen's deferred-delivery evidence
                depth = sum(1 for j in sess.parked if j > slot)
                seq = sess.park_seq
                sess.park_seq += 1
                sess.parked[slot] = {"label": label,
                                     "request_id": request_id, "seq": seq}
                self.metrics.record_oracle("parked", depth=depth)
                park_row = {"kind": "answer_park", "session": sid,
                            "round": round_idx, "slot": slot,
                            "label": label, "request_id": request_id,
                            "seq": seq}
                if len(sess.parked) == q:
                    to_dispatch = dict(sess.parked)
                    sess.parked = {}
            # stream the park OUTSIDE the store lock (disk write): the
            # row carries its slot + seq, so concurrent parks interleaving
            # in the file restore identically regardless of write order
            self.recorder.append(sid, park_row)
            if to_dispatch is None:
                with self.store.lock:
                    missing = [j for j in range(q) if j not in sess.parked]
                return {"session": sid, "verb": "parked", "slot": slot,
                        "round": round_idx, "parked": q - len(missing),
                        "missing": missing}
        finally:
            self.store.unpin(sess)
        # all q slots filled: drain through ONE fused dispatch in SLOT
        # order under a deterministic synthetic request_id — delivery
        # order is now immaterial, and a crashed/retried drain dedupes
        q = sess.bucket.acq_batch
        ordered = [to_dispatch[j]["label"] for j in range(q)]
        rid = f"answer:{sid}:{round_idx}"
        try:
            payload = self.label(sid, ordered if q > 1 else ordered[0],
                                 request_id=rid, epoch=epoch,
                                 trace_ctx=trace)
        except BaseException:
            # failed drain: re-park so the answers survive for a retry
            # (the park rows are still in the stream; nothing is lost)
            with self.store.lock:
                for j, e in to_dispatch.items():
                    sess.parked.setdefault(j, e)
            raise
        self.metrics.record_oracle("round_completed")
        with self.store.lock:
            done = sess.recent.get(rid)
            if done is not None:
                # every per-answer request_id now answers from the
                # committed round — late redelivery reads, never re-applies
                for e in to_dispatch.values():
                    if e.get("request_id"):
                        sess.recent[e["request_id"]] = done
        payload = dict(payload)
        payload.update({"verb": "dispatched", "slot": slot,
                        "round": round_idx, "applied": ordered})
        return payload

    async def answer_async(self, sid: str, slot, label=None,
                           request_id: Optional[str] = None,
                           epoch: Optional[int] = None,
                           abstain: bool = False, trace_ctx=None) -> dict:
        # parking is host-dict work but the drain dispatch blocks on the
        # batcher — always off the event loop (like the wake-through path)
        loop = asyncio.get_running_loop()
        return await loop.run_in_executor(
            self._executor,
            lambda: self.answer(sid, slot, label=label,
                                request_id=request_id, epoch=epoch,
                                abstain=abstain, trace_ctx=trace_ctx))

    def best(self, sid: str, epoch: Optional[int] = None,
             trace_ctx=None) -> dict:
        my = self._trace_child(trace_ctx)
        with self._serve_span("best", my):
            return self._best_impl(sid, epoch=epoch)

    def _best_impl(self, sid: str, epoch: Optional[int] = None) -> dict:
        self._check_hold(sid)
        sess = self._resolve_pinned(sid)  # wakes a parked session
        try:
            self._check_epoch(sess, epoch)
            if sess.restoring:
                # the slot holds a partially-replayed posterior and
                # n_labeled is still 0 — answering now would serve a wrong
                # best-model estimate with a 200; same retryable contract
                # as label
                raise BucketQuarantined(
                    f"session {sid} is being restored; retry shortly")
            out = self._payload(sess, sess.last or None)
            with sess.bucket.lock:
                pbest = sess.bucket.pbest(sess.slot)
            if pbest is not None:
                out["pbest"] = pbest.tolist()
            return out
        finally:
            self.store.unpin(sess)

    def close_session(self, sid: str, epoch: Optional[int] = None) -> dict:
        # a close landing in the migration-hold window would discard the
        # copy whose export is already in the router's hands — and the
        # import would then resurrect the "closed" session on the
        # destination. Retryable: the retry lands post-commit on the new
        # owner (and closes it there) or post-abort back here.
        self._check_hold(sid)
        try:
            sess = self.store.get(sid)
            self._check_epoch(sess, epoch)
            restoring = sess.restoring
        except UnknownSession:
            # a parked session closes without waking: drop the payload /
            # hibernate file and seal the stream (close marker)
            if self.tiers is not None and self.tiers.discard(sid):
                self.recorder.seal(sid)
                self.metrics.record_session("close")
                return {"closed": sid}
            raise
        if restoring:
            # freeing the slot mid-replay would let a new admission take
            # it while the restore keeps dispatching recorded rounds into
            # it — corrupting whichever session lands there
            raise BucketQuarantined(
                f"session {sid} is being restored; retry shortly")
        if self.prior_pool is not None and not sess.parked:
            # harvest the fit before the slot is freed (a parked session
            # already contributed at demotion)
            try:
                self.contribute_prior(sess, sess.bucket.slot_fit(sess.slot))
            except Exception:
                pass  # a close must never fail on pool bookkeeping
        if self.quality is not None and not sess.parked \
                and self.quality.should_audit(sid):
            # shadow audit: capture the stream and the session's seeding
            # facts BEFORE close tears them down; the replay itself runs
            # on the audit worker thread against a scratch slot
            try:
                rows = self.recorder.history(sid)
                if rows:
                    self.quality.maybe_enqueue_audit(
                        sess.bucket, sid, sess.seed, rows,
                        prior=sess.prior_fit, task=sess.task)
            except Exception:
                pass  # a close must never fail on audit bookkeeping
        self.store.close(sid)
        self.recorder.close(sid)
        if self.tiers is not None:
            self.tiers.discard(sid)  # clear any stale cold-index entry
        self.metrics.record_session("close")
        return {"closed": sid}

    def trace(self, sid: str, epoch: Optional[int] = None) -> dict:
        """The session's per-round decision history from its record stream
        (the flight recorder's interactive face: every dispatch this
        session rode, with the proposed item, best-model answer, and the
        label that was applied)."""
        self._check_hold(sid)
        sess = self._resolve_pinned(sid)  # wakes a parked session
        try:
            self._check_epoch(sess, epoch)
            if sess.restoring:
                # import_history lands only after the replay verifies; a
                # trace served now would be empty/partial, not the
                # session's history
                raise BucketQuarantined(
                    f"session {sid} is being restored; retry shortly")
            rounds = self.recorder.history(sid) or []
            return {"session": sid, "task": sess.task,
                    "n_labeled": sess.n_labeled, "rounds": rounds}
        finally:
            self.store.unpin(sess)

    def export_session(self, sid: str, close: bool = False,
                       hold: bool = False, raw: bool = False) -> dict:
        """The migration verb behind ``POST /session/{id}/export``: a
        self-contained payload (recorder stream + fingerprint-guarded
        carries snapshot) any same-task server can import. ``close`` frees
        the slot once the payload is built — the drain handoff.
        ``hold`` runs the fleet's PREPARE protocol instead (quiesce,
        hold, export-without-close — see :meth:`begin_migration`); the
        router commits or aborts through ``POST /session/{id}/fence``.

        A PARKED session exports without waking — its warm/cold payload
        IS the export (a demotion is an export minus the HTTP hop). The
        export pin means a demotion either completed before this verb
        (payload served from the tier) or cleanly aborts against it —
        the client always gets a consistent snapshot.

        ``raw`` keeps the payload's arrays as host arrays (the same keys,
        no base64): the in-process form, which ``import_session`` takes
        as it takes the JSON one; the HTTP route sends the JSON form."""
        if hold:
            return self.begin_migration(sid)
        if close:
            # a closing export is a drain handoff: like close_session it
            # must wait out a migration hold, not race it
            self._check_hold(sid)
        from coda_tpu_torch.serve import recovery
        from coda_tpu_torch.serve.recovery import _counter

        try:
            sess = self.store.get_pinned(sid)
        except UnknownSession:
            payload = (self.tiers.parked_payload(sid, materialized=not raw)
                       if self.tiers is not None else None)
            if payload is None:
                raise
            if close:
                self.tiers.discard(sid)
                self.recorder.seal(sid)
                self.metrics.record_session("close")
            self.metrics.record_recovery("exported")
            _counter("serve_sessions_exported_total",
                     "Sessions serialized for checkpoint/migration").inc()
            return payload
        try:
            payload = recovery.export_session(self, sid, raw=raw)
        finally:
            self.store.unpin(sess)
        if close:
            self.close_session(sid)
        return payload

    def import_body_cap(self) -> int:
        """The largest body ``POST /session/import`` reads: the
        reference's 1 MiB for the payload's rows and fields, plus the
        base64 of one slot's carries in the largest of this server's
        buckets (2.7 GB at the headline). Builds every registered task's
        bucket, as an import into it would."""
        most = max((self.store._bucket_for(t, self.spec).carry_nbytes()
                    for t in self.store.tasks()), default=0)
        return _MAX_BODY_BYTES + 4 * -(-most // 3)

    def import_session(self, payload: dict) -> dict:
        """The restore verb behind ``POST /session/import``: admit the
        exported session under its ORIGINAL id (the client's handle
        survives the migration), restore its posterior via the
        digest-verified snapshot fast path or bitwise stream replay, and
        answer like a normal session verb."""
        from coda_tpu_torch.serve import recovery

        if self.draining:
            self.metrics.record_session("reject")
            raise Draining()
        try:
            try:
                info = recovery.import_session(self, payload)
            except SlabFull:
                # tiering admission: an import past slab capacity demotes
                # the coldest resident session instead of 503
                if self.tiers is None or not self.tiers.make_room_for(
                        payload.get("task"), self.spec):
                    raise
                info = recovery.import_session(self, payload)
        except BaseException:
            # a restore replay dispatch that consumed donated carries
            # quarantines its bucket WITHOUT passing through the batcher's
            # failure hook (imports never ride a tick) — kick the heal
            # here so retried imports find a rebuilt slab, not a 503 loop
            self._heal_quarantined()
            raise
        sess = self.store.get(info["session"])
        out = self._payload(sess, sess.last or None)
        out.update(restored_via=info["restored_via"],
                   rounds=info["rounds"])
        return out

    def restore_sessions(self, record_dir: Optional[str] = None) -> dict:
        """Rebuild every un-closed session stream in ``record_dir`` (the
        crash-restart path; ``--restore`` runs it at startup)."""
        from coda_tpu_torch.serve import recovery

        report = recovery.restore_app_sessions(self, record_dir)
        self._heal_quarantined()  # a failed restore replay must not leave
        return report             # a bucket 503-refused with no heal queued

    def _heal_quarantined(self) -> None:
        for b in self.store.buckets():
            if b.quarantined is not None:
                self.healer.schedule(b)

    def list_sessions(self) -> dict:
        """Every addressable session id across all tiers (the fleet
        router's rebalance worklist — ``GET /sessions``). Set-deduped:
        this runs per replica per topology change at 100k+-session
        scale."""
        with self.store.lock:
            sids = list(self.store._sessions)
        if self.tiers is not None:
            seen = set(sids)
            sids += [s for s in self.tiers.parked_sids()
                     if s not in seen]
        return {"sessions": sids}

    def healthz(self) -> dict:
        """Three-state readiness: ``unready`` (warm pool not ready),
        ``degraded`` (serving, but a bucket is failed/quarantined/lazy,
        the warm-up failed or a stream fell back to memory), ``ok``."""
        ready = self.ready.is_set()
        buckets = self.store.buckets()
        problems = []
        if self.warm_error:
            problems.append("warmup_failed")
        if any(b.failed is not None for b in buckets):
            problems.append("buckets_failed")
        if any(b.quarantined is not None for b in buckets):
            problems.append("buckets_quarantined")
        if self._warm_requested and any(not b.is_warm for b in buckets):
            problems.append("buckets_lazy")
        if getattr(self.recorder, "degraded_streams", 0):
            problems.append("recorder_degraded")
        status = ("unready" if not ready
                  else "degraded" if problems else "ok")
        return {"ok": ready and not self.draining, "ready": ready,
                "draining": self.draining, "status": status,
                "problems": problems}

    # -- cross-session surrogate prior (serve/priors.py) -------------------
    def contribute_prior(self, sess, fit_stats) -> bool:
        """Fold one session's fit statistics into the pool (at close or
        demotion; exactly once per session). A SEEDED session's inherited
        pool mass is subtracted first — the per-refold decay is linear,
        so what is left of the seed after ``fits`` refolds is exactly
        ``SURROGATE_FIT_DECAY ** fits`` of it; without the subtraction
        every generation would re-contribute its ancestors' statistics
        and the pool would amplify instead of track."""
        if self.prior_pool is None or fit_stats is None \
                or sess.prior_contributed:
            return False
        import numpy as np

        from coda_tpu_torch.selectors.surrogate import (SURROGATE_FIT_DECAY,
                                                  prior_from_dict)
        from coda_tpu_torch.serve.priors import bucket_pool_key

        if sess.prior_fit is not None:
            g = SURROGATE_FIT_DECAY ** float(
                np.asarray(fit_stats.get("fits", 0)))
            seed = prior_from_dict(sess.prior_fit)
            fit_stats = {
                "A": np.asarray(fit_stats["A"], np.float64) - g * seed.A,
                "b": np.asarray(fit_stats["b"], np.float64) - g * seed.b,
                "n": max(0.0, float(fit_stats["n"]) - g * seed.n),
                "rounds": fit_stats["rounds"],
            }
        ok = self.prior_pool.contribute(
            bucket_pool_key(self, sess.bucket), fit_stats)
        if ok:
            sess.prior_contributed = True
            self.refresh_bucket_priors()
        return ok

    def refresh_bucket_priors(self) -> int:
        """Re-resolve each bucket's admission prior from the pool (after
        a contribution, a router pool push, or a restart restore)."""
        if self.prior_pool is None:
            return 0
        from coda_tpu_torch.serve.priors import bucket_pool_key

        n = 0
        for b in self.store.buckets():
            stats = self.prior_pool.get(bucket_pool_key(self, b))
            if b.set_prior(stats) is not None:
                n += 1
        return n

    def _prior_totals(self) -> dict:
        """ServeMetrics snapshot provider for the prior evidence triple
        (+ pool gauges): contributions accepted into the pool, warmup
        rounds the pool credited to live sessions (slab-read), and gate
        rejections that fired inside a credited warmup window."""
        if self.prior_pool is None:
            return {}
        per = getattr(self, "_surrogate_per", None)
        if per is None:
            per = {}
            for b in self.store.buckets():
                s = b.surrogate_stats()
                if s is not None:
                    per[id(b)] = s
        pool = self.prior_pool.stats()
        return {
            "prior_sessions_contributed": pool["sessions_contributed"],
            "prior_warmup_rounds_skipped": sum(
                s.get("prior_rounds", 0) for s in per.values()),
            "prior_gate_rejections": sum(
                s.get("prior_rejects", 0) for s in per.values()),
            "prior_pools": pool["pools"],
            "prior_rounds_pooled": pool["rounds_pooled"],
            # staleness: the age of the least recently refreshed
            # pool (None until the first contribution lands) + per-pool
            # contribution ages — /metrics renders both
            "prior_pool_staleness_seconds": pool["staleness_seconds"],
            "prior_pool_ages_seconds": pool["pool_ages_seconds"],
        }

    def sync_prior(self, pool_snap: Optional[dict] = None) -> dict:
        """The router exchange verb (``POST /prior/sync``, piggybacked on
        the health poll): drain this replica's since-last-poll delta for
        the caller, adopt the router's merged pool when one is pushed,
        then re-fold the just-drained delta locally so this replica's own
        recent contributions stay live until the next push echoes them
        back (uncounted — contribute() already counted them)."""
        if self.prior_pool is None:
            return {"delta": {}}
        delta = self.prior_pool.drain_delta()
        if pool_snap:
            self.prior_pool.replace(pool_snap)
            if delta:
                self.prior_pool.merge_delta(delta, count=False)
            self.refresh_bucket_priors()
        return {"delta": delta}

    def save_prior_pool(self, tracking_store) -> Optional[str]:
        """Persist the pool into the tracking store (one stable named
        run, ``prior_pool.json`` artifact) — the restart-survival half."""
        if self.prior_pool is None:
            return None
        import json as _json

        with tracking_store.run("serve", "surrogate-prior-pool") as run:
            return run.log_artifact_bytes(
                "prior_pool.json",
                _json.dumps(self.prior_pool.snapshot()).encode())

    def load_prior_pool(self, tracking_store) -> int:
        """Adopt the persisted pool (restart path); returns pools loaded."""
        if self.prior_pool is None:
            return 0
        import json as _json

        found = tracking_store.find_run("serve", "surrogate-prior-pool")
        if not found:
            return 0
        path = os.path.join(tracking_store.artifact_root, found[0],
                            "prior_pool.json")
        try:
            with open(path) as f:
                snap = _json.load(f)
        except (OSError, ValueError):
            return 0
        n = self.prior_pool.replace(snap)
        self.refresh_bucket_priors()
        return n

    def _surrogate_totals(self) -> dict:
        """Surrogate counters over every surrogate-scorer bucket (the
        ServeMetrics snapshot provider); {} when none runs the surrogate.
        Caches the per-bucket dicts on ``_surrogate_per`` for stats()."""
        per_bucket = {}
        for b in self.store.buckets():
            s = b.surrogate_stats()
            if s is not None:
                per_bucket[id(b)] = s
        self._surrogate_per = per_bucket
        per = list(per_bucket.values())
        if not per:
            return {}
        margins = [s["contract_margin"] for s in per
                   if s["contract_margin"] is not None]
        return {
            "surrogate_rounds": sum(s["rounds"] for s in per),
            "surrogate_fallbacks": sum(s["fallbacks"] for s in per),
            "surrogate_fit_refreshes": sum(s["fit_refreshes"]
                                           for s in per),
            "surrogate_contract_margin": (min(margins) if margins
                                          else None),
        }

    def stats(self) -> dict:
        # the tier occupancy FIRST, so the snapshot below carries current
        # gauges between sweeper passes
        if self.tiers is not None:
            tiers = self.tiers.counts()
            self.metrics.set_tier_occupancy(**tiers)
        else:
            tiers = {"hot": self.store.live_sessions(), "warm": 0,
                     "cold": 0}
            self.metrics.set_tier_occupancy(**tiers)
        snap = self.metrics.snapshot()
        # open sessions (every addressable one, all three tiers) against
        # the live slab slots
        snap["open_sessions"] = tiers["hot"] + tiers["warm"] + tiers["cold"]
        snap["slab_occupancy"] = self.store.slab_occupancy()
        snap["draining"] = self.draining
        snap["ready"] = self.ready.is_set()
        reg = self.telemetry.registry
        snap["records_written"] = int(
            reg.counter("records_written_total").value())
        snap["record_rows_written"] = int(self.recorder.rows_written)
        snap["replay_verified"] = int(
            reg.counter("replay_verified_total").value())
        snap["buckets"] = [
            {"task": b.task, "method": b.spec.method,
             "shape": list(b.shape), "capacity": b.capacity, "live": b.live,
             "step_impl": b.impl,
             "warm": b.is_warm, "warm_s": b.warm_s,
             "warm_hits": b.warm_hits, "warm_misses": b.warm_misses,
             "failed": b.failed, "quarantined": b.quarantined,
             "heals": b.heals, "cost": {},   # the reference's XLA costs
             "surrogate": getattr(self, "_surrogate_per", {}).get(id(b))}
            for b in self.store.buckets()
        ]
        if self.prior_pool is not None:
            snap["prior_pool"] = self.prior_pool.stats()
        if self.quality is not None:
            # fold THIS pass's live signals (surrogate gate pressure,
            # prior staleness-regret) into the drift detectors, then
            # re-read the plane so the snapshot reflects the fold
            self.quality.feed_serve_stats(snap["buckets"], snap)
            snap["quality"] = self.quality.snapshot()
        snap["warm_error"] = self.warm_error
        snap["recorder_degraded_streams"] = int(
            getattr(self.recorder, "degraded_streams", 0))
        snap["status"] = self.healthz()["status"]
        if self.faults is not None:
            snap["faults"] = self.faults.snapshot()
        return snap

    def quality_scorecard(self) -> Optional[dict]:
        """``GET /fleet/quality`` on one server: this plane's scorecard;
        None with ``--no-quality`` (the route 404s)."""
        if self.quality is None:
            return None
        return self.quality.scorecard()

    def _payload(self, sess, res: Optional[dict]) -> dict:
        out = {
            "session": sess.sid,
            "task": sess.task,
            "n_labeled": sess.n_labeled,
        }
        if res:
            out.update({
                "idx": res["next_idx"],
                "prob": res["next_prob"],
                "best": res["best"],
                "stochastic": res["stochastic"],
            })
        return out


class Draining(RuntimeError):
    """New sessions refused: the server is shutting down."""


class StaleItem(ValueError):
    """The labeled idx is not the item the session proposed."""


_SESSION_RE = re.compile(
    r"^/session/([0-9a-f]+)"
    r"(/(label|labels|answer|best|trace|export|fence|epoch))?$")

# GET /trace/id/{trace_id}: retained distributed-trace spans (distinct
# from GET /session/{id}/trace, the per-round DECISION history)
_TRACE_ID_RE = re.compile(r"^/trace/id/([0-9a-f]+)$")

_REASONS = {200: "OK", 400: "Bad Request", 404: "Not Found",
            409: "Conflict", 500: "Internal Server Error",
            501: "Not Implemented", 503: "Service Unavailable",
            504: "Gateway Timeout"}

_JSON = "application/json"
_PROM = "text/plain; version=0.0.4; charset=utf-8"

# idle keep-alive connections are reaped after this many seconds
_IDLE_TIMEOUT_S = 120.0

# request bodies are small JSON (a label, a seed); an import's may add the
# base64 of one slot's carries (ServeApp.import_body_cap)
_MAX_BODY_BYTES = 1 << 20
# a larger body is read this many bytes at a time into one array
_READ_PIECE = 1 << 20


async def _read_body(reader: asyncio.StreamReader, n: int):
    """``n`` bytes of a request body; past ``_READ_PIECE``, read a piece at
    a time into one array (a ``readexactly`` of the whole copies it twice,
    and a ``bytearray`` fills it with zeros, each holding the GIL on the
    event loop) and returned as a memoryview."""
    if n <= _READ_PIECE:
        return await reader.readexactly(n) if n > 0 else b""
    body = np.empty(n, np.uint8)
    for at in range(0, n, _READ_PIECE):
        piece = await reader.readexactly(min(_READ_PIECE, n - at))
        body[at:at + len(piece)] = np.frombuffer(piece, np.uint8)
    return memoryview(body)


class AsyncHTTPServer:
    """Asyncio front door with the stdlib server's surface.

    The listening socket binds at construction (``server_address`` is
    immediately readable, ``port=0`` picks a free port — the test hook);
    ``serve_forever()`` runs the event loop in the calling thread;
    ``shutdown()`` (any thread) stops it and blocks until it has;
    ``server_close()`` releases the socket.

    The protocol half is deliberately minimal HTTP/1.1 — request line,
    headers, Content-Length bodies, keep-alive — which is all the JSON API
    (and every stdlib/urllib client) needs, and keeps the no-new-deps
    stance of the rest of the stack.
    """

    def __init__(self, app: ServeApp, port: int = 0,
                 host: str = "127.0.0.1"):
        self.app = app
        self._sock = socket.create_server((host, port), backlog=512)
        self.server_address = self._sock.getsockname()
        self._loop: Optional[asyncio.AbstractEventLoop] = None
        self._stop: Optional[asyncio.Event] = None
        self._started = threading.Event()
        self._finished = threading.Event()
        self._closed = False

    # -- lifecycle ---------------------------------------------------------
    def serve_forever(self) -> None:
        asyncio.run(self._main())

    async def _main(self) -> None:
        self._loop = asyncio.get_running_loop()
        self._stop = asyncio.Event()
        server = await asyncio.start_server(self._serve_conn,
                                            sock=self._sock)
        self._started.set()
        try:
            await self._stop.wait()
        finally:
            server.close()
            try:
                await server.wait_closed()
            except Exception:
                pass
            self._closed = True
            self._finished.set()

    def shutdown(self) -> None:
        loop, stop = self._loop, self._stop
        if loop is not None and stop is not None and loop.is_running():
            loop.call_soon_threadsafe(stop.set)
            self._finished.wait(timeout=30.0)

    def stop_soon(self) -> None:
        """Ask the loop to stop without waiting (safe in a signal
        handler running on the loop's own thread)."""
        loop, stop = self._loop, self._stop
        if loop is not None and stop is not None:
            loop.call_soon_threadsafe(stop.set)

    def server_close(self) -> None:
        if not self._closed:
            try:
                self._sock.close()
            except OSError:
                pass
            self._closed = True

    # -- one connection ----------------------------------------------------
    async def _serve_conn(self, reader: asyncio.StreamReader,
                          writer: asyncio.StreamWriter) -> None:
        try:
            while True:
                try:
                    line = await asyncio.wait_for(reader.readline(),
                                                  _IDLE_TIMEOUT_S)
                except asyncio.TimeoutError:
                    break
                if not line or line in (b"\r\n", b"\n"):
                    break
                parts = line.decode("latin1").split()
                if len(parts) != 3:
                    break
                method, target, version = parts
                headers = {}
                while True:
                    h = await reader.readline()
                    if not h or h in (b"\r\n", b"\n"):
                        break
                    k, _, v = h.decode("latin1").partition(":")
                    headers[k.strip().lower()] = v.strip()
                try:
                    n = int(headers.get("content-length") or 0)
                except ValueError:
                    n = -1
                cap = _MAX_BODY_BYTES
                if n > cap and target.partition("?")[0] == "/session/import":
                    cap = await asyncio.get_running_loop().run_in_executor(
                        self.app._executor, self.app.import_body_cap)
                if 0 <= n <= cap:
                    body = await _read_body(reader, n)
                    status, payload, ctype = await self._handle(
                        method, target, body, headers)
                else:
                    # malformed or oversized Content-Length: answer a JSON
                    # error (never a dropped connection) and close — the
                    # unread body makes the stream unusable for keep-alive
                    headers["connection"] = "close"
                    status, payload, ctype = (
                        400, {"error": "bad request: invalid or oversized "
                                       "Content-Length"}, _JSON)
                data = (payload if isinstance(payload, memoryview)
                        else payload.encode() if isinstance(payload, str)
                        else json.dumps(payload).encode())
                keep = (version == "HTTP/1.1"
                        and headers.get("connection", "").lower() != "close")
                head = (f"HTTP/1.1 {status} {_REASONS.get(status, 'OK')}\r\n"
                        f"Content-Type: {ctype}\r\n"
                        f"Content-Length: {len(data)}\r\n"
                        "Connection: "
                        f"{'keep-alive' if keep else 'close'}\r\n\r\n")
                if isinstance(data, memoryview):
                    writer.write(head.encode("latin1"))  # no copy of a
                    writer.write(data)                   # large body
                else:
                    writer.write(head.encode("latin1") + data)
                await writer.drain()
                if not keep:
                    break
        except (ConnectionError, asyncio.IncompleteReadError):
            pass  # client went away mid-request; nothing to answer
        finally:
            try:
                writer.close()
                await writer.wait_closed()
            except Exception:
                pass

    # -- routing (same error envelope as the session verbs raise) ----------
    async def _handle(self, method: str, target: str, body: bytes,
                      headers: Optional[dict] = None):
        app = self.app
        path, _, query = target.partition("?")
        params = {}
        for kv in filter(None, query.split("&")):
            k, _, v = kv.partition("=")
            params[k] = v
        # trace context: continue the caller's (`coda-trace` header), or
        # mint fresh at this front door for session verbs so every label
        # decision has ONE causal trace even from untraced clients. Never
        # touches session state — purely observational.
        trace_ctx = None
        if getattr(app, "tracing", False):
            from coda_tpu_torch.telemetry.trace import (TRACE_HEADER, mint,
                                                       parse)

            trace_ctx = parse((headers or {}).get(TRACE_HEADER, ""))
            if trace_ctx is None and path.startswith("/session"):
                trace_ctx = mint()
        if method == "GET" and path == "/healthz":
            # the readiness gate: 503 until the warm pool is ready, so a
            # starting replica takes no traffic while its kernels build
            # and its caches fill. Draining stays 200 — the
            # process is live and still answering existing sessions.
            h = app.healthz()
            return (200 if h["ready"] else 503), h, _JSON
        if method == "GET" and path == "/metrics":
            # Prometheus text exposition, not JSON: registry counters
            # (kernel builds and loads, device memory) + the serve
            # snapshot (dispatches, occupancy, queue depth, latency
            # quantiles, warm pool). Same error envelope as every other
            # route: a render failure must answer a JSON 500, never drop
            # the connection.
            try:
                from coda_tpu_torch.telemetry import render_prometheus

                def render():
                    return render_prometheus(app.telemetry.registry,
                                             serve_metrics=app.metrics)
                text = await asyncio.get_running_loop().run_in_executor(
                    None, render)
            except Exception as e:
                return 500, {"error": f"internal: {e}"}, _JSON
            return 200, text, _PROM
        try:
            out = await self._route(method, path, body, params,
                                    trace_ctx=trace_ctx)
        except Draining:
            return (503, {"error": "draining: not admitting new sessions"},
                    _JSON)
        except SlabFull as e:
            return 503, {"error": f"busy: {e}"}, _JSON
        except BucketQuarantined as e:
            # the slab is being rebuilt from session streams — transient,
            # retryable: 503 like every other backpressure signal
            return 503, {"error": f"healing: {e}"}, _JSON
        except StaleOwner as e:
            # the fencing rejection: this replica's copy is stale — the
            # router re-locates on this envelope; a direct client should
            # re-resolve the fleet front door
            app.metrics.record_session("request_reject")
            return 409, {"error": f"stale owner: {e}"}, _JSON
        except ImportRejected as e:
            return 409, {"error": f"import rejected: {e}"}, _JSON
        except UnknownSession as e:
            app.metrics.record_session("request_reject")
            return 404, {"error": f"unknown session {e}"}, _JSON
        except StaleItem as e:
            app.metrics.record_session("request_reject")
            return 409, {"error": str(e)}, _JSON
        except TimeoutError as e:
            return 504, {"error": str(e)}, _JSON
        except NotImplementedError as e:
            # a verb of a later slice of the port
            return 501, {"error": f"not implemented: {e}"}, _JSON
        except (ValueError, TypeError, KeyError) as e:
            return 400, {"error": f"bad request: {e}"}, _JSON
        except Exception as e:  # cancelled tickets, dispatch failures: the
            # client must get a JSON error, never a dropped connection
            return 500, {"error": f"internal: {e}"}, _JSON
        if out is None:
            return 404, {"error": "not found"}, _JSON
        return 200, out, _JSON

    async def _route(self, method: str, path: str, raw: bytes,
                     params: Optional[dict] = None, trace_ctx=None):
        app = self.app
        loop = asyncio.get_running_loop()
        m = _SESSION_RE.match(path)

        def _epoch(req=None):
            # the router's fencing stamp: body field on POST/DELETE,
            # ?epoch=N on GETs
            v = (req or {}).get("epoch")
            if v is None:
                v = (params or {}).get("epoch")
            return None if v in (None, "") else int(v)

        if method == "POST" and path == "/session/import":
            # restore an exported session (the parse, and the replay or
            # snapshot verification, never on the event loop)
            from coda_tpu_torch.serve.recovery import payload_from_json

            return await loop.run_in_executor(
                app._executor,
                lambda: app.import_session(payload_from_json(raw)))
        if method == "POST" and path == "/session":
            req = json.loads(raw or b"{}")
            kw = {}
            if req.get("session") is not None:
                kw["sid"] = str(req["session"])
            return await app.open_session_async(task=req.get("task"),
                                                seed=req.get("seed"),
                                                trace_ctx=trace_ctx, **kw)
        if m and method == "POST" and m.group(3) == "label":
            req = json.loads(raw or b"{}")
            if "label" not in req:
                raise ValueError("missing 'label'")
            return await app.label_async(m.group(1), req["label"],
                                         idx=req.get("idx"),
                                         request_id=req.get("request_id"),
                                         epoch=_epoch(req),
                                         trace_ctx=trace_ctx)
        if m and method == "POST" and m.group(3) == "labels":
            # the q answers of a round, one dispatch (ServeApp.labels)
            req = json.loads(raw or b"{}")
            if not isinstance(req.get("labels"), list) or not req["labels"]:
                raise ValueError("missing non-empty 'labels' list")
            return await app.labels_async(m.group(1), req["labels"],
                                          idx=req.get("idx"),
                                          request_id=req.get("request_id"),
                                          epoch=_epoch(req),
                                          trace_ctx=trace_ctx)
        if m and method == "POST" and m.group(3) == "answer":
            # one per-slot crowd answer, any order (see ServeApp.answer)
            req = json.loads(raw or b"{}")
            if "slot" not in req:
                raise ValueError("missing 'slot'")
            if "label" not in req and not req.get("abstain"):
                raise ValueError("missing 'label' (or 'abstain': true)")
            return await app.answer_async(m.group(1), req["slot"],
                                          label=req.get("label"),
                                          request_id=req.get("request_id"),
                                          epoch=_epoch(req),
                                          abstain=bool(req.get("abstain")),
                                          trace_ctx=trace_ctx)
        if m and method == "POST" and m.group(3) == "export":
            # the body encoded off the event loop and the GIL
            from coda_tpu_torch.serve.recovery import payload_to_json

            req = json.loads(raw or b"{}")
            return await loop.run_in_executor(
                app._executor,
                lambda: payload_to_json(app.export_session(
                    m.group(1), close=bool(req.get("close")),
                    hold=bool(req.get("hold")), raw=True)))
        if m and method == "POST" and m.group(3) == "fence":
            # the migration commit/abort half of the fleet's hold protocol
            req = json.loads(raw or b"{}")
            return await loop.run_in_executor(
                app._executor,
                lambda: app.end_migration(m.group(1),
                                          drop=bool(req.get("drop"))))
        if m and method == "GET" and m.group(3) == "epoch":
            return await loop.run_in_executor(
                app._executor, app.session_epoch, m.group(1))
        if m and method == "GET" and m.group(3) == "best":
            return await loop.run_in_executor(
                app._executor,
                lambda: app.best(m.group(1), epoch=_epoch(),
                                 trace_ctx=trace_ctx))
        if m and method == "GET" and m.group(3) == "trace":
            return await loop.run_in_executor(
                app._executor,
                lambda: app.trace(m.group(1), epoch=_epoch()))
        if m and method == "DELETE" and m.group(3) is None:
            req = json.loads(raw or b"{}")
            return await loop.run_in_executor(
                app._executor,
                lambda: app.close_session(m.group(1), epoch=_epoch(req)))
        if method == "POST" and path == "/prior/sync":
            # the pool-exchange half of a router's health poll
            req = json.loads(raw or b"{}")
            return await loop.run_in_executor(
                app._executor, lambda: app.sync_prior(req.get("pool")))
        if method == "GET" and path == "/stats":
            return await loop.run_in_executor(app._executor, app.stats)
        if method == "GET" and path == "/sessions":
            return await loop.run_in_executor(app._executor,
                                              app.list_sessions)
        tm = _TRACE_ID_RE.match(path)
        if tm and method == "GET":
            return await loop.run_in_executor(
                app._executor, app.trace_by_id, tm.group(1))
        if method == "GET" and path == "/fleet/quality":
            # the decision-quality scorecard of this server's plane
            scorecard = getattr(app, "quality_scorecard", None)
            if scorecard is not None:
                return await loop.run_in_executor(app._executor, scorecard)
        return None


def make_server(app: ServeApp, port: int = 0,
                host: str = "127.0.0.1") -> AsyncHTTPServer:
    """Bind the front door; ``port=0`` picks a free port (for tests)."""
    return AsyncHTTPServer(app, port=port, host=host)


def parse_args(argv=None):
    p = argparse.ArgumentParser(
        description="batched multi-session serving of interactive active "
                    "model selection on the card (PyTorch/CUDA)")
    p.add_argument("--task", default=None)
    p.add_argument("--data-dir", default="data")
    p.add_argument("--synthetic", default=None, metavar="H,N,C",
                   help="serve a seeded synthetic task of this shape")
    p.add_argument("--method", default="coda",
                   help="selector behind every session "
                        "{coda, iid, uncertainty, model_picker, ...}")
    p.add_argument("--acq-batch", type=int, default=1, metavar="Q",
                   help="labels per round per session (default 1). Q > 1 "
                        "sessions propose Q items per round and accept "
                        "all Q oracle answers through ONE "
                        "POST /session/{id}/labels dispatch (fused "
                        "multi-row posterior update) — the serving face "
                        "of --acq-batch")
    p.add_argument("--eig-scorer", default="exact",
                   metavar="exact|surrogate:k",
                   help="coda methods only: the scoring rung every "
                        "session's bucket compiles (the serving face of "
                        "the main CLI's --eig-scorer) — surrogate:k "
                        "amortizes the per-round scoring pass behind the "
                        "measured contract; surrogate counters surface "
                        "on /stats and /metrics (its buckets run the 'map' "
                        "lowering)")
    p.add_argument("--surrogate-prior", default="off",
                   choices=["off", "pool"],
                   help="coda + surrogate scorer only: warm-start every "
                        "session's surrogate fit from the cross-session "
                        "prior pool (serve/priors.py) — closed/demoted "
                        "sessions contribute their fit statistics, new "
                        "admissions seed from the merged pool; the "
                        "per-round trust gate is unchanged. 'off' "
                        "(default) seeds nothing. With --tracking-db the "
                        "pool survives restarts")
    p.add_argument("--capacity", type=int, default=64,
                   help="slab slots per bucket = max HOT (resident) "
                        "sessions per (task, config); admission past it "
                        "demotes the coldest session to the warm tier "
                        "(503 only with --no-tiering or when nothing is "
                        "demotable). Every slot is allocated at start: an "
                        "incremental "
                        "CODA slot holds a (C, N, H) cache (2.0 GB fp32 "
                        "at (1000, 50000, 10)), so size it from device "
                        "memory")
    p.add_argument("--no-tiering", action="store_true",
                   help="disable hot/warm/cold session paging: sessions "
                        "exist only while they hold a slab slot and "
                        "admission past capacity answers 503")
    p.add_argument("--tier-spill-dir", default=None,
                   help="enable the COLD tier: idle warm payloads "
                        "hibernate to the spill store here (serve/spill.py; "
                        "scanned at startup, so cold sessions survive "
                        "restarts); without it paging is warm-only")
    p.add_argument("--idle-warm-s", type=float, default=30.0,
                   help="demote a hot session to the warm tier after this "
                        "many seconds without a request")
    p.add_argument("--idle-cold-s", type=float, default=120.0,
                   help="hibernate a warm session to the cold tier after "
                        "this many further idle seconds (needs "
                        "--tier-spill-dir)")
    p.add_argument("--max-warm", type=int, default=8192,
                   help="bound on host-RAM warm payloads; LRU overflow "
                        "hibernates to the cold tier (the RSS lever)")
    p.add_argument("--tier-free-frac", type=float, default=0.0,
                   help="sweeper keeps this fraction of each slab free by "
                        "demoting LRU-idle sessions ahead of admission "
                        "bursts (0 = demote only under admission "
                        "pressure)")
    p.add_argument("--bucket-n", type=int, default=1,
                   help="pad task N up to this quantum so near-shaped tasks "
                        "share one compiled program (1 = exact shapes)")
    p.add_argument("--max-batch", type=int, default=256,
                   help="max requests coalesced into one dispatch")
    p.add_argument("--max-wait-ms", type=float, default=2.0,
                   help="linger after the first queued request before "
                        "dispatching, when the batcher was IDLE at arrival "
                        "(after a busy tick the next starts immediately — "
                        "continuous batching)")
    p.add_argument("--max-linger-ms", type=float, default=None,
                   help="hard cap on one tick's total formation window "
                        "regardless of arrival pattern "
                        "(default 4x --max-wait-ms)")
    p.add_argument("--step-impl", default=None,
                   choices=["map", "batched", "vmap"],
                   help="slab-step lowering: 'map' runs the requested "
                        "slots one after another through the one-session "
                        "functions; 'batched' (also 'vmap') runs each run "
                        "of consecutive requested slots as one replica "
                        "batch (CODA's batched form: kernel 5); both are "
                        "bitwise the sequential session. Default: "
                        "coda_tpu_torch.serve.state.DEFAULT_IMPL")
    p.add_argument("--no-donate", action="store_true",
                   help="accepted for the reference's command lines; the "
                        "port's step writes the slab in place and has no "
                        "donation to turn off")
    p.add_argument("--no-warm", action="store_true",
                   help="skip the warm pool: the first dispatch per bucket "
                        "builds the kernels (readiness is immediate)")
    p.add_argument("--compilation-cache-dir", default=None,
                   help="the directory the CUDA kernels are built into "
                        "and loaded from (ops/build.py; default "
                        "coda_tpu_torch/_build): a restarted server loads "
                        "the libraries an earlier one built, with no nvcc")
    p.add_argument("--port", type=int, default=7861)
    p.add_argument("--device", default="cuda", choices=["cuda", "cpu"],
                   help="run on the card (default) or, for tests and "
                        "rehearsals, the CPU")
    p.add_argument("--tracking-db", default=None,
                   help="flush serving metrics into this MLflow-schema "
                        "sqlite DB on shutdown")
    p.add_argument("--telemetry-dir", default=None,
                   help="write trace.json (Perfetto spans: batcher ticks + "
                        "slab steps) + telemetry.json (kernel builds and "
                        "loads, device memory) + metrics.prom there on "
                        "shutdown; /metrics serves the same registry live "
                        "either way")
    p.add_argument("--record-dir", default=None,
                   help="stream each session's per-round decision history "
                        "to an append-only session_<id>.jsonl there "
                        "(crash-safe: every completed dispatch is flushed); "
                        "GET /session/{id}/trace serves the same stream "
                        "live either way")
    p.add_argument("--restore", action="store_true",
                   help="at startup, rebuild every un-closed session "
                        "stream found in --record-dir by bitwise replay "
                        "(the crash-restart path: a killed server "
                        "restarted with --restore resumes its sessions)")
    p.add_argument("--no-trace", action="store_true",
                   help="disable distributed tracing (trace-context "
                        "propagation, serve/tick/step trace spans, "
                        "latency exemplars, GET /trace/id/{trace_id}). "
                        "Tracing never perturbs session math — on and "
                        "off produce bitwise-identical trajectories — "
                        "so this is purely an overhead lever")
    p.add_argument("--no-quality", action="store_true",
                   help="disable the decision-quality plane "
                        "(telemetry/quality.py): streaming calibration of "
                        "the served posterior, drift detectors, and the "
                        "shadow auditor that bitwise-replays a sample of "
                        "closed sessions. The plane never perturbs "
                        "session math — on and off produce "
                        "bitwise-identical decision rows — so this is "
                        "purely an overhead lever")
    p.add_argument("--quality-audit-frac", type=float, default=0.25,
                   help="fraction of closing sessions the shadow auditor "
                        "re-replays (deterministic per-sid hash sample; "
                        "0 disables auditing but keeps calibration/drift)")
    p.add_argument("--slo-fast-s", type=float, default=300.0,
                   help="SLO watchtower fast burn-rate window (seconds); "
                        "fleet router only")
    p.add_argument("--slo-slow-s", type=float, default=3600.0,
                   help="SLO watchtower slow burn-rate window (seconds); "
                        "fleet router only")
    p.add_argument("--fault-spec", default=None, metavar="SPEC",
                   help="deterministic fault injection (serve/faults.py): "
                        "'name:param=v,...[;name:...]' with names "
                        "step_raise | step_nan | record_eio | slow_step | "
                        "crash_before_tick | crash_after_tick | "
                        "demote_during_label | oracle_poison | "
                        "oracle_abstain | stream_tamper (the fleet's come "
                        "with slice 9) and "
                        "triggers after=N / every=N / p=F,seed=S (e.g. "
                        "'step_raise:after=100') — exercises the recovery "
                        "paths under real traffic")
    return p.parse_args(argv)


def build_app(args) -> ServeApp:
    """ServeApp from parsed args."""
    from coda_tpu_torch.cli import load_dataset

    if getattr(args, "compilation_cache_dir", None):
        from coda_tpu_torch.ops import build

        build.set_build_dir(args.compilation_cache_dir)
    spec_kwargs = {}
    if args.method.startswith("coda"):
        # every slot carries its own state; the auto eig_mode budget must
        # see the whole slab (the reference's rule)
        spec_kwargs["n_parallel"] = args.capacity
        scorer = getattr(args, "eig_scorer", "exact")
        if scorer != "exact":
            spec_kwargs["eig_scorer"] = scorer
        prior_knob = getattr(args, "surrogate_prior", "off")
        if prior_knob and prior_knob != "off":
            spec_kwargs["surrogate_prior"] = prior_knob
    telemetry = None
    if getattr(args, "telemetry_dir", None):
        from coda_tpu_torch.telemetry import Telemetry

        telemetry = Telemetry(out_dir=args.telemetry_dir)
    recorder = None
    if getattr(args, "record_dir", None):
        from coda_tpu_torch.telemetry import SessionRecorder

        recorder = SessionRecorder(out_dir=args.record_dir)
    max_linger_ms = getattr(args, "max_linger_ms", None)
    app = ServeApp(
        capacity=args.capacity, bucket_n=args.bucket_n,
        max_batch=args.max_batch, max_wait=args.max_wait_ms / 1e3,
        max_linger=(None if max_linger_ms is None else max_linger_ms / 1e3),
        spec=SelectorSpec.create(args.method,
                                 acq_batch=getattr(args, "acq_batch", 1),
                                 **spec_kwargs),
        step_impl=getattr(args, "step_impl", None),
        donate=not getattr(args, "no_donate", False),
        telemetry=telemetry, recorder=recorder,
        fault_spec=getattr(args, "fault_spec", None),
        tiering=not getattr(args, "no_tiering", False),
        tier_spill_dir=getattr(args, "tier_spill_dir", None),
        idle_warm_s=getattr(args, "idle_warm_s", 30.0),
        idle_cold_s=getattr(args, "idle_cold_s", 120.0),
        max_warm=getattr(args, "max_warm", 8192),
        tier_free_fraction=getattr(args, "tier_free_frac", 0.0),
        tracing=not getattr(args, "no_trace", False),
        quality=not getattr(args, "no_quality", False),
        quality_audit_frac=getattr(args, "quality_audit_frac", 0.25),
        device=args.device,
    )
    if args.task or args.synthetic:
        ds = load_dataset(args)
        app.add_task(ds.name, ds.preds, class_names=ds.class_names)
    else:
        from coda_tpu_torch.data import make_synthetic_task

        task = make_synthetic_task(seed=0, H=8, N=512, C=10,
                                   device=args.device)
        app.add_task(task.name, task.preds)
    return app


def main(argv=None) -> int:
    import signal

    args = parse_args(argv)
    app = build_app(args)
    if app.prior_pool is not None and args.tracking_db:
        # adopt the persisted pool BEFORE any admission so the first
        # session of this process already warm-starts
        from coda_tpu_torch.tracking import TrackingStore

        _ts = TrackingStore(args.tracking_db)
        n = app.load_prior_pool(_ts)
        _ts.close()
        if n:
            print(f"surrogate prior pool restored: {n} pool(s) from "
                  f"{args.tracking_db}", flush=True)
    if args.restore and args.record_dir:
        # crash restore BEFORE taking traffic: rebuild every un-closed
        # session stream (bitwise replay-verified), then open the doors
        app.start(warm=not args.no_warm)
        report = app.restore_sessions(args.record_dir)
        print(f"restored {len(report['restored'])} session(s) from "
              f"{args.record_dir} "
              f"({report['skipped_closed']} closed, "
              f"{len(report['failed'])} failed"
              + (f": {report['failed']}" if report["failed"] else "") + ")",
              flush=True)
    else:
        # warm in the background so the socket binds at once and /healthz
        # gates traffic until the pool is ready
        app.start(warm=not args.no_warm, warm_async=True)
    srv = make_server(app, args.port)
    # SIGTERM drains like ^C: stop the loop, finish queued work, close
    # the streams, exit 0
    signal.signal(signal.SIGTERM, lambda *_: srv.stop_soon())
    print(f"serving {app.default_task!r} ({app.spec.method}) on "
          f"http://127.0.0.1:{srv.server_address[1]}/ — capacity "
          f"{app.store.capacity} sessions/bucket, device {app.device}"
          + ("" if args.no_warm else "; warming pool (healthz 503 until "
             "ready)"), flush=True)
    try:
        srv.serve_forever()
    except KeyboardInterrupt:
        print("\ndraining...", flush=True)
    finally:
        app.drain()
        srv.server_close()
        if args.telemetry_dir:
            paths = app.telemetry.write(
                extra={"serve": app.metrics.snapshot()})
            print(f"telemetry written to {paths.get('telemetry')}")
        if args.tracking_db:
            from coda_tpu_torch.tracking import TrackingStore

            store = TrackingStore(args.tracking_db)
            app.metrics.log_to_store(store, params={
                "method": app.spec.method,
                "capacity": app.store.capacity})
            if app.quality is not None:
                # the shutdown quality scorecard next to the metrics rows
                # (experiment serve_quality)
                app.quality.log_to_store(store, params={
                    "method": app.spec.method})
            if app.prior_pool is not None:
                app.save_prior_pool(store)  # the restart-survival half
            store.close()
            print(f"metrics logged to {args.tracking_db}")
    print("drained", flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
