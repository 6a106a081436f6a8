"""Continuous-batching dispatcher: many sessions' requests, one launch
(counterpart of ``coda_tpu/serve/batcher.py``).

The host half of the serving layer. Front-door workers (asyncio handlers or
in-process callers) submit one request per user action (session start,
oracle label) and wait on a ticket; a single batcher thread drains the
queue, forms a batch, groups by bucket, and executes ONE masked
slab step per bucket (:func:`coda_tpu_torch.serve.state.make_slab_step`).
Accelerator dispatch cost is thus amortized over every concurrent session
instead of paid per click.

Batch formation is **continuous**: a completed tick immediately starts
forming the next one from whatever queued while it ran — no fixed wait
gates a ready batch, and tickets arriving while a batch forms join it up
to ``max_batch``. Formation then lingers only while arrivals keep
flowing: each arrival refreshes a ``max_wait`` quiet-gap budget, so the
cohort the previous tick just answered can resubmit as a burst and ride
this tick instead of the next (the masked slab step costs the same at
any occupancy, so a few ms of pickup buys half the slab a whole tick of
latency), while a single idle request is dispatched ``max_wait`` after
it arrives. Total formation time is hard-capped by ``max_linger`` so
steady trickle arrival can never stretch a tick's formation window
indefinitely — the cap, not the gap, is the worst-case bound.

Two requests for the same slot never ride one tick (the second would read
the first's pre-update state); the collision is requeued for the next tick.
Closed-loop clients can't produce collisions (they wait for their reply),
so this path only guards misbehaving open-loop callers.

Tickets resolve exactly once (a lock arbitrates dispatch completion against
wait-timeout cancellation — the loser of the race is a no-op), and a
resolution wakes both the blocking ``wait()`` path and any asyncio waiter
registered by ``wait_async()`` (the front door's bridge from the batcher
thread into the event loop).
"""

from __future__ import annotations

import contextlib
import queue
import threading
import time
from dataclasses import dataclass, field
from typing import Optional


@dataclass
class Ticket:
    """One submitted request and its rendezvous.

    Resolution (result, error, or cancellation) happens EXACTLY once: the
    first of {dispatch completion, dispatch failure, cancel} wins under
    ``_lock`` and fires ``done`` plus any registered asyncio futures; later
    attempts return False and change nothing. This is what makes a
    wait-timeout racing an in-flight dispatch safe — the ticket is never
    double-completed, whichever side wins.
    """

    session: object                 # state.Session
    do_update: bool
    idx: int = 0
    label: int = 0
    prob: float = 0.0
    request_id: Optional[str] = None  # client idempotency token (labels)
    # trace context (telemetry.trace.TraceContext) of the request this
    # ticket carries, or None when untraced. Read ONLY by spans/metrics/
    # recorder rows — never by dispatch math (the non-perturbation
    # contract: tracing off and on take bitwise-identical trajectories).
    trace: Optional[object] = None
    submitted: float = field(default_factory=time.perf_counter)
    collected: float = 0.0          # when the batcher picked it into a batch
    done: threading.Event = field(default_factory=threading.Event)
    result: Optional[dict] = None
    error: Optional[BaseException] = None
    cancelled: bool = False
    # resolution hook: runs EXACTLY once, whoever resolves the ticket
    # (complete/fail/cancel), outside the ticket lock. The serving layer
    # hands a session's demotion pin to its ticket through this — the pin
    # is released the instant the ticket is resolved, never twice.
    on_resolve: Optional[object] = None
    _lock: threading.Lock = field(default_factory=threading.Lock)
    _async_waiters: list = field(default_factory=list)  # (loop, future)

    # -- resolution (exactly once) ----------------------------------------
    def _resolve_locked(self):
        """Caller holds ``_lock`` and has set result/error: mark done and
        hand back (waiters, hook) for POST-lock delivery — the hook takes
        other locks (the session store's, for the demotion pin), so it
        must never run inside the ticket lock."""
        self.done.set()
        waiters, self._async_waiters = self._async_waiters, []
        cb, self.on_resolve = self.on_resolve, None
        return waiters, cb

    @staticmethod
    def _run_hook(cb) -> None:
        if cb is not None:
            try:
                cb()
            except Exception:
                pass  # a hook failure must never mask the resolution

    def _deliver(self, waiters) -> None:
        for loop, fut in waiters:
            try:
                loop.call_soon_threadsafe(self._resolve_future, fut)
            except RuntimeError:
                pass  # loop already closed; the waiter is gone anyway

    def _resolve_future(self, fut) -> None:
        if fut.done():
            return
        if self.error is not None:
            fut.set_exception(self.error)
        else:
            fut.set_result(self.result)

    def complete(self, result: dict, collector: Optional[dict] = None
                 ) -> bool:
        """Resolve with a result. With a ``collector`` ({loop: [(ticket,
        future), ...]}), async waiters are appended there instead of each
        paying its own ``call_soon_threadsafe`` — the dispatcher flushes
        one cross-thread wakeup per event loop per tick instead of one per
        ticket (256 tickets = 256 loop wakeups otherwise, a measurable
        slice of the tick cycle on a busy host)."""
        with self._lock:
            if self.done.is_set():
                return False
            self.result = result
            waiters, cb = self._resolve_locked()
        self._run_hook(cb)
        if collector is None:
            self._deliver(waiters)
        else:
            for loop, fut in waiters:
                collector.setdefault(loop, []).append((self, fut))
        return True

    def fail(self, error: BaseException) -> bool:
        with self._lock:
            if self.done.is_set():
                return False
            self.error = error
            waiters, cb = self._resolve_locked()
        self._run_hook(cb)
        self._deliver(waiters)
        return True

    def cancel(self, reason: str = "timeout") -> bool:
        """Mark the ticket dead-on-arrival for the dispatcher. Wins only if
        nothing resolved it yet (a dispatch that already completed it keeps
        its result — the caller lost the race and gets the real answer)."""
        with self._lock:
            if self.done.is_set():
                return False
            self.cancelled = True
            self.error = RuntimeError(f"request cancelled ({reason})")
            waiters, cb = self._resolve_locked()
        self._run_hook(cb)
        self._deliver(waiters)
        return True

    # -- waiting -----------------------------------------------------------
    def wait(self, timeout: Optional[float] = None) -> dict:
        """Block for the result. On timeout the ticket is CANCELLED before
        raising: a still-queued request must not fire later against a slot
        the caller has given up on (it could have been freed and reassigned
        — the dispatch would advance another session's PRNG stream — or,
        for a label the client will retry, apply the same update twice).
        Best-effort: a ticket already inside a dispatch completes, and if
        the dispatch resolves the ticket before the cancel lands, the real
        result is returned instead of raising."""
        if not self.done.wait(timeout):
            if self.cancel("serve dispatch timed out"):
                raise TimeoutError("serve dispatch timed out")
            # lost the race: a dispatch completed us during the timeout
        if self.error is not None:
            raise self.error
        return self.result

    async def wait_async(self, timeout: Optional[float] = None) -> dict:
        """Awaitable twin of :meth:`wait` for the asyncio front door: the
        batcher thread resolves the future via ``call_soon_threadsafe``, so
        the event loop never blocks on accelerator work."""
        import asyncio

        loop = asyncio.get_running_loop()
        fut = loop.create_future()
        with self._lock:
            if self.done.is_set():
                self._resolve_future(fut)
            else:
                self._async_waiters.append((loop, fut))
        try:
            return await asyncio.wait_for(fut, timeout)
        except asyncio.TimeoutError:
            if self.cancel("serve dispatch timed out"):
                raise TimeoutError("serve dispatch timed out") from None
            if self.error is not None:
                raise self.error
            return self.result


def _deliver_batch(items: list) -> None:
    """Resolve many tickets' futures inside their event loop (one
    ``call_soon_threadsafe`` delivered this whole list)."""
    for t, fut in items:
        t._resolve_future(fut)


class Batcher:
    """The dispatcher thread around a :class:`SessionStore`.

    ``max_batch`` caps requests per tick. ``max_wait`` is the quiet-gap
    budget: a tick dispatches once no new ticket has arrived for
    ``max_wait`` (a full batch never waits at all — continuous batching
    admits everything already queued immediately). ``max_linger`` bounds
    TOTAL formation time of any tick regardless of arrival pattern
    (default ``4x max_wait``); pause time is excluded, since a paused
    batcher deliberately holds its batch (the lockstep hook).
    ``start()``/``stop()`` manage the thread; ``pause()``/``resume()``
    freeze ticking with the queue still accepting — the
    deterministic-occupancy hook the lockstep load generator and the
    batching tests use.
    """

    def __init__(self, store, metrics=None, max_batch: int = 256,
                 max_wait: float = 0.002, max_linger: Optional[float] = None,
                 telemetry=None, recorder=None, faults=None, quality=None):
        self.store = store
        self.metrics = metrics
        # optional FaultInjector: tick-boundary crash points (the batcher
        # is where "the process died between ticks" is a meaningful,
        # deterministic place to die)
        self.faults = faults
        # recovery hook: called as on_bucket_failure(bucket, error) when a
        # dispatch leaves a bucket quarantined — the ServeApp wires this
        # to BucketHealer.schedule so the slab rebuild starts immediately,
        # off this thread
        self.on_bucket_failure = None
        # optional Telemetry: each per-bucket dispatch becomes a span on the
        # "host:batcher" lane (annotated so a live torch.profiler capture
        # shows the same tick names next to the device rows), with the
        # slab-step execution as a nested "step/<task>" span for the
        # queue-wait / dispatch / step attribution
        self.telemetry = telemetry
        # optional SessionRecorder: every completed ticket appends one
        # decision row to its session's record stream (the flight
        # recorder's serving face — GET /session/{id}/trace)
        self.recorder = recorder
        # optional QualityPlane (telemetry/quality.py): labeled tickets get
        # a pre-dispatch consensus-posterior read (calibration evidence +
        # the rows' additive-optional pred_label_prob field). Read-only —
        # quality on/off takes bitwise-identical decision trajectories,
        # same contract as tracing.
        self.quality = quality
        self.max_batch = int(max_batch)
        self.max_wait = float(max_wait)
        self.max_linger = (4.0 * self.max_wait if max_linger is None
                           else float(max_linger))
        self.queue: queue.Queue = queue.Queue()
        self._running = False
        self._paused = threading.Event()
        self._paused.set()  # set = not paused
        self._thread: Optional[threading.Thread] = None

    # -- lifecycle ---------------------------------------------------------
    def start(self) -> "Batcher":
        if self._thread is not None:
            return self
        self._running = True
        self._thread = threading.Thread(target=self._loop,
                                        name="serve-batcher", daemon=True)
        self._thread.start()
        return self

    def stop(self, drain: bool = True, timeout: float = 30.0) -> None:
        """Stop ticking; with ``drain`` (default) finish queued work first."""
        if self._thread is None:
            return
        if drain:
            deadline = time.perf_counter() + timeout
            while not self.queue.empty() and time.perf_counter() < deadline:
                time.sleep(0.005)
        self._running = False
        self._paused.set()
        self._thread.join(timeout=timeout)
        self._thread = None
        # fail any tickets stranded by a non-drained stop
        self._flush_queue(RuntimeError("server stopped"))

    def _flush_queue(self, error: BaseException) -> None:
        """Fail everything currently queued (exactly-once resolution makes
        racing a live dispatch safe — whichever side resolves first wins)."""
        while True:
            try:
                t = self.queue.get_nowait()
            except queue.Empty:
                break
            self._forget_pending(t)
            t.fail(error)

    def pause(self) -> None:
        self._paused.clear()

    def resume(self) -> None:
        self._paused.set()

    # -- submission (front-door workers) -----------------------------------
    def submit(self, ticket: Ticket) -> Ticket:
        if not self._running:
            # fail fast with a retryable error instead of blackholing the
            # ticket until the request timeout: during a rolling restart
            # the client's retry/backoff loop needs to see the drain NOW
            # so it can land on the restored server
            self._forget_pending(ticket)
            ticket.fail(RuntimeError("server draining: batcher stopped"))
            return ticket
        self.queue.put(ticket)
        if not self._running:
            # raced a concurrent stop(): its final flush may have run
            # before our put landed, which would strand the ticket until
            # the request timeout — flush again (failing an already-
            # resolved ticket is a no-op)
            self._flush_queue(RuntimeError("server draining: batcher "
                                           "stopped"))
        return ticket

    def submit_start(self, session, trace=None) -> Ticket:
        return self.submit(Ticket(session=session, do_update=False,
                                  trace=trace))

    def submit_label(self, session, idx: int, label: int, prob: float,
                     request_id: Optional[str] = None,
                     trace=None) -> Ticket:
        return self.submit(Ticket(session=session, do_update=True, idx=idx,
                                  label=label, prob=prob,
                                  request_id=request_id, trace=trace))

    # -- the tick ----------------------------------------------------------
    def _collect(self) -> list:
        """Form one batch: block briefly for the first ticket, drain what's
        already queued, then linger while arrivals keep flowing.

        Each arrival refreshes a ``max_wait`` quiet-gap budget, so the
        window ends ``max_wait`` after the LAST arrival — but the total
        unpaused formation time is hard-capped at ``max_linger``, so
        steady trickle arrival bounds a tick's formation by time, not
        only by ``max_batch``.

        A pause() landing mid-collect (the thread may already hold tickets
        from its blocking get) HOLDS the batch — full or partial — until
        resume, and admits everything submitted during the pause (up to
        ``max_batch``) into this one dispatch; without the hold,
        lockstep's one-dispatch-per-round guarantee would be a race
        against the first submitter."""
        try:
            first = self.queue.get(timeout=0.05)
        except queue.Empty:
            return []
        batch = [first]
        # continuous-batching fast path: everything that queued while the
        # previous tick ran joins this one with zero added wait
        while len(batch) < self.max_batch:
            try:
                batch.append(self.queue.get_nowait())
            except queue.Empty:
                break
        # adaptive pickup linger: while arrivals keep flowing (gaps under
        # max_wait), keep collecting — the cohort the previous tick just
        # answered resubmits as a burst, and riding THIS tick instead of
        # the next saves it a whole slab step (which costs the same at any
        # occupancy). Each arrival refreshes the max_wait gap budget, so
        # the window ends max_wait after the LAST arrival, not the first;
        # the total unpaused formation time is hard-capped at max_linger
        # so steady trickle arrival bounds a tick's formation by time, not
        # only by max_batch.
        spent = 0.0  # unpaused linger seconds consumed (the cap's measure)
        while len(batch) < self.max_batch and spent < self.max_linger:
            if not self._paused.is_set():
                break  # pause-hold below owns the batch from here
            gap = min(self.max_wait, self.max_linger - spent)
            if gap <= 0:
                break
            t0 = time.perf_counter()
            try:
                batch.append(self.queue.get(timeout=gap))
            except queue.Empty:
                break  # arrivals went quiet for a full max_wait
            finally:
                spent += time.perf_counter() - t0
        # pause-hold: NEVER hand a batch (even a full one) to dispatch
        # while paused — wait out the pause and admit everything submitted
        # during it, so a lockstep round rides exactly one dispatch
        while not self._paused.is_set():
            self._paused.wait()
            while len(batch) < self.max_batch:
                try:
                    batch.append(self.queue.get_nowait())
                except queue.Empty:
                    break
        return batch

    def _loop(self) -> None:
        while self._running:
            self._paused.wait()
            batch = self._collect()
            if not batch:
                continue
            self._dispatch(batch)

    @staticmethod
    def _forget_pending(t: Ticket) -> None:
        """Drop a failed/dropped ticket's idempotency registration so the
        client's retry resubmits instead of re-joining a dead ticket.

        Identity-guarded: a cancelled ticket collected LATE must not
        erase the registration of the newer live ticket its client's
        retry already re-registered under the same request_id — that
        would reopen the double-apply window."""
        if t.request_id is not None:
            pending = t.session.pending
            if pending.get(t.request_id) is t:
                pending.pop(t.request_id, None)

    def _dispatch(self, batch: list) -> None:
        # group by bucket; at most one ticket per slot per tick. Cancelled
        # tickets (wait-timeout) and tickets whose session closed while
        # queued are dropped HERE, not dispatched — their slot may already
        # belong to someone else (see Ticket.wait). Their slot entry is
        # never marked pending, so the next tick sees a clean slab.
        if self.faults is not None:
            self.faults.fire("tick_pre")    # crash_before_tick
        now = time.perf_counter()
        per_bucket: dict = {}
        requeue: list = []
        for t in batch:
            t.collected = now
            if t.cancelled or not self.store.alive(t.session.sid):
                self._forget_pending(t)
                t.fail(RuntimeError("request cancelled (timeout or "
                                    "session closed while queued)"))
                continue
            if t.request_id is not None:
                done = t.session.recent.get(t.request_id)
                if done is not None:
                    # an earlier ticket for this request_id already
                    # committed its result — possible when the client's
                    # wait-timeout cancel lost the race to that ticket's
                    # in-flight dispatch and the retry resubmitted before
                    # the commit landed. Answer from the committed result;
                    # dispatching would apply the oracle answer twice.
                    self._forget_pending(t)
                    t.complete(dict(done))
                    continue
            slots = per_bucket.setdefault(t.session.bucket, {})
            if t.session.slot in slots:
                requeue.append(t)  # same-slot collision -> next tick
            else:
                slots[t.session.slot] = t
        depth = self.queue.qsize() + len(requeue)
        for bucket, slots in per_bucket.items():
            if bucket.quarantined is not None or bucket.failed is not None:
                # fail fast WITHOUT the bucket lock: the healer holds it
                # for the entire slab rebuild, and blocking here would
                # stall this thread — and with it every OTHER bucket's
                # dispatches — behind one bucket's recovery. The heal was
                # scheduled when the quarantine was set; waiters just need
                # the retryable error now.
                try:
                    bucket._check_available()
                except BaseException as e:
                    for t in slots.values():
                        self._forget_pending(t)
                        t.fail(e)
                    if bucket.quarantined is not None and \
                            self.on_bucket_failure is not None:
                        # a quarantine set OUTSIDE this thread's dispatch
                        # path (an import/restore replay dispatch failed)
                        # has no heal scheduled yet — kick it here;
                        # schedule() is a no-op while one is in flight
                        self.on_bucket_failure(bucket, e)
                    continue
            reqs = {
                slot: {"do_update": t.do_update, "idx": t.idx,
                       "label": t.label, "prob": t.prob}
                for slot, t in slots.items()
            }
            # OTel-style span links: one coalesced tick serves many
            # requests, so the tick span links to every member TRACE
            # (fan-in) instead of parenting to any single one — the span
            # recorder files it under each linked trace's retention ring
            links = sorted({t.trace.trace_id for t in slots.values()
                            if t.trace is not None})
            span_attrs = {"requests": len(slots), "depth": depth}
            if links:
                span_attrs["links"] = links
            span = (self.telemetry.span(
                        f"tick/{bucket.task}", lane="host:batcher",
                        annotate=True, **span_attrs)
                    if self.telemetry is not None
                    else contextlib.nullcontext())
            t0 = time.perf_counter()
            try:
                # the bucket lock serializes the slab swap against THIS
                # bucket's admission writes only — other buckets' dispatches
                # and admissions proceed (see SessionStore docstring)
                with span, bucket.lock:
                    pred_probs = {}
                    if self.quality is not None:
                        # pre-dispatch read of the exact posterior the
                        # round's decision is about to be made under: the
                        # consensus pi_hat's mass on each realized label
                        pred_probs = self.quality.pre_dispatch(
                            bucket, bucket.task,
                            [(slot, t.idx, t.label)
                             for slot, t in slots.items() if t.do_update])
                    results = bucket.dispatch(reqs)
            except BaseException as e:  # surface to every waiter, keep going
                for t in slots.values():
                    self._forget_pending(t)
                    t.fail(e)
                if bucket.quarantined is not None and \
                        self.on_bucket_failure is not None:
                    # the slab was lost to this failure: kick off the
                    # rebuild-from-streams heal (off this thread) so the
                    # waiters' retries find a healed bucket, not a corpse
                    self.on_bucket_failure(bucket, e)
                continue
            dt = time.perf_counter() - t0
            deliveries: dict = {}  # loop -> [(ticket, future), ...]
            timing = dict(bucket.last_timing)
            if self.telemetry is not None and timing.get("step_s"):
                # the slab-step execution as its own span, nested inside
                # the tick: tick minus step is host-side build/fan-out
                t_end = time.perf_counter()
                s0 = t_end - timing["step_s"]
                step_attrs = {"requests": len(slots),
                              "source": "aot" if bucket.is_warm else "jit"}
                if links:
                    step_attrs["links"] = links
                self.telemetry.spans.record(
                    f"step/{bucket.task}", lane="host:batcher",
                    t_start=s0, t_end=t_end, attrs=step_attrs)
            now = time.perf_counter()
            for slot, t in slots.items():
                r = results[slot]
                t.session.last = r
                t.session.last_used = time.monotonic()  # the tiers' LRU axis
                if t.do_update:
                    # batch-label tickets carry a q-wide list: every one
                    # of its oracle answers counts (the loadgen's
                    # double-apply sentinel reads this)
                    t.session.n_labeled += (len(t.label)
                                            if isinstance(t.label, list)
                                            else 1)
                if t.request_id is not None:
                    # idempotency: the result is committed BEFORE the
                    # ticket resolves, so a client retry racing the
                    # response can only ever read, never re-apply
                    recent = t.session.recent
                    recent[t.request_id] = r
                    while len(recent) > 128:  # bounded retry window
                        recent.pop(next(iter(recent)))
                    # identity-guarded (like _forget_pending): if a cancel
                    # of THIS ticket already let the client's retry
                    # re-register the request_id, popping here would strip
                    # the newer ticket's registration mid-flight
                    if t.session.pending.get(t.request_id) is t:
                        t.session.pending.pop(t.request_id, None)
                if self.recorder is not None:
                    row = {
                        "n_labeled": t.session.n_labeled,
                        "do_update": t.do_update,
                        "labeled_idx": t.idx if t.do_update else None,
                        "label": t.label if t.do_update else None,
                        "prob": t.prob if t.do_update else None,
                        "request_id": t.request_id,
                        "next_idx": r["next_idx"],
                        "next_prob": r["next_prob"],
                        "best": r["best"],
                        "stochastic": r["stochastic"],
                        "pbest_max": r.get("pbest_max"),
                        "pbest_entropy": r.get("pbest_entropy"),
                    }
                    if t.trace is not None:
                        # additive optional field: a decision row joins to
                        # its serving trace; absent (not null) when
                        # untraced, so tracing-off streams stay bitwise
                        # identical to pre-tracing streams
                        row["trace_id"] = t.trace.trace_id
                    if slot in pred_probs:
                        # additive optional field (same contract as
                        # trace_id): the probability the session's
                        # consensus pi_hat assigned to the realized oracle
                        # label, read pre-update. Absent with quality off,
                        # so off-streams stay bitwise identical on the
                        # existing keys.
                        row["pred_label_prob"] = pred_probs[slot]
                    self.recorder.append(t.session.sid, row)
                if self.metrics is not None:
                    tid = t.trace.trace_id if t.trace is not None else None
                    self.metrics.record_request_latency(
                        now - t.submitted, trace_id=tid)
                    self.metrics.record_queue_wait(
                        t.collected - t.submitted, trace_id=tid)
                t.complete(r, collector=deliveries)
            for loop, items in deliveries.items():
                try:
                    loop.call_soon_threadsafe(_deliver_batch, items)
                except RuntimeError:  # loop closed; waiters are gone
                    pass
            if self.metrics is not None:
                self.metrics.record_dispatch(
                    len(slots), depth, dt,
                    step_seconds=timing.get("step_s"),
                    warm=bucket.is_warm)
        for t in requeue:
            self.queue.put(t)
        if self.faults is not None:
            self.faults.fire("tick_post")   # crash_after_tick
