"""Structured span recorder: one timeline for host phases and device lanes
(counterpart of ``coda_tpu/telemetry/spans.py``).

A :class:`SpanRecorder` gives the port's loops one vocabulary: named
begin/end events on named *lanes* (one lane per device, plus host lanes),
recorded O(1) into a fixed-capacity ring and exported as Chrome
``trace_event`` JSON, loadable in Perfetto / ``chrome://tracing``.

Host spans and a ``--profile-dir`` trace line up because hot regions also
enter :func:`annotation` (``torch.profiler.record_function``), which puts
the same names on the profiler's CPU rows, above the CUDA kernels they
launch.

All timestamps come from ``time.perf_counter()`` (monotonic) relative to
the recorder's creation, never the wall clock.
"""

from __future__ import annotations

import collections
import contextlib
import json
import threading
import time
from typing import Optional

# events kept per recorder: enough for a full 26-task suite sweep
# (~hundreds of dispatch spans) plus long serve sessions' tick spans,
# small enough that a trace.json export stays a few MB
_CAPACITY = 65536

# per-trace retention ring: distinct traces kept (FIFO eviction) and spans
# kept per trace. The front door mints a context for EVERY session verb,
# so a loadgen capture run generates thousands of traces — the cap must
# outlast a full capture pass or sampled traces are evicted before the
# stitcher fetches them. Both caps bound memory independently of the main
# ring (4096 traces x 256 spans x ~100 B is a few-MB worst case).
_TRACE_CAPACITY = 4096
_TRACE_SPAN_CAPACITY = 256


@contextlib.contextmanager
def annotation(name: str):
    """``torch.profiler.record_function(name)``: the enclosed host region
    shows under ``name`` in a live ``torch.profiler`` capture (a
    ``--profile-dir`` trace), the correlation hook between the two. Used
    only where telemetry is on."""
    from torch.profiler import record_function

    with record_function(name):
        yield


class SpanRecorder:
    """Thread-safe structured span recorder with Chrome-trace export.

    Lanes are created on first use and map to Chrome ``tid``s in first-seen
    order; use ``device:<id>`` for device lanes and ``host:<role>`` for host
    threads. Events are ``(name, lane, t_start, t_end, attrs)`` tuples in a
    bounded ring — recording is O(1) and never blocks on a reduction.
    """

    def __init__(self, capacity: int = _CAPACITY,
                 trace_capacity: int = _TRACE_CAPACITY,
                 trace_span_capacity: int = _TRACE_SPAN_CAPACITY):
        self._lock = threading.Lock()
        self._events: collections.deque = collections.deque(maxlen=capacity)
        self._lanes: dict[str, int] = {}
        self._t0 = time.perf_counter()
        # wall-clock: one-shot anchor pairing _t0 with an epoch instant so a
        # router can line up spans from recorders in different processes;
        # never used for durations (those stay perf_counter-relative)
        self._t0_unix = time.time()  # wall-clock: cross-process anchor
        self.capacity = capacity
        self.recorded = 0  # total ever recorded (ring evicts past capacity)
        # trace_id -> deque of event tuples; FIFO eviction past capacity
        self._traces: "collections.OrderedDict[str, collections.deque]" = \
            collections.OrderedDict()
        self._trace_capacity = trace_capacity
        self._trace_span_capacity = trace_span_capacity

    # -- recording (hot path: O(1)) ----------------------------------------
    def record(self, name: str, lane: str = "host", t_start: float = 0.0,
               t_end: float = 0.0, attrs: Optional[dict] = None) -> None:
        """Record one completed span (perf_counter begin/end seconds).

        ``attrs["trace"]`` indexes the span under that trace for
        :meth:`trace_events`; ``attrs["links"]`` (a list of trace_ids)
        additionally files it under every linked trace — the OTel span-link
        fan-in a coalesced batcher tick uses, so a tick serving 32 requests
        appears in all 32 traces while being recorded exactly once.
        """
        with self._lock:
            if lane not in self._lanes:
                self._lanes[lane] = len(self._lanes)
            ev = (name, lane, t_start, t_end, attrs)
            self._events.append(ev)
            self.recorded += 1
            if attrs:
                tid = attrs.get("trace")
                if tid is not None:
                    self._index_trace(tid, ev)
                for linked in attrs.get("links") or ():
                    if linked != tid:
                        self._index_trace(linked, ev)

    def _index_trace(self, trace_id: str, ev: tuple) -> None:
        """File one event under a trace id (caller holds the lock)."""
        ring = self._traces.get(trace_id)
        if ring is None:
            while len(self._traces) >= self._trace_capacity:
                self._traces.popitem(last=False)
            ring = collections.deque(maxlen=self._trace_span_capacity)
            self._traces[trace_id] = ring
        ring.append(ev)

    def instant(self, name: str, lane: str = "host",
                attrs: Optional[dict] = None) -> None:
        """Record a zero-duration marker event."""
        t = time.perf_counter()
        self.record(name, lane, t, t, attrs)

    @contextlib.contextmanager
    def span(self, name: str, lane: str = "host", annotate: bool = False,
             **attrs):
        """Time the enclosed block as one span on ``lane``.

        ``annotate=True`` additionally enters :func:`annotation` so the
        region shows up (same name) in a live ``torch.profiler`` capture.
        """
        cm = annotation(name) if annotate else contextlib.nullcontext()
        t0 = time.perf_counter()
        try:
            with cm:
                yield
        finally:
            self.record(name, lane, t0, time.perf_counter(), attrs or None)

    # -- reading -----------------------------------------------------------
    def events(self) -> list:
        with self._lock:
            return list(self._events)

    def lanes(self) -> list[str]:
        """Lane names in tid order."""
        with self._lock:
            return sorted(self._lanes, key=self._lanes.get)

    def summary(self) -> dict:
        with self._lock:
            return {
                "events": len(self._events),
                "recorded": self.recorded,
                "dropped": max(0, self.recorded - len(self._events)),
                "capacity": self.capacity,
                "lanes": sorted(self._lanes, key=self._lanes.get),
            }

    def trace_ids(self) -> list[str]:
        """Retained trace ids, oldest first."""
        with self._lock:
            return list(self._traces)

    def trace_events(self, trace_id: str) -> list:
        """Retained event tuples for one trace (empty if unknown/evicted)."""
        with self._lock:
            ring = self._traces.get(trace_id)
            return list(ring) if ring is not None else []

    def trace_payload(self, trace_id: str, process: str = "") -> dict:
        """Wire payload for ``GET /trace/id/{trace_id}``: this recorder's
        retained spans for one trace, timestamps rebased to seconds since
        recorder creation plus a wall-clock anchor (``t0_unix``) so a
        stitcher can line up recorders from different processes."""
        events = [
            {"name": name, "lane": lane,
             "t0": t0 - self._t0, "t1": t1 - self._t0,
             **({"attrs": attrs} if attrs else {})}
            for name, lane, t0, t1, attrs in self.trace_events(trace_id)
        ]
        return {"trace_id": trace_id, "process": process,
                "t0_unix": self._t0_unix, "events": events}

    def lane_busy_s(self, lane: str) -> float:
        """Union-of-intervals busy seconds of one lane (overlapping spans
        counted once — the same folding the scheduler's occupancy uses)."""
        ivals = sorted((t0, t1) for name, ln, t0, t1, _ in self.events()
                       if ln == lane)
        busy, last = 0.0, None
        for s, e in ivals:
            if last is None or s > last:
                busy += e - s
                last = e
            elif e > last:
                busy += e - last
                last = e
        return busy

    # -- export ------------------------------------------------------------
    def to_chrome(self) -> dict:
        """Chrome ``trace_event`` JSON object (Perfetto-loadable).

        Spans become ``"X"`` (complete) events with microsecond timestamps
        relative to recorder creation; each lane is a named thread of one
        process, ordered by first use. Nested spans on a lane nest visually
        because their intervals nest.
        """
        with self._lock:
            events = list(self._events)
            lanes = dict(self._lanes)
        out = []
        for lane, tid in sorted(lanes.items(), key=lambda kv: kv[1]):
            out.append({"name": "thread_name", "ph": "M", "pid": 0,
                        "tid": tid, "args": {"name": lane}})
            out.append({"name": "thread_sort_index", "ph": "M", "pid": 0,
                        "tid": tid, "args": {"sort_index": tid}})
        for name, lane, t0, t1, attrs in events:
            ev = {
                "name": name, "ph": "X", "pid": 0, "tid": lanes[lane],
                "ts": round((t0 - self._t0) * 1e6, 3),
                "dur": round(max(0.0, t1 - t0) * 1e6, 3),
            }
            if attrs:
                ev["args"] = attrs
            out.append(ev)
        return {"traceEvents": out, "displayTimeUnit": "ms"}

    def save(self, path: str) -> str:
        with open(path, "w") as f:
            json.dump(self.to_chrome(), f)
        return path


def stitch_traces(payloads: list[dict]) -> dict:
    """Stitch per-process :meth:`SpanRecorder.trace_payload` dicts into one
    Chrome ``trace_event`` file with one *process lane* per payload.

    Each payload becomes a Chrome ``pid`` named after its ``process``
    (router, replica id, ...); lanes within a payload keep their tids.
    Timestamps are aligned across processes via each payload's wall-clock
    anchor, rebased so the earliest span in the stitched trace is t=0 —
    Perfetto then shows the router verb, both replicas' serve spans, and
    the linked tick/step spans on one shared timeline.
    """
    payloads = [p for p in payloads if p and p.get("events")]
    if not payloads:
        return {"traceEvents": [], "displayTimeUnit": "ms"}
    # absolute (epoch) start of the earliest span across all processes
    base = min(p["t0_unix"] + e["t0"] for p in payloads for e in p["events"])
    out = []
    for pid, p in enumerate(payloads):
        name = p.get("process") or f"process-{pid}"
        out.append({"name": "process_name", "ph": "M", "pid": pid,
                    "tid": 0, "args": {"name": name}})
        out.append({"name": "process_sort_index", "ph": "M", "pid": pid,
                    "tid": 0, "args": {"sort_index": pid}})
        lanes: dict[str, int] = {}
        for e in p["events"]:
            lane = e.get("lane", "host")
            if lane not in lanes:
                lanes[lane] = len(lanes)
                out.append({"name": "thread_name", "ph": "M", "pid": pid,
                            "tid": lanes[lane], "args": {"name": lane}})
            off = p["t0_unix"] - base
            ev = {
                "name": e["name"], "ph": "X", "pid": pid,
                "tid": lanes[lane],
                "ts": round((e["t0"] + off) * 1e6, 3),
                "dur": round(max(0.0, e["t1"] - e["t0"]) * 1e6, 3),
            }
            if e.get("attrs"):
                ev["args"] = e["attrs"]
            out.append(ev)
    return {"traceEvents": out, "displayTimeUnit": "ms"}
