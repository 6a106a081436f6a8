"""Deterministic fault injection for the serving layer (counterpart of
``coda_tpu/serve/faults.py``: the whole spec grammar, so every reference
spec parses).

The port fires every site of one server (the slab step, the recorder,
the batcher's tick boundaries, the tiers, the crowd's answer verb and
the shadow auditor). A spec naming a fleet site (the router's transport
and migration) is refused by :class:`FaultInjector` with
``NotImplementedError`` naming slice 9 of the port, which brings the
fleet (:data:`PENDING_SITES`).

Every recovery path in ``serve/recovery.py`` exists because some step of
the serving pipeline can fail: the compiled slab step can raise after
consuming its donated carries, it can return NaN (silent posterior
corruption), the recorder's disk can fill, the host can stall, the process
can die between ticks. None of those are reachable from a test without
help — so this module makes each one *injectable*, deterministically, at
the exact site where it would occur in production. The fault matrix
(``scripts/check_fault_matrix.py``) and the loadgen chaos mode
(``--fault-spec``) then exercise every recovery path instead of reasoning
about it.

Spec grammar (``--fault-spec``), semicolon-separated faults::

    <name>:<param>=<value>[,<param>=<value>...][;<name>:...]

Names (each is one injection point):

  * ``step_raise``    — the slab step raises AFTER the executable has run
                        (donated carries are already consumed — the
                        quarantine/self-heal path);
  * ``step_nan``      — the step's outputs (next_prob + P(best) digest)
                        are replaced with NaN (silent-corruption path: the
                        digest verification must catch it);
  * ``record_eio``    — the recorder's stream write raises ``OSError``
                        (disk-full path: degrade to memory-only stream);
  * ``slow_step``     — the dispatch sleeps ``ms`` before the step (tail
                        amplification; also the concurrent-export race
                        window);
  * ``crash_before_tick`` / ``crash_after_tick`` — ``os._exit(17)``
                        around a batcher tick (crash-restore path: rebuild
                        sessions from their JSONL streams);
  * ``demote_during_label`` — a tier demotion is attempted at the exact
                        moment a label arrives for the session
                        (demotion-vs-ticket race: either the label wakes
                        the freshly-demoted session or the demotion loses
                        cleanly to the in-flight pin);
  * ``oracle_poison``  — an arriving crowd answer (``POST /session/{id}/
                        answer``) is corrupted to the adversarial family
                        ``(label+1) % C`` before parking;
  * ``oracle_abstain`` — an arriving crowd answer is converted into an
                        abstention (the slot stays open).

Fleet-level names (fired inside the router↔replica transport,
``serve/transport.py``, addressable per edge with ``edge=<replica_id>``
and per verb with ``task=<verb>``):

  * ``net_drop``      — the call raises ``ConnectionError`` before the
                        send (a lost packet; retry/breaker territory);
  * ``partition``     — same drop, but idiomatically used with
                        ``times=K`` for a K-arrival outage window that
                        "heals" when the budget is spent;
  * ``net_delay``     — the edge sleeps ``ms`` before the send (tail
                        amplification across the fleet);
  * ``net_dup``       — the request is DELIVERED TWICE (a retransmitted
                        packet): the second answer is discarded and the
                        replica's request_id dedupe must keep the
                        posterior exactly-once;
  * ``flap_healthz``  — the health probe answers unready without
                        touching the replica (the eviction-hysteresis
                        scenario);
  * ``kill_replica``  — fired at the router's mid-migration point
                        (between export and import): the matching
                        replica is killed abruptly via the fleet's kill
                        hook — SIGKILL semantics for the in-process
                        fleet.

Triggers (deterministic — a spec plus a request history replays exactly):

  * ``after=N``  — fire on the (N+1)-th arrival at the site (0-indexed),
                   ``times=K`` fires on the K arrivals from there
                   (default 1);
  * ``every=N``  — fire on every N-th arrival (unbounded unless ``times``);
  * ``p=F,seed=S`` — fire when a counter-addressed hash draw < F: the
                   decision for arrival ``i`` is a pure function of
                   (seed, name, i), so two runs with the same spec and
                   arrival order inject identically ("seed-addressable");
  * ``task=T``   — only fire for that bucket/task (default all).

Example: ``step_raise:after=5;slow_step:every=3,ms=20``.
"""

from __future__ import annotations

import hashlib
import os
import threading
import time
from dataclasses import dataclass, field
from typing import Optional

#: injection-point name -> site it hooks (documentation + validation).
FAULT_SITES = {
    "step_raise": "step_post",      # after the executable ran (carries gone)
    "step_nan": "step_out",         # corrupt the step's host outputs
    "record_eio": "record_write",   # inside SessionRecorder.append
    "slow_step": "step_pre",        # before the step, inside the lock
    "crash_before_tick": "tick_pre",
    "crash_after_tick": "tick_post",
    # inject a tier demotion at the exact moment a label arrives for the
    # session (serve/tiering.py): either the demotion wins and the label
    # transparently wakes the session back, or it loses cleanly to an
    # in-flight pin — the matrix fails on any lost/double-applied label
    "demote_during_label": "label_pre",
    # fleet-level faults (serve/transport.py fires these per
    # router↔replica edge; filter with edge=<replica_id> / task=<verb>)
    "net_drop": "edge_call",
    "partition": "edge_call",
    "net_delay": "edge_call",
    "net_dup": "edge_call",
    "flap_healthz": "edge_healthz",
    # process fault: fired by the router between a migration's export
    # and its import (serve/router.py); the fleet's kill hook SIGKILLs
    # the matching replica at exactly that point
    "kill_replica": "migrate_mid",
    # crowd-oracle answer faults (fired by ServeApp.answer, applied
    # OUT-OF-BAND by the answer path itself): oracle_poison corrupts the
    # arriving label to the adversarial family ((label+1) % C — the
    # systematic mislabeler of coda_tpu/crowd/oracle.py), oracle_abstain
    # converts the answer into an abstention (the slot stays open). The
    # robustness matrix drives both through the front door to show the
    # parking + dedupe layer keeps labels exactly-once regardless.
    "oracle_poison": "oracle_answer",
    "oracle_abstain": "oracle_answer",
    # decision-quality plane (telemetry/quality.py): fired by the shadow
    # auditor just before it replays a sampled session's stream, applied
    # OUT-OF-BAND — the auditor ulp-tampers its in-memory COPY of the
    # rows (the session's real stream is untouched), so the bench can
    # prove a single-ulp stream corruption is caught and attributed to
    # the exact session + round
    "stream_tamper": "audit_pre",
}

#: fault name -> the slice of the port that brings the module it fires in
PENDING_SITES = {
    "net_drop": "9 (the fleet)",
    "partition": "9 (the fleet)",
    "net_delay": "9 (the fleet)",
    "net_dup": "9 (the fleet)",
    "flap_healthz": "9 (the fleet)",
    "kill_replica": "9 (the fleet)",
}

_CRASH_EXIT_CODE = 17  # distinguishable from python tracebacks (1) in tests


class FaultInjected(RuntimeError):
    """An injected fault fired (never raised by real failures)."""


@dataclass
class _Fault:
    """One parsed fault: a name, a trigger, and a fire budget."""

    name: str
    site: str
    after: Optional[int] = None
    every: Optional[int] = None
    p: Optional[float] = None
    seed: int = 0
    times: Optional[int] = None     # max fires; default 1 for `after`
    ms: float = 0.0                 # slow_step / net_delay only
    task: Optional[str] = None      # bucket filter (verb at edge sites)
    edge: Optional[str] = None      # router↔replica edge filter
    count: int = 0                  # arrivals at the site (matching task)
    fired: int = 0

    def should_fire(self) -> bool:
        """Decide for the CURRENT arrival (caller already bumped count)."""
        i = self.count - 1
        budget = self.times if self.times is not None else (
            1 if self.after is not None else None)
        if budget is not None and self.fired >= budget:
            return False
        if self.after is not None:
            return i >= self.after
        if self.every is not None:
            return self.every > 0 and (i + 1) % self.every == 0
        if self.p is not None:
            # counter-addressed hash draw: deterministic per (seed, name, i)
            h = hashlib.sha256(
                f"{self.seed}:{self.name}:{i}".encode()).digest()
            draw = int.from_bytes(h[:8], "big") / float(1 << 64)
            return draw < self.p
        return True  # bare fault: fire on every arrival (within budget)


def parse_fault_spec(spec: Optional[str]) -> list[_Fault]:
    """Parse a ``--fault-spec`` string; [] for None/empty."""
    faults: list[_Fault] = []
    for part in (spec or "").split(";"):
        part = part.strip()
        if not part:
            continue
        name, _, params = part.partition(":")
        name = name.strip()
        if name not in FAULT_SITES:
            raise ValueError(
                f"unknown fault {name!r}; known: {sorted(FAULT_SITES)}")
        f = _Fault(name=name, site=FAULT_SITES[name])
        for kv in filter(None, (s.strip() for s in params.split(","))):
            if "=" not in kv:
                raise ValueError(f"fault param {kv!r} is not key=value")
            k, v = kv.split("=", 1)
            if k in ("after", "every", "seed", "times"):
                setattr(f, k, int(v))
            elif k in ("p", "ms"):
                setattr(f, k, float(v))
            elif k == "task":
                f.task = None if v == "*" else v
            elif k == "edge":
                f.edge = None if v == "*" else v
            else:
                raise ValueError(f"unknown fault param {k!r} in {part!r}")
        faults.append(f)
    return faults


class FaultInjector:
    """Deterministic injection at named sites.

    Thread-safe: counters advance under one lock (the batcher thread, heal
    threads, and recorder writers all pass through here). ``fire`` raises /
    sleeps / exits for the faults whose action is in-band, and RETURNS the
    names of triggered faults so sites with out-of-band actions
    (``step_nan``'s output corruption) can apply them.
    """

    def __init__(self, spec: Optional[str] = None):
        self.faults = parse_fault_spec(spec)
        for f in self.faults:
            if f.name in PENDING_SITES:
                raise NotImplementedError(
                    f"fault {f.name!r} fires in a module that comes with "
                    f"slice {PENDING_SITES[f.name]} of the port")
        self.spec = spec or ""
        self._lock = threading.Lock()

    @property
    def active(self) -> bool:
        return bool(self.faults)

    def fire(self, site: str, task: Optional[str] = None,
             edge: Optional[str] = None) -> list[str]:
        """One arrival at ``site``; applies every matching triggered fault.

        Raise order: a crash fault exits the process outright; a
        ``step_raise`` raises :class:`FaultInjected`; ``slow_step`` /
        ``net_delay`` sleep then return; out-of-band names (``step_nan``,
        ``net_drop``, ``net_dup``, ``flap_healthz``, ``kill_replica``)
        are returned to the caller to apply at the site.
        """
        fired: list[_Fault] = []
        with self._lock:
            for f in self.faults:
                if f.site != site:
                    continue
                if f.task is not None and task is not None and f.task != task:
                    continue
                if f.edge is not None and edge is not None and \
                        f.edge != edge:
                    continue
                f.count += 1
                if f.should_fire():
                    f.fired += 1
                    fired.append(f)
            # only the instances that fired sleep — matching by name would
            # charge every configured slow_step's ms when any one fires
            slow = [f.ms for f in fired
                    if f.name in ("slow_step", "net_delay")]
        triggered = [f.name for f in fired]
        for name in triggered:
            if name.startswith("crash_"):
                # simulate sudden process death: no atexit, no flush beyond
                # what the crash-safe recorder already did per row
                os._exit(_CRASH_EXIT_CODE)
        for ms in slow:
            time.sleep(ms / 1e3)
        if "step_raise" in triggered:
            raise FaultInjected(
                "injected step_raise (slab step failed after consuming "
                "donated carries)")
        if "record_eio" in triggered:
            raise OSError(5, "injected record_eio (recorder disk write "
                             "failed)")
        return triggered

    def snapshot(self) -> list[dict]:
        """Per-fault arrival/fire counts (for /stats and the matrix)."""
        with self._lock:
            return [
                {"name": f.name, "site": f.site, "count": f.count,
                 "fired": f.fired, "task": f.task}
                for f in self.faults
            ]
