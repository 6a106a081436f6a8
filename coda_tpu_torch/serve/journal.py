"""Migration journal: a per-router append-log that makes session moves
crash-consistent (counterpart of ``coda_tpu/serve/journal.py``; the log
format is the same line for line, so each package reads the other's).

A migration is a multi-step protocol (quiesce+hold on the source, export,
import on the destination, fence the source) and the router — or either
replica — can be SIGKILLed between any two steps. Without a durable
record, a crash mid-move leaves the session's ownership in doubt: did the
import land? is the source copy still authoritative? This log resolves
that: every phase transition is one appended JSON line, flushed before
the next step runs, so a restarted router replays the log and knows
exactly how far each move got.

Framing is the same torn-tail-tolerant contract as the recorder streams
and ``serve/spill.py``: one JSON object per line, append + flush per
record; a process killed mid-write leaves at most one truncated FINAL
line, which the load path drops. A torn line anywhere else is real
corruption and raises.

Record shape (every record carries the migration id ``mid`` — unique per
move — so interleaved moves of different sessions never alias)::

    {"mid": "<sid>#<seq>", "phase": "intent",   "sid", "src", "dst",
     "epoch"}
    {"mid": ...,           "phase": "exported",  "digest", "n_labeled"}
    {"mid": ...,           "phase": "imported"}
    {"mid": ...,           "phase": "committed", "fenced": true|false}
    {"mid": ...,           "phase": "aborted",   "reason": "..."}

Resolution on restart (:meth:`MigrationJournal.in_doubt` feeds the
router's ``recover_from_journal``): a move whose last phase is ``intent``
or ``exported`` may or may not have imported — probe the destination; one
at ``imported`` definitely committed on the target — finalize by fencing
the source. Either way the outcome is *didn't move* or *moved exactly
once*, never gone and never doubled.
"""

from __future__ import annotations

import hashlib
import json
import os
import threading
from typing import Optional

#: phases that end a migration (anything else is in-doubt after a crash)
TERMINAL_PHASES = ("committed", "aborted")


def payload_digest(payload: dict) -> str:
    """A cheap identity digest of an export payload: enough to recognise
    "the copy the journal saw" on the destination during recovery (sid +
    epoch + committed-label count + the stream's last posterior digest),
    without hashing megabytes of carries."""
    rows = payload.get("rows") or []
    last = rows[-1] if rows else {}
    key = {
        "sid": payload.get("session"),
        "epoch": int(payload.get("epoch") or 0),
        "n_labeled": int(payload.get("n_labeled") or 0),
        "rounds": len(rows),
        "pbest_max": last.get("pbest_max"),
        "pbest_entropy": last.get("pbest_entropy"),
    }
    return hashlib.sha256(
        json.dumps(key, sort_keys=True).encode()).hexdigest()[:16]


class MigrationJournal:
    """Append-only migration log + the in-memory state it rebuilds.

    Thread-safe (one lock around the fd and the state maps). The journal
    is an *ordering* log, not a database: the load path folds records per
    ``mid`` (last phase wins) and per ``sid`` (the latest committed epoch
    wins) — that fold is the router's durable epoch/placement map.
    """

    def __init__(self, path: str):
        self.path = path
        self._lock = threading.Lock()
        self._seq = 0
        # mid -> folded record (intent fields + latest phase + extras)
        self._moves: dict[str, dict] = {}
        self.records_loaded = 0
        self.torn_tail_dropped = False
        d = os.path.dirname(path)
        if d:
            os.makedirs(d, exist_ok=True)
        self._load()
        self._fd = open(path, "a")

    # -- load (torn-tail-tolerant, same contract as the recorder) ----------
    def _load(self) -> None:
        if not os.path.exists(self.path):
            return
        with open(self.path) as f:
            lines = f.read().splitlines()
        for i, line in enumerate(lines):
            if not line.strip():
                continue
            try:
                rec = json.loads(line)
            except ValueError:
                if i == len(lines) - 1:
                    self.torn_tail_dropped = True
                    break  # the crash the flush-per-record contract allows
                raise
            self._fold(rec)
            self.records_loaded += 1
        for mid in self._moves:
            try:
                self._seq = max(self._seq, int(mid.rsplit("#", 1)[1]) + 1)
            except (IndexError, ValueError):
                pass

    def _fold(self, rec: dict) -> None:
        mid = rec.get("mid")
        if not mid:
            return
        cur = self._moves.setdefault(mid, {})
        cur.update({k: v for k, v in rec.items() if v is not None})

    # -- append ------------------------------------------------------------
    def _append(self, rec: dict) -> None:
        with self._lock:
            self._fold(rec)
            try:
                self._fd.write(json.dumps(rec, separators=(",", ":"))
                               + "\n")
                self._fd.flush()
            except OSError:
                # a full disk must not fail the migration itself — the
                # epoch fence still protects correctness; only crash
                # recovery loses this move's record
                pass

    def begin(self, sid: str, src: str, dst: str, epoch: int) -> str:
        with self._lock:
            mid = f"{sid}#{self._seq}"
            self._seq += 1
        self._append({"mid": mid, "phase": "intent", "sid": sid,
                      "src": src, "dst": dst, "epoch": int(epoch)})
        return mid

    def record(self, mid: str, phase: str, **extra) -> None:
        rec = {"mid": mid, "phase": phase}
        rec.update(extra)
        self._append(rec)

    # -- reads -------------------------------------------------------------
    def in_doubt(self) -> list[dict]:
        """Folded records of every move whose last phase is not terminal
        — the set a restarted router must resolve before serving."""
        with self._lock:
            return [dict(m) for m in self._moves.values()
                    if m.get("phase") not in TERMINAL_PHASES]

    def committed(self) -> dict:
        """``sid -> {epoch, dst}`` from committed records (highest epoch
        per sid wins) — the durable half of the router's epoch/placement
        map."""
        out: dict[str, dict] = {}
        with self._lock:
            moves = list(self._moves.values())
        for m in moves:
            if m.get("phase") != "committed":
                continue
            sid = m.get("sid")
            ep = int(m.get("epoch") or 0)
            if sid and ep >= out.get(sid, {}).get("epoch", -1):
                out[sid] = {"epoch": ep, "dst": m.get("dst")}
        return out

    def stats(self) -> dict:
        with self._lock:
            phases: dict[str, int] = {}
            for m in self._moves.values():
                p = m.get("phase") or "?"
                phases[p] = phases.get(p, 0) + 1
            return {"path": self.path, "moves": len(self._moves),
                    "records_loaded": self.records_loaded,
                    "torn_tail_dropped": self.torn_tail_dropped,
                    "phases": phases}

    def close(self) -> None:
        with self._lock:
            try:
                self._fd.close()
            except OSError:
                pass
