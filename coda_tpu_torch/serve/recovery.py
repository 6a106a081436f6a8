"""Bucket self-healing: rebuild a slab lost to a step failure from its
sessions' recorder streams (the healer half of ``coda_tpu/serve/
recovery.py``; export/import, crash restore and ``replay-serve`` come with
slice 8b of the port).

The posterior is the valuable state; the slab is disposable. Every live
session already has a per-round stream (``SessionRecorder``), and a
same-backend replay of it through the bucket's step is bitwise, so a
quarantined bucket (a step failed after writing the slab in place) is
rebuilt by replaying every live slot's stream into fresh slots — one
dispatch per round for ALL slots — with every replayed round, the P(best)
digest included, verified bitwise against its row. :class:`BucketHealer`
runs it off the batcher thread with bounded retries and backoff; only a
digest mismatch or exhausted retries degrade the bucket to terminal.
"""

from __future__ import annotations

import re
import threading
import time
from typing import Optional

import numpy as np

# the only session ids this package mints (hex): the HTTP routes can
# address nothing else and the id lands in a recorder file path
_SID_RE = re.compile(r"^[0-9a-f]{1,64}$")

# result-row quantities a replayed round must reproduce bitwise
_INT_QUANTITIES = ("next_idx", "best")
_FLOAT_QUANTITIES = ("next_prob", "pbest_max", "pbest_entropy")


class ReplayMismatch(RuntimeError):
    """A replayed round diverged bitwise from its recorded row."""


def _counter(name: str, help: str = ""):
    from coda_tpu_torch.telemetry.registry import get_registry

    return get_registry().counter(name, help)


# ---------------------------------------------------------------------------
# bitwise row verification (the heal contract)
# ---------------------------------------------------------------------------

def _f32_bits_equal(a, b) -> bool:
    return (np.float32(a).tobytes() == np.float32(b).tobytes())


def check_row(recorded: dict, replayed: dict, round_i: int,
              sid: str = "?") -> None:
    """Raise :class:`ReplayMismatch` naming the first diverging quantity.

    Integers compare exact; floats compare BITWISE (same-backend replay
    through the identical compiled step admits nothing less — and a NaN
    poisoned into the recorded stream can never silently verify against a
    finite replay)."""
    def _as_list(v):
        return list(v) if isinstance(v, (list, tuple)) else [v]

    for q in _INT_QUANTITIES:
        # batch-label rows carry q-wide lists (next_idx of a q>1 bucket);
        # compare element-exact either way
        rec_l, rep_l = _as_list(recorded[q]), _as_list(replayed[q])
        if len(rec_l) != len(rep_l) or any(
                int(x) != int(y) for x, y in zip(rec_l, rep_l)):
            raise ReplayMismatch(
                f"session {sid} round {round_i}: {q} recorded "
                f"{recorded[q]} != replayed {replayed[q]}")
    for q in _FLOAT_QUANTITIES:
        rec = recorded.get(q)
        rep = replayed.get(q)
        if rec is None and rep is None:
            continue  # method exposes no posterior digest
        if (rec is None) != (rep is None):
            raise ReplayMismatch(
                f"session {sid} round {round_i}: {q} present on only one "
                f"side (recorded {rec!r}, replayed {rep!r})")
        rec_l, rep_l = _as_list(rec), _as_list(rep)
        if len(rec_l) != len(rep_l) or any(
                not _f32_bits_equal(x, y) for x, y in zip(rec_l, rep_l)):
            raise ReplayMismatch(
                f"session {sid} round {round_i}: {q} recorded {rec!r} != "
                f"replayed {rep!r} (bitwise)")


def data_rows(rows) -> list:
    """The decision rows of a stream (meta/close marker lines dropped)."""
    return [r for r in (rows or []) if not r.get("kind")]


def last_digest(rows) -> Optional[tuple]:
    """The last recorded (pbest_max, pbest_entropy) of a stream, or None
    when the stream is empty or the method records no posterior digest."""
    rows = data_rows(rows)
    if not rows or rows[-1].get("pbest_max") is None:
        return None
    return (rows[-1]["pbest_max"], rows[-1].get("pbest_entropy"))


def _row_label_count(row: dict) -> int:
    """Oracle answers a stream row committed: q for a batch-label row
    (list-valued ``label``), else 1."""
    if not row.get("do_update"):
        return 0
    lab = row.get("label")
    return len(lab) if isinstance(lab, (list, tuple)) else 1


def _request_from_row(row: dict) -> dict:
    if row.get("do_update"):
        lab = row["label"]
        if isinstance(lab, (list, tuple)):
            # batch-label row (acq_batch > 1): the whole q-wide answer
            # set replays through one dispatch, like it was applied
            return {"do_update": True,
                    "idx": [int(v) for v in row["labeled_idx"]],
                    "label": [int(v) for v in lab],
                    "prob": [float(v) for v in row["prob"]]}
        return {"do_update": True, "idx": int(row["labeled_idx"]),
                "label": int(lab), "prob": float(row["prob"])}
    return {"do_update": False}


def replay_live_coalesced(bucket, live, *, dispatch, alive=None,
                          on_fail=None) -> int:
    """Drive many slots' recorded rows through ``bucket`` with ONE masked
    dispatch serving every live slot per round — the shared choreography
    of :func:`heal_bucket` and :func:`restore_app_sessions` (a serial
    per-session replay would run capacity-times more full-slab steps).

    ``live`` maps ``slot -> (sid, rows)`` and is MUTATED: a slot whose
    session dies mid-replay (``alive``) or fails is removed, so the caller
    reads the survivors out of it. ``dispatch(reqs)`` runs one coalesced
    round (the caller owns locking/flags). Without ``on_fail`` any failure
    raises — the heal contract, where one divergence invalidates the whole
    rebuild. With ``on_fail(sid, err)``, a :class:`ReplayMismatch` drops
    only that slot, and a dispatch-level error drops every slot in the
    round's request set then stops — the restore contract, where one
    corrupt stream must not brick the others. Returns the number of
    replayed rounds."""
    n = 0
    max_rounds = max((len(r) for _, r in live.values()), default=0)
    for k in range(max_rounds):
        reqs = {}
        for slot, (sid, rows) in list(live.items()):
            if k >= len(rows):
                continue
            if alive is not None and not alive(sid):
                # closed by its client mid-replay (close/release are
                # lock-free): a finished session needs no rebuild — its
                # slot's rows stay garbage until reallocation, like any
                # released slot
                del live[slot]
                continue
            reqs[slot] = _request_from_row(rows[k])
        if not reqs:
            break
        try:
            res = dispatch(reqs)
        except BaseException as e:
            if on_fail is None:
                raise
            # the bucket itself is down (the step tore its slab): every
            # session still rebuilding here fails attributably; the
            # caller's heal hook takes over
            for slot in list(reqs):
                sid, _ = live.pop(slot)
                on_fail(sid, e)
            break
        for slot in reqs:
            sid, rows = live[slot]
            try:
                check_row(rows[k], res[slot], k, sid=sid)
            except ReplayMismatch as e:
                if on_fail is None:
                    raise
                del live[slot]
                on_fail(sid, e)
        n = k + 1
    return n


def replay_rows_into_slot(bucket, slot: int, rows, sid: str = "?",
                          verify: bool = True) -> Optional[dict]:
    """Re-drive a session's recorded rows through the bucket's compiled
    step into ``slot`` (freshly staged with the session's init — see
    ``Bucket.stage_fresh``), one dispatch per row, verifying each round
    bitwise. Returns the last replayed result row."""
    last = None
    for k, row in enumerate(data_rows(rows)):
        with bucket.lock:
            res = bucket.dispatch({slot: _request_from_row(row)})[slot]
        if verify:
            check_row(row, res, k, sid=sid)
        last = res
    return last


def snapshot_fingerprint(bucket) -> dict:
    """The axes along which a slot snapshot is bit-portable: the port's
    backend (``torch-cuda``/``torch-cpu``) and torch version, the selector
    config, the padded shape and the step lowering."""
    import torch

    return {
        "backend": f"torch-{bucket.device.type}",
        "torch_version": torch.__version__,
        "method": bucket.spec.method,
        "spec_kwargs": [list(kv) for kv in bucket.spec.kwargs],
        "acq_batch": bucket.acq_batch,
        "shape": list(bucket.shape),
        "n_valid": bucket.n_valid,
        "step_impl": bucket.impl,
    }


# ---------------------------------------------------------------------------
# bucket self-healing
# ---------------------------------------------------------------------------

def heal_bucket(bucket, store, recorder) -> dict:
    """Rebuild a quarantined bucket's slab from its sessions' streams.

    Under the bucket lock: allocate a fresh slab, re-stage every live
    slot's init, then replay round-by-round — ONE dispatch serves every
    rebuilding slot per round (the same coalescing the serving path uses),
    with each slot's replayed row verified bitwise against its stream,
    posterior digest included. On full verification the quarantine lifts;
    a mismatch raises :class:`ReplayMismatch` (the caller degrades the
    bucket to terminal — a rebuild that cannot be verified must never
    silently re-admit)."""
    t0 = time.perf_counter()
    sessions = store.sessions_on(bucket)
    live = {
        s.slot: (s.sid, data_rows(recorder.history(s.sid)) or [])
        for s in sessions
    }
    with bucket.lock:
        # the quarantine flag stays SET for the whole rebuild: allocate()
        # never takes this lock (staged admission), so lifting the flag
        # early would let a concurrent open stage a write that our own
        # dispatches below apply into a slot mid-rebuild. Admissions stay
        # 503-refused until the rebuild is verified; our dispatches go
        # through the `_healing` override.
        bucket.reset_slab()
        for s in sessions:
            bucket.stage_fresh(s.slot, s.seed)
        # no on_fail: one divergence invalidates the WHOLE rebuild (the
        # caller degrades the bucket to terminal)
        n_replayed = replay_live_coalesced(
            bucket, live,
            dispatch=lambda reqs: bucket.dispatch(reqs, _healing=True),
            alive=store.alive)
        bucket.heals += 1
        bucket.quarantined = None
    return {"sessions": len(sessions), "rounds": n_replayed,
            "seconds": time.perf_counter() - t0}


class BucketHealer:
    """Runs :func:`heal_bucket` off the batcher thread when a dispatch
    quarantines a bucket, with bounded retries and exponential backoff.

    One heal thread per bucket at a time; a digest mismatch degrades the
    bucket to terminal immediately (an unverifiable rebuild must not
    serve), exhausted retries likewise — everything else re-admits. A
    bucket that keeps getting re-quarantined is capped at ``max_heals``
    lifetime rebuilds before degrading (a persistently failing step is a
    bug, not weather)."""

    def __init__(self, store, recorder, metrics=None, max_attempts: int = 3,
                 backoff_s: float = 0.05, max_heals: int = 8):
        self.store = store
        self.recorder = recorder
        self.metrics = metrics
        self.max_attempts = int(max_attempts)
        self.backoff_s = float(backoff_s)
        self.max_heals = int(max_heals)
        self._lock = threading.Lock()
        self._inflight: set = set()
        self.last_report: dict = {}

    def schedule(self, bucket, error: Optional[BaseException] = None,
                 sync: bool = False) -> bool:
        """Kick off a heal for ``bucket`` (idempotent while one is in
        flight). ``sync`` heals in the calling thread — the test hook."""
        with self._lock:
            if bucket.failed is not None or id(bucket) in self._inflight:
                return False
            if bucket.heals >= self.max_heals:
                bucket.failed = (
                    f"bucket exceeded {self.max_heals} slab rebuilds — "
                    f"persistent step failure (last: {error!r})")
                bucket.quarantined = None
                self._fail_metrics()  # terminal degradation must count
                return False          # like every other one
            self._inflight.add(id(bucket))
        _counter("serve_buckets_quarantined_total",
                 "Buckets quarantined by a step failure that tore the "
                 "slab").inc()
        if self.metrics is not None:
            self.metrics.record_recovery("quarantined")
        if sync:
            self._run(bucket)
            return True
        threading.Thread(target=self._run, args=(bucket,),
                         name=f"serve-heal-{bucket.task}",
                         daemon=True).start()
        return True

    def _run(self, bucket) -> None:
        try:
            last_err: Optional[BaseException] = None
            for attempt in range(self.max_attempts):
                try:
                    info = heal_bucket(bucket, self.store, self.recorder)
                except ReplayMismatch as e:
                    bucket.failed = (f"slab rebuild failed digest "
                                     f"verification: {e}")
                    bucket.quarantined = None
                    self._fail_metrics()
                    return
                except BaseException as e:
                    last_err = e
                    time.sleep(self.backoff_s * (2 ** attempt))
                    continue
                self.last_report = info
                _counter("serve_buckets_healed_total",
                         "Quarantined buckets rebuilt from session "
                         "streams and digest-verified").inc()
                if self.metrics is not None:
                    self.metrics.record_recovery("healed")
                return
            bucket.failed = (f"slab rebuild failed after "
                             f"{self.max_attempts} attempts: {last_err!r}")
            bucket.quarantined = None
            self._fail_metrics()
        finally:
            with self._lock:
                self._inflight.discard(id(bucket))

    def _fail_metrics(self) -> None:
        _counter("serve_heal_failures_total",
                 "Bucket rebuilds degraded to terminal (digest mismatch "
                 "or exhausted retries)").inc()
        if self.metrics is not None:
            self.metrics.record_recovery("heal_failed")
