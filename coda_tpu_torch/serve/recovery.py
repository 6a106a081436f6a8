"""Fault-tolerant serving: export/import, crash restore, self-healing
and offline stream verification (counterpart of ``coda_tpu/serve/
recovery.py``).

The posterior is the valuable state; the process and the slab are
disposable. Every live session has a per-round stream
(``SessionRecorder``), and a same-backend replay of it through the
bucket's step is bitwise, so:

  * :func:`export_session` serializes a session as a versioned payload
    (the reference's keys and :data:`SESSION_EXPORT_VERSION`): its
    stream plus a fingerprint-guarded snapshot of the slot's carries
    (``Bucket.snapshot_slot``). :func:`import_session` restores it on any
    server of the same task: the snapshot is written into the slot and
    accepted only when the slot's P(best) digest equals the stream's last
    recorded digest bitwise; otherwise (another fingerprint — every
    reference payload, whose backend is a JAX one — digest drift, no
    snapshot) the session is rebuilt by replaying its oracle answers
    through the bucket's step, every round verified bitwise. The session
    keeps its id.
  * :func:`heal_bucket` rebuilds a quarantined slab by replaying every
    live slot's stream, one dispatch per round for ALL slots;
    :class:`BucketHealer` runs it off the batcher thread.
  * :func:`restore_app_sessions` scans a ``--record-dir`` for streams
    without a close marker and replays them coalesced, in slab-sized
    waves paged out to the warm tier between waves.
  * :func:`replay_serve_main` (``python -m coda_tpu_torch.cli
    replay-serve <dir>``) verifies session streams against a fresh slab
    without a server.

A payload's arrays are base64 in JSON (``_pack``); the warm tier keeps
them as raw host arrays (``_pack(..., raw=True)``: the same keys, no
base64), and the HTTP edge encodes them (:func:`payload_to_json`) and
decodes them (:func:`payload_from_json`) a few MiB at a time, so no
format changes and no other request waits out a 2.7 GB body.
"""

from __future__ import annotations

import base64
import binascii
import json
import os
import re
import subprocess
import sys
import threading
import time
import uuid
from typing import Optional

import numpy as np

from coda_tpu_torch.serve.state import BucketQuarantined, SelectorSpec

#: bump on any change to the export payload's fields
SESSION_EXPORT_VERSION = 1

# the only session ids this package ever mints (uuid4 hex): imports must
# match, both because the HTTP routes can address nothing else and because
# the id lands in a recorder file path (session_<id>.jsonl)
_SID_RE = re.compile(r"^[0-9a-f]{1,64}$")

# result-row quantities a replayed round must reproduce bitwise
_INT_QUANTITIES = ("next_idx", "best")
_FLOAT_QUANTITIES = ("next_prob", "pbest_max", "pbest_entropy")


class ReplayMismatch(RuntimeError):
    """A replayed round diverged bitwise from its recorded row."""


class ImportRejected(ValueError):
    """The import payload cannot be restored here (wrong task/method/data,
    or its stream failed replay verification)."""


def _counter(name: str, help: str = ""):
    from coda_tpu_torch.telemetry import get_registry

    return get_registry().counter(name, help)


def _schema_version() -> int:
    from coda_tpu_torch.telemetry.recorder import SESSION_SCHEMA_VERSION

    return SESSION_SCHEMA_VERSION


def _stream_version_error(meta: dict) -> Optional[str]:
    """The schema-gate verdict for one session stream's meta, or None
    when it is replayable by this build: the current version always; the
    previous (pre-batching) version too, whose rows are a strict subset
    at acq_batch=1 — rejecting it would discard every in-flight session
    across a deploy. A v2 stream's missing ``acq_batch`` reads as 1; the
    q-mismatch against a batch server is caught by the acq_batch check,
    not mislabeled a schema problem."""
    from coda_tpu_torch.telemetry.recorder import SUPPORTED_SESSION_VERSIONS

    v = meta.get("v")
    if v is not None and v not in SUPPORTED_SESSION_VERSIONS:
        return (f"stream schema v{v}; this build replays "
                f"v{list(SUPPORTED_SESSION_VERSIONS)}")
    return None


# ---------------------------------------------------------------------------
# array <-> JSON-safe codec for snapshot carries
# ---------------------------------------------------------------------------

def _pack(arr, raw: bool = False) -> dict:
    """One array as ``{"dtype", "shape", "data"}``: ``data`` base64 text
    (JSON-safe), or with ``raw`` the host array itself (the warm tier's
    form: no copy, no base64)."""
    a = np.asarray(arr)
    # ascontiguousarray PROMOTES 0-d arrays to (1,); reshape back so a
    # scalar state leaf (the surrogate fit's counters) round-trips with
    # its rank intact — the import-side structural guard compares shapes
    a = np.ascontiguousarray(a).reshape(a.shape)
    return {"dtype": str(a.dtype), "shape": list(a.shape),
            "data": a if raw else
            base64.b64encode(a.tobytes()).decode("ascii")}


def _unpack(d: dict) -> np.ndarray:
    data = d["data"]
    if isinstance(data, np.ndarray):
        # a warm-tier leaf: the snapshot's own host array, only read
        return data.reshape(d["shape"])
    if isinstance(data, str):
        data = base64.b64decode(data)
    # raw bytes pass through untouched — the spill store's lazy frames
    # (serve/spill.py) hand the decompressed leaf bytes over directly,
    # skipping the base64 round trip the JSON transport needs
    return np.frombuffer(
        data, dtype=np.dtype(d["dtype"])).reshape(d["shape"])


# ---------------------------------------------------------------------------
# the HTTP edge: a payload <-> its JSON body. A headline slot is 2.7 GB of
# base64. json's scanner and encoder and binascii hold the GIL for a whole
# call, and a thread that holds it without pause makes every other thread
# wait the interpreter's switch interval (5 ms) at each of its releases,
# which the batcher makes at every tensor operation: a dispatch then takes
# seconds. So a large string stays out of json, numpy finds the strings
# (its loops release the GIL), and base64 runs in child processes fed
# through pipes (whose reads and writes release it too).
# ---------------------------------------------------------------------------

# a string at least this long is lifted out of a body before json parses
# it, and an array at least this long is coded in a child process
_BLOB_MIN = 1 << 20
# the child codes this many bytes at a time (a multiple of 3)
_PIECE = 3 << 20
# one pipe write, one search for quotes: this many bytes
_SCAN = 8 << 20
# children a large array is split between (half the host's cores, at most 4)
_CHILDREN = min(4, max(1, (os.cpu_count() or 2) // 2))

_CODEC = """
import binascii, sys
enc, n = sys.argv[1] == "encode", int(sys.argv[2])
r, w = open(0, "rb", buffering=0), open(1, "wb", buffering=0)
buf = bytearray(n if enc else n // 3 * 4)
mv = memoryview(buf)
while True:
    k = 0
    while k < len(buf):
        got = r.readinto(mv[k:])
        if not got:
            break
        k += got
    if not k:
        break
    out = memoryview(binascii.b2a_base64(mv[:k], newline=False) if enc
                     else binascii.a2b_base64(mv[:k]))
    while out:
        out = out[w.write(out):]
    if k < len(buf):
        break
"""


def _b64_child(src, dst, encode: bool) -> int:
    """Base64-encode (or decode) the bytes-like ``src`` into the writable
    ``dst`` in a child process; the bytes written, or -1 when the child
    failed or wrote more than ``dst`` holds."""
    proc = subprocess.Popen(
        [sys.executable, "-c", _CODEC, "encode" if encode else "decode",
         str(_PIECE)], stdin=subprocess.PIPE, stdout=subprocess.PIPE,
        stderr=subprocess.DEVNULL, bufsize=0)
    src = memoryview(src).cast("B")

    def feed():
        try:
            for j in range(0, len(src), _SCAN):
                piece = src[j:j + _SCAN]
                while piece:
                    piece = piece[proc.stdin.write(piece):]
        except OSError:
            pass         # the child is gone: its exit code says why
        finally:
            proc.stdin.close()

    th = threading.Thread(target=feed, daemon=True)
    th.start()
    dst, o = memoryview(dst).cast("B"), 0
    try:
        while o < len(dst):
            got = proc.stdout.readinto(dst[o:])
            if not got:
                break
            o += got
        if proc.stdout.read(1):
            o = -1
    finally:
        if o < 0:
            proc.kill()
        proc.stdout.close()
        th.join()
        if proc.wait() != 0:
            o = -1
    return o


def _b64(src, dst, encode: bool) -> bool:
    """:func:`_b64_child` over ``_CHILDREN`` children, each a contiguous
    part of ``src`` (whole 3-byte groups, or 4-character groups, so only
    the last part pads); whether every part filled its part of ``dst``
    exactly."""
    src, dst = memoryview(src).cast("B"), memoryview(dst).cast("B")
    unit, out_unit = (3, 4) if encode else (4, 3)
    step = max(unit, -(-len(src) // _CHILDREN // unit) * unit)
    parts = [(src[j:j + step], dst[j // unit * out_unit:
                                   len(dst) if j + step >= len(src)
                                   else (j + step) // unit * out_unit])
             for j in range(0, len(src), step)]
    ok = [False] * len(parts)

    def run(i):
        ok[i] = _b64_child(*parts[i], encode) == len(parts[i][1])

    threads = [threading.Thread(target=run, args=(i,), daemon=True)
               for i in range(len(parts))]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    return all(ok) and sum(len(d) for _, d in parts) == len(dst)


def _holes(payload, fill) -> dict:
    """The top level of ``payload`` with each packed array (a value, or
    every item of a list) replaced by ``fill(packed)``: the places
    :func:`~coda_tpu_torch.serve.spill.materialize` encodes."""
    from coda_tpu_torch.serve.spill import _is_packed

    out = {}
    for k in payload:
        v = payload[k]
        if _is_packed(v):
            v = fill(v)
        elif isinstance(v, (list, tuple)) and v and all(
                _is_packed(c) for c in v):
            v = [fill(c) for c in v]
        out[k] = v
    return out


def payload_to_json(payload) -> memoryview:
    """``json.dumps(materialize(payload)).encode()``, byte for byte, with
    each large array's base64 written by child processes straight into the
    body (the export route's encoder; ``payload`` raw, packed or a spilled
    one)."""
    from coda_tpu_torch.serve.spill import _raw_bytes

    tag, blobs = uuid.uuid4().hex, []

    def hole(d):
        data = d["data"]
        blobs.append(data if isinstance(data, str)
                     else memoryview(_raw_bytes(data)).cast("B"))
        return {"dtype": d["dtype"], "shape": list(d["shape"]),
                "data": f"{tag}{len(blobs) - 1}"}

    text = json.dumps(_holes(payload, hole)).encode()
    marks = [f'"{tag}{i}"'.encode() for i in range(len(blobs))]
    sizes = [len(b) if isinstance(b, str) else 4 * -(-b.nbytes // 3)
             for b in blobs]
    out = np.empty(len(text) + sum(sizes) - sum(len(m) - 2 for m in marks),
                   np.uint8)
    pos = o = 0
    for blob, mark, size in zip(blobs, marks, sizes):
        at = text.index(mark, pos) + 1       # just past the opening quote
        out[o:o + at - pos] = np.frombuffer(text, np.uint8, at - pos, pos)
        o += at - pos
        if isinstance(blob, str):
            out[o:o + size] = np.frombuffer(blob.encode("ascii"), np.uint8)
        elif blob.nbytes < _BLOB_MIN:
            out[o:o + size] = np.frombuffer(
                binascii.b2a_base64(blob, newline=False), np.uint8)
        elif not _b64(blob, out[o:o + size], encode=True):
            raise RuntimeError("a base64 encoder process failed")
        o += size
        pos = at + len(mark) - 2             # the closing quote
    out[o:] = np.frombuffer(text, np.uint8, len(text) - pos, pos)
    return memoryview(out)


def _marks(arr: np.ndarray) -> np.ndarray:
    """Where the uint8 ``arr`` holds a quote or a backslash, in order,
    searched ``_SCAN`` bytes at a time."""
    found = []
    for j in range(0, len(arr), _SCAN):
        p = arr[j:j + _SCAN]
        m = (p == 0x22) | (p == 0x5C)
        if m.any():
            found.append(np.flatnonzero(m) + j)
    return np.concatenate(found) if found else np.zeros(0, np.int64)


def _b64_bytes(arr: np.ndarray, a: int, b: int):
    """The bytes the base64 text ``arr[a:b]`` encodes, decoded by child
    processes (``base64.b64decode`` of the whole where the text is not
    canonical, so the result is the reference's)."""
    n = b - a
    if n % 4 == 0:
        pad = int(n >= 1 and arr[b - 1] == 0x3D) + int(
            n >= 2 and arr[b - 2] == 0x3D)
        out = np.empty(n // 4 * 3 - pad, np.uint8)
        if _b64(arr[a:b], out, encode=False):
            return memoryview(out)
    return base64.b64decode(arr[a:b].tobytes())


def payload_from_json(raw) -> dict:
    """``json.loads(raw)`` for an import body (any bytes-like), with every
    string of ``_BLOB_MIN`` bytes or more and no escape lifted out before
    the parse, and each array's base64 decoded by child processes into raw
    bytes, which :func:`_unpack` takes as they are (the import route's
    decoder)."""
    if len(raw) < _BLOB_MIN:
        return json.loads(bytes(raw) or b"{}")
    arr = np.frombuffer(raw, np.uint8)
    at = _marks(arr)
    marks, quote = at.tolist(), (arr[at] == 0x22).tolist()
    spans, q, esc, i = [], -1, False, 0
    while i < len(marks):
        p = marks[i]
        if not quote[i]:                     # a backslash
            if q >= 0:
                esc = True
                if i + 1 < len(marks) and marks[i + 1] == p + 1:
                    i += 1                   # the character it escapes
        elif q < 0:
            q, esc = p, False                # a string opens
        else:
            if p - q - 1 >= _BLOB_MIN and not esc:
                spans.append((q + 1, p))
            q = -1                           # and closes
        i += 1
    tag, parts, keep = uuid.uuid4().hex, [], 0
    for k, (a, b) in enumerate(spans):
        parts += [arr[keep:a].tobytes(), f"{tag}{k}".encode()]
        keep = b
    parts.append(arr[keep:].tobytes())
    obj = json.loads(b"".join(parts))

    def span(v):
        if isinstance(v, str) and len(v) > len(tag) and v[:len(tag)] == tag \
                and v[len(tag):].isdigit():
            return spans[int(v[len(tag):])]
        return None

    def text(v):                             # a lifted string put back
        if isinstance(v, dict):
            return {text(k): text(x) for k, x in v.items()}
        if isinstance(v, list):
            return [text(x) for x in v]
        s = span(v)
        return v if s is None else arr[s[0]:s[1]].tobytes().decode("utf-8")

    def array(d):
        s = span(d["data"])
        return d if s is None else dict(d, data=_b64_bytes(arr, *s))

    return text(_holes(obj, array) if isinstance(obj, dict) else obj)


# ---------------------------------------------------------------------------
# bitwise row verification (the restore/heal contract)
# ---------------------------------------------------------------------------

def _f32_bits_equal(a, b) -> bool:
    return (np.float32(a).tobytes() == np.float32(b).tobytes())


def check_row(recorded: dict, replayed: dict, round_i: int,
              sid: str = "?") -> None:
    """Raise :class:`ReplayMismatch` naming the first diverging quantity.

    Integers compare exact; floats compare BITWISE (same-backend replay
    through the identical step admits nothing less — and a NaN
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
            # session still rebuilding here fails
            # attributably; the caller's heal hook takes over
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
    """Re-drive a session's recorded rows through the bucket's step into
    ``slot`` (freshly staged with the session's init — see
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


# ---------------------------------------------------------------------------
# export
# ---------------------------------------------------------------------------

def snapshot_fingerprint(bucket) -> dict:
    """The axes along which a slot snapshot is bit-portable: the port's
    backend (``torch-cuda``/``torch-cpu``) and torch version, the selector
    config, the padded shape and the step lowering. Anything else (every
    reference payload among them) restores via the replay path."""
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


def build_export_payload(app, sess, snapshot=None, raw: bool = False
                         ) -> dict:
    """The serialization shared by ``POST /session/{id}/export`` and the
    warm-tier demotion (serve/tiering.py — a demoted session IS its export
    payload, minus the HTTP hop). Caller has resolved ``sess`` and
    guaranteed it stays resident for the duration (a pin, or the export
    verb's own lookup). ``snapshot`` injects a pre-taken
    ``(leaves, key)`` (the sweeper's batched ``snapshot_slots``) instead
    of reading the slab here. ``raw`` keeps the arrays as host arrays
    (the warm tier's form)."""
    bucket = sess.bucket
    payload = {
        "v": SESSION_EXPORT_VERSION,
        "kind": "session_export",
        "session": sess.sid,
        "task": sess.task,
        "method": bucket.spec.method,
        "spec_kwargs": [list(kv) for kv in bucket.spec.kwargs],
        "acq_batch": bucket.acq_batch,
        "seed": sess.seed,
        # ownership epoch: preserved verbatim by demote/wake round trips;
        # only the router's migration commit bumps it (fencing)
        "epoch": sess.epoch,
        "dataset": {k: app.store.task_meta(sess.task).get(k)
                    for k in ("shape", "digest")},
        "fingerprint": snapshot_fingerprint(bucket),
        "carries": None,
        "key": None,
    }
    if sess.prior_fit is not None:
        # the applied-prior record rides the payload so the import-side
        # REPLAY fallback (and any later heal on the destination) seeds
        # the same init this session was admitted with
        payload["prior_fit"] = dict(sess.prior_fit)
    if sess.prior_contributed:
        # the once-flag rides too: a demoted session contributes at
        # demotion, and a later wake+close must not fold it in twice
        payload["prior_contributed"] = True
    # snapshot FIRST (a consistent host copy under the bucket lock — see
    # Bucket.snapshot_slot), stream second: if a dispatch lands between
    # the two, the stream is ahead of the snapshot, the import-side digest
    # check fails, and restore falls back to the replay path
    try:
        leaves, key = (snapshot if snapshot is not None
                       else bucket.snapshot_slot(sess.slot))
        payload["carries"] = [_pack(x, raw=raw) for x in leaves]
        payload["key"] = _pack(key, raw=raw)
    except (BucketQuarantined, RuntimeError):
        pass  # slab lost: the stream-only export is still complete
    rows = data_rows(app.recorder.history(sess.sid))
    payload["rows"] = rows
    payload["n_labeled"] = sum(_row_label_count(r) for r in rows)
    payload["last"] = dict(rows[-1]) if rows else None
    # parked per-slot crowd answers of the CURRENT round (the async
    # answer verb): they ride the payload so a migration loses none
    with app.store.lock:
        if sess.parked:
            payload["parked"] = {str(j): dict(e)
                                 for j, e in sess.parked.items()}
    return payload


def export_session(app, sid: str, raw: bool = False) -> dict:
    """Serialize one live session as a self-contained, versioned payload.

    Always carries the recorder stream (the portable, replayable session
    log — ``n_labeled``/``last`` are derived from it, the single source of
    truth). When the slab is readable, also a fingerprint-guarded snapshot
    of the slot's carries for the import fast path; a quarantined bucket
    exports stream-only (the stream IS the session). Leaves the session
    live — the drain flow closes it separately once the peer confirms the
    import."""
    sess = app.store.get(sid)
    if sess.restoring:
        # mid-restore the slot and the recorder history are half-built;
        # an export now would serialize an empty stream as the session
        raise BucketQuarantined(
            f"session {sid} is being restored; retry shortly")
    payload = build_export_payload(app, sess, raw=raw)
    app.metrics.record_recovery("exported")
    _counter("serve_sessions_exported_total",
             "Sessions serialized for checkpoint/migration").inc()
    return payload


def export_all(app) -> list[dict]:
    """Export every open session — resident AND parked (the drain/migrate
    sweep; a rolling restart must carry all three tiers). A session closed
    by its client between the listing and its export is skipped — a
    finished session needs no migration."""
    from coda_tpu_torch.serve.state import UnknownSession

    with app.store.lock:
        sids = list(app.store._sessions)
    out = []
    for sid in sids:
        try:
            out.append(export_session(app, sid))
        except UnknownSession:
            pass
    tiers = getattr(app, "tiers", None)
    if tiers is not None:
        seen = {p["session"] for p in out}
        out += [p for p in tiers.export_parked()
                if p["session"] not in seen]
    return out


# ---------------------------------------------------------------------------
# import / restore
# ---------------------------------------------------------------------------

def _fingerprint_compatible(fp: dict, bucket) -> bool:
    return fp == snapshot_fingerprint(bucket)


def _close_quietly(store, sid: str) -> None:
    """Cleanup close on an error path: a racing client DELETE may have
    already popped the sid — that must not mask the original error."""
    try:
        store.close(sid)
    except Exception:
        pass


def _finalize_restored(sess, rows) -> None:
    """Rebuild a restored session's host bookkeeping from its rows:
    label count, last result row, and the idempotency cache — a label the
    client retries across the migration must dedupe on the new server."""
    sess.n_labeled = sum(_row_label_count(r) for r in rows)
    sess.last = dict(rows[-1]) if rows else {}
    for row in rows:
        rid = row.get("request_id")
        if rid:
            sess.recent[rid] = {
                k: row.get(k) for k in ("next_idx", "next_prob",
                                        "best", "stochastic",
                                        "pbest_max", "pbest_entropy")}


def _repark_answers(app, sess, parked) -> None:
    """Re-park a restored session's pending per-slot crowd answers (the
    async answer verb) and re-stream their park rows — the restored
    stream is rewritten from data rows only, and a crash after THIS
    restore must find the parks again (0 lost answers, the robustness
    artifact's bound)."""
    if not parked:
        return
    q = sess.bucket.acq_batch
    round_idx = sess.n_labeled // q
    entries = {}
    for j, e in parked.items():
        j = int(j)
        if 0 <= j < q:
            entries[j] = {"label": int(e["label"]),
                          "request_id": e.get("request_id"),
                          "seq": int(e.get("seq", 0))}
    with app.store.lock:
        sess.parked = entries
        sess.park_seq = 1 + max((e["seq"] for e in entries.values()),
                                default=-1)
    for j in sorted(entries):
        e = entries[j]
        app.recorder.append(sess.sid, {
            "kind": "answer_park", "session": sess.sid,
            "round": round_idx, "slot": j, "label": e["label"],
            "request_id": e.get("request_id"), "seq": e["seq"]})


def parked_from_rows(raw_rows, n_rounds: int) -> dict:
    """The pending per-slot answers of a raw stream: ``answer_park`` rows
    addressed to the CURRENT round (``round == n_rounds`` — parks of
    completed rounds are superseded by their data row). Later rows win a
    slot (re-park after a failed drain)."""
    parked = {}
    for r in (raw_rows or []):
        if r.get("kind") != "answer_park":
            continue
        if int(r.get("round", -1)) != n_rounds:
            continue
        parked[int(r["slot"])] = {"label": r.get("label"),
                                  "request_id": r.get("request_id"),
                                  "seq": int(r.get("seq", 0))}
    return parked


def import_session(app, payload: dict, count: bool = True) -> dict:
    """Restore an exported session into this server; returns
    ``{restored_via, session, n_labeled, rounds}``.

    Restore order: (1) snapshot fast path — carries present AND
    fingerprint matches this bucket AND the standalone posterior digest of
    the written slot equals the stream's last recorded digest bitwise;
    (2) replay path — re-drive the stream through the bucket's compiled
    step from the session's init, every round verified bitwise. A session
    that fails both is rejected whole (attributable), never half-admitted.

    ``count=False`` skips the open/imported metrics — the tier wake path
    (serve/tiering.py) restores through here but counts its own events
    (a wake is a page-in, not a new session).
    """
    if payload.get("v") != SESSION_EXPORT_VERSION:
        raise ImportRejected(
            f"export payload v={payload.get('v')!r}; this build imports "
            f"v{SESSION_EXPORT_VERSION}")
    task = payload["task"]
    if task not in app.store.tasks():
        raise ImportRejected(f"task {task!r} is not registered here")
    meta = app.store.task_meta(task)
    want_ds = payload.get("dataset") or {}
    if want_ds.get("digest") and want_ds["digest"] != meta.get("digest"):
        raise ImportRejected(
            f"dataset digest mismatch for task {task!r}: session was "
            f"served on {want_ds['digest']}, this server has "
            f"{meta.get('digest')} — restoring against different data "
            "answers a different question")
    if payload["method"] != app.spec.method or \
            [list(kv) for kv in app.spec.kwargs] != payload["spec_kwargs"]:
        raise ImportRejected(
            f"selector config mismatch: session ran "
            f"{payload['method']}{payload['spec_kwargs']}, this server "
            f"serves {app.spec.method}{[list(k) for k in app.spec.kwargs]}")
    want_q = int(payload.get("acq_batch", 1))
    if want_q != app.spec.acq_batch:
        # a q-mismatched import would replay q-wide rows through a
        # differently-shaped compiled step — reject with the real reason
        raise ImportRejected(
            f"acq_batch mismatch: session batches {want_q} label(s) per "
            f"round, this server serves acq_batch={app.spec.acq_batch}")
    sid = payload.get("session")
    if not isinstance(sid, str) or not _SID_RE.match(sid):
        # an unchecked id would flow into a recorder file path AND create
        # a session the hex-only HTTP routes can never address again
        raise ImportRejected(
            f"invalid session id {sid!r}: expected the lowercase-hex id "
            "the export was taken under")
    rows = data_rows(payload.get("rows"))
    # published gated: the sid is addressable from here (the client's
    # handle must resolve), but labels answer retryable 503 until the
    # posterior AND the request_id dedupe cache are rebuilt — a retry
    # landing mid-restore must neither 404 nor double-apply
    # the imported copy's prior is the RECORDED one (payload), never the
    # pool's current state — replay must reproduce the admitted init
    sess = app.store.open(task, app.spec, seed=int(payload["seed"]),
                          sid=sid, restoring=True,
                          prior=payload.get("prior_fit"))
    # the copy's ownership epoch is the payload's — set before the verbs
    # unblock so a fenced verb can never race an un-epoched window
    sess.epoch = int(payload.get("epoch") or 0)
    sess.prior_contributed = bool(payload.get("prior_contributed"))
    bucket = sess.bucket
    try:
        restored_via = None
        want = last_digest(rows)
        if payload.get("carries") is not None and want is not None \
                and _fingerprint_compatible(payload.get("fingerprint")
                                            or {}, bucket):
            # write the snapshot into the (gated) slot's own tensors, then
            # read the slot's digest: accepted only on a bitwise match
            # with the stream's last row. A mismatch leaves nothing
            # behind — the replay below restages the init over it.
            try:
                bucket.restore_slot(sess.slot,
                                    [_unpack(d) for d in payload["carries"]],
                                    _unpack(payload["key"]))
                with bucket.lock:
                    got = bucket.digest(sess.slot)
            except ValueError:
                got = None   # not this bucket's state structure
            if got is not None and _f32_bits_equal(got[0], want[0]) \
                    and _f32_bits_equal(got[1], want[1]):
                restored_via = "snapshot"
        # no digest on either side -> the snapshot is UNVERIFIABLE; the
        # replay path verifies every round
        if restored_via is None:
            bucket.stage_fresh(sess.slot, sess.seed, prior=sess.prior_fit)
            replay_rows_into_slot(bucket, sess.slot, rows, sid=sess.sid)
            restored_via = "replay"
        _finalize_restored(sess, rows)
        app.recorder.import_history(
            sess.sid, meta={"task": task, "method": payload["method"],
                            "spec_kwargs": payload["spec_kwargs"],
                            "acq_batch": want_q,
                            "seed": sess.seed,
                            "epoch": sess.epoch,
                            "shape": meta.get("shape"),
                            "digest": meta.get("digest"),
                            **({"surrogate_prior": dict(sess.prior_fit)}
                               if sess.prior_fit is not None else {}),
                            "imported_via": restored_via},
            rows=rows)
        # pending async crowd answers ride the payload; import_history
        # rewrote the stream from data rows only, so re-stream the parks
        _repark_answers(app, sess, payload.get("parked") or {})
    except ReplayMismatch as e:
        _close_quietly(app.store, sess.sid)
        raise ImportRejected(f"stream failed replay verification: {e}")
    except BaseException:
        _close_quietly(app.store, sess.sid)
        raise
    sess.restoring = False  # fully rebuilt: labels flow again
    if count:
        app.metrics.record_session("open")  # pairs with close's 'close'
        app.metrics.record_recovery("imported")
        _counter("serve_sessions_imported_total",
                 "Sessions restored from checkpoint/migration "
                 "payloads").inc()
    return {"restored_via": restored_via, "session": sess.sid,
            "n_labeled": sess.n_labeled, "rounds": len(rows)}


# ---------------------------------------------------------------------------
# crash restore: rebuild live sessions from a --record-dir
# ---------------------------------------------------------------------------

def load_session_stream(path: str):
    """``(meta, rows, closed)`` from one ``session_<id>.jsonl``.

    Crash-tolerant: a process killed mid-write leaves at most one
    truncated FINAL line, which is dropped; a torn line anywhere else is
    real corruption and raises."""
    meta: dict = {}
    rows: list = []
    closed = False
    with open(path) as f:
        lines = f.read().splitlines()
    for i, line in enumerate(lines):
        if not line.strip():
            continue
        try:
            row = json.loads(line)
        except ValueError:
            if i == len(lines) - 1:
                break  # torn final line: the crash the recorder flushes for
            raise
        kind = row.get("kind")
        if kind == "session_meta":
            meta = row
        elif kind == "session_close":
            closed = True
        else:
            rows.append(row)
            # a data row AFTER a close marker means the stream was resumed
            # (same-dir migration): the session is live again
            closed = False
    return meta, rows, closed


def iter_session_streams(record_dir: str):
    """Yield ``(sid, path)`` for every session stream in a record dir."""
    for fn in sorted(os.listdir(record_dir)):
        if fn.startswith("session_") and fn.endswith(".jsonl"):
            yield fn[len("session_"):-len(".jsonl")], \
                os.path.join(record_dir, fn)


def restore_app_sessions(app, record_dir: Optional[str] = None) -> dict:
    """Restore every un-closed session stream found in ``record_dir``
    (default: the app's own recorder directory) — the crash-restart path.

    Each wave: every restorable stream is first admitted GATED
    (``Session.restoring`` — the sid resolves, labels answer retryable
    503), then all sessions sharing a bucket are replayed COALESCED —
    one masked slab dispatch serves every restoring slot per round, the
    same choreography :func:`heal_bucket` uses. A serial
    per-session replay would run ``capacity`` times more full-slab steps
    at exactly the moment (crash under full load) this path exists for.

    With tiering enabled (``app.tiers``), MORE streams than slab capacity
    restore in waves: each restored wave is demoted to the warm tier
    before the next wave admits, so a crash of a beyond-capacity server
    restarts with its whole open-session population intact (hot set
    re-forms on demand via wake-on-label). Hibernated sessions carry a
    close marker and are correctly skipped — their spill files are the
    authority and the TierManager re-indexes them at startup.

    Per-session failures are collected, not raised: one corrupt stream
    must not brick the whole restart. Returns
    ``{restored: [sid], skipped_closed: n, failed: {sid: reason}}``."""
    d = record_dir or app.recorder.out_dir
    report = {"restored": [], "skipped_closed": 0, "failed": {}}
    if not d or not os.path.isdir(d):
        return report
    # phase 1: validate every stream (no admission yet)
    pending: list = []         # (sid, meta, rows)
    for sid, path in iter_session_streams(d):
        try:
            meta, rows, closed = load_session_stream(path)
        except Exception as e:
            report["failed"][sid] = f"unreadable stream: {e}"
            continue
        v_err = _stream_version_error(meta)
        if v_err is not None:
            # an unsupported stream version would replay with missing/
            # mis-shaped fields and misreport them as divergence — name
            # the real incompatibility instead
            report["failed"][sid] = v_err
            continue
        if closed:
            report["skipped_closed"] += 1
            continue
        if app.store.alive(sid):
            continue  # already live (e.g. double restore call)
        if not _SID_RE.match(sid):
            report["failed"][sid] = f"invalid session id {sid!r} in stream"
            continue
        raw_rows, rows = rows, data_rows(rows)
        # pending async crowd answers live in answer_park kind-rows of the
        # CURRENT round; rebuild them after replay so a crash between an
        # answer arriving and its round completing loses nothing
        n_rounds = (sum(_row_label_count(r) for r in rows)
                    // max(1, int(meta.get("acq_batch", 1))))
        parked = parked_from_rows(raw_rows, n_rounds)
        task = meta.get("task")
        try:
            if task not in app.store.tasks():
                raise ImportRejected(f"task {task!r} is not registered "
                                     "here")
            want_dg = meta.get("digest")
            have_dg = app.store.task_meta(task).get("digest")
            if want_dg and want_dg != have_dg:
                raise ImportRejected(
                    f"dataset digest mismatch for task {task!r}: stream "
                    f"was recorded on {want_dg}, this server has {have_dg}")
            if meta.get("method") and meta["method"] != app.spec.method:
                raise ImportRejected(
                    f"selector config mismatch: stream ran "
                    f"{meta['method']}, this server serves "
                    f"{app.spec.method}")
            want_kw = meta.get("spec_kwargs")
            have_kw = [list(kv) for kv in app.spec.kwargs]
            if want_kw is not None and [list(kv) for kv in want_kw] \
                    != have_kw:
                # without this, a kwargs-mismatched restart surfaces as
                # a per-round "bitwise divergence" instead of the named
                # config error (import_session already checks both)
                raise ImportRejected(
                    f"selector config mismatch: stream ran "
                    f"{meta['method']}{want_kw}, this server serves "
                    f"{app.spec.method}{have_kw}")
            # a v2 (pre-batching) stream carries no acq_batch: it is an
            # acq_batch=1 stream by construction
            want_q = int(meta.get("acq_batch", 1))
            if want_q != app.spec.acq_batch:
                raise ImportRejected(
                    f"acq_batch mismatch: stream batches {want_q} "
                    f"label(s) per round, this server serves "
                    f"acq_batch={app.spec.acq_batch}")
        except Exception as e:
            report["failed"][sid] = repr(e)
            continue
        pending.append((sid, meta, rows, parked))
    # phase 2: admit + replay in slab-sized waves (one wave = the whole
    # set when everything fits; beyond-capacity restarts need app.tiers)
    tiers = getattr(app, "tiers", None)
    wave_size = max(1, int(app.store.capacity))
    while pending:
        wave, pending = pending[:wave_size], pending[wave_size:]
        staged: list = []      # (sess, rows, meta, parked)
        for sid, meta, rows, parked in wave:
            try:
                # the stream meta's applied-prior record (if the session
                # was admitted prior-seeded) re-applies here — the pool
                # may have moved on, this session's history has not
                sess = app.store.open(meta.get("task"), app.spec,
                                      seed=int(meta.get("seed", 0)),
                                      sid=sid, restoring=True,
                                      prior=meta.get("surrogate_prior"))
                # a crash-restored copy keeps its stream's ownership
                # epoch: if the session had migrated away and this stream
                # was never fenced (the crash window), the restored copy
                # is STALE and the epoch makes the fence still hold
                sess.epoch = int(meta.get("epoch") or 0)
                sess.bucket.stage_fresh(sess.slot, sess.seed,
                                        prior=sess.prior_fit)
            except Exception as e:
                report["failed"][sid] = repr(e)
                continue
            staged.append((sess, rows, meta, parked))
        # coalesced bitwise-verified replay, one dispatch per round per
        # bucket; a diverging stream fails ONLY its session
        by_bucket: dict = {}
        for sess, rows, meta, parked in staged:
            by_bucket.setdefault(
                id(sess.bucket), (sess.bucket, []))[1].append(
                    (sess, rows, meta, parked))
        for bucket, items in by_bucket.values():
            live = {sess.slot: (sess.sid, rows)
                    for sess, rows, _, _ in items}

            def locked_dispatch(reqs, _bucket=bucket):
                with _bucket.lock:
                    return _bucket.dispatch(reqs)

            def on_fail(sid, e):
                if isinstance(e, ReplayMismatch):
                    report["failed"][sid] = repr(ImportRejected(
                        f"stream failed replay verification: {e}"))
                else:
                    report["failed"][sid] = f"restore dispatch failed: {e!r}"
                _close_quietly(app.store, sid)

            # per-session isolation: a diverging stream fails ONLY its
            # session (restoring sessions are close-gated, so no `alive`
            # check needed)
            replay_live_coalesced(bucket, live, dispatch=locked_dispatch,
                                  on_fail=on_fail)
            for sess, rows, meta, parked in items:
                if sess.slot not in live:
                    continue
                _finalize_restored(sess, rows)
                app.recorder.import_history(
                    sess.sid, meta={"task": sess.task,
                                    "method": meta.get("method")
                                    or app.spec.method,
                                    "spec_kwargs": meta.get("spec_kwargs")
                                    or [list(kv) for kv in app.spec.kwargs],
                                    "acq_batch": app.spec.acq_batch,
                                    "seed": sess.seed,
                                    "epoch": sess.epoch,
                                    "shape": meta.get("shape"),
                                    "digest": meta.get("digest"),
                                    **({"surrogate_prior":
                                        dict(sess.prior_fit)}
                                       if sess.prior_fit is not None
                                       else {}),
                                    "imported_via": "replay"},
                    rows=rows)
                _repark_answers(app, sess, parked)
                sess.restoring = False
                report["restored"].append(sess.sid)
                app.metrics.record_session("open")
                app.metrics.record_recovery("restored")
                _counter("serve_sessions_restored_total",
                         "Sessions rebuilt from their JSONL streams after "
                         "a crash").inc()
        if pending and tiers is not None:
            # make room for the next wave: page this one out to warm (it
            # just replayed, so its payload is a verified snapshot); the
            # hot set re-forms on demand via wake-on-label. Batched per
            # bucket — one slab snapshot demotes the whole wave — and
            # unstarted sessions (a stream with zero data rows) demote
            # too, or their slots would starve every later wave.
            demote_by_bucket: dict = {}
            for sess, rows, meta, parked in staged:
                if app.store.alive(sess.sid):
                    demote_by_bucket.setdefault(
                        id(sess.bucket), (sess.bucket, []))[1].append(
                            sess.sid)
            for bucket, wave_sids in demote_by_bucket.values():
                tiers.demote_batch(bucket, wave_sids,
                                   allow_unstarted=True)
    return report


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
            # re-apply each session's RECORDED admission prior: a heal
            # replays from the admitted init, and a prior-seeded session
            # healed cold would diverge bitwise on its first verify row
            bucket.stage_fresh(s.slot, s.seed, prior=s.prior_fit)
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


# ---------------------------------------------------------------------------
# offline stream verification: `python -m coda_tpu_torch.cli replay-serve`
# ---------------------------------------------------------------------------

def verify_session_stream(store, meta: dict, rows, sid: str = "?") -> dict:
    """Replay one stream into a fresh slab slot and verify it bitwise.

    Returns ``{parity, rounds}``; raises :class:`ReplayMismatch` (or
    ValueError for a structurally unusable stream) otherwise."""
    v_err = _stream_version_error(meta)
    if v_err is not None:
        raise ValueError(v_err)
    task = meta.get("task")
    if task not in store.tasks():
        raise ValueError(f"stream's task {task!r} not loaded")
    want = meta.get("digest")
    have = store.task_meta(task).get("digest")
    if want and want != have:
        raise ValueError(
            f"dataset digest mismatch: stream recorded {want}, loaded "
            f"data hashes to {have}")
    kwargs = {k: v for k, v in (meta.get("spec_kwargs") or [])}
    spec = SelectorSpec.create(meta.get("method", "coda"),
                               acq_batch=int(meta.get("acq_batch", 1)),
                               **kwargs)
    # a prior-seeded stream verifies against the SAME applied-prior
    # record its meta stamped at admission (pool state since is moot)
    sess = store.open(task, spec, seed=int(meta.get("seed", 0)),
                      prior=meta.get("surrogate_prior"))
    try:
        rows = data_rows(rows)
        replay_rows_into_slot(sess.bucket, sess.slot, rows, sid=sid)
    finally:
        store.close(sess.sid)
    return {"parity": True, "rounds": len(rows)}


def replay_serve_main(argv=None) -> int:
    """``python -m coda_tpu_torch.cli replay-serve <record-dir> [...]``: verify
    every serving-session JSONL stream in a record dir by bitwise replay
    against a fresh slab (exit 2 on any divergence) — the offline twin of
    ``cli replay`` for the interactive-session records."""
    import argparse

    p = argparse.ArgumentParser(
        prog="coda_tpu_torch.cli replay-serve",
        description="replay-verify serving session streams "
                    "(session_<id>.jsonl) bitwise against a fresh slab")
    p.add_argument("record_dir", help="a serve --record-dir")
    p.add_argument("--task", default=None)
    p.add_argument("--data-dir", default="data")
    p.add_argument("--synthetic", default=None, metavar="H,N,C",
                   help="the seeded synthetic task the server ran "
                        "(must match the recorded dataset digest)")
    p.add_argument("--device", default="cuda", choices=["cuda", "cpu"],
                   help="replay on the card (default; the bitwise contract "
                        "holds against a card server's streams) or the CPU")
    p.add_argument("--session", default=None,
                   help="verify only this session id")
    args = p.parse_args(argv)

    from coda_tpu_torch.cli import load_dataset
    from coda_tpu_torch.serve.state import SessionStore

    if args.task or args.synthetic:
        ds = load_dataset(args)
    else:
        from coda_tpu_torch.data import make_synthetic_task

        ds = make_synthetic_task(seed=0, H=8, N=512, C=10,
                                 device=args.device)
    store = SessionStore(capacity=2, device=args.device)
    store.register_task(ds.name, ds.preds)

    n_ok = n_bad = 0
    for sid, path in iter_session_streams(args.record_dir):
        if args.session and sid != args.session:
            continue
        try:
            meta, rows, closed = load_session_stream(path)
            meta = dict(meta, task=ds.name)  # verify against loaded data
            info = verify_session_stream(store, meta, rows, sid=sid)
        except Exception as e:
            print(f"  session {sid}: DIVERGED/unusable — {e}")
            n_bad += 1
            continue
        print(f"  session {sid}: PARITY ({info['rounds']} rounds"
              + (", closed" if closed else ", live") + ")")
        n_ok += 1
    print(f"verdict: {'PARITY' if n_bad == 0 else 'DIVERGED'} "
          f"({n_ok} verified, {n_bad} failed)")
    return 0 if n_bad == 0 else 2
