"""Cold-tier spill store v3: sharded segments + sidecar index + lazy frames
(counterpart of ``coda_tpu/serve/spill.py``: the same files, readable by
either package).

What the port decides afresh is the compression of a large carry leaf. A
headline slot's ``(C, N, H)`` fp32 cache is one 2.0 GB leaf of P(best)
values, which deflate shrinks by about a tenth at some 26 MB/s a core:
the reference's one-thread ``zlib.compress(leaf, 6)`` would take over a
minute. So a part past :data:`PARALLEL_MIN_BYTES` is probed first (its
first :data:`PROBE_BYTES` at level 1): if deflate saves less than
:data:`STORE_RATIO` of them, the part is written in stored blocks (level
0, about memcpy's rate), else at :data:`SPILL_LEVEL`; either way in
:data:`CHUNK_BYTES` pieces on a thread pool (zlib releases the GIL), each
ended by a full flush and joined under one zlib header and one Adler-32
trailer (:func:`adler32_combine`). Every part is one ordinary zlib stream
of some level, which ``zlib.decompress`` — the reference's reader too —
inflates unchanged. Smaller parts are ``zlib.compress(part,
SPILL_LEVEL)``.

The v2 store (one ``spill.log`` append-log) fixed the v1 per-file layout's
inode storm, but it still had three costs that dominate at the ROADMAP's
literal million sessions:

  * **startup was O(frames)** — every start re-scanned every header in
    the log sequentially, even though almost all of them were already
    known at the last clean shutdown;
  * **wake decompressed the whole payload** — one zlib stream held the
    metadata, the row history AND every slab carry, so a wake (or even a
    failed digest check) paid full decompression of arrays it might
    never use;
  * **compaction stopped the world** — the whole log was rewritten in
    one pass before the append fd opened, so a garbage-heavy store
    serialized its entire live set on the startup path.

v3 replaces the single log with a sharded layout per spill dir (one spill
dir per replica — the fleet already gives each replica its own subdir):

  * **segments** — ``seg_<n>.log`` files, appended in order, sealed and
    rolled at :data:`SEGMENT_MAX_BYTES`. A frame is a JSON header line
    ``{"sid", "parts": [[name, nbytes, crc32], ...]}`` followed by the
    concatenated zlib-compressed part streams and a trailing newline
    (tombstones: ``{"sid", "tomb": true}``). The payload is split into a
    ``meta`` part (the export payload minus arrays: task, spec, rows)
    and one part per slab carry leaf, so decompression is per-leaf.
  * **sidecar index** — ``spill_index.json``, atomically replaced after
    compactions, on close, and every :data:`INDEX_FLUSH_EVERY`
    mutations. Startup loads the index and scans ONLY the bytes
    appended after it was written (the per-segment recorded size is the
    scan cursor), truncating a torn tail — O(index + tail), not
    O(frames). A missing/corrupt index degrades to a full scan, never
    to data loss; ``startup_mode`` / ``startup_scan_frames`` report
    which path ran (the 1M-session artifact's evidence).
  * **lazy reads** — ``get`` returns a :class:`LazyPayload`: the
    segment is mmap'd, the ``meta`` part is decoded eagerly (it is what
    every import touches first), and each carry leaf decompresses only
    when accessed — a wake is zero-copy on the array bytes until the
    import path's digest check actually reads them.
    :func:`materialize` converts back to a JSON-safe dict for the
    export/migration surfaces.
  * **per-segment compaction** — a sealed segment whose garbage
    fraction exceeds :data:`COMPACT_GARBAGE_FRAC` has its live frames
    copied forward into the active segment as raw bytes (no
    decompression) one short lock window per frame, then the segment is
    unlinked. Concurrent gets keep working: an open mmap pins the
    unlinked file's data. Nothing ever rewrites the whole store.
  * **legacy layouts fold in** — a v2 ``spill.log`` and v1
    ``hibernated_<sid>.json`` files are read at startup, re-encoded
    into v3 segments, and removed (counted in ``compactions``), so an
    old spill dir upgrades itself on first start.

Thread safety: one lock around the index tables and the active-segment
append fd. Compression happens OUTSIDE the lock (``encode`` /
``put_encoded`` — the tier manager uses the split API so a big demotion
batch no longer stalls concurrent wakes behind zlib); reads mmap the
segment without the lock.
"""

from __future__ import annotations

import base64
import json
import mmap
import os
import threading
import zlib
from concurrent.futures import ThreadPoolExecutor
from collections.abc import Mapping
from typing import Iterator, Optional

import numpy as np

#: the v1 per-file layout (still readable; startup folds it in)
LEGACY_PREFIX = "hibernated_"
#: the v2 single append-log (still readable; startup folds it in)
LOG_NAME = "spill.log"
#: v3 segment files: ``seg_<8-digit counter>.log``
SEGMENT_PREFIX = "seg_"
#: the persisted sidecar index
INDEX_NAME = "spill_index.json"
INDEX_VERSION = 3
#: seal + roll the active segment past this many bytes
SEGMENT_MAX_BYTES = 4 << 20
#: compact a sealed segment when dead bytes exceed this fraction
COMPACT_GARBAGE_FRAC = 0.5
#: rewrite the sidecar index after this many puts/deletes
INDEX_FLUSH_EVERY = 256
#: the zlib level of every part (the reference writes 6; any level reads
#: back with zlib.decompress)
SPILL_LEVEL = 1
#: a part at least this large deflates in pieces on a thread pool
PARALLEL_MIN_BYTES = 64 << 20
#: the piece size of a parallel deflate
CHUNK_BYTES = 32 << 20
#: the probe of a large part, and the compressed share of it past which
#: the part is stored (level 0) rather than deflated
PROBE_BYTES = 1 << 20
STORE_RATIO = 0.85


def _legacy_path(spill_dir: str, sid: str) -> str:
    return os.path.join(spill_dir, f"{LEGACY_PREFIX}{sid}.json")


def _seg_name(n: int) -> str:
    return f"{SEGMENT_PREFIX}{n:08d}.log"


def _seg_num(name: str) -> Optional[int]:
    if not (name.startswith(SEGMENT_PREFIX) and name.endswith(".log")):
        return None
    try:
        return int(name[len(SEGMENT_PREFIX):-len(".log")])
    except ValueError:
        return None


# ---------------------------------------------------------------------------
# payload <-> parts codec
# ---------------------------------------------------------------------------
# An export payload's arrays (slab carries + PRNG key, packed by
# recovery._pack as {"dtype","shape","data"}) become their own
# compressed parts holding RAW array bytes (not base64 — a third
# smaller before compression even starts); everything else (task, spec,
# rows, parked answers) is the "meta" part. A payload without carries
# (stream-only export, or a non-export dict) is a single meta part.

_ARRAY_KEYS = ("carries", "key")


def _is_packed(d) -> bool:
    return (isinstance(d, Mapping) and "dtype" in d and "shape" in d
            and "data" in d)


def _raw_bytes(data):
    """A packed array's bytes as a bytes-like object: base64 text
    decoded, a host array viewed without a copy."""
    if isinstance(data, str):
        return base64.b64decode(data)
    if isinstance(data, np.ndarray):
        return memoryview(np.ascontiguousarray(data).reshape(-1)).cast("B")
    return data


_ADLER_BASE = 65521


def adler32_combine(a1: int, a2: int, len2: int) -> int:
    """The Adler-32 of ``A + B`` from ``adler32(A)``, ``adler32(B)`` and
    ``len(B)`` (zlib's ``adler32_combine``)."""
    rem = len2 % _ADLER_BASE
    s1 = a1 & 0xFFFF
    s2 = (rem * s1) % _ADLER_BASE
    s1 += (a2 & 0xFFFF) + _ADLER_BASE - 1
    s2 += ((a1 >> 16) & 0xFFFF) + ((a2 >> 16) & 0xFFFF) + _ADLER_BASE - rem
    if s1 >= _ADLER_BASE:
        s1 -= _ADLER_BASE
    if s1 >= _ADLER_BASE:
        s1 -= _ADLER_BASE
    if s2 >= _ADLER_BASE << 1:
        s2 -= _ADLER_BASE << 1
    if s2 >= _ADLER_BASE:
        s2 -= _ADLER_BASE
    return s1 | (s2 << 16)


def _deflate_piece(piece, last: bool, level: int):
    c = zlib.compressobj(level, zlib.DEFLATED, -15)
    body = c.compress(piece) + c.flush(zlib.Z_FINISH if last
                                       else zlib.Z_FULL_FLUSH)
    return body, zlib.adler32(piece), len(piece)


_POOL: Optional[ThreadPoolExecutor] = None
_POOL_LOCK = threading.Lock()


def _pool() -> ThreadPoolExecutor:
    global _POOL
    with _POOL_LOCK:
        if _POOL is None:
            _POOL = ThreadPoolExecutor(
                max_workers=max(1, os.cpu_count() or 1),
                thread_name_prefix="spill-deflate")
        return _POOL


def compress(data, level: int = SPILL_LEVEL) -> bytes:
    """``data`` as ONE zlib stream: ``zlib.compress`` for a small part, a
    probed parallel piecewise deflate (see the module docstring) past
    :data:`PARALLEL_MIN_BYTES`."""
    mv = memoryview(data).cast("B") if not isinstance(data, bytes) \
        else memoryview(data)
    n = len(mv)
    if n < PARALLEL_MIN_BYTES:
        return zlib.compress(mv, level)
    probe = mv[:PROBE_BYTES]
    if len(zlib.compress(probe, 1)) > STORE_RATIO * len(probe):
        level = 0
    cuts = list(range(0, n, CHUNK_BYTES))
    futs = [_pool().submit(_deflate_piece, mv[a:a + CHUNK_BYTES],
                           a == cuts[-1], level) for a in cuts]
    parts = [f.result() for f in futs]
    adler = 1
    for _, a, ln in parts:
        adler = adler32_combine(adler, a, ln)
    # the zlib header (deflate, 32 KiB window, no dictionary): any FLEVEL
    # reads back; this one says "fastest"
    return b"".join([b"\x78\x01"] + [p for p, _, _ in parts]
                    + [adler.to_bytes(4, "big")])


def encode_payload(payload: Mapping) -> list:
    """Split + compress a payload into ``[(name, zbytes), ...]`` with no
    lock held — the caller appends the result via :meth:`SpillStore.
    put_encoded`. Pure function of the payload."""
    meta = dict(payload)
    parts = []
    carries = meta.get("carries")
    if isinstance(carries, (list, tuple)) and all(
            _is_packed(c) for c in carries):
        spec = []
        for i, c in enumerate(carries):
            name = f"c{i}"
            spec.append({"dtype": c["dtype"], "shape": list(c["shape"]),
                         "part": name})
            parts.append((name, compress(_raw_bytes(c["data"]))))
        meta["carries"] = {"__parts__": spec}
    key = meta.get("key")
    if _is_packed(key):
        meta["key"] = {"__parts__": [{"dtype": key["dtype"],
                                      "shape": list(key["shape"]),
                                      "part": "key"}]}
        parts.append(("key", compress(_raw_bytes(key["data"]))))
    zmeta = compress(json.dumps(meta, separators=(",", ":")).encode())
    return [("meta", zmeta)] + parts


def _frame(sid: str, parts: Optional[list]) -> list:
    """One frame as the list of its byte strings (the header line, the
    parts, the closing newline): written in turn, never joined, so a
    gigabyte part is not copied again on its way to the disk."""
    if parts is None:
        head = {"sid": sid, "tomb": True}
        body = []
    else:
        head = {"sid": sid,
                "parts": [[name, len(z), zlib.crc32(z)]
                          for name, z in parts]}
        body = [z for _, z in parts]
    return [json.dumps(head, separators=(",", ":")).encode() + b"\n",
            *body, b"\n"]


class _LazyLeaf(Mapping):
    """One packed array whose ``data`` decompresses on first access."""

    def __init__(self, spec: dict, mm, off: int, n: int):
        self._spec, self._mm, self._off, self._n = spec, mm, off, n
        self._data: Optional[bytes] = None

    def __getitem__(self, k):
        if k == "data":
            if self._data is None:
                self._data = zlib.decompress(
                    memoryview(self._mm)[self._off:self._off + self._n])
            return self._data
        if k in ("dtype", "shape"):
            return self._spec[k]
        raise KeyError(k)

    def __iter__(self):
        return iter(("dtype", "shape", "data"))

    def __len__(self):
        return 3


class LazyPayload(Mapping):
    """An mmap-backed export payload: meta decoded eagerly, carry leaves
    decompressed per-leaf on access. Compares equal to (and
    :func:`materialize`-s into) the plain dict it was encoded from."""

    def __init__(self, mm, meta: dict, part_offs: dict):
        self._mm = mm
        self._meta = meta
        self._offs = part_offs       # name -> (abs_off, nbytes)
        self._cache: dict = {}

    def _resolve(self, k):
        v = self._meta[k]
        if isinstance(v, dict) and "__parts__" in v:
            leaves = []
            for spec in v["__parts__"]:
                off, n = self._offs[spec["part"]]
                leaves.append(_LazyLeaf(spec, self._mm, off, n))
            return leaves[0] if k == "key" else leaves
        return v

    def __getitem__(self, k):
        if k not in self._cache:
            self._cache[k] = self._resolve(k)
        return self._cache[k]

    def __iter__(self):
        return iter(self._meta)

    def __len__(self):
        return len(self._meta)

    def __eq__(self, other):
        if isinstance(other, LazyPayload):
            other = materialize(other)
        if isinstance(other, Mapping):
            return materialize(self) == dict(other)
        return NotImplemented

    def __ne__(self, other):
        eq = self.__eq__(other)
        return NotImplemented if eq is NotImplemented else not eq


def materialize(payload) -> Optional[dict]:
    """A JSON-safe plain dict of ``payload`` (array bytes back to
    base64). The export/migration surfaces call this at the serialization
    boundary; a plain dict passes through untouched."""
    if payload is None or not isinstance(payload, Mapping):
        return payload
    if _is_packed(payload):
        data = payload["data"]
        if not isinstance(data, str):
            data = base64.b64encode(_raw_bytes(data)).decode("ascii")
        return {"dtype": payload["dtype"],
                "shape": list(payload["shape"]), "data": data}
    out = {}
    for k in payload:
        v = payload[k]
        if _is_packed(v):
            v = materialize(v)
        elif isinstance(v, (list, tuple)) and v and all(
                _is_packed(c) for c in v):
            v = [materialize(c) for c in v]
        out[k] = v
    return out


class SpillStore:
    """Sharded-segment session hibernation store (see module docstring).

    Public surface (the tier manager's contract): ``put``/``get``/
    ``delete``/``sids``/``__contains__``/``__len__``/``items``, plus the
    split ``encode``/``put_encoded`` pair so compression can run outside
    any caller-side lock, ``maybe_compact`` for the sweeper, and
    ``stats`` for the gauges.
    """

    def __init__(self, spill_dir: str, compact: bool = True):
        self.dir = spill_dir
        self._lock = threading.Lock()
        # sid -> (seg_name, head_off, frame_len)
        self._index: dict[str, tuple] = {}
        # seg_name -> {"size": scanned/appended bytes, "garbage": bytes}
        self._segs: dict[str, dict] = {}
        # tombstones whose append failed (ENOSPC): retried before the
        # next successful append so a deleted sid cannot silently
        # resurrect at the next startup scan
        self._tomb_retry: set[str] = set()
        self.compactions = 0          # legacy folds + segment compactions
        self.segment_compactions = 0  # v3 per-segment compactions only
        self.put_errors = 0           # appends that failed (caller keeps warm)
        self.startup_mode = "scan"    # "index" (sidecar honored) | "scan"
        self.startup_scan_frames = 0  # frames the startup actually parsed
        self._mutations = 0           # puts/deletes since last index write
        os.makedirs(spill_dir, exist_ok=True)
        self._startup()
        self._open_active()
        self._fold_legacy()
        if compact:
            self.maybe_compact()
        self._write_index()

    # -- paths -------------------------------------------------------------
    def _seg_path(self, seg: str) -> str:
        return os.path.join(self.dir, seg)

    @property
    def index_path(self) -> str:
        return os.path.join(self.dir, INDEX_NAME)

    # -- startup -----------------------------------------------------------
    def _startup(self) -> None:
        names = sorted(
            (n for n in os.listdir(self.dir) if _seg_num(n) is not None),
            key=_seg_num)
        cursors = {n: 0 for n in names}   # per-segment scan start
        loaded = self._load_index()
        if loaded is not None:
            entries, sizes = loaded
            ok = True
            for seg, rec in sizes.items():
                if seg not in cursors:
                    ok = False      # a recorded segment vanished: rescan
                    break
                actual = os.path.getsize(self._seg_path(seg))
                if actual < rec["size"]:
                    ok = False      # truncated under us: rescan
                    break
            if ok:
                self.startup_mode = "index"
                for sid, (seg, off, ln) in entries.items():
                    self._index[sid] = (seg, off, ln)
                for seg, rec in sizes.items():
                    self._segs[seg] = {"size": rec["size"],
                                       "garbage": rec["garbage"]}
                    cursors[seg] = rec["size"]
        # scan only what the index does not cover: whole segments under
        # "scan", appended tails (or brand-new segments) under "index"
        for seg in names:
            self._segs.setdefault(seg, {"size": 0, "garbage": 0})
            self._scan_segment(seg, cursors[seg])

    def _load_index(self):
        try:
            with open(self.index_path) as f:
                idx = json.load(f)
            if idx.get("v") != INDEX_VERSION:
                return None
            entries = {sid: tuple(e) for sid, e in idx["entries"].items()}
            sizes = {seg: {"size": int(rec["size"]),
                           "garbage": int(rec["garbage"])}
                     for seg, rec in idx["segments"].items()}
            return entries, sizes
        except (OSError, ValueError, KeyError, TypeError):
            return None

    def _scan_segment(self, seg: str, start: int) -> None:
        """Index frames from ``start`` to EOF; a torn final frame is
        truncated away — the crash the append path's single-flush
        contract allows."""
        path = self._seg_path(seg)
        try:
            size = os.path.getsize(path)
        except OSError:
            return
        if start >= size:
            return
        good_end = start
        with open(path, "rb") as f:
            f.seek(start)
            while True:
                head_off = f.tell()
                line = f.readline()
                if not line:
                    break
                try:
                    head = json.loads(line)
                    sid = head["sid"]
                    body = (0 if head.get("tomb") else
                            sum(int(p[1]) for p in head["parts"]))
                except (ValueError, KeyError, TypeError, IndexError):
                    break  # torn/garbage header: the segment ends here
                body_off = f.tell()
                if body_off + body + 1 > size:
                    break  # torn body (crash mid-append)
                f.seek(body_off + body)
                if f.read(1) != b"\n":
                    break  # frame not terminated: torn
                good_end = f.tell()
                frame_len = good_end - head_off
                self.startup_scan_frames += 1
                self._supersede_locked(sid)
                if head.get("tomb"):
                    self._segs[seg]["garbage"] += frame_len
                else:
                    self._index[sid] = (seg, head_off, frame_len)
                self._segs[seg]["size"] = good_end
        if good_end < size:
            with open(path, "ab") as f:
                f.truncate(good_end)

    def _supersede_locked(self, sid: str) -> None:
        prev = self._index.pop(sid, None)
        if prev is not None:
            pseg, _, plen = prev
            if pseg in self._segs:
                self._segs[pseg]["garbage"] += plen

    def _fold_legacy(self) -> None:
        """Re-encode v1 per-file and v2 single-log payloads into v3
        segments, then remove the old layout (upgrade-on-first-start)."""
        folded = 0
        v2 = os.path.join(self.dir, LOG_NAME)
        if os.path.exists(v2):
            for sid, payload in self._scan_v2(v2):
                if self._append_parts(sid, encode_payload(payload),
                                      startup=True):
                    folded += 1
            try:
                os.remove(v2)
            except OSError:
                pass
        for fn in sorted(os.listdir(self.dir)):
            if not (fn.startswith(LEGACY_PREFIX) and fn.endswith(".json")):
                continue
            sid = fn[len(LEGACY_PREFIX):-len(".json")]
            path = os.path.join(self.dir, fn)
            try:
                with open(path) as f:
                    payload = json.load(f)
            except (OSError, ValueError):
                continue  # unreadable legacy file: left in place
            if sid not in self._index:   # a v2/v3 frame supersedes v1
                if not self._append_parts(sid, encode_payload(payload),
                                          startup=True):
                    continue
            folded += 1
            try:
                os.remove(path)
            except OSError:
                pass
        if folded:
            self.compactions += 1

    @staticmethod
    def _scan_v2(path: str) -> Iterator[tuple]:
        """(sid, payload) for the live set of a v2 append-log: last frame
        per sid wins, tombstones delete, torn tail dropped."""
        frames: dict[str, Optional[dict]] = {}
        try:
            size = os.path.getsize(path)
            with open(path, "rb") as f:
                while True:
                    line = f.readline()
                    if not line:
                        break
                    try:
                        head = json.loads(line)
                        n = int(head["n"])
                        sid = head["sid"]
                    except (ValueError, KeyError, TypeError):
                        break
                    off = f.tell()
                    if off + n + 1 > size:
                        break
                    zbytes = f.read(n)
                    if f.read(1) != b"\n":
                        break
                    if head.get("tomb"):
                        frames[sid] = None
                    else:
                        try:
                            frames[sid] = json.loads(zlib.decompress(zbytes))
                        except (ValueError, zlib.error):
                            frames.pop(sid, None)
        except OSError:
            return
        for sid, payload in frames.items():
            if payload is not None:
                yield sid, payload

    # -- the active segment ------------------------------------------------
    def _open_active(self) -> None:
        nums = [_seg_num(s) for s in self._segs]
        cur = max([n for n in nums if n is not None], default=0)
        if cur == 0:
            cur = 1
            self._segs[_seg_name(1)] = {"size": 0, "garbage": 0}
        self._active = _seg_name(cur)
        self._append_fd = open(self._seg_path(self._active), "ab")
        if self._segs[self._active]["size"] >= SEGMENT_MAX_BYTES:
            self._roll_locked()

    def _roll_locked(self) -> None:
        try:
            self._append_fd.close()
        except OSError:
            pass
        nxt = _seg_name(_seg_num(self._active) + 1)
        self._segs[nxt] = {"size": 0, "garbage": 0}
        self._active = nxt
        self._append_fd = open(self._seg_path(nxt), "ab")

    def _append_locked(self, frame):
        """Append one frame (bytes, or the list :func:`_frame` gives) to
        the active segment under the lock; returns ``(seg, offset)`` or
        None on failure — with the tail rewound, because a partial write
        (ENOSPC mid-flush) would otherwise make the startup scan's
        torn-tail truncation drop every valid frame appended after it."""
        chunks = [frame] if isinstance(frame, (bytes, bytearray)) else frame
        try:
            offset = self._append_fd.tell()
            for c in chunks:
                self._append_fd.write(c)
            self._append_fd.flush()
        except (OSError, ValueError):   # ValueError: fd already closed
            try:
                self._append_fd.seek(offset)
                self._append_fd.truncate(offset)
            except (OSError, ValueError, UnboundLocalError):
                pass  # scan-time truncation remains the backstop
            self.put_errors += 1
            return None
        seg = self._active
        self._segs[seg]["size"] = offset + sum(len(c) for c in chunks)
        if self._segs[seg]["size"] >= SEGMENT_MAX_BYTES:
            self._roll_locked()
        return seg, offset

    def _append_parts(self, sid: str, parts: list,
                      startup: bool = False) -> bool:
        frame = _frame(sid, parts)
        with self._lock:
            if not startup:
                self._flush_tombstones_locked()  # deletes land before puts
            at = self._append_locked(frame)
            if at is None:
                return False
            self._supersede_locked(sid)
            self._index[sid] = (at[0], at[1], sum(len(c) for c in frame))
            self._mutations += 1
        return True

    def _flush_tombstones_locked(self) -> None:
        for sid in list(self._tomb_retry):
            if self._append_locked(_frame(sid, None)) is None:
                return  # disk still unhappy; keep retrying later
            self._tomb_retry.discard(sid)

    # -- the store surface -------------------------------------------------
    def encode(self, payload: Mapping) -> list:
        """Compress a payload into appendable parts — NO lock held, so
        the tier manager can run zlib outside its own lock too."""
        return encode_payload(payload)

    def put_encoded(self, sid: str, parts: list) -> bool:
        """Append a pre-encoded payload (one short lock window); False
        (counted) when the disk write failed — the caller keeps the
        session warm, never lost."""
        ok = self._append_parts(sid, parts)
        if ok:
            try:
                os.remove(_legacy_path(self.dir, sid))
            except OSError:
                pass
            self._maybe_flush_index()
        return ok

    def put(self, sid: str, payload: Mapping) -> bool:
        """``encode`` (outside the lock) + ``put_encoded``."""
        return self.put_encoded(sid, self.encode(payload))

    def get(self, sid: str):
        """The payload as a :class:`LazyPayload` (meta decoded, carry
        leaves decompressed on access), or None."""
        with self._lock:
            entry = self._index.get(sid)
        if entry is None:
            return None
        seg, head_off, frame_len = entry
        try:
            with open(self._seg_path(seg), "rb") as f:
                mm = mmap.mmap(f.fileno(), 0, access=mmap.ACCESS_READ)
        except (OSError, ValueError):
            return None
        try:
            nl = mm.find(b"\n", head_off, head_off + frame_len)
            head = json.loads(mm[head_off:nl])
            offs, cur = {}, nl + 1
            for name, n, _crc in head.get("parts", []):
                offs[name] = (cur, int(n))
                cur += int(n)
            moff, mn = offs["meta"]
            meta = json.loads(zlib.decompress(mm[moff:moff + mn]))
            return LazyPayload(mm, meta, offs)
        except (ValueError, KeyError, zlib.error, IndexError):
            return None

    def delete(self, sid: str) -> bool:
        """Tombstone one sid (and drop its legacy file, if any). A failed
        tombstone append is queued and retried before the next append —
        without that, a restart's scan would re-index the last live
        frame and resurrect a session the server confirmed closed."""
        with self._lock:
            entry = self._index.pop(sid, None)
            if entry is None:
                return False
            seg, _, frame_len = entry
            if seg in self._segs:
                self._segs[seg]["garbage"] += frame_len
            if self._append_locked(_frame(sid, None)) is None:
                self._tomb_retry.add(sid)
            self._mutations += 1
        try:
            os.remove(_legacy_path(self.dir, sid))
        except OSError:
            pass
        self._maybe_flush_index()
        return True

    def sids(self) -> list:
        with self._lock:
            return list(self._index)

    def __contains__(self, sid: str) -> bool:
        with self._lock:
            return sid in self._index

    def __len__(self) -> int:
        with self._lock:
            return len(self._index)

    def items(self) -> Iterator[tuple]:
        """(sid, payload-dict) over the live set (the export sweep —
        materialized, the consumer serializes them)."""
        for sid in self.sids():
            payload = self.get(sid)
            if payload is not None:
                yield sid, materialize(payload)

    # -- compaction --------------------------------------------------------
    def _compactable_locked(self) -> list:
        out = []
        for seg, rec in self._segs.items():
            if seg == self._active or rec["size"] == 0:
                continue
            if rec["garbage"] > COMPACT_GARBAGE_FRAC * rec["size"]:
                out.append(seg)
        return out

    def maybe_compact(self) -> int:
        """Compact every sealed segment past the garbage threshold;
        returns how many were compacted. Safe at runtime: one short lock
        window per copied frame, concurrent gets read via mmaps that
        survive the unlink."""
        with self._lock:
            victims = self._compactable_locked()
        for seg in victims:
            self._compact_segment(seg)
        if victims:
            self._write_index()
        return len(victims)

    def _compact_segment(self, seg: str) -> None:
        """Copy the segment's live frames forward into the active segment
        as raw bytes (no decompression), then unlink it. Tombstones for
        sids that are gone from the index are copied forward too unless
        this is the oldest segment (nothing older could resurrect them);
        scan order stays correct because copies land in a NEWER segment
        than any frame they supersede."""
        path = self._seg_path(seg)
        try:
            with open(path, "rb") as f:
                data = f.read()
        except OSError:
            return
        with self._lock:
            oldest = seg == min(self._segs, key=_seg_num)
        pos = 0
        while pos < len(data):
            nl = data.find(b"\n", pos)
            if nl < 0:
                break
            try:
                head = json.loads(data[pos:nl])
                sid = head["sid"]
                body = (0 if head.get("tomb") else
                        sum(int(p[1]) for p in head.get("parts", [])))
            except (ValueError, KeyError, TypeError):
                break
            end = nl + 1 + body + 1
            if end > len(data) or data[end - 1:end] != b"\n":
                break
            frame = data[pos:end]
            with self._lock:
                entry = self._index.get(sid)
                live = entry is not None and entry[0] == seg \
                    and entry[1] == pos
                keep_tomb = (head.get("tomb") and sid not in self._index
                             and sid not in self._tomb_retry and not oldest)
                if live or keep_tomb:
                    at = self._append_locked(frame)
                    if at is None:
                        return  # disk full: abort, retry next sweep
                    if live:
                        self._index[sid] = (at[0], at[1], len(frame))
            pos = end
        with self._lock:
            self._segs.pop(seg, None)
        try:
            os.remove(path)
        except OSError:
            pass
        self.segment_compactions += 1
        self.compactions += 1

    # -- sidecar index -----------------------------------------------------
    def _maybe_flush_index(self) -> None:
        with self._lock:
            due = self._mutations >= INDEX_FLUSH_EVERY
            if due:
                self._mutations = 0
        if due:
            self._write_index()

    def _write_index(self) -> None:
        with self._lock:
            doc = {"v": INDEX_VERSION,
                   "entries": {sid: list(e)
                               for sid, e in self._index.items()},
                   "segments": {seg: {"size": rec["size"],
                                      "garbage": rec["garbage"]}
                                for seg, rec in self._segs.items()}}
            self._mutations = 0
        tmp = self.index_path + ".tmp"
        try:
            with open(tmp, "w") as f:
                json.dump(doc, f, separators=(",", ":"))
                f.flush()
                os.fsync(f.fileno())
            os.replace(tmp, self.index_path)
        except OSError:
            pass  # next startup degrades to a scan, never to data loss

    # -- stats -------------------------------------------------------------
    def stats(self) -> dict:
        with self._lock:
            live = sum(ln for _, _, ln in self._index.values())
            size = sum(rec["size"] for rec in self._segs.values())
            garbage = sum(rec["garbage"] for rec in self._segs.values())
            return {
                "entries": len(self._index),
                "segments": len(self._segs),
                "live_bytes": live,
                "log_bytes": size,
                "garbage_bytes": garbage,
                "segment_compactions": self.segment_compactions,
                "compactions": self.compactions,
                "put_errors": self.put_errors,
                "startup_mode": self.startup_mode,
                "startup_scan_frames": self.startup_scan_frames,
            }

    def close(self) -> None:
        with self._lock:
            self._flush_tombstones_locked()  # last chance to persist
            try:
                self._append_fd.close()
            except OSError:
                pass
        self._write_index()
