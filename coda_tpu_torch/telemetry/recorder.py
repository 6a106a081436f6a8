"""Decision flight recorder: per-round provenance records on disk
(counterpart of the run-record half of ``coda_tpu/telemetry/recorder.py``).

A record holds, per seed and labeling round, the decision (chosen index,
oracle label, selection probability), the top-k acquisition scores and
indices with the chosen score and the runner-up gap, a P(best) digest
(max and entropy in bits; NaN for methods without a posterior) and the
round's PRNG key words; plus one run-level environment fingerprint. The
engine gathers the arrays on the device and reads them back once a run
(``engine/loop.py``); ``engine/replay.py`` compares two records.

The on-disk layout is the reference's schema v4, byte for byte where the
reference fixes the bytes (the dataset digest), so the reference's
``scripts/check_record_schema.py`` and ``python -m coda_tpu.cli replay
<record> --against <record>`` read a port record as their own::

    <dir>/record.json   # schema_version, fingerprint, run config, shapes
    <dir>/rounds.npz    # the per-seed x per-round arrays (REQUIRED_ARRAYS)

The fingerprint's ``backend`` names the port (``torch-cuda``,
``torch-cpu``), so a comparison with a JAX record takes the cross-backend
score contract, never the bitwise one. Serving-session streams
(:class:`SessionRecorder`, schema v4 like the reference's) are the serve
layer's per-session JSONL logs. ``save`` feeds the
registry's recorder counters (``telemetry/registry.py``), as the
reference's does.
"""

from __future__ import annotations

import hashlib
import json
import os
import re
import threading
import time
from dataclasses import dataclass, field
from typing import Optional

import numpy as np

RECORD_SCHEMA_VERSION = 4
SUPPORTED_RECORD_VERSIONS = (1, 2, 3, 4)

# the documented cross-backend score contract (the reference's): records
# of two backends or knob sets agree on scores to 2.34e-4
CROSS_BACKEND_SCORE_TOL = 2.34e-4

# every array a rounds.npz must carry: name -> (dtype kind, ndim with the
# leading seed axis) at acq_batch = 1
REQUIRED_ARRAYS = {
    "chosen_idx": ("i", 2),        # (S, T)
    "true_class": ("i", 2),        # (S, T)
    "best_model": ("i", 2),        # (S, T)
    "regret": ("f", 2),            # (S, T)
    "cumulative_regret": ("f", 2),  # (S, T)
    "select_prob": ("f", 2),       # (S, T)
    "regret_at_0": ("f", 1),       # (S,)
    "stochastic": ("b", 1),        # (S,)
    "round_key": ("u", 3),         # (S, T, 2)
    "topk_idx": ("i", 3),          # (S, T, k)
    "topk_score": ("f", 3),        # (S, T, k)
    "chosen_score": ("f", 2),      # (S, T)
    "runner_up_gap": ("f", 2),     # (S, T)
    "pbest_max": ("f", 2),         # (S, T)
    "pbest_entropy": ("f", 2),     # (S, T)
    "root_key": ("u", 2),          # (S, 2)
    "init_key": ("u", 2),          # (S, 2)
    "prior_key": ("u", 2),         # (S, 2)
}

# per-run (S, 2) key arrays: no round axis
_RUN_KEYS = ("root_key", "init_key", "prior_key")

REQUIRED_META = ("schema_version", "fingerprint", "run", "trace_k",
                 "seeds", "rounds")

# the per-round decision arrays that grow a trailing (q,) axis under
# batched acquisition
_BATCH_ARRAYS = ("chosen_idx", "true_class", "select_prob")

# arrays that exist only from a given schema version on
_VERSIONED_ARRAYS = {
    "surrogate_fallback": (3, ("b", 2)),   # (S, T)
}

# v4's optional per-round arrays of a crowd-oracle run (validated when
# present, never demanded)
_OPTIONAL_ARRAYS = {
    "oracle_label": ("i", 2),   # (S, T) the aggregated crowd answer
    "label_weight": ("f", 2),   # (S, T) the applied reliability weight
}


def optional_arrays(acq_batch: int = 1) -> dict:
    """The optional arrays' spec at a record's ``acq_batch``: a trailing
    ``(q,)`` axis at q > 1, like the decision arrays."""
    out = dict(_OPTIONAL_ARRAYS)
    if acq_batch <= 1:
        return out
    return {name: (kind, ndim + 1) for name, (kind, ndim) in out.items()}


def required_arrays(acq_batch: int = 1,
                    schema_version: int = RECORD_SCHEMA_VERSION) -> dict:
    """The REQUIRED_ARRAYS spec for a record's ``acq_batch`` and schema
    version: at q > 1 the decision arrays are (S, T, q); v3 on carry
    ``surrogate_fallback``."""
    out = dict(REQUIRED_ARRAYS)
    for name, (since, spec) in _VERSIONED_ARRAYS.items():
        if schema_version >= since:
            out[name] = spec
    if acq_batch > 1:
        for name in _BATCH_ARRAYS:
            kind, ndim = out[name]
            out[name] = (kind, ndim + 1)
    return out


# the knob subset of an argparse namespace worth fingerprinting: every flag
# that can change the decision trace (the reference's list)
KNOB_FIELDS = (
    "method", "loss", "iters", "seeds", "alpha", "learning_rate",
    "multiplier", "prefilter_n", "no_diag_prior", "q", "epsilon",
    "eig_chunk", "eig_mode", "eig_backend", "eig_precision",
    "eig_cache_dtype", "eig_refresh", "eig_entropy", "posterior",
    "eig_pbest", "eig_scorer", "pi_update", "mesh", "acq_batch",
    "oracle_noise", "oracle_annotators", "oracle_reliability",
    "surrogate_prior", "surrogate_prior_digest",
)


def _host(x) -> np.ndarray:
    """A tensor or array as a numpy array on the host."""
    if hasattr(x, "detach"):
        return x.detach().cpu().numpy()
    return np.asarray(x)


def dataset_digest(preds, labels=None, max_bytes: int = 1 << 28) -> str:
    """Stable 16-hex digest of the prediction tensor (and labels), the
    reference's bytes: sha256 over each array's ``(shape, dtype)`` repr
    and its bytes, up to ``max_bytes`` an array; beyond that a strided
    ~16M-element subsample."""
    h = hashlib.sha256()
    for arr in (preds, labels):
        if arr is None:
            continue
        a = _host(arr)
        h.update(repr((a.shape, str(a.dtype))).encode())
        if a.nbytes <= max_bytes:
            h.update(np.ascontiguousarray(a).tobytes())
        else:
            flat = a.reshape(-1)
            stride = max(1, flat.size // (1 << 24))
            h.update(np.ascontiguousarray(flat[::stride]).tobytes())
    return h.hexdigest()[:16]


def environment_fingerprint(dataset=None, knobs: Optional[dict] = None,
                            digest: Optional[str] = None,
                            device=None) -> dict:
    """The run-level provenance block of a record: the port's backend
    (``torch-cuda`` or ``torch-cpu``, from ``device`` or the dataset's
    tensors), torch and CUDA versions, the device kind, the RNG mode
    (threefry partitionable, 32-bit), the knobs and a dataset digest."""
    import torch

    if device is None:
        preds = getattr(dataset, "preds", None)
        device = getattr(preds, "device", "cpu")
    dev = torch.device(device)
    cuda = dev.type == "cuda"
    fp = {
        "backend": f"torch-{dev.type}",
        "torch_version": torch.__version__,
        "cuda_version": torch.version.cuda,
        "device_kind": torch.cuda.get_device_name(dev) if cuda else "cpu",
        "n_devices": torch.cuda.device_count() if cuda else 1,
        "threefry_partitionable": True,
        "x64": False,
        "knobs": dict(knobs or {}),
    }
    ds = {}
    if dataset is not None:
        ds = {"name": getattr(dataset, "name", None),
              "shape": list(getattr(dataset, "shape", ()) or ())}
        if digest is None and getattr(dataset, "preds", None) is not None:
            digest = dataset_digest(dataset.preds,
                                    getattr(dataset, "labels", None))
    if digest is not None:
        ds["digest"] = digest
    fp["dataset"] = ds
    return fp


def knobs_from_args(args) -> dict:
    """The fingerprint-worthy knob subset of an argparse namespace."""
    return {k: getattr(args, k) for k in KNOB_FIELDS
            if getattr(args, k, None) is not None}


@dataclass
class RunRecord:
    """One recorded run: JSON meta + the per-seed/per-round arrays."""

    meta: dict
    arrays: dict = field(default_factory=dict)

    @classmethod
    def from_result(cls, result, aux, fingerprint: dict, run: dict,
                    extra_meta: Optional[dict] = None,
                    crowd=None) -> "RunRecord":
        """Build a record from an ``(ExperimentResult, RunTraceAux)`` pair
        with a leading seed axis (as ``run_seeds_recorded`` returns).
        ``crowd``, the ``CrowdAux`` of a crowd-oracle run, adds the v4
        optional arrays: ``oracle_label`` holds its ``applied_label`` (the
        aggregated answer, as the reference stores it) and
        ``label_weight`` its weights; a clean run passes None."""
        trace = aux.trace
        arrays = {
            "chosen_idx": _host(result.chosen_idx).astype(np.int32),
            "true_class": _host(result.true_class).astype(np.int32),
            "best_model": _host(result.best_model).astype(np.int32),
            "regret": _host(result.regret).astype(np.float32),
            "cumulative_regret": _host(result.cumulative_regret).astype(
                np.float32),
            "select_prob": _host(result.select_prob).astype(np.float32),
            "regret_at_0": np.atleast_1d(
                _host(result.regret_at_0).astype(np.float32)),
            "stochastic": np.atleast_1d(_host(result.stochastic).astype(bool)),
            "round_key": _host(trace.round_key).astype(np.uint32),
            "topk_idx": _host(trace.topk_idx).astype(np.int32),
            "topk_score": _host(trace.topk_score).astype(np.float32),
            "chosen_score": _host(trace.chosen_score).astype(np.float32),
            "runner_up_gap": _host(trace.runner_up_gap).astype(np.float32),
            "pbest_max": _host(trace.pbest_max).astype(np.float32),
            "pbest_entropy": _host(trace.pbest_entropy).astype(np.float32),
            "surrogate_fallback": _host(trace.surrogate_fallback).astype(
                bool),
            "root_key": _host(aux.root_key).astype(np.uint32).reshape(-1, 2),
            "init_key": _host(aux.init_key).astype(np.uint32).reshape(-1, 2),
            "prior_key": _host(aux.prior_key).astype(np.uint32).reshape(
                -1, 2),
        }
        if crowd is not None:
            arrays["oracle_label"] = _host(crowd.applied_label).astype(
                np.int32)
            arrays["label_weight"] = _host(crowd.label_weight).astype(
                np.float32)
        ci = arrays["chosen_idx"]
        meta = {
            "schema_version": RECORD_SCHEMA_VERSION,
            "fingerprint": fingerprint,
            "run": run,
            "trace_k": int(arrays["topk_idx"].shape[-1]),
            "seeds": int(ci.shape[0]),
            "rounds": int(ci.shape[1]),
            "acq_batch": int(ci.shape[2]) if ci.ndim == 3 else 1,
        }
        if extra_meta:
            meta.update(extra_meta)
        return cls(meta=meta, arrays=arrays)

    def save(self, out_dir: str, registry=None) -> dict:
        """Write ``rounds.npz`` then ``record.json`` under ``out_dir``
        (arrays first: a crash between the writes leaves no record.json
        pointing at missing arrays); returns {artifact: path} and feeds the
        recorder counters of ``registry`` (default: the process
        registry)."""
        t0 = time.perf_counter()
        os.makedirs(out_dir, exist_ok=True)
        paths = {"record": os.path.join(out_dir, "record.json"),
                 "rounds": os.path.join(out_dir, "rounds.npz")}
        with open(paths["rounds"], "wb") as f:
            np.savez(f, **self.arrays)
        with open(paths["record"], "w") as f:
            json.dump(self.meta, f, indent=2, default=str)
        from coda_tpu_torch.telemetry.registry import get_registry

        reg = registry if registry is not None else get_registry()
        reg.counter("records_written_total",
                    "Flight-recorder run records written").inc()
        reg.counter("record_rounds_total",
                    "Labeling rounds captured by the flight recorder").inc(
                        float(self.meta["seeds"] * self.meta["rounds"]))
        reg.gauge("recorder_last_write_seconds",
                  "Host seconds to serialize the last run record").set(
                      time.perf_counter() - t0)
        return paths

    @classmethod
    def load(cls, in_dir: str) -> "RunRecord":
        with open(os.path.join(in_dir, "record.json")) as f:
            meta = json.load(f)
        v = meta.get("schema_version")
        if v not in SUPPORTED_RECORD_VERSIONS:
            raise ValueError(
                f"record at {in_dir!r} has schema_version={v!r}; this build "
                f"reads v{SUPPORTED_RECORD_VERSIONS}")
        with np.load(os.path.join(in_dir, "rounds.npz")) as z:
            arrays = {k: z[k] for k in z.files}
        return cls(meta=meta, arrays=arrays)

    @property
    def seeds(self) -> int:
        return int(self.meta["seeds"])

    @property
    def rounds(self) -> int:
        return int(self.meta["rounds"])

    @property
    def acq_batch(self) -> int:
        """Labels per round (1 for v1 records, which predate batching)."""
        return int(self.meta.get("acq_batch", 1))

    def seed_arrays(self, s: int) -> dict:
        """The per-round arrays of one seed (no leading axis)."""
        return {k: v[s] for k, v in self.arrays.items()}

    def violations(self) -> list:
        """Schema violations of this record (empty = clean): the record
        half of the reference's ``scripts/check_record_schema.py`` —
        version stamp, required meta, every required array with its dtype
        kind, rank and (seeds, rounds, trace_k) extents."""
        out = []
        meta = self.meta
        v = meta.get("schema_version")
        if v is None:
            out.append("record.json has no schema_version stamp")
        elif v not in SUPPORTED_RECORD_VERSIONS:
            out.append(f"schema_version {v!r} not in supported "
                       f"{list(SUPPORTED_RECORD_VERSIONS)}")
        # v2 on stamps acq_batch; v1 predates batching and reads as q = 1
        q = meta.get("acq_batch", 1)
        if isinstance(v, int) and v >= 2 \
                and not isinstance(meta.get("acq_batch"), int):
            out.append(f"v{v} record.json missing integer 'acq_batch'")
            q = 1
        q = q if isinstance(q, int) else 1
        spec = required_arrays(q, v if isinstance(v, int) else 1)
        optional = optional_arrays(q) if isinstance(v, int) and v >= 4 \
            else {}
        out += [f"record.json missing required field {key!r}"
                for key in REQUIRED_META if key not in meta]
        S, T, k = meta.get("seeds"), meta.get("rounds"), meta.get("trace_k")
        for name, (kind, ndim) in spec.items():
            a = self.arrays.get(name)
            if a is None:
                out.append(f"rounds.npz missing array {name!r}")
                continue
            if a.dtype.kind != kind:
                out.append(f"{name}: dtype kind {a.dtype.kind!r} != "
                           f"expected {kind!r}")
            if a.ndim != ndim:
                out.append(f"{name}: rank {a.ndim} != expected {ndim}")
                continue
            if a.shape[0] != S:
                out.append(f"{name}: leading seed extent {a.shape[0]} != "
                           f"meta seeds {S}")
            if ndim >= 2 and name not in _RUN_KEYS and a.shape[1] != T:
                out.append(f"{name}: round extent {a.shape[1]} != "
                           f"meta rounds {T}")
            if name.startswith("topk_") and a.shape[2] != k:
                out.append(f"{name}: top-k extent {a.shape[2]} != "
                           f"meta trace_k {k}")
            if name in _BATCH_ARRAYS and q > 1 and a.shape[2] != q:
                out.append(f"{name}: label-batch extent {a.shape[2]} != "
                           f"meta acq_batch {q}")
        for name, (kind, ndim) in optional.items():
            a = self.arrays.get(name)
            if a is None:
                continue
            if a.dtype.kind != kind:
                out.append(f"{name}: dtype kind {a.dtype.kind!r} != "
                           f"expected {kind!r}")
            if a.ndim != ndim:
                out.append(f"{name}: rank {a.ndim} != expected {ndim}")
            elif a.shape[0] != S:
                out.append(f"{name}: leading seed extent {a.shape[0]} != "
                           f"meta seeds {S}")
            elif a.shape[1] != T:
                out.append(f"{name}: round extent {a.shape[1]} != "
                           f"meta rounds {T}")
        extra = set(self.arrays) - set(spec) - set(optional)
        if extra:
            out.append(f"unversioned field drift: unexpected arrays "
                       f"{sorted(extra)} (bump RECORD_SCHEMA_VERSION)")
        return out


def is_record_dir(path: str) -> bool:
    return (os.path.isfile(os.path.join(path, "record.json"))
            and os.path.isfile(os.path.join(path, "rounds.npz")))


_STREAM_SAFE = re.compile(r"[^A-Za-z0-9_.-]+")


def stream_dir(root: str, *parts: str) -> str:
    """``<root>/<part>/...`` with filesystem-hostile characters squashed
    (a task name like ``glue/cola`` must not nest): the suite's
    per-(family, method) record streams, as the reference lays them
    out."""
    safe = [_STREAM_SAFE.sub("-", p) for p in parts if p]
    return os.path.join(root, *safe)


# -- serving-session streams (SessionRecorder) -------------------------------

# the session stream's schema, the reference's: v2 added request_id, the
# P(best) digest and the session_close marker; v3 q-wide batch-label rows
# and the meta's acq_batch; v4 answer_park rows (the crowd's answer
# verb). Rows may carry the additive optional ``trace_id`` and
# ``pred_label_prob``; a reader tolerates extra keys.
SESSION_SCHEMA_VERSION = 4
SUPPORTED_SESSION_VERSIONS = (2, 3, 4)


def _counters(registry=None):
    from coda_tpu_torch.telemetry.registry import get_registry

    return registry if registry is not None else get_registry()


def _truncate_torn_tail(path: str) -> None:
    """Drop a torn final line (no trailing newline) from a JSONL stream —
    the leftover of a crash mid-write. Keeps everything through the last
    newline; a file that is ONE torn line truncates to empty."""
    with open(path, "rb+") as f:
        f.seek(0, os.SEEK_END)
        size = f.tell()
        if size == 0:
            return
        back = min(size, 1 << 20)
        f.seek(size - back)
        tail = f.read(back)
        if tail.endswith(b"\n"):
            return
        cut = tail.rfind(b"\n")
        f.truncate(size - back + cut + 1 if cut >= 0 else 0)


def _count_stream_rows(path: str) -> tuple:
    """``(n_data_rows, resumable)`` for a session stream file. Not
    resumable when a ``session_close`` marker is present (the stream
    ended here — anything after it is a new incarnation, not a
    continuation) or a line fails to parse."""
    n = 0
    with open(path) as f:
        for line in f:
            try:
                kind = json.loads(line).get("kind")
            except ValueError:
                return n, False
            if kind == "session_close":
                return n, False
            if not kind:
                # only DATA rows count toward the resume prefix: marker
                # rows (session_meta, v4's answer_park) are not part of
                # the decision-row sequence import_history aligns on
                n += 1
    return n, True


class SessionRecorder:
    """Per-session decision streams for the serving layer.

    An interactive session has no known end, so its record is a *stream*:
    one in-memory history per live session (the ``GET /session/{id}/trace``
    payload) plus, with an ``out_dir``, an append-only JSONL file per
    session (one meta line, then one versioned row per dispatch) that
    survives a crash mid-session — every ``append`` is flushed.

    Thread-safe: the batcher thread appends, HTTP worker threads read.

    Failure semantics (the disk-full recovery path): a stream write that
    raises (``OSError`` — full disk, dead mount, or the injected
    ``record_eio`` fault) DEGRADES that session's stream to memory-only
    instead of failing the request: the file handle is dropped, the
    session keeps serving, ``degraded_streams`` counts the evidence (and
    rides the ``serve_record_write_errors_total`` registry counter +
    ``/healthz`` degraded status). A clean close writes a
    ``session_close`` marker row so crash restore can tell a finished
    session from one that was live at process death.
    """

    def __init__(self, out_dir: Optional[str] = None, registry=None,
                 faults=None):
        self.out_dir = out_dir
        self._lock = threading.Lock()
        self._history: dict[str, list] = {}
        self._files: dict[str, object] = {}
        self._registry = registry
        self.faults = faults        # optional FaultInjector (record_eio)
        self._task_of: dict[str, str] = {}  # sid -> task (fault filter)
        self.rows_written = 0
        self.degraded_streams = 0   # streams downgraded to memory-only
        if out_dir:
            os.makedirs(out_dir, exist_ok=True)

    def _counter(self):
        return _counters(self._registry).counter(
            "serve_record_rows_total",
            "Per-round decision rows streamed by the serving recorder")

    def _write(self, sid: str, f, line: str) -> None:
        """One flushed stream write; degrades the stream on failure.
        Caller holds ``_lock`` and has already committed the row to the
        in-memory history — a full disk must not lose the session."""
        try:
            if self.faults is not None:
                self.faults.fire("record_write",
                                 task=self._task_of.get(sid))
            f.write(line)
            f.flush()  # crash-mid-session keeps every completed row
        except OSError as e:
            self._files.pop(sid, None)
            self.degraded_streams += 1
            try:
                f.close()
            except OSError:
                pass
            _counters(self._registry).counter(
                "serve_record_write_errors_total",
                "Recorder stream writes that failed; the stream degraded "
                "to memory-only").inc()
            import sys

            print(f"recorder: stream for session {sid} degraded to "
                  f"memory-only ({e})", file=sys.stderr)

    def open(self, sid: str, meta: Optional[dict] = None) -> None:
        with self._lock:
            self._history[sid] = []
            if meta and meta.get("task"):
                self._task_of[sid] = meta["task"]
            if self.out_dir:
                f = open(os.path.join(self.out_dir,
                                      f"session_{sid}.jsonl"), "a")
                self._files[sid] = f
                header = {"v": SESSION_SCHEMA_VERSION, "kind": "session_meta",
                          "session": sid}
                header.update(meta or {})
                self._write(sid, f, json.dumps(header, default=str) + "\n")

    def import_history(self, sid: str, meta: Optional[dict] = None,
                       rows=()) -> None:
        """Seed a session's history from an imported/restored stream.

        The portable session log moves WITH the session: on a fresh
        record dir the full history (meta + rows) is written so the new
        server's stream is self-contained; when the stream file already
        exists here AND is a live prefix of the imported rows (crash
        restore against the same dir), it is resumed by appending only
        the missing suffix — a file that is closed (the session migrated
        away from this dir and is now coming back), unreadable, or ahead
        of the payload is rewritten whole, since appending after a close
        marker or a row gap would leave a stream a later crash restore
        replays into a false divergence. A resumed file may end in a
        TORN line (the crash the restore is recovering from happened
        mid-write); that tail is truncated before appending —
        concatenating a new row onto the fragment would corrupt a
        mid-file line and make the stream unreadable."""
        rows = [dict(r) for r in rows]
        path = (os.path.join(self.out_dir, f"session_{sid}.jsonl")
                if self.out_dir else None)
        resume = path is not None and os.path.exists(path)
        n_existing = 0
        if resume:
            _truncate_torn_tail(path)
            n_existing, resumable = _count_stream_rows(path)
            if not resumable or n_existing > len(rows):
                resume, n_existing = False, 0
        with self._lock:
            self._history[sid] = rows
            if meta and meta.get("task"):
                self._task_of[sid] = meta["task"]
            if path is None:
                return
            f = open(path, "a" if resume else "w")
            self._files[sid] = f
            lines = []
            if not resume:
                header = {"v": SESSION_SCHEMA_VERSION,
                          "kind": "session_meta", "session": sid}
                header.update(meta or {})
                lines.append(json.dumps(header, default=str))
            lines += [json.dumps(dict(r, v=SESSION_SCHEMA_VERSION),
                                 default=str) for r in rows[n_existing:]]
            if lines:
                self._write(sid, f, "\n".join(lines) + "\n")

    def append(self, sid: str, row: dict) -> None:
        with self._lock:
            hist = self._history.get(sid)
            if hist is None:
                return  # session closed (or never opened) while queued
            row = dict(row, v=SESSION_SCHEMA_VERSION)
            hist.append(row)
            self.rows_written += 1
            f = self._files.get(sid)
            if f is not None:
                self._write(sid, f, json.dumps(row, default=str) + "\n")
        self._counter().inc()

    def history(self, sid: str) -> Optional[list]:
        with self._lock:
            hist = self._history.get(sid)
            return list(hist) if hist is not None else None

    def park(self, sid: str) -> None:
        """Release a live stream's host resources WITHOUT ending it — the
        warm-tier demotion hook (serve/tiering.py): the fd closes (100k
        parked sessions must not hold 100k file handles) and the
        in-memory history drops (the demotion payload carries the rows),
        but NO close marker is written — the stream is still a live
        session's record, and crash restore must rebuild it. Wake resumes
        the file through :meth:`import_history`'s append path."""
        with self._lock:
            self._history.pop(sid, None)
            self._task_of.pop(sid, None)
            f = self._files.pop(sid, None)
        if f is not None:
            try:
                f.close()
            except OSError:
                pass

    def seal(self, sid: str) -> None:
        """End a PARKED session's stream: append the ``session_close``
        marker to its file (hibernate/discard of a non-resident session —
        from there the hibernate payload, or nothing, is the authority
        and crash restore must skip the stream). A still-live stream is
        closed normally instead."""
        with self._lock:
            live = sid in self._files or sid in self._history
        if live:
            self.close(sid)
            return
        if not self.out_dir:
            return
        path = os.path.join(self.out_dir, f"session_{sid}.jsonl")
        if not os.path.exists(path):
            return
        try:
            with open(path, "a") as f:
                f.write(json.dumps(
                    {"v": SESSION_SCHEMA_VERSION, "kind": "session_close",
                     "session": sid}) + "\n")
        except OSError:
            pass

    def close(self, sid: str) -> None:
        with self._lock:
            self._history.pop(sid, None)
            self._task_of.pop(sid, None)
            f = self._files.pop(sid, None)
            if f is not None:
                # the clean-shutdown marker crash restore keys on: a
                # stream WITHOUT it was live when the process died
                try:
                    f.write(json.dumps(
                        {"v": SESSION_SCHEMA_VERSION,
                         "kind": "session_close", "session": sid}) + "\n")
                    f.flush()
                except OSError:
                    pass
        if f is not None:
            try:
                f.close()
            except OSError:
                pass

    def close_all(self) -> None:
        with self._lock:
            files = list(self._files.items())
            self._files.clear()
            self._history.clear()
            self._task_of.clear()
        for sid, f in files:
            try:
                f.write(json.dumps(
                    {"v": SESSION_SCHEMA_VERSION, "kind": "session_close",
                     "session": sid}) + "\n")
                f.close()
            except OSError:
                pass
