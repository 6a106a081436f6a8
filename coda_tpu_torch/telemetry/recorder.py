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
(``SessionRecorder``) come with slice 8 of the port. ``save`` feeds the
registry's recorder counters (``telemetry/registry.py``), as the
reference's does.
"""

from __future__ import annotations

import hashlib
import json
import os
import re
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
