"""Intra-run checkpoint / resume of a labeling experiment (counterpart of
``coda_tpu/engine/checkpoint.py``, with ``torch.save`` in place of orbax).

The experiment runs round by round (``engine/loop.make_step_fn``); every
``every`` rounds the selector state, the cumulative regret and the filled
prefix of the per-round traces are saved under ``<dir>/step_<r>``. On a
restart the newest usable checkpoint is restored onto the run's device and
the rounds continue from ``r``, replaying nothing. The round keys come
from one ``random.split(k_scan, iters)`` table, which is prefix-stable (row
i depends on i alone, as in JAX's partitionable threefry), so a resume
with a smaller ``iters`` restores an earlier step and is still exact.

Resume is **bitwise**: the port runs the same per-round operations whether
or not a run is cut (there is no scan to recompile per chunk), and the
state crosses the disk bit for bit, a bfloat16 cache included. The
reference's chunked scan agrees with its single scan to about 1 ulp.

The state is flattened by field name, not by leaf position: a
``NamedTuple`` state (``CODAState``, ``LUREState``, ``RiskState``,
``ModelPickerState``, with nested ``SparseRows`` or ``SurrogateFit``)
becomes ``{"__type__": "module:QualName", "fields": {name: ...}}`` with
tensors, None and host values (Python scalars, numpy arrays) in place, so
a checkpoint whose fields differ from the current state class fails with
an actionable "layout change" error instead of mis-assigning leaves. Each
save copies the tensors to the host before it returns: ``update`` writes
the state in place, and the next round must not change a checkpoint
being written. A fingerprint of the selector configuration is saved
beside the steps (``fingerprint.json``) and checked on resume.

What a checkpoint holds is the selector's whole state: at the headline
(H=1000, N=50,000, C=10) CODA's incremental tier carries its (C, N, H)
P(best) cache, 2.0 GB in fp32 (1.0 GB in bfloat16).

Under a mesh (``mesh=``, ``parallel/mesh.py``) each rank saves its own
blocks of the state (its ``(C, N/a, H/b)`` cache block; nothing is
gathered to one rank) under ``<dir>/rank_<r>/``, with a fingerprint that
names the mesh's spec and the rank, so a resume under another spec or
world is refused. A save is complete only when every rank has written
it: the ranks meet after their writes, before any prunes an older step,
and a resume restores the newest step every rank holds
(:func:`latest_step`). A resumed mesh run is bitwise the uninterrupted
mesh run.
"""

from __future__ import annotations

import importlib
import json
import os
import re
import shutil
import time
import zlib
from typing import Callable, Optional

import numpy as np
import torch

from coda_tpu_torch import random as trandom
from coda_tpu_torch.engine.loop import (
    ExperimentResult,
    _validate_rounds,
    make_step_fn,
)
from coda_tpu_torch.oracle import regret_fn
from coda_tpu_torch.parallel.collectives import host_ints, raise_together
from coda_tpu_torch.parallel.mesh import Mesh
from coda_tpu_torch.selectors.protocol import Selector

_STEP_RE = re.compile(r"^step_(\d+)$")
_FINGERPRINT = "fingerprint.json"
_TREE_FILE = "tree.pt"


def _saved_steps(ckpt_dir: str) -> list[int]:
    if not os.path.isdir(ckpt_dir):
        return []
    return sorted(int(m.group(1))
                  for m in map(_STEP_RE.match, os.listdir(ckpt_dir)) if m)


def latest_step(ckpt_dir: str, at_most: Optional[int] = None,
                mesh: Optional[Mesh] = None) -> Optional[int]:
    """The largest checkpointed round (optionally <= ``at_most``), or
    None. Under a ``mesh`` (every rank calls this) ``ckpt_dir`` is the
    run's directory and the round is the largest that every rank's
    ``rank_<r>`` directory holds: a step some rank did not finish is not
    a checkpoint."""
    if mesh is None:
        steps = _saved_steps(ckpt_dir)
    else:
        mine = _saved_steps(rank_dir(ckpt_dir, mesh))
        steps = sorted(set(mine).intersection(*host_ints(mine, mesh)))
    if at_most is not None:
        steps = [s for s in steps if s <= at_most]
    return max(steps) if steps else None


def rank_dir(ckpt_dir: str, mesh: Optional[Mesh]) -> str:
    """Where this rank's steps live: ``ckpt_dir`` unsharded, else
    ``ckpt_dir/rank_<r>``."""
    if mesh is None:
        return ckpt_dir
    return os.path.join(ckpt_dir, f"rank_{mesh.rank}")


def _to_host(tree):
    """``tree`` with every tensor copied to the host (a synchronising
    copy: the caller may mutate the originals as soon as it returns)."""
    if isinstance(tree, torch.Tensor):
        return tree.detach().cpu()
    if isinstance(tree, dict):
        return {k: _to_host(v) for k, v in tree.items()}
    return tree


class ExperimentCheckpointer:
    """Saves/restores a checkpoint tree at round boundaries.

    A save writes ``<dir>/step_<r>.tmp`` and renames it to ``step_<r>``,
    so a cut save never appears under the final name; the newest ``keep``
    steps are kept. ``restore`` loads onto ``device`` (``weights_only``:
    tensors, dicts, lists and Python scalars)."""

    def __init__(self, ckpt_dir: str, keep: int = 2, device=None,
                 barrier: Optional[Callable[[], None]] = None):
        self.ckpt_dir = os.path.abspath(ckpt_dir)
        self.keep = keep
        self.device = torch.device("cpu" if device is None else device)
        # called between a save's rename and the pruning of older steps
        # (a mesh's ranks meet there: no rank prunes the newest step that
        # every rank holds before all have written the next)
        self.barrier = barrier

    def save(self, round_: int, tree) -> None:
        path = os.path.join(self.ckpt_dir, f"step_{round_}")
        tmp = path + ".tmp"
        shutil.rmtree(tmp, ignore_errors=True)
        os.makedirs(tmp)
        torch.save(_to_host(tree), os.path.join(tmp, _TREE_FILE))
        if os.path.exists(path):  # stale complete save from an older run
            shutil.rmtree(path)
        os.rename(tmp, path)
        if self.barrier is not None:
            self.barrier()
        self._gc()

    def restore(self, round_: int):
        return torch.load(
            os.path.join(self.ckpt_dir, f"step_{round_}", _TREE_FILE),
            map_location=self.device, weights_only=True)

    def _gc(self) -> None:
        steps = _saved_steps(self.ckpt_dir)
        for s in steps[: max(0, len(steps) - self.keep)]:
            shutil.rmtree(os.path.join(self.ckpt_dir, f"step_{s}"),
                          ignore_errors=True)


# -- the state, flattened by field name --------------------------------------

def _is_namedtuple(x) -> bool:
    return isinstance(x, tuple) and hasattr(x, "_fields")


def flatten_state(x):
    """A selector state as nested dicts of tensors, None and Python
    scalars, keyed by field name (:func:`unflatten_state` inverts it)."""
    if _is_namedtuple(x):
        cls = type(x)
        return {"__type__": f"{cls.__module__}:{cls.__qualname__}",
                "fields": {f: flatten_state(getattr(x, f))
                           for f in cls._fields}}
    if isinstance(x, np.ndarray):   # a host leaf (PriorStats' arrays)
        return {"__ndarray__": torch.from_numpy(np.array(x))}
    if x is None or isinstance(x, (torch.Tensor, bool, int, float, str)):
        return x
    raise TypeError(f"cannot checkpoint a state leaf of type "
                    f"{type(x).__name__}")


class StaleLayoutError(ValueError):
    pass


def _state_class(name: str):
    module, _, qualname = name.partition(":")
    if not module.startswith("coda_tpu_torch."):
        raise StaleLayoutError(f"state type {name!r} is not the port's")
    obj = importlib.import_module(module)
    for part in qualname.split("."):
        obj = getattr(obj, part, None)
        if obj is None:
            raise StaleLayoutError(f"state type {name!r} no longer exists")
    return obj


def unflatten_state(tree):
    """The state :func:`flatten_state` saved. Raises
    :class:`StaleLayoutError` where a saved state type's fields are not
    the current class's."""
    if isinstance(tree, dict) and "__type__" in tree:
        cls = _state_class(tree["__type__"])
        saved = list(tree["fields"])
        if saved != list(cls._fields):
            raise StaleLayoutError(
                f"{cls.__name__} fields {saved} != this build's "
                f"{list(cls._fields)}")
        return cls(**{f: unflatten_state(v)
                      for f, v in tree["fields"].items()})
    if isinstance(tree, dict) and "__ndarray__" in tree:
        return tree["__ndarray__"].cpu().numpy()
    return tree


# -- the configuration fingerprint ------------------------------------------

def _fingerprint(selector: Selector, labels, seed: int,
                 dataset_id: Optional[str] = None,
                 mesh: Optional[Mesh] = None) -> dict:
    """The reference's fingerprint: selector name, hyperparams and their
    defaults (as ``repr``), the pool size, the labels' CRC32 (same-shape
    tasks differ there), the dataset name and the seed; under a ``mesh``
    also its spec and the rank (``labels`` the rank's block)."""
    lab = labels.detach().cpu().numpy() if hasattr(labels, "detach") \
        else np.asarray(labels)
    where = {} if mesh is None else {"mesh": mesh.spec, "rank": mesh.rank}
    return where | {
        "selector": selector.name,
        "hyperparams": {k: repr(v)
                        for k, v in sorted(selector.hyperparams.items())},
        "_hyperparam_defaults": {
            k: repr(v)
            for k, v in sorted(selector.hyperparam_defaults.items())},
        "n_points": int(lab.shape[0]),
        "labels_crc32": int(zlib.crc32(np.ascontiguousarray(lab)
                                       .tobytes())),
        "dataset": dataset_id,
        "seed": int(seed),
    }


def _layout_error(ckpt_dir: str, mesh: Optional[Mesh]) -> Optional[str]:
    """Why ``ckpt_dir`` (a run's directory) was written under another
    layout: ``rank_<r>`` directories met unsharded, a run's own steps met
    under a mesh; None when it was not."""
    if not os.path.isdir(ckpt_dir):
        return None
    ranks = [d for d in os.listdir(ckpt_dir) if d.startswith("rank_")]
    if mesh is None and ranks:
        return (f"checkpoint dir {ckpt_dir!r} was written under a mesh "
                f"({len(ranks)} rank directories); resume it with the "
                "same --mesh (or use a fresh --checkpoint-dir)")
    if mesh is not None and os.path.exists(
            os.path.join(ckpt_dir, _FINGERPRINT)):
        return (f"checkpoint dir {ckpt_dir!r} was written by an unsharded "
                f"run; it does not resume under --mesh {mesh.spec} (use a "
                "fresh --checkpoint-dir)")
    return None


def _fingerprint_error(ckpt_dir: str, fp: dict) -> Optional[str]:
    """Write ``fp`` into a fresh directory, else require the saved one to
    match it: the refusal's message where it does not (None where it was
    written or matches). A hyperparam the checkpoint predates is
    tolerated while it sits at its default; set to anything else it is a
    mismatch."""
    path = os.path.join(ckpt_dir, _FINGERPRINT)
    if os.path.exists(path):
        with open(path) as f:
            saved = json.load(f)
        saved_hp = saved.get("hyperparams", {})
        defaults = fp.get("_hyperparam_defaults", {})
        cur_hp = {k: v for k, v in fp["hyperparams"].items()
                  if k in saved_hp or v != defaults.get(k, object())}
        cur = dict(fp, hyperparams=cur_hp)
        saved_cmp = {k: v for k, v in saved.items()
                     if k != "_hyperparam_defaults"}
        cur_cmp = {k: v for k, v in cur.items()
                   if k != "_hyperparam_defaults"}
        if saved_cmp != cur_cmp:
            return (f"checkpoint dir {ckpt_dir!r} was written by a different "
                    f"configuration:\n  saved:   {saved}\n  current: {fp}\n"
                    "Use a fresh --checkpoint-dir (or delete this one).")
    else:
        os.makedirs(ckpt_dir, exist_ok=True)
        with open(path, "w") as f:
            json.dump(fp, f, indent=2)
    return None


_TRACE_NAMES = ("chosen_idx", "true_class", "best_model", "regret",
                "cumulative_regret", "select_prob")


def make_resumable_runner(selector: Selector, labels: torch.Tensor,
                          model_losses: torch.Tensor, iters: int,
                          every: int = 25,
                          dataset_id: Optional[str] = None,
                          timings: Optional[list] = None,
                          mesh: Optional[Mesh] = None
                          ) -> Callable[[int, str], ExperimentResult]:
    """``run(seed, ckpt_dir) -> ExperimentResult``: seed ``seed``'s
    ``iters`` rounds on ``labels``' device, checkpointed every ``every``
    rounds (the last chunk is not saved: its result is the run's), resumed
    from the newest checkpoint of ``ckpt_dir`` at or below ``iters``.
    Bitwise the one-seed run of ``engine/loop.build_experiment_fn``.

    ``timings``: when a list is given, each save and restore appends
    ``{"op": "save"|"restore", "round", "seconds", "bytes"}`` (host clock;
    a save's copy to the host synchronises the device; under a mesh this
    rank's bytes and seconds, the ranks' meeting included).

    ``mesh``: ``selector``, ``labels`` and ``model_losses`` are this
    rank's (``engine/loop.make_step_fn``); every rank calls ``run`` with
    the same arguments, saves its blocks under ``ckpt_dir/rank_<r>`` and
    gets the same result."""
    if every < 1:
        raise ValueError(f"every={every} must be >= 1")
    _validate_rounds(selector, labels.shape[0] * (
        mesh.data if mesh is not None else 1), iters)
    regret_of = regret_fn(model_losses, mesh)
    step = make_step_fn(selector, labels, model_losses, mesh=mesh)
    dev = labels.device
    barrier = None
    if mesh is not None and mesh.size > 1:
        def barrier():
            host_ints([], mesh)

    def _size(path: str) -> int:
        return sum(os.path.getsize(os.path.join(d, f))
                   for d, _, fs in os.walk(path) for f in fs)

    def run(seed: int, ckpt_dir: str) -> ExperimentResult:
        key = trandom.PRNGKey(seed)
        k_init, k_prior, k_scan = trandom.split(key, 3)
        round_keys = trandom.split(k_scan, iters)
        mine = rank_dir(ckpt_dir, mesh)
        error = _layout_error(ckpt_dir, mesh)
        raise_together(error or _fingerprint_error(mine, _fingerprint(
            selector, labels, seed, dataset_id, mesh)), mesh)
        ckptr = ExperimentCheckpointer(mine, device=dev, barrier=barrier)
        start = latest_step(ckpt_dir, at_most=iters, mesh=mesh)
        if start:
            t0 = time.perf_counter()
            restored = ckptr.restore(start)
            try:
                state = unflatten_state(restored["state"])
            except StaleLayoutError as e:
                raise ValueError(
                    f"checkpoint at {mine!r} step {start} predates a "
                    f"selector-state layout change ({e}). Use a fresh "
                    "--checkpoint-dir (or delete this one).") from None
            cum = restored["cum"]
            regret0 = restored["regret0"]
            stoch = restored["stochastic"]
            traces = {n: [restored["traces"][n][:start]]
                      for n in _TRACE_NAMES}
            if timings is not None:
                timings.append({
                    "op": "restore", "round": start,
                    "seconds": time.perf_counter() - t0,
                    "bytes": _size(os.path.join(ckptr.ckpt_dir,
                                                f"step_{start}"))})
        else:
            start = 0
            state = selector.init(k_init)
            best0, stoch = selector.best(state, k_prior)
            regret0 = regret_of(best0)
            cum = torch.zeros((), dtype=torch.float32, device=dev)
            traces = {n: [] for n in _TRACE_NAMES}

        for lo in range(start, iters, every):
            hi = min(lo + every, iters)
            outs = []
            for t in range(lo, hi):
                state, cum, o = step(state, cum, round_keys[t])
                outs.append(o)
            cols = [torch.stack(c) for c in zip(*outs)]
            for n, col in zip(_TRACE_NAMES, cols[:6]):
                traces[n].append(col.to(torch.int32) if n in (
                    "chosen_idx", "true_class", "best_model") else col)
            stoch = stoch | cols[6].any()
            if hi < iters:   # the final chunk's result is the run's
                t0 = time.perf_counter()
                ckptr.save(hi, {
                    "state": flatten_state(state), "cum": cum,
                    "regret0": regret0, "stochastic": stoch,
                    "traces": {n: torch.cat(traces[n])
                               for n in _TRACE_NAMES}})
                if timings is not None:
                    timings.append({
                        "op": "save", "round": hi,
                        "seconds": time.perf_counter() - t0,
                        "bytes": _size(os.path.join(ckptr.ckpt_dir,
                                                    f"step_{hi}"))})
        full = {n: torch.cat(traces[n]) for n in _TRACE_NAMES}
        return ExperimentResult(
            **full, regret_at_0=regret0,
            stochastic=stoch | selector.always_stochastic)

    return run


def run_experiment_resumable(selector: Selector, labels: torch.Tensor,
                             model_losses: torch.Tensor, iters: int,
                             seed: int, ckpt_dir: str, every: int = 25,
                             dataset_id: Optional[str] = None,
                             mesh: Optional[Mesh] = None
                             ) -> ExperimentResult:
    """One-shot convenience wrapper around :func:`make_resumable_runner`."""
    return make_resumable_runner(selector, labels, model_losses, iters,
                                 every, dataset_id, mesh=mesh)(seed, ckpt_dir)
