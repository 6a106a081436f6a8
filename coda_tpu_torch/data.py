"""Model-selection datasets: the ``(H, N, C)`` prediction tensor
(counterpart of ``coda_tpu/data.py``).

A dataset is a dense float32 tensor of post-softmax scores — H models x N
points x C classes — plus an optional ``(N,)`` int32 label vector.
``.npy``/``.npz``/``.pt`` files load as in the reference package, and
:func:`make_synthetic_task` builds its arrays with the same numpy calls,
so both packages see bitwise-identical tasks. Tensors land on the card
unless the caller passes ``device="cpu"``.

With a ``mesh`` (``parallel/mesh.py``) a rank keeps only its ``(H/b,
N/a)`` block of ``preds`` and its N block of ``labels`` (the counterpart
of the reference's sharded placement, ``P(model, data, None)``): a
``.npy`` file is memory-mapped, so a rank reads only its block (H leads,
so each of its models is one contiguous read); the synthetic task is
built whole by the same numpy calls and then sliced, so every block is
bitwise the unsharded task's. With ``unsharded_fallback`` a task whose N
does not divide the data axis, or whose H does not divide the model axis,
loads unsharded instead, with the reference's warning on stderr.
"""

from __future__ import annotations

import functools
import os
import sys
from dataclasses import dataclass, field
from typing import Callable, Optional

import numpy as np
import torch

from coda_tpu_torch.parallel.mesh import Mesh, check_divisible, shard_preds
from coda_tpu_torch.utils.platform import DeviceLike, resolve_device

DATA_EXTS = (".npy", ".npz", ".pt")


def find_task_file(data_dir: str, task: str) -> Optional[str]:
    """Path of ``<data_dir>/<task>.{npy,npz,pt}``, or None."""
    for ext in DATA_EXTS:
        fp = os.path.join(data_dir, task + ext)
        if os.path.exists(fp):
            return fp
    return None


def list_tasks(data_dir: str) -> list[str]:
    """Task names with a prediction tensor under ``data_dir`` (label files
    excluded), sorted."""
    tasks = set()
    for f in os.listdir(data_dir):
        base, ext = os.path.splitext(f)
        if ext in DATA_EXTS and not base.endswith("_labels"):
            tasks.add(base)
    return sorted(tasks)


def _load_array(filepath: str, mmap: bool = False) -> np.ndarray:
    """Load a dense array from .npy/.npz/.pt into host memory (numpy);
    ``mmap``: a ``.npy`` file memory-mapped read-only instead."""
    if filepath.endswith(".npy"):
        return np.load(filepath, mmap_mode="r" if mmap else None)
    if filepath.endswith(".npz"):
        with np.load(filepath) as z:
            return z["preds"] if "preds" in z.files else z[z.files[0]]
    if filepath.endswith(".pt"):
        t = torch.load(filepath, map_location="cpu", weights_only=True)
        return t.detach().cpu().numpy()
    raise ValueError(f"Unsupported dataset file format: {filepath}")


def _labels_path(filepath: str) -> str:
    root, ext = os.path.splitext(filepath)
    return f"{root}_labels{ext}"


@dataclass
class Dataset:
    """A model-selection dataset.

    Attributes:
      preds: ``(H, N, C)`` float32 post-softmax scores (under a ``mesh``
        this rank's ``(H/b, N/a, C)`` block).
      labels: optional ``(N,)`` int32 ground-truth classes (under a
        ``mesh`` this rank's block).
      name: task name.
      filenames: optional ``(N,)`` source-item filenames.
      class_names: optional ``(C,)`` human-readable class names.
      mesh: the mesh the task is sharded over, or None.
      whole_digest: under a ``mesh``, the flight recorder's digest of the
        whole task, computed on demand from its source (a rank holds only
        its block).
    """

    preds: torch.Tensor
    labels: Optional[torch.Tensor] = None
    name: str = "task"
    filenames: Optional[list] = None
    class_names: Optional[list] = None
    mesh: Optional[Mesh] = None
    whole_digest: Optional[Callable[[], str]] = field(default=None,
                                                      repr=False)

    def digest(self) -> str:
        """The recorder's ``dataset_digest`` of the whole task's preds and
        labels (the reference's bytes), under a mesh too."""
        if self.mesh is None:
            from coda_tpu_torch.telemetry.recorder import dataset_digest

            return dataset_digest(self.preds, self.labels)
        if self.whole_digest is None:
            raise ValueError(f"task {self.name!r} is a rank's block with no "
                             "source to digest the whole task from")
        return self.whole_digest()

    @property
    def shape(self) -> tuple[int, int, int]:
        """The task's ``(H, N, C)`` (the global counts under a mesh)."""
        h, n, C = self.preds.shape
        if self.mesh is None:
            return (h, n, C)
        return (h * self.mesh.model, n * self.mesh.data, C)

    @classmethod
    def from_file(cls, filepath: str, name: Optional[str] = None,
                  device: DeviceLike = None, mesh: Optional[Mesh] = None,
                  unsharded_fallback: bool = False) -> "Dataset":
        """Load ``<task>.{npy,npz,pt}`` (+ optional ``<task>_labels.*``);
        under a ``mesh`` this rank's block, on the mesh's device."""
        preds_np = _load_array(filepath, mmap=mesh is not None)
        if preds_np.ndim != 3:
            raise ValueError(f"preds must be (H, N, C); got {preds_np.shape}")
        task = name or os.path.splitext(os.path.basename(filepath))[0]
        mesh = _placement(preds_np.shape[1], mesh, unsharded_fallback, task,
                          H=preds_np.shape[0])
        dev = mesh.device if mesh is not None else resolve_device(device)

        labels_np = None
        filenames = class_names = None
        if filepath.endswith(".npz"):
            with np.load(filepath) as z:
                if "labels" in z.files:
                    labels_np = z["labels"].astype(np.int32)
                if "filenames" in z.files:
                    filenames = [str(s) for s in z["filenames"]]
                if "classes" in z.files:
                    class_names = [str(s) for s in z["classes"]]
        if labels_np is None:
            lp = _labels_path(filepath)
            if os.path.exists(lp):
                labels_np = _load_array(lp).astype(np.int32)
        if mesh is not None:
            return cls(
                preds=shard_preds(preds_np, mesh).local.float(),
                labels=(None if labels_np is None
                        else shard_preds(labels_np, mesh, dim=0).local),
                name=task, filenames=filenames, class_names=class_names,
                mesh=mesh, whole_digest=functools.partial(
                    _file_digest, filepath, labels_np))
        preds_np = preds_np.astype(np.float32)    # fp32 mandatory
        labels = (None if labels_np is None
                  else torch.from_numpy(labels_np).to(dev))
        return cls(preds=torch.from_numpy(preds_np).to(dev), labels=labels,
                   name=task, filenames=filenames, class_names=class_names)


def _file_digest(filepath: str, labels_np: Optional[np.ndarray]) -> str:
    """The recorder's digest of a task file's whole preds (fp32, a ``.npy``
    read through a memory map) and labels."""
    from coda_tpu_torch.telemetry.recorder import dataset_digest

    preds = _load_array(filepath, mmap=True)
    if preds.dtype != np.float32:
        preds = preds.astype(np.float32)
    return dataset_digest(preds, labels_np)


def _placement(N: int, mesh: Optional[Mesh], unsharded_fallback: bool,
               name: str, warn=None, H: Optional[int] = None
               ) -> Optional[Mesh]:
    """The mesh a task of N items (and H models) is sharded over:
    ``mesh``, or None when N does not divide its data axis (or H its
    model axis) and ``unsharded_fallback`` lets the task load unsharded
    (with the reference's warning on stderr, so a heterogeneous sweep
    does not abort on one awkward shape; printed by rank 0 alone)."""
    if mesh is None:
        return None
    try:
        check_divisible(N, mesh, H)
    except ValueError as e:
        if not unsharded_fallback:
            raise
        if mesh.rank == 0:
            warn = warn or functools.partial(print, file=sys.stderr)
            warn(f"[data] {name}: sharded placement failed ({e}); "
                 "loading unsharded")
        return None
    return mesh


def make_synthetic_arrays(seed: int, H: int = 8, N: int = 200, C: int = 4,
                          acc_lo: float = 0.35, acc_hi: float = 0.9,
                          sharpness: float = 4.0
                          ) -> tuple[np.ndarray, np.ndarray]:
    """The host arrays ``(preds (H, N, C) float32, labels (N,) int32)`` of
    the seeded synthetic task — the reference's numpy calls in the
    reference's order, so the bits agree.

    Models span true accuracies in ``[acc_lo, acc_hi]``; each model's
    per-point prediction is a peaked softmax whose argmax equals the true
    label with that model's accuracy.
    """
    rng = np.random.default_rng(seed)
    labels = rng.integers(0, C, size=N).astype(np.int32)
    accs = np.linspace(acc_lo, acc_hi, H)
    # shuffle so the best model isn't always index H-1
    rng.shuffle(accs)

    logits = rng.normal(0.0, 1.0, size=(H, N, C)).astype(np.float32)
    correct = rng.random((H, N)) < accs[:, None]
    # wrong predicted class: shift true label by a random non-zero offset
    offsets = rng.integers(1, C, size=(H, N))
    wrong_cls = (labels[None, :] + offsets) % C
    pred_cls = np.where(correct, labels[None, :], wrong_cls)
    idx_h, idx_n = np.meshgrid(np.arange(H), np.arange(N), indexing="ij")
    logits[idx_h, idx_n, pred_cls] += sharpness
    # softmax
    logits -= logits.max(-1, keepdims=True)
    p = np.exp(logits)
    p /= p.sum(-1, keepdims=True)
    return p.astype(np.float32), labels


def make_synthetic_task(seed: int, H: int = 8, N: int = 200, C: int = 4,
                        acc_lo: float = 0.35, acc_hi: float = 0.9,
                        sharpness: float = 4.0, name: Optional[str] = None,
                        device: DeviceLike = None,
                        mesh: Optional[Mesh] = None,
                        unsharded_fallback: bool = False) -> Dataset:
    """Seeded synthetic model-selection task (see
    :func:`make_synthetic_arrays`), placed on ``device``; under a
    ``mesh`` built whole and sliced to this rank's ``(H/b, N/a)`` block."""
    name = name or f"synthetic_h{H}_n{N}_c{C}_s{seed}"
    mesh = _placement(N, mesh, unsharded_fallback, name, H=H)
    p, labels = make_synthetic_arrays(seed, H, N, C, acc_lo, acc_hi,
                                      sharpness)
    if mesh is not None:
        from coda_tpu_torch.telemetry.recorder import dataset_digest

        # the whole task exists only here: digest it before it is sliced
        whole = dataset_digest(p, labels)
        return Dataset(preds=shard_preds(p, mesh).local,
                       labels=shard_preds(labels, mesh, dim=0).local,
                       name=name, mesh=mesh, whole_digest=lambda: whole)
    dev = resolve_device(device)
    return Dataset(
        preds=torch.from_numpy(p).to(dev),
        labels=torch.from_numpy(labels).to(dev),
        name=name,
    )
