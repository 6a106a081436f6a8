"""Model-selection datasets: the ``(H, N, C)`` prediction tensor
(counterpart of ``coda_tpu/data.py``).

A dataset is a dense float32 tensor of post-softmax scores — H models x N
points x C classes — plus an optional ``(N,)`` int32 label vector.
``.npy``/``.npz``/``.pt`` files load as in the reference package, and
:func:`make_synthetic_task` builds its arrays with the same numpy calls,
so both packages see bitwise-identical tasks. Tensors land on the card
unless the caller passes ``device="cpu"``.
"""

from __future__ import annotations

import os
from dataclasses import dataclass
from typing import Optional

import numpy as np
import torch

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


def _load_array(filepath: str) -> np.ndarray:
    """Load a dense array from .npy/.npz/.pt into host memory (numpy)."""
    if filepath.endswith(".npy"):
        return np.load(filepath)
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
      preds: ``(H, N, C)`` float32 post-softmax scores.
      labels: optional ``(N,)`` int32 ground-truth classes.
      name: task name.
      filenames: optional ``(N,)`` source-item filenames.
      class_names: optional ``(C,)`` human-readable class names.
    """

    preds: torch.Tensor
    labels: Optional[torch.Tensor] = None
    name: str = "task"
    filenames: Optional[list] = None
    class_names: Optional[list] = None

    @property
    def shape(self) -> tuple[int, int, int]:
        return tuple(self.preds.shape)  # (H, N, C)

    @classmethod
    def from_file(cls, filepath: str, name: Optional[str] = None,
                  device: DeviceLike = None) -> "Dataset":
        """Load ``<task>.{npy,npz,pt}`` (+ optional ``<task>_labels.*``)."""
        dev = resolve_device(device)
        preds_np = _load_array(filepath).astype(np.float32)  # fp32 mandatory
        if preds_np.ndim != 3:
            raise ValueError(f"preds must be (H, N, C); got {preds_np.shape}")
        task = name or os.path.splitext(os.path.basename(filepath))[0]

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
        labels = (None if labels_np is None
                  else torch.from_numpy(labels_np).to(dev))
        return cls(preds=torch.from_numpy(preds_np).to(dev), labels=labels,
                   name=task, filenames=filenames, class_names=class_names)


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
                        device: DeviceLike = None) -> Dataset:
    """Seeded synthetic model-selection task (see
    :func:`make_synthetic_arrays`), placed on ``device``."""
    dev = resolve_device(device)
    p, labels = make_synthetic_arrays(seed, H, N, C, acc_lo, acc_hi,
                                      sharpness)
    return Dataset(
        preds=torch.from_numpy(p).to(dev),
        labels=torch.from_numpy(labels).to(dev),
        name=name or f"synthetic_h{H}_n{N}_c{C}_s{seed}",
    )
