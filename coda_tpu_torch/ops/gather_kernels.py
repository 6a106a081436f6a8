"""The delta pi-hat row gather: the CUDA kernel and its plain version
(counterpart of ``coda_tpu/ops/pallas_gather.py``).

Kernel 3, :func:`gather_rows_sum`, replaces the Pallas ``_gather_kernel``:
``out[n] = Σ_h preds_by_class[s_h, h, n]`` summed in h order, over the
``(C, H, N)`` contiguous transpose of the predictions that
:func:`prep_gather_layout` builds once per experiment. The source is
``csrc/row_gather.cu`` (its header states the byte bound and the design).
A CUDA tensor launches the kernel or raises; only a CPU tensor takes the
plain version.
"""

from __future__ import annotations

import ctypes

import torch

from coda_tpu_torch.ops.build import load

# launches of the kernel, counted where the wrapper launches it
launch_counts = {"row_gather": 0}

_MAX_SMEM = 48 << 10


def prep_gather_layout(preds: torch.Tensor) -> torch.Tensor:
    """``(H, N, C)`` predictions -> ``(C, H, N)`` contiguous, so each
    model's row for one class is a contiguous N-vector (copies the whole
    tensor: build it once per experiment)."""
    return preds.permute(2, 0, 1).contiguous()


def gather_rows_sum_plain(preds_by_class: torch.Tensor,
                          pred_classes: torch.Tensor) -> torch.Tensor:
    """Plain version of kernel 3: one row per model, summed over models."""
    H = preds_by_class.shape[1]
    h = torch.arange(H, device=preds_by_class.device)
    return preds_by_class[pred_classes.to(torch.int64), h].sum(0)


def _lib():
    lib = load("row_gather")
    if not getattr(lib, "_typed", False):
        lib.row_gather_launch.argtypes = [ctypes.c_void_p] * 3 + \
            [ctypes.c_int] * 3 + [ctypes.c_void_p]
        lib.row_gather_launch.restype = ctypes.c_int
        lib._typed = True
    return lib


def gather_rows_sum(preds_by_class: torch.Tensor,
                    pred_classes: torch.Tensor) -> torch.Tensor:
    """Kernel 3 (``csrc/row_gather.cu``): ``(N,)`` sum over models h of row
    ``pred_classes[h]`` of ``preds_by_class`` ``(C, H, N)``. CPU tensors
    take :func:`gather_rows_sum_plain`. A class index outside ``[0, C)``
    gives NaN (the kernel reads nothing then)."""
    if preds_by_class.device.type == "cpu":
        return gather_rows_sum_plain(preds_by_class, pred_classes)
    dev = preds_by_class.device
    if dev.type != "cuda":
        raise ValueError(f"row_gather takes CUDA tensors; got {dev}")
    if (preds_by_class.dim() != 3 or preds_by_class.dtype != torch.float32
            or not preds_by_class.is_contiguous()):
        raise ValueError("preds_by_class must be a contiguous float32 "
                         "(C, H, N) tensor")
    C, H, N = preds_by_class.shape
    if (tuple(pred_classes.shape) != (H,) or pred_classes.device != dev
            or torch.is_floating_point(pred_classes)):
        raise ValueError(f"pred_classes must be an integer ({H},) tensor on "
                         f"{dev}")
    if 4 * H > _MAX_SMEM:
        raise ValueError(f"H={H} exceeds the kernel's shared-memory budget")
    s = pred_classes.to(torch.int32).contiguous()
    out = torch.empty(N, dtype=torch.float32, device=dev)
    rc = _lib().row_gather_launch(
        preds_by_class.data_ptr(), s.data_ptr(), out.data_ptr(), C, H, N,
        torch.cuda.current_stream().cuda_stream)
    if rc != 0:
        raise RuntimeError(f"row_gather launch failed: cudaError {rc}")
    launch_counts["row_gather"] += 1
    return out
