"""The delta pi-hat row gather: the CUDA kernel and its plain version
(counterpart of ``coda_tpu/ops/pallas_gather.py``).

Kernel 3, :func:`gather_rows_sum`, replaces the Pallas ``_gather_kernel``:
``out[n] = Σ_h preds_by_class[s_h, h, n]`` summed in h order, over the
``(C, H, N)`` contiguous transpose of the predictions that
:func:`prep_gather_layout` builds once per experiment. The source is
``csrc/row_gather.cu`` (its header states the byte bound and the design).
:func:`gather_rows_sum_batched` is the same kernel with a replica axis
(the seed-batched engine's ``(S, H)`` classes, one launch for all S).
A CUDA tensor launches the kernel or raises; only a CPU tensor takes the
plain version. :func:`gather_rows_sum_inorder` is the plain version that
sums in the kernel's order (h from 0, fp32), for the tests that hold the
kernel to it bitwise. :func:`gather_rows_sum_sharded` and its batched form
run kernel 3 on a mesh rank's ``(C, H/b, N/a)`` block, the model group
completing the column.
"""

from __future__ import annotations

import ctypes

import torch

from coda_tpu_torch.ops.build import load
from coda_tpu_torch.parallel.collectives import gather_sum
from coda_tpu_torch.parallel.mesh import MODEL_AXIS

# launches of the kernel, counted where the wrapper launches it
launch_counts = {"row_gather": 0, "row_gather_batched": 0}

_MAX_GRID_Y = 65535   # replicas of one batched launch, as kernels 4-5


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


def gather_rows_sum_inorder(preds_by_class: torch.Tensor,
                            pred_classes: torch.Tensor) -> torch.Tensor:
    """Kernel 3's sum in its own order: ``acc = acc + row(s_h, h)`` for h
    from 0, in fp32 — the Pallas kernel's accumulator. ``(H,)`` classes
    give ``(N,)``, ``(S, H)`` give ``(S, N)``. One PyTorch add per model:
    for the tests and the chip smoke test, not the main path."""
    H = preds_by_class.shape[1]
    s = pred_classes.to(torch.int64)
    acc = torch.zeros((*s.shape[:-1], preds_by_class.shape[2]),
                      dtype=torch.float32, device=preds_by_class.device)
    for h in range(H):
        acc = acc + preds_by_class[s[..., h], h]
    return acc


def gather_rows_sum_batched_plain(preds_by_class: torch.Tensor,
                                  pred_classes: torch.Tensor) -> torch.Tensor:
    """Plain version of the batched kernel 3: ``(S, H)`` classes ->
    ``(S, N)``, one indexing expression for all replicas."""
    H = preds_by_class.shape[1]
    h = torch.arange(H, device=preds_by_class.device)
    return preds_by_class[pred_classes.to(torch.int64), h].sum(1)


def _lib():
    lib = load("row_gather")
    if not getattr(lib, "_typed", False):
        lib.row_gather_launch.argtypes = [ctypes.c_void_p] * 3 + \
            [ctypes.c_int] * 4 + [ctypes.c_void_p]
        lib.row_gather_launch.restype = ctypes.c_int
        lib.row_gather_batched_launch.argtypes = [ctypes.c_void_p] * 3 + \
            [ctypes.c_int] * 5 + [ctypes.c_void_p]
        lib.row_gather_batched_launch.restype = ctypes.c_int
        lib._typed = True
    return lib


def _check(preds_by_class: torch.Tensor, pred_classes: torch.Tensor,
           lead: tuple) -> torch.Tensor:
    """Device, dtype and shape the kernel accepts; returns the classes as
    contiguous int32."""
    dev = preds_by_class.device
    if dev.type != "cuda":
        raise ValueError(f"row_gather takes CUDA tensors; got {dev}")
    if (preds_by_class.dim() != 3 or preds_by_class.dtype != torch.float32
            or not preds_by_class.is_contiguous()):
        raise ValueError("preds_by_class must be a contiguous float32 "
                         "(C, H, N) tensor")
    H = preds_by_class.shape[1]
    if (tuple(pred_classes.shape) != (*lead, H) or pred_classes.device != dev
            or torch.is_floating_point(pred_classes)):
        raise ValueError(f"pred_classes must be an integer {(*lead, H)} "
                         f"tensor on {dev}")
    return pred_classes.to(torch.int32).contiguous()


def _aligned(preds_by_class: torch.Tensor) -> bool:
    """Every row segment starts 16-byte aligned (N a multiple of 4, the
    tensor 16-byte aligned): the kernel's ring of 16-byte copies; else its
    4-byte path."""
    N = preds_by_class.shape[2]
    return N % 4 == 0 and preds_by_class.data_ptr() % 16 == 0


def _raise_on(rc: int) -> None:
    if rc != 0:
        raise RuntimeError(f"row_gather launch failed: cudaError {rc}")


def gather_rows_sum(preds_by_class: torch.Tensor,
                    pred_classes: torch.Tensor) -> torch.Tensor:
    """Kernel 3 (``csrc/row_gather.cu``): ``(N,)`` sum over models h of row
    ``pred_classes[h]`` of ``preds_by_class`` ``(C, H, N)``. CPU tensors
    take :func:`gather_rows_sum_plain`. A class index outside ``[0, C)``
    gives NaN (the kernel reads nothing then)."""
    if preds_by_class.device.type == "cpu":
        return gather_rows_sum_plain(preds_by_class, pred_classes)
    s = _check(preds_by_class, pred_classes, ())
    C, H, N = preds_by_class.shape
    out = torch.empty(N, dtype=torch.float32, device=preds_by_class.device)
    _raise_on(_lib().row_gather_launch(
        preds_by_class.data_ptr(), s.data_ptr(), out.data_ptr(), C, H, N,
        int(_aligned(preds_by_class)),
        torch.cuda.current_stream().cuda_stream))
    launch_counts["row_gather"] += 1
    return out


def gather_rows_sum_batched(preds_by_class: torch.Tensor,
                            pred_classes: torch.Tensor) -> torch.Tensor:
    """Kernel 3 with a replica axis (``csrc/row_gather.cu``): ``(S, N)``,
    row ``s`` the sum over models h of row ``pred_classes[s, h]``, bitwise
    the single-replica kernel's, in one launch for all S replicas. CPU
    tensors take :func:`gather_rows_sum_batched_plain`. A class out of
    range gives NaN for that replica only."""
    if preds_by_class.device.type == "cpu":
        return gather_rows_sum_batched_plain(preds_by_class, pred_classes)
    if pred_classes.dim() != 2 or not 1 <= pred_classes.shape[0] \
            <= _MAX_GRID_Y:
        raise ValueError(f"pred_classes must be (S, H) with 1 <= S <= "
                         f"{_MAX_GRID_Y}; got {tuple(pred_classes.shape)}")
    S = pred_classes.shape[0]
    s = _check(preds_by_class, pred_classes, (S,))
    C, H, N = preds_by_class.shape
    out = torch.empty((S, N), dtype=torch.float32,
                      device=preds_by_class.device)
    _raise_on(_lib().row_gather_batched_launch(
        preds_by_class.data_ptr(), s.data_ptr(), out.data_ptr(), S, C, H, N,
        int(_aligned(preds_by_class)),
        torch.cuda.current_stream().cuda_stream))
    launch_counts["row_gather_batched"] += 1
    return out


def gather_rows_sum_sharded(preds_by_class: torch.Tensor,
                            pred_classes: torch.Tensor, mesh,
                            plain: bool = False) -> torch.Tensor:
    """Kernel 3 on a mesh rank's block: ``preds_by_class`` its ``(C, H/b,
    N/a)`` layout and ``pred_classes`` its models' ``(H/b,)`` classes ->
    the ``(N/a,)`` column, the sum over this rank's models completed by the
    model group's rank-order sum (no collective without a model axis).
    ``plain``: the plain version on any device."""
    fn = gather_rows_sum_plain if plain else gather_rows_sum
    part = fn(preds_by_class, pred_classes)
    return gather_sum(part, mesh, MODEL_AXIS) if mesh.model > 1 else part


def gather_rows_sum_batched_sharded(preds_by_class: torch.Tensor,
                                    pred_classes: torch.Tensor, mesh,
                                    plain: bool = False) -> torch.Tensor:
    """The batched kernel 3 on a mesh rank's block: ``(S, H/b)`` classes
    -> ``(S, N/a)``, as :func:`gather_rows_sum_sharded`."""
    fn = gather_rows_sum_batched_plain if plain else gather_rows_sum_batched
    part = fn(preds_by_class, pred_classes)
    return gather_sum(part, mesh, MODEL_AXIS) if mesh.model > 1 else part
