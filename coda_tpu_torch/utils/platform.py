"""Device resolution for the port's entry points.

Every entry point takes a ``device`` argument and runs on the card unless
the caller asks for the CPU (as the tests do). Without a usable CUDA
device a request for one raises — the port never carries on quietly on
the CPU, where its numbers would mean something else.
"""

from __future__ import annotations

from typing import Optional, Union

import torch

DeviceLike = Union[str, torch.device, None]


def resolve_device(device: DeviceLike = None) -> torch.device:
    """``None`` -> ``cuda``; a CUDA request without a CUDA device raises."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "coda_tpu_torch runs on a CUDA device by default and none is "
            "available; pass device='cpu' to run the plain PyTorch path "
            "on the CPU")
    return dev


def pin_fp32_matmul() -> None:
    """Full-fp32 matrix products: the reference runs its contractions at
    ``lax.Precision.HIGHEST``, so TF32 (about three decimal digits) is
    off for every matmul and convolution."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.set_float32_matmul_precision("highest")


def device_name(device: Optional[torch.device] = None) -> str:
    dev = torch.device("cpu" if device is None else device)
    if dev.type == "cuda":
        return torch.cuda.get_device_name(dev)
    return "cpu"
