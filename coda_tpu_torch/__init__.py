"""coda_tpu_torch — the PyTorch/CUDA port of coda_tpu.

CODA (consensus-driven active model selection) on an NVIDIA H100: the
``(H, N, C)`` prediction tensor, the selector state and every per-round
pass live on the card, and the reference package's Pallas TPU kernels are
hand-written CUDA kernels here (``csrc/``, built with ``nvcc`` for
``sm_90a`` at first use). ``coda_tpu`` stays the reference; this package
imports neither it nor JAX. Entry points run on ``cuda`` unless the caller
passes ``device="cpu"``, where every kernel's plain PyTorch version runs.
"""

from coda_tpu_torch.data import Dataset, make_synthetic_task
from coda_tpu_torch.losses import LOSS_FNS, accuracy_loss
from coda_tpu_torch.oracle import Oracle, true_losses

__version__ = "0.1.0"

__all__ = [
    "Dataset",
    "make_synthetic_task",
    "Oracle",
    "true_losses",
    "LOSS_FNS",
    "accuracy_loss",
]
