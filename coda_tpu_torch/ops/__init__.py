"""Tensor ops of the port: the P(best) integral, confusion priors, masked
selection, and the CUDA kernels with their plain versions."""

from coda_tpu_torch.ops.beta import (
    beta_log_pdf,
    cumtrapz_uniform,
    dirichlet_to_beta,
)
from coda_tpu_torch.ops.confusion import (
    create_confusion_matrices,
    ensemble_preds,
    initialize_dirichlets,
)
from coda_tpu_torch.ops.masked import (
    entropy2,
    masked_argmax_tiebreak,
    masked_argmin_tiebreak,
    masked_categorical,
)
from coda_tpu_torch.ops.pbest import compute_pbest, pbest_row_mixture

__all__ = [
    "beta_log_pdf",
    "cumtrapz_uniform",
    "dirichlet_to_beta",
    "compute_pbest",
    "pbest_row_mixture",
    "create_confusion_matrices",
    "ensemble_preds",
    "initialize_dirichlets",
    "entropy2",
    "masked_argmax_tiebreak",
    "masked_argmin_tiebreak",
    "masked_categorical",
]
