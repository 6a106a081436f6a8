"""P(model h is best) via the Beta order-statistic integral (counterpart of
``coda_tpu/ops/pbest.py``).

    P(h best) = ∫ pdf_h(x) * Π_{h'≠h} cdf_{h'}(x) dx

on a fixed 256-point grid, normalised — with the reference's numeric
choreography: grid ends 1e-6, cdf floor 1e-30, ±80 clamp on the exclusive
log-product, trapezoid quadrature. All math fp32.
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from coda_tpu_torch.ops.beta import (
    beta_log_pdf,
    cumtrapz_uniform,
    dirichlet_to_beta,
)
from coda_tpu_torch.utils.checks import debug_check_finite

NUM_POINTS = 256
_EPS = 1e-30
_LOG_CLAMP = 80.0
_GRID_LO = 1e-6


def _grid_np(num_points: int) -> np.ndarray:
    """The grid by ``jnp.linspace(lo, 1 - lo, G, float32)``'s formula:
    ``lo·(1 - i/(G-1)) + hi·(i/(G-1))`` in float32, endpoint appended (XLA
    may fold it to within an ulp of this, depending on context)."""
    f32 = np.float32
    lo, hi = f32(_GRID_LO), f32(1.0 - _GRID_LO)
    div = num_points - 1
    step = (np.arange(div, dtype=f32) / f32(div)).astype(f32)
    out = lo * (f32(1.0) - step) + hi * step
    return np.concatenate([out, [hi]]).astype(f32)


@functools.lru_cache(maxsize=None)
def _grid_on(num_points: int, device: torch.device) -> torch.Tensor:
    return torch.from_numpy(_grid_np(num_points)).to(device)


def pbest_grid(num_points: int = NUM_POINTS,
               device=None) -> torch.Tensor:
    """The fixed integration grid in (0, 1). Built once per device: a
    host-to-card copy inside the round would synchronise the stream.
    Callers must not modify it."""
    return _grid_on(num_points, torch.device("cpu" if device is None
                                             else device))


def compute_pbest(alpha: torch.Tensor, beta: torch.Tensor,
                  num_points: int = NUM_POINTS,
                  eps: float = _EPS) -> torch.Tensor:
    """P(h best) over the last axis H of Beta parameters ``(..., H)``.
    Returns ``(..., H)`` normalised probabilities."""
    x = pbest_grid(num_points, alpha.device)  # (G,)
    dx = x[1] - x[0]

    pdf = torch.exp(beta_log_pdf(x, alpha[..., None], beta[..., None]))
    debug_check_finite(pdf, "pbest.pdf")

    cdf = cumtrapz_uniform(pdf, dx, dim=-1)
    log_cdf = torch.log(torch.clamp_min(cdf, eps))

    # exclusive product over models, in log space, clamped like the
    # reference to avoid inf when many tiny cdfs multiply
    log_prod_excl = torch.clamp(
        log_cdf.sum(-2, keepdim=True) - log_cdf, -_LOG_CLAMP, _LOG_CLAMP)
    integrand = pdf * torch.exp(log_prod_excl)
    debug_check_finite(integrand, "pbest.integrand")

    # jnp.trapezoid(integrand, x): 0.5 * Σ diff(x) * (y[1:] + y[:-1])
    prob = 0.5 * (torch.diff(x) * (integrand[..., 1:]
                                   + integrand[..., :-1])).sum(-1)
    prob = prob / torch.clamp_min(prob.sum(-1, keepdim=True), eps)
    debug_check_finite(prob, "pbest.normalized")
    return prob


def pbest_row_mixture(dirichlets: torch.Tensor, pi_hat: torch.Tensor,
                      num_points: int = NUM_POINTS) -> torch.Tensor:
    """Marginal P(h best) under the class prior: ``(..., H, C, C)``
    Dirichlets and ``(C,)`` pi-hat -> ``(..., H)``
    ``Σ_c P(h best | class c) · pi_hat(c)``."""
    alpha_cc, beta_cc = dirichlet_to_beta(dirichlets)   # (..., H, C)
    a = alpha_cc.transpose(-1, -2)
    b = beta_cc.transpose(-1, -2)
    rows = compute_pbest(a, b, num_points=num_points)    # (..., C, H)
    return (rows * pi_hat[..., :, None]).sum(-2)
