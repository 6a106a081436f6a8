"""Beta-distribution primitives for the P(best) kernel (counterpart of
``coda_tpu/ops/beta.py``): the Dirichlet-diagonal -> Beta reduction, the
Beta log-pdf and the cumulative trapezoid on a uniform grid. fp32
throughout, no data-dependent control flow."""

from __future__ import annotations

import torch


def dirichlet_to_beta(alpha_dirichlet: torch.Tensor
                      ) -> tuple[torch.Tensor, torch.Tensor]:
    """Diagonal Beta marginals of per-row Dirichlets.

    ``alpha_dirichlet`` ``(..., C, C)`` -> ``(alpha_cc, beta_cc)`` each
    ``(..., C)`` with ``beta_cc = row_sum - alpha_cc``.
    """
    alpha_cc = torch.diagonal(alpha_dirichlet, dim1=-2, dim2=-1)
    beta_cc = alpha_dirichlet.sum(-1) - alpha_cc
    return alpha_cc, beta_cc


def beta_log_pdf(x: torch.Tensor, a: torch.Tensor,
                 b: torch.Tensor) -> torch.Tensor:
    """log Beta(a, b) pdf at x; broadcasts:
    ``(a-1)log x + (b-1)log1p(-x) + lgamma(a+b) - lgamma(a) - lgamma(b)``."""
    return ((a - 1.0) * torch.log(x) + (b - 1.0) * torch.log1p(-x)
            + torch.lgamma(a + b) - torch.lgamma(a) - torch.lgamma(b))


def cumtrapz_uniform(y: torch.Tensor, dx, dim: int = -1) -> torch.Tensor:
    """Cumulative trapezoid integral over a uniform grid, zero-initialised:
    one ``cumsum`` over the per-interval areas."""
    y = y.movedim(dim, -1)
    areas = 0.5 * (y[..., 1:] + y[..., :-1]) * dx
    out = torch.cat([torch.zeros_like(y[..., :1]),
                     torch.cumsum(areas, dim=-1)], dim=-1)
    return out.movedim(-1, dim)
