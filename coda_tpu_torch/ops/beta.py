"""Beta-distribution primitives for the P(best) kernel (counterpart of
``coda_tpu/ops/beta.py``): the Dirichlet-diagonal -> Beta reduction (from
dense or compact rows), the Beta log-pdf, the cumulative trapezoid on a
uniform grid and the logistic-normal closed forms of the amortized
tables. fp32 throughout, no data-dependent control flow."""

from __future__ import annotations

import math

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


def sparse_rows_to_beta(diag: torch.Tensor, vals: torch.Tensor,
                        resid: torch.Tensor, *, includes_diag: bool = False
                        ) -> tuple[torch.Tensor, torch.Tensor]:
    """Diagonal Beta marginals straight from compact class rows
    (``ops/sparse_rows.py``): ``diag`` ``(..., C)``, ``vals`` ``(..., C,
    K)`` tracked off-diagonal values — or, in the K = C parity layout
    (``includes_diag=True``), the full rows with the diagonal at its
    column — and ``resid`` ``(..., C)`` untracked off-diagonal mass.
    Returns ``(alpha_cc, beta_cc)`` each ``(..., C)``."""
    if includes_diag:
        return diag, vals.sum(-1) - diag
    return diag, vals.sum(-1) + resid


# -- the amortized predictive-uncertainty approximation (arXiv 1905.12194) --
# The two-class reduction of the Laplace bridge maps Beta(a, b) to
# logit(X) ~ N(digamma(a) - digamma(b), polygamma(1, a) + polygamma(1, b)),
# whose pdf and cdf have closed forms: no lgamma grids and no cumulative
# trapezoid (the ``eig_pbest='amortized'`` tables).

def beta_logit_normal_params(a: torch.Tensor, b: torch.Tensor
                             ) -> tuple[torch.Tensor, torch.Tensor]:
    """``(mu, sigma)`` of the logistic-normal matched to Beta(a, b)."""
    mu = torch.special.digamma(a) - torch.special.digamma(b)
    var = torch.special.polygamma(1, a) + torch.special.polygamma(1, b)
    return mu, torch.sqrt(var)


def logit_normal_log_pdf(x: torch.Tensor, mu: torch.Tensor,
                         sigma: torch.Tensor) -> torch.Tensor:
    """log pdf at x in (0, 1) of the logistic-normal; broadcasts."""
    z = (torch.log(x) - torch.log1p(-x) - mu) / sigma
    return (-0.5 * z * z - 0.5 * math.log(2.0 * math.pi) - torch.log(sigma)
            - torch.log(x) - torch.log1p(-x))


def logit_normal_log_cdf(x: torch.Tensor, mu: torch.Tensor,
                         sigma: torch.Tensor) -> torch.Tensor:
    """log cdf at x in (0, 1) of the logistic-normal (``log_ndtr``)."""
    z = (torch.log(x) - torch.log1p(-x) - mu) / sigma
    return torch.special.log_ndtr(z)
