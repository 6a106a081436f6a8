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


# -- the hypothetical-label row refresh ------------------------------------
# (the reference keeps these in selectors/coda.py; here the selector and
# kernel 6's wrapper in ops/eig_kernels.py share them)

def _trapz_weights(num_points: int, dx: torch.Tensor) -> torch.Tensor:
    """Uniform-grid trapezoid weights (half weight at both ends)."""
    w = dx.expand(num_points).clone()
    w[0] = 0.5 * dx
    w[-1] = 0.5 * dx
    return w


def _bump_tables(a, b, x, dx, update_weight):
    """Per-model Beta grid tables for the two hypothetical-label variants
    of ``(..., H)`` Beta parameters: "bumped" ``(a+w, b)`` when the model
    predicted the hypothesised class, else "unbumped" ``(a, b+w)``.

    Returns ``(S0, dlogcdf, F_u, dF)`` with the grid axis last:
    ``S0 = Σ_H logcdf_unbumped`` and the ``d*`` tables bumped - unbumped.
    """
    def tab(aa, bb):
        logpdf = beta_log_pdf(x, aa[..., None], bb[..., None])  # (..., H, G)
        cdf = cumtrapz_uniform(torch.exp(logpdf), dx, dim=-1)
        logcdf = torch.log(torch.clamp_min(cdf, _EPS))
        # cap the exponent so fp32 never overflows (binds only where the
        # integrand is ~0 anyway)
        return logcdf, torch.exp(torch.clamp_max(logpdf - logcdf, 85.0))

    logcdf_u, F_u = tab(a, b + update_weight)     # model predicted != c
    logcdf_b, F_b = tab(a + update_weight, b)     # model predicted c
    return logcdf_u.sum(-2), logcdf_b - logcdf_u, F_u, F_b - F_u


def _pbest_hyp_from_tables(tables, eq_t, w_trapz):
    """The hypothetical-row integral for ONE class row over all items:
    per-item exclusive log-cdf sum, max-shift, weighted integrand,
    normalisation. Three fp32 ``(N, H)·(H, G)``/``(N, G)·(G, H)`` products
    left to ``torch.matmul``: the precomputed refresh and kernel 6's plain
    version (the kernel computes them inside its scoring pass). With a
    leading replica axis (tables ``(S, ...)``, ``eq_t`` ``(S, N, H)``) the
    products are batched ``torch.matmul`` calls, one row per replica."""
    S0_t, dlogcdf_t, F_u_t, dF_t = tables
    eq = eq_t.to(w_trapz.dtype)
    S = S0_t.unsqueeze(-2) + eq @ dlogcdf_t            # (N, G)
    S = S - S.amax(-1, keepdim=True)
    wE = w_trapz * torch.exp(S)
    t_base = wE @ F_u_t.transpose(-1, -2)              # (N, H)
    t_diff = wE @ dF_t.transpose(-1, -2)
    unnorm = t_base + eq * t_diff
    return unnorm / torch.clamp_min(unnorm.sum(-1, keepdim=True), _EPS)


def refresh_tables(a_t: torch.Tensor, b_t: torch.Tensor,
                   update_weight: float = 1.0, num_points: int = 256):
    """One class row's O(H·G) tables from its Beta parameters ``a_t``,
    ``b_t`` (H,), as the reference's refresh and its kernel-6 wrapper build
    them: ``(S0 (G,), dlogcdf (H, G), F_u (H, G), dF (H, G), w_trapz
    (G,))``, all contiguous fp32. ``(S, H)`` parameters give each table a
    leading replica axis (``w_trapz`` stays ``(G,)``)."""
    x = pbest_grid(num_points, a_t.device)
    dx = x[1] - x[0]
    S0, dlogcdf, F_u, dF = _bump_tables(a_t, b_t, x, dx, update_weight)
    return (S0.contiguous(), dlogcdf.contiguous(), F_u, dF,
            _trapz_weights(num_points, dx))


def _pbest_hyp_row(a_t, b_t, eq_t, update_weight: float, num_points: int):
    """Hypothetical P(best) for one class row: ``a_t``, ``b_t`` (H,) Beta
    parameters, ``eq_t`` (N, H) bool (did model h predict this class at
    item n) -> (N, H). Seed-batched: ``(S, H)`` parameters and ``(S, N,
    H)`` masks -> ``(S, N, H)``, each replica its own class row."""
    *tables, w_trapz = refresh_tables(a_t, b_t, update_weight, num_points)
    return _pbest_hyp_from_tables(tables, eq_t, w_trapz)
