"""P(model h is best) via the Beta order-statistic integral (counterpart of
``coda_tpu/ops/pbest.py``).

    P(h best) = ∫ pdf_h(x) * Π_{h'≠h} cdf_{h'}(x) dx

on a fixed 256-point grid, normalised — with the reference's numeric
choreography: grid ends 1e-6, cdf floor 1e-30, ±80 clamp on the exclusive
log-product, trapezoid quadrature. All math fp32.
"""

from __future__ import annotations

import contextlib
import functools
import warnings

import numpy as np
import torch

from coda_tpu_torch.ops.beta import (
    beta_log_pdf,
    beta_logit_normal_params,
    cumtrapz_uniform,
    dirichlet_to_beta,
    logit_normal_log_cdf,
    logit_normal_log_pdf,
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


@contextlib.contextmanager
def _tf32_products():
    """TF32 tensor-core products for the body only: the setting is
    restored on the way out, so no other product of the program (the
    pi-hat contractions, the confusion prior) leaves fp32."""
    old = torch.backends.cuda.matmul.allow_tf32
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        torch.backends.cuda.matmul.allow_tf32 = True
    try:
        yield
    finally:
        with warnings.catch_warnings():
            warnings.simplefilter("ignore")
            torch.backends.cuda.matmul.allow_tf32 = old


def eig_matmul(a: torch.Tensor, b: torch.Tensor,
               precision: str = "highest") -> torch.Tensor:
    """``a @ b`` at an ``eig_precision`` (the EIG table products only).
    On the card: ``highest`` and ``high`` are fp32 on the CUDA cores (TF32
    off); ``default`` is one TF32 tensor-core pass. ``high`` stands for the
    TPU's 3-pass bf16: the fp32 product is at least as accurate and, on an
    H100, faster than three TF32 passes over hi/lo splits. On the CPU every
    precision is the fp32 product, as XLA's CPU backend ignores the
    precision too."""
    if precision != "default" or a.device.type != "cuda":
        return a @ b
    with _tf32_products():
        return a @ b


def _pbest_hyp_from_tables(tables, eq_t, w_trapz, precision: str = "highest",
                           out=None):
    """The hypothetical-row integral for ONE class row over all items:
    per-item exclusive log-cdf sum, max-shift, weighted integrand,
    normalisation — the body the quadrature and the amortized tables
    share. Three ``(N, H)·(H, G)``/``(N, G)·(G, H)`` products at
    ``precision`` (:func:`eig_matmul`): the precomputed refresh, the
    row-scanned tier and kernel 6's plain version (the kernel computes
    them inside its scoring pass). With leading axes (tables ``(..., H,
    G)``, ``eq_t`` ``(..., N, H)``) the products are batched, one row per
    leading index. ``out``: the tensor the normalised rows are written
    into (the same division), else a new one."""
    S0_t, dlogcdf_t, F_u_t, dF_t = tables
    eq = eq_t.to(w_trapz.dtype)
    S = S0_t.unsqueeze(-2) + eig_matmul(eq, dlogcdf_t, precision)  # (N, G)
    S = S - S.amax(-1, keepdim=True)
    wE = w_trapz * torch.exp(S)
    t_base = eig_matmul(wE, F_u_t.transpose(-1, -2), precision)    # (N, H)
    t_diff = eig_matmul(wE, dF_t.transpose(-1, -2), precision)
    unnorm = t_base + eq * t_diff
    return torch.div(unnorm, torch.clamp_min(unnorm.sum(-1, keepdim=True),
                                             _EPS), out=out)


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


def _pbest_hyp_row(a_t, b_t, eq_t, update_weight: float, num_points: int,
                   precision: str = "highest", out=None):
    """Hypothetical P(best) for one class row: ``a_t``, ``b_t`` (H,) Beta
    parameters, ``eq_t`` (N, H) bool (did model h predict this class at
    item n) -> (N, H), written into ``out`` when given. Seed-batched:
    ``(S, H)`` parameters and ``(S, N, H)`` masks -> ``(S, N, H)``, each
    replica its own class row."""
    *tables, w_trapz = refresh_tables(a_t, b_t, update_weight, num_points)
    return _pbest_hyp_from_tables(tables, eq_t, w_trapz, precision, out)


def _amortized_bump_tables(a, b, x, update_weight):
    """:func:`_bump_tables` on the logistic-normal closed forms
    (``ops.beta.logit_normal_log_pdf``/``log_cdf``) instead of lgamma grids
    and the cumulative trapezoid: the same eps floor and exponent clamp,
    the same ``(S0, dlogcdf, F_u, dF)`` contract."""
    log_eps = torch.log(torch.tensor(_EPS, dtype=torch.float32,
                                     device=x.device))

    def tab(aa, bb):
        mu, sigma = beta_logit_normal_params(aa, bb)
        mu, sigma = mu[..., None], sigma[..., None]
        logcdf = torch.maximum(logit_normal_log_cdf(x, mu, sigma), log_eps)
        logpdf = logit_normal_log_pdf(x, mu, sigma)
        return logcdf, torch.exp(torch.clamp_max(logpdf - logcdf, 85.0))

    logcdf_u, F_u = tab(a, b + update_weight)
    logcdf_b, F_b = tab(a + update_weight, b)
    return logcdf_u.sum(-2), logcdf_b - logcdf_u, F_u, F_b - F_u


def _pbest_hyp_row_amortized(a_t, b_t, eq_t, update_weight: float,
                             num_points: int, precision: str = "highest"):
    """:func:`_pbest_hyp_row` on the amortized tables: the same integral
    body (:func:`_pbest_hyp_from_tables`), other tables."""
    x = pbest_grid(num_points, a_t.device)
    w_trapz = _trapz_weights(num_points, x[1] - x[0])
    tables = _amortized_bump_tables(a_t, b_t, x, update_weight)
    return _pbest_hyp_from_tables(tables, eq_t, w_trapz, precision)


def _pbest_hyp_row_gated(a_t, b_t, eq_t, update_weight: float,
                         num_points: int, min_conc: float,
                         precision: str = "highest"):
    """The ``eig_pbest='amortized'`` row refresh: the amortized tables
    where the row's ``min_h(a + b) >= min_conc``, the quadrature's
    elsewhere — the reference's ``lax.cond`` taken on the device. Both
    table sets are O(H·G); the choice is made per element before the
    shared integral body runs once, so each replica's result is bitwise
    the branch its gate names and nothing waits on the host."""
    x = pbest_grid(num_points, a_t.device)
    dx = x[1] - x[0]
    quad = _bump_tables(a_t, b_t, x, dx, update_weight)
    amort = _amortized_bump_tables(a_t, b_t, x, update_weight)
    gate = (a_t + b_t).amin(-1) >= min_conc                     # (...)
    tables = tuple(
        torch.where(gate.reshape(gate.shape + (1,) * (q.dim() - gate.dim())),
                    am, q)
        for q, am in zip(quad, amort))
    return _pbest_hyp_from_tables(tables, eq_t,
                                  _trapz_weights(num_points, dx), precision)


def compute_pbest_rows(aT: torch.Tensor, bT: torch.Tensor,
                       num_points: int = NUM_POINTS,
                       row_chunk: int = 1) -> torch.Tensor:
    """:func:`compute_pbest` over ``row_chunk`` class rows at a time:
    ``(..., C, H)`` from ``(..., C, H)`` Beta parameters with
    O(row_chunk·H·G) temporaries instead of the one-shot (C, H, G)."""
    C = aT.shape[-2]
    r = max(1, min(row_chunk, C))
    return torch.cat([compute_pbest(aT[..., i:i + r, :], bT[..., i:i + r, :],
                                    num_points=num_points)
                      for i in range(0, C, r)], dim=-2)
