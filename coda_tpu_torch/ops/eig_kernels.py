"""Incremental-EIG scoring: the CUDA kernels and their plain versions
(counterpart of ``coda_tpu/ops/pallas_eig.py``).

Kernel 1, :func:`eig_scores_cache`, replaces the Pallas
``_score_block_kernel``: ``(C, N, H)`` hypothetical-P(best) cache ->
``(N,)`` expected-entropy drops, one read of the cache.
Kernel 2, :func:`eig_scores_refresh`, replaces ``_refresh_score_kernel``:
it writes the refreshed class row ``c`` into the cache IN PLACE while it
scores with it — the cache tensor passed in is modified (JAX returned a
new, donated buffer instead).

Both kernels live in ``csrc/eig_score.cu`` (its header states the byte
bound and the design). A wrapper launches its kernel for a CUDA tensor
and raises on anything the kernel does not take; only a CPU tensor takes
the plain version beside it. The cache layout ``(C, N, H)`` is the
reference's, so the tests compare like with like. ``mixture0`` and
``h_before`` are computed here, outside the kernel, as the reference's
``_mixture_stats`` does.
"""

from __future__ import annotations

import ctypes

import torch

from coda_tpu_torch.ops.build import load
from coda_tpu_torch.ops.masked import entropy2

_ENTROPY_FLOOR = 1e-12
_LOG2E = 1.4426950408889634

# launches of each kernel, counted where the wrapper launches it
launch_counts = {"eig_score": 0, "eig_refresh_score": 0}

_MAX_SMEM = 48 << 10  # default dynamic shared memory a block may use


def mixture_stats(pbest_rows: torch.Tensor, pi_hat: torch.Tensor):
    """``(mixture0 (H,), h_before 0-d)``: the class mixture of the current
    P(best) rows and its entropy — the cheap pre-kernel scalars."""
    mixture0 = (pi_hat[:, None] * pbest_rows).sum(0)
    return mixture0, entropy2(mixture0)


# -- plain versions --------------------------------------------------------

def eig_scores_from_cache(pbest_rows: torch.Tensor, pbest_hyp: torch.Tensor,
                          pi_hat: torch.Tensor, pi_hat_xi: torch.Tensor,
                          chunk: int = 256) -> torch.Tensor:
    """Plain version of kernel 1: ``(N,)`` EIG scores from the cache, in
    ``(C, chunk, H)`` blocks over N (a memory valve; values do not depend
    on ``chunk``). Same mixture delta, 1e-12 floor, ``log·log2(e)`` and
    reduction structure (entropy over H, then classes over axis 0) as the
    reference kernel."""
    mixture0, h_before = mixture_stats(pbest_rows, pi_hat)
    C, N, H = pbest_hyp.shape
    B = max(1, min(chunk, N))
    out = torch.empty(N, dtype=torch.float32, device=pbest_hyp.device)
    for start in range(0, N, B):
        hyp_b = pbest_hyp[:, start:start + B].to(torch.float32)
        mix = mixture0 + pi_hat[:, None, None] * (hyp_b - pbest_rows[:, None])
        p = torch.clamp_min(mix, _ENTROPY_FLOOR)
        h_after = -(p * (torch.log(p) * _LOG2E)).sum(-1)       # (C, b)
        out[start:start + B] = h_before - (
            pi_hat_xi[start:start + B].T * h_after).sum(0)
    return out


def eig_scores_refresh_plain(pbest_rows, pbest_hyp, hyp_t, true_class,
                             pi_hat, pi_hat_xi, chunk: int = 256):
    """Plain version of kernel 2: write ``hyp_t`` into class row
    ``true_class`` of ``pbest_hyp`` (in place), then score. Returns
    ``(scores (N,), pbest_hyp)``. ``true_class`` may be a 0-d device
    tensor (no host synchronisation)."""
    c = torch.as_tensor(true_class, device=pbest_hyp.device).reshape(1)
    pbest_hyp.index_copy_(0, c.to(torch.int64),
                          hyp_t.to(pbest_hyp.dtype)[None])
    return eig_scores_from_cache(pbest_rows, pbest_hyp, pi_hat, pi_hat_xi,
                                 chunk), pbest_hyp


# -- kernels ---------------------------------------------------------------

_P = ctypes.c_void_p
_I = ctypes.c_int


def _lib():
    lib = load("eig_score")
    if not getattr(lib, "_typed", False):
        lib.eig_score_launch.argtypes = [_P] * 7 + [_I] * 4 + [_P]
        lib.eig_score_launch.restype = _I
        lib.eig_refresh_score_launch.argtypes = [_P] * 9 + [_I] * 4 + [_P]
        lib.eig_refresh_score_launch.restype = _I
        lib._typed = True
    return lib


def _require(cond: bool, msg: str) -> None:
    if not cond:
        raise ValueError(msg)


def _check_operands(pbest_rows, pbest_hyp, pi_hat, pi_hat_xi):
    """Device, dtype, shape and contiguity the kernels accept."""
    _require(pbest_hyp.device.type == "cuda",
             f"EIG kernels take CUDA tensors; got {pbest_hyp.device}")
    _require(pbest_hyp.dim() == 3, "pbest_hyp must be (C, N, H)")
    C, N, H = pbest_hyp.shape
    for name, t, shape in (("pbest_rows", pbest_rows, (C, H)),
                           ("pbest_hyp", pbest_hyp, (C, N, H)),
                           ("pi_hat", pi_hat, (C,)),
                           ("pi_hat_xi", pi_hat_xi, (N, C))):
        _require(t.device == pbest_hyp.device,
                 f"{name} is on {t.device}, the cache on {pbest_hyp.device}")
        _require(t.dtype == torch.float32,
                 f"{name} must be float32 (got {t.dtype}); the bfloat16 "
                 "cache is a later slice")
        _require(tuple(t.shape) == shape,
                 f"{name} has shape {tuple(t.shape)}, expected {shape}")
        _require(t.is_contiguous(), f"{name} must be contiguous")
    _require(4 * C * 8 <= _MAX_SMEM, f"C={C} exceeds the kernel's "
             "shared-memory budget")
    return C, N, H


def _vec(H: int, *tensors) -> int:
    """float4 loads when every row starts 16-byte aligned."""
    ok = H % 4 == 0 and all(t.data_ptr() % 16 == 0 for t in tensors)
    return 4 if ok else 1


def _stream() -> int:
    return torch.cuda.current_stream().cuda_stream


def _raise_on(rc: int, what: str) -> None:
    if rc != 0:
        raise RuntimeError(f"{what} launch failed: cudaError {rc}")


def eig_scores_cache(pbest_rows: torch.Tensor, pbest_hyp: torch.Tensor,
                     pi_hat: torch.Tensor, pi_hat_xi: torch.Tensor,
                     chunk: int = 256) -> torch.Tensor:
    """Kernel 1 (``csrc/eig_score.cu``): ``(N,)`` EIG scores from the
    ``(C, N, H)`` cache. CPU tensors take :func:`eig_scores_from_cache`
    (``chunk`` is its memory valve); CUDA tensors launch the kernel."""
    if pbest_hyp.device.type == "cpu":
        return eig_scores_from_cache(pbest_rows, pbest_hyp, pi_hat,
                                     pi_hat_xi, chunk)
    C, N, H = _check_operands(pbest_rows, pbest_hyp, pi_hat, pi_hat_xi)
    mixture0, h_before = mixture_stats(pbest_rows, pi_hat)
    out = torch.empty(N, dtype=torch.float32, device=pbest_hyp.device)
    rc = _lib().eig_score_launch(
        pbest_rows.data_ptr(), pbest_hyp.data_ptr(), pi_hat.data_ptr(),
        pi_hat_xi.data_ptr(), mixture0.data_ptr(), h_before.data_ptr(),
        out.data_ptr(), C, N, H,
        _vec(H, pbest_rows, pbest_hyp, mixture0), _stream())
    _raise_on(rc, "eig_score")
    launch_counts["eig_score"] += 1
    return out


def eig_scores_refresh(pbest_rows: torch.Tensor, pbest_hyp: torch.Tensor,
                       hyp_t: torch.Tensor, true_class: torch.Tensor,
                       pi_hat: torch.Tensor, pi_hat_xi: torch.Tensor,
                       chunk: int = 256):
    """Kernel 2 (``csrc/eig_score.cu``): write ``hyp_t`` (N, H) into class
    row ``true_class`` of ``pbest_hyp`` IN PLACE and score every item with
    it, in one pass over the cache. ``pbest_rows`` must already hold the
    refreshed row; ``pbest_hyp`` holds the old one. ``true_class`` is a
    0-d or 1-element integer tensor on the cache's device, read by the
    kernel (no host synchronisation); out of range gives NaN scores.
    Returns ``(scores (N,), pbest_hyp)``."""
    if pbest_hyp.device.type == "cpu":
        return eig_scores_refresh_plain(pbest_rows, pbest_hyp, hyp_t,
                                        true_class, pi_hat, pi_hat_xi, chunk)
    C, N, H = _check_operands(pbest_rows, pbest_hyp, pi_hat, pi_hat_xi)
    _require(tuple(hyp_t.shape) == (N, H) and hyp_t.dtype == torch.float32
             and hyp_t.device == pbest_hyp.device and hyp_t.is_contiguous(),
             f"hyp_t must be a contiguous float32 ({N}, {H}) tensor on "
             f"{pbest_hyp.device}")
    _require(isinstance(true_class, torch.Tensor)
             and true_class.device == pbest_hyp.device
             and true_class.numel() == 1
             and not torch.is_floating_point(true_class),
             "true_class must be a 1-element integer tensor on the cache's "
             "device")
    c = true_class.reshape(1).to(torch.int32)
    mixture0, h_before = mixture_stats(pbest_rows, pi_hat)
    out = torch.empty(N, dtype=torch.float32, device=pbest_hyp.device)
    rc = _lib().eig_refresh_score_launch(
        pbest_rows.data_ptr(), pbest_hyp.data_ptr(), hyp_t.data_ptr(),
        c.data_ptr(), pi_hat.data_ptr(), pi_hat_xi.data_ptr(),
        mixture0.data_ptr(), h_before.data_ptr(), out.data_ptr(), C, N, H,
        _vec(H, pbest_rows, pbest_hyp, hyp_t, mixture0), _stream())
    _raise_on(rc, "eig_refresh_score")
    launch_counts["eig_refresh_score"] += 1
    return out, pbest_hyp
