"""Incremental-EIG scoring: the CUDA kernels and their plain versions
(counterpart of ``coda_tpu/ops/pallas_eig.py``).

Kernel 1, :func:`eig_scores_cache`, replaces the Pallas
``_score_block_kernel``: ``(C, N, H)`` hypothetical-P(best) cache ->
``(N,)`` expected-entropy drops, one read of the cache.
Kernel 2, :func:`eig_scores_refresh`, replaces ``_refresh_score_kernel``:
it writes the refreshed class row ``c`` into the cache IN PLACE while it
scores with it — the cache tensor passed in is modified (JAX returned a
new, donated buffer instead).
Kernel 6, :func:`eig_scores_refresh_compute`, replaces
``_refresh_compute_score_kernel`` (``eig_refresh='fused'``): it computes
that row on the card from the labelled class's O(H·G) Beta grid tables
(no three-product refresh before it) and scores with it; it too writes
row ``c`` in place. It runs as two launches: a row kernel that writes the
unnormalised row to an fp32 ``(N, H)`` scratch, and a scoring pass that
normalises, stores and scores it.
Kernels 4 and 5, :func:`eig_scores_cache_batched` and
:func:`eig_scores_refresh_batched`, replace ``_batched_score_kernel`` and
``_batched_refresh_kernel``: kernels 1 and 2 for S replicas in one launch
(the seed-batched engine), every operand with a leading replica axis and
each replica refreshing its own class row; per replica bitwise kernels 1
and 2. On the card they take any S up to the grid's 65,535 whose state
fits in device memory: the reference's ``batched_pallas_viable`` (a budget
for the TPU's lane padding) and ``choose_block`` (a VMEM budget) have no
counterpart, since the card pads nothing and a block's tile is fixed.

Kernels 1, 2, 4 and 5 live in ``csrc/eig_score.cu``, kernel 6 in
``csrc/eig_refresh_compute.cu`` (each header states the bound and the
design). Each takes two flavours, as the Pallas kernels do: the cache's
storage type (float32 or bfloat16, ``eig_cache_dtype``; all arithmetic
fp32, a refreshed row rounded to the storage type and scored as rounded)
and the entropy's log (exact, or the polynomial ``log2_approx`` under
``eig_entropy='approx'``). A wrapper launches its kernel for a CUDA tensor
and raises on anything the kernel does not take; only a CPU tensor takes
the plain version beside it. The cache layout ``(C, N, H)`` is the
reference's, so the tests compare like with like. ``mixture0`` and
``h_before`` are computed here, outside the kernel, in the kernel's
entropy flavour, as the reference's ``_mixture_stats`` does; kernel 6's
Beta tables too, as the reference's wrapper builds them.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from coda_tpu_torch.ops.build import load
from coda_tpu_torch.ops.masked import entropy2, log2_approx
from coda_tpu_torch.ops.pbest import _pbest_hyp_row, refresh_tables

_ENTROPY_FLOOR = 1e-12
_LOG2E = 1.4426950408889634

# launches of each kernel flavour (see :func:`flavour`), counted where the
# wrapper launches it; a kernel's total is the sum over its flavours
launch_counts = {"eig_score": 0, "eig_refresh_score": 0,
                 "eig_refresh_compute_score": 0, "eig_score_batched": 0,
                 "eig_refresh_score_batched": 0, "eig_plogp_sweep": 0}

CACHE_DTYPES = (torch.float32, torch.bfloat16)
_MAX_SMEM = 48 << 10  # default dynamic shared memory a block may use
# shared memory a block may opt in to on Hopper (H100 and H200 alike)
_MAX_SMEM_OPTIN = 232_448
_MAX_GRID_Y = 65535   # replicas of one batched launch (gridDim.y)


def flavour(kernel: str, dtype: torch.dtype, approx: bool) -> str:
    """The flavour's name: ``kernel`` for the fp32 cache with the exact
    entropy, else e.g. ``eig_score[bfloat16,approx]``."""
    tags = ([str(dtype).removeprefix("torch.")]
            if dtype != torch.float32 else []) + (["approx"] if approx else [])
    return f"{kernel}[{','.join(tags)}]" if tags else kernel


def _count(kernel: str, dtype: torch.dtype, approx: bool) -> None:
    name = flavour(kernel, dtype, approx)
    launch_counts[name] = launch_counts.get(name, 0) + 1


def mixture_stats(pbest_rows: torch.Tensor, pi_hat: torch.Tensor,
                  approx: bool = False):
    """``(mixture0 (H,), h_before 0-d)``: the class mixture of the current
    P(best) rows and its entropy — the cheap pre-kernel scalars. ``approx``
    must match the scoring pass's flavour: h_before and the per-class
    entropies enter one subtraction, and a mixed lowering would forfeit
    the error cancellation the scores rely on. With a replica axis,
    ``(S, C, H)`` rows and ``(S, C)`` pi-hat give ``(S, H)`` and ``(S,)``
    (the reference's ``jax.vmap(_mixture_stats)``), one replica at a time:
    a reduction over another axis of a larger tensor may add in another
    order, and replica s must give the one-replica bits."""
    if pbest_rows.dim() == 3:
        mixture0, h_before = zip(*(mixture_stats(r, p, approx)
                                   for r, p in zip(pbest_rows, pi_hat)))
        return torch.stack(mixture0), torch.stack(h_before)
    mixture0 = (pi_hat[:, None] * pbest_rows).sum(0)
    return mixture0, entropy2(mixture0, approx=approx)


# -- plain versions --------------------------------------------------------

def eig_scores_from_cache(pbest_rows: torch.Tensor, pbest_hyp: torch.Tensor,
                          pi_hat: torch.Tensor, pi_hat_xi: torch.Tensor,
                          chunk: int = 256,
                          approx: bool = False) -> torch.Tensor:
    """Plain version of kernel 1: ``(N,)`` EIG scores from the cache, in
    ``(C, chunk, H)`` blocks over N (a memory valve; values do not depend
    on ``chunk``). Same mixture delta, 1e-12 floor, ``log·log2(e)`` (or
    ``log2_approx``) and reduction structure (entropy over H, then classes
    over axis 0) as the reference kernel; a bf16 cache is widened to fp32
    block by block."""
    mixture0, h_before = mixture_stats(pbest_rows, pi_hat, approx)
    C, N, H = pbest_hyp.shape
    B = max(1, min(chunk, N))
    out = torch.empty(N, dtype=torch.float32, device=pbest_hyp.device)
    for start in range(0, N, B):
        out[start:start + B] = _score_block(
            pbest_hyp[:, start:start + B], pi_hat_xi[start:start + B],
            pbest_rows, pi_hat, mixture0, h_before, approx)
    return out


def _score_block(hyp_b, pi_xi_b, pbest_rows, pi_hat, mixture0, h_before,
                 approx: bool) -> torch.Tensor:
    """The scores of the items of one ``(C, b, H)`` slice of the cache
    (``pi_xi_b`` their ``(b, C)`` pi-hat rows): the plain scoring pass's
    body."""
    hyp_b = hyp_b.to(torch.float32)
    mix = mixture0 + pi_hat[:, None, None] * (hyp_b - pbest_rows[:, None])
    p = torch.clamp_min(mix, _ENTROPY_FLOOR)
    log2p = log2_approx(p) if approx else torch.log(p) * _LOG2E
    h_after = -(p * log2p).sum(-1)                              # (C, b)
    return h_before - (pi_xi_b.T * h_after).sum(0)


def eig_scores_rows(pbest_rows: torch.Tensor, pbest_hyp: torch.Tensor,
                    pi_hat: torch.Tensor, pi_hat_xi: torch.Tensor,
                    rows: torch.Tensor, approx: bool = False
                    ) -> torch.Tensor:
    """The plain scoring pass on the items ``rows`` (int64 ``(m,)``) only:
    ``(m,)`` scores, each the value :func:`eig_scores_from_cache` gives
    that item (the same block body on the gathered ``(C, m, H)`` slice).
    The surrogate scorer's exact re-score of its shortlist."""
    mixture0, h_before = mixture_stats(pbest_rows, pi_hat, approx)
    return _score_block(pbest_hyp.index_select(1, rows),
                        pi_hat_xi.index_select(0, rows), pbest_rows, pi_hat,
                        mixture0, h_before, approx)


def eig_scores_refresh_plain(pbest_rows, pbest_hyp, hyp_t, true_class,
                             pi_hat, pi_hat_xi, chunk: int = 256,
                             approx: bool = False):
    """Plain version of kernel 2: write ``hyp_t`` into class row
    ``true_class`` of ``pbest_hyp`` (in place, rounded to the cache's
    storage type), then score with the stored row. Returns ``(scores (N,),
    pbest_hyp)``. ``true_class`` may be a 0-d device tensor (no host
    synchronisation)."""
    c = torch.as_tensor(true_class, device=pbest_hyp.device).reshape(1)
    pbest_hyp.index_copy_(0, c.to(torch.int64),
                          hyp_t.to(pbest_hyp.dtype)[None])
    return eig_scores_from_cache(pbest_rows, pbest_hyp, pi_hat, pi_hat_xi,
                                 chunk, approx), pbest_hyp


def eig_scores_refresh_compute_plain(pbest_rows, pbest_hyp, a_t, b_t,
                                     hard_preds, true_class, pi_hat,
                                     pi_hat_xi, update_weight: float = 1.0,
                                     num_points: int = 256,
                                     approx: bool = False, chunk: int = 256):
    """Plain version of kernel 6: the refreshed row of class
    ``true_class`` from the Beta tables of ``(a_t, b_t)`` by three fp32
    matrix products (``eq = hard_preds == true_class``), written into
    ``pbest_hyp`` in place at its storage type, then every item scored
    with the stored row. Returns ``(scores (N,), pbest_hyp)``."""
    c = torch.as_tensor(true_class, device=pbest_hyp.device).reshape(())
    row = _pbest_hyp_row(a_t, b_t, hard_preds == c, update_weight,
                         num_points)
    return eig_scores_refresh_plain(pbest_rows, pbest_hyp, row, c, pi_hat,
                                    pi_hat_xi, chunk, approx)


def eig_scores_from_cache_batched(pbest_rows, pbest_hyp, pi_hat, pi_hat_xi,
                                  chunk: int = 256,
                                  approx: bool = False) -> torch.Tensor:
    """Plain version of kernel 4: :func:`eig_scores_from_cache` for each
    replica of ``(S, C, N, H)`` caches. Returns ``(S, N)``."""
    return torch.stack([
        eig_scores_from_cache(r, h, p, px, chunk, approx)
        for r, h, p, px in zip(pbest_rows, pbest_hyp, pi_hat, pi_hat_xi)])


def eig_scores_refresh_batched_plain(pbest_rows, pbest_hyp, hyp_t,
                                     true_class, pi_hat, pi_hat_xi,
                                     chunk: int = 256, approx: bool = False):
    """Plain version of kernel 5: :func:`eig_scores_refresh_plain` for each
    replica s, writing ``hyp_t[s]`` into class row ``true_class[s]`` of
    replica s IN PLACE. Returns ``(scores (S, N), pbest_hyp)``."""
    scores = [eig_scores_refresh_plain(r, h, ht, c, p, px, chunk, approx)[0]
              for r, h, ht, c, p, px in zip(pbest_rows, pbest_hyp, hyp_t,
                                            true_class, pi_hat, pi_hat_xi)]
    return torch.stack(scores), pbest_hyp


# -- kernels ---------------------------------------------------------------

_P = ctypes.c_void_p
_I = ctypes.c_int


def _lib():
    lib = load("eig_score")
    if not getattr(lib, "_typed", False):
        lib.eig_score_launch.argtypes = [_P] * 7 + [_I] * 6 + [_P]
        lib.eig_score_launch.restype = _I
        lib.eig_refresh_score_launch.argtypes = [_P] * 9 + [_I] * 6 + [_P]
        lib.eig_refresh_score_launch.restype = _I
        lib.eig_score_batched_launch.argtypes = [_P] * 7 + [_I] * 7 + [_P]
        lib.eig_score_batched_launch.restype = _I
        lib.eig_refresh_score_batched_launch.argtypes = \
            [_P] * 9 + [_I] * 7 + [_P]
        lib.eig_refresh_score_batched_launch.restype = _I
        lib.eig_plogp_sweep_launch.argtypes = [_P, _P, ctypes.c_longlong, _I,
                                               _P]
        lib.eig_plogp_sweep_launch.restype = _I
        lib._typed = True
    return lib


def _lib6(defines: tuple[str, ...] = ()):
    lib = load("eig_refresh_compute", defines)
    if not getattr(lib, "_typed", False):
        lib.eig_refresh_compute_layout.argtypes = [_I] * 3 + [_P]
        lib.eig_refresh_compute_layout.restype = _I
        lib.eig_refresh_compute_launch.argtypes = [_P] * 16 + [_I] * 7 + [_P]
        lib.eig_refresh_compute_launch.restype = _I
        lib._typed = True
    return lib


_LAYOUT_KEYS = ("items_per_block", "models_per_chunk", "points_per_stage",
                "smem_bytes", "blocks_per_sm", "max_models")


@functools.lru_cache(maxsize=None)
def _layout(C: int, H: int, num_points: int, device: int) -> tuple:
    out = (ctypes.c_longlong * len(_LAYOUT_KEYS))()
    _raise_on(_lib6().eig_refresh_compute_layout(C, H, num_points, out),
              "eig_refresh_compute_layout")
    return tuple(out)


def refresh_compute_layout(C: int, H: int, num_points: int = 256) -> dict:
    """Kernel 6's tiling at ``(C, H, num_points)`` on the current card:
    items per block, models per chunk of the products, grid points per
    stage of the products, dynamic shared memory per block of the row
    kernel (bytes), its resident blocks per SM (0 if it does not fit), and
    the largest H that fits at this ``num_points``."""
    return dict(zip(_LAYOUT_KEYS, _layout(C, H, num_points,
                                          torch.cuda.current_device())))


def _require(cond: bool, msg: str) -> None:
    if not cond:
        raise ValueError(msg)


def _check_operands(pbest_rows, pbest_hyp, pi_hat, pi_hat_xi,
                    batched: bool = False):
    """Device, dtype, shape and contiguity the kernels accept; ``batched``
    (kernels 4 and 5): every operand carries a leading replica axis S."""
    _require(pbest_hyp.device.type == "cuda",
             f"EIG kernels take CUDA tensors; got {pbest_hyp.device}")
    _require(pbest_hyp.dim() == 3 + batched, "pbest_hyp must be "
             + ("(S, C, N, H)" if batched else "(C, N, H)"))
    _require(pbest_hyp.dtype in CACHE_DTYPES,
             f"pbest_hyp must be float32 or bfloat16 (got {pbest_hyp.dtype})")
    *lead, C, N, H = pbest_hyp.shape
    _require(all(1 <= s <= _MAX_GRID_Y for s in lead),
             f"a batch takes 1 to {_MAX_GRID_Y} replicas (got {lead})")
    for name, t, shape in (("pbest_rows", pbest_rows, (*lead, C, H)),
                           ("pbest_hyp", pbest_hyp, (*lead, C, N, H)),
                           ("pi_hat", pi_hat, (*lead, C)),
                           ("pi_hat_xi", pi_hat_xi, (*lead, N, C))):
        _require(t.device == pbest_hyp.device,
                 f"{name} is on {t.device}, the cache on {pbest_hyp.device}")
        _require(t is pbest_hyp or t.dtype == torch.float32,
                 f"{name} must be float32 (got {t.dtype})")
        _require(tuple(t.shape) == shape,
                 f"{name} has shape {tuple(t.shape)}, expected {shape}")
        _require(t.is_contiguous(), f"{name} must be contiguous")
    # the approx pass's per-block class entropies: 8 items x C floats
    _require(4 * C * 8 <= _MAX_SMEM, f"C={C} exceeds the kernel's "
             "shared-memory budget")
    return C, N, H


def _check_class(true_class, dev, S: int = 0) -> torch.Tensor:
    """The class index as contiguous int32: one element, or ``(S,)`` for a
    batch of ``S`` replicas."""
    _require(isinstance(true_class, torch.Tensor)
             and true_class.device == dev
             and (true_class.numel() == 1 if not S
                  else tuple(true_class.shape) == (S,))
             and not torch.is_floating_point(true_class),
             ("true_class must be a 1-element integer tensor" if not S
              else f"true_class must be an integer ({S},) tensor")
             + " on the cache's device")
    return true_class.reshape(-1).to(torch.int32).contiguous()


def _vec(H: int, cache: torch.Tensor, *tensors) -> int:
    """16-byte loads (4 fp32 or 8 bf16 values) when H is a multiple of
    that width and every row starts 16-byte aligned."""
    width = 16 // cache.element_size()
    ok = H % width == 0 and all(t.data_ptr() % 16 == 0
                                for t in (cache, *tensors))
    return width if ok else 1


def _stream() -> int:
    return torch.cuda.current_stream().cuda_stream


def _raise_on(rc: int, what: str) -> None:
    if rc != 0:
        raise RuntimeError(f"{what} launch failed: cudaError {rc}")


def eig_scores_cache(pbest_rows: torch.Tensor, pbest_hyp: torch.Tensor,
                     pi_hat: torch.Tensor, pi_hat_xi: torch.Tensor,
                     chunk: int = 256, approx: bool = False) -> torch.Tensor:
    """Kernel 1 (``csrc/eig_score.cu``): ``(N,)`` EIG scores from the
    ``(C, N, H)`` cache (float32 or bfloat16). CPU tensors take
    :func:`eig_scores_from_cache` (``chunk`` is its memory valve); CUDA
    tensors launch the kernel."""
    if pbest_hyp.device.type == "cpu":
        return eig_scores_from_cache(pbest_rows, pbest_hyp, pi_hat,
                                     pi_hat_xi, chunk, approx)
    C, N, H = _check_operands(pbest_rows, pbest_hyp, pi_hat, pi_hat_xi)
    mixture0, h_before = mixture_stats(pbest_rows, pi_hat, approx)
    out = torch.empty(N, dtype=torch.float32, device=pbest_hyp.device)
    rc = _lib().eig_score_launch(
        pbest_rows.data_ptr(), pbest_hyp.data_ptr(), pi_hat.data_ptr(),
        pi_hat_xi.data_ptr(), mixture0.data_ptr(), h_before.data_ptr(),
        out.data_ptr(), C, N, H, _vec(H, pbest_hyp, pbest_rows, mixture0),
        int(pbest_hyp.dtype == torch.bfloat16), int(approx), _stream())
    _raise_on(rc, "eig_score")
    _count("eig_score", pbest_hyp.dtype, approx)
    return out


def eig_scores_refresh(pbest_rows: torch.Tensor, pbest_hyp: torch.Tensor,
                       hyp_t: torch.Tensor, true_class: torch.Tensor,
                       pi_hat: torch.Tensor, pi_hat_xi: torch.Tensor,
                       chunk: int = 256, approx: bool = False):
    """Kernel 2 (``csrc/eig_score.cu``): write ``hyp_t`` (N, H) fp32 into
    class row ``true_class`` of ``pbest_hyp`` IN PLACE, rounded to the
    cache's storage type, and score every item with the stored row, in one
    pass over the cache. ``pbest_rows`` must already hold the refreshed
    row; ``pbest_hyp`` holds the old one. ``true_class`` is a 0-d or
    1-element integer tensor on the cache's device, read by the kernel (no
    host synchronisation); out of range gives NaN scores.
    Returns ``(scores (N,), pbest_hyp)``."""
    if pbest_hyp.device.type == "cpu":
        return eig_scores_refresh_plain(pbest_rows, pbest_hyp, hyp_t,
                                        true_class, pi_hat, pi_hat_xi, chunk,
                                        approx)
    C, N, H = _check_operands(pbest_rows, pbest_hyp, pi_hat, pi_hat_xi)
    _require(tuple(hyp_t.shape) == (N, H) and hyp_t.dtype == torch.float32
             and hyp_t.device == pbest_hyp.device and hyp_t.is_contiguous(),
             f"hyp_t must be a contiguous float32 ({N}, {H}) tensor on "
             f"{pbest_hyp.device}")
    c = _check_class(true_class, pbest_hyp.device)
    mixture0, h_before = mixture_stats(pbest_rows, pi_hat, approx)
    out = torch.empty(N, dtype=torch.float32, device=pbest_hyp.device)
    rc = _lib().eig_refresh_score_launch(
        pbest_rows.data_ptr(), pbest_hyp.data_ptr(), hyp_t.data_ptr(),
        c.data_ptr(), pi_hat.data_ptr(), pi_hat_xi.data_ptr(),
        mixture0.data_ptr(), h_before.data_ptr(), out.data_ptr(), C, N, H,
        _vec(H, pbest_hyp, pbest_rows, hyp_t, mixture0),
        int(pbest_hyp.dtype == torch.bfloat16), int(approx), _stream())
    _raise_on(rc, "eig_refresh_score")
    _count("eig_refresh_score", pbest_hyp.dtype, approx)
    return out, pbest_hyp


def eig_scores_cache_batched(pbest_rows: torch.Tensor,
                             pbest_hyp: torch.Tensor, pi_hat: torch.Tensor,
                             pi_hat_xi: torch.Tensor, chunk: int = 256,
                             approx: bool = False) -> torch.Tensor:
    """Kernel 4 (``csrc/eig_score.cu``): kernel 1 for S replicas in one
    launch. ``pbest_rows`` (S, C, H), ``pbest_hyp`` (S, C, N, H) float32 or
    bfloat16, ``pi_hat`` (S, C), ``pi_hat_xi`` (S, N, C) -> ``(S, N)``
    scores, row s bitwise kernel 1's on replica s. CPU tensors take
    :func:`eig_scores_from_cache_batched`."""
    if pbest_hyp.device.type == "cpu":
        return eig_scores_from_cache_batched(pbest_rows, pbest_hyp, pi_hat,
                                             pi_hat_xi, chunk, approx)
    C, N, H = _check_operands(pbest_rows, pbest_hyp, pi_hat, pi_hat_xi,
                              batched=True)
    S = pbest_hyp.shape[0]
    mixture0, h_before = mixture_stats(pbest_rows, pi_hat, approx)
    out = torch.empty((S, N), dtype=torch.float32, device=pbest_hyp.device)
    rc = _lib().eig_score_batched_launch(
        pbest_rows.data_ptr(), pbest_hyp.data_ptr(), pi_hat.data_ptr(),
        pi_hat_xi.data_ptr(), mixture0.data_ptr(), h_before.data_ptr(),
        out.data_ptr(), S, C, N, H, _vec(H, pbest_hyp, pbest_rows, mixture0),
        int(pbest_hyp.dtype == torch.bfloat16), int(approx), _stream())
    _raise_on(rc, "eig_score_batched")
    _count("eig_score_batched", pbest_hyp.dtype, approx)
    return out


def eig_scores_refresh_batched(pbest_rows: torch.Tensor,
                               pbest_hyp: torch.Tensor, hyp_t: torch.Tensor,
                               true_class: torch.Tensor, pi_hat: torch.Tensor,
                               pi_hat_xi: torch.Tensor, chunk: int = 256,
                               approx: bool = False):
    """Kernel 5 (``csrc/eig_score.cu``): kernel 2 for S replicas in one
    launch. Replica s writes ``hyp_t[s]`` (N, H) fp32 into its class row
    ``true_class[s]`` of ``pbest_hyp`` (S, C, N, H) IN PLACE, rounded to
    the storage type, and scores every item with the stored row; row s of
    the scores and replica s of the cache are bitwise kernel 2's on
    replica s. ``true_class`` is an integer (S,) tensor on the cache's
    device, read by the kernel; an out-of-range class gives NaN scores for
    its replica only. Returns ``(scores (S, N), pbest_hyp)``."""
    if pbest_hyp.device.type == "cpu":
        return eig_scores_refresh_batched_plain(
            pbest_rows, pbest_hyp, hyp_t, true_class, pi_hat, pi_hat_xi,
            chunk, approx)
    C, N, H = _check_operands(pbest_rows, pbest_hyp, pi_hat, pi_hat_xi,
                              batched=True)
    S = pbest_hyp.shape[0]
    _require(tuple(hyp_t.shape) == (S, N, H) and hyp_t.dtype == torch.float32
             and hyp_t.device == pbest_hyp.device and hyp_t.is_contiguous(),
             f"hyp_t must be a contiguous float32 ({S}, {N}, {H}) tensor on "
             f"{pbest_hyp.device}")
    c = _check_class(true_class, pbest_hyp.device, S)
    mixture0, h_before = mixture_stats(pbest_rows, pi_hat, approx)
    out = torch.empty((S, N), dtype=torch.float32, device=pbest_hyp.device)
    rc = _lib().eig_refresh_score_batched_launch(
        pbest_rows.data_ptr(), pbest_hyp.data_ptr(), hyp_t.data_ptr(),
        c.data_ptr(), pi_hat.data_ptr(), pi_hat_xi.data_ptr(),
        mixture0.data_ptr(), h_before.data_ptr(), out.data_ptr(), S, C, N, H,
        _vec(H, pbest_hyp, pbest_rows, hyp_t, mixture0),
        int(pbest_hyp.dtype == torch.bfloat16), int(approx), _stream())
    _raise_on(rc, "eig_refresh_score_batched")
    _count("eig_refresh_score_batched", pbest_hyp.dtype, approx)
    return out, pbest_hyp


# the terms plogp_terms evaluates: the exact flavour's, the full-precision
# logf(p) * log2(e) * p, and p * lg2.approx(p) for every p
PLOGP_FORMS = ("exact", "logf", "lg2")
# the exact flavour's contract: each term t = p*log2(p) within
# PLOGP_CONTRACT_ULPS * 2^-24 * max(|t|, p) of its double-precision value
PLOGP_CONTRACT_ULPS = 4


def plogp_error_units(p: torch.Tensor, t: torch.Tensor) -> torch.Tensor:
    """``|t - p*log2(p)|`` in units of the exact flavour's contract,
    ``PLOGP_CONTRACT_ULPS * 2^-24 * max(|p*log2(p)|, p)``, the reference
    taken in float64; the contract holds where this is at most 1."""
    p64 = p.double()
    ref = p64 * torch.log2(p64)
    unit = PLOGP_CONTRACT_ULPS * 2.0 ** -24 * torch.maximum(ref.abs(), p64)
    return (t.double() - ref).abs() / unit


def plogp_terms(p: torch.Tensor, form: str = "exact") -> torch.Tensor:
    """The log-term sweep's entry (``eig_plogp_sweep_launch`` in
    ``csrc/eig_score.cu``): ``p * log2(p)`` for each fp32 ``p`` as the
    scoring kernels compute it in the exact flavour (``form="exact"``), with
    a full-precision log (``"logf"``: ``logf(p) * log2(e) * p``), or with
    the hardware's ``lg2.approx`` for every p (``"lg2"``). ``p`` must lie in
    ``[1e-12, 1]`` for the exact form to equal the scoring loop's term
    (the loop floors p there). CPU tensors take the plain versions' term,
    ``p * (log(p) * log2(e))``, for every form."""
    _require(form in PLOGP_FORMS, f"form must be one of {PLOGP_FORMS}")
    if p.device.type == "cpu":
        return p * (torch.log(p) * _LOG2E)
    _require(p.device.type == "cuda" and p.dtype == torch.float32
             and p.is_contiguous(), "p must be a contiguous float32 CUDA "
             "tensor")
    out = torch.empty_like(p)
    _raise_on(_lib().eig_plogp_sweep_launch(
        p.data_ptr(), out.data_ptr(), p.numel(), PLOGP_FORMS.index(form),
        _stream()), "eig_plogp_sweep")
    launch_counts["eig_plogp_sweep"] += 1
    return out


def eig_scores_refresh_compute(pbest_rows: torch.Tensor,
                               pbest_hyp: torch.Tensor, a_t: torch.Tensor,
                               b_t: torch.Tensor, hard_preds: torch.Tensor,
                               true_class: torch.Tensor, pi_hat: torch.Tensor,
                               pi_hat_xi: torch.Tensor,
                               update_weight: float = 1.0,
                               num_points: int = 256, approx: bool = False,
                               chunk: int = 256):
    """Kernel 6 (``csrc/eig_refresh_compute.cu``): compute class row
    ``true_class`` of the cache from the Beta parameters ``a_t``, ``b_t``
    (H,) of the labelled class and ``hard_preds`` (N, H) int32, write it
    into ``pbest_hyp`` IN PLACE at the storage type, and score every item
    with the stored row. ``pbest_rows`` must already hold the refreshed
    P(best) row; ``pbest_hyp`` holds the old class row. The O(H·G) tables
    are built here with PyTorch, as the reference's wrapper builds them,
    and so is the fp32 ``(N, H)`` scratch the two launches share. H is
    bounded by the row kernel's shared memory (the eq bitmask of its item
    tile: 16,224 models at ``num_points=256``; see
    :func:`refresh_compute_layout`). CPU tensors take
    :func:`eig_scores_refresh_compute_plain` (``chunk`` is its scoring
    valve). Returns ``(scores (N,), pbest_hyp)``.
    """
    if pbest_hyp.device.type == "cpu":
        return eig_scores_refresh_compute_plain(
            pbest_rows, pbest_hyp, a_t, b_t, hard_preds, true_class, pi_hat,
            pi_hat_xi, update_weight, num_points, approx, chunk)
    C, N, H = _check_operands(pbest_rows, pbest_hyp, pi_hat, pi_hat_xi)
    dev = pbest_hyp.device
    _require(tuple(hard_preds.shape) == (N, H)
             and hard_preds.dtype == torch.int32 and hard_preds.device == dev
             and hard_preds.is_contiguous(),
             f"hard_preds must be a contiguous int32 ({N}, {H}) tensor on "
             f"{dev}")
    for name, t in (("a_t", a_t), ("b_t", b_t)):
        _require(tuple(t.shape) == (H,) and t.dtype == torch.float32
                 and t.device == dev, f"{name} must be a float32 ({H},) "
                 f"tensor on {dev}")
    _require(num_points >= 2, f"num_points={num_points} must be >= 2")
    c = _check_class(true_class, dev)
    lib = _lib6()
    layout = refresh_compute_layout(C, H, num_points)
    smem = layout["smem_bytes"]
    _require(smem <= _MAX_SMEM_OPTIN,
             f"kernel 6 needs {smem} bytes of shared memory per block at "
             f"C={C}, H={H}, num_points={num_points}; a Hopper block may opt "
             f"in to at most {_MAX_SMEM_OPTIN} (H up to "
             f"{layout['max_models']} at this num_points)")
    S0, dlogcdf, F_u, dF, w_trapz = refresh_tables(a_t, b_t, update_weight,
                                                   num_points)
    fu_t, df_t = F_u.T.contiguous(), dF.T.contiguous()     # (G, H) once
    mixture0, h_before = mixture_stats(pbest_rows, pi_hat, approx)
    # the unnormalised rows and their clamped sums between the two launches
    scratch = torch.empty((N, H), dtype=torch.float32, device=dev)
    den = torch.empty(N, dtype=torch.float32, device=dev)
    out = torch.empty(N, dtype=torch.float32, device=dev)
    rc = lib.eig_refresh_compute_launch(
        pbest_rows.data_ptr(), pbest_hyp.data_ptr(), hard_preds.data_ptr(),
        c.data_ptr(), S0.data_ptr(), dlogcdf.data_ptr(), fu_t.data_ptr(),
        df_t.data_ptr(), w_trapz.data_ptr(), pi_hat.data_ptr(),
        pi_hat_xi.data_ptr(), mixture0.data_ptr(), h_before.data_ptr(),
        scratch.data_ptr(), den.data_ptr(), out.data_ptr(), C, N, H,
        num_points, _vec(H, pbest_hyp, pbest_rows, mixture0, scratch),
        int(pbest_hyp.dtype == torch.bfloat16), int(approx), _stream())
    _raise_on(rc, "eig_refresh_compute_score")
    _count("eig_refresh_compute_score", pbest_hyp.dtype, approx)
    return out, pbest_hyp
