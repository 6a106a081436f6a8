"""Incremental-EIG scoring: the CUDA kernels and their plain versions
(counterpart of ``coda_tpu/ops/pallas_eig.py``).

Kernel 1, :func:`eig_scores_cache`, replaces the Pallas
``_score_block_kernel``: ``(C, N, H)`` hypothetical-P(best) cache ->
``(N,)`` expected-entropy drops, one read of the cache.
Kernel 2, :func:`eig_scores_refresh`, replaces ``_refresh_score_kernel``:
it writes the refreshed class row ``c`` into the cache IN PLACE while it
scores with it — the cache tensor passed in is modified (JAX returned a
new, donated buffer instead).
Where the item axis is too short to fill the card, kernels 1, 2, 4 and 5
split their class loop over another grid axis and sum each item's classes
in a second launch (:func:`choose_class_chunks`), bitwise the single
launch; so does kernel 6's scoring launch, and its row launch splits its
model chunks over another grid axis (:func:`choose_row_split`).
Kernel 6, :func:`eig_scores_refresh_compute`, replaces
``_refresh_compute_score_kernel`` (``eig_refresh='fused'``): it computes
that row on the card from the labelled class's O(H·G) Beta grid tables
(no three-product refresh before it) and scores with it; it too writes
row ``c`` in place. It splits the tables into TF32 planes (one small
launch), computes each item's quadrature weights w (a second launch), runs
a row kernel (TMA and ``wgmma``) that writes the unnormalised row to an
fp32 ``(N, H)`` scratch, and a scoring pass that normalises, stores and
scores it.
Kernels 4 and 5, :func:`eig_scores_cache_batched` and
:func:`eig_scores_refresh_batched`, replace ``_batched_score_kernel`` and
``_batched_refresh_kernel``: kernels 1 and 2 for S replicas in one launch
(the seed-batched engine), every operand with a leading replica axis and
each replica refreshing its own class row; per replica bitwise kernels 1
and 2, on either decomposition. On the card they take any S up to the grid's 65,535 whose state
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
from typing import Optional

import torch

from coda_tpu_torch.ops.build import load
from coda_tpu_torch.ops.masked import entropy2, log2_approx
from coda_tpu_torch.ops.pbest import _pbest_hyp_row, refresh_tables
from coda_tpu_torch.parallel.collectives import gather_sum
from coda_tpu_torch.parallel.mesh import MODEL_AXIS

_ENTROPY_FLOOR = 1e-12
_LOG2E = 1.4426950408889634

# launches of each kernel flavour (see :func:`flavour`), counted where the
# wrapper launches it; a kernel's total is the sum over its flavours
launch_counts = {"eig_score": 0, "eig_refresh_score": 0,
                 "eig_refresh_compute_score": 0, "eig_score_batched": 0,
                 "eig_refresh_score_batched": 0, "eig_plogp_sweep": 0}
# of those, the launches of kernels 1, 2, 4 and 5 that took the split
# decomposition (class_chunks > 1), and of kernel 6 that split either of
# its launches (class_chunks > 1 or the row split), by flavour
split_counts: dict = {}

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


def _count(kernel: str, dtype: torch.dtype, approx: bool,
           split: bool = False) -> None:
    name = flavour(kernel, dtype, approx)
    launch_counts[name] = launch_counts.get(name, 0) + 1
    if split:
        split_counts[name] = split_counts.get(name, 0) + 1


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
        lib.eig_score_split_launch.argtypes = [_P] * 8 + [_I] * 7 + [_P]
        lib.eig_score_split_launch.restype = _I
        lib.eig_refresh_score_split_launch.argtypes = \
            [_P] * 10 + [_I] * 7 + [_P]
        lib.eig_refresh_score_split_launch.restype = _I
        lib.eig_score_batched_launch.argtypes = [_P] * 7 + [_I] * 7 + [_P]
        lib.eig_score_batched_launch.restype = _I
        lib.eig_refresh_score_batched_launch.argtypes = \
            [_P] * 9 + [_I] * 7 + [_P]
        lib.eig_refresh_score_batched_launch.restype = _I
        lib.eig_score_batched_split_launch.argtypes = \
            [_P] * 8 + [_I] * 8 + [_P]
        lib.eig_score_batched_split_launch.restype = _I
        lib.eig_refresh_score_batched_split_launch.argtypes = \
            [_P] * 10 + [_I] * 8 + [_P]
        lib.eig_refresh_score_batched_split_launch.restype = _I
        lib.eig_plogp_sweep_launch.argtypes = [_P, _P, ctypes.c_longlong, _I,
                                               _P]
        lib.eig_plogp_sweep_launch.restype = _I
        lib._typed = True
    return lib


def _lib6(defines: tuple[str, ...] = ()):
    lib = load("eig_refresh_compute", defines)
    if not getattr(lib, "_typed", False):
        lib.eig_refresh_compute_layout.argtypes = [_I] * 4 + [_P]
        lib.eig_refresh_compute_layout.restype = _I
        lib.eig_refresh_compute_launch.argtypes = \
            [_P] * 21 + [_I] * 11 + [_P]
        lib.eig_refresh_compute_launch.restype = _I
        lib.eig_split_tables_launch.argtypes = [_P] * 3 + [_I] * 2 + [_P]
        lib.eig_split_tables_launch.restype = _I
        lib._typed = True
    return lib


_LAYOUT_KEYS = ("items_per_block", "models_per_chunk", "points_per_stage",
                "smem_bytes", "blocks_per_sm", "max_models", "ring_stages",
                "warpgroups")


@functools.lru_cache(maxsize=None)
def _layout(C: int, H: int, num_points: int, nwg: int, device: int) -> tuple:
    out = (ctypes.c_longlong * len(_LAYOUT_KEYS))()
    _raise_on(_lib6().eig_refresh_compute_layout(C, H, num_points, nwg, out),
              "eig_refresh_compute_layout")
    return tuple(out)


def refresh_compute_layout(C: int, H: int, num_points: int = 256,
                           warpgroups: int = 2) -> dict:
    """Kernel 6's tiling at ``(C, H, num_points)`` on the current card with
    ``warpgroups`` consumer warpgroups wanted: items per block, models per
    chunk of the products, grid points per stage of the products, dynamic
    shared memory per block of the row kernel (bytes), its resident blocks
    per SM (0 if it does not fit), the largest H that fits at this
    ``num_points``, the ring stages taken (the source's four, cut to what
    fits) and the consumer warpgroups taken (one where two do not fit).
    The same numbers as :func:`row_layout` but for the blocks an SM, which
    only the card can say."""
    return dict(zip(_LAYOUT_KEYS, _layout(C, H, num_points, warpgroups,
                                          torch.cuda.current_device())))


# Kernel 6's row launch (csrc/eig_refresh_compute.cu): a block is one or
# two consumer warpgroups (choose_row_warpgroups; one where two do not fit)
# and a producer warp; each warpgroup owns ROW_ITEMS items at a time, and
# the block walks the models in chunks of ROW_MODELS, ROW_POINTS grid
# points a ring stage of ROW_STAGE_BYTES (the TF32 hi and lo planes of both
# tables), which its warpgroups share. Shared memory: 1 KB of alignment,
# the ring (the source's ROW_STAGES stages, fewer where H leaves no room,
# ROW_MIN_STAGES at least), w (items x (Gp + 4) fp32), the eq bitmask
# (items x mask_words(H) words) and two mbarriers a stage.
ROW_ITEMS = 64
ROW_MODELS = 128
ROW_POINTS = 8
ROW_STAGE_BYTES = 16 << 10
ROW_MIN_STAGES, ROW_STAGES = 2, 4


def row_smem_bytes(H: int, num_points: int, stages: int,
                   warpgroups: int = 1) -> int:
    """Dynamic shared memory of a row block (the source's
    ``smem_bytes``)."""
    gp = -(-num_points // ROW_POINTS) * ROW_POINTS
    return (1024 + stages * ROW_STAGE_BYTES
            + 4 * warpgroups * ROW_ITEMS * ((gp + 4) + mask_words(H))
            + 16 * stages)


def mask_words(H: int) -> int:
    """The eq mask's row stride in 32-bit words: ceil(H / 32) rounded up
    to 16 bytes (the source's ``mask_stride``)."""
    return -(-(-(-H // 32)) // 4) * 4


def row_layout(H: int, num_points: int = 256,
               optin: Optional[int] = None) -> dict:
    """The two-warpgroup row block's shape on a card whose blocks may opt
    in to ``optin`` bytes of shared memory (default: Hopper's): the
    consumer warpgroups taken (one where two do not fit with the fewest
    stages), the ring stages taken (as many as fit, up to
    :data:`ROW_STAGES`), the bytes at those, and the largest H whose block
    fits (one warpgroup, the fewest stages). The source's ``row_shape``."""
    optin = _MAX_SMEM_OPTIN if optin is None else optin
    nwg = 2 if row_smem_bytes(H, num_points, ROW_MIN_STAGES, 2) <= optin \
        else 1
    stages = ROW_STAGES
    while (stages > ROW_MIN_STAGES
           and row_smem_bytes(H, num_points, stages, nwg) > optin):
        stages -= 1
    fixed = row_smem_bytes(0, num_points, ROW_MIN_STAGES)
    return {"warpgroups": nwg, "ring_stages": stages,
            "smem_bytes": row_smem_bytes(H, num_points, stages, nwg),
            "max_models": max(0, (optin - fixed) // (4 * ROW_ITEMS) // 4
                              * 128)}


def check_row_layout(C: int, H: int, num_points: int = 256) -> dict:
    """:func:`row_layout` at ``(H, num_points)``, or a ValueError naming
    the shared-memory limit and the largest H where the row block does not
    fit a Hopper block."""
    lay = row_layout(H, num_points)
    smem = lay["smem_bytes"]
    _require(smem <= _MAX_SMEM_OPTIN,
             f"kernel 6 needs {smem} bytes of shared memory per block at "
             f"C={C}, H={H}, num_points={num_points}; a Hopper block may opt "
             f"in to at most {_MAX_SMEM_OPTIN} (H up to "
             f"{lay['max_models']} at this num_points)")
    return lay


_TF32_MASK = -8192   # 0xffffe000 as an int32: sign, exponent, 10 bits


def split_tf32(x: torch.Tensor):
    """``(hi, lo)`` of fp32 ``x`` as kernel 6 cuts its product operands:
    ``hi`` keeps the sign, the exponent and TF32's 10 mantissa bits,
    ``lo`` is ``x - hi`` (exact in fp32) cut likewise, so ``hi + lo``
    carries x to about 2^-21 relative."""
    x = x.to(torch.float32).contiguous()
    hi = (x.view(torch.int32) & _TF32_MASK).view(torch.float32)
    lo = ((x - hi).view(torch.int32) & _TF32_MASK).view(torch.float32)
    return hi, lo


def split_tables(F_u: torch.Tensor, dF: torch.Tensor) -> torch.Tensor:
    """Kernel 6's product operands: ``(4, H, Gp)`` fp32 planes hi(F_u),
    hi(dF), lo(F_u), lo(dF) of the ``(H, G)`` tables (:func:`split_tf32`),
    ``Gp`` = G rounded up to the kernel's 8-point k step, zero past G. A
    CUDA tensor takes ``split_tables_kernel`` (one launch, the one kernel
    6's wrapper makes each call, here alone for the tests: it counts no
    launch of kernel 6); a CPU tensor its plain version here."""
    H, G = F_u.shape
    _require(tuple(dF.shape) == (H, G) and F_u.dtype == dF.dtype
             == torch.float32 and F_u.device == dF.device,
             "F_u and dF must be float32 tensors of one (H, G) shape")
    gp = -(-G // ROW_POINTS) * ROW_POINTS
    if F_u.device.type == "cpu":
        planes = torch.zeros((4, H, gp), dtype=torch.float32)
        planes[0, :, :G], planes[2, :, :G] = split_tf32(F_u)
        planes[1, :, :G], planes[3, :, :G] = split_tf32(dF)
        return planes
    F_u, dF = F_u.contiguous(), dF.contiguous()
    planes = torch.empty((4, H, gp), dtype=torch.float32, device=F_u.device)
    _raise_on(_lib6().eig_split_tables_launch(
        F_u.data_ptr(), dF.data_ptr(), planes.data_ptr(), H, G, _stream()),
        "eig_split_tables")
    return planes


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


# -- the class-chunk split of kernels 1, 2, 4 and 5 -------------------------
# Where the item grid cannot fill the card, kernels 1 and 2 split their
# class loop over a second grid axis, kernels 4 and 5 each replica's over a
# second axis beside the replica's (``csrc/eig_score.cu``); scores and the
# refreshed rows are bitwise the single launch's at every chunk count.

EXACT_ROWS = 4        # eig::kExactRows: rows an exact warp scores at once
# The single launch keeps the rows of about S * N items in flight (a warp
# walks its items' rows class by class; S replicas side by side in kernels
# 4 and 5), so a short item axis leaves the card idle. The split is taken
# where S * N is under SPLIT_ITEMS_PER_SM items an SM and the classes' rows
# hold at least SPLIT_MIN_CLASS_VALUES values (a warp's walk over them
# outlasts the second launch); each warp then scores four rows, one class
# (exact) or four (approx) a chunk. From scripts/torch_split_sweep.py on
# the H100: no chunk count beat the single launch at N = 8192; every swept
# shape at N <= 4096 with C * H >= 8064 gained (16 times at the pool,
# C = 1000, N = 256); at C * H = 800 the approx flavour lost; four rows a
# warp came within a few per cent of the best chunk count at every swept
# shape, with no partial last wave.
SPLIT_ITEMS_PER_SM = 32
SPLIT_MIN_CLASS_VALUES = 4096
_MAX_CHUNKS = 65535   # gridDim.y


def choose_class_chunks(C: int, N: int, H: int, approx: bool,
                        sms: int, S: int = 1) -> int:
    """The class chunks kernels 1 and 2 (``S = 1``) or 4 and 5 (``S``
    replicas) take at a ``(C, N, H)`` cache a replica in the ``approx`` or
    exact flavour on a card of ``sms`` SMs (the storage type does not
    enter): 1, the single launch, where the rows it holds in flight,
    ``S * N``, reach ``SPLIT_ITEMS_PER_SM * sms`` or ``C * H`` is under
    ``SPLIT_MIN_CLASS_VALUES``; else one class a chunk (exact) or
    ``EXACT_ROWS`` (approx), as many as the grid's y axis holds, counted
    as the kernel cuts them (:func:`chunk_bounds`)."""
    if (S * N >= SPLIT_ITEMS_PER_SM * sms
            or C * H < SPLIT_MIN_CLASS_VALUES):
        return 1
    per = EXACT_ROWS if approx else 1
    return len(chunk_bounds(C, min(_MAX_CHUNKS, -(-C // per))))


def chunk_bounds(C: int, chunks: int) -> list:
    """The ``[c0, c1)`` class ranges of ``chunks`` chunks as the split
    kernel cuts them: ``ceil(C / chunks)`` classes each, the last the
    rest, empty chunks dropped."""
    per = -(-C // chunks)
    return [(c0, min(C, c0 + per)) for c0 in range(0, C, per)]


# Kernel 6's row launch is persistent: its blocks (one an SM at G = 256)
# walk the work items, item tiles of one or two warpgroups' items or, under
# the row split, (tile, model chunk) pairs, each of which loads its tile's
# w and eq mask before its products. The rules below are set from
# scripts/torch_split_sweep.py --k6 --warpgroups 1,2 on the H100 (C = 10,
# H = 1000, N from 1024 to 50,000; the pool; digits_h80), the device ms
# of the tables' split, S and the row launch: the split pays where its work
# items take fewer rounds of the grid than the single path's whole tiles,
# a split round costing about 1.2 single ones (each work item loads its
# tile: at N = 16,000 and 50,000, in equal rounds, it ran 1.12-1.15 times
# slower; at N = 2048-12,000 and 24,000 1.03-1.95 times faster), and
# one-warpgroup tiles pay where they fit one round (the pool, digits_h80,
# N = 1024: 1.04-1.11 times faster; past one round up to 1.41 times
# slower).
ROW_BLOCKS_PER_SM = 1


def row_blocks(N: int, H: int, row_split: bool, sms: int,
               blocks_per_sm: int, items_per_block: int = ROW_ITEMS) -> int:
    """Kernel 6's persistent row grid: its work items (item tiles of
    ``items_per_block``, or (tile, model chunk) pairs under the row split),
    at most the blocks a card of ``sms`` SMs holds at once."""
    items = (-(-N // items_per_block)
             * (-(-H // ROW_MODELS) if row_split else 1))
    return max(1, min(items, sms * max(1, blocks_per_sm)))


def choose_row_split(N: int, H: int, sms: int,
                     blocks_per_sm: int = ROW_BLOCKS_PER_SM,
                     items_per_block: int = 2 * ROW_ITEMS) -> bool:
    """Whether kernel 6's row launch takes the row split at N items and H
    models on a card of ``sms`` SMs that each hold ``blocks_per_sm`` row
    blocks of ``items_per_block`` items: where the models span K > 1
    chunks and the grid of P = ``blocks_per_sm * sms`` blocks finishes the
    split's T * K work items (T item tiles), at 1.2 times a round, sooner
    than the single path's K chunks of ceil(T / P) tiles a block:
    ``6 * ceil(T * K / P) < 5 * K * ceil(T / P)``."""
    T, K = -(-N // items_per_block), -(-H // ROW_MODELS)
    P = sms * max(1, blocks_per_sm)
    return K > 1 and 6 * -(-T * K // P) < 5 * K * -(-T // P)


def choose_row_warpgroups(N: int, H: int, row_split: bool, sms: int,
                          blocks_per_sm: int = ROW_BLOCKS_PER_SM) -> int:
    """Kernel 6's consumer warpgroups a row block: one (tiles of
    ROW_ITEMS items, more blocks busy) where the launch's work items at
    that tile, ``ceil(N / ROW_ITEMS)`` times the model chunks under the
    row split, fit one round of ``sms`` SMs of ``blocks_per_sm``
    one-warpgroup blocks; else two (tiles of ``2 * ROW_ITEMS``, each stage
    of the planes shared, half their L2 traffic)."""
    items = -(-N // ROW_ITEMS) * (-(-H // ROW_MODELS) if row_split else 1)
    return 1 if items <= sms * max(1, blocks_per_sm) else 2


def row_plan(C: int, N: int, H: int, num_points: int, sms: int,
             warpgroups: Optional[int] = None,
             row_split: Optional[bool] = None) -> tuple:
    """``(layout, row_split)`` of kernel 6's row launch on the current
    card as its wrapper picks them: the row split (None:
    :func:`choose_row_split` at the two-warpgroup block), then
    :func:`refresh_compute_layout` at ``warpgroups`` consumer warpgroups
    (None: :func:`choose_row_warpgroups`)."""
    if row_split is None:
        two = refresh_compute_layout(C, H, num_points, 2)
        row_split = choose_row_split(N, H, sms, two["blocks_per_sm"],
                                     two["items_per_block"])
    if warpgroups is None:
        warpgroups = choose_row_warpgroups(
            N, H, row_split, sms,
            refresh_compute_layout(C, H, num_points, 1)["blocks_per_sm"])
    return refresh_compute_layout(C, H, num_points, warpgroups), row_split


@functools.lru_cache(maxsize=None)
def _sm_count(device: int) -> int:
    return torch.cuda.get_device_properties(device).multi_processor_count


def _check_chunks(class_chunks: Optional[int], C: int) -> None:
    """A forced ``class_chunks`` must be an int in ``[1, min(C, 65535)]``,
    on any device (the CPU reads it no further)."""
    _require(class_chunks is None or (
        isinstance(class_chunks, int)
        and 1 <= class_chunks <= min(C, _MAX_CHUNKS)),
        f"class_chunks must be an int in [1, {min(C, _MAX_CHUNKS)}] "
        f"(got {class_chunks!r})")


def _sms(cache: torch.Tensor) -> int:
    index = cache.device.index
    return _sm_count(torch.cuda.current_device() if index is None else index)


def _class_chunks(class_chunks: Optional[int], C: int, N: int, H: int,
                  cache: torch.Tensor, approx: bool, S: int = 1) -> int:
    """``class_chunks`` (checked by :func:`_check_chunks`), or the rule's
    choice where it is None."""
    if class_chunks is not None:
        return class_chunks
    return choose_class_chunks(C, N, H, approx, _sms(cache), S)


def _raise_on(rc: int, what: str) -> None:
    if rc != 0:
        raise RuntimeError(f"{what} launch failed: cudaError {rc}")


def _launch(kernel: str, args: tuple, flags: tuple, k: int,
            ent_shape: tuple, dev: torch.device) -> None:
    """Launch ``kernel`` (1, 2, 4 or 5 by its C name's stem) on its single
    decomposition where ``k == 1``, else split over ``k`` class chunks
    through a fresh fp32 scratch ``ent`` of ``ent_shape``."""
    lib = _lib()
    if k == 1:
        rc = getattr(lib, kernel + "_launch")(*args, *flags, _stream())
    else:
        ent = torch.empty(ent_shape, dtype=torch.float32, device=dev)
        rc = getattr(lib, kernel + "_split_launch")(
            *args, ent.data_ptr(), *flags, k, _stream())
    _raise_on(rc, kernel)


def eig_scores_cache(pbest_rows: torch.Tensor, pbest_hyp: torch.Tensor,
                     pi_hat: torch.Tensor, pi_hat_xi: torch.Tensor,
                     chunk: int = 256, approx: bool = False,
                     class_chunks: Optional[int] = None) -> torch.Tensor:
    """Kernel 1 (``csrc/eig_score.cu``): ``(N,)`` EIG scores from the
    ``(C, N, H)`` cache (float32 or bfloat16). CPU tensors take
    :func:`eig_scores_from_cache` (``chunk`` is its memory valve); CUDA
    tensors launch the kernel, over ``class_chunks`` class chunks (None:
    :func:`choose_class_chunks`; 1: the single launch), bitwise the same
    scores at every count."""
    _check_chunks(class_chunks, pbest_hyp.shape[-3])
    if pbest_hyp.device.type == "cpu":
        return eig_scores_from_cache(pbest_rows, pbest_hyp, pi_hat,
                                     pi_hat_xi, chunk, approx)
    C, N, H = _check_operands(pbest_rows, pbest_hyp, pi_hat, pi_hat_xi)
    k = _class_chunks(class_chunks, C, N, H, pbest_hyp, approx)
    mixture0, h_before = mixture_stats(pbest_rows, pi_hat, approx)
    out = torch.empty(N, dtype=torch.float32, device=pbest_hyp.device)
    args = (pbest_rows.data_ptr(), pbest_hyp.data_ptr(), pi_hat.data_ptr(),
            pi_hat_xi.data_ptr(), mixture0.data_ptr(), h_before.data_ptr(),
            out.data_ptr())
    flags = (C, N, H, _vec(H, pbest_hyp, pbest_rows, mixture0),
             int(pbest_hyp.dtype == torch.bfloat16), int(approx))
    _launch("eig_score", args, flags, k, (N, C), pbest_hyp.device)
    _count("eig_score", pbest_hyp.dtype, approx, split=k > 1)
    return out


def eig_scores_refresh(pbest_rows: torch.Tensor, pbest_hyp: torch.Tensor,
                       hyp_t: torch.Tensor, true_class: torch.Tensor,
                       pi_hat: torch.Tensor, pi_hat_xi: torch.Tensor,
                       chunk: int = 256, approx: bool = False,
                       class_chunks: Optional[int] = None):
    """Kernel 2 (``csrc/eig_score.cu``): write ``hyp_t`` (N, H) fp32 into
    class row ``true_class`` of ``pbest_hyp`` IN PLACE, rounded to the
    cache's storage type, and score every item with the stored row, in one
    pass over the cache. ``pbest_rows`` must already hold the refreshed
    row; ``pbest_hyp`` holds the old one. ``true_class`` is a 0-d or
    1-element integer tensor on the cache's device, read by the kernel (no
    host synchronisation); out of range gives NaN scores. ``class_chunks``
    as for :func:`eig_scores_cache`: scores and cache bitwise the same at
    every count. Returns ``(scores (N,), pbest_hyp)``."""
    _check_chunks(class_chunks, pbest_hyp.shape[-3])
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
    k = _class_chunks(class_chunks, C, N, H, pbest_hyp, approx)
    mixture0, h_before = mixture_stats(pbest_rows, pi_hat, approx)
    out = torch.empty(N, dtype=torch.float32, device=pbest_hyp.device)
    args = (pbest_rows.data_ptr(), pbest_hyp.data_ptr(), hyp_t.data_ptr(),
            c.data_ptr(), pi_hat.data_ptr(), pi_hat_xi.data_ptr(),
            mixture0.data_ptr(), h_before.data_ptr(), out.data_ptr())
    flags = (C, N, H, _vec(H, pbest_hyp, pbest_rows, hyp_t, mixture0),
             int(pbest_hyp.dtype == torch.bfloat16), int(approx))
    _launch("eig_refresh_score", args, flags, k, (N, C), pbest_hyp.device)
    _count("eig_refresh_score", pbest_hyp.dtype, approx, split=k > 1)
    return out, pbest_hyp


def eig_scores_cache_batched(pbest_rows: torch.Tensor,
                             pbest_hyp: torch.Tensor, pi_hat: torch.Tensor,
                             pi_hat_xi: torch.Tensor, chunk: int = 256,
                             approx: bool = False,
                             class_chunks: Optional[int] = None
                             ) -> torch.Tensor:
    """Kernel 4 (``csrc/eig_score.cu``): kernel 1 for S replicas in one
    launch. ``pbest_rows`` (S, C, H), ``pbest_hyp`` (S, C, N, H) float32 or
    bfloat16, ``pi_hat`` (S, C), ``pi_hat_xi`` (S, N, C) -> ``(S, N)``
    scores, row s bitwise kernel 1's on replica s. CPU tensors take
    :func:`eig_scores_from_cache_batched`. On the card the launch takes
    one of two decompositions, with the same bits: grid ``(N/32, S)``, each
    warp walking its items' classes in turn, where ``S * N`` items keep
    the card busy; else, at a short item axis, each replica's class loop
    split over ``class_chunks`` chunks on another grid axis, then a
    mixture launch (None: :func:`choose_class_chunks` with S; 1: the
    single launch)."""
    _check_chunks(class_chunks, pbest_hyp.shape[-3])
    if pbest_hyp.device.type == "cpu":
        return eig_scores_from_cache_batched(pbest_rows, pbest_hyp, pi_hat,
                                             pi_hat_xi, chunk, approx)
    C, N, H = _check_operands(pbest_rows, pbest_hyp, pi_hat, pi_hat_xi,
                              batched=True)
    S = pbest_hyp.shape[0]
    k = _class_chunks(class_chunks, C, N, H, pbest_hyp, approx, S)
    mixture0, h_before = mixture_stats(pbest_rows, pi_hat, approx)
    out = torch.empty((S, N), dtype=torch.float32, device=pbest_hyp.device)
    args = (pbest_rows.data_ptr(), pbest_hyp.data_ptr(), pi_hat.data_ptr(),
            pi_hat_xi.data_ptr(), mixture0.data_ptr(), h_before.data_ptr(),
            out.data_ptr())
    flags = (S, C, N, H, _vec(H, pbest_hyp, pbest_rows, mixture0),
             int(pbest_hyp.dtype == torch.bfloat16), int(approx))
    _launch("eig_score_batched", args, flags, k, (S, N, C),
            pbest_hyp.device)
    _count("eig_score_batched", pbest_hyp.dtype, approx, split=k > 1)
    return out


def eig_scores_refresh_batched(pbest_rows: torch.Tensor,
                               pbest_hyp: torch.Tensor, hyp_t: torch.Tensor,
                               true_class: torch.Tensor, pi_hat: torch.Tensor,
                               pi_hat_xi: torch.Tensor, chunk: int = 256,
                               approx: bool = False,
                               class_chunks: Optional[int] = None):
    """Kernel 5 (``csrc/eig_score.cu``): kernel 2 for S replicas in one
    launch. Replica s writes ``hyp_t[s]`` (N, H) fp32 into its class row
    ``true_class[s]`` of ``pbest_hyp`` (S, C, N, H) IN PLACE, rounded to
    the storage type, and scores every item with the stored row; row s of
    the scores and replica s of the cache are bitwise kernel 2's on
    replica s. ``true_class`` is an integer (S,) tensor on the cache's
    device, read by the kernel; an out-of-range class gives NaN scores for
    its replica only, and leaves its cache untouched. ``class_chunks``
    picks the decomposition as for :func:`eig_scores_cache_batched`
    (the chunk holding a replica's class writes its row): scores and cache
    bitwise the same at every count. Returns ``(scores (S, N),
    pbest_hyp)``."""
    _check_chunks(class_chunks, pbest_hyp.shape[-3])
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
    k = _class_chunks(class_chunks, C, N, H, pbest_hyp, approx, S)
    mixture0, h_before = mixture_stats(pbest_rows, pi_hat, approx)
    out = torch.empty((S, N), dtype=torch.float32, device=pbest_hyp.device)
    args = (pbest_rows.data_ptr(), pbest_hyp.data_ptr(), hyp_t.data_ptr(),
            c.data_ptr(), pi_hat.data_ptr(), pi_hat_xi.data_ptr(),
            mixture0.data_ptr(), h_before.data_ptr(), out.data_ptr())
    flags = (S, C, N, H, _vec(H, pbest_hyp, pbest_rows, hyp_t, mixture0),
             int(pbest_hyp.dtype == torch.bfloat16), int(approx))
    _launch("eig_refresh_score_batched", args, flags, k, (S, N, C),
            pbest_hyp.device)
    _count("eig_refresh_score_batched", pbest_hyp.dtype, approx,
           split=k > 1)
    return out, pbest_hyp


# -- the sharded entries (a mesh's (data, model) block) --------------------
# Each launches its kernel on this rank's (C, N/a, H/b) block, with the
# mixture and h_before computed from the rank's own H columns of the
# P(best) rows (:func:`mixture_stats`). The kernel then returns this rank's
# part of every score, ``h_before_j - Σ_c pi_xi[n, c] · H2_j[c, n]``: the
# entropy H2 is a plain sum over models with no normalisation
# (``csrc/eig_score.cu``), so the model group's rank-order sum of the
# parts (``gather_sum`` over the model axis) is the score. On the data
# axis alone the part is the score, and no collective runs.

def _check_block(pbest_hyp: torch.Tensor, pi_hat_xi: torch.Tensor, mesh,
                 n_global: int, h_global: Optional[int] = None) -> None:
    """The operands must be this rank's block: ``(..., C, N/a, H/b)``
    cache rows and ``(..., N/a, C)`` pi-hat rows of a task of
    ``n_global`` items (and ``h_global`` models, default ``H/b`` times
    the model axis) on a ``data=a,model=b`` mesh."""
    n, h = pbest_hyp.shape[-2], pbest_hyp.shape[-1]
    _require(n * mesh.data == n_global and pi_hat_xi.shape[-2] == n,
             f"a sharded entry takes this rank's block of N: the cache "
             f"holds {n} items and pi_hat_xi {pi_hat_xi.shape[-2]}, a "
             f"{mesh.spec} block of N={n_global} is {n_global // mesh.data}")
    if h_global is not None:
        _require(h * mesh.model == h_global,
                 f"a sharded entry takes this rank's block of H: the cache "
                 f"holds {h} models, a {mesh.spec} block of H={h_global} is "
                 f"{h_global // mesh.model}")


def _model_sum(part: torch.Tensor, mesh) -> torch.Tensor:
    """The score from this rank's part: the model group's rank-order sum
    (the part itself on a mesh without a model axis)."""
    return gather_sum(part, mesh, MODEL_AXIS) if mesh.model > 1 else part


def eig_scores_cache_sharded(pbest_rows: torch.Tensor,
                             pbest_hyp: torch.Tensor, pi_hat: torch.Tensor,
                             pi_hat_xi: torch.Tensor, mesh, n_global: int,
                             chunk: int = 256, approx: bool = False,
                             h_global: Optional[int] = None,
                             plain: bool = False) -> torch.Tensor:
    """Kernel 1 per ``(data, model)`` block (the counterpart of the
    reference's ``eig_scores_cache_pallas_sharded``): ``pi_hat``
    replicated, ``pbest_rows`` this rank's ``(C, H/b)`` columns,
    ``pbest_hyp`` its ``(C, N/a, H/b)`` block and ``pi_hat_xi`` its
    ``(N/a, C)`` rows -> this rank's ``(N/a,)`` scores, the same on every
    rank of its model group. The arg-max over the data axis happens
    outside. CPU tensors take the plain version, as
    :func:`eig_scores_cache` does; ``plain`` takes it on any device (the
    ``eig_backend='jnp'`` yardstick, as in each entry below)."""
    _check_block(pbest_hyp, pi_hat_xi, mesh, n_global, h_global)
    fn = eig_scores_from_cache if plain else eig_scores_cache
    return _model_sum(fn(pbest_rows, pbest_hyp, pi_hat,
                                       pi_hat_xi, chunk=chunk,
                                       approx=approx), mesh)


def eig_scores_refresh_sharded(pbest_rows: torch.Tensor,
                               pbest_hyp: torch.Tensor, hyp_t: torch.Tensor,
                               true_class: torch.Tensor,
                               pi_hat: torch.Tensor, pi_hat_xi: torch.Tensor,
                               mesh, n_global: int, chunk: int = 256,
                               approx: bool = False,
                               h_global: Optional[int] = None,
                               plain: bool = False):
    """Kernel 2 per block (``eig_scores_refresh_pallas_sharded``): each
    rank writes its ``(N/a, H/b)`` slice ``hyp_t`` of class row
    ``true_class`` into its block of the cache IN PLACE and scores its
    items; ``(scores (N/a,), pbest_hyp)``."""
    _check_block(pbest_hyp, pi_hat_xi, mesh, n_global, h_global)
    fn = eig_scores_refresh_plain if plain else eig_scores_refresh
    part, hyp = fn(pbest_rows, pbest_hyp, hyp_t, true_class,
                                   pi_hat, pi_hat_xi, chunk=chunk,
                                   approx=approx)
    return _model_sum(part, mesh), hyp


def eig_scores_cache_batched_sharded(pbest_rows, pbest_hyp, pi_hat,
                                     pi_hat_xi, mesh, n_global: int,
                                     chunk: int = 256, approx: bool = False,
                                     h_global: Optional[int] = None,
                                     plain: bool = False):
    """Kernel 4 per block: :func:`eig_scores_cache_sharded` for S
    replicas, ``(S, C, N/a, H/b)`` -> ``(S, N/a)``."""
    _check_block(pbest_hyp, pi_hat_xi, mesh, n_global, h_global)
    fn = (eig_scores_from_cache_batched if plain
          else eig_scores_cache_batched)
    return _model_sum(fn(
        pbest_rows, pbest_hyp, pi_hat, pi_hat_xi, chunk=chunk,
        approx=approx), mesh)


def eig_scores_refresh_batched_sharded(pbest_rows, pbest_hyp, hyp_t,
                                       true_class, pi_hat, pi_hat_xi, mesh,
                                       n_global: int, chunk: int = 256,
                                       approx: bool = False,
                                       h_global: Optional[int] = None,
                                       plain: bool = False):
    """Kernel 5 per block: :func:`eig_scores_refresh_sharded` for S
    replicas, each writing its own class row of its block."""
    _check_block(pbest_hyp, pi_hat_xi, mesh, n_global, h_global)
    fn = (eig_scores_refresh_batched_plain if plain
          else eig_scores_refresh_batched)
    part, hyp = fn(pbest_rows, pbest_hyp, hyp_t,
                                           true_class, pi_hat, pi_hat_xi,
                                           chunk=chunk, approx=approx)
    return _model_sum(part, mesh), hyp


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
                               chunk: int = 256,
                               class_chunks: Optional[int] = None,
                               row_split: Optional[bool] = None,
                               warpgroups: Optional[int] = None):
    """Kernel 6 (``csrc/eig_refresh_compute.cu``): compute class row
    ``true_class`` of the cache from the Beta parameters ``a_t``, ``b_t``
    (H,) of the labelled class and ``hard_preds`` (N, H) int32, write it
    into ``pbest_hyp`` IN PLACE at the storage type, and score every item
    with the stored row. ``pbest_rows`` must already hold the refreshed
    P(best) row; ``pbest_hyp`` holds the old class row. The O(H·G) tables
    are built here with PyTorch, as the reference's wrapper builds them,
    and so is the fp32 ``(N, H)`` scratch of the unnormalised rows; the
    kernel splits the tables into TF32 planes itself (one launch,
    :func:`split_tables`). H is bounded by the row kernel's shared memory
    (the eq bitmask of its item tile: 16,384 models at ``num_points=256``;
    see :func:`row_layout`). CPU tensors take
    :func:`eig_scores_refresh_compute_plain` (``chunk`` is its scoring
    valve). On the card the work takes one of several decompositions, with
    the same scores, row and cache bits: the scoring over ``class_chunks``
    class chunks (None: :func:`choose_class_chunks`; 1: the single
    launch), the row launch with its model chunks split over the grid
    where ``row_split`` (None: :func:`choose_row_split`), with 1 or 2
    consumer warpgroups a row block (``warpgroups``; None:
    :func:`choose_row_warpgroups`; two are cut to one where they do not
    fit). Forced ``class_chunks``, ``row_split`` and ``warpgroups`` are
    checked on every device, the CPU included. Returns ``(scores (N,),
    pbest_hyp)``.
    """
    _check_chunks(class_chunks, pbest_hyp.shape[-3])
    _require(row_split is None or isinstance(row_split, bool),
             f"row_split must be None or a bool (got {row_split!r})")
    _require(warpgroups is None or (type(warpgroups) is int
                                    and warpgroups in (1, 2)),
             f"warpgroups must be None, 1 or 2 (got {warpgroups!r})")
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
    check_row_layout(C, H, num_points)
    sms = _sms(pbest_hyp)
    layout, row_split = row_plan(C, N, H, num_points, sms, warpgroups,
                                 row_split)
    S0, dlogcdf, F_u, dF, w_trapz = refresh_tables(a_t, b_t, update_weight,
                                                   num_points)
    F_u, dF = F_u.contiguous(), dF.contiguous()   # (H, G): K-major already
    mixture0, h_before = mixture_stats(pbest_rows, pi_hat, approx)
    k = _class_chunks(class_chunks, C, N, H, pbest_hyp, approx)
    chunks = -(-H // ROW_MODELS)
    blocks = row_blocks(N, H, row_split, sms, layout["blocks_per_sm"],
                        layout["items_per_block"])
    gp = -(-num_points // ROW_POINTS) * ROW_POINTS
    # the tables' TF32 planes; w and the eq mask between the S and row
    # launches; the unnormalised rows and their clamped sums between the
    # row and scoring launches; the row split's per-chunk sums; the class
    # split's class terms
    planes = torch.empty((4, H, gp), dtype=torch.float32, device=dev)
    wbuf = torch.empty((N, gp), dtype=torch.float32, device=dev)
    mbuf = torch.empty((N, mask_words(H)), dtype=torch.int32, device=dev)
    scratch = torch.empty((N, H), dtype=torch.float32, device=dev)
    den = torch.empty(N, dtype=torch.float32, device=dev)
    part = (torch.empty((chunks, N), dtype=torch.float32, device=dev)
            if row_split else None)
    ent = torch.empty((N, C), dtype=torch.float32, device=dev) \
        if k > 1 else None
    out = torch.empty(N, dtype=torch.float32, device=dev)
    rc = lib.eig_refresh_compute_launch(
        pbest_rows.data_ptr(), pbest_hyp.data_ptr(), hard_preds.data_ptr(),
        c.data_ptr(), S0.data_ptr(), dlogcdf.data_ptr(), F_u.data_ptr(),
        dF.data_ptr(), w_trapz.data_ptr(), pi_hat.data_ptr(),
        pi_hat_xi.data_ptr(), mixture0.data_ptr(), h_before.data_ptr(),
        planes.data_ptr(), wbuf.data_ptr(), mbuf.data_ptr(),
        scratch.data_ptr(), den.data_ptr(),
        None if part is None else part.data_ptr(),
        None if ent is None else ent.data_ptr(), out.data_ptr(), C, N, H,
        num_points, _vec(H, pbest_hyp, pbest_rows, mixture0, scratch),
        int(pbest_hyp.dtype == torch.bfloat16), int(approx), k,
        int(row_split), blocks, layout["warpgroups"], _stream())
    _raise_on(rc, "eig_refresh_compute_score")
    _count("eig_refresh_compute_score", pbest_hyp.dtype, approx,
           split=k > 1 or row_split)
    return out, pbest_hyp
