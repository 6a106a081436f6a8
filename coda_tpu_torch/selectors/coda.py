"""CODA: consensus-driven active model selection on the card (counterpart
of ``coda_tpu/selectors/coda.py``).

Every EIG tier of the reference, chosen by ``eig_mode`` (``auto`` takes
the reference's rule, :func:`resolve_eig_mode`):

  * **incremental** — the ``(C, N, H)`` hypothetical-P(best) cache is
    carried in the state and one class row is refreshed a round; scoring
    runs through the CUDA kernels (``ops/eig_kernels``): kernel 1 at init,
    kernel 2 (precomputed refresh) or kernel 6 (``eig_refresh='fused'``)
    a round, the pi-hat column through kernel 3 (``ops/gather_kernels``);
  * **factored** — no cache: every round scores all N from the C class
    rows' Beta grid tables by three fp32 products a block
    (:func:`eig_scores_factored`), and pi-hat is recomputed in full;
  * **rowscan** — the factored integral over groups of class rows, with
    temporaries bounded by a byte budget instead of (C, H, G) tables
    (:func:`eig_scores_rowscan`);
  * **direct** — the reference's per-item choreography, ``compute_pbest``
    for every item and class (:func:`eig_scores`), a cross-check.

and the knobs on them: ``eig_precision`` (the precision of the EIG table
products, :func:`~coda_tpu_torch.ops.pbest.eig_matmul`), ``posterior``
(dense, or the sparse top-K rows of ``ops/sparse_rows``, incremental tier
only), ``eig_pbest`` (the quadrature, or the amortized logistic-normal
tables gated on the labelled row's concentration), ``pi_update`` (the
delta column through kernel 3, or the exact column recompute),
``prefilter_n`` and the ``q`` ablations. The factored, rowscan and direct
tiers, the prefilter and the ablations run no kernel of this repository:
the reference leaves them to XLA einsums, and here they are PyTorch
products.

Each round: select (a tie-broken masked argmax over the round's scores —
the incremental tier's were computed at the end of the previous
init/update), update (the Dirichlet row, pi-hat, and on the incremental
tier the cache row with the next scores), best (the argmax of the
pi-hat-weighted P(best) rows).

The selector has a seed-batched form (``Selector.batched``) on every
tier except the fused refresh, which the reference refuses under ``vmap``:
the same state with a leading replica axis S, one round for all S seeds.
Off the incremental tier, replica s follows seed s's one-seed run
bitwise: the scoring, the pi-hat recompute and the P(best) readout run one
replica at a time inside the round, since neither cuBLAS nor PyTorch's
reductions promise one summation order at every batch size.

Batched acquisition (``--acq-batch q``, ``selectors/batch.py``): on the
full-pool EIG acquisition ``select_q`` re-ranks the round's one score
vector greedily with the reference's information-overlap penalty, and
``update_q`` applies the q answers as one update — the posterior rows,
pi-hat column by column (kernel 3 once an answer on the delta path), the
q class rows of the cache refreshed from the final posterior, then ONE
scoring pass (kernel 1). Several seeds run one after another: a seed
batch refreshes its rows replica by replica anyway, and measured slower
on the card than the seeds in turn. Under
``eig_refresh='fused'`` the q answers go through ``update`` one after
another (kernel 6 and kernel 3 q times a round). ``update_w`` and
``update_qw`` scale an answer's increment by a weight (the crowd oracle's
protocol).

The contract-gated surrogate scorer (``eig_scorer='surrogate:k'``,
``selectors/surrogate.py``, incremental tier, precomputed refresh): the
class row is written without kernel 2, and the round's scores are the
surrogate's hybrid vector, or the full pass through kernel 1 on a warmup
or fallback round. Its seeds run one after another (the round's branch
is a host decision per seed).

State is updated IN PLACE where the reference returned new arrays: the
Dirichlet (or sparse) row, the pi-hat column, the cache row and the
unlabeled mask. Every product runs at fp32 with TF32 off, except the EIG
table products under ``eig_precision`` ``high`` or ``default``, which
switch TF32 on for those products alone. ``shard_spec`` raises
``NotImplementedError`` naming the later slice that brings it.
"""

from __future__ import annotations

import math
from typing import NamedTuple, Optional

import torch
import torch.nn.functional as F

from coda_tpu_torch import random as trandom
from coda_tpu_torch.ops.beta import dirichlet_to_beta
from coda_tpu_torch.ops.confusion import (
    create_confusion_matrices,
    ensemble_preds,
    initialize_dirichlets,
)
from coda_tpu_torch.ops.eig_kernels import (
    eig_scores_cache,
    eig_scores_cache_batched,
    eig_scores_from_cache,
    eig_scores_from_cache_batched,
    eig_scores_rows,
    eig_scores_refresh,
    eig_scores_refresh_batched,
    eig_scores_refresh_batched_plain,
    eig_scores_refresh_compute,
    eig_scores_refresh_compute_plain,
    eig_scores_refresh_plain,
)
from coda_tpu_torch.ops.gather_kernels import (
    gather_rows_sum,
    gather_rows_sum_batched,
    gather_rows_sum_batched_plain,
    gather_rows_sum_plain,
    prep_gather_layout,
)
from coda_tpu_torch.ops.masked import entropy2, masked_argmax_tiebreak
from coda_tpu_torch.ops.pbest import (
    _bump_tables,
    _pbest_hyp_from_tables,
    _pbest_hyp_row,
    _pbest_hyp_row_gated,
    _trapz_weights,
    compute_pbest,
    compute_pbest_rows,
    pbest_grid,
    pbest_row_mixture,
)
from coda_tpu_torch.ops.sparse_rows import (
    SparseRows,
    _even_share,
    _take_row,
    densify_row,
    parse_posterior,
    posterior_nbytes,
    scatter_row,
    sparsify,
)
from coda_tpu_torch.ops.sparse_rows import row_beta as sparse_row_beta
from coda_tpu_torch.selectors import surrogate as sg
from coda_tpu_torch.selectors.protocol import (
    BatchedSelector,
    Selector,
    SelectResult,
)
from coda_tpu_torch.selectors.uncertainty import uncertainty_scores
from coda_tpu_torch.utils.platform import (
    DeviceLike,
    pin_fp32_matmul,
    resolve_device,
)

# reference coda/coda.py:307: isclose(rtol=1e-8) with torch's default
# atol=1e-8; atol dominates for tiny EIG entropy deltas
_TIE_RTOL = 1e-8
_TIE_ATOL = 1e-8

# The reference's "auto" budgets, kept so that "auto" names the same tier
# in both packages. They were sized for a TPU's memory: the incremental
# tier while its per-replica cache + (C, H, N) delta layout + posterior
# fit 4 GiB (6 GiB under the surrogate scorer), then the factored tier
# while its four (C, H, G) fp32 tables per replica fit 2 GiB, then
# rowscan.
_INCR_CACHE_MAX_BYTES = 4 << 30
_SURROGATE_INCR_CACHE_MAX_BYTES = 6 << 30
_TABLES_MAX_BYTES = 2 << 30

# eig_pbest='amortized' engages on a round whose labelled row has
# min_h(a + b) at or above this (the reference's calibrated gate: the
# 2.34e-4 score contract holds above it); below, the quadrature runs
_AMORTIZED_MIN_CONC = 32.0

# temporaries of one step of the row-scanned tier (a group of class rows
# over a block of items) and of one block of the direct tier: the groups
# and blocks are sized to stay under these
_ROWSCAN_TEMP_BYTES = 1 << 30
_DIRECT_TEMP_BYTES = 1 << 30
# temporaries of one batched pass of a q-wide round's class-row refresh
# (:func:`_refresh_row_chunk`)
_REFRESH_TEMP_BYTES = 1 << 30

_SLICE_5 = "the N-axis parallel part of slice 5 of the port"

# eig_backend values that run the plain PyTorch versions: the reference's
# name for its non-kernel path, and the port's own
PLAIN_BACKENDS = ("jnp", "plain")

EIG_MODES = ("incremental", "factored", "rowscan", "direct")
PRECISIONS = ("highest", "high", "default")


class CODAHyperparams(NamedTuple):
    """The reference's fields and defaults. ``shard_spec`` raises at
    anything but its default (the N-axis parallel part of slice 5)."""

    prefilter_n: int = 0          # EIG on a random subset of this many
    #                               candidates a round (0: all)
    alpha: float = 0.9            # prior_strength = 1 - alpha
    learning_rate: float = 0.01   # update_strength
    multiplier: float = 2.0
    disable_diag_prior: bool = False
    q: str = "eig"                # acquisition: eig | iid | uncertainty
    eig_chunk: int = 256          # N-block of the scoring passes and the
    #                               cache build (a memory valve)
    num_points: int = 256         # P(best) integration grid
    eig_mode: str = "auto"        # auto | incremental | factored |
    #                               rowscan | direct
    eig_backend: str = "auto"     # auto = the CUDA kernels on a card, the
    #                               plain versions on the CPU; jnp (the
    #                               reference's name; alias plain) = the
    #                               plain versions everywhere (the yardstick
    #                               the kernels are held to on the card)
    n_parallel: int = 1           # replicas sharing the card: the seeds
    #                               the engine batches (auto budget)
    eig_precision: str = "highest"  # highest | high | default: the EIG
    #                               table products only (fp32; fp32; one
    #                               TF32 pass on the card; no effect on the
    #                               CPU, as in the reference)
    eig_cache_dtype: str = "float32"  # float32 | bfloat16: storage of the
    #                               (C, N, H) cache; all math stays fp32
    eig_refresh: str = "precomputed"  # precomputed | fused: the class row
    #                               is computed by three fp32 products
    #                               before the scoring pass, or inside it
    #                               (kernel 6; opt-in numerics, as in the
    #                               reference)
    eig_entropy: str = "exact"    # exact | approx: the scoring chain's log2
    shard_spec: str = ""
    posterior: str = "dense"      # dense | sparse:K (incremental tier only)
    eig_pbest: str = "quad"       # quad | amortized (incremental tier,
    #                               precomputed refresh)
    eig_scorer: str = "exact"     # exact | surrogate:k (incremental tier,
    #                               precomputed refresh)
    surrogate_prior: str = "off"  # off | pool: the surrogate's fit seeded
    #                               from a cross-session prior
    pi_update: str = "auto"       # auto (= delta) | delta | exact


def _unsupported(knob: str, value, where: str):
    raise NotImplementedError(
        f"{knob}={value!r} comes with {where}; coda_tpu_torch runs every EIG "
        "tier, numerics knob and scorer of the reference on one card")


def resolve_pi_update(hp: CODAHyperparams, N: Optional[int] = None) -> str:
    """The pi-hat refresh the incremental tier runs: ``exact`` (the column
    recomputed from the posterior row) when asked, else ``delta`` (the
    label's exact linear increment, kernel 3 on the card). The reference
    resolves ``auto`` by backend — delta on the CPU, the exact column on a
    TPU where its gather kernel cannot run; on the card kernel 3 always
    can, so ``auto`` is ``delta``."""
    del N
    if hp.pi_update not in ("auto", "delta", "exact"):
        raise ValueError(f"unknown pi_update {hp.pi_update!r} "
                         "(use 'auto', 'delta' or 'exact')")
    return "exact" if hp.pi_update == "exact" else "delta"


def resolve_precision(name: str) -> str:
    """``eig_precision`` checked: ``highest``, ``high`` or ``default``
    (what :func:`~coda_tpu_torch.ops.pbest.eig_matmul` takes)."""
    if name not in PRECISIONS:
        raise ValueError(
            f"unknown eig_precision {name!r} (use highest/high/default)")
    return name


def resolve_eig_mode(hp: CODAHyperparams, H: int, N: int, C: int) -> str:
    """The EIG tier, by the reference's rule: ``auto`` -> incremental while
    the acquisition is full-pool EIG and every replica's cache (at its
    storage type), delta layout (unless ``pi_update='exact'``) and
    posterior (dense or sparse) fit the budget; else factored while the
    replicas' (C, H, G) tables fit theirs; else rowscan. An explicit
    ``incremental`` without full-pool EIG raises."""
    full_pool_eig = (hp.q == "eig"
                     and not (hp.prefilter_n and hp.prefilter_n < N))
    if hp.eig_mode != "auto":
        if hp.eig_mode not in EIG_MODES:
            raise ValueError(f"unknown eig_mode {hp.eig_mode!r} (use auto, "
                             + ", ".join(EIG_MODES) + ")")
        if hp.eig_mode == "incremental" and not full_pool_eig:
            raise ValueError(
                "eig_mode='incremental' requires the full-pool EIG "
                "acquisition (q='eig' without an active prefilter); the "
                f"requested config (q={hp.q!r}, prefilter_n={hp.prefilter_n}) "
                "would maintain a large P(best) cache that is never read")
        return hp.eig_mode
    itemsize = 2 if hp.eig_cache_dtype == "bfloat16" else 4
    cache_bytes = itemsize * N * C * H
    budget = (_SURROGATE_INCR_CACHE_MAX_BYTES if hp.eig_scorer != "exact"
              else _INCR_CACHE_MAX_BYTES)
    delta_bytes = 4 * N * C * H if resolve_pi_update(hp, N) == "delta" else 0
    post_bytes = posterior_nbytes(H, C, parse_posterior(hp.posterior))
    par = max(1, hp.n_parallel)
    if full_pool_eig and par * (cache_bytes + delta_bytes + post_bytes) \
            <= budget:
        return "incremental"
    if par * 16 * C * H * hp.num_points <= _TABLES_MAX_BYTES:
        return "factored"
    return "rowscan"


def batches_seeds(hp: CODAHyperparams) -> bool:
    """Whether the selector has a seed-batched form: every tier does but
    the fused refresh (the reference refuses it under ``vmap``) and the
    surrogate scorer (its round branches per seed on the host)."""
    return hp.eig_refresh != "fused" and hp.eig_scorer == "exact"


def check_supported(hp: CODAHyperparams, N: int) -> None:
    """Raise on every knob value the port does not run: ``ValueError``
    with the reference's text where the reference refuses the value too,
    ``NotImplementedError`` where a later slice brings it. The refusals
    that depend on the resolved tier are :func:`check_tier`'s."""
    del N
    if hp.q not in ("eig", "iid", "uncertainty"):
        raise ValueError(f"unknown q {hp.q!r} "
                         "(use 'eig', 'iid' or 'uncertainty')")
    if hp.eig_backend not in ("auto",) + PLAIN_BACKENDS:
        raise ValueError(f"unknown eig_backend {hp.eig_backend!r} "
                         "(use 'auto', 'jnp' or 'plain')")
    if hp.eig_cache_dtype not in ("float32", "bfloat16"):
        raise ValueError(f"unknown eig_cache_dtype {hp.eig_cache_dtype!r} "
                         "(use 'float32' or 'bfloat16')")
    if hp.eig_entropy not in ("exact", "approx"):
        raise ValueError(f"unknown eig_entropy {hp.eig_entropy!r} "
                         "(use 'exact' or 'approx')")
    if hp.eig_refresh not in ("precomputed", "fused"):
        raise ValueError(f"unknown eig_refresh {hp.eig_refresh!r} "
                         "(use 'precomputed' or 'fused')")
    if hp.eig_pbest not in ("quad", "amortized"):
        raise ValueError(f"unknown eig_pbest {hp.eig_pbest!r} "
                         "(use 'quad' or 'amortized')")
    resolve_pi_update(hp)
    resolve_precision(hp.eig_precision)
    parse_posterior(hp.posterior)
    scorer_k = sg.parse_scorer(hp.eig_scorer)
    if sg.parse_prior(hp.surrogate_prior) and scorer_k is None:
        raise ValueError(
            "surrogate_prior='pool' warm-starts the carried surrogate "
            "fit; eig_scorer='exact' carries none — it would silently "
            "not apply (use eig_scorer='surrogate:k' or "
            "surrogate_prior='off')")
    if hp.eig_refresh == "fused" and (hp.shard_spec or hp.n_parallel > 1):
        raise ValueError(
            "eig_refresh='fused' computes the replacement row inside the "
            "single-chip pallas scoring kernel; it requires the pallas "
            "backend and supports neither shard_spec nor vmapped batches "
            f"(got backend={hp.eig_backend!r}, shard_spec={hp.shard_spec!r}, "
            f"n_parallel={hp.n_parallel})")
    if hp.shard_spec:
        _unsupported("shard_spec", hp.shard_spec, _SLICE_5)


def check_tier(hp: CODAHyperparams, eig_mode: str) -> None:
    """The reference's refusals of knobs that would silently not apply
    on the resolved tier (``ValueError``, the reference's text)."""
    if parse_posterior(hp.posterior) is not None and eig_mode != "incremental":
        raise ValueError(
            "posterior='sparse:K' requires the incremental EIG tier "
            f"(this config resolved to eig_mode={eig_mode!r}): the dense "
            "recompute tiers re-read the full posterior every round, so a "
            "sparse carry would be densified right back — shrink the "
            "config into the incremental budget or use posterior='dense'")
    if hp.eig_pbest == "amortized" and eig_mode != "incremental":
        raise ValueError(
            "eig_pbest='amortized' replaces the incremental row-refresh "
            f"quadrature; this config resolved to eig_mode={eig_mode!r} "
            "where it would silently not apply")
    if eig_mode == "direct" and hp.eig_precision != "highest":
        raise ValueError(
            "eig_mode='direct' is the reference-choreography cross-check "
            "kernel and always runs at HIGHEST precision; "
            f"eig_precision={hp.eig_precision!r} would silently not apply")
    if eig_mode == "direct" and hp.eig_entropy == "approx":
        raise ValueError(
            "eig_mode='direct' is the reference-choreography cross-check "
            "kernel and always uses the exact entropy lowering; "
            "eig_entropy='approx' would silently not apply")
    fused = hp.eig_refresh == "fused"
    if fused and eig_mode != "incremental":
        raise ValueError(
            "eig_refresh='fused' computes the incremental tier's cache row "
            f"inside the scoring kernel, but this config resolved to "
            f"eig_mode={eig_mode!r} — it would silently never run")
    if hp.eig_pbest == "amortized" and fused:
        raise ValueError(
            "eig_pbest='amortized' runs the row refresh through the jnp "
            "logistic-normal tables; the pallas kernels compute their own "
            f"Beta tables (got backend={hp.eig_backend!r}, "
            f"eig_refresh={hp.eig_refresh!r}) — it would silently not "
            "apply")
    surrogate = sg.parse_scorer(hp.eig_scorer) is not None
    if surrogate and eig_mode != "incremental":
        raise ValueError(
            "eig_scorer='surrogate:k' amortizes the incremental tier's "
            f"scoring pass; this config resolved to eig_mode={eig_mode!r} "
            "where the shortlist refresh has no carried cache to read — "
            "shrink the config into the incremental budget or use "
            "eig_scorer='exact'")
    if surrogate and fused:
        raise ValueError(
            "eig_scorer='surrogate:k' scores through the shortlist "
            "gather; eig_refresh='fused' scores the full pool inside the "
            "refresh kernel and cannot take the hybrid vector — drop "
            "eig_refresh='fused' or the surrogate")


class CODAState(NamedTuple):
    """Selector state (the reference's ``CODAState``). The cache fields
    are None off the incremental tier; a sparse posterior (``sparse``)
    replaces ``dirichlets``; ``surrogate`` is the surrogate scorer's fit
    (None for the exact scorer). ``update`` modifies these tensors in
    place. The seed-batched form carries the same fields with a leading
    replica axis S."""

    dirichlets: Optional[torch.Tensor]  # (H, C, C) Dirichlet posteriors
    pi_hat_xi: torch.Tensor         # (N, C) per-item class posterior
    pi_hat: torch.Tensor            # (C,) marginal class estimate
    unlabeled: torch.Tensor         # (N,) bool
    pbest_rows: Optional[torch.Tensor] = None   # (C, H) P(best | row c)
    pbest_hyp: Optional[torch.Tensor] = None    # (C, N, H) ... under a
    #                                             +1 label of n as c
    pi_xi_unnorm: Optional[torch.Tensor] = None  # (N, C) unnormalised pi
    eig_scores_cached: Optional[torch.Tensor] = None  # (N,) next scores
    sparse: Optional[SparseRows] = None  # the sparse:K posterior
    surrogate: Optional[sg.SurrogateFit] = None  # the surrogate's fit


# -- pi-hat ------------------------------------------------------------------

def pi_unnorm(dirichlets: torch.Tensor, preds: torch.Tensor) -> torch.Tensor:
    """Unnormalised (N, C) class scores ``Σ_{h,s} d[h,c,s]·preds[h,n,s]``.
    A ``(S, H, C, C)`` posterior gives ``(S, N, C)``, one contraction per
    replica (each replica's bits are then its one-seed run's)."""
    if dirichlets.dim() == 4:
        return torch.stack([pi_unnorm(d, preds) for d in dirichlets])
    return torch.einsum("hcs,hns->nc", dirichlets, preds)


def _normalize_pi(unnorm: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """(pi_hat_xi, pi_hat) from the unnormalised (..., N, C) class
    scores; with a replica axis one replica at a time (the reduction over
    N may add in another order on a larger tensor)."""
    if unnorm.dim() == 3:
        pi_xi, pi = zip(*(_normalize_pi(u) for u in unnorm))
        return torch.stack(pi_xi), torch.stack(pi)
    pi_xi = unnorm / torch.clamp_min(unnorm.sum(-1, keepdim=True), 1e-12)
    pi = pi_xi.sum(-2)
    return pi_xi, pi / pi.sum(-1, keepdim=True)


def update_pi_hat(dirichlets: torch.Tensor, preds: torch.Tensor):
    """Dirichlet-adjusted class posterior per item + dataset marginal; a
    ``(S, H, C, C)`` posterior one replica at a time (bitwise each
    replica's one-seed values)."""
    if dirichlets.dim() == 4:
        pi_xi, pi = zip(*(update_pi_hat(d, preds) for d in dirichlets))
        return torch.stack(pi_xi), torch.stack(pi)
    return _normalize_pi(pi_unnorm(dirichlets, preds))


def update_pi_hat_column(dirichlets: torch.Tensor, true_class: torch.Tensor,
                         preds: torch.Tensor, pi_xi_unnorm: torch.Tensor):
    """Recompute column ``true_class`` of the pi-hat factorisation from
    Dirichlet row ``true_class`` (``dirichlets`` already holds the label):
    one O(N·H·C) contraction. ``pi_xi_unnorm`` is updated IN PLACE.
    Returns ``(pi_hat_xi, pi_hat, pi_xi_unnorm)``."""
    return update_pi_hat_column_from_row(_take_row(dirichlets, true_class),
                                         true_class, preds, pi_xi_unnorm)


def update_pi_hat_column_from_row(d_t: torch.Tensor, true_class: torch.Tensor,
                                  preds: torch.Tensor,
                                  pi_xi_unnorm: torch.Tensor):
    """:func:`update_pi_hat_column` from the class row itself, ``d_t``
    (H, C) — what the sparse posterior feeds with its rebuilt row
    (``ops.sparse_rows.densify_row``). Seed-batched: ``(S, H, C)`` rows,
    ``(S,)`` classes, ``(S, N, C)`` factors, one contraction a replica."""
    if d_t.dim() == 3:
        col = torch.stack([torch.einsum("hs,hns->n", d, preds) for d in d_t])
    else:
        col = torch.einsum("hs,hns->n", d_t, preds)
    _put_col(pi_xi_unnorm, true_class, col)
    pi_xi, pi = _normalize_pi(pi_xi_unnorm)
    return pi_xi, pi, pi_xi_unnorm


def _put_col(unnorm: torch.Tensor, c: torch.Tensor, col: torch.Tensor,
             add: bool = False) -> None:
    """Set (or add to) column ``c`` of ``(N, C)`` factors IN PLACE; with a
    replica axis, column ``c[s]`` of replica s from ``col[s]``."""
    c = c.to(torch.int64)
    if c.dim() == 0:
        if add:
            unnorm.index_add_(1, c.reshape(1), col[:, None])
        else:
            unnorm.index_copy_(1, c.reshape(1), col[:, None])
        return
    rep = torch.arange(c.shape[0], device=unnorm.device)
    if add:
        unnorm[rep, :, c] += col
    else:
        unnorm[rep, :, c] = col


def update_pi_hat_column_delta(true_class: torch.Tensor,
                               pred_classes: torch.Tensor,
                               preds_by_class: torch.Tensor,
                               pi_xi_unnorm: torch.Tensor,
                               update_strength: float, gather_fn=None):
    """Exact linear increment of pi-hat column ``true_class``: the label
    adds ``lr·1[s == s_h]`` to Dirichlet row ``true_class`` of every model,
    so the column moves by ``lr · Σ_h preds[h, n, s_h]`` — one row per
    model of the ``(C, H, N)`` layout. ``pi_xi_unnorm`` is updated IN
    PLACE. Returns ``(pi_hat_xi, pi_hat, pi_xi_unnorm)``."""
    gather_fn = gather_fn or gather_rows_sum
    delta = update_strength * gather_fn(preds_by_class, pred_classes)
    _put_col(pi_xi_unnorm, true_class, delta, add=True)
    pi_xi, pi = _normalize_pi(pi_xi_unnorm)
    return pi_xi, pi, pi_xi_unnorm


# -- the tiers' scoring --------------------------------------------------------

def _beta_rows(dirichlets: torch.Tensor):
    """``(aT, bT)`` ``(..., C, H)``: every class row's diagonal Beta."""
    a_cc, b_cc = dirichlet_to_beta(dirichlets)       # (..., H, C)
    return a_cc.transpose(-1, -2), b_cc.transpose(-1, -2)


def _class_eq(pred_b: torch.Tensor, classes: torch.Tensor) -> torch.Tensor:
    """``(..., R, B, H)`` fp32: did model h predict class ``classes[r]`` at
    item b, from ``(..., B, H)`` hard predictions."""
    return (pred_b.unsqueeze(-3) == classes[:, None, None]).to(torch.float32)


def _class_entropy_drop(hyp, mixture0, pi_r, before_r, pi_xi_b, approx):
    """``Σ_r pi_xi[b, r] · H(mixture | label r)`` over the ``(..., R, B, H)``
    hypothetical rows of R classes: the mixture moves by row r's change
    only. Returns ``(..., B)``."""
    mix = mixture0[..., None, None, :] + pi_r[..., :, None, None] * (
        hyp - before_r[..., :, None, :])
    h_after = entropy2(mix, -1, approx=approx)                 # (..., R, B)
    return (pi_xi_b.transpose(-1, -2) * h_after).sum(-2)


def _per_replica(fn, dirichlets, pi_hat, pi_hat_xi, hard_preds, **kw):
    """A tier's scores for a leading replica axis, one replica at a time:
    neither cuBLAS nor PyTorch's reductions promise one summation order at
    every batch size, and each replica must stay bitwise its one-seed run
    (``scripts/torch_bmm_probe.py`` times both forms of the products)."""
    return torch.stack([
        fn(d, p, px, hard_preds if hard_preds.dim() == 2 else hard_preds[s],
           **kw)
        for s, (d, p, px) in enumerate(zip(dirichlets, pi_hat, pi_hat_xi))])


def eig_scores(dirichlets: torch.Tensor, pi_hat: torch.Tensor,
               pi_hat_xi: torch.Tensor, hard_preds: torch.Tensor,
               update_weight: float = 1.0, num_points: int = 256,
               chunk: int = 256) -> torch.Tensor:
    """The direct tier: expected information gain of labeling each point,
    ``compute_pbest`` of every class row under every item's +1 label, as
    the reference's choreography. Returns (N,). With a leading replica
    axis (``(S, H, C, C)``, ``(S, C)``, ``(S, N, C)``; ``hard_preds``
    ``(N, H)`` shared or ``(S, N, H)``) returns ``(S, N)``. Items run in
    blocks of at most ``chunk`` whose ``(B, C, H, G)`` temporaries stay
    within ``_DIRECT_TEMP_BYTES``."""
    if dirichlets.dim() == 4:
        return _per_replica(eig_scores, dirichlets, pi_hat, pi_hat_xi,
                            hard_preds, update_weight=update_weight,
                            num_points=num_points, chunk=chunk)
    H, C = dirichlets.shape[-3], dirichlets.shape[-1]
    lead = dirichlets.shape[:-3]
    aT, bT = _beta_rows(dirichlets)
    before = compute_pbest(aT, bT, num_points=num_points)      # (..., C, H)
    mixture0 = (pi_hat[..., :, None] * before).sum(-2)
    h_before = entropy2(mixture0)
    classes = torch.arange(C, dtype=hard_preds.dtype,
                           device=hard_preds.device)
    N = hard_preds.shape[-2]
    per_item = 8 * 4 * C * H * num_points * max(1, lead.numel())
    B = max(1, min(chunk, N, _DIRECT_TEMP_BYTES // per_item))
    out = []
    for start in range(0, N, B):
        eq = _class_eq(hard_preds[..., start:start + B, :], classes)
        eq = eq.transpose(-3, -2)                              # (..., B, C, H)
        a_hyp = aT.unsqueeze(-3) + update_weight * eq
        b_hyp = bT.unsqueeze(-3) + update_weight * (1.0 - eq)
        hyp = compute_pbest(a_hyp, b_hyp, num_points=num_points)
        mix = mixture0[..., None, None, :] + pi_hat[..., None, :, None] * (
            hyp - before.unsqueeze(-3))
        h_after = entropy2(mix, -1)                            # (..., B, C)
        out.append(h_before[..., None]
                   - (pi_hat_xi[..., start:start + B, :] * h_after).sum(-1))
    return torch.cat(out, -1)


def eig_scores_factored(dirichlets: torch.Tensor, pi_hat: torch.Tensor,
                        pi_hat_xi: torch.Tensor, hard_preds: torch.Tensor,
                        update_weight: float = 1.0, num_points: int = 256,
                        chunk: int = 256, precision: str = "highest",
                        approx: bool = False) -> torch.Tensor:
    """The factored tier: the same integral as :func:`eig_scores`, with
    the Beta grid tables of the two hypothetical variants of every class
    row built once (O(C·H·G) transcendentals, independent of N) and the
    per-item integral as three products over the model and grid axes a
    block of ``chunk`` items (``eig_precision`` sets their precision).
    Returns (N,), or ``(S, N)`` with a leading replica axis (see
    :func:`eig_scores`), one replica at a time (:func:`_per_replica`)."""
    if dirichlets.dim() == 4:
        return _per_replica(eig_scores_factored, dirichlets, pi_hat,
                            pi_hat_xi, hard_preds, update_weight=update_weight,
                            num_points=num_points, chunk=chunk,
                            precision=precision, approx=approx)
    C = dirichlets.shape[-1]
    aT, bT = _beta_rows(dirichlets)
    before = compute_pbest(aT, bT, num_points=num_points)      # (..., C, H)
    mixture0 = (pi_hat[..., :, None] * before).sum(-2)
    h_before = entropy2(mixture0, approx=approx)
    x = pbest_grid(num_points, aT.device)
    dx = x[1] - x[0]
    w_trapz = _trapz_weights(num_points, dx)
    tables = _bump_tables(aT, bT, x, dx, update_weight)
    classes = torch.arange(C, dtype=hard_preds.dtype,
                           device=hard_preds.device)
    N = hard_preds.shape[-2]
    B = max(1, min(chunk, N))
    out = []
    for start in range(0, N, B):
        eq = _class_eq(hard_preds[..., start:start + B, :], classes)
        hyp = _pbest_hyp_from_tables(tables, eq, w_trapz, precision)
        out.append(h_before[..., None] - _class_entropy_drop(
            hyp, mixture0, pi_hat, before,
            pi_hat_xi[..., start:start + B, :], approx))
    return torch.cat(out, -1)


def _rowscan_rows(lead: int, H: int, B: int, num_points: int) -> int:
    """Class rows a step of the row-scanned tier: as many as keep the
    step's tables (four (H, G) and two bump variants' grids) and block
    temporaries (a few (B, G) and (B, H)) within ``_ROWSCAN_TEMP_BYTES``."""
    G = num_points
    per_row = 4 * lead * (8 * H * G + B * (3 * G + 8 * H))
    return max(1, _ROWSCAN_TEMP_BYTES // per_row)


def _refresh_row_chunk(N: int, H: int, num_points: int) -> int:
    """Class rows one batched pass of the q-wide refresh takes: as many as
    keep a row's temporaries — six (N, H) and three (N, G) fp32 arrays,
    two table sets of four (H, G) — within ``_REFRESH_TEMP_BYTES``. At
    the headline (N, H) = (50000, 1000) that is one row, about 1.2 GB."""
    G = num_points
    per_row = 4 * (6 * N * H + 3 * N * G + 8 * H * G)
    return max(1, _REFRESH_TEMP_BYTES // per_row)


def eig_scores_rowscan(dirichlets: torch.Tensor, pi_hat: torch.Tensor,
                       pi_hat_xi: torch.Tensor, hard_preds: torch.Tensor,
                       update_weight: float = 1.0, num_points: int = 256,
                       chunk: int = 256, precision: str = "highest",
                       approx: bool = False) -> torch.Tensor:
    """The row-scanned tier: the factored integral visiting class rows in
    groups, each group's tables built, used over every block of ``chunk``
    items and dropped, its expected-entropy terms added into a running
    (N,) sum. The reference scans one row at a time (O(H·G) tables); here
    a group holds as many rows as keep a step's temporaries within
    ``_ROWSCAN_TEMP_BYTES``, which cuts the launches C-fold where memory
    allows (at the ImageNet-scale pool, C = 1000 rows a round). Products
    as the factored tier's. Returns (N,), or ``(S, N)`` one replica at a
    time (:func:`_per_replica`)."""
    if dirichlets.dim() == 4:
        return _per_replica(eig_scores_rowscan, dirichlets, pi_hat,
                            pi_hat_xi, hard_preds, update_weight=update_weight,
                            num_points=num_points, chunk=chunk,
                            precision=precision, approx=approx)
    H, C = dirichlets.shape[-3], dirichlets.shape[-1]
    lead = max(1, dirichlets.shape[:-3].numel())
    aT, bT = _beta_rows(dirichlets)
    N = hard_preds.shape[-2]
    B = max(1, min(chunk, N))
    R = _rowscan_rows(lead, H, B, num_points)
    before = compute_pbest_rows(aT, bT, num_points=num_points, row_chunk=R)
    mixture0 = (pi_hat[..., :, None] * before).sum(-2)
    h_before = entropy2(mixture0, approx=approx)
    x = pbest_grid(num_points, aT.device)
    dx = x[1] - x[0]
    w_trapz = _trapz_weights(num_points, dx)
    classes = torch.arange(C, dtype=hard_preds.dtype,
                           device=hard_preds.device)
    acc = torch.zeros(h_before.shape + (N,), dtype=torch.float32,
                      device=aT.device)
    for c0 in range(0, C, R):
        rows = slice(c0, c0 + R)
        tables = _bump_tables(aT[..., rows, :], bT[..., rows, :], x, dx,
                              update_weight)
        for start in range(0, N, B):
            items = slice(start, start + B)
            eq = _class_eq(hard_preds[..., items, :], classes[rows])
            hyp = _pbest_hyp_from_tables(tables, eq, w_trapz, precision)
            acc[..., items] += _class_entropy_drop(
                hyp, mixture0, pi_hat[..., rows], before[..., rows, :],
                pi_hat_xi[..., items, rows], approx)
    return h_before[..., None] - acc


# -- the P(best) cache ---------------------------------------------------------

def build_eig_cache(dirichlets: torch.Tensor, hard_preds: torch.Tensor,
                    update_weight: float = 1.0, num_points: int = 256,
                    chunk: int = 256, precision: str = "highest",
                    cache_dtype: torch.dtype = torch.float32
                    ) -> tuple[torch.Tensor, torch.Tensor]:
    """The full ``(pbest_rows (C, H), pbest_hyp (C, N, H))`` cache: the
    factored tier's tables and products over all N items and C class rows
    (at ``precision``), in ``chunk``-item blocks written straight into the
    ``(C, N, H)`` layout. The math is fp32; ``cache_dtype`` is the storage
    type of ``pbest_hyp`` (each block rounded to nearest even on the way
    in)."""
    H, C, _ = dirichlets.shape
    N = hard_preds.shape[0]
    aT, bT = _beta_rows(dirichlets)
    pbest_rows = compute_pbest(aT, bT, num_points=num_points)
    x = pbest_grid(num_points, dirichlets.device)
    dx = x[1] - x[0]
    w_trapz = _trapz_weights(num_points, dx)
    tables = _bump_tables(aT, bT, x, dx, update_weight)
    classes = torch.arange(C, dtype=hard_preds.dtype, device=hard_preds.device)
    hyp = torch.empty((C, N, H), dtype=cache_dtype, device=dirichlets.device)
    B = max(1, min(chunk, N))
    for start in range(0, N, B):
        eq = _class_eq(hard_preds[start:start + B], classes)   # (C, B, H)
        hyp[:, start:start + B] = _pbest_hyp_from_tables(tables, eq, w_trapz,
                                                         precision)
    return pbest_rows, hyp


def row_beta(dirichlets: torch.Tensor, true_class: torch.Tensor):
    """``(a_t, b_t)`` (H,): the diagonal-Beta parameters of class row
    ``true_class`` (a 0-d device tensor; no host synchronisation).
    Seed-batched: ``(S, H, C, C)`` posteriors and ``(S,)`` classes give
    ``(S, H)``, replica s's row ``true_class[s]``. The row is taken first
    and reduced alone — the same reduction as the sparse posterior's
    parity layout, so ``sparse:K>=C`` stays bitwise dense on the card."""
    row = _take_row(dirichlets, true_class)                    # (..., H, C)
    c = true_class.to(torch.int64).reshape(true_class.shape + (1, 1))
    a_t = row.gather(-1, c.expand(*row.shape[:-1], 1))[..., 0]
    return a_t, row.sum(-1) - a_t


def update_eig_cache_parts(dirichlets: Optional[torch.Tensor],
                           true_class: torch.Tensor, hard_preds: torch.Tensor,
                           update_weight: float = 1.0, num_points: int = 256,
                           precision: str = "highest", beta_t=None,
                           pbest: str = "quad", out=None):
    """The refreshed values of class row ``true_class`` without writing
    them: ``(row_t (H,), hyp_t (N, H))``. ``dirichlets`` already holds the
    new label; ``true_class`` is a 0-d device tensor. ``beta_t``: the
    row's ``(a_t, b_t)`` when the caller has them (the sparse posterior's
    O(H·K) reduction; ``dirichlets`` may then be None). ``pbest=
    'amortized'``: the row's hypothetical integral on the logistic-normal
    tables where its ``min(a_t + b_t) >= _AMORTIZED_MIN_CONC``, chosen on
    the device; ``row_t`` is always the quadrature's. Seed-batched:
    ``(S, ...)`` and ``(S,)`` give ``((S, H), (S, N, H))``. ``out``: the
    ``hyp_t`` tensor to write into."""
    a_t, b_t = beta_t if beta_t is not None else row_beta(dirichlets,
                                                          true_class)
    # (N, H) bool, or (S, N, H) with each replica's own class; compared in
    # hard_preds' int32 (an int64 class would widen the whole pass)
    c = true_class.to(hard_preds.dtype)
    eq_t = hard_preds == c.reshape(c.shape + (1, 1))
    if pbest == "amortized":
        hyp_t = _pbest_hyp_row_gated(a_t, b_t, eq_t, update_weight,
                                     num_points, _AMORTIZED_MIN_CONC,
                                     precision)
        if out is not None:
            hyp_t = out.copy_(hyp_t)
    else:
        hyp_t = _pbest_hyp_row(a_t, b_t, eq_t, update_weight, num_points,
                               precision, out)
    row_t = compute_pbest(a_t, b_t, num_points=num_points)
    return row_t, hyp_t


def _disagreement_mask(hard_preds: torch.Tensor, C: int) -> torch.Tensor:
    """Points where at least one model disagrees with the majority vote
    (the smallest modal class, as ``torch.mode`` in the reference)."""
    N, H = hard_preds.shape
    votes = torch.zeros((N, C), dtype=torch.int32, device=hard_preds.device)
    votes.scatter_add_(1, hard_preds.to(torch.int64),
                       torch.ones_like(hard_preds, dtype=torch.int32))
    maj = votes.argmax(-1)
    return (hard_preds != maj[:, None]).any(-1)


def _replicate(t, S: int):
    """S writable copies of a state field along a new leading axis."""
    if t is None:
        return None
    if isinstance(t, tuple):
        return type(t)(*(_replicate(x, S) for x in t))
    return t.unsqueeze(0).repeat(S, *[1] * t.dim())


# -- the selector --------------------------------------------------------------

def make_coda(preds: torch.Tensor, hp: Optional[CODAHyperparams] = None,
              name: str = "coda", device: DeviceLike = None,
              prior: Optional[sg.PriorStats] = None) -> Selector:
    """Build the CODA selector over a ``(H, N, C)`` prediction tensor.

    Runs on ``device`` (default: the card; ``device="cpu"`` runs the plain
    versions). The statics — hard predictions, disagreement mask, the
    confusion prior and (incremental tier, delta pi-hat) the ``(C, H, N)``
    gather layout — are built once here. ``init``/``select``/``update``/
    ``best`` keep everything on the device, and read nothing back to the
    host but one flag a round under ``prefilter_n`` (the reference's
    ``lax.cond`` between the prefiltered and the full pool). So does the
    seed-batched form, ``Selector.batched`` (None for the fused refresh and
    the surrogate scorer). The surrogate scorer reads at most two flags a
    round (its warmup counter, then its gate's verdict).
    ``extras["eig_mode"]`` names the resolved tier.

    ``prior``: a cross-session :class:`~coda_tpu_torch.selectors.surrogate.
    PriorStats` the surrogate's fit starts from (``surrogate_prior='pool'``
    only, as in the reference).
    """
    hp = hp or CODAHyperparams()
    dev = resolve_device(device)
    pin_fp32_matmul()
    preds = torch.as_tensor(preds, dtype=torch.float32).to(dev)
    H, N, C = preds.shape
    check_supported(hp, N)
    if prior is not None and not sg.parse_prior(hp.surrogate_prior):
        raise ValueError(
            "a prior was passed but surrogate_prior='off' — seeding "
            "under the off knob would break the off-config bitwise pin; "
            "set surrogate_prior='pool'")
    eig_mode = resolve_eig_mode(hp, H, N, C)
    check_tier(hp, eig_mode)
    scorer_k = sg.parse_scorer(hp.eig_scorer)
    precision = resolve_precision(hp.eig_precision)
    pi_update = resolve_pi_update(hp, N)
    sparse_k = parse_posterior(hp.posterior)
    incremental = eig_mode == "incremental"
    use_prefilter = bool(hp.q == "eig" and hp.prefilter_n
                         and hp.prefilter_n < N)
    prior_strength = 1.0 - hp.alpha
    update_strength = hp.learning_rate
    cache_dtype = getattr(torch, hp.eig_cache_dtype)
    approx = hp.eig_entropy == "approx"
    fused = hp.eig_refresh == "fused"
    plain = hp.eig_backend in PLAIN_BACKENDS
    score_fn = eig_scores_from_cache if plain else eig_scores_cache
    refresh_fn = eig_scores_refresh_plain if plain else eig_scores_refresh
    compute_fn = (eig_scores_refresh_compute_plain if plain
                  else eig_scores_refresh_compute)
    gather_fn = gather_rows_sum_plain if plain else gather_rows_sum
    score_s_fn = (eig_scores_from_cache_batched if plain
                  else eig_scores_cache_batched)
    refresh_s_fn = (eig_scores_refresh_batched_plain if plain
                    else eig_scores_refresh_batched)
    gather_s_fn = (gather_rows_sum_batched_plain if plain
                   else gather_rows_sum_batched)

    hard_preds = preds.argmax(-1).T.to(torch.int32).contiguous()   # (N, H)
    disagree = _disagreement_mask(hard_preds, C)                   # (N,)
    ens_hard = ensemble_preds(preds).argmax(-1)
    soft_conf = create_confusion_matrices(ens_hard, preds, mode="soft")
    # contiguous: the prior comes out of its contraction in a transposed
    # layout, and a reduction over another layout may sum in another order
    # (a replica of the seed-batched state is contiguous)
    dirichlets0 = (hp.multiplier * initialize_dirichlets(
        soft_conf, prior_strength, hp.disable_diag_prior)).contiguous()
    preds_by_class = (prep_gather_layout(preds)                    # (C, H, N)
                      if incremental and pi_update == "delta" else None)
    unc_scores = uncertainty_scores(preds) if hp.q == "uncertainty" else None

    if eig_mode == "direct":
        eig_fn, eig_kwargs = eig_scores, {}
    else:
        eig_fn = (eig_scores_rowscan if eig_mode == "rowscan"
                  else eig_scores_factored)
        eig_kwargs = {"precision": precision, "approx": approx}

    def _tier_scores(state: CODAState, pi_xi, hard, chunk):
        return eig_fn(state.dirichlets, state.pi_hat, pi_xi, hard,
                      num_points=hp.num_points, chunk=chunk, **eig_kwargs)

    def _initial_state() -> CODAState:
        """The deterministic initial state, before its score-ahead."""
        unnorm = pi_unnorm(dirichlets0, preds)
        pi_xi, pi = _normalize_pi(unnorm)
        rows = hyp = None
        if incremental:
            rows, hyp = build_eig_cache(dirichlets0, hard_preds,
                                        num_points=hp.num_points,
                                        chunk=hp.eig_chunk,
                                        precision=precision,
                                        cache_dtype=cache_dtype)
        sparse = (sparsify(dirichlets0, sparse_k) if sparse_k is not None
                  else None)
        fit = None
        if scorer_k is not None:
            # init is exact (round 0 of the warmup); the fit starts zeroed
            # with the prior posterior's class summaries, then takes the
            # pool's normal equations and warmup credit if given one
            aT, bT = _beta_rows(dirichlets0)
            fit = sg.init_fit(aT, bT)
            if prior is not None:
                fit = sg.seed_fit(fit, prior)
        return CODAState(
            dirichlets=None if sparse is not None else dirichlets0.clone(),
            pi_hat_xi=pi_xi,
            pi_hat=pi,
            unlabeled=torch.ones(N, dtype=torch.bool, device=dev),
            pbest_rows=rows,
            pbest_hyp=hyp,
            pi_xi_unnorm=unnorm if incremental else None,
            eig_scores_cached=None,
            sparse=sparse,
            surrogate=fit,
        )

    def init(key=None) -> CODAState:
        del key  # CODA's initialisation is deterministic
        st = _initial_state()
        if not incremental:
            return st
        # score-ahead: the next select reads these
        return st._replace(eig_scores_cached=score_fn(
            st.pbest_rows, st.pbest_hyp, st.pi_hat, st.pi_hat_xi,
            chunk=hp.eig_chunk, approx=approx))

    # -- select: one form for a state with or without a replica axis ------

    def _eig_select_full(state: CODAState, cand, k_tie) -> SelectResult:
        """Every point scored, the candidates masked at argmax time."""
        if incremental:
            scores = state.eig_scores_cached
        else:
            scores = _tier_scores(state, state.pi_hat_xi, hard_preds,
                                  hp.eig_chunk)
        idx, n_ties = masked_argmax_tiebreak(k_tie, scores, cand,
                                             rtol=_TIE_RTOL, atol=_TIE_ATOL)
        return SelectResult(idx=idx,
                            prob=scores.gather(-1, idx[..., None])[..., 0],
                            stochastic=n_ties > 1,
                            scores=torch.where(cand, scores, float("-inf")))

    def _eig_select_prefiltered(state: CODAState, cand, k_sub, k_tie
                         ) -> SelectResult:
        """EIG on ``prefilter_n`` candidates drawn uniformly (the top of
        masked uniforms, lower index first among equal values as
        ``lax.top_k``); with fewer candidates the masked slots are excluded
        again at argmax time."""
        K = hp.prefilter_n
        u = torch.where(cand, trandom.uniform(k_sub, (N,), device=dev), -1.0)
        cand_idx = torch.sort(u, dim=-1, descending=True,
                              stable=True).indices[..., :K]      # (..., K)
        valid = u.gather(-1, cand_idx) >= 0.0
        pi_xi_sub = state.pi_hat_xi.gather(
            -2, cand_idx[..., None].expand(*cand_idx.shape, C))
        scores_sub = _tier_scores(state, pi_xi_sub, hard_preds[cand_idx],
                                  min(hp.eig_chunk, K))
        local, n_ties = masked_argmax_tiebreak(
            k_tie, scores_sub, valid, rtol=_TIE_RTOL, atol=_TIE_ATOL)
        subsampled = cand.sum(-1) > K
        # the subset's scores back at full N for the flight recorder
        scores_full = torch.full(cand.shape, float("-inf"), device=dev)
        scores_full.scatter_(-1, cand_idx, torch.where(valid, scores_sub,
                                                       float("-inf")))
        return SelectResult(
            idx=cand_idx.gather(-1, local[..., None])[..., 0],
            prob=scores_sub.gather(-1, local[..., None])[..., 0],
            stochastic=(n_ties > 1) | subsampled,
            scores=scores_full)

    def _candidates(unlabeled):
        """``(candidate mask, may_subsample)``. Reference order: the
        disagreement filter first; an empty set falls back to every
        unlabeled point, which is never subsampled."""
        cand0 = disagree & unlabeled
        may_subsample = cand0.any(-1, keepdim=True)
        cand = torch.where(may_subsample, cand0, unlabeled)
        return cand, may_subsample[..., 0]

    def _select(state: CODAState, k_sub, k_tie) -> SelectResult:
        cand, may_subsample = _candidates(state.unlabeled)
        if hp.q == "eig" and not use_prefilter:
            return _eig_select_full(state, cand, k_tie)
        if use_prefilter:
            # the reference's lax.cond: one flag read back a round
            if bool(may_subsample.all()):
                return _eig_select_prefiltered(state, cand, k_sub, k_tie)
            full = _eig_select_full(state, cand, k_tie)
            if not bool(may_subsample.any()):
                return full
            # replicas differ (seed-batched): each takes its own branch
            sub = _eig_select_prefiltered(state, cand, k_sub, k_tie)
            return SelectResult(*(
                torch.where(may_subsample.reshape(
                    may_subsample.shape + (1,) * (a.dim() - 1)), a, b)
                for a, b in zip(sub, full)))
        # the ablation acquisitions subsample the mask before scoring, so
        # the iid probability is 1/|pool| of the subsampled pool
        subsampled = torch.zeros_like(may_subsample)
        if hp.prefilter_n and hp.prefilter_n < N:
            K = hp.prefilter_n
            u = torch.where(cand, trandom.uniform(k_sub, (N,), device=dev),
                            -1.0)
            kth = torch.sort(u, dim=-1).values[..., N - K]
            take = may_subsample & (cand.sum(-1) > K)
            cand = torch.where(take[..., None], cand & (u >= kth[..., None]),
                               cand)
            subsampled = take
        if hp.q == "iid":
            scores = torch.ones(cand.shape, device=dev) / torch.clamp_min(
                cand.sum(-1, keepdim=True), 1)
        else:
            scores = unc_scores.expand(cand.shape)
        idx, n_ties = masked_argmax_tiebreak(k_tie, scores, cand,
                                             rtol=_TIE_RTOL, atol=_TIE_ATOL)
        return SelectResult(idx=idx,
                            prob=scores.gather(-1, idx[..., None])[..., 0],
                            stochastic=(n_ties > 1) | subsampled,
                            scores=torch.where(cand, scores, float("-inf")))

    def select(state: CODAState, key: torch.Tensor) -> SelectResult:
        k_sub, k_tie = trandom.split(key)
        return _select(state, k_sub, k_tie)

    def _greedy_overlap_topq(pi_xi, pi, unlabeled, rows, hyp, scores, cand,
                             k_tie, q: int) -> SelectResult:
        """Greedy top-q EIG with the reference's information-overlap
        penalty, a re-rank of one scoring pass (one replica). Each of the
        top ``M = max(32, 8q)`` candidates carries unit feature vectors —
        its pi-hat row and, on the incremental tier, its expected
        |dP(best)| profile over models at its ``min(8, C)`` likeliest
        labels read from the cache — and after each pick every remaining
        score is scaled by ``1 - (max cosine overlap with the picks)``.
        ``lax.top_k`` is a stable descending sort; the features are
        normalised by device-tensor divisions."""
        M = min(N, max(32, 8 * q))
        inf = float("-inf")
        # candidates by score; unlabeled non-candidates at a finite floor,
        # so a candidate set smaller than q falls back to unlabeled points
        pool_scores = torch.where(cand, scores,
                                  torch.where(unlabeled, -1e30, inf))
        top_scores, pool = sg._top(pool_scores, M)
        valid = top_scores > -1e29
        pi_xi_p = pi_xi.index_select(0, pool)                       # (M, C)
        U = pi_xi_p / torch.clamp_min(
            torch.linalg.vector_norm(pi_xi_p, dim=1, keepdim=True), 1e-12)
        feats = [U]
        if incremental:
            kc = min(8, C)
            wv, ci = sg._top(pi_xi_p * pi[None, :], kc)             # (M, kc)
            hyp_sel = hyp[ci, pool[:, None]].to(torch.float32)      # (M,kc,H)
            E = (wv[:, :, None] * torch.abs(hyp_sel - rows[ci])).sum(1)
            feats.append(E / torch.clamp_min(
                torch.linalg.vector_norm(E, dim=1, keepdim=True), 1e-12))
        # a device-tensor divisor: one IEEE division on every device
        Fm = _even_share(torch.cat(feats, 1), math.sqrt(len(feats)))
        keys = trandom.split(k_tie, q)
        pen = torch.zeros(M, dtype=torch.float32, device=dev)
        taken = torch.zeros(M, dtype=torch.bool, device=dev)
        fb_base = unlabeled.index_select(0, pool)
        locs, ties = [], []
        for t in range(q):
            eff = top_scores * (1.0 - pen)
            avail = valid & ~taken
            use = torch.where(avail.any(), avail, fb_base & ~taken)
            loc, n_ties = masked_argmax_tiebreak(
                keys[t], torch.where(avail, eff, inf), use,
                rtol=_TIE_RTOL, atol=_TIE_ATOL)
            overlap = torch.clamp(Fm @ Fm[loc], 0.0, 1.0)
            pen = torch.maximum(pen, overlap)
            taken.index_fill_(0, loc.reshape(1), True)
            locs.append(loc)
            ties.append(n_ties > 1)
        locs = torch.stack(locs)
        return SelectResult(
            idx=pool.index_select(0, locs),
            prob=torch.where(valid.index_select(0, locs),
                             top_scores.index_select(0, locs), inf),
            stochastic=torch.stack(ties).any(),
            scores=torch.where(cand, scores, inf))

    def _round_scores(state: CODAState):
        """The round's full-pool scores: the incremental tier's cached
        score-ahead, else the tier's scoring pass."""
        if incremental:
            return state.eig_scores_cached
        return _tier_scores(state, state.pi_hat_xi, hard_preds, hp.eig_chunk)

    def select_q(state: CODAState, key, q: int) -> SelectResult:
        """q picks of the full-pool EIG from the round's one scoring pass
        (the score-ahead on the incremental tier), re-ranked greedily with
        the overlap penalty; the key is split as ``select``'s (the
        subsample half unused), the tie-break half split q ways."""
        _, k_tie = trandom.split(key)
        cand, _ = _candidates(state.unlabeled)
        return _greedy_overlap_topq(
            state.pi_hat_xi, state.pi_hat, state.unlabeled,
            state.pbest_rows, state.pbest_hyp, _round_scores(state), cand,
            k_tie, q)

    # -- update: one form for a state with or without a replica axis ------

    def _pred_rows(idx):
        """Each model's hard prediction at ``idx``: (..., H)."""
        return hard_preds.index_select(0, idx.reshape(-1).to(torch.int64)) \
            .reshape(idx.shape + (H,))

    def _eff(w):
        """The posterior increment: the learning rate, scaled by ``w``."""
        return update_strength if w is None else update_strength * w

    def _post_add(state: CODAState, true_class, pred_at, w=None):
        """One label (per replica) into the posterior IN PLACE; returns the
        sparse row's ``(a_t, b_t)``, else None."""
        if state.sparse is not None:
            # one-row sparse scatter; the labelled row's Betas from its
            # O(H·K) compact form, not a dense (H, C, C) pass
            scatter_row(state.sparse, true_class, pred_at, update_strength,
                        weight=w)
            return sparse_row_beta(state.sparse, true_class)
        onehot = F.one_hot(pred_at.to(torch.int64), C).to(torch.float32)
        # a replica's weight scales its (H, C) increment
        inc = (_eff(w) if w is None or w.dim() == 0
               else _eff(w)[:, None, None]) * onehot
        c = true_class.to(torch.int64)
        if c.dim() == 0:
            state.dirichlets.index_add_(1, c.reshape(1), inc[:, None])
        else:
            rep = torch.arange(c.shape[0], device=dev)
            state.dirichlets[rep, :, c] += inc
        return None

    def _row_beta(state: CODAState, true_class):
        """``(a_t, b_t)`` of class row ``true_class`` of the posterior."""
        if state.sparse is not None:
            return sparse_row_beta(state.sparse, true_class)
        return row_beta(state.dirichlets, true_class)

    def _mark_labeled(unlabeled, idx):
        """``idx`` (one point, the round's (q,), or one a replica) leaves
        the unlabeled set, IN PLACE."""
        idx = idx.to(torch.int64)
        if unlabeled.dim() == 1:
            unlabeled.index_fill_(0, idx.reshape(-1), False)
        else:
            unlabeled[torch.arange(idx.shape[0], device=dev), idx] = False

    def _delta_col(state: CODAState, true_class, pred_at, w=None):
        """Add the label's exact pi-hat increment to column ``true_class``
        IN PLACE (kernel 3, or its batched form, on the card)."""
        gathered = (gather_fn(preds_by_class, pred_at)
                    if true_class.dim() == 0
                    else gather_s_fn(preds_by_class, pred_at))
        eff = (_eff(w) if w is None or w.dim() == 0
               else _eff(w)[:, None])
        _put_col(state.pi_xi_unnorm, true_class, eff * gathered, add=True)

    def _exact_col(state: CODAState, true_class):
        """Recompute pi-hat column ``true_class`` from the posterior row IN
        PLACE."""
        d_t = (densify_row(state.sparse, true_class)
               if state.sparse is not None
               else _take_row(state.dirichlets, true_class))
        if d_t.dim() == 3:
            col = torch.stack([torch.einsum("hs,hns->n", d, preds)
                               for d in d_t])
        else:
            col = torch.einsum("hs,hns->n", d_t, preds)
        _put_col(state.pi_xi_unnorm, true_class, col)

    def _surrogate_scores(state: CODAState, pi, pi_xi, true_classes, a_t,
                          b_t):
        """The contract-gated scoring pass (one replica) on the refreshed
        cache: ``(scores, fit)``. ``true_classes`` (q,) and their (q, H)
        Betas are the round's labelled rows; ``state.eig_scores_cached`` is
        the previous round's vector and ``state.unlabeled`` already the
        next select's."""
        fit = sg.refresh_class_feats(state.surrogate, true_classes, a_t, b_t)
        rows, hyp = state.pbest_rows, state.pbest_hyp
        feats = sg.build_features(state.eig_scores_cached, pi_xi, pi,
                                  fit.cls_feats, rows, hyp, hard_preds,
                                  true_classes)
        cand, _ = _candidates(state.unlabeled)
        return sg.surrogate_score_round(
            fit, feats, cand, scorer_k,
            lambda sel: eig_scores_rows(rows, hyp, pi, pi_xi, sel,
                                        approx=approx),
            lambda: score_fn(rows, hyp, pi, pi_xi, chunk=hp.eig_chunk,
                             approx=approx))

    def _write_row(state: CODAState, c, row_t, hyp_t) -> None:
        """Class row ``c`` (per replica) of the P(best) cache IN PLACE,
        ``hyp_t`` rounded to the cache's storage type."""
        if c.dim() == 0:
            state.pbest_rows.index_copy_(0, c.reshape(1), row_t[None])
            state.pbest_hyp.index_copy_(
                0, c.reshape(1), hyp_t.to(state.pbest_hyp.dtype)[None])
        else:
            rep = torch.arange(c.shape[0], device=dev)
            state.pbest_rows[rep, c] = row_t
            state.pbest_hyp[rep, c] = hyp_t.to(state.pbest_hyp.dtype)

    def _refresh_parts(state: CODAState, true_class, beta_t):
        """:func:`update_eig_cache_parts` of the labelled class row; a seed
        batch's one replica at a time: the batched row refresh (its Beta
        tables' scans and sums, its products) is not batch-size invariant
        on the card at every shape, and replica s must be bitwise its
        one-seed run."""
        kw = dict(num_points=hp.num_points, precision=precision,
                  pbest=hp.eig_pbest)
        if true_class.dim() == 0:
            return update_eig_cache_parts(state.dirichlets, true_class,
                                          hard_preds, beta_t=beta_t, **kw)
        S = true_class.shape[0]
        # each replica's rows written in place: no (S, N, H) stacking copy
        hyp_t = torch.empty((S, N, H), dtype=torch.float32, device=dev)
        rows = [update_eig_cache_parts(
            None if state.dirichlets is None else state.dirichlets[s],
            true_class[s], hard_preds,
            beta_t=None if beta_t is None else (beta_t[0][s], beta_t[1][s]),
            out=hyp_t[s], **kw)[0] for s in range(S)]
        return torch.stack(rows), hyp_t

    def _update(state: CODAState, idx, true_class, w=None) -> CODAState:
        """One label per replica, applied IN PLACE to ``state``'s tensors;
        returns the state with the new pi-hat (and, on the incremental
        tier, scores). ``w``: the increment's weight (``update_w``)."""
        pred_at = _pred_rows(idx)
        beta_t = _post_add(state, true_class, pred_at, w)
        batched = true_class.dim() > 0
        _mark_labeled(state.unlabeled, idx)
        if not incremental:
            pi_xi, pi = update_pi_hat(state.dirichlets, preds)
            return state._replace(pi_hat_xi=pi_xi, pi_hat=pi)
        if pi_update == "delta":
            _delta_col(state, true_class, pred_at, w)
        else:
            _exact_col(state, true_class)
        pi_xi, pi = _normalize_pi(state.pi_xi_unnorm)
        c = true_class.to(torch.int64)
        fit = state.surrogate
        if fused:
            # the class row is computed inside the scoring pass (kernel 6)
            # from the labelled class's Beta tables
            a_t, b_t = (beta_t if beta_t is not None
                        else row_beta(state.dirichlets, true_class))
            row_t = compute_pbest(a_t, b_t, num_points=hp.num_points)
            state.pbest_rows.index_copy_(0, c.reshape(1), row_t[None])
            scores, hyp = compute_fn(
                state.pbest_rows, state.pbest_hyp, a_t, b_t, hard_preds,
                true_class, pi, pi_xi, num_points=hp.num_points,
                approx=approx, chunk=hp.eig_chunk)
        elif scorer_k is not None:
            # the surrogate needs the labelled row's Betas too: taken once
            # and handed to the row refresh, which is written without
            # kernel 2 (the round's scores are the surrogate's)
            beta_t = beta_t if beta_t is not None else _row_beta(
                state, true_class)
            row_t, hyp_t = update_eig_cache_parts(
                state.dirichlets, true_class, hard_preds,
                num_points=hp.num_points, precision=precision,
                beta_t=beta_t, pbest=hp.eig_pbest)
            _write_row(state, c, row_t, hyp_t)
            hyp = state.pbest_hyp
            scores, fit = _surrogate_scores(state, pi, pi_xi, c.reshape(1),
                                            beta_t[0][None], beta_t[1][None])
        else:
            row_t, hyp_t = _refresh_parts(state, true_class, beta_t)
            if batched:
                rep = torch.arange(c.shape[0], device=dev)
                state.pbest_rows[rep, c] = row_t
                scores, hyp = refresh_s_fn(
                    state.pbest_rows, state.pbest_hyp, hyp_t, c, pi, pi_xi,
                    chunk=hp.eig_chunk, approx=approx)
            else:
                state.pbest_rows.index_copy_(0, c.reshape(1), row_t[None])
                scores, hyp = refresh_fn(
                    state.pbest_rows, state.pbest_hyp, hyp_t, true_class,
                    pi, pi_xi, chunk=hp.eig_chunk, approx=approx)
        return state._replace(pi_hat_xi=pi_xi, pi_hat=pi, pbest_hyp=hyp,
                              eig_scores_cached=scores, surrogate=fit)

    def update(state: CODAState, idx, true_class, prob=None) -> CODAState:
        """One label, applied IN PLACE to ``state``'s tensors; returns the
        state with the new pi-hat (and scores)."""
        del prob
        return _update(state, idx, true_class)

    def update_w(state: CODAState, idx, true_class, prob, w) -> CODAState:
        """``update`` with the posterior increment scaled by ``w`` (a
        tensor): w = 1 is ``update`` bitwise, w = 0 leaves the posterior
        as it was (the point is still labelled)."""
        del prob
        return _update(state, idx, true_class, w=w)

    def _refresh_rows(state: CODAState, classes):
        """The class rows ``classes`` (q,) refreshed from the posterior, as
        many at a time in one batched pass (the reference's ``vmap`` over
        the rows) as keep the pass's temporaries within
        ``_REFRESH_TEMP_BYTES`` (:func:`_refresh_row_chunk`), and written
        in order, a repeated class twice with equal values. Returns their
        ``(q, H)`` Beta parameters."""
        betas = [_row_beta(state, c) for c in classes]
        a_t = torch.stack([a for a, _ in betas])
        b_t = torch.stack([b for _, b in betas])
        step = _refresh_row_chunk(N, H, hp.num_points)
        for j0 in range(0, classes.shape[0], step):
            cs = classes[j0:j0 + step]
            rows_t, hyps_t = update_eig_cache_parts(
                state.dirichlets, cs, hard_preds, num_points=hp.num_points,
                precision=precision,
                beta_t=(a_t[j0:j0 + step], b_t[j0:j0 + step]),
                pbest=hp.eig_pbest)
            for j in range(cs.shape[0]):
                _write_row(state, cs[j], rows_t[j], hyps_t[j])
        return a_t, b_t

    def _update_q(state: CODAState, idxs, true_classes, ws=None
                  ) -> CODAState:
        """All q answers of a round (``(q,)``) as one update, IN PLACE: the
        posterior rows in order, pi-hat column by column (kernel 3 once an
        answer on the delta path; the exact column from the final
        posterior otherwise), the q class rows of the cache refreshed from
        the final posterior and written in order (a repeated class writes
        equal values twice), then one scoring pass — kernel 1, or the
        surrogate's. ``ws``: per-answer weights (``update_qw``)."""
        q = true_classes.shape[-1]
        tcs = true_classes.to(torch.int64)
        pred_q = _pred_rows(idxs)                               # (q, H)
        for j in range(q):
            _post_add(state, tcs[j], pred_q[j],
                      None if ws is None else ws[j])
        _mark_labeled(state.unlabeled, idxs)
        if not incremental:
            pi_xi, pi = update_pi_hat(state.dirichlets, preds)
            return state._replace(pi_hat_xi=pi_xi, pi_hat=pi)
        for j in range(q):
            if pi_update == "delta":
                _delta_col(state, tcs[j], pred_q[j],
                           None if ws is None else ws[j])
            else:
                _exact_col(state, tcs[j])
        pi_xi, pi = _normalize_pi(state.pi_xi_unnorm)
        a_t, b_t = _refresh_rows(state, tcs)
        fit = state.surrogate
        if scorer_k is not None:
            scores, fit = _surrogate_scores(state, pi, pi_xi, tcs, a_t, b_t)
        else:
            scores = score_fn(state.pbest_rows, state.pbest_hyp, pi, pi_xi,
                              chunk=hp.eig_chunk, approx=approx)
        return state._replace(pi_hat_xi=pi_xi, pi_hat=pi,
                              eig_scores_cached=scores, surrogate=fit)

    def update_q(state: CODAState, idxs, true_classes, probs=None
                 ) -> CODAState:
        """The q answers of a round as one update (:func:`_update_q`)."""
        del probs
        return _update_q(state, idxs, true_classes)

    def update_qw(state: CODAState, idxs, true_classes, probs, ws
                  ) -> CODAState:
        """The weighted q-wide update: answer j's increment scaled by
        ``ws[j]`` (w = 1 everywhere is ``update_q`` bitwise)."""
        del probs
        return _update_q(state, idxs, true_classes, ws=ws)

    def _pbest_recomputed(dirichlets, pi_hat):
        """P(best) of one replica's posterior, off the incremental tier."""
        if eig_mode != "rowscan":
            return pbest_row_mixture(dirichlets, pi_hat,
                                     num_points=hp.num_points)
        # large C: the (C, H, G) temporary in row groups
        aT, bT = _beta_rows(dirichlets)
        rows = compute_pbest_rows(
            aT, bT, num_points=hp.num_points,
            row_chunk=_rowscan_rows(1, H, 1, hp.num_points))
        return (pi_hat[:, None] * rows).sum(0)

    def get_pbest(state: CODAState) -> torch.Tensor:
        """P(best) under the current posterior: ``(H,)``, or ``(S, H)``
        for a batched state."""
        if incremental:
            # the cached per-row P(best) is compute_pbest of the current
            # posterior; only the pi-hat mixture is recomputed (one
            # replica at a time, bitwise its one-seed readout)
            if state.pbest_rows.dim() == 3:
                return torch.stack([(p[:, None] * r).sum(0) for p, r in
                                    zip(state.pi_hat, state.pbest_rows)])
            return (state.pi_hat[:, None] * state.pbest_rows).sum(0)
        if state.dirichlets.dim() == 4:
            # one replica at a time, bitwise its one-seed readout
            return torch.stack([_pbest_recomputed(d, p) for d, p in
                                zip(state.dirichlets, state.pi_hat)])
        return _pbest_recomputed(state.dirichlets, state.pi_hat)

    def best(state: CODAState, key=None):
        del key  # plain argmax, as the reference
        return (get_pbest(state).argmax(),
                torch.zeros((), dtype=torch.bool, device=dev))

    # -- the seed-batched form: S replicas, one round for all ---------------

    def init_batched(S: int) -> CODAState:
        """S writable replicas of the deterministic initial state (the
        cache is built once and copied: ``update`` writes each replica in
        place), then, on the incremental tier, one launch of kernel 4 for
        every replica's score-ahead."""
        st = CODAState(*(_replicate(t, S) for t in _initial_state()))
        if not incremental:
            return st
        return st._replace(eig_scores_cached=score_s_fn(
            st.pbest_rows, st.pbest_hyp, st.pi_hat, st.pi_hat_xi,
            chunk=hp.eig_chunk, approx=approx))

    def select_keys(keys: torch.Tensor) -> torch.Tensor:
        # select's own split of its key (``select`` above), on the host:
        # (..., 2, 2), the subsample key then the tie-break key
        return trandom.split(keys)

    def select_batched(state: CODAState, keys: torch.Tensor) -> SelectResult:
        """One pick per replica; ``keys`` (S, 2, 2) on the state's device,
        rows of :func:`select_keys`."""
        return _select(state, keys[:, 0], keys[:, 1])

    def update_batched(state: CODAState, idx, true_class, prob=None
                       ) -> CODAState:
        """One label per replica, ``idx`` and ``true_class`` (S,), applied
        IN PLACE: on the incremental tier each replica's posterior row,
        pi-hat column (batched kernel 3, or the exact column), P(best) row,
        and cache row with the scores (kernel 5, one launch for all
        replicas); elsewhere the posterior rows and the full pi-hat."""
        del prob
        return _update(state, idx, true_class.to(torch.int64))

    def update_w_batched(state: CODAState, idx, true_class, prob, w
                         ) -> CODAState:
        """``update_batched`` with replica s's increment scaled by
        ``w[s]`` (``(S,)``): bitwise ``update_w`` on each replica."""
        del prob
        return _update(state, idx, true_class.to(torch.int64), w=w)

    def best_batched(state: CODAState):
        pbest = get_pbest(state)                                   # (S, H)
        return (pbest.argmax(-1),
                torch.zeros(pbest.shape[0], dtype=torch.bool, device=dev))

    batched = BatchedSelector(
        init=init_batched, select_keys=select_keys, select=select_batched,
        update=update_batched, best=best_batched,
        update_w=update_w_batched) \
        if batches_seeds(hp) else None
    # the q-wide pair: the overlap re-rank on the full-pool EIG (the
    # prefilter and the ablations take batch.py's generic top-q); the
    # fused refresh has no multi-row form, so its q answers go through
    # ``update`` one after another (batch.py's fallback). Neither has a
    # seed-batched form: under --acq-batch the seeds run one after another
    full_pool = hp.q == "eig" and not use_prefilter

    extras = {"get_pbest": get_pbest, "eig_scores": eig_scores,
              "eig_mode": eig_mode, "hard_preds": hard_preds,
              "preds_by_class": preds_by_class}
    if incremental:
        # the exact scoring pass on a carried state (the surrogate's
        # yardstick)
        extras["score_exact"] = lambda st: score_fn(
            st.pbest_rows, st.pbest_hyp, st.pi_hat, st.pi_hat_xi,
            chunk=hp.eig_chunk, approx=approx)
    if scorer_k is not None:
        # the round's fallback flag, for the recorder's trace
        extras["scorer_round_stats"] = lambda st: st.surrogate.last_fallback

        def score_surrogate(st: CODAState, tcs):
            """A surviving round's surrogate pass on a carried state
            (features, predictions, the shortlist's exact re-score, the
            gate, the hybrid vector and refold): ``(scores, fit)``."""
            fit = st.surrogate
            feats = sg.build_features(
                st.eig_scores_cached, st.pi_hat_xi, st.pi_hat,
                fit.cls_feats, st.pbest_rows, st.pbest_hyp, hard_preds, tcs)
            cand, _ = _candidates(st.unlabeled)
            scores, fit, _ = sg.hybrid_score_pass(
                fit, feats, cand, scorer_k,
                lambda sel: eig_scores_rows(
                    st.pbest_rows, st.pbest_hyp, st.pi_hat, st.pi_hat_xi,
                    sel, approx=approx))
            return scores, fit

        extras["score_surrogate"] = score_surrogate

    return Selector(
        name=name, init=init, select=select, update=update, best=best,
        select_q=select_q if full_pool else None,
        update_q=None if fused else update_q,
        update_w=update_w,
        update_qw=None if fused else update_qw,
        always_stochastic=False,
        hyperparams=dict(hp._asdict()),
        hyperparam_defaults=dict(CODAHyperparams()._asdict()),
        extras=extras,
        batched=batched,
    )
