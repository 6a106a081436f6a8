"""CODA: consensus-driven active model selection on the card — the main
path of the reference selector (counterpart of
``coda_tpu/selectors/coda.py``).

This port covers the configuration the paper's run resolves to — the
dense Dirichlet posterior, the INCREMENTAL EIG tier carrying the
``(C, N, H)`` hypothetical-P(best) cache, the exact scorer, the delta
pi-hat update and full-pool EIG acquisition — and the reference's
headline-speed knobs on that tier: ``eig_cache_dtype`` (fp32 or bf16
storage of the cache), ``eig_entropy`` (exact or polynomial log2) and
``eig_refresh`` (``precomputed`` or ``fused``). One round:

  * select: tie-broken masked argmax over the scores computed at the end
    of the previous init/update (score-ahead);
  * update: add to Dirichlet row ``true_class``; move pi-hat column
    ``true_class`` by the row-gather kernel (``ops/gather_kernels``);
    then either (``precomputed``) recompute the class row of the cache
    with three fp32 contractions and write it into the cache while
    re-scoring all N in one kernel pass (kernel 2), or (``fused``) hand
    the class row's Beta parameters to kernel 6, which computes the row
    inside the scoring pass (``ops/eig_kernels``);
  * best: argmax of the pi-hat-weighted cached P(best) rows.

The selector also has a seed-batched form (``Selector.batched``) for the
precomputed refresh: the same state with a leading replica axis S, one
round for all S seeds through kernels 4 and 5 and the batched kernel 3 —
what the reference's ``vmap`` over seeds reaches with
``eig_backend='pallas'``. The fused refresh has none: the reference
refuses it under ``vmap`` (``n_parallel > 1``), so its seeds run one after
another.

State is updated IN PLACE: ``update`` writes the Dirichlet row, the pi-hat
column, the P(best) row, the cache row and the unlabeled mask into the
tensors of the state it is given (the reference returned new arrays). The
contractions and the pi-hat einsum are plain fp32 ``torch.matmul``/
``einsum`` with TF32 off, as the reference left them to XLA at HIGHEST
precision. Every knob value outside these paths raises
``NotImplementedError`` naming the later slice that brings it.
"""

from __future__ import annotations

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
from coda_tpu_torch.ops.masked import masked_argmax_tiebreak
from coda_tpu_torch.ops.pbest import (
    _EPS,
    _bump_tables,
    _pbest_hyp_row,
    _trapz_weights,
    compute_pbest,
    pbest_grid,
)
from coda_tpu_torch.selectors.protocol import (
    BatchedSelector,
    Selector,
    SelectResult,
)
from coda_tpu_torch.utils.platform import (
    DeviceLike,
    pin_fp32_matmul,
    resolve_device,
)

# reference coda/coda.py:307: isclose(rtol=1e-8) with torch's default
# atol=1e-8; atol dominates for tiny EIG entropy deltas
_TIE_RTOL = 1e-8
_TIE_ATOL = 1e-8

# the reference's "auto" budget for the incremental tier (cache + the
# (C, H, N) delta layout + the dense posterior, per replica); kept so
# "auto" resolves the same tier in both packages
_INCR_CACHE_MAX_BYTES = 4 << 30

_SLICE_REST = "the rest of CODA (slice 2 of the port)"

# eig_backend values that run the plain PyTorch versions: the reference's
# name for its non-kernel path, and the port's own
PLAIN_BACKENDS = ("jnp", "plain")


class CODAHyperparams(NamedTuple):
    """The reference's fields and defaults. See :func:`check_supported`
    for the values that raise."""

    prefilter_n: int = 0
    alpha: float = 0.9            # prior_strength = 1 - alpha
    learning_rate: float = 0.01   # update_strength
    multiplier: float = 2.0
    disable_diag_prior: bool = False
    q: str = "eig"                # acquisition: eig | iid | uncertainty
    eig_chunk: int = 256          # N-block of the plain scoring and the
    #                               cache build (a memory valve)
    num_points: int = 256         # P(best) integration grid
    eig_mode: str = "auto"        # auto | incremental (factored, rowscan,
    #                               direct: a later slice)
    eig_backend: str = "auto"     # auto = the CUDA kernels on a card, the
    #                               plain versions on the CPU; jnp (the
    #                               reference's name; alias plain) = the
    #                               plain versions everywhere (the yardstick
    #                               the kernels are held to on the card)
    n_parallel: int = 1           # replicas sharing the card: the seeds
    #                               the engine batches (auto budget)
    eig_precision: str = "highest"
    eig_cache_dtype: str = "float32"  # float32 | bfloat16: storage of the
    #                               (C, N, H) cache; all math stays fp32
    eig_refresh: str = "precomputed"  # precomputed | fused: the class row
    #                               is computed by three fp32 products
    #                               before the scoring pass, or inside it
    #                               (kernel 6; opt-in numerics, as in the
    #                               reference)
    eig_entropy: str = "exact"    # exact | approx: the scoring chain's log2
    shard_spec: str = ""
    posterior: str = "dense"
    eig_pbest: str = "quad"
    eig_scorer: str = "exact"
    surrogate_prior: str = "off"
    pi_update: str = "auto"       # auto | delta (exact: a later slice)


def _unsupported(knob: str, value, where: str = _SLICE_REST):
    raise NotImplementedError(
        f"{knob}={value!r} comes with {where}; coda_tpu_torch runs the "
        "incremental tier with the exact scorer, delta pi-hat and the dense "
        "posterior (fp32 or bf16 cache, exact or approx entropy, "
        "precomputed or fused refresh)")


def resolve_eig_mode(hp: CODAHyperparams, H: int, N: int, C: int) -> str:
    """The EIG tier, restricted to the incremental one: ``auto`` resolves
    as the reference does (incremental while its per-replica bytes fit the
    reference's budget) and raises where the reference would pick a tier
    this slice lacks."""
    full_pool_eig = (hp.q == "eig"
                     and not (hp.prefilter_n and hp.prefilter_n < N))
    if hp.eig_mode == "incremental":
        if not full_pool_eig:
            raise ValueError(
                "eig_mode='incremental' requires the full-pool EIG "
                f"acquisition (q='eig' without an active prefilter); got "
                f"q={hp.q!r}, prefilter_n={hp.prefilter_n}")
        return "incremental"
    if hp.eig_mode in ("factored", "rowscan", "direct"):
        _unsupported("eig_mode", hp.eig_mode)
    if hp.eig_mode != "auto":
        raise ValueError(f"unknown eig_mode {hp.eig_mode!r}")
    # the cache at its storage dtype + the fp32 (C, H, N) delta layout +
    # the dense posterior
    itemsize = 2 if hp.eig_cache_dtype == "bfloat16" else 4
    resident = itemsize * N * C * H + 4 * N * C * H + 4 * H * C * C
    if full_pool_eig and max(1, hp.n_parallel) * resident \
            <= _INCR_CACHE_MAX_BYTES:
        return "incremental"
    _unsupported("eig_mode", "auto",
                 f"{_SLICE_REST}: this shape resolves past the incremental "
                 f"tier's budget at n_parallel={max(1, hp.n_parallel)}; "
                 "eig_mode='incremental' (the CLI's --eig-mode incremental) "
                 "runs it")


def batches_seeds(hp: CODAHyperparams) -> bool:
    """Whether the selector has a seed-batched form: the precomputed
    refresh has (kernels 4 and 5), the fused one has none."""
    return hp.eig_refresh != "fused"


def check_supported(hp: CODAHyperparams, N: int) -> None:
    """Raise on every knob value outside the port's paths: ``ValueError``
    with the reference's text where the reference refuses the value too,
    ``NotImplementedError`` where a later slice brings it."""
    if hp.q != "eig":
        _unsupported("q", hp.q)
    if hp.prefilter_n and hp.prefilter_n < N:
        _unsupported("prefilter_n", hp.prefilter_n)
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
    fused = hp.eig_refresh == "fused"
    if fused and (hp.shard_spec or hp.n_parallel > 1):
        raise ValueError(
            "eig_refresh='fused' computes the replacement row inside the "
            "single-chip pallas scoring kernel; it requires the pallas "
            "backend and supports neither shard_spec nor vmapped batches "
            f"(got backend={hp.eig_backend!r}, shard_spec={hp.shard_spec!r}, "
            f"n_parallel={hp.n_parallel})")
    if hp.eig_pbest == "amortized" and fused:
        raise ValueError(
            "eig_pbest='amortized' runs the row refresh through the jnp "
            "logistic-normal tables; the pallas kernels compute their own "
            f"Beta tables (got backend={hp.eig_backend!r}, "
            f"eig_refresh={hp.eig_refresh!r}) — it would silently not "
            "apply")
    for knob, default, where in (
            ("eig_precision", "highest", _SLICE_REST),
            ("posterior", "dense", _SLICE_REST),
            ("eig_pbest", "quad", _SLICE_REST),
            ("eig_scorer", "exact", "batched acquisition and the surrogate "
             "(slice 4 of the port)"),
            ("surrogate_prior", "off", "batched acquisition and the "
             "surrogate (slice 4 of the port)"),
            ("shard_spec", "", "replay, suite and parallel (slice 5 of the "
             "port)")):
        value = getattr(hp, knob)
        if value != default:
            _unsupported(knob, value, where)
    if hp.pi_update == "exact":
        _unsupported("pi_update", "exact")
    if hp.pi_update not in ("auto", "delta"):
        raise ValueError(f"unknown pi_update {hp.pi_update!r} "
                         "(use 'auto' or 'delta')")


class CODAState(NamedTuple):
    """Selector state of the incremental tier (the reference's
    ``CODAState`` minus the fields of later slices). ``update`` modifies
    these tensors in place. The seed-batched form carries the same fields
    with a leading replica axis S."""

    dirichlets: torch.Tensor        # (H, C, C) Dirichlet confusion posteriors
    pi_hat_xi: torch.Tensor         # (N, C) per-item class posterior
    pi_hat: torch.Tensor            # (C,) marginal class estimate
    unlabeled: torch.Tensor         # (N,) bool
    pbest_rows: torch.Tensor        # (C, H) P(best | class row c)
    pbest_hyp: torch.Tensor         # (C, N, H) ... under a +1 label of n as c
    pi_xi_unnorm: torch.Tensor      # (N, C) unnormalised pi-hat factors
    eig_scores_cached: torch.Tensor  # (N,) scores of the current posterior


# -- pi-hat ------------------------------------------------------------------

def pi_unnorm(dirichlets: torch.Tensor, preds: torch.Tensor) -> torch.Tensor:
    """Unnormalised (N, C) class scores ``Σ_{h,s} d[h,c,s]·preds[h,n,s]``."""
    return torch.einsum("hcs,hns->nc", dirichlets, preds)


def _normalize_pi(unnorm: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """(pi_hat_xi, pi_hat) from the unnormalised (..., N, C) class
    scores."""
    pi_xi = unnorm / torch.clamp_min(unnorm.sum(-1, keepdim=True), 1e-12)
    pi = pi_xi.sum(-2)
    return pi_xi, pi / pi.sum(-1, keepdim=True)


def update_pi_hat(dirichlets: torch.Tensor, preds: torch.Tensor):
    """Dirichlet-adjusted class posterior per item + dataset marginal."""
    return _normalize_pi(pi_unnorm(dirichlets, preds))


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
    c = true_class.reshape(1).to(torch.int64)
    pi_xi_unnorm.index_add_(1, c, delta[:, None])
    pi_xi, pi = _normalize_pi(pi_xi_unnorm)
    return pi_xi, pi, pi_xi_unnorm


# -- the P(best) cache ---------------------------------------------------------

def _pbest_hyp_block(eq, S0, dlogcdf, F_u, dF, w_trapz):
    """Hypothetical P(best) for a block of items: ``eq`` (B, C, H) ->
    (B, C, H). Three fp32 contractions over the model and grid axes; the
    max-shift of S per (n, c) is the reference's underflow guard."""
    S = S0[None] + torch.einsum("bch,chg->bcg", eq, dlogcdf)
    S = S - S.amax(-1, keepdim=True)
    wE = w_trapz * torch.exp(S)                       # (B, C, G)
    t_base = torch.einsum("bcg,chg->bch", wE, F_u)
    t_diff = torch.einsum("bcg,chg->bch", wE, dF)
    unnorm = t_base + eq * t_diff
    return unnorm / torch.clamp_min(unnorm.sum(-1, keepdim=True), _EPS)


def build_eig_cache(dirichlets: torch.Tensor, hard_preds: torch.Tensor,
                    update_weight: float = 1.0, num_points: int = 256,
                    chunk: int = 256,
                    cache_dtype: torch.dtype = torch.float32
                    ) -> tuple[torch.Tensor, torch.Tensor]:
    """The full ``(pbest_rows (C, H), pbest_hyp (C, N, H))`` cache: one
    factored pass over all N items and C class rows, in ``chunk``-item
    blocks written straight into the ``(C, N, H)`` layout. The math is
    fp32; ``cache_dtype`` is the storage type of ``pbest_hyp`` (each block
    rounded to nearest even on the way in)."""
    H, C, _ = dirichlets.shape
    N = hard_preds.shape[0]
    a_cc, b_cc = dirichlet_to_beta(dirichlets)
    aT, bT = a_cc.T, b_cc.T                           # (C, H)
    pbest_rows = compute_pbest(aT, bT, num_points=num_points)
    x = pbest_grid(num_points, dirichlets.device)
    dx = x[1] - x[0]
    w_trapz = _trapz_weights(num_points, dx)
    S0, dlogcdf, F_u, dF = _bump_tables(aT, bT, x, dx, update_weight)
    classes = torch.arange(C, dtype=hard_preds.dtype, device=hard_preds.device)
    hyp = torch.empty((C, N, H), dtype=cache_dtype, device=dirichlets.device)
    B = max(1, min(chunk, N))
    for start in range(0, N, B):
        pred_b = hard_preds[start:start + B]          # (B, H)
        eq = (pred_b[:, None, :] == classes[None, :, None]).to(torch.float32)
        blk = _pbest_hyp_block(eq, S0, dlogcdf, F_u, dF, w_trapz)
        hyp[:, start:start + B] = blk.transpose(0, 1)
    return pbest_rows, hyp


def row_beta(dirichlets: torch.Tensor, true_class: torch.Tensor):
    """``(a_t, b_t)`` (H,): the diagonal-Beta parameters of class row
    ``true_class`` (a 0-d device tensor; no host synchronisation).
    Seed-batched: ``(S, H, C, C)`` posteriors and ``(S,)`` classes give
    ``(S, H)``, replica s's row ``true_class[s]``."""
    a_cc, b_cc = dirichlet_to_beta(dirichlets)       # (..., H, C)
    if dirichlets.dim() == 3:
        c = true_class.reshape(1).to(torch.int64)
        return a_cc.index_select(1, c)[:, 0], b_cc.index_select(1, c)[:, 0]
    c = true_class.to(torch.int64)[:, None, None].expand(-1, a_cc.shape[1], 1)
    return a_cc.gather(-1, c)[..., 0], b_cc.gather(-1, c)[..., 0]


def update_eig_cache_parts(dirichlets: torch.Tensor, true_class: torch.Tensor,
                           hard_preds: torch.Tensor, update_weight: float = 1.0,
                           num_points: int = 256):
    """The refreshed values of class row ``true_class`` without writing
    them: ``(row_t (H,), hyp_t (N, H))``. ``dirichlets`` already holds the
    new label; ``true_class`` is a 0-d device tensor. Seed-batched:
    ``(S, H, C, C)`` and ``(S,)`` give ``((S, H), (S, N, H))``."""
    a_t, b_t = row_beta(dirichlets, true_class)
    # (N, H) bool, or (S, N, H) with each replica's own class; compared in
    # hard_preds' int32 (an int64 class would widen the whole pass)
    c = true_class.to(hard_preds.dtype)
    eq_t = hard_preds == c.reshape(c.shape + (1, 1))
    hyp_t = _pbest_hyp_row(a_t, b_t, eq_t, update_weight, num_points)
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


# -- the selector --------------------------------------------------------------

def make_coda(preds: torch.Tensor, hp: Optional[CODAHyperparams] = None,
              name: str = "coda", device: DeviceLike = None) -> Selector:
    """Build the CODA selector over a ``(H, N, C)`` prediction tensor.

    Runs on ``device`` (default: the card; ``device="cpu"`` runs the plain
    versions). The statics — hard predictions, disagreement mask, the
    confusion prior and the ``(C, H, N)`` gather layout — are built once
    here; ``init``/``select``/``update``/``best`` keep everything on the
    device and never synchronise with the host. So does the seed-batched
    form, ``Selector.batched`` (None for the fused refresh).
    """
    hp = hp or CODAHyperparams()
    dev = resolve_device(device)
    pin_fp32_matmul()
    preds = torch.as_tensor(preds, dtype=torch.float32).to(dev)
    H, N, C = preds.shape
    check_supported(hp, N)
    resolve_eig_mode(hp, H, N, C)
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
    dirichlets0 = hp.multiplier * initialize_dirichlets(
        soft_conf, prior_strength, hp.disable_diag_prior)
    preds_by_class = prep_gather_layout(preds)                     # (C, H, N)

    def _initial_state() -> CODAState:
        """The deterministic initial state, before its score-ahead."""
        unnorm = pi_unnorm(dirichlets0, preds)
        pi_xi, pi = _normalize_pi(unnorm)
        rows, hyp = build_eig_cache(dirichlets0, hard_preds,
                                    num_points=hp.num_points,
                                    chunk=hp.eig_chunk,
                                    cache_dtype=cache_dtype)
        return CODAState(
            dirichlets=dirichlets0.clone(),
            pi_hat_xi=pi_xi,
            pi_hat=pi,
            unlabeled=torch.ones(N, dtype=torch.bool, device=dev),
            pbest_rows=rows,
            pbest_hyp=hyp,
            pi_xi_unnorm=unnorm,
            eig_scores_cached=None,
        )

    def init(key=None) -> CODAState:
        del key  # CODA's initialisation is deterministic
        st = _initial_state()
        # score-ahead: the next select reads these
        return st._replace(eig_scores_cached=score_fn(
            st.pbest_rows, st.pbest_hyp, st.pi_hat, st.pi_hat_xi,
            chunk=hp.eig_chunk, approx=approx))

    def select(state: CODAState, key: torch.Tensor) -> SelectResult:
        _k_sub, k_tie = trandom.split(key)
        # reference order: the disagreement filter first; an empty set
        # falls back to every unlabeled point
        cand0 = disagree & state.unlabeled
        cand = torch.where(cand0.any(), cand0, state.unlabeled)
        scores = state.eig_scores_cached
        idx, n_ties = masked_argmax_tiebreak(k_tie, scores, cand,
                                             rtol=_TIE_RTOL, atol=_TIE_ATOL)
        # a new tensor: ``update`` rewrites the state in place but not this
        return SelectResult(idx=idx, prob=scores.take(idx),
                            stochastic=n_ties > 1,
                            scores=torch.where(cand, scores, float("-inf")))

    def update(state: CODAState, idx, true_class, prob=None) -> CODAState:
        """One label, applied IN PLACE to ``state``'s tensors; returns the
        state with the new pi-hat and scores."""
        del prob
        c = true_class.reshape(1).to(torch.int64)
        pred_at = hard_preds.index_select(0, idx.reshape(1).to(torch.int64))[0]
        onehot = F.one_hot(pred_at.to(torch.int64), C).to(torch.float32)
        state.dirichlets.index_add_(1, c, (update_strength * onehot)[:, None])
        pi_xi, pi, unnorm = update_pi_hat_column_delta(
            true_class, pred_at, preds_by_class, state.pi_xi_unnorm,
            update_strength, gather_fn=gather_fn)
        if fused:
            # the class row is computed inside the scoring pass (kernel 6)
            # from the labelled class's Beta tables
            a_t, b_t = row_beta(state.dirichlets, true_class)
            row_t = compute_pbest(a_t, b_t, num_points=hp.num_points)
            state.pbest_rows.index_copy_(0, c, row_t[None])
            scores, hyp = compute_fn(
                state.pbest_rows, state.pbest_hyp, a_t, b_t, hard_preds,
                true_class, pi, pi_xi, num_points=hp.num_points,
                approx=approx, chunk=hp.eig_chunk)
        else:
            row_t, hyp_t = update_eig_cache_parts(
                state.dirichlets, true_class, hard_preds,
                num_points=hp.num_points)
            state.pbest_rows.index_copy_(0, c, row_t[None])
            scores, hyp = refresh_fn(state.pbest_rows, state.pbest_hyp,
                                     hyp_t, true_class, pi, pi_xi,
                                     chunk=hp.eig_chunk, approx=approx)
        state.unlabeled.index_fill_(0, idx.reshape(1).to(torch.int64), False)
        return state._replace(pi_hat_xi=pi_xi, pi_hat=pi, pi_xi_unnorm=unnorm,
                              pbest_hyp=hyp, eig_scores_cached=scores)

    def get_pbest(state: CODAState) -> torch.Tensor:
        # the cached per-row P(best) is compute_pbest of the current
        # posterior; only the pi-hat mixture is recomputed ((S, H) for a
        # batched state)
        return (state.pi_hat[..., :, None] * state.pbest_rows).sum(-2)

    def best(state: CODAState, key=None):
        del key  # plain argmax, as the reference
        return (get_pbest(state).argmax(),
                torch.zeros((), dtype=torch.bool, device=dev))

    # -- the seed-batched form: S replicas, one round for all ---------------

    def init_batched(S: int) -> CODAState:
        """S writable replicas of the deterministic initial state (the
        cache is built once and copied: ``update`` writes each replica in
        place), then one launch of kernel 4 for every replica's
        score-ahead."""
        st = CODAState(*(t.unsqueeze(0).repeat(S, *[1] * t.dim())
                         for t in _initial_state()[:-1]), None)
        return st._replace(eig_scores_cached=score_s_fn(
            st.pbest_rows, st.pbest_hyp, st.pi_hat, st.pi_hat_xi,
            chunk=hp.eig_chunk, approx=approx))

    def select_keys(keys: torch.Tensor) -> torch.Tensor:
        # select's own split of its key (``select`` above), on the host:
        # the tie-break draws from the second half
        return trandom.split(keys)[..., 1, :]

    def select_batched(state: CODAState, k_tie: torch.Tensor
                       ) -> SelectResult:
        """One pick per replica; ``k_tie`` (S, 2) on the state's device,
        rows of :func:`select_keys`."""
        cand0 = disagree & state.unlabeled                         # (S, N)
        cand = torch.where(cand0.any(-1, keepdim=True), cand0,
                           state.unlabeled)
        scores = state.eig_scores_cached
        idx, n_ties = masked_argmax_tiebreak(k_tie, scores, cand,
                                             rtol=_TIE_RTOL, atol=_TIE_ATOL)
        return SelectResult(idx=idx, prob=scores.gather(1, idx[:, None])[:, 0],
                            stochastic=n_ties > 1,
                            scores=torch.where(cand, scores, float("-inf")))

    def update_batched(state: CODAState, idx, true_class, prob=None
                       ) -> CODAState:
        """One label per replica, ``idx`` and ``true_class`` (S,), applied
        IN PLACE: each replica's Dirichlet row, pi-hat column (batched
        kernel 3), P(best) row, and cache row with the scores (kernel 5,
        one launch for all replicas)."""
        del prob
        rep = torch.arange(idx.shape[0], device=dev)
        c = true_class.to(torch.int64)
        pred_at = hard_preds.index_select(0, idx.to(torch.int64))  # (S, H)
        onehot = F.one_hot(pred_at.to(torch.int64), C).to(torch.float32)
        state.dirichlets[rep, :, c] += update_strength * onehot
        delta = update_strength * gather_s_fn(preds_by_class, pred_at)
        state.pi_xi_unnorm[rep, :, c] += delta
        pi_xi, pi = _normalize_pi(state.pi_xi_unnorm)
        row_t, hyp_t = update_eig_cache_parts(
            state.dirichlets, c, hard_preds, num_points=hp.num_points)
        state.pbest_rows[rep, c] = row_t
        scores, hyp = refresh_s_fn(state.pbest_rows, state.pbest_hyp, hyp_t,
                                   c, pi, pi_xi, chunk=hp.eig_chunk,
                                   approx=approx)
        state.unlabeled[rep, idx.to(torch.int64)] = False
        return state._replace(pi_hat_xi=pi_xi, pi_hat=pi, pbest_hyp=hyp,
                              eig_scores_cached=scores)

    def best_batched(state: CODAState):
        pbest = get_pbest(state)                                   # (S, H)
        return (pbest.argmax(-1),
                torch.zeros(pbest.shape[0], dtype=torch.bool, device=dev))

    batched = BatchedSelector(
        init=init_batched, select_keys=select_keys, select=select_batched,
        update=update_batched, best=best_batched) if batches_seeds(hp) \
        else None

    return Selector(
        name=name, init=init, select=select, update=update, best=best,
        always_stochastic=False,
        hyperparams=dict(hp._asdict()),
        hyperparam_defaults=dict(CODAHyperparams()._asdict()),
        extras={"get_pbest": get_pbest, "hard_preds": hard_preds,
                "preds_by_class": preds_by_class},
        batched=batched,
    )
