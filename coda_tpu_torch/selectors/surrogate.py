"""The contract-gated EIG surrogate, ``--eig-scorer surrogate:k``
(counterpart of ``coda_tpu/selectors/surrogate.py``).

On the incremental tier a round's cost is the one full scoring pass over
the ``(C, N, H)`` P(best) cache, though only the top few candidates can be
picked. The surrogate scorer replaces that pass with

  1. a ridge regressor over :data:`N_FEATURES` cheap per-candidate
     features the state already carries (pi-hat moments, the labelled
     class rows' coupling, per-class Beta summaries, expected |dP(best)|
     summaries at each candidate's :data:`SURROGATE_FEATURE_KC` likeliest
     labels, the previous round's score), predicting every score;
  2. an exact re-score of the predicted top-k plus
     :data:`SURROGATE_AUDIT_ROWS` rotating audit rows, so the picked score
     is always an exact one;
  3. a trust gate measured every round on those exact rows (an
     unrefreshed prediction reaching the best exact score, an audit row
     outranking the shortlist's tail, or a prediction off by more than
     :data:`SURROGATE_SCORE_TOL` on the top exact ranks): a violated
     round falls back to the full exact pass, and the first
     :data:`SURROGATE_WARMUP_ROUNDS` rounds are always full.

Every round refolds the fit's normal equations with its (features, exact
score) pairs and re-solves the 16x16 ridge (fp32 ``torch.linalg.solve``).
``surrogate:k`` with ``k >= N`` re-scores every row exactly, so its
scores are the exact scorer's.

The reference chooses between the full pass and the hybrid vector with
``lax.cond``. Here the choice is a real branch on the host, so a round
reads one flag back from the device: the warmup counter on a warmup
round, the gate's verdict after it (two reads on a round past warmup).
The full pass is the selector's own scoring pass (kernel 1 on the card);
the shortlist's exact rows are PyTorch.

The cross-session prior (``--surrogate-prior pool``): :class:`PriorStats`
is the fit's normal equations as float64 numpy, summed across sessions
(:func:`merge_fits`), decayed and capped (:func:`fold_prior`), and a new
session's fit starts from it with warmup credit (:func:`seed_fit`).
:func:`prior_digest` is the reference's digest of a pool's values.

Under a mesh (``mesh=``, ``parallel/mesh.py``) each rank holds its
``(C, N/a, H/b)`` block of the cache and builds the features of its items:
every sum over models (the class summaries' means, the labelled classes'
vote share, the |dP(best)| profile's sum, squares and mixture alignment,
the mixture's normaliser) is the model group's rank-order sum, its max the
group's max, and a mean divides by the global H as a device tensor. The
shortlist is the top k over every data block (``ops/masked.top_k``), the
audit rows are drawn over the global N, each re-scored row is computed on
its owner's block and sent to every rank (``collectives.from_owner``), and
the gate reads the predictions and masks gathered over the data group. The
normal equations add the data group's parts in rank order. So the fit and
the gate's verdict — and with them the host branch — are bitwise the same
on every rank.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import numpy as np
import torch

from coda_tpu_torch.ops.masked import entropy2, top_k
from coda_tpu_torch.ops.pbest import sum_h
from coda_tpu_torch.ops.sparse_rows import _even_share as _div
from coda_tpu_torch.parallel.collectives import (
    all_gather_cat,
    clear_items,
    gather_sum,
    local_positions,
    max_over,
    min_over,
)
from coda_tpu_torch.parallel.mesh import DATA_AXIS, MODEL_AXIS, Mesh

#: feature width of the ridge regressor (see :func:`build_features`)
N_FEATURES = 16

#: rounds that always run the full exact pass before the surrogate may
#: score one
SURROGATE_WARMUP_ROUNDS = 10

#: the score contract the gate holds predictions to on the top exact
#: ranks (the cross-backend 2.34e-4)
SURROGATE_SCORE_TOL = 2.34e-4

#: top exact-ranked shortlist rows the score contract is held on
SURROGATE_GATE_TOPR = 4

#: rotating audit rows re-scored exactly outside the shortlist a round
SURROGATE_AUDIT_ROWS = 4

#: likeliest labels a candidate's |dP(best)| features read from the cache
SURROGATE_FEATURE_KC = 8

#: ridge regulariser (relative to the accumulated pair count) and the
#: normal equations' exponential forgetting a round
SURROGATE_RIDGE_LAMBDA = 1e-4
SURROGATE_FIT_DECAY = 0.9

#: cap on the pair mass a merged prior carries into a fresh fit
SURROGATE_PRIOR_MAX_PAIRS = 4096.0

#: the pool's forgetting a contribution
SURROGATE_PRIOR_DECAY = 0.98

#: rounds a session's fit must have seen before it joins the pool
SURROGATE_PRIOR_MIN_ROUNDS = SURROGATE_WARMUP_ROUNDS

# the audit rotation's stride over the carried round counter (uint32)
_AUDIT_PRIME = 2654435761
_U32 = 0xFFFFFFFF

# items a block of the feature pass gathers from the cache: the (B, kc, H)
# fp32 slice stays a few tens of MB at the headline
_FEATURE_BLOCK = 1024


def parse_scorer(spec: str) -> Optional[int]:
    """``'exact'`` -> None; ``'surrogate:k'`` -> k (>= 1); anything else
    raises (the reference's text)."""
    if spec == "exact":
        return None
    if isinstance(spec, str) and spec.startswith("surrogate:"):
        try:
            k = int(spec.split(":", 1)[1])
        except ValueError:
            k = 0
        if k >= 1:
            return k
    raise ValueError(
        f"unknown eig_scorer {spec!r} (use 'exact' or 'surrogate:k' with "
        "integer k >= 1, e.g. 'surrogate:64')")


def gate_pressure(margin, tol: float = SURROGATE_SCORE_TOL) -> float:
    """The escape gate's margin as a drift reading in [0, inf): 0 with a
    margin of ``tol`` or more, 1 at a zero margin, above 1 once the gate
    forces fallbacks; a missing or non-finite margin reads 0."""
    if margin is None:
        return 0.0
    m = float(margin)
    if not np.isfinite(m):
        return 0.0
    return max(0.0, 1.0 - m / float(tol))


class SurrogateFit(NamedTuple):
    """The carried surrogate state (0-d tensors for the scalars)."""

    A: torch.Tensor          # (F, F) decayed F^T F
    b: torch.Tensor          # (F,) decayed F^T y
    w: torch.Tensor          # (F,) the ridge solution
    n: torch.Tensor          # 0-d f32, decayed pair count
    cls_feats: torch.Tensor  # (C, 3) per-class Beta summaries
    rounds: torch.Tensor     # 0-d i32, rounds seen
    fallbacks: torch.Tensor  # 0-d i32, gate fallbacks
    fits: torch.Tensor       # 0-d i32, refolds
    last_fallback: torch.Tensor  # 0-d bool, did this round fall back
    margin: torch.Tensor     # 0-d f32, the last gated round's margin
    prior_rounds: torch.Tensor   # 0-d i32, warmup credit of a pool prior
    prior_rejects: torch.Tensor  # 0-d i32, fallbacks inside that credit


def _h_global(H: int, mesh: Optional[Mesh]) -> int:
    return H * (mesh.model if mesh is not None else 1)


def class_feats_from_beta(a_row: torch.Tensor, b_row: torch.Tensor,
                          mesh: Optional[Mesh] = None) -> torch.Tensor:
    """``(..., 3)`` summaries of class rows' per-model Betas ``(..., H)``:
    log1p of the mean and of the min concentration, the mean accuracy.
    ``mesh``: the Betas of this rank's models; the sums and the minimum
    cross the model group."""
    conc = a_row + b_row
    H = _h_global(conc.shape[-1], mesh)
    acc = a_row / torch.clamp_min(conc, 1e-12)
    sums = sum_h(torch.stack([conc.sum(-1), acc.sum(-1)]), mesh)
    low = min_over(conc.amin(-1), mesh, MODEL_AXIS)
    # the means divide by a device tensor: one IEEE division on every
    # device (the reference's quotient), never the CUDA reciprocal product
    return torch.stack([torch.log1p(_div(sums[0], H)),
                        torch.log1p(low),
                        _div(sums[1], H)], -1).to(torch.float32)


def init_fit(a_cc_T: torch.Tensor, b_cc_T: torch.Tensor,
             mesh: Optional[Mesh] = None) -> SurrogateFit:
    """A zeroed fit with the initial posterior's class summaries, from
    every class row's ``(C, H)`` Beta parameters (``mesh``: this rank's
    models')."""
    dev = a_cc_T.device
    F = N_FEATURES

    def i32():
        return torch.zeros((), dtype=torch.int32, device=dev)

    return SurrogateFit(
        A=torch.zeros((F, F), dtype=torch.float32, device=dev),
        b=torch.zeros(F, dtype=torch.float32, device=dev),
        w=torch.zeros(F, dtype=torch.float32, device=dev),
        n=torch.zeros((), dtype=torch.float32, device=dev),
        cls_feats=class_feats_from_beta(a_cc_T, b_cc_T, mesh),
        rounds=i32(), fallbacks=i32(), fits=i32(),
        last_fallback=torch.zeros((), dtype=torch.bool, device=dev),
        margin=torch.full((), float("nan"), dtype=torch.float32, device=dev),
        prior_rounds=i32(), prior_rejects=i32())


def refresh_class_feats(fit: SurrogateFit, true_classes: torch.Tensor,
                        a_t: torch.Tensor, b_t: torch.Tensor,
                        mesh: Optional[Mesh] = None) -> SurrogateFit:
    """The labelled class rows' summaries, ``true_classes`` (q,) and their
    ``(q, H)`` Betas (``mesh``: this rank's models'), written in order (a
    repeated class keeps the last); the fit's ``cls_feats`` is updated IN
    PLACE."""
    rows = class_feats_from_beta(a_t, b_t, mesh)                # (q, 3)
    tcs = true_classes.reshape(-1).to(torch.int64)
    for j in range(tcs.shape[0]):
        fit.cls_feats.index_copy_(0, tcs[j:j + 1], rows[j:j + 1])
    return fit


def build_features(prev_scores: torch.Tensor,   # (N,) last round's
                   pi_hat_xi: torch.Tensor,     # (N, C)
                   pi_hat: torch.Tensor,        # (C,)
                   cls_feats: torch.Tensor,     # (C, 3)
                   pbest_rows: torch.Tensor,    # (C, H)
                   pbest_hyp: torch.Tensor,     # (C, N, H), storage dtype
                   hard_preds: torch.Tensor,    # (N, H) int32
                   true_classes: torch.Tensor,  # (q,) the labelled rows
                   block: int = _FEATURE_BLOCK,
                   mesh: Optional[Mesh] = None) -> torch.Tensor:
    """The ``(N, N_FEATURES)`` design matrix, in the reference's column
    order: 1, the previous score, pi-hat's max, runner-up, entropy and
    collision mass, the candidate's weight on the labelled classes and the
    share of models predicting them, the expectation of the class
    summaries, the sum/max/L2/mixture-alignment of the expected
    |dP(best)| profile at the top-kc labels, and previous score x weight.
    The profile gathers ``(block, kc, H)`` of the cache at a time, so no
    ``(N, kc, H)`` temporary is ever built.

    ``mesh``: every operand is this rank's block (its items, and its
    models of ``pbest_rows``, ``pbest_hyp`` and ``hard_preds``) and the
    rows are its items' features, the same on every rank of its model
    group: the sums over models are the group's rank-order sums (the L2
    norm's ``sqrt`` taken after the sum), the profile's max the group's
    max, and the vote share divides by the global H."""
    N, C = pi_hat_xi.shape
    dev = pi_hat_xi.device
    prev = prev_scores.to(torch.float32)
    finite_prev = torch.where(torch.isfinite(prev), prev, 0.0)
    top2 = top_k(pi_hat_xi, min(2, C))[0]
    p_max, p_2nd = top2[:, 0], top2[:, -1]
    p_ent = entropy2(pi_hat_xi, -1)
    p_coll = (pi_hat_xi * pi_hat_xi).sum(-1)
    tcs = true_classes.reshape(-1).to(torch.int64)
    w_t = pi_hat_xi.index_select(1, tcs).sum(-1)                 # (N,)
    eq = hard_preds[:, None, :] == tcs.to(hard_preds.dtype)[None, :, None]
    # the count is exact, so the model group's sum is the unsharded count
    eq_t = _div(sum_h(eq.to(torch.float32).sum((1, 2)), mesh),
                eq.shape[1] * _h_global(eq.shape[2], mesh))
    conc = pi_hat_xi @ cls_feats                                  # (N, 3)
    kc = min(SURROGATE_FEATURE_KC, C)
    wv, ci = top_k(pi_hat_xi * pi_hat[None, :], kc)               # (N, kc)
    mix = (pi_hat[:, None] * pbest_rows).sum(0)                  # (H,)
    mix = mix / torch.clamp_min(sum_h(mix.sum(), mesh), 1e-12)
    cols = {k: torch.empty(N, dtype=torch.float32, device=dev)
            for k in ("sum", "max", "l2", "mix")}
    B = max(1, min(block, N))
    for s in range(0, N, B):
        items = torch.arange(s, min(s + B, N), device=dev)
        ci_b = ci[s:s + B]
        hyp_sel = pbest_hyp[ci_b, items[:, None]].to(torch.float32)
        E = (wv[s:s + B, :, None]
             * torch.abs(hyp_sel - pbest_rows[ci_b])).sum(1)    # (B, H)
        cols["sum"][s:s + B] = E.sum(-1)
        cols["max"][s:s + B] = E.amax(-1)
        cols["l2"][s:s + B] = (E * E).sum(-1)
        cols["mix"][s:s + B] = E @ mix
    # this rank's models' parts, summed (and maxed) over the model group
    parts = sum_h(torch.stack([cols["sum"], cols["l2"], cols["mix"]]), mesh)
    cols.update(sum=parts[0], l2=torch.sqrt(parts[1]), mix=parts[2],
                max=max_over(cols["max"], mesh, MODEL_AXIS))
    feats = torch.stack([
        torch.ones(N, dtype=torch.float32, device=dev), finite_prev,
        p_max, p_2nd, p_ent, p_coll, w_t, eq_t,
        conc[:, 0], conc[:, 1], conc[:, 2],
        cols["sum"], cols["max"], cols["l2"], cols["mix"],
        finite_prev * w_t], 1)
    assert feats.shape[1] == N_FEATURES
    return feats


def _prev_anchor(feats: torch.Tensor) -> torch.Tensor:
    """The previous-score column: the regressor predicts the residual
    against it."""
    return feats[:, 1]


def predict(fit: SurrogateFit, feats: torch.Tensor) -> torch.Tensor:
    """``(N,)`` predictions: the previous score plus the ridge residual."""
    return _prev_anchor(feats) + feats @ fit.w


def _solve(A: torch.Tensor, b: torch.Tensor, n: torch.Tensor
           ) -> torch.Tensor:
    """The ridge solution of ``(A + lambda I) w = b``, lambda scaled by the
    pair count; a non-finite solution (a degenerate system) becomes 0."""
    lam = SURROGATE_RIDGE_LAMBDA * torch.clamp_min(n, 1.0)
    eye = torch.eye(N_FEATURES, dtype=A.dtype, device=A.device)
    w = torch.linalg.solve(A + lam * eye, b)
    return torch.where(torch.isfinite(w), w, 0.0)


def fold_pairs(fit: SurrogateFit, feats: torch.Tensor,
               targets: torch.Tensor, mask: torch.Tensor,
               mesh: Optional[Mesh] = None) -> SurrogateFit:
    """Refold the normal equations with the rows of ``mask`` (their exact
    scores as residuals against the previous score) and re-solve.
    ``mesh``: the rows are this rank's items, and the products over them
    are the data group's rank-order sums (bitwise the same fit on every
    rank)."""
    m = mask.to(torch.float32)
    fm = feats * m[:, None]
    resid = targets - _prev_anchor(feats)
    tm = torch.where(mask & torch.isfinite(resid), resid, 0.0)
    FtF, Fty, count = fm.T @ fm, fm.T @ tm, m.sum()
    if mesh is not None and mesh.data > 1:
        F = N_FEATURES
        flat = gather_sum(torch.cat([FtF.reshape(-1), Fty, count[None]]),
                          mesh, DATA_AXIS)
        FtF, Fty, count = flat[:F * F].reshape(F, F), flat[F * F:-1], \
            flat[-1]
    A = SURROGATE_FIT_DECAY * fit.A + FtF
    b = SURROGATE_FIT_DECAY * fit.b + Fty
    n = SURROGATE_FIT_DECAY * fit.n + count
    return fit._replace(A=A, b=b, w=_solve(A, b, n), n=n,
                        fits=fit.fits + 1)


def audit_rows(fit: SurrogateFit, N: int,
               n_audit: int = SURROGATE_AUDIT_ROWS) -> torch.Tensor:
    """The round's audit rows: ``n_audit`` rows strided over the pool,
    rotated by the round counter (uint32 arithmetic, as the reference)."""
    n_audit = max(1, min(n_audit, N))
    stride = max(1, N // n_audit)
    dev = fit.rounds.device
    base = (fit.rounds.to(torch.int64) * _AUDIT_PRIME) & _U32
    offs = torch.arange(n_audit, dtype=torch.int64, device=dev) * stride
    return (((base + offs) & _U32) % N).to(torch.int64)


class GateVerdict(NamedTuple):
    """The trust gate's reading of a round (0-d tensors)."""

    violated: torch.Tensor       # bool, any condition tripped
    escape: torch.Tensor         # bool, an unrefreshed prediction reached
    #                              the best exact score
    audit_outrank: torch.Tensor  # bool, an audit row beat the shortlist
    delta: torch.Tensor          # f32, max |pred - exact| on the top ranks
    margin: torch.Tensor         # f32, best exact score minus the best
    #                              unrefreshed prediction


def measure_gate(pred: torch.Tensor, exact_sel: torch.Tensor,
                 sel: torch.Tensor, k: int, cand: torch.Tensor,
                 refreshed: torch.Tensor) -> GateVerdict:
    """The three contract conditions (module docstring)."""
    inf = float("inf")
    short_sel, short_exact = sel[:k], exact_sel[:k]
    short_valid = cand[short_sel]
    audit_sel, audit_exact = sel[k:], exact_sel[k:]
    in_short = (audit_sel[:, None] == short_sel[None, :]).any(1)
    audit_valid = cand[audit_sel] & ~in_short
    floor = torch.where(short_valid, short_exact, inf).amin()
    peak = torch.where(short_valid, short_exact, -inf).amax()
    peak = torch.maximum(peak, torch.where(audit_valid, audit_exact,
                                           -inf).amax())
    max_unref = torch.where(cand & ~refreshed, pred, -inf).amax()
    tie_slack = 1e-8 + 1e-8 * torch.abs(peak)
    escape = max_unref >= peak - tie_slack
    audit_outrank = (audit_valid
                     & (audit_exact > floor + SURROGATE_SCORE_TOL)).any()
    r = min(SURROGATE_GATE_TOPR, k)
    top_exact, top_loc = top_k(torch.where(short_valid, short_exact, -inf), r)
    pred_at = pred[short_sel[top_loc]]
    delta = torch.where(torch.isfinite(top_exact),
                        torch.abs(pred_at - top_exact), 0.0).amax()
    violated = escape | audit_outrank | (delta > SURROGATE_SCORE_TOL)
    return GateVerdict(violated=violated, escape=escape,
                       audit_outrank=audit_outrank, delta=delta,
                       margin=(peak - max_unref).to(torch.float32))


def _owned(sel: torch.Tensor, N: int, mesh: Mesh) -> torch.Tensor:
    """This rank's positions of the global rows ``sel`` it holds, and
    ``N`` (one past its block) for the others."""
    hit = torch.div(sel, N, rounding_mode="floor") == mesh.data_index
    return torch.where(hit, local_positions(sel, N, mesh), N)


def propose_shortlist(fit: SurrogateFit, feats: torch.Tensor,
                      cand: torch.Tensor, k: int, exact_rows_fn,
                      mesh: Optional[Mesh] = None) -> tuple:
    """Predict, shortlist, re-score exactly, measure: ``(pred, sel,
    exact_sel, refreshed, verdict)``. ``mesh``: ``feats`` and ``cand``
    are this rank's items, ``pred`` and ``refreshed`` its block, ``sel``
    global rows over every block (the audit rows over the global N) and
    ``exact_rows_fn(sel)`` their exact scores, the same on every rank;
    the gate reads the data group's gathered vectors."""
    N = feats.shape[0]
    n_all = N * (mesh.data if mesh is not None else 1)
    k = max(1, min(k, n_all))
    pred = predict(fit, feats)
    _, short = top_k(torch.where(cand, pred, float("-inf")), k, mesh)
    sel = torch.cat([short, audit_rows(fit, n_all)])
    exact_sel = exact_rows_fn(sel)
    unref = torch.ones(N, dtype=torch.bool, device=feats.device)
    clear_items(unref, sel, mesh)
    refreshed = ~unref
    vecs = (pred, cand, refreshed)
    if mesh is not None:
        # the gate on every block's vectors, the same on every rank
        vecs = [all_gather_cat(t, mesh, DATA_AXIS, 0) for t in vecs]
    verdict = measure_gate(vecs[0], exact_sel, sel, k, *vecs[1:])
    return pred, sel, exact_sel, refreshed, verdict


def _hybrid(pred, sel, exact_sel, mesh: Optional[Mesh] = None):
    """The predictions with the exactly re-scored rows in place (``mesh``:
    the rows this rank holds, in its block)."""
    if mesh is None:
        scores = pred.clone()
        scores[sel] = exact_sel
        return scores
    # the rows of other ranks land in a spare slot past the block
    N = pred.shape[0]
    scores = torch.cat([pred, pred.new_zeros(1)])
    scores[_owned(sel, N, mesh)] = exact_sel
    return scores[:N]


def hybrid_score_pass(fit: SurrogateFit, feats: torch.Tensor,
                      cand: torch.Tensor, k: int, exact_rows_fn,
                      mesh: Optional[Mesh] = None) -> tuple:
    """A surviving round's scoring alone (no warmup or fallback branch):
    ``(hybrid scores, refolded fit, verdict)`` (``mesh``: see
    :func:`propose_shortlist`)."""
    pred, sel, exact_sel, refreshed, verdict = propose_shortlist(
        fit, feats, cand, k, exact_rows_fn, mesh)
    scores = _hybrid(pred, sel, exact_sel, mesh)
    return scores, fold_pairs(fit, feats, scores, refreshed & cand,
                              mesh), verdict


def surrogate_score_round(fit: SurrogateFit, feats: torch.Tensor,
                          cand: torch.Tensor, k: int, exact_rows_fn,
                          exact_full_fn, mesh: Optional[Mesh] = None
                          ) -> tuple:
    """One round under the contract: ``(scores, fit')``. A warmup round
    (``rounds + prior_rounds < SURROGATE_WARMUP_ROUNDS``) or a round whose
    gate is violated runs ``exact_full_fn`` and refolds from every
    candidate; any other round returns the hybrid vector and refolds from
    the re-scored rows. The branch is taken on the host (module
    docstring); under a ``mesh`` (see :func:`propose_shortlist`) the
    warmup counter and the verdict are the same on every rank, so every
    rank takes the same branch."""
    dev = feats.device
    false = torch.zeros((), dtype=torch.bool, device=dev)
    warm_t = (fit.rounds + fit.prior_rounds) < SURROGATE_WARMUP_ROUNDS
    warm = bool(warm_t)
    if warm:
        verdict = GateVerdict(violated=false, escape=false,
                              audit_outrank=false,
                              delta=torch.zeros((), dtype=torch.float32,
                                                device=dev),
                              margin=fit.margin)
        need_full = True
    else:
        pred, sel, exact_sel, refreshed, verdict = propose_shortlist(
            fit, feats, cand, k, exact_rows_fn, mesh)
        need_full = bool(verdict.violated)
    if need_full:
        scores, pair_mask = exact_full_fn(), cand
    else:
        scores = _hybrid(pred, sel, exact_sel, mesh)
        pair_mask = refreshed & cand
    fit = fold_pairs(fit, feats, scores, pair_mask, mesh)
    fell_back = verdict.violated & ~warm_t
    prior_reject = fell_back & (fit.rounds < SURROGATE_WARMUP_ROUNDS)
    fit = fit._replace(
        rounds=fit.rounds + 1,
        fallbacks=fit.fallbacks + fell_back.to(torch.int32),
        last_fallback=fell_back,
        margin=verdict.margin,
        prior_rejects=fit.prior_rejects + prior_reject.to(torch.int32))
    return scores, fit


# -- the cross-session prior (--surrogate-prior pool) -------------------------

def parse_prior(spec: str) -> bool:
    """``'off'`` -> False; ``'pool'`` -> True; anything else raises."""
    if spec == "off":
        return False
    if spec == "pool":
        return True
    raise ValueError(
        f"unknown surrogate_prior {spec!r} (use 'off' or 'pool')")


class PriorStats(NamedTuple):
    """A mergeable cross-session prior: float64 numpy on the host (a sum
    of the sessions' decayed normal equations), cast to fp32 only when a
    fit is seeded (:func:`seed_fit`)."""

    A: np.ndarray       # (F, F) f64
    b: np.ndarray       # (F,) f64
    n: float            # summed decayed pair count
    rounds: float       # summed labelling rounds of the contributors
    sessions: float     # sessions folded in (decays too)


def empty_prior() -> PriorStats:
    """The neutral element of :func:`merge_fits`."""
    F = N_FEATURES
    return PriorStats(A=np.zeros((F, F), np.float64),
                      b=np.zeros((F,), np.float64),
                      n=0.0, rounds=0.0, sessions=0.0)


def _host(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        return x.detach().cpu().numpy()
    return np.asarray(x)


def prior_from_fit(A, b, n, rounds) -> PriorStats:
    """One session's contribution from its fit's ``A``, ``b``, ``n`` and
    ``rounds`` (tensors or arrays); a fit that accumulated nothing gives
    the neutral element."""
    A = _host(A).astype(np.float64).reshape(N_FEATURES, N_FEATURES)
    b = _host(b).astype(np.float64).reshape(N_FEATURES)
    n = float(_host(n))
    if not np.isfinite(n) or n <= 0.0:
        return empty_prior()
    return PriorStats(A=A, b=b, n=n, rounds=float(_host(rounds)),
                      sessions=1.0)


def merge_fits(p: PriorStats, q: PriorStats) -> PriorStats:
    """The pool merge: an elementwise sum (commutative, with
    :func:`empty_prior` as its neutral element)."""
    return PriorStats(A=p.A + q.A, b=p.b + q.b, n=p.n + q.n,
                      rounds=p.rounds + q.rounds,
                      sessions=p.sessions + q.sessions)


def merge_many(priors) -> PriorStats:
    """Left fold of :func:`merge_fits` from the neutral element."""
    out = empty_prior()
    for p in priors:
        out = merge_fits(out, p)
    return out


def scale_prior(p: PriorStats, gamma: float) -> PriorStats:
    """A pool's mass scaled by ``gamma``."""
    g = float(gamma)
    return PriorStats(A=p.A * g, b=p.b * g, n=p.n * g,
                      rounds=p.rounds * g, sessions=p.sessions * g)


def clip_prior(p: PriorStats,
               max_pairs: float = SURROGATE_PRIOR_MAX_PAIRS) -> PriorStats:
    """A, b and n scaled down together to at most ``max_pairs`` pairs (the
    ridge solution is unchanged; rounds and sessions stay)."""
    if p.n <= max_pairs:
        return p
    g = max_pairs / p.n
    return p._replace(A=p.A * g, b=p.b * g, n=p.n * g)


def fold_prior(pool: PriorStats, contribution: PriorStats,
               decay: float = SURROGATE_PRIOR_DECAY) -> PriorStats:
    """The pool's fold: decay, merge, cap."""
    return clip_prior(merge_fits(scale_prior(pool, decay), contribution))


def prior_warmup_credit(p: PriorStats) -> int:
    """Warmup rounds a seeded session may skip: the pool's rounds, at
    most the whole warmup; none from an empty pool."""
    if p.n <= 0.0:
        return 0
    return int(min(float(SURROGATE_WARMUP_ROUNDS), p.rounds))


def seed_fit(fit: SurrogateFit, p: PriorStats) -> SurrogateFit:
    """A fresh fit warm-started from a pool: the prior's normal equations
    (cast to fp32) added, the ridge re-solved, the warmup credit granted.
    The class summaries stay this session's own."""
    credit = prior_warmup_credit(p)
    if credit == 0 and p.n <= 0.0:
        return fit
    dev = fit.A.device
    A = fit.A + torch.from_numpy(np.asarray(p.A, np.float32)).to(dev)
    b = fit.b + torch.from_numpy(np.asarray(p.b, np.float32)).to(dev)
    n = fit.n + torch.tensor(np.float32(p.n), device=dev)
    return fit._replace(A=A, b=b, w=_solve(A, b, n), n=n,
                        prior_rounds=fit.prior_rounds + credit)


def prior_to_dict(p: PriorStats) -> dict:
    """JSON form of a pool."""
    return {"v": 1, "A": np.asarray(p.A, np.float64).tolist(),
            "b": np.asarray(p.b, np.float64).tolist(),
            "n": float(p.n), "rounds": float(p.rounds),
            "sessions": float(p.sessions)}


def prior_from_dict(d: dict) -> PriorStats:
    if int(d.get("v", 1)) != 1:
        raise ValueError(f"unknown prior stats version {d.get('v')!r}")
    return PriorStats(
        A=np.asarray(d["A"], np.float64).reshape(N_FEATURES, N_FEATURES),
        b=np.asarray(d["b"], np.float64).reshape(N_FEATURES),
        n=float(d["n"]), rounds=float(d["rounds"]),
        sessions=float(d.get("sessions", 0.0)))


def prior_digest(p: PriorStats) -> str:
    """16-hex digest of a pool's values (blake2b over the float64 bytes
    of A, b, n and rounds): the reference's digest for the same arrays."""
    import hashlib

    h = hashlib.blake2b(digest_size=8)
    h.update(np.asarray(p.A, np.float64).tobytes())
    h.update(np.asarray(p.b, np.float64).tobytes())
    h.update(np.float64(p.n).tobytes())
    h.update(np.float64(p.rounds).tobytes())
    return h.hexdigest()
