"""The rest of CODA in the port against the JAX reference on the CPU: the
factored, rowscan and direct EIG tiers, the tier resolution, the amortized
P(best), ``pi_update='exact'``, ``eig_precision``, the prefilter and the
``q`` ablations, each tier's seed-batched form, and the reference's
refusals. The sparse posterior is ``tests/test_torch_sparse.py``'s.

Inputs come from seeded numpy generators or the repository's tasks, and
go through both packages. Tolerances:

  * tier resolution, refusal texts, keys and tie-break draws: equal;
  * one call of a tier's scoring function: ``rtol=1e-4, atol=1e-6`` (the
    reference's own bound between two lowerings of the same scores,
    ``tests/test_pallas_eig.py:298``); a batched call equals the stacked
    one-seed calls bitwise;
  * trajectories (3 seeds x 30 rounds, batched, against the reference's
    vmapped run): each seed equal in every recorded quantity within the
    cross-backend score contract (2.34e-4), or its first divergence a
    ``tie-break-flip`` where the reference's runner-up gap is at most
    2.34e-4 (the port's ``compare_records`` triage);
  * the amortized refresh: below the gate bitwise the quadrature, above it
    within 2.34e-4 of the quadrature's scores (the reference's pins,
    ``tests/test_sparse_posterior.py``);
  * ``eig_precision`` ``high``/``default`` on the CPU: bitwise ``highest``,
    as XLA's CPU backend gives.
"""

from __future__ import annotations

import dataclasses
import os

import numpy as np
import pytest
import torch

from coda_tpu_torch.selectors import coda as tcoda

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SCORE_TOL = dict(rtol=1e-4, atol=1e-6)
CONTRACT = 2.34e-4   # telemetry/recorder.CROSS_BACKEND_SCORE_TOL


@pytest.fixture(autouse=True)
def _one_torch_thread():
    """Each test on one PyTorch thread, restored after: when pytest-xdist
    workers share the cores, the port's many small operations on several
    threads each wait on the other workers' spinning threads (tens of
    times slower than on one)."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _task(name):
    """(preds, labels) numpy arrays of a synthetic shape or a data file."""
    if isinstance(name, tuple):
        from coda_tpu_torch.data import make_synthetic_arrays

        H, N, C = name
        return make_synthetic_arrays(seed=3, H=H, N=N, C=C)[:2]
    d = np.load(os.path.join(ROOT, "data", f"{name}.npz"))
    return d["preds"].astype(np.float32), d["labels"]


def _random_state(seed, H, N, C, S=0):
    """numpy (dirichlets, pi_hat, pi_hat_xi, hard_preds), a leading
    replica axis S when S > 0."""
    rng = np.random.default_rng(seed)
    lead = (S,) if S else ()
    d = (rng.uniform(0.05, 1.0, lead + (H, C, C))
         + 3.0 * np.eye(C)).astype(np.float32)
    pi_xi = rng.uniform(0.1, 1.0, lead + (N, C)).astype(np.float32)
    pi_xi /= pi_xi.sum(-1, keepdims=True)
    pi = pi_xi.mean(-2)
    pi = (pi / pi.sum(-1, keepdims=True)).astype(np.float32)
    hard = rng.integers(0, C, (N, H)).astype(np.int32)
    return d, pi, pi_xi.astype(np.float32), hard


# -- tier resolution ------------------------------------------------------------

SHAPES = [(1000, 50_000, 10), (500, 256, 1000), (80, 899, 10),
          (14, 899, 10), (2000, 4096, 1000), (6, 128, 4), (300, 20_000, 100),
          (20, 256, 40)]
KNOBS = [dict(), dict(n_parallel=5), dict(n_parallel=5,
                                          eig_cache_dtype="bfloat16"),
         dict(prefilter_n=4096), dict(prefilter_n=64), dict(q="iid"),
         dict(q="uncertainty", n_parallel=3), dict(posterior="sparse:32"),
         dict(posterior="sparse:32", n_parallel=5), dict(pi_update="exact"),
         dict(pi_update="exact", n_parallel=2), dict(eig_scorer="surrogate:8"),
         dict(num_points=128, n_parallel=8), dict(eig_mode="factored"),
         dict(eig_mode="rowscan", q="iid"), dict(eig_mode="direct"),
         dict(eig_mode="incremental"), dict(eig_mode="incremental", q="iid"),
         dict(eig_mode="incremental", prefilter_n=10)]


@pytest.mark.parametrize("shape", SHAPES)
def test_resolve_eig_mode_matches_reference(shape):
    """auto (and every explicit tier) names the reference's tier over a
    grid of knobs; an explicit incremental tier without full-pool EIG
    raises the reference's text. Rows at the headline, the
    imagenet_sparse pool and digits_h80 are pinned to their tier by
    name."""
    from coda_tpu.selectors import CODAHyperparams as JHP
    from coda_tpu.selectors.coda import resolve_eig_mode as jresolve

    for kw in KNOBS:
        try:
            want = jresolve(JHP(**kw), *shape)
        except ValueError as e:
            with pytest.raises(ValueError) as got:
                tcoda.resolve_eig_mode(tcoda.CODAHyperparams(**kw), *shape)
            assert str(got.value) == str(e)
            continue
        assert tcoda.resolve_eig_mode(tcoda.CODAHyperparams(**kw),
                                      *shape) == want, (shape, kw)
    pinned = {((1000, 50_000, 10), (("n_parallel", 5),)): "factored",
              ((1000, 50_000, 10), (("n_parallel", 5), ("eig_cache_dtype",
                                                        "bfloat16"))):
                  "factored",
              ((1000, 50_000, 10), (("prefilter_n", 4096),)): "factored",
              ((500, 256, 1000), (("n_parallel", 5),)): "rowscan",
              ((1000, 50_000, 10), ()): "incremental",
              ((80, 899, 10), (("n_parallel", 5),)): "incremental"}
    for (s, kw), tier in pinned.items():
        if s == shape:
            assert tcoda.resolve_eig_mode(tcoda.CODAHyperparams(**dict(kw)),
                                          *s) == tier


# -- each tier's scores ---------------------------------------------------------

TIERS = ("factored", "rowscan", "direct")


def _jax_tier_fn(tier):
    from coda_tpu.selectors import coda as jcoda

    return {"factored": jcoda.eig_scores_factored,
            "rowscan": jcoda.eig_scores_rowscan,
            "direct": jcoda.eig_scores}[tier]


def _port_tier_fn(tier):
    return {"factored": tcoda.eig_scores_factored,
            "rowscan": tcoda.eig_scores_rowscan,
            "direct": tcoda.eig_scores}[tier]


@pytest.mark.parametrize("tier", TIERS)
@pytest.mark.parametrize("shape,chunk", [((6, 128, 4), 48),
                                         ((14, 64, 10), 64),
                                         ((9, 37, 5), 16)])
def test_tier_scores_match_reference(tier, shape, chunk):
    """One scoring call of the tier on the same posterior, both packages,
    ragged chunks included; the seed-batched call equals the stacked
    one-seed calls bitwise."""
    import jax.numpy as jnp

    H, N, C = shape
    d, pi, pi_xi, hard = _random_state(7, H, N, C)
    kw = {} if tier == "direct" else {"approx": False}
    want = _jax_tier_fn(tier)(jnp.asarray(d), jnp.asarray(pi),
                              jnp.asarray(pi_xi), jnp.asarray(hard),
                              chunk=chunk, **kw)
    fn = _port_tier_fn(tier)
    got = fn(torch.from_numpy(d), torch.from_numpy(pi),
             torch.from_numpy(pi_xi), torch.from_numpy(hard), chunk=chunk)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **SCORE_TOL)
    ds, pis, pxs, _ = _random_state(8, H, N, C, S=3)
    ds[1], pis[1], pxs[1] = d, pi, pi_xi
    batched = fn(torch.from_numpy(ds), torch.from_numpy(pis),
                 torch.from_numpy(pxs), torch.from_numpy(hard), chunk=chunk)
    for s in range(3):
        one = fn(torch.from_numpy(ds[s]), torch.from_numpy(pis[s]),
                 torch.from_numpy(pxs[s]), torch.from_numpy(hard),
                 chunk=chunk)
        assert torch.equal(batched[s], one)


@pytest.mark.parametrize("tier", ("factored", "rowscan"))
def test_tier_scores_approx_entropy_match_reference(tier):
    """``eig_entropy='approx'`` on the factored and rowscan tiers: the
    polynomial log2 in both packages."""
    import jax.numpy as jnp

    d, pi, pi_xi, hard = _random_state(9, 8, 50, 6)
    want = _jax_tier_fn(tier)(jnp.asarray(d), jnp.asarray(pi),
                              jnp.asarray(pi_xi), jnp.asarray(hard),
                              chunk=32, approx=True)
    got = _port_tier_fn(tier)(torch.from_numpy(d), torch.from_numpy(pi),
                              torch.from_numpy(pi_xi),
                              torch.from_numpy(hard), chunk=32, approx=True)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **SCORE_TOL)


def test_rowscan_groups_rows_as_memory_allows(monkeypatch):
    """The row-scanned tier's value does not depend on how many class rows
    a step holds: one row a step (the reference's scan) and every row at
    once agree within the score tolerance, and both with factored."""
    d, pi, pi_xi, hard = (torch.from_numpy(a)
                          for a in _random_state(10, 7, 40, 9))
    full = tcoda.eig_scores_rowscan(d, pi, pi_xi, hard, chunk=16)
    monkeypatch.setattr(tcoda, "_ROWSCAN_TEMP_BYTES", 1)
    assert tcoda._rowscan_rows(1, 7, 16, 256) == 1
    one = tcoda.eig_scores_rowscan(d, pi, pi_xi, hard, chunk=16)
    fact = tcoda.eig_scores_factored(d, pi, pi_xi, hard, chunk=16)
    np.testing.assert_allclose(one.numpy(), full.numpy(), **SCORE_TOL)
    np.testing.assert_allclose(fact.numpy(), full.numpy(), **SCORE_TOL)


# -- trajectories ---------------------------------------------------------------

def _record(result, aux):
    from coda_tpu_torch.telemetry.recorder import RunRecord

    return RunRecord.from_result(result, aux, {}, {})


def _reference_run(preds, labels, iters, seeds, **kw):
    import jax.numpy as jnp

    from coda_tpu.engine import run_seeds_recorded
    from coda_tpu.selectors import CODAHyperparams, make_coda

    hp = CODAHyperparams(n_parallel=seeds, **kw)
    return _record(*run_seeds_recorded(lambda p: make_coda(p, hp),
                                       jnp.asarray(preds),
                                       jnp.asarray(labels), iters=iters,
                                       seeds=seeds))


def _port_run(preds, labels, iters, seeds, sequential=False, **kw):
    from coda_tpu_torch.engine import run_seeds_recorded

    hp = tcoda.CODAHyperparams(n_parallel=1 if sequential else seeds, **kw)

    def factory(p):
        sel = tcoda.make_coda(p, hp, device="cpu")
        return dataclasses.replace(sel, batched=None) if sequential else sel

    return _record(*run_seeds_recorded(factory, preds, labels, iters=iters,
                                       seeds=seeds, device="cpu"))


def _assert_triaged(got, ref):
    """Every seed at parity within the score contract, or diverging first
    as a tie-break flip at a reference runner-up gap <= 2.34e-4."""
    from coda_tpu_torch.engine.replay import compare_records

    report = compare_records(got, ref, score_tol=CONTRACT)
    for s in report.seeds:
        if s.parity:
            continue
        gap = float(ref.arrays["runner_up_gap"][s.seed,
                                                s.first_divergent_round])
        assert s.classification == "tie-break-flip", s.to_dict()
        assert abs(gap) <= CONTRACT, (s.to_dict(), gap)
    return report


@pytest.mark.parametrize("tier,task", [
    ("factored", (6, 128, 4)), ("factored", (14, 64, 10)),
    ("factored", "digits"), ("factored", "digits_h80"),
    ("rowscan", (6, 128, 4)), ("rowscan", (14, 64, 10)),
    ("rowscan", "digits"), ("direct", (6, 128, 4)),
    ("direct", (14, 64, 10))])
def test_tier_trajectories_match_vmapped_reference(tier, task):
    """3 seeds x 30 rounds of the tier, the port's seed-batched form
    against the reference's vmapped run (``n_parallel=3``)."""
    preds, labels = _task(task)
    kw = dict(eig_mode=tier, eig_chunk=1024)
    ref = _reference_run(preds, labels, 30, 3, **kw)
    got = _port_run(preds, labels, 30, 3, **kw)
    _assert_triaged(got, ref)


@pytest.mark.parametrize("tier", TIERS)
def test_tier_batched_equals_one_seed_after_another(tier):
    """The seed-batched form runs each seed's one-seed trajectory
    bitwise (scores, picks, posterior digests)."""
    preds, labels = _task((6, 96, 4))
    kw = dict(eig_mode=tier, eig_chunk=40)
    a = _port_run(preds, labels, 12, 3, **kw)
    b = _port_run(preds, labels, 12, 3, sequential=True, **kw)
    for f, arr in a.arrays.items():
        np.testing.assert_array_equal(arr, b.arrays[f], err_msg=f)


def test_factored_and_incremental_agree_on_the_scores():
    """The incremental tier's cached scores and the factored tier's
    recomputed ones are the same integral: round 0 within the score
    tolerance, and the 30-round trajectories triage."""
    preds, labels = _task("digits")
    inc = tcoda.make_coda(preds, tcoda.CODAHyperparams(
        eig_mode="incremental", eig_chunk=1024), device="cpu")
    fac = tcoda.make_coda(preds, tcoda.CODAHyperparams(
        eig_mode="factored", eig_chunk=1024), device="cpu")
    assert (inc.extras["eig_mode"], fac.extras["eig_mode"]) == (
        "incremental", "factored")
    key = torch.tensor([0, 0])
    si, sf = inc.init(None), fac.init(None)
    np.testing.assert_allclose(fac.select(sf, key).scores.numpy(),
                               inc.select(si, key).scores.numpy(),
                               **SCORE_TOL)
    _assert_triaged(_port_run(preds, labels, 30, 3, eig_mode="factored"),
                    _port_run(preds, labels, 30, 3, eig_mode="incremental"))


# -- the amortized P(best) ------------------------------------------------------

def _gate_case(seed, conc):
    rng = np.random.default_rng(seed)
    H, N = 7, 60
    a = (rng.uniform(0.3, 0.7, H) * conc).astype(np.float32)
    b = (conc - a).astype(np.float32)
    eq = rng.uniform(size=(N, H)) < 0.3
    return a, b, eq


@pytest.mark.parametrize("conc,engaged", [(4.2, False), (31.9, False),
                                          (40.0, True), (140.0, True)])
def test_amortized_gate(conc, engaged):
    """Below the gate the amortized refresh is bitwise the quadrature
    (the reference's lax.cond taken on the device); above it, bitwise the
    amortized tables' row, which equals the reference's
    ``_pbest_hyp_row_amortized`` within the score tolerance and tracks the
    quadrature's row within the reference's unit pin (0.05; the scoring
    chain contracts it to the 2.34e-4 score contract, pinned below)."""
    import jax.numpy as jnp

    from coda_tpu.selectors import coda as jcoda
    from coda_tpu_torch.ops import pbest as tpb

    a, b, eq = _gate_case(5, conc)
    at, bt, eqt = map(torch.from_numpy, (a, b, eq))
    gated = tpb._pbest_hyp_row_gated(at, bt, eqt, 1.0, 256,
                                     tcoda._AMORTIZED_MIN_CONC)
    quad = tpb._pbest_hyp_row(at, bt, eqt, 1.0, 256)
    amort = tpb._pbest_hyp_row_amortized(at, bt, eqt, 1.0, 256)
    if engaged:
        assert torch.equal(gated, amort)
        assert float((gated - quad).abs().max()) < 0.05
        want = jcoda._pbest_hyp_row_amortized(jnp.asarray(a), jnp.asarray(b),
                                              jnp.asarray(eq), 1.0, 256)
        np.testing.assert_allclose(amort.numpy(), np.asarray(want),
                                   **SCORE_TOL)
    else:
        assert torch.equal(gated, quad)
    # the batched gate decides each replica alone
    a2, b2, _ = _gate_case(6, 4.0 if engaged else 60.0)
    ab = torch.from_numpy(np.stack([a, a2]))
    bb = torch.from_numpy(np.stack([b, b2]))
    both = tpb._pbest_hyp_row_gated(ab, bb, torch.stack([eqt, eqt]), 1.0,
                                    256, tcoda._AMORTIZED_MIN_CONC)
    assert torch.equal(both[0], gated)


def test_logit_normal_closed_forms_match_reference():
    import jax.numpy as jnp

    from coda_tpu.ops import beta as jbeta
    from coda_tpu_torch.ops import beta as tbeta

    rng = np.random.default_rng(3)
    a = rng.uniform(0.5, 80.0, 50).astype(np.float32)
    b = rng.uniform(0.5, 80.0, 50).astype(np.float32)
    x = np.linspace(1e-6, 1 - 1e-6, 256, dtype=np.float32)
    mu_j, sig_j = jbeta.beta_logit_normal_params(jnp.asarray(a),
                                                 jnp.asarray(b))
    mu_t, sig_t = tbeta.beta_logit_normal_params(torch.from_numpy(a),
                                                 torch.from_numpy(b))
    np.testing.assert_allclose(mu_t.numpy(), np.asarray(mu_j), rtol=1e-5,
                               atol=1e-5)
    np.testing.assert_allclose(sig_t.numpy(), np.asarray(sig_j), rtol=1e-5)
    args_j = (jnp.asarray(x), mu_j[:, None], sig_j[:, None])
    args_t = (torch.from_numpy(x), mu_t[:, None], sig_t[:, None])
    for f in ("logit_normal_log_pdf", "logit_normal_log_cdf"):
        np.testing.assert_allclose(getattr(tbeta, f)(*args_t).numpy(),
                                   np.asarray(getattr(jbeta, f)(*args_j)),
                                   rtol=1e-4, atol=1e-3)


def test_amortized_engaged_holds_score_contract():
    """The reference's pin (``tests/test_sparse_posterior.py``): at
    multiplier 20 every row clears the gate; the scores move, within
    2.34e-4 of the quadrature run's, and the cached P(best) rows stay the
    quadrature's (posterior digest bitwise while the picks agree)."""
    preds, labels = _task((8, 200, 6))
    kw = dict(eig_mode="incremental", eig_chunk=64, multiplier=20.0)
    rec_q = _port_run(preds, labels, 20, 1, **kw)
    rec_a = _port_run(preds, labels, 20, 1, eig_pbest="amortized", **kw)
    d_score = max(float(np.max(np.abs(rec_q.arrays[q] - rec_a.arrays[q])))
                  for q in ("topk_score", "chosen_score"))
    assert 0.0 < d_score <= CONTRACT, d_score
    idx_q, idx_a = rec_q.arrays["chosen_idx"][0], rec_a.arrays["chosen_idx"][0]
    diverge = np.nonzero(idx_q != idx_a)[0]
    shared = int(diverge[0]) if diverge.size else len(idx_q)
    np.testing.assert_array_equal(rec_q.arrays["pbest_max"][0, :shared],
                                  rec_a.arrays["pbest_max"][0, :shared])


@pytest.mark.parametrize("multiplier", [2.0, 16.0])
def test_amortized_trajectory_matches_reference(multiplier):
    """``eig_pbest='amortized'`` runs 3 seeds x 30 rounds as the
    reference's does (multiplier 16 engages the gate, 2 keeps the
    quadrature); at multiplier 2 it is bitwise the quad run."""
    preds, labels = _task((14, 64, 10))
    kw = dict(eig_pbest="amortized", multiplier=multiplier, eig_chunk=1024)
    got = _port_run(preds, labels, 30, 3, **kw)
    _assert_triaged(got, _reference_run(preds, labels, 30, 3, **kw))
    if multiplier == 2.0:
        quad = _port_run(preds, labels, 30, 3, multiplier=multiplier,
                         eig_chunk=1024)
        for f, arr in got.arrays.items():
            np.testing.assert_array_equal(arr, quad.arrays[f], err_msg=f)


# -- pi_update, eig_precision ---------------------------------------------------

@pytest.mark.parametrize("task", [(6, 128, 4), "digits"])
def test_pi_update_exact_matches_reference_and_delta(task):
    """``pi_update='exact'`` (the column recomputed from the posterior
    row, no (C, H, N) layout) against the reference's exact column and
    against the port's delta run: both triage."""
    preds, labels = _task(task)
    got = _port_run(preds, labels, 30, 3, pi_update="exact", eig_chunk=1024)
    sel = tcoda.make_coda(preds, tcoda.CODAHyperparams(pi_update="exact"),
                          device="cpu")
    assert sel.extras["preds_by_class"] is None
    _assert_triaged(got, _reference_run(preds, labels, 30, 3,
                                        pi_update="exact", eig_chunk=1024))
    _assert_triaged(got, _port_run(preds, labels, 30, 3, eig_chunk=1024))


def test_pi_hat_column_matches_reference():
    import jax.numpy as jnp

    from coda_tpu.selectors import coda as jcoda

    d, _, _, _ = _random_state(11, 6, 40, 5)
    preds = np.random.default_rng(2).dirichlet(np.ones(5), (6, 40)).astype(
        np.float32)
    unnorm = np.asarray(jcoda.pi_unnorm(jnp.asarray(d), jnp.asarray(preds)))
    c = 3
    jx, jp, ju = jcoda.update_pi_hat_column(jnp.asarray(d), jnp.asarray(c),
                                            jnp.asarray(preds),
                                            jnp.asarray(unnorm))
    tx, tp, tu = tcoda.update_pi_hat_column(
        torch.from_numpy(d), torch.tensor(c), torch.from_numpy(preds),
        torch.from_numpy(unnorm.copy()))
    for t, j in ((tx, jx), (tp, jp), (tu, ju)):
        np.testing.assert_allclose(t.numpy(), np.asarray(j), rtol=1e-5,
                                   atol=1e-7)


@pytest.mark.parametrize("tier", ("incremental", "factored", "rowscan"))
def test_eig_precision_is_highest_on_the_cpu(tier):
    """``high`` and ``default`` run the fp32 products on the CPU, as XLA's
    CPU backend ignores the precision: bitwise the ``highest`` run, and
    no TF32 setting is left on."""
    preds, labels = _task((6, 128, 4))
    runs = [_port_run(preds, labels, 10, 2, eig_mode=tier, eig_precision=p)
            for p in tcoda.PRECISIONS]
    for other in runs[1:]:
        for f, arr in runs[0].arrays.items():
            np.testing.assert_array_equal(arr, other.arrays[f], err_msg=f)
    assert not torch.backends.cuda.matmul.allow_tf32


def test_eig_matmul_precision_splits():
    """Every precision is the fp32 product on the CPU (``high`` is the fp32
    product on the card too; ``default`` alone takes one TF32 pass there),
    and the TF32 switch is restored on the way out of its scope."""
    from coda_tpu_torch.ops.pbest import _tf32_products, eig_matmul

    x = torch.from_numpy(np.random.default_rng(0).normal(
        size=(64, 33)).astype(np.float32))
    y = x.T.contiguous()
    for p in tcoda.PRECISIONS:
        assert torch.equal(eig_matmul(x, y, p), x @ y)
    with _tf32_products():
        assert torch.backends.cuda.matmul.allow_tf32
    assert not torch.backends.cuda.matmul.allow_tf32


# -- the prefilter and the q ablations -------------------------------------------

@pytest.mark.parametrize("knobs", [
    dict(prefilter_n=24), dict(prefilter_n=24, eig_mode="rowscan"),
    dict(prefilter_n=500), dict(q="iid"), dict(q="uncertainty"),
    dict(q="iid", prefilter_n=16), dict(q="uncertainty", prefilter_n=16)])
def test_prefilter_and_ablations_match_reference(knobs):
    """The prefilter's masked-uniform subset (a stable descending sort for
    ``lax.top_k``) and the ablations draw the reference's bits: 3 seeds x
    30 rounds pick the same items."""
    preds, labels = _task((6, 128, 4))
    ref = _reference_run(preds, labels, 30, 3, eig_chunk=1024, **knobs)
    got = _port_run(preds, labels, 30, 3, eig_chunk=1024, **knobs)
    _assert_triaged(got, ref)
    np.testing.assert_array_equal(got.arrays["chosen_idx"],
                                  ref.arrays["chosen_idx"])
    np.testing.assert_array_equal(got.arrays["stochastic"],
                                  ref.arrays["stochastic"])


def test_prefilter_falls_back_to_the_full_pool():
    """Once every disagreement point is labeled the reference scores the
    whole unlabeled pool (its lax.cond); the port's batched form takes each
    replica's own branch."""
    rng = np.random.default_rng(4)
    preds = rng.dirichlet(np.ones(3), (5, 40)).astype(np.float32)
    labels = rng.integers(0, 3, 40)
    # past item 6 every model predicts the label, each with its own
    # confidence: no disagreement there, scores still distinct
    logits = rng.normal(size=(5, 34, 3)) + 4.0 * np.eye(3)[labels[6:]]
    p = np.exp(logits)
    preds[:, 6:] = (p / p.sum(-1, keepdims=True)).astype(np.float32)
    kw = dict(prefilter_n=4, eig_chunk=1024)
    ref = _reference_run(preds, labels, 12, 3, **kw)
    got = _port_run(preds, labels, 12, 3, **kw)
    np.testing.assert_array_equal(got.arrays["chosen_idx"][:, :6],
                                  ref.arrays["chosen_idx"][:, :6])
    _assert_triaged(got, ref)


# -- refusals and the CLI ---------------------------------------------------------

REFUSALS = [
    dict(posterior="sparse:2", eig_mode="factored"),
    dict(eig_pbest="amortized", eig_mode="rowscan"),
    dict(eig_mode="direct", eig_precision="high"),
    dict(eig_mode="direct", eig_entropy="approx"),
    dict(eig_mode="incremental", q="iid"),
    dict(eig_mode="incremental", prefilter_n=8),
    dict(pi_update="bogus"), dict(eig_pbest="bogus"),
    dict(eig_precision="bogus"), dict(posterior="sparse:0"),
    dict(posterior="topk")]


@pytest.mark.parametrize("knobs", REFUSALS)
def test_refusals_raise_the_reference_text(knobs):
    from coda_tpu.selectors import CODAHyperparams as JHP
    from coda_tpu.selectors import make_coda as jmake

    preds, _ = _task((6, 128, 4))
    with pytest.raises(ValueError) as want:
        jmake(preds, JHP(**knobs))
    with pytest.raises(ValueError) as got:
        tcoda.make_coda(preds, tcoda.CODAHyperparams(**knobs), device="cpu")
    assert str(got.value) == str(want.value)


def test_fused_refusals():
    """The fused refresh off the incremental tier, with batched seeds or
    with the amortized tables raises ``ValueError``."""
    preds, _ = _task((6, 128, 4))
    for kw in (dict(eig_refresh="fused", eig_mode="factored"),
               dict(eig_refresh="fused", n_parallel=2),
               dict(eig_refresh="fused", eig_pbest="amortized")):
        with pytest.raises(ValueError, match="fused"):
            tcoda.make_coda(preds, tcoda.CODAHyperparams(**kw), device="cpu")


CLI_KNOBS = [
    ["--eig-mode", m] for m in ("auto", "incremental", "factored", "rowscan",
                                "direct")] + [
    ["--eig-precision", p] for p in ("highest", "high", "default")] + [
    ["--posterior", "sparse:2"], ["--posterior", "sparse:4"],
    ["--eig-pbest", "amortized"], ["--pi-update", "exact"],
    ["--pi-update", "delta"], ["--prefilter-n", "16"], ["--q", "iid"],
    ["--q", "uncertainty"], ["--eig-backend", "jnp"],
    ["--eig-cache-dtype", "bfloat16"], ["--eig-entropy", "approx"],
    ["--eig-refresh", "fused"], ["--no-diag-prior"]]


@pytest.mark.parametrize("knob", CLI_KNOBS, ids=lambda k: "=".join(k))
def test_cli_runs_every_reference_knob(knob, capsys):
    """Each value of the reference CLI's CODA flags runs the port's CLI on
    the CPU at a small shape, 3 seeds batched (fused: one after
    another)."""
    from coda_tpu_torch.cli import main

    assert main(["--synthetic", "6,64,4", "--method", "coda", "--iters",
                 "4", "--seeds", "3", "--device", "cpu", "--no-mlflow"]
                + knob) == 0
    out = capsys.readouterr().out
    assert "seed 2: regret@4=" in out


@pytest.mark.parametrize("knob,where", [
    (["--eig-scorer", "surrogate:8"], "slice 4"),
    (["--surrogate-prior", "pool"], "slice 4"),
    (["--mesh", "model=2"], "slice 5")])
def test_cli_later_slice_flags_raise(knob, where, tmp_path):
    """``--mesh`` with a model axis runs since slice 5 ported both axes:
    without its ranks it raises the reference's "needs" error, and on a
    one-rank model axis the surrogate scorer runs too (since slice 5d).
    The slice 4 flags run now: ``--eig-scorer surrogate:8``, and
    ``--surrogate-prior pool`` with it; ``pool`` alone is the reference's
    refusal."""
    from coda_tpu_torch.cli import main

    argv = ["--synthetic", "6,64,4", "--method", "coda", "--iters", "2",
            "--seeds", "1", "--device", "cpu", "--no-mlflow"] + knob
    if where == "slice 5":
        with pytest.raises(ValueError, match="mesh 1x2 needs 2 ranks"):
            main(argv)
        assert main(argv[:-1] + ["model=1", "--eig-scorer",
                                 "surrogate:8"]) == 0
        return
    if knob[0] == "--surrogate-prior":
        with pytest.raises(ValueError, match="eig_scorer='exact' carries"):
            main(argv)
        argv += ["--eig-scorer", "surrogate:8"]
    assert main(argv) == 0


@pytest.mark.parametrize("knob", [["--acq-batch", "0"],
                                  ["--oracle-reliability", "vote"]])
def test_cli_refuses_unported_flags(knob, capsys):
    """Flags are parsed with the reference's validators: ``--acq-batch``
    at least 1, ``--oracle-reliability`` learned or majority (the crowd
    oracle's flags are parsed since it was ported)."""
    from coda_tpu_torch.cli import main

    with pytest.raises(SystemExit) as exc:
        main(["--synthetic", "6,64,4", "--method", "coda", "--iters", "2",
              "--seeds", "1", "--device", "cpu"] + knob)
    assert exc.value.code == 2
    err = capsys.readouterr().err
    assert ("acq-batch must be >= 1, got 0" in err if knob[0] ==
            "--acq-batch" else "invalid choice: 'vote'" in err)


def test_cli_headline_resolves_factored():
    """The paper's command at the headline (``--seeds`` defaults to 5, one
    batch): the port resolves the factored tier, as the reference's
    resolver does for the same arguments. No allocation."""
    from coda_tpu.selectors import CODAHyperparams as JHP
    from coda_tpu.selectors.coda import resolve_eig_mode as jresolve
    from coda_tpu_torch.cli import hyperparams, parse_args

    shape = (1000, 50_000, 10)
    hp = hyperparams(parse_args(["--synthetic", "1000,50000,10",
                                 "--method", "coda"]))
    assert hp.n_parallel == 5
    assert tcoda.resolve_eig_mode(hp, *shape) == "factored" == jresolve(
        JHP(n_parallel=5), *shape)
