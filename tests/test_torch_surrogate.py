"""The contract-gated surrogate scorer (``eig_scorer='surrogate:k'``) and
its cross-session prior (``surrogate_prior='pool'``) in the port against
the JAX reference on the CPU (mirrors ``tests/test_surrogate.py`` and
``tests/test_prior.py``).

Inputs come from seeded numpy generators or the repository's tasks, and
go through both packages. Tolerances:

  * the features, predictions and the refolded normal equations:
    ``rtol=1e-5, atol=1e-6`` (sums over models and items in another
    order); the ridge weights ``rtol=1e-3, atol=1e-5`` (a 16x16 fp32
    solve of a system built from those sums);
  * the gate's verdict, the audit rows, the shortlist, the refusal texts,
    the tier resolution and ``prior_digest``: equal; the ``PriorStats``
    algebra (float64 numpy in both): bitwise;
  * ``surrogate:k`` with ``k >= N``: bitwise the exact scorer's run;
  * trajectories (3 seeds): the port's ``compare_records`` at the
    cross-backend contract (2.34e-4) finds each seed at parity or first
    diverging as a ``tie-break-flip`` at a reference runner-up gap of at
    most 2.34e-4; the fallback flags equal the reference's up to there.
"""

from __future__ import annotations

import os

import numpy as np
import pytest
import torch

try:
    import jax.numpy as jnp
except ImportError:  # a card machine without JAX runs the gpu cases only
    jnp = None

from coda_tpu_torch.engine import replay as treplay
from coda_tpu_torch.engine import run_seeds_compiled, run_seeds_recorded
from coda_tpu_torch.selectors import coda as tcoda
from coda_tpu_torch.selectors import surrogate as tsg
from coda_tpu_torch.telemetry.recorder import (
    CROSS_BACKEND_SCORE_TOL as TOL,
    RunRecord,
)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SEEDS = 3
FEAT = dict(rtol=1e-5, atol=1e-6)


@pytest.fixture(autouse=True)
def _one_torch_thread():
    """Each test on one PyTorch thread, restored after (xdist workers share
    the cores)."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _jsg():
    from coda_tpu.selectors import surrogate as jsg

    return jsg


def _task(name):
    if isinstance(name, tuple):
        from coda_tpu_torch.data import make_synthetic_arrays

        H, N, C = name
        return make_synthetic_arrays(seed=3, H=H, N=N, C=C)[:2]
    d = np.load(os.path.join(ROOT, "data", f"{name}.npz"))
    return d["preds"].astype(np.float32), d["labels"]


def _state(seed=0, N=200, C=12, H=9, q=2):
    """A random carried state's arrays (numpy)."""
    rng = np.random.default_rng(seed)
    pi_xi = rng.uniform(0.05, 1.0, (N, C)).astype(np.float32)
    pi_xi /= pi_xi.sum(-1, keepdims=True)
    pi = pi_xi.mean(0)
    pi = (pi / pi.sum()).astype(np.float32)
    rows = rng.dirichlet(np.ones(H), C).astype(np.float32)
    hyp = np.clip(rows[:, None, :] + rng.normal(0, 0.02, (C, N, H)), 1e-6,
                  1).astype(np.float32)
    return dict(
        prev=rng.normal(0.002, 0.0005, N).astype(np.float32),
        pi_xi=pi_xi.astype(np.float32), pi=pi,
        a=rng.uniform(1, 30, (C, H)).astype(np.float32),
        b=rng.uniform(1, 30, (C, H)).astype(np.float32),
        rows=rows, hyp=hyp,
        hard=rng.integers(0, C, (N, H)).astype(np.int32),
        tcs=rng.integers(0, C, q).astype(np.int32),
        targets=rng.normal(0.002, 0.0005, N).astype(np.float32),
        mask=rng.random(N) < 0.7)


def _t(x):
    """A torch copy of an array (JAX's host arrays are read-only)."""
    return torch.from_numpy(np.array(x))


def _fits(d):
    """The reference's and the port's fits from the same class Betas, with
    the touched rows refreshed."""
    jsg = _jsg()
    jf = jsg.init_fit(jnp.asarray(d["a"]), jnp.asarray(d["b"]))
    tf = tsg.init_fit(_t(d["a"]), _t(d["b"]))
    np.testing.assert_allclose(tf.cls_feats.numpy(),
                               np.asarray(jf.cls_feats), **FEAT)
    at, bt = d["a"][d["tcs"]] * 1.5, d["b"][d["tcs"]] + 2.0
    jf = jsg.refresh_class_feats(jf, jnp.asarray(d["tcs"]), jnp.asarray(at),
                                 jnp.asarray(bt))
    tf = tsg.refresh_class_feats(tf, _t(d["tcs"]), _t(at), _t(bt))
    np.testing.assert_allclose(tf.cls_feats.numpy(),
                               np.asarray(jf.cls_feats), **FEAT)
    return jf, tf


def _features(d, jf, tf, block=64):
    jsg = _jsg()
    jx = jsg.build_features(jnp.asarray(d["prev"]), jnp.asarray(d["pi_xi"]),
                            jnp.asarray(d["pi"]), jf.cls_feats,
                            jnp.asarray(d["rows"]), jnp.asarray(d["hyp"]),
                            jnp.asarray(d["hard"]), jnp.asarray(d["tcs"]))
    tx = tsg.build_features(_t(d["prev"]), _t(d["pi_xi"]), _t(d["pi"]),
                            tf.cls_feats, _t(d["rows"]), _t(d["hyp"]),
                            _t(d["hard"]), _t(d["tcs"]), block=block)
    return jx, tx


@pytest.mark.parametrize("seed,C", [(0, 12), (1, 3), (2, 40)])
def test_features_fit_and_prediction_match_reference(seed, C):
    jsg = _jsg()
    d = _state(seed, C=C)
    jf, tf = _fits(d)
    jx, tx = _features(d, jf, tf, block=37)     # a ragged last block
    np.testing.assert_allclose(tx.numpy(), np.asarray(jx), **FEAT)
    mask = d["mask"]
    for _ in range(3):                              # refold three rounds
        jf = jsg.fold_pairs(jf, jx, jnp.asarray(d["targets"]),
                            jnp.asarray(mask))
        tf = tsg.fold_pairs(tf, tx, _t(d["targets"]), _t(mask))
        mask = ~mask
    for f in ("A", "b", "n"):
        np.testing.assert_allclose(getattr(tf, f).numpy(),
                                   np.asarray(getattr(jf, f)), **FEAT)
    np.testing.assert_allclose(tf.w.numpy(), np.asarray(jf.w), rtol=1e-3,
                               atol=1e-5)
    assert int(tf.fits) == int(jf.fits) == 3
    np.testing.assert_allclose(tsg.predict(tf, tx).numpy(),
                               np.asarray(jsg.predict(jf, jx)), **FEAT)


def test_gate_audit_shortlist_and_hybrid_match_reference():
    """Given the same fit, features and exact scores: the audit rows, the
    shortlist, the gate's verdict on each condition and the hybrid vector
    are the reference's."""
    jsg = _jsg()
    d = _state(4, N=150)
    jf, tf = _fits(d)
    jx, _ = _features(d, jf, tf)
    jf = jsg.fold_pairs(jf, jx, jnp.asarray(d["targets"]),
                        jnp.asarray(d["mask"]))
    tf = tf._replace(**{f: _t(np.asarray(getattr(jf, f)))
                        for f in ("A", "b", "w", "n", "rounds")})
    tx = _t(np.asarray(jx))
    rng = np.random.default_rng(9)
    exact = (np.asarray(jsg.predict(jf, jx))
             + rng.normal(0, 2e-4, 150)).astype(np.float32)
    cand = rng.random(150) < 0.8
    for rounds in (0, 7, 123456):
        jr = jf._replace(rounds=jnp.asarray(rounds, jnp.int32))
        tr = tf._replace(rounds=torch.tensor(rounds, dtype=torch.int32))
        np.testing.assert_array_equal(tsg.audit_rows(tr, 150).numpy(),
                                      np.asarray(jsg.audit_rows(jr, 150)))
        for k in (1, 8, 200):
            want = jsg.propose_shortlist(jr, jx, jnp.asarray(cand), k,
                                         lambda s: jnp.asarray(exact)[s])
            got = tsg.propose_shortlist(tr, tx, _t(cand), k,
                                        lambda s: _t(exact)[s])
            np.testing.assert_array_equal(got[1].numpy(),
                                          np.asarray(want[1]))
            np.testing.assert_array_equal(got[3].numpy(),
                                          np.asarray(want[3]))
            for g, w in zip(got[4], want[4]):
                np.testing.assert_allclose(g.numpy(), np.asarray(w),
                                           rtol=1e-6, atol=1e-9)
            hs, hf, hv = tsg.hybrid_score_pass(tr, tx, _t(cand), k,
                                               lambda s: _t(exact)[s])
            js, jff, jv = jsg.hybrid_score_pass(
                jr, jx, jnp.asarray(cand), k,
                lambda s: jnp.asarray(exact)[s])
            np.testing.assert_allclose(hs.numpy(), np.asarray(js), **FEAT)
            assert bool(hv.violated) == bool(jv.violated)
    # each condition alone, on hand-made inputs
    pred = np.zeros(10, np.float32)
    sel = np.array([0, 1, 2, 3, 4, 5], np.int64)
    for ex, pr in (([1., .9, .8, .7, .5, .1], [0, 0, 0, 0, 0, 0]),
                   ([1., .9, .8, .7, 2., .1], [1., .9, .8, .7, 0, 0]),
                   ([1., .9, .8, .7, .5, .1], [1., .9, .8, .7001, 0, 0])):
        p = pred.copy()
        p[:6] = pr
        p[9] = 0.95
        refreshed = np.zeros(10, bool)
        refreshed[sel] = True
        cand = np.ones(10, bool)
        args = (p, np.asarray(ex, np.float32), sel, 4, cand, refreshed)
        jv = jsg.measure_gate(*(jnp.asarray(a) for a in args[:3]), 4,
                              *(jnp.asarray(a) for a in args[4:]))
        tv = tsg.measure_gate(*(_t(a) for a in args[:3]), 4,
                              *(_t(a) for a in args[4:]))
        for g, w in zip(tv, jv):
            np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-6)


def _cfg(**kw):
    from coda_tpu.selectors import CODAHyperparams

    return (CODAHyperparams(eig_chunk=1024, n_parallel=SEEDS, **kw),
            tcoda.CODAHyperparams(eig_chunk=1024, n_parallel=SEEDS, **kw))


def _records(name, iters, prior=None, **kw):
    from coda_tpu.engine.loop import run_seeds_recorded as jrun
    from coda_tpu.selectors import make_coda

    preds, labels = _task(name)
    jhp, thp = _cfg(**kw)
    tprior = None if prior is None else tsg.PriorStats(*prior)
    ref = RunRecord.from_result(*jrun(
        lambda p: make_coda(p, jhp, prior=prior), jnp.asarray(preds),
        jnp.asarray(labels), iters=iters, seeds=SEEDS), {"b": "jax"}, {})
    got = RunRecord.from_result(*run_seeds_recorded(
        lambda p: tcoda.make_coda(p, thp, device="cpu", prior=tprior),
        preds, labels, iters=iters, seeds=SEEDS, device="cpu"),
        {"b": "torch"}, {})
    return ref, got


def _hold(ref, got):
    report = treplay.compare_records(ref, got, score_tol=TOL)
    for s in report.seeds:
        T = ref.rounds if s.parity else s.first_divergent_round
        if not s.parity:
            gap = float(ref.arrays["runner_up_gap"][s.seed, T])
            assert s.classification == "tie-break-flip", s.to_dict()
            assert abs(gap) <= TOL, (s.to_dict(), gap)
        a, b = ref.seed_arrays(s.seed), got.seed_arrays(s.seed)
        for f in ("chosen_idx", "best_model", "surrogate_fallback"):
            np.testing.assert_array_equal(b[f][:T + 1 if s.parity else T],
                                          a[f][:T + 1 if s.parity else T],
                                          err_msg=f)
    return report


@pytest.mark.parametrize("name,k", [("digits", 16), ("digits", 32),
                                    ((10, 48, 1000), 16)])
def test_trajectory_and_fallbacks_match_reference(name, k):
    """30 rounds (10 warmup, then the gate), 3 seeds one after another;
    the C = 1000 pool at N = 48 reads 8 of its 1000 labels a candidate."""
    ref, got = _records(name, 30, eig_scorer=f"surrogate:{k}")
    _hold(ref, got)
    assert not got.arrays["surrogate_fallback"][:, :10].any()


def test_k_at_least_n_is_the_exact_scorer():
    """``surrogate:k`` with k >= N re-scores every row exactly: every
    round's decisions, scores and digests are the exact scorer's,
    bitwise."""
    preds, labels = _task((6, 40, 4))
    out = {}
    for scorer in ("exact", "surrogate:40", "surrogate:1000"):
        hp = tcoda.CODAHyperparams(eig_scorer=scorer)
        out[scorer] = RunRecord.from_result(*run_seeds_recorded(
            lambda p: tcoda.make_coda(p, hp, device="cpu"), preds, labels,
            iters=20, seeds=2, device="cpu"), {}, {})
    for scorer in ("surrogate:40", "surrogate:1000"):
        for f, v in out["exact"].arrays.items():
            np.testing.assert_array_equal(out[scorer].arrays[f], v,
                                          err_msg=f)


def test_fallback_round_is_the_full_pass_and_counters():
    """Driven round by round: a warmup or fallback round's scores are the
    full exact pass bitwise; a surviving round's pick is an exactly
    scored row; the counters add up."""
    from coda_tpu_torch import random as trandom

    preds, labels = _task("digits")
    hp = tcoda.CODAHyperparams(eig_scorer="surrogate:16", eig_chunk=1024)
    sel = tcoda.make_coda(torch.from_numpy(preds), hp, device="cpu")
    st = sel.init(None)
    key = trandom.PRNGKey(1)
    full_rounds = 0
    for t in range(24):
        key, k = trandom.split(key)
        exact = sel.extras["score_exact"](st)
        res = sel.select(st, k)
        i = int(res.idx)
        assert float(st.eig_scores_cached[i]) == float(exact[i])
        st = sel.update(st, res.idx, torch.tensor(int(labels[i])), res.prob)
        fell = bool(sel.extras["scorer_round_stats"](st))
        if t < tsg.SURROGATE_WARMUP_ROUNDS or fell:
            full_rounds += 1
            assert torch.equal(st.eig_scores_cached,
                               sel.extras["score_exact"](st))
    fit = st.surrogate
    assert int(fit.rounds) == 24
    assert full_rounds == tsg.SURROGATE_WARMUP_ROUNDS + int(fit.fallbacks)
    assert int(fit.fits) == 24 and torch.isfinite(fit.margin)
    scores, fit2 = sel.extras["score_surrogate"](st, torch.tensor([1]))
    assert scores.shape == (preds.shape[1],) and int(fit2.fits) == 25


def test_q_wide_and_sparse_compose_with_the_surrogate():
    """The surrogate under ``--acq-batch 4`` and ``sparse:K`` against the
    reference (10 rounds of 4 labels; 12 rounds sparse)."""
    from coda_tpu.engine.loop import run_seeds_recorded as jrun
    from coda_tpu.selectors import make_coda

    preds, labels = _task((14, 64, 10))
    for kw, q, iters in ((dict(eig_scorer="surrogate:8"), 4, 10),
                         (dict(eig_scorer="surrogate:8",
                               posterior="sparse:3"), 1, 14)):
        jhp, thp = _cfg(**kw)
        ref = RunRecord.from_result(*jrun(
            lambda p: make_coda(p, jhp), jnp.asarray(preds),
            jnp.asarray(labels), iters=iters, seeds=SEEDS, acq_batch=q),
            {}, {})
        got = RunRecord.from_result(*run_seeds_recorded(
            lambda p: tcoda.make_coda(p, thp, device="cpu"), preds, labels,
            iters=iters, seeds=SEEDS, device="cpu", acq_batch=q), {}, {})
        assert treplay.compare_records(ref, got, score_tol=TOL).parity


def _refusal(make, *args, **kw):
    try:
        make(*args, **kw)
    except ValueError as e:
        return str(e)
    raise AssertionError("no refusal")


@pytest.mark.parametrize("kw,prior", [
    (dict(surrogate_prior="pool"), False),
    (dict(eig_scorer="surrogate:8"), True),
    (dict(eig_scorer="surrogate:8", eig_mode="factored"), False),
    (dict(eig_scorer="surrogate:0"), False),
    (dict(eig_scorer="bogus"), False),
    (dict(eig_scorer="surrogate:8", surrogate_prior="warm"), False)])
def test_refusals_have_the_reference_text(kw, prior):
    from coda_tpu.selectors import CODAHyperparams, make_coda

    preds, _ = _task((6, 40, 4))
    p = tsg.empty_prior()._replace(n=1.0) if prior else None
    want = _refusal(make_coda, jnp.asarray(preds), CODAHyperparams(**kw),
                    prior=p)
    got = _refusal(tcoda.make_coda, torch.from_numpy(preds),
                   tcoda.CODAHyperparams(**kw), device="cpu", prior=p)
    assert got == want
    # the port's own: the fused refresh scores inside kernel 6
    with pytest.raises(ValueError, match="eig_refresh='fused'"):
        tcoda.make_coda(torch.from_numpy(preds), tcoda.CODAHyperparams(
            eig_scorer="surrogate:8", eig_refresh="fused"), device="cpu")


@pytest.mark.parametrize("N", [50_000, 60_000, 90_000])
def test_auto_budget_holds_both_ways(N):
    """The surrogate's 6 GiB budget against the exact scorer's 4 GiB (the
    cache and the delta layout, 8 N C H bytes): at (H, C) = (1000, 10) the
    exact scorer leaves the incremental tier past N = 53,687 and the
    surrogate past N = 80,530, as in the reference."""
    from coda_tpu.selectors import CODAHyperparams
    from coda_tpu.selectors.coda import resolve_eig_mode as jresolve

    for kw in (dict(), dict(eig_scorer="surrogate:64"),
               dict(eig_scorer="surrogate:64", eig_cache_dtype="bfloat16"),
               dict(eig_scorer="surrogate:64", n_parallel=2)):
        want = jresolve(CODAHyperparams(**kw), 1000, N, 10)
        assert tcoda.resolve_eig_mode(tcoda.CODAHyperparams(**kw), 1000, N,
                                      10) == want
    exact = tcoda.resolve_eig_mode(tcoda.CODAHyperparams(), 1000, N, 10)
    sur = tcoda.resolve_eig_mode(tcoda.CODAHyperparams(
        eig_scorer="surrogate:64"), 1000, N, 10)
    assert (exact, sur) == {50_000: ("incremental", "incremental"),
                            60_000: ("factored", "incremental"),
                            90_000: ("factored", "factored")}[N]


def _rand_prior(seed, rounds=12.0):
    rng = np.random.default_rng(seed)
    F = tsg.N_FEATURES
    M = rng.normal(size=(F, F))
    return tsg.PriorStats(A=M @ M.T, b=rng.normal(size=F),
                          n=float(rng.uniform(10, 500)), rounds=rounds,
                          sessions=1.0)


def _same(p, q):
    return (np.asarray(p.A).tobytes() == np.asarray(q.A).tobytes()
            and np.asarray(p.b).tobytes() == np.asarray(q.b).tobytes()
            and (p.n, p.rounds, p.sessions) == (q.n, q.rounds, q.sessions))


def test_prior_algebra_and_digest_match_reference():
    jsg = _jsg()
    ps = [_rand_prior(s, rounds=4.0 * s) for s in range(4)]
    js = [jsg.PriorStats(*p) for p in ps]
    pairs = ((tsg.merge_fits(ps[0], ps[1]), jsg.merge_fits(js[0], js[1])),
             (tsg.merge_many(ps), jsg.merge_many(js)),
             (tsg.scale_prior(ps[2], 0.3), jsg.scale_prior(js[2], 0.3)),
             (tsg.clip_prior(ps[3], 50.0), jsg.clip_prior(js[3], 50.0)),
             (tsg.fold_prior(ps[1], ps[2]), jsg.fold_prior(js[1], js[2])),
             (tsg.empty_prior(), jsg.empty_prior()),
             (tsg.prior_from_fit(ps[0].A, ps[0].b, ps[0].n, 3),
              jsg.prior_from_fit(js[0].A, js[0].b, js[0].n, 3)),
             (tsg.prior_from_fit(ps[0].A, ps[0].b, 0.0, 3),
              jsg.prior_from_fit(js[0].A, js[0].b, 0.0, 3)),
             (tsg.prior_from_dict(tsg.prior_to_dict(ps[3])),
              jsg.prior_from_dict(jsg.prior_to_dict(js[3]))))
    for p, q in pairs:
        assert _same(p, q)
        assert tsg.prior_digest(p) == jsg.prior_digest(q)
        assert tsg.prior_warmup_credit(p) == jsg.prior_warmup_credit(q)
    assert _same(tsg.merge_fits(ps[0], ps[1]), tsg.merge_fits(ps[1], ps[0]))
    assert _same(tsg.merge_fits(tsg.empty_prior(), ps[2]), ps[2])
    assert tsg.prior_to_dict(ps[1]) == jsg.prior_to_dict(js[1])
    # the committed record's digest is the reference's for the same arrays
    from coda_tpu_torch.convert import prior_from_numpy

    assert tsg.prior_digest(prior_from_numpy(js[2])) == jsg.prior_digest(
        js[2])
    # a seeded fit: the prior's equations, the ridge, the warmup credit
    d = _state(5)
    jf, tf = _fits(d)
    jseed, tseed = jsg.seed_fit(jf, js[2]), tsg.seed_fit(tf, ps[2])
    for f in ("A", "b", "n", "prior_rounds"):
        np.testing.assert_array_equal(getattr(tseed, f).numpy(),
                                      np.asarray(getattr(jseed, f)))
    np.testing.assert_allclose(tseed.w.numpy(), np.asarray(jseed.w),
                               rtol=1e-3, atol=1e-5)
    assert tsg.seed_fit(tf, tsg.empty_prior()) is tf
    assert tsg.gate_pressure(None) == jsg.gate_pressure(None) == 0.0
    for m in (-1e-4, 0.0, 1e-4, 5e-4, float("nan")):
        assert tsg.gate_pressure(m) == jsg.gate_pressure(m)


def test_seeded_run_matches_reference_and_skips_warmup():
    """A pool-seeded run (the prior from a donor run's fit) against the
    reference's from the same prior: the same warmup credit, decisions and
    fallback flags; the donor's prior has the reference's digest when its
    fit does."""
    jsg = _jsg()
    preds, labels = _task("digits")
    hp = tcoda.CODAHyperparams(eig_scorer="surrogate:16", eig_chunk=1024)
    donor = tcoda.make_coda(torch.from_numpy(preds), hp, device="cpu")
    res = run_seeds_compiled(lambda p: donor, preds, labels, iters=16,
                             seeds=1, device="cpu")
    assert res.chosen_idx.shape == (1, 16)
    fit = donor.init(None).surrogate
    pool = tsg.clip_prior(tsg.prior_from_fit(
        fit.A + 1.0 + torch.eye(16), fit.b + 0.5, 40.0, 16))
    jpool = jsg.PriorStats(*pool)
    assert tsg.prior_digest(pool) == jsg.prior_digest(jpool)
    assert tsg.prior_warmup_credit(pool) == tsg.SURROGATE_WARMUP_ROUNDS
    ref, got = _records("digits", 16, prior=jpool,
                        eig_scorer="surrogate:16", surrogate_prior="pool")
    _hold(ref, got)


def _committed(name):
    return os.path.join(ROOT, "runs", name)


@pytest.mark.parametrize("a,b", [("surrogate_r17/surrogate",
                                  "surrogate_r17/exact"),
                                 ("prior_r18/cold", "prior_r18/seeded"),
                                 ("prior_r18/off", "prior_r18/seeded"),
                                 ("prior_r18/cold", "prior_r18/off"),
                                 ("surrogate_r17/surrogate",
                                  "prior_r18/seeded")])
def test_committed_records_triage_as_the_reference(a, b):
    from coda_tpu.engine import replay as jreplay
    from coda_tpu.telemetry.recorder import RunRecord as JRecord

    ja, jb = JRecord.load(_committed(a)), JRecord.load(_committed(b))
    ta, tb = RunRecord.load(_committed(a)), RunRecord.load(_committed(b))
    tol = jreplay._auto_tol(ja, {}, against=jb)
    assert treplay._auto_tol(ta, {}, against=tb) == tol
    want = jreplay.compare_records(ja, jb, score_tol=tol)
    got = treplay.compare_records(ta, tb, score_tol=tol)
    assert got.to_dict() == want.to_dict()
    assert treplay.format_triage(got) == jreplay.format_triage(want)


def test_port_surrogate_record_against_the_committed_ones(tmp_path):
    """The port CLI's ``surrogate:32`` digits record (3 seeds x 100
    rounds): held to the committed surrogate record by the triage, and to
    the committed exact one by the scorer envelope, as the reference
    holds its own; the prior's envelope bound read as the reference's."""
    from coda_tpu_torch.cli import main

    out = str(tmp_path / "sur")
    assert main(["--task", "digits", "--data-dir", os.path.join(ROOT, "data"),
                 "--method", "coda", "--iters", "100", "--seeds", "3",
                 "--eig-chunk", "1024", "--eig-scorer", "surrogate:32",
                 "--no-mlflow", "--record-dir", out, "--device", "cpu"]) == 0
    mine = RunRecord.load(out)
    assert mine.violations() == []
    ref = RunRecord.load(_committed("surrogate_r17/surrogate"))
    report = treplay.compare_records(ref, mine, score_tol=TOL)
    for s in report.seeds:
        if not s.parity:
            gap = float(ref.arrays["runner_up_gap"][s.seed,
                                                    s.first_divergent_round])
            assert s.classification == "tie-break-flip", s.to_dict()
            assert abs(gap) <= TOL
    env = treplay.compare_records(RunRecord.load(
        _committed("surrogate_r17/exact")), mine)
    assert all(s.classification == "eig-scorer-envelope" for s in env.seeds)
    cold = RunRecord.load(_committed("prior_r18/cold"))
    seeded = RunRecord.load(_committed("prior_r18/seeded"))
    assert treplay.within_prior_envelope(
        float(cold.arrays["cumulative_regret"][:, -1].mean()),
        float(seeded.arrays["cumulative_regret"][:, -1].mean()))


@pytest.mark.gpu
def test_fallback_rounds_on_card_score_as_exact_rounds():
    """On the card a full surrogate round (warmup or fallback: the row
    written, then kernel 1) gives bitwise the scores of the exact scorer's
    round on the same labels (the row written by kernel 2, which shares
    kernel 1's scoring pass); the surrogate's divisions by a count are one
    IEEE division, bitwise the host's."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    from coda_tpu_torch import random as trandom

    preds, labels = _task("digits")
    sels = {s: tcoda.make_coda(torch.from_numpy(preds), tcoda.CODAHyperparams(
        eig_scorer=s, eig_chunk=1024), device="cuda")
        for s in ("surrogate:32", "exact")}
    st = {s: sel.init(None) for s, sel in sels.items()}
    assert torch.equal(st["surrogate:32"].eig_scores_cached,
                       st["exact"].eig_scores_cached)
    key, full = trandom.PRNGKey(2), 0
    for t in range(40):
        key, k = trandom.split(key)
        res = sels["surrogate:32"].select(st["surrogate:32"], k)
        tc = torch.tensor(int(labels[int(res.idx)]), device="cuda")
        for s, sel in sels.items():
            st[s] = sel.update(st[s], res.idx, tc, res.prob)
        if t < tsg.SURROGATE_WARMUP_ROUNDS or bool(
                st["surrogate:32"].surrogate.last_fallback):
            full += 1
            assert torch.equal(st["surrogate:32"].eig_scores_cached,
                               st["exact"].eig_scores_cached), t
    assert full >= tsg.SURROGATE_WARMUP_ROUNDS
    rng = np.random.default_rng(0)
    for n in (3, 9, 16, 500, 1000, 2 ** 0.5):
        x = torch.from_numpy(rng.uniform(0, 50, 4096).astype(np.float32))
        want = x / torch.tensor(n, dtype=torch.float32)
        assert torch.equal(tsg._div(x.cuda(), n).cpu(), want)
