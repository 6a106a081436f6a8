"""The crowd oracle in the port (``coda_tpu_torch/crowd``) against the JAX
reference (``coda_tpu/crowd``) on the CPU.

Inputs are seeded synthetic tasks (``make_synthetic_arrays``) or seeded
numpy draws, through both packages. Tolerances:

  * the spec parser, the annotator pool, the host sampler and the vote
    draws (ids, responses, abstentions over seeds 0-63): equal;
  * ``aggregate_votes`` on the same inputs: the label equal; the weight
    within 2 ulp of the log-likelihood's scale, ``e = 2 * 2^-24 * (sum_v
    |log conf| + log(1 + V))`` times the weight (the weight is a softmax of
    log-likelihoods; the port's ``log`` and ``exp`` differ from XLA's in
    the last bit, and the difference of two log-likelihoods carries it);
    the counts within 2 ulp plus V times ``e`` (each vote adds the teach
    distribution, a softmax of the same log-likelihoods);
  * the weighted update: w = 1 bitwise ``update`` (one label, q-wide and
    seed-batched), w = 0 leaves the posterior bitwise;
  * the crowd loop at the reference's robustness spec: the port's
    ``compare_records`` at the cross-backend contract (2.34e-4) finds
    every seed at parity with a fresh reference capture, or first
    diverging at a ``tie-break-flip`` whose runner-up gap is at most
    2.34e-4, with the rounds before it the reference's decisions and crowd
    labels exactly and its weights within 1e-6; a seed batch is bitwise
    its seeds run one after another; a clean spec is bitwise the plain
    engine.
"""

from __future__ import annotations

import argparse
import os

import numpy as np
import pytest
import torch

try:
    import jax
    import jax.numpy as jnp
except ImportError:  # a card machine without JAX runs the gpu cases only
    jax = jnp = None

from coda_tpu_torch import random as trandom
from coda_tpu_torch.crowd import loop as tloop
from coda_tpu_torch.crowd import oracle as toracle
from coda_tpu_torch.crowd import reliability as trel
from coda_tpu_torch.engine import replay as treplay
from coda_tpu_torch.selectors import coda as tcoda
from coda_tpu_torch.telemetry.recorder import (
    CROSS_BACKEND_SCORE_TOL as TOL,
    RunRecord,
)

# the reference's robustness specs (scripts/bench_robustness.py)
NOISY_SPEC = ("annotators=8,votes=3,acc=0.6:0.95,abstain=0.1,"
              "adversarial=1,trust=16,seed=0")
RELIABILITY_SPEC = ("annotators=8,votes=3,acc=0.55:0.95,abstain=0.05,"
                    "adversarial=2,trust=24,seed=1")
SPECS = (NOISY_SPEC, RELIABILITY_SPEC,
         "annotators=3,votes=5,acc=0.7,seed=4",
         "annotators=6,votes=2,abstain=0.4,reliability=majority,seed=9")
SHAPE = (8, 256, 4)         # the robustness bench's synthetic task
SEEDS, ROUNDS = 3, 40

needs_jax = pytest.mark.skipif(jax is None, reason="needs the JAX reference")


@pytest.fixture(autouse=True)
def _one_torch_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _jcrowd():
    from coda_tpu.crowd import loop, oracle, reliability

    return oracle, reliability, loop


# -- spec, pool, host sampler -------------------------------------------------

@needs_jax
@pytest.mark.parametrize("spec", (None, "clean") + SPECS + (
    "annotators=6,votes=3,acc=0.6:0.9,abstain=0.1,adversarial=2,trust=16,"
    "defer=0.2:5,reliability=majority,seed=7", "defer=0.3"))
def test_reference_spec_and_pool(spec):
    """The parsed config, the planted accuracies and the (A, C, C) pool
    equal the reference's, bitwise."""
    jo, _, _ = _jcrowd()
    jc, tc = jo.parse_oracle_spec(spec), toracle.parse_oracle_spec(spec)
    assert tuple(tc) == tuple(jc)
    np.testing.assert_array_equal(toracle.planted_accuracies(tc),
                                  jo.planted_accuracies(jc))
    for C in (2, 4, 10):
        got = toracle.make_annotators(tc, C, device="cpu")
        assert got.dtype == torch.float32
        np.testing.assert_array_equal(got.numpy(),
                                      np.asarray(jo.make_annotators(jc, C)))


@needs_jax
@pytest.mark.parametrize("bad", ["bogus=1", "reliability=vote",
                                 "annotators=0", "votes=0",
                                 "annotators=2,adversarial=2", "abstain=1.5",
                                 "defer=1.0", "votes", "acc=x"])
def test_reference_spec_errors(bad):
    """Every spec the reference refuses, the port refuses with the same
    message."""
    jo, _, _ = _jcrowd()
    with pytest.raises(ValueError) as want:
        jo.parse_oracle_spec(bad)
    with pytest.raises(ValueError) as got:
        toracle.parse_oracle_spec(bad)
    assert str(got.value) == str(want.value)


@needs_jax
@pytest.mark.parametrize("spec", [
    "annotators=4,votes=1,abstain=0.3,defer=0.4:3,seed=5", NOISY_SPEC,
    "clean"])
def test_reference_host_sampler(spec):
    """``HostCrowdSampler.answer`` is the reference's dict over sessions,
    rounds, slots, attempts and true labels."""
    jo, _, _ = _jcrowd()
    C = 4
    js = jo.HostCrowdSampler(jo.parse_oracle_spec(spec), C)
    ts = toracle.HostCrowdSampler(toracle.parse_oracle_spec(spec), C)
    np.testing.assert_array_equal(ts.confusions, js.confusions)
    for sess in ("s0", "alpha", "7"):
        for r in range(6):
            for slot in range(3):
                for attempt in range(3):
                    z = (r + slot) % C
                    assert ts.answer(sess, r, slot, z, attempt) == \
                        js.answer(sess, r, slot, z, attempt)


# -- vote draws ---------------------------------------------------------------

@needs_jax
@pytest.mark.parametrize("spec", SPECS)
def test_reference_sample_votes(spec):
    """Annotator ids, responses and abstentions equal the reference's over
    seeds 0-63 and every true class; the run-wide batched draws
    (``oracle.draw_votes`` over a batch of keys) are the per-key draws."""
    jo, _, _ = _jcrowd()
    jc, tc = jo.parse_oracle_spec(spec), toracle.parse_oracle_spec(spec)
    C = 5
    jconf = jo.make_annotators(jc, C)
    tconf = toracle.make_annotators(tc, C, device="cpu")
    keys = torch.stack([trandom.PRNGKey(s) for s in range(64)])
    draws = toracle.draw_votes(keys, tc, C)
    for s in range(64):
        z = s % C
        want = jo.sample_votes(jax.random.PRNGKey(s), jconf, z, jc)
        got = toracle.sample_votes(trandom.PRNGKey(s), tconf, z, tc)
        for w, g in zip(want, got):
            np.testing.assert_array_equal(g.numpy(), np.asarray(w))
        # the draws of the batch of keys
        np.testing.assert_array_equal(draws.ann_ids[s].numpy(),
                                      got[0].numpy())
        np.testing.assert_array_equal(draws.answered[s].numpy(),
                                      got[2].numpy())


@needs_jax
def test_reference_round_votes_salted():
    """A round's crowd key is ``fold_in(k, CROWD_SALT + j)``: the q answers
    of a round drawn by ``run_draws`` are the reference's ``sample_votes``
    at those keys."""
    jo, _, _ = _jcrowd()
    jc, tc = (jo.parse_oracle_spec(NOISY_SPEC),
              toracle.parse_oracle_spec(NOISY_SPEC))
    C, q = 4, 3
    jconf = jo.make_annotators(jc, C)
    lconf = toracle.log_confusions(
        toracle.make_annotators(tc, C, device="cpu"))
    keys = trandom.split(trandom.PRNGKey(11), 20)            # (T, 2)
    draws = tloop.run_draws(keys, tc, C, q, "cpu")            # (T, q, V)
    jkeys = jax.random.split(jax.random.PRNGKey(11), 20)
    for t in range(20):
        for j in range(q):
            k = jax.random.fold_in(jkeys[t], jo.CROWD_SALT + j)
            want = jo.sample_votes(k, jconf, (t + j) % C, jc)
            d = tloop._round(tloop._round(draws, t), j)
            resp = toracle.votes_from_draws(d, lconf,
                                            torch.tensor((t + j) % C))
            np.testing.assert_array_equal(d.ann_ids.numpy(),
                                          np.asarray(want[0]))
            np.testing.assert_array_equal(resp.numpy(), np.asarray(want[1]))
            np.testing.assert_array_equal(d.answered.numpy(),
                                          np.asarray(want[2]))


# -- aggregation --------------------------------------------------------------

def _ulps(a, b) -> np.ndarray:
    a = np.asarray(a, np.float32).view(np.int32).astype(np.int64)
    b = np.asarray(b, np.float32).view(np.int32).astype(np.int64)
    return np.abs(a - b)


def _weight_tol(counts, ann, resp, w) -> float:
    """``e * w`` of the module docstring."""
    conf = counts / counts.sum(-1, keepdims=True)
    ll = np.abs(np.log(conf[ann, :, resp])).sum(0).max()
    return 2 * 2.0 ** -24 * (ll + np.log1p(len(ann))) * float(w)


@needs_jax
@pytest.mark.parametrize("spec,C,dup", [
    (NOISY_SPEC, 4, False), (NOISY_SPEC, 10, False),
    (RELIABILITY_SPEC, 4, False), (SPECS[3], 4, False),
    ("annotators=2,votes=4,acc=0.9,trust=4,seed=2", 3, True),
    ("annotators=1,votes=3,acc=0.8,abstain=0.2,trust=6,seed=3", 4, True)])
def test_reference_aggregate_votes(spec, C, dup):
    """300 rounds, each aggregating the same votes on the reference's
    posterior in both packages: the label equal, the counts within 2 ulp,
    the weight within its tolerance (module docstring). ``dup`` pools
    (one or two annotators) draw the same (annotator, response) pair
    twice in most rounds: the M-step's order counts there."""
    jo, jr, _ = _jcrowd()
    jc, tc = jo.parse_oracle_spec(spec), toracle.parse_oracle_spec(spec)
    conf = jo.make_annotators(jc, C)
    agg = jax.jit(lambda rel, a, r, s: jr.aggregate_votes(rel, a, r, s, jc))
    rel = jr.init_reliability(jc, C)
    dups = 0
    for s in range(300):
        ann, resp, ans = jo.sample_votes(jax.random.PRNGKey(s), conf, s % C,
                                         jc)
        ann, resp, ans = (np.asarray(x) for x in (ann, resp, ans))
        pairs = [(a, r) for a, r, k in zip(ann, resp, ans) if k]
        dups += len(pairs) != len(set(pairs))
        counts = np.array(rel.counts)
        trel_in = trel.ReliabilityState(
            torch.from_numpy(counts.copy()),
            torch.tensor(float(rel.n_votes)))
        label, w, rel = agg(rel, ann, resp, ans)
        tl, tw, trel_out = trel.aggregate_votes(
            trel_in, torch.from_numpy(ann.astype(np.int64)),
            torch.from_numpy(resp.astype(np.int64)),
            torch.from_numpy(ans.copy()), tc)
        assert int(tl) == int(label), s
        e = _weight_tol(counts, ann, resp, 1.0)
        assert abs(float(tw) - float(w)) <= e * float(w), s
        want_c = np.asarray(rel.counts)
        assert (np.abs(trel_out.counts.numpy() - want_c)
                <= 2 * np.spacing(want_c) + len(ann) * e).all(), s
        assert float(trel_out.n_votes) == float(rel.n_votes)
        # the input state is left as it was
        np.testing.assert_array_equal(trel_in.counts.numpy(), counts)
    assert dups > (100 if dup else -1)


@needs_jax
def test_reference_annotator_accuracy_and_movement():
    jo, jr, _ = _jcrowd()
    rng = np.random.default_rng(0)
    counts = rng.uniform(0.5, 9.0, (6, 5, 5)).astype(np.float32)
    want = jr.annotator_accuracy(jr.ReliabilityState(
        jnp.asarray(counts), jnp.float32(0)))
    got = trel.annotator_accuracy(trel.ReliabilityState(
        torch.from_numpy(counts), torch.zeros(())))
    assert _ulps(got.numpy(), want).max() <= 2
    prev = rng.uniform(0, 1, 6).astype(np.float32)
    assert trel.accuracy_movement(torch.from_numpy(prev), got) == \
        pytest.approx(jr.accuracy_movement(prev, want), abs=1e-7)


def _learned_pool(spec, C, rounds, key_seed):
    """The bench_robustness reliability recovery in the port: each round a
    true class and votes from ``fold``-split keys, the posterior fed its
    own aggregated votes. Returns (learned (A,), planted diagonal (A,),
    cfg)."""
    cfg = toracle.parse_oracle_spec(spec)
    conf = toracle.make_annotators(cfg, C, device="cpu")
    rel = trel.init_reliability(cfg, C, device="cpu")
    keys = trandom.split(trandom.PRNGKey(key_seed), rounds)
    for t in range(rounds):
        k_z, k_votes = trandom.split(keys[t])
        z = trandom.randint(k_z, (), 0, C)
        ann, resp, ans = toracle.sample_votes(k_votes, conf, z, cfg)
        _, _, rel = trel.aggregate_votes(rel, ann, resp, ans, cfg)
    learned = trel.annotator_accuracy(rel).numpy()
    planted = torch.diagonal(conf, dim1=-2, dim2=-1).mean(-1).numpy()
    return learned, planted, cfg


def test_port_ds_recovers_planted_confusions():
    """The reference's robustness check (ROBUSTNESS_CPU_r18.json
    ``reliability``): 400 rounds at its spec, corr >= 0.8 and mae <= 0.25
    against the planted diagonals, every adversary below every honest
    annotator."""
    learned, planted, cfg = _learned_pool(RELIABILITY_SPEC, 4, 400, 7)
    honest = np.arange(cfg.annotators) < cfg.annotators - cfg.adversarial
    corr = float(np.corrcoef(learned, planted)[0, 1])
    mae = float(np.abs(learned - planted).mean())
    assert corr >= 0.8 and mae <= 0.25, (corr, mae, learned, planted)
    assert learned[~honest].max() < learned[honest].min()


@needs_jax
def test_reference_ds_recovery_matches():
    """The same recovery in the reference's loop: the learned accuracies
    agree with the port's within 1e-5."""
    jo, jr, _ = _jcrowd()
    cfg = jo.parse_oracle_spec(RELIABILITY_SPEC)
    conf = jo.make_annotators(cfg, 4)

    def step(rel, key):
        k_z, k_votes = jax.random.split(key)
        z = jax.random.randint(k_z, (), 0, 4, dtype=jnp.int32)
        ann, resp, ans = jo.sample_votes(k_votes, conf, z, cfg)
        return jr.aggregate_votes(rel, ann, resp, ans, cfg)[2], None

    keys = jax.random.split(jax.random.PRNGKey(7), 150)
    rel, _ = jax.lax.scan(step, jr.init_reliability(cfg, 4), keys)
    learned, _, _ = _learned_pool(RELIABILITY_SPEC, 4, 150, 7)
    np.testing.assert_allclose(learned, np.asarray(jr.annotator_accuracy(
        rel)), atol=1e-5)


# -- the weighted update ------------------------------------------------------

def _selector(posterior="dense", **kw):
    from coda_tpu_torch.data import make_synthetic_arrays

    preds = make_synthetic_arrays(seed=1, H=5, N=48, C=4)[0]
    hp = tcoda.CODAHyperparams(eig_chunk=64, num_points=64,
                               posterior=posterior, **kw)
    return tcoda.make_coda(torch.from_numpy(preds), hp, device="cpu")


def _states_equal(a, b) -> None:
    for x, y in zip(torch.utils._pytree.tree_leaves(a),
                    torch.utils._pytree.tree_leaves(b)):
        if isinstance(x, torch.Tensor):
            assert torch.equal(x, y)


@pytest.mark.parametrize("posterior", ["dense", "sparse:2", "sparse:4"])
def test_port_weight_one_bitwise_and_zero_noop(posterior):
    """w = 1 is ``update`` bitwise (one label; q-wide ``update_qw`` with
    ones is ``update_q``; the seed-batched ``update_w`` with ones is
    ``update`` of the batch); w = 0 leaves the posterior bitwise and still
    labels the point."""
    from coda_tpu_torch.selectors.batch import (
        resolve_batch_fns,
        resolve_batch_wfns,
    )

    sel = _selector(posterior)
    rng = np.random.default_rng(3)
    q = 4
    idxs = torch.from_numpy(rng.choice(48, q, replace=False))
    tcs = torch.from_numpy(rng.integers(0, 4, q))
    probs = torch.full((q,), 0.5)
    key = trandom.PRNGKey(0)
    one, zero = torch.ones(()), torch.zeros(())
    _states_equal(sel.update_w(sel.init(key), idxs[0], tcs[0], probs[0],
                               one),
                  sel.update(sel.init(key), idxs[0], tcs[0], probs[0]))
    _, upd_qw = resolve_batch_wfns(sel, q)
    _, upd_q = resolve_batch_fns(sel, q)
    _states_equal(upd_qw(sel.init(key), idxs, tcs, probs, torch.ones(q)),
                  upd_q(sel.init(key), idxs, tcs, probs))
    s0 = sel.init(key)
    post = (s0.sparse if s0.sparse is not None else s0.dirichlets)
    post = [t.clone() for t in torch.utils._pytree.tree_leaves(post)
            if isinstance(t, torch.Tensor)]
    s1 = sel.update_w(s0, idxs[0], tcs[0], probs[0], zero)
    after = (s1.sparse if s1.sparse is not None else s1.dirichlets)
    for x, y in zip(post, [t for t in torch.utils._pytree.tree_leaves(after)
                           if isinstance(t, torch.Tensor)]):
        assert torch.equal(x, y)
    assert not bool(s1.unlabeled[idxs[0]])
    # seed-batched: S = 3 replicas, ones == update, mixed == each replica
    bsel = sel.batched
    S = 3
    ix, tc = idxs[:S], tcs[:S]
    _states_equal(bsel.update_w(bsel.init(S), ix, tc, probs[:S],
                                torch.ones(S)),
                  bsel.update(bsel.init(S), ix, tc, probs[:S]))
    ws = torch.tensor([0.25, 0.0, 0.8])
    batch = bsel.update_w(bsel.init(S), ix, tc, probs[:S], ws)
    for s in range(S):
        one_s = sel.update_w(sel.init(key), ix[s], tc[s], probs[s], ws[s])
        for f in ("pi_hat", "pi_hat_xi", "eig_scores_cached"):
            assert torch.equal(getattr(batch, f)[s], getattr(one_s, f)), f


# -- the crowd loop -----------------------------------------------------------

def _task():
    from coda_tpu_torch.data import make_synthetic_arrays

    H, N, C = SHAPE
    return make_synthetic_arrays(seed=0, H=H, N=N, C=C)[:2]


def _hp(mod, **kw):
    return mod.CODAHyperparams(eig_chunk=1024, n_parallel=SEEDS, **kw)


def _port_run(spec, seeds=SEEDS, rounds=ROUNDS, q=1, sequential=False,
              trace_k=8, **kw):
    import dataclasses

    preds, labels = _task()
    hp = _hp(tcoda, **kw)

    def factory(p):
        sel = tcoda.make_coda(p, hp, device="cpu")
        return dataclasses.replace(sel, batched=None) if sequential else sel

    return tloop.run_seeds_crowd_recorded(
        factory, preds, labels, toracle.parse_oracle_spec(spec),
        iters=rounds, seeds=seeds, trace_k=trace_k, acq_batch=q,
        device="cpu")


def _ref_run(spec, seeds=SEEDS, rounds=ROUNDS, q=1, **kw):
    from coda_tpu.crowd.loop import run_seeds_crowd_recorded
    from coda_tpu.crowd.oracle import parse_oracle_spec
    from coda_tpu.selectors import CODAHyperparams, make_coda

    preds, labels = _task()
    hp = CODAHyperparams(eig_chunk=1024, n_parallel=SEEDS, **kw)
    return run_seeds_crowd_recorded(
        lambda p: make_coda(p, hp), jnp.asarray(preds), jnp.asarray(labels),
        parse_oracle_spec(spec), iters=rounds, seeds=seeds, acq_batch=q)


def _record(out, knobs=None, backend="torch-cpu"):
    res, aux, crowd = out
    return RunRecord.from_result(
        res, aux, {"backend": backend, "knobs": dict(knobs or {})},
        {"iters": ROUNDS}, crowd=crowd)


def _jrecord(out, knobs=None):
    from coda_tpu.telemetry.recorder import RunRecord as JRecord

    res, aux, crowd = out
    return JRecord.from_result(res, aux, {"backend": "cpu",
                                          "knobs": dict(knobs or {})},
                               {"iters": ROUNDS}, crowd=crowd)


def _hold(ref, got):
    """Each seed at parity or first diverging at a near-tie flip; before
    it the reference's decisions, crowd labels and weights."""
    report = treplay.compare_records(ref, got, score_tol=TOL)
    for s in report.seeds:
        T = ref.rounds if s.parity else s.first_divergent_round
        if not s.parity:
            gap = float(ref.arrays["runner_up_gap"][s.seed, T])
            assert s.classification == "tie-break-flip" or (
                ref.acq_batch > 1
                and treplay.first_pick_flip(ref, got, s.seed, T, TOL)
            ), s.to_dict()
            assert abs(gap) <= TOL, (s.to_dict(), gap)
        a, b = ref.seed_arrays(s.seed), got.seed_arrays(s.seed)
        for f in ("chosen_idx", "true_class", "best_model", "oracle_label"):
            np.testing.assert_array_equal(b[f][:T], a[f][:T], err_msg=f)
        np.testing.assert_allclose(b["label_weight"][:T],
                                   a["label_weight"][:T], atol=1e-6)
        np.testing.assert_allclose(b["regret"][:T], a["regret"][:T],
                                   atol=1e-6)
    return report


@pytest.fixture(scope="module")
def port_noisy():
    return _port_run(NOISY_SPEC)


@needs_jax
@pytest.mark.parametrize("q", [1, 4])
def test_reference_crowd_loop_holds(q, port_noisy):
    """3 seeds x 40 rounds on (8, 256, 4) at the reference's noisy spec
    (seeds as one batch at q = 1, one after another at q = 4) against a
    fresh reference capture."""
    got = port_noisy if q == 1 else _port_run(NOISY_SPEC, rounds=10, q=q)
    rounds = ROUNDS if q == 1 else 10
    ref = _ref_run(NOISY_SPEC, rounds=rounds, q=q)
    report = _hold(_record(ref, backend="cpu"), _record(got))
    # the ground-truth labels the votes were drawn for, and the learned
    # accuracies, up to each seed's first divergence
    crowd, jcrowd = got[2], ref[2]
    assert crowd.annotator_accuracy.shape == (SEEDS, rounds, 8)
    for s in report.seeds:
        T = rounds if s.parity else s.first_divergent_round
        np.testing.assert_array_equal(
            crowd.oracle_label[s.seed, :T].numpy(),
            np.asarray(jcrowd.oracle_label)[s.seed, :T])
        np.testing.assert_allclose(
            crowd.annotator_accuracy[s.seed, :T].numpy(),
            np.asarray(jcrowd.annotator_accuracy)[s.seed, :T], atol=1e-6)


def test_port_crowd_batch_is_seeds_in_turn(port_noisy):
    """The seed batch (batched update_w) is bitwise the seeds run one after
    another, the crowd's arrays included."""
    seq = _port_run(NOISY_SPEC, sequential=True)
    for x, y in zip(torch.utils._pytree.tree_leaves(port_noisy),
                    torch.utils._pytree.tree_leaves(seq)):
        assert torch.equal(x, y)
    w = port_noisy[2].label_weight
    assert ((w >= 0) & (w <= 1)).all()
    assert not torch.equal(port_noisy[2].applied_label,
                           port_noisy[2].oracle_label)


def test_port_clean_spec_is_the_engine():
    """A clean config runs the engine's own program: bitwise the plain
    recorded run, with no CrowdAux."""
    from coda_tpu_torch.engine import run_seeds_recorded

    preds, labels = _task()
    hp = _hp(tcoda)
    got = tloop.run_seeds_crowd_recorded(
        lambda p: tcoda.make_coda(p, hp, device="cpu"), preds, labels,
        toracle.parse_oracle_spec("clean"), iters=6, seeds=2, device="cpu")
    want = run_seeds_recorded(
        lambda p: tcoda.make_coda(p, hp, device="cpu"), preds, labels,
        iters=6, seeds=2, device="cpu")
    assert got[2] is None
    for a, b in zip(got[:2], want):
        for x, y in zip(torch.utils._pytree.tree_leaves(a),
                        torch.utils._pytree.tree_leaves(b)):
            assert torch.equal(x, y)
    res, crowd = tloop.run_seeds_crowd(
        lambda p: tcoda.make_coda(p, hp, device="cpu"), preds, labels,
        toracle.parse_oracle_spec("clean"), iters=6, seeds=1, device="cpu")
    assert crowd is None and torch.equal(res.chosen_idx,
                                         want[0].chosen_idx[:1])


def test_port_crowd_needs_a_weighted_update():
    from coda_tpu_torch.selectors import make_iid

    preds, labels = _task()
    with pytest.raises(ValueError, match="update_w"):
        tloop.run_seeds_crowd(lambda p: make_iid(p, device="cpu"), preds,
                              labels, toracle.parse_oracle_spec(NOISY_SPEC),
                              iters=2, seeds=1, device="cpu")


# -- records ------------------------------------------------------------------

@needs_jax
def test_reference_triages_port_crowd_records(port_noisy):
    """The reference's ``compare_records`` reads a port crowd record (and
    the port's a reference one): noisy against clean is the
    ``oracle-noise-envelope`` in both directions and both packages."""
    from coda_tpu.engine.replay import compare_records as jcompare
    from coda_tpu.telemetry.recorder import RunRecord as JRecord
    from coda_tpu_torch.engine import run_seeds_recorded

    preds, labels = _task()
    hp = _hp(tcoda)
    clean = run_seeds_recorded(
        lambda p: tcoda.make_coda(p, hp, device="cpu"), preds, labels,
        iters=ROUNDS, seeds=SEEDS, device="cpu")
    knobs = {"oracle_noise": NOISY_SPEC}
    noisy_rec = _record(port_noisy, knobs)
    clean_rec = _record((*clean, None))
    assert noisy_rec.violations() == []
    for a, b in ((clean_rec, noisy_rec), (noisy_rec, clean_rec)):
        rep = treplay.compare_records(a, b)
        assert {s.classification for s in rep.seeds} == {
            "oracle-noise-envelope"}
        assert "oracle-noise envelope" in treplay.format_triage(rep)
    import tempfile

    with tempfile.TemporaryDirectory() as d:
        noisy_rec.save(os.path.join(d, "noisy"))
        clean_rec.save(os.path.join(d, "clean"))
        ja = JRecord.load(os.path.join(d, "clean"))
        jb = JRecord.load(os.path.join(d, "noisy"))
        assert set(jb.arrays) >= {"oracle_label", "label_weight"}
        jrep = jcompare(ja, jb)
        assert {s.classification for s in jrep.seeds} == {
            "oracle-noise-envelope"}
        env = jrep.meta["oracle_envelope"]
        assert env["oracle_a"] == "clean" and env["oracle_b"] == NOISY_SPEC
        # the other way round: a reference crowd record in the port
        jnoisy = _jrecord(_ref_run(NOISY_SPEC, rounds=8), knobs)
        jnoisy.save(os.path.join(d, "jnoisy"))
        back = RunRecord.load(os.path.join(d, "jnoisy"))
        assert back.violations() == []
        rep = treplay.compare_records(back, clean_rec)
        assert {s.classification for s in rep.seeds} == {
            "oracle-noise-envelope"}


def test_port_crowd_record_replays(tmp_path, capsys):
    """A noisy record from the CLI re-executes bitwise through ``cli
    replay`` on its backend, its crowd arrays too; the CLI refuses an
    override that leaves no honest annotator and ``--checkpoint-dir``."""
    from coda_tpu_torch import cli

    rec = str(tmp_path / "rec")
    base = ["--synthetic", "6,60,3", "--method", "coda", "--iters", "6",
            "--seeds", "2", "--device", "cpu", "--no-mlflow",
            "--oracle-noise", NOISY_SPEC]
    assert cli.main(base + ["--record-dir", rec]) == 0
    record = RunRecord.load(rec)
    assert record.violations() == []
    assert record.meta["fingerprint"]["knobs"]["oracle_noise"] == NOISY_SPEC
    capsys.readouterr()
    assert cli.main(["replay", rec, "--device", "cpu"]) == 0
    assert "verdict: PARITY" in capsys.readouterr().out
    dataset, factory, args = treplay.load_record_environment(record,
                                                             device="cpu")
    again = treplay.replay_record(record, factory, dataset.preds,
                                  dataset.labels, device="cpu")
    for k in ("oracle_label", "label_weight", "chosen_idx"):
        np.testing.assert_array_equal(again[k], record.arrays[k])
    with pytest.raises(SystemExit, match="no honest annotator"):
        cli.main(base + ["--oracle-annotators", "1"])
    with pytest.raises(SystemExit, match="checkpoint-dir"):
        cli.main(base + ["--checkpoint-dir", str(tmp_path / "ck")])
    # a clean spec falls through to the engine: no crowd arrays
    assert cli.main(base[:-1] + ["clean", "--record-dir",
                                 str(tmp_path / "c")]) == 0
    assert "oracle_label" not in RunRecord.load(str(tmp_path / "c")).arrays


def test_port_cli_crowd_config_overrides():
    ns = argparse.Namespace(oracle_noise=NOISY_SPEC, oracle_annotators=5,
                            oracle_reliability="majority")
    from coda_tpu_torch.cli import crowd_config

    cfg = crowd_config(ns)
    assert (cfg.annotators, cfg.reliability) == (5, "majority")
    assert crowd_config(argparse.Namespace(
        oracle_noise=None, oracle_annotators=None,
        oracle_reliability=None)) is None


@pytest.fixture
def cuda():
    """The card, decided inside the test (a skip where there is none)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


@pytest.mark.gpu
def test_port_crowd_on_the_card_is_bitwise_batched(cuda):
    """On the card: the seed batch is bitwise the seeds in turn, and two
    runs of one seed are bitwise equal (the M-step's order is fixed)."""
    import dataclasses

    preds, labels = _task()
    hp = _hp(tcoda)
    cfg = toracle.parse_oracle_spec(NOISY_SPEC)

    def run(sequential=False):
        def factory(p):
            sel = tcoda.make_coda(p, hp, device=cuda)
            return (dataclasses.replace(sel, batched=None) if sequential
                    else sel)
        return tloop.run_seeds_crowd(factory, preds, labels, cfg, iters=20,
                                     seeds=SEEDS, device=cuda)

    a, b, c = run(), run(), run(sequential=True)
    for x, y, z in zip(torch.utils._pytree.tree_leaves(a),
                       torch.utils._pytree.tree_leaves(b),
                       torch.utils._pytree.tree_leaves(c)):
        assert torch.equal(x, y) and torch.equal(x, z)
