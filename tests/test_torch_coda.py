"""The port's CODA selector and engine against the JAX reference on the CPU.

The whole slice: ``coda_tpu_torch`` ``run_seeds_compiled(device="cpu")``
against the reference's ``run_experiment`` with
``CODAHyperparams(eig_backend="pallas", pi_update="delta")`` — the JAX side
then runs the Pallas scoring and refresh kernels in interpret mode. Chosen
index, true class, best model, regret and prior regret are equal; the
selection probability agrees within 1e-5 (absolute). So that a failure
means a port fault and not a near-tie, each compared round first has its
reference top-2 score gap checked against twice the largest difference
between the two packages' full score vectors in that round: with the gap
wider than that, both argmaxes must agree.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from coda_tpu_torch import random as trandom
from coda_tpu_torch.selectors import coda as tcoda

PROB_ATOL = 1e-5


def _jax_task(name):
    from coda_tpu.data import Dataset, make_synthetic_task

    if name == "synthetic":
        return make_synthetic_task(0, H=8, N=200, C=4)
    return Dataset.from_file(f"data/{name}.npz")


def _jax_hp():
    from coda_tpu.selectors import CODAHyperparams

    return CODAHyperparams(eig_backend="pallas", pi_update="delta")


def _jax_scores_per_round(task, iters, seed):
    """The reference's full per-round candidate score vectors (-inf off the
    candidate set), from its flight-recorder program with top-k = N."""
    from coda_tpu.engine.loop import build_recording_experiment_fn
    from coda_tpu.oracle import true_losses
    from coda_tpu.selectors import make_coda

    N = task.preds.shape[1]
    sel = make_coda(task.preds, _jax_hp())
    fn = build_recording_experiment_fn(
        sel, task.labels, true_losses(task.preds, task.labels), iters,
        trace_k=N)
    _, aux = jax.jit(fn)(jax.random.PRNGKey(seed))
    idx = np.asarray(aux.trace.topk_idx)
    val = np.asarray(aux.trace.topk_score)
    full = np.full((iters, N), -np.inf, np.float32)
    np.put_along_axis(full, idx, val, axis=1)
    return full, np.asarray(aux.trace.runner_up_gap)


def _port_scores_per_round(preds, labels, iters, seed):
    """The port's candidate score vectors before each round's select, on
    the engine's key schedule."""
    from coda_tpu_torch.engine.loop import make_step_fn
    from coda_tpu_torch.oracle import true_losses

    preds, labels = torch.from_numpy(np.array(preds)), \
        torch.from_numpy(np.array(labels))
    sel = tcoda.make_coda(preds, device="cpu")
    step = make_step_fn(sel, labels, true_losses(preds, labels))
    k_init, _, k_scan = trandom.split(trandom.PRNGKey(seed), 3)
    state = sel.init(k_init)
    disagree = tcoda._disagreement_mask(sel.extras["hard_preds"],
                                        preds.shape[2])
    cum = torch.zeros(())
    out = []
    for k in trandom.split(k_scan, iters):
        cand0 = disagree & state.unlabeled
        cand = cand0 if bool(cand0.any()) else state.unlabeled
        out.append(torch.where(cand, state.eig_scores_cached,
                               float("-inf")).numpy().copy())
        state, cum, _ = step(state, cum, k)
    return np.stack(out)


@pytest.mark.parametrize("name,iters,seeds", [("synthetic", 20, 2),
                                              ("digits", 15, 1)])
def test_slice_trajectory_matches_reference(name, iters, seeds):
    from coda_tpu.engine import run_experiment
    from coda_tpu.selectors import make_coda
    from coda_tpu_torch.engine import run_seeds_compiled

    task = _jax_task(name)
    preds, labels = np.asarray(task.preds), np.asarray(task.labels)
    port = run_seeds_compiled(
        lambda p: tcoda.make_coda(p, device="cpu"), preds, labels,
        iters=iters, seeds=seeds, device="cpu")
    assert port.chosen_idx.shape == (seeds, iters)
    for s in range(seeds):
        # the precondition: every round's reference top-2 gap is wider
        # than twice the two packages' largest score difference
        ref_scores, gaps = _jax_scores_per_round(task, iters, s)
        port_scores = _port_scores_per_round(preds, labels, iters, s)
        np.testing.assert_array_equal(np.isfinite(port_scores),
                                      np.isfinite(ref_scores))
        fin = np.isfinite(ref_scores)
        absdiff = np.zeros_like(ref_scores)
        absdiff[fin] = np.abs(port_scores[fin] - ref_scores[fin])
        diff = absdiff.max(1)
        assert (gaps > 2 * diff).all(), (gaps, diff)
        # scores are small differences of ~log2(H)-sized entropies, so
        # fp32 reduction-order noise is absolute: the select_prob bound
        assert diff.max() < PROB_ATOL, diff

        ref = run_experiment(make_coda(task.preds, _jax_hp()), task,
                             iters=iters, seed=s)
        for field in ("chosen_idx", "true_class", "best_model", "regret"):
            np.testing.assert_array_equal(
                getattr(port, field)[s].numpy(),
                np.asarray(getattr(ref, field)), err_msg=field)
        assert float(port.regret_at_0[s]) == float(ref.regret_at_0)
        np.testing.assert_allclose(port.select_prob[s].numpy(),
                                   np.asarray(ref.select_prob), rtol=0,
                                   atol=PROB_ATOL)
        np.testing.assert_allclose(port.cumulative_regret[s].numpy(),
                                   np.asarray(ref.cumulative_regret),
                                   rtol=1e-6)
        assert bool(port.stochastic[s]) == bool(ref.stochastic)


def _jax_mid_run_state(task, rounds):
    from coda_tpu.selectors import make_coda

    sel = make_coda(task.preds, _jax_hp())
    select, update = jax.jit(sel.select), jax.jit(sel.update)
    state = jax.jit(sel.init)(jax.random.PRNGKey(0))
    for r in range(rounds):
        res = select(state, jax.random.PRNGKey(100 + r))
        state = update(state, res.idx, task.labels[res.idx], res.prob)
    return sel, select, update, state


def test_convert_state_then_step_matches_reference():
    """Start both packages from the same JAX mid-run state: one select +
    update in each gives the same choice and the same next state."""
    from coda_tpu_torch.convert import state_from_numpy, state_to_numpy

    task = _jax_task("synthetic")
    jsel, select, update, jstate = _jax_mid_run_state(task, 4)
    fields = {k: (None if v is None else np.asarray(v))
              for k, v in jstate._asdict().items()}
    tstate = state_from_numpy(fields, device="cpu")
    back = state_to_numpy(tstate)
    for f, v in back.items():
        np.testing.assert_array_equal(v, fields[f])

    key = jax.random.PRNGKey(77)
    jres = select(jstate, key)
    jnext = update(jstate, jres.idx, task.labels[jres.idx], jres.prob)
    tsel = tcoda.make_coda(torch.from_numpy(np.array(task.preds)),
                           device="cpu")
    tres = tsel.select(tstate, trandom.PRNGKey(77))
    assert int(tres.idx) == int(jres.idx)
    labels = torch.from_numpy(np.array(task.labels))
    tnext = tsel.update(tstate, tres.idx, labels.take(tres.idx), tres.prob)
    got = state_to_numpy(tnext)
    np.testing.assert_array_equal(got["unlabeled"],
                                  np.asarray(jnext.unlabeled))
    np.testing.assert_array_equal(got["dirichlets"],
                                  np.asarray(jnext.dirichlets))
    for f in ("pi_hat_xi", "pi_hat", "pi_xi_unnorm", "pbest_rows"):
        np.testing.assert_allclose(got[f], np.asarray(getattr(jnext, f)),
                                   rtol=1e-5, atol=1e-7, err_msg=f)
    np.testing.assert_allclose(got["pbest_hyp"], np.asarray(jnext.pbest_hyp),
                               rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(got["eig_scores_cached"],
                               np.asarray(jnext.eig_scores_cached),
                               rtol=1e-4, atol=1e-6)
    tb, _ = tsel.best(tnext)
    jb, _ = jsel.best(jnext, key)
    assert int(tb) == int(jb)


def test_convert_refuses_later_slice_fields():
    """Every field of the reference's state crosses now (the surrogate fit
    too, ``tests/test_torch_batchq.py``); a field the state does not have
    and a state without a posterior are refused."""
    from coda_tpu_torch.convert import state_from_numpy

    with pytest.raises(ValueError, match="not CODAState's"):
        state_from_numpy({"crowd": np.zeros(3)}, device="cpu")
    with pytest.raises(ValueError, match="missing"):
        state_from_numpy({"dirichlets": np.ones((2, 2, 2))}, device="cpu")


def test_cache_build_and_row_refresh_match_reference():
    from coda_tpu.selectors import coda as jcoda

    rng = np.random.default_rng(12)
    H, N, C = 7, 90, 4
    d = (rng.uniform(0.05, 1.0, (H, C, C)) + 2 * np.eye(C)).astype(np.float32)
    hard = rng.integers(0, C, (N, H)).astype(np.int32)
    rows_j, hyp_j = jcoda.build_eig_cache(jnp.asarray(d), jnp.asarray(hard),
                                          chunk=32)
    rows_t, hyp_t = tcoda.build_eig_cache(torch.from_numpy(d),
                                          torch.from_numpy(hard), chunk=32)
    np.testing.assert_allclose(rows_t.numpy(), np.asarray(rows_j),
                               rtol=1e-5, atol=1e-7)
    np.testing.assert_allclose(hyp_t.numpy(), np.asarray(hyp_j),
                               rtol=1e-5, atol=1e-6)
    c = 2
    row_j, hypt_j = jcoda.update_eig_cache_parts(
        jnp.asarray(d), jnp.int32(c), jnp.asarray(hard))
    row_t, hypt_t = tcoda.update_eig_cache_parts(
        torch.from_numpy(d), torch.tensor(c, dtype=torch.int32),
        torch.from_numpy(hard))
    np.testing.assert_allclose(row_t.numpy(), np.asarray(row_j), rtol=1e-5,
                               atol=1e-7)
    np.testing.assert_allclose(hypt_t.numpy(), np.asarray(hypt_j),
                               rtol=1e-5, atol=1e-6)
    # a freshly built cache's row c IS the refreshed row of the same
    # posterior
    np.testing.assert_allclose(hypt_t.numpy(), hyp_t[c].numpy(), rtol=1e-5,
                               atol=1e-7)


def test_pi_hat_updates_match_reference():
    from coda_tpu.selectors import coda as jcoda

    rng = np.random.default_rng(13)
    H, N, C = 6, 70, 5
    preds = rng.dirichlet(np.ones(C), size=(H, N)).astype(np.float32)
    d = (rng.uniform(0.05, 1.0, (H, C, C)) + 2 * np.eye(C)).astype(np.float32)
    for pt, pj in zip(tcoda.update_pi_hat(torch.from_numpy(d),
                                          torch.from_numpy(preds)),
                      jcoda.update_pi_hat(jnp.asarray(d),
                                          jnp.asarray(preds))):
        np.testing.assert_allclose(pt.numpy(), np.asarray(pj), rtol=1e-5)
    unnorm = np.asarray(jcoda.pi_unnorm(jnp.asarray(d), jnp.asarray(preds)))
    np.testing.assert_allclose(
        tcoda.pi_unnorm(torch.from_numpy(d), torch.from_numpy(preds)).numpy(),
        unnorm, rtol=1e-5)
    s = preds[:, 9].argmax(-1).astype(np.int32)
    ref = jcoda.update_pi_hat_column_delta(
        jnp.int32(3), jnp.asarray(s), jnp.transpose(jnp.asarray(preds),
                                                    (2, 0, 1)),
        jnp.asarray(unnorm), 0.01)
    got = tcoda.update_pi_hat_column_delta(
        torch.tensor(3), torch.from_numpy(s),
        torch.from_numpy(preds).permute(2, 0, 1).contiguous(),
        torch.from_numpy(unnorm.copy()), 0.01)
    for g, r in zip(got, ref):
        np.testing.assert_allclose(g.numpy(), np.asarray(r), rtol=1e-6,
                                   atol=1e-7)


def test_disagreement_mask_matches_reference():
    from coda_tpu.selectors.coda import _disagreement_mask as jmask

    rng = np.random.default_rng(14)
    hard = rng.integers(0, 3, (120, 5)).astype(np.int32)
    hard[:40] = 1                                   # unanimous items
    np.testing.assert_array_equal(
        tcoda._disagreement_mask(torch.from_numpy(hard), 3).numpy(),
        np.asarray(jmask(jnp.asarray(hard), 3)))


@pytest.mark.parametrize("knob,value", [
    ("eig_scorer", "surrogate:8"), ("surrogate_prior", "pool"),
    ("shard_spec", "data=2")])
def test_later_slice_knobs_raise(knob, value):
    """Knobs of later slices raise NotImplementedError naming the slice —
    never a silent fallback. Slice 4's knobs build now: the surrogate
    scorer, and the pool prior with it (alone it is the reference's
    refusal)."""
    preds = torch.from_numpy(np.array(_jax_task("synthetic").preds))
    hp = tcoda.CODAHyperparams(**{knob: value})
    if knob == "shard_spec":
        with pytest.raises(NotImplementedError, match="slice 5"):
            tcoda.make_coda(preds, hp, device="cpu")
        return
    if knob == "surrogate_prior":
        with pytest.raises(ValueError, match="warm-starts the carried"):
            tcoda.make_coda(preds, hp, device="cpu")
        hp = hp._replace(eig_scorer="surrogate:8")
    sel = tcoda.make_coda(preds, hp, device="cpu")
    assert sel.init(None).surrogate is not None


@pytest.mark.parametrize("knob,value", [
    ("eig_mode", "factored"), ("eig_mode", "rowscan"), ("eig_mode", "direct"),
    ("eig_precision", "high"),
    ("pi_update", "exact"), ("posterior", "sparse:2"),
    ("eig_pbest", "amortized"), ("q", "iid"), ("q", "uncertainty"),
    ("prefilter_n", 10)])
def test_slice_rest_knobs_build_and_run(knob, value):
    """The knobs the rest of CODA brings (they raised before it) build a
    selector and run a round on the CPU."""
    from coda_tpu_torch.engine.loop import make_step_fn
    from coda_tpu_torch.oracle import true_losses

    task = _jax_task("synthetic")
    preds = torch.from_numpy(np.array(task.preds))
    labels = torch.from_numpy(np.array(task.labels))
    sel = tcoda.make_coda(preds, tcoda.CODAHyperparams(**{knob: value}),
                          device="cpu")
    state = sel.init(None)
    step = make_step_fn(sel, labels, true_losses(preds, labels))
    state, _, outs = step(state, torch.zeros(()), trandom.PRNGKey(0))
    assert not bool(state.unlabeled[outs[0]])
    assert torch.isfinite(outs[3])


@pytest.mark.parametrize("knob,value", [
    ("eig_cache_dtype", "bfloat16"), ("eig_entropy", "approx"),
    ("eig_refresh", "fused")])
def test_headline_speed_knobs_build_and_run(knob, value):
    """The knobs the fused slice brings build a selector and run a round
    on the CPU, with finite scores for every item."""
    from coda_tpu_torch.engine.loop import make_step_fn
    from coda_tpu_torch.oracle import true_losses

    task = _jax_task("synthetic")
    preds = torch.from_numpy(np.array(task.preds))
    labels = torch.from_numpy(np.array(task.labels))
    sel = tcoda.make_coda(preds, tcoda.CODAHyperparams(**{knob: value}),
                          device="cpu")
    state = sel.init(None)
    if knob == "eig_cache_dtype":
        assert state.pbest_hyp.dtype == torch.bfloat16
    step = make_step_fn(sel, labels, true_losses(preds, labels))
    state, _, outs = step(state, torch.zeros(()), trandom.PRNGKey(0))
    assert not bool(state.unlabeled[outs[0]])
    assert torch.isfinite(state.eig_scores_cached).all()


def test_unknown_knob_values_raise_value_error():
    preds = torch.full((3, 20, 2), 0.5)
    for kw in ({"eig_backend": "pallas"}, {"eig_mode": "bogus"},
               {"pi_update": "bogus"}):
        with pytest.raises(ValueError):
            tcoda.make_coda(preds, tcoda.CODAHyperparams(**kw), device="cpu")
    assert tuple(tcoda.CODAHyperparams._fields) == tuple(
        __import__("coda_tpu.selectors", fromlist=["CODAHyperparams"])
        .CODAHyperparams._fields)


def test_plain_backend_runs_the_same_trajectory():
    """eig_backend='plain' (the card-side yardstick) is the CPU path's
    arithmetic: on the CPU both settings give bitwise the same run."""
    from coda_tpu_torch.data import make_synthetic_task
    from coda_tpu_torch.engine import run_seeds_compiled

    t = make_synthetic_task(1, H=6, N=80, C=3, device="cpu")
    runs = [run_seeds_compiled(
        lambda p, b=b: tcoda.make_coda(p, tcoda.CODAHyperparams(
            eig_backend=b), device="cpu"),
        t.preds, t.labels, iters=8, seeds=1, device="cpu")
        for b in ("auto", "plain")]
    for a, b in zip(*runs):
        assert torch.equal(a, b)


def test_cli_prints_reference_lines(capsys):
    from coda_tpu_torch.cli import main

    assert main(["--synthetic", "6,60,3", "--iters", "5", "--seeds", "2",
                 "--device", "cpu", "--method", "coda", "--no-mlflow"]) == 0
    out = capsys.readouterr().out
    assert "Loaded preds of shape (6, 60, 3)" in out
    for s in range(2):
        assert f"seed {s}: regret@5=" in out
    line = [ln for ln in out.splitlines() if ln.startswith("seed 0:")][0]
    assert "cumulative=" in line and "stochastic=False" in line
    assert main(["--task", "iris", "--data-dir", "data", "--iters", "3",
                 "--seeds", "1", "--device", "cpu", "--method", "coda",
                 "--no-mlflow"]) == 0
    assert "seed 0: regret@3=" in capsys.readouterr().out
