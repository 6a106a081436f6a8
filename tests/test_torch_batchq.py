"""Batched acquisition (``--acq-batch q``) in the port against the JAX
reference on the CPU: the generic greedy top-q, ActiveTesting's and
ModelPicker's own pairs, CODA's overlap-penalised ``select_q`` and fused
``update_q`` (dense and ``sparse:K``, delta and exact pi-hat), the weighted
``update_qw``, several seeds (one after another), the label-weighted
cumulative regret,
the committed ``runs/batchq_r14`` records and the q-vs-q' envelope.

Inputs are the repository's tasks or seeded synthetic ones, through both
packages. Tolerances:

  * trajectories (3 seeds, q in {2, 4}): the port's ``compare_records`` at
    the cross-backend score contract (2.34e-4) finds each seed at parity
    or first diverging as a ``tie-break-flip`` where the reference's
    runner-up gap is at most 2.34e-4 (ModelPicker's near-tie flips, as in
    ``tests/test_torch_baselines.py``), or at q > 1 as the same near tie
    of a round's first pick, which the triage names ``score-delta``
    because the later picks' probabilities follow it
    (``engine.replay.first_pick_flip``); the rounds before it hold the
    reference's decisions exactly and its regrets within 1e-6;
  * one ``select_q``/``update_q`` from the same state: the same picks,
    the state within rtol 1e-4 / atol 1e-6, the next scores within 1e-5;
  * ``update_qw`` with w = 1 bitwise ``update_q``; w = 0 leaves the
    posterior bitwise; the fused ``update_q`` within 2.34e-4 of q
    sequential updates; several seeds bitwise each seed alone.
"""

from __future__ import annotations

import json
import os

import numpy as np
import pytest
import torch

try:
    import jax
    import jax.numpy as jnp
except ImportError:  # a card machine without JAX runs the gpu cases only
    jax = jnp = None

from coda_tpu_torch.engine import replay as treplay
from coda_tpu_torch.engine import run_seeds_compiled, run_seeds_recorded
from coda_tpu_torch.selectors import SELECTOR_FACTORIES
from coda_tpu_torch.selectors import coda as tcoda
from coda_tpu_torch.selectors.batch import (
    generic_update_q,
    make_batched_selector,
    resolve_batch_fns,
)
from coda_tpu_torch.telemetry.recorder import (
    CROSS_BACKEND_SCORE_TOL as TOL,
    RunRecord,
)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SEEDS = 3
METHODS = ("iid", "uncertainty", "activetesting", "vma", "model_picker")


@pytest.fixture(autouse=True)
def _one_torch_thread():
    """Each test on one PyTorch thread, restored after (xdist workers share
    the cores)."""
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


def _factories(method, iters, q, **kw):
    """(reference factory, port factory) for a method."""
    from coda_tpu.selectors import SELECTOR_FACTORIES as JF
    from coda_tpu.selectors import CODAHyperparams, make_coda

    if method == "coda":
        jhp = CODAHyperparams(eig_chunk=1024, n_parallel=SEEDS, **kw)
        thp = tcoda.CODAHyperparams(eig_chunk=1024, n_parallel=SEEDS, **kw)
        return (lambda p: make_coda(p, jhp),
                lambda p: tcoda.make_coda(p, thp, device="cpu"))
    extra = {"budget": iters * q} if method in ("activetesting", "vma") \
        else {}
    return (lambda p: JF[method](p, **extra),
            lambda p: SELECTOR_FACTORIES[method](p, device="cpu", **extra))


def _records(method, name, q, iters, **kw):
    """The reference's and the port's records of the same run."""
    from coda_tpu.engine.loop import run_seeds_recorded as jrun

    preds, labels = _task(name)
    jfac, tfac = _factories(method, iters, q, **kw)
    ref = RunRecord.from_result(*jrun(jfac, jnp.asarray(preds),
                                      jnp.asarray(labels), iters=iters,
                                      seeds=SEEDS, acq_batch=q),
                                {"backend": "jax"}, {})
    got = RunRecord.from_result(*run_seeds_recorded(
        tfac, preds, labels, iters=iters, seeds=SEEDS, device="cpu",
        acq_batch=q), {"backend": "torch"}, {})
    return ref, got


def _hold(ref, got, flips_allowed=True):
    """Each seed at parity, or its first divergence a near-tie flip (a
    ``tie-break-flip``, or at q > 1 ``replay.first_pick_flip``) with the
    rounds before it the reference's. Returns the triage report."""
    assert got.acq_batch == ref.acq_batch
    report = treplay.compare_records(ref, got, score_tol=TOL)
    for s in report.seeds:
        T = ref.rounds if s.parity else s.first_divergent_round
        if not s.parity:
            gap = float(ref.arrays["runner_up_gap"][s.seed, T])
            assert flips_allowed, treplay.format_triage(report)
            assert s.classification == "tie-break-flip" or (
                ref.acq_batch > 1
                and treplay.first_pick_flip(ref, got, s.seed, T, TOL)
            ), s.to_dict()
            assert abs(gap) <= TOL, (s.to_dict(), gap)
        a, b = ref.seed_arrays(s.seed), got.seed_arrays(s.seed)
        for f in ("chosen_idx", "true_class", "best_model"):
            np.testing.assert_array_equal(b[f][:T], a[f][:T], err_msg=f)
        np.testing.assert_allclose(b["regret"][:T], a["regret"][:T],
                                   atol=1e-6)
        np.testing.assert_allclose(b["cumulative_regret"][:T],
                                   a["cumulative_regret"][:T], atol=1e-5)
    return report


CODA_CASES = [
    ((6, 128, 4), 2, {}), ((6, 128, 4), 4, {}),
    ((14, 64, 10), 2, {}), ((14, 64, 10), 4, {}),
    ("digits_h80", 2, {}), ("digits_h80", 4, {}),
    ((14, 64, 10), 4, dict(posterior="sparse:3")),
    ("digits_h80", 2, dict(posterior="sparse:4")),
    ((6, 128, 4), 4, dict(pi_update="exact")),
    ((14, 64, 10), 2, dict(pi_update="exact", posterior="sparse:3")),
]


@pytest.mark.parametrize("name,q,kw", CODA_CASES)
def test_coda_trajectory_matches_reference(name, q, kw):
    """CODA's q-wide rounds (overlap re-rank, fused update) against the
    reference's vmapped run, 10 rounds of q labels, batched seeds."""
    ref, got = _records("coda", name, q, 10, **kw)
    _hold(ref, got)


@pytest.mark.parametrize("name", [(6, 128, 4), "digits_h80"])
@pytest.mark.parametrize("method", METHODS)
def test_baseline_trajectory_matches_reference(method, name):
    """The generic top-q (IID, Uncertainty, VMA), ActiveTesting's draws
    without replacement and ModelPicker's argmin top-q, q = 4, 10 rounds;
    only ModelPicker may flip a near-tie."""
    ref, got = _records(method, name, 4, 10)
    report = _hold(ref, got, flips_allowed=method == "model_picker")
    np.testing.assert_array_equal(got.arrays["stochastic"],
                                  ref.arrays["stochastic"])
    assert len(report.seeds) == SEEDS


def _coda_pair(name, **kw):
    from coda_tpu.selectors import CODAHyperparams, make_coda

    preds, labels = _task(name)
    jsel = make_coda(jnp.asarray(preds), CODAHyperparams(eig_chunk=64, **kw))
    tsel = tcoda.make_coda(torch.from_numpy(preds),
                           tcoda.CODAHyperparams(eig_chunk=64, **kw),
                           device="cpu")
    return preds, labels, jsel, tsel


def _to_port(jstate):
    from coda_tpu_torch.convert import state_from_numpy

    return state_from_numpy(
        {k: (None if v is None else (tuple(np.asarray(x) for x in v)
                                     if isinstance(v, tuple)
                                     else np.asarray(v)))
         for k, v in jstate._asdict().items()}, device="cpu")


@pytest.mark.parametrize("kw", [{}, dict(posterior="sparse:3"),
                                dict(pi_update="exact")])
def test_select_q_and_update_q_from_one_state(kw):
    """From the same mid-run state (converted from the reference's), one
    ``select_q`` picks the reference's q points and one ``update_q``
    reaches its state: the posterior, pi-hat, cache and next scores."""
    from coda_tpu_torch import random as trandom

    preds, labels, jsel, tsel = _coda_pair((14, 64, 10), **kw)
    st = jax.jit(jsel.init)(jax.random.PRNGKey(0))
    upd = jax.jit(jsel.update)
    for i, c in ((3, 1), (10, 4), (40, 1)):
        st = upd(st, jnp.asarray(i), jnp.asarray(c), jnp.asarray(0.0))
    q = 4
    key = jax.random.PRNGKey(7)
    jres = jax.jit(jsel.select_q, static_argnums=2)(st, key, q)
    tst = _to_port(st)
    tres = tsel.select_q(tst, trandom.PRNGKey(7), q)
    np.testing.assert_array_equal(tres.idx.numpy(), np.asarray(jres.idx))
    np.testing.assert_allclose(tres.prob.numpy(), np.asarray(jres.prob),
                               rtol=1e-4, atol=1e-6)
    tcs = labels[np.asarray(jres.idx)]
    jnext = jax.jit(jsel.update_q)(st, jres.idx, jnp.asarray(tcs),
                                   jres.prob)
    tnext = tsel.update_q(tst, tres.idx, torch.from_numpy(tcs), tres.prob)
    for f in ("dirichlets", "pi_hat_xi", "pi_hat", "unlabeled",
              "pbest_rows", "pbest_hyp"):
        a, b = getattr(jnext, f), getattr(tnext, f)
        if a is None:
            assert b is None
            continue
        np.testing.assert_allclose(b.numpy(), np.asarray(a), rtol=1e-4,
                                   atol=1e-6, err_msg=f)
    # the scores are differences of ~3-bit entropies: 1e-5 absolute is
    # tens of their ulps, and far inside the 2.34e-4 contract
    np.testing.assert_allclose(tnext.eig_scores_cached.numpy(),
                               np.asarray(jnext.eig_scores_cached), rtol=0,
                               atol=1e-5)
    if "posterior" in kw:
        for x, y in zip(tnext.sparse, jnext.sparse):
            np.testing.assert_allclose(x.numpy(), np.asarray(y), rtol=1e-6,
                                       atol=1e-7)


@pytest.mark.parametrize("kw", [{}, dict(posterior="sparse:3")])
def test_update_qw_weights(kw):
    """w = 1 everywhere is ``update_q`` bitwise; w = 0 answers leave the
    posterior bitwise (their points are still labelled)."""
    preds, labels, _, tsel = _coda_pair((14, 64, 10), **kw)
    idxs = torch.tensor([5, 9, 21, 9 + 1])
    tcs = torch.from_numpy(labels[idxs.numpy()]).to(torch.int64)
    probs = torch.zeros(4)
    a = tsel.update_q(tsel.init(None), idxs, tcs, probs)
    b = tsel.update_qw(tsel.init(None), idxs, tcs, probs, torch.ones(4))
    for x, y in zip(a, b):
        if isinstance(x, tuple):
            assert all(torch.equal(u, v) for u, v in zip(x, y))
        elif x is not None:
            assert torch.equal(x, y)
    base = tsel.init(None)
    post0 = (base.dirichlets.clone() if base.dirichlets is not None
             else tuple(t.clone() for t in base.sparse))
    z = tsel.update_qw(base, idxs, tcs, probs, torch.zeros(4))
    if z.dirichlets is not None:
        assert torch.equal(z.dirichlets, post0)
    else:
        assert all(torch.equal(u, v) for u, v in zip(z.sparse, post0))
    assert not z.unlabeled[idxs].any()
    # one weighted answer is update_w's
    one = tsel.update_qw(tsel.init(None), idxs[:1], tcs[:1], probs[:1],
                         torch.tensor([0.5]))
    w1 = tsel.update_w(tsel.init(None), idxs[0], tcs[0], probs[0],
                       torch.tensor(0.5))
    assert torch.equal(one.eig_scores_cached, w1.eig_scores_cached)


def test_fused_update_q_equals_sequential_updates():
    """The fused ``update_q`` and q calls of ``update`` (batch.py's
    fallback, the fused-refresh path) from the same state reach the same
    cache and scores within the score contract, a repeated class too."""
    preds, labels, _, tsel = _coda_pair("digits_h80")
    idxs = torch.tensor([11, 250, 600, 13])
    tcs = torch.tensor([2, 7, 2, 5])
    probs = torch.zeros(4)
    a = tsel.update_q(tsel.init(None), idxs, tcs, probs)
    b = generic_update_q(tsel.update)(tsel.init(None), idxs, tcs, probs)
    for f in ("dirichlets", "pi_hat_xi", "pbest_rows", "pbest_hyp"):
        torch.testing.assert_close(getattr(a, f), getattr(b, f), rtol=1e-5,
                                   atol=1e-7)
    d = (a.eig_scores_cached - b.eig_scores_cached).abs().max()
    assert float(d) <= TOL
    # the fused refresh runs the sequential path: its q-wide run triages
    # against the precomputed one
    recs = {}
    for refresh in ("precomputed", "fused"):
        hp = tcoda.CODAHyperparams(eig_chunk=1024, eig_refresh=refresh)
        recs[refresh] = RunRecord.from_result(*run_seeds_recorded(
            lambda p: tcoda.make_coda(p, hp, device="cpu"),
            *_task("digits_h80"), iters=8, seeds=1, device="cpu",
            acq_batch=4), {"backend": "torch"}, {})
    assert tcoda.make_coda(torch.from_numpy(preds), tcoda.CODAHyperparams(
        eig_refresh="fused"), device="cpu").update_q is None
    _hold(recs["precomputed"], recs["fused"])


@pytest.mark.parametrize("kw", [{}, dict(posterior="sparse:3"),
                                dict(eig_pbest="amortized")])
def test_update_q_row_chunks_equal_one_pass(kw, monkeypatch):
    """A temporary budget of one row a pass (the headline's) refreshes the
    q rows, a repeated class among them, to the one-pass values: the
    cache within rtol 1e-5 / atol 1e-7, the next scores within 1e-6."""
    preds, labels, _, tsel = _coda_pair("digits_h80", **kw)
    idxs = torch.tensor([11, 250, 600, 13, 40])
    tcs = torch.tensor([2, 7, 2, 5, 9])
    probs = torch.zeros(5)
    assert tcoda._refresh_row_chunk(899, 80, 256) >= 5
    a = tsel.update_q(tsel.init(None), idxs, tcs, probs)
    monkeypatch.setattr(tcoda, "_REFRESH_TEMP_BYTES", 1)
    assert tcoda._refresh_row_chunk(899, 80, 256) == 1
    b = tsel.update_q(tsel.init(None), idxs, tcs, probs)
    for f in ("pbest_rows", "pbest_hyp"):
        torch.testing.assert_close(getattr(b, f), getattr(a, f), rtol=1e-5,
                                   atol=1e-7)
    torch.testing.assert_close(b.eig_scores_cached, a.eig_scores_cached,
                               rtol=0, atol=1e-6)


@pytest.mark.parametrize("kw", [{}, dict(posterior="sparse:3"),
                                dict(eig_mode="factored")])
def test_seed_batch_equals_seeds_one_after_another(kw):
    """A q-wide run of several seeds takes no seed-batched form (CODA's
    has one only at q = 1): it is bitwise the run with the batched form
    taken away, each seed bitwise its one-seed run."""
    import dataclasses

    from coda_tpu_torch.engine.loop import seeds_batch

    preds, labels = _task((14, 64, 10))
    hp = tcoda.CODAHyperparams(**kw)

    def run(sequential, seeds=3):
        def fac(p):
            sel = tcoda.make_coda(p, hp, device="cpu")
            return dataclasses.replace(sel, batched=None) if sequential \
                else sel

        return run_seeds_compiled(fac, preds, labels, iters=6, seeds=seeds,
                                  device="cpu", acq_batch=4)

    sel = tcoda.make_coda(torch.from_numpy(preds), hp, device="cpu")
    assert sel.batched is not None and seeds_batch(sel, 1)
    assert not seeds_batch(sel, 4)
    a, b, one = run(False), run(True), run(False, seeds=1)
    for f in a._fields:
        assert torch.equal(getattr(a, f), getattr(b, f)), f
        assert torch.equal(getattr(a, f)[:1], getattr(one, f)), f
    # make_batched_selector's pair has no seed-batched form either
    wide = make_batched_selector(sel, 3)
    assert wide.batched is None and wide.hyperparams["acq_batch"] == 3


def test_cli_q_wide_seeds_run_one_after_another(capsys):
    """The CLI at ``--acq-batch 2`` with 3 CODA seeds runs them one after
    another, so the auto tier's replica count is 1 (3 at q = 1)."""
    from coda_tpu_torch.cli import hyperparams, main, parse_args

    argv = ["--synthetic", "6,60,3", "--iters", "3", "--seeds", "3",
            "--device", "cpu", "--method", "coda", "--no-mlflow"]
    assert hyperparams(parse_args(argv)).n_parallel == 3
    argv += ["--acq-batch", "2"]
    assert hyperparams(parse_args(argv)).n_parallel == 1
    assert main(argv) == 0
    out = capsys.readouterr().out
    assert "seeds run one after another, 2 labels/round" in out
    assert "seed 2: regret@3=" in out


def test_label_weighted_cumulative_regret_and_budgets():
    preds, labels = _task((6, 128, 4))
    r = run_seeds_compiled(lambda p: SELECTOR_FACTORIES["iid"](
        p, device="cpu"), preds, labels, iters=7, seeds=2, device="cpu",
        acq_batch=3)
    assert r.chosen_idx.shape == (2, 7, 3)
    for s in range(2):
        assert len(set(r.chosen_idx[s].reshape(-1).tolist())) == 21
    np.testing.assert_allclose(r.cumulative_regret.numpy(),
                               np.cumsum(3 * r.regret.numpy(), 1),
                               rtol=1e-6)
    with pytest.raises(ValueError, match="43 x acq_batch=3 = 129 labels"):
        run_seeds_compiled(lambda p: SELECTOR_FACTORIES["iid"](
            p, device="cpu"), preds, labels, iters=43, seeds=1,
            device="cpu", acq_batch=3)
    with pytest.raises(ValueError, match="fixed label buffer of 10"):
        run_seeds_compiled(lambda p: SELECTOR_FACTORIES["activetesting"](
            p, budget=10, device="cpu"), preds, labels, iters=4, seeds=1,
            device="cpu", acq_batch=3)
    with pytest.raises(ValueError, match="q >= 2"):
        resolve_batch_fns(SELECTOR_FACTORIES["iid"](preds, device="cpu"), 1)


def _committed(name):
    return os.path.join(ROOT, "runs", name)


@pytest.fixture(scope="module")
def digits_q4(tmp_path_factory):
    """The port CLI's record of ``runs/batchq_r14/q4``'s run."""
    from coda_tpu_torch.cli import main

    out = str(tmp_path_factory.mktemp("rec") / "q4")
    with open(os.path.join(_committed("batchq_r14/q4"), "record.json")) as f:
        knobs = json.load(f)["fingerprint"]["knobs"]
    assert main(["--task", "digits", "--data-dir", os.path.join(ROOT, "data"),
                 "--method", "coda", "--iters", str(knobs["iters"]),
                 "--seeds", str(knobs["seeds"]), "--eig-chunk",
                 str(knobs["eig_chunk"]), "--acq-batch", "4", "--no-mlflow",
                 "--record-dir", out, "--device", "cpu"]) == 0
    return out


def test_digits_q4_record_triages_against_the_committed_one(digits_q4):
    from coda_tpu.engine import replay as jreplay
    from coda_tpu.telemetry.recorder import RunRecord as JRecord

    mine = RunRecord.load(digits_q4)
    assert mine.violations() == [] and mine.acq_batch == 4
    assert mine.meta["fingerprint"]["dataset"]["digest"] == "5f3db83b81eef3d0"
    ref = RunRecord.load(_committed("batchq_r14/q4"))
    _hold(ref, mine)
    ja, jb = JRecord.load(_committed("batchq_r14/q4")), JRecord.load(
        digits_q4)
    tol = jreplay._auto_tol(ja, {}, against=jb)
    assert tol == TOL and treplay._auto_tol(ref, {}, against=mine) == tol
    want = jreplay.compare_records(ja, jb, score_tol=tol)
    got = treplay.compare_records(ref, mine, score_tol=tol)
    assert got.to_dict() == want.to_dict()


def test_digits_q4_holds_a_fresh_reference_capture(digits_q4):
    """The reference run afresh with ``runs/batchq_r14/q4``'s knobs
    (digits, q = 4, 3 seeds x 30 rounds, ``eig_chunk`` 1024, its seeds
    under ``vmap``) and the port CLI's run of the same: the port holds the
    fresh capture, each seed at parity or first diverging at a near tie
    within 2.34e-4 (a ``tie-break-flip``, or a first-pick near tie that
    the triage names ``score-delta``). The fresh capture holds the
    committed record by the same rule: a first-pick near tie the port
    shows against the committed record is one the reference's own
    re-run shows too, not a change of the port's."""
    from coda_tpu.engine.loop import run_seeds_recorded as jrun
    from coda_tpu.selectors import CODAHyperparams, make_coda

    committed = RunRecord.load(_committed("batchq_r14/q4"))
    kn = committed.meta["fingerprint"]["knobs"]
    preds, labels = _task("digits")
    jhp = CODAHyperparams(eig_chunk=kn["eig_chunk"],
                          n_parallel=kn["n_parallel"])
    fresh = RunRecord.from_result(
        *jrun(lambda p: make_coda(p, jhp), jnp.asarray(preds),
              jnp.asarray(labels), iters=kn["iters"], seeds=kn["seeds"],
              acq_batch=kn["acq_batch"]), {"backend": "jax"}, {})
    mine = RunRecord.load(digits_q4)
    _hold(fresh, mine)
    _hold(committed, fresh)


@pytest.mark.parametrize("a,b", [("batchq_r14/q1", "port"),
                                 ("batchq_r14/q8", "batchq_r14/q4"),
                                 ("port", "surrogate_r17/exact")])
def test_q_vs_q_takes_the_reference_envelope(a, b, digits_q4):
    from coda_tpu.engine import replay as jreplay
    from coda_tpu.telemetry.recorder import RunRecord as JRecord

    path = {n: digits_q4 if n == "port" else _committed(n) for n in (a, b)}
    want = jreplay.compare_records(JRecord.load(path[a]),
                                   JRecord.load(path[b]))
    got = treplay.compare_records(RunRecord.load(path[a]),
                                  RunRecord.load(path[b]))
    assert got.to_dict() == want.to_dict()
    assert treplay.format_triage(got) == jreplay.format_triage(want)
    assert all(s.classification == "acq-batch-envelope" for s in got.seeds)
    assert "acq-batch envelope" in treplay.format_triage(got)


@pytest.mark.gpu
@pytest.mark.parametrize("seeds", [1, 3])
def test_q_wide_kernel_route_equals_plain_on_card(seeds):
    """On the card, the q-wide rounds through kernels 1 and 3 hold the
    plain route's trajectory (digits_h80, q = 4, 20 rounds, the seeds one
    after another) by the triage at the score contract."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    preds, labels = _task("digits_h80")
    recs = {}
    for backend in ("auto", "jnp"):
        hp = tcoda.CODAHyperparams(eig_chunk=1024, eig_backend=backend,
                                   n_parallel=seeds)
        recs[backend] = RunRecord.from_result(*run_seeds_recorded(
            lambda p: tcoda.make_coda(p, hp, device="cuda"), preds, labels,
            iters=20, seeds=seeds, device="cuda", acq_batch=4), {}, {})
    _hold(recs["jnp"], recs["auto"])
