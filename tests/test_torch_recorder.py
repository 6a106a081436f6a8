"""The port's flight recorder, triage and command line against the JAX
package on the CPU.

* A port record of ``digits`` (CODA, 100 rounds x 3 seeds, the committed
  record's knobs) carries the committed dataset digest, passes
  ``scripts/check_record_schema.py``, and the reference's
  ``compare_records`` against ``runs/surrogate_r17/exact`` at its auto
  tolerance finds parity, or only ``tie-break-flip``s at a recorded gap of
  at most 2.34e-4.
* The port's ``compare_records`` gives the reference's ``to_dict()`` on
  every pair of committed records and on the port record against each,
  both the pairs that take the per-round path and those the reference
  compares by the regret envelope (different scorers or priors).
* The reference rebuilds its selector from a port record's knobs.
* IID and ModelPicker records carry the reference's conventions (NaN
  posterior digest without a posterior, slot 0 without a score vector).
* Recording changes no decision; the CLI takes the reference's method
  names and ``eig_backend`` names.
"""

from __future__ import annotations

import dataclasses
import importlib.util
import itertools
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from coda_tpu_torch.engine import replay as treplay
from coda_tpu_torch.engine import run_seeds_compiled, run_seeds_recorded
from coda_tpu_torch.selectors import SELECTOR_FACTORIES
from coda_tpu_torch.selectors import coda as tcoda
from coda_tpu_torch.telemetry import recorder as trec

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
COMMITTED = ("surrogate_r17/default", "surrogate_r17/exact",
             "surrogate_r17/surrogate", "prior_r18/cold", "prior_r18/off",
             "prior_r18/seeded")
DIGITS_DIGEST = "5f3db83b81eef3d0"
TOL = trec.CROSS_BACKEND_SCORE_TOL


def _cli(argv):
    from coda_tpu_torch.cli import main

    return main(argv + ["--device", "cpu", "--no-mlflow"])


@pytest.fixture(scope="module")
def digits_record(tmp_path_factory):
    """The port's record of the committed capture's run."""
    out = str(tmp_path_factory.mktemp("rec") / "digits")
    assert _cli(["--task", "digits", "--data-dir",
                 os.path.join(ROOT, "data"), "--method", "coda", "--iters",
                 "100", "--seeds", "3", "--eig-chunk", "1024",
                 "--record-dir", out]) == 0
    return out


def _schema_checker():
    spec = importlib.util.spec_from_file_location(
        "check_record_schema",
        os.path.join(ROOT, "scripts", "check_record_schema.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _committed(name):
    return os.path.join(ROOT, "runs", name)


def test_digits_record_digest_schema_and_reference_triage(digits_record):
    from coda_tpu.engine import replay as jreplay
    from coda_tpu.telemetry.recorder import RunRecord

    with open(os.path.join(digits_record, "record.json")) as f:
        meta = json.load(f)
    fp = meta["fingerprint"]
    assert fp["dataset"]["digest"] == DIGITS_DIGEST
    assert fp["backend"] == "torch-cpu" and meta["schema_version"] == 4
    assert fp["knobs"]["eig_backend"] == "auto"
    assert (meta["seeds"], meta["rounds"], meta["trace_k"]) == (3, 100, 8)
    assert _schema_checker().check_record(digits_record) == []
    assert trec.RunRecord.load(digits_record).violations() == []
    mine = RunRecord.load(digits_record)
    ref = RunRecord.load(_committed("surrogate_r17/exact"))
    tol = jreplay._auto_tol(mine, {}, against=ref)
    assert tol == TOL                  # two backends: the score contract
    report = jreplay.compare_records(mine, ref, score_tol=tol)
    for s in report.seeds:
        if s.parity:
            continue
        gap = float(ref.arrays["runner_up_gap"][s.seed,
                                                s.first_divergent_round])
        assert s.classification == "tie-break-flip", s.to_dict()
        assert abs(gap) <= TOL, (s.to_dict(), gap)
    np.testing.assert_array_equal(mine.arrays["round_key"],
                                  ref.arrays["round_key"])


def _pairs():
    names = ("port",) + COMMITTED
    return list(itertools.combinations(names, 2))


@pytest.mark.parametrize("a,b", _pairs())
def test_port_compare_records_gives_the_reference_report(a, b,
                                                         digits_record):
    from coda_tpu.engine import replay as jreplay
    from coda_tpu.telemetry.recorder import RunRecord

    paths = {n: (digits_record if n == "port" else _committed(n))
             for n in (a, b)}
    ja, jb = (RunRecord.load(paths[n]) for n in (a, b))
    ta, tb = (trec.RunRecord.load(paths[n]) for n in (a, b))
    envelope = ("envelope" in json.dumps(
        jreplay.compare_records(ja, jb).to_dict()))
    if envelope:
        # the label-aligned regret envelope, both ways round
        for order in ((ja, jb, ta, tb), (jb, ja, tb, ta)):
            want = jreplay.compare_records(order[0], order[1])
            got = treplay.compare_records(order[2], order[3])
            assert got.to_dict() == want.to_dict()
            assert treplay.format_triage(got) == jreplay.format_triage(want)
        return
    tol = jreplay._auto_tol(ja, {}, against=jb)
    assert treplay._auto_tol(ta, {}, against=tb) == tol
    for order in ((ja, jb, ta, tb), (jb, ja, tb, ta)):
        want = jreplay.compare_records(order[0], order[1], score_tol=tol)
        got = treplay.compare_records(order[2], order[3], score_tol=tol)
        assert got.to_dict() == want.to_dict()
        assert treplay.format_triage(got) == jreplay.format_triage(want)


def test_replay_without_a_record_to_compare_raises(digits_record):
    """Without a second record the replay re-executes the record: on the
    recording's backend (the CPU here) with unchanged knobs its tolerance
    is bitwise, on another backend or with overrides the contract; asked
    for the card on a machine without one, it raises (no fallback to the
    CPU)."""
    rec = trec.RunRecord.load(digits_record)
    assert treplay._auto_tol(rec, {}, device="cpu") == 0.0
    assert treplay._auto_tol(rec, {}, device="cuda") == TOL
    assert treplay._auto_tol(rec, {"eig_entropy": "approx"},
                             device="cpu") == TOL
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA"):
            treplay.replay_main([digits_record])


@pytest.mark.parametrize("backend,knob", [("plain", "jnp"), ("jnp", "jnp"),
                                          ("pallas", "pallas")])
def test_reference_rebuilds_its_selector_from_port_knobs(tmp_path, backend,
                                                         knob):
    """Fault 2: the record writes the reference's eig_backend names, and
    the reference's replay path builds its selector from them."""
    from coda_tpu.cli import build_selector_factory
    from coda_tpu.data import make_synthetic_task
    from coda_tpu.engine.replay import _args_from_record
    from coda_tpu.telemetry.recorder import RunRecord

    out = str(tmp_path / "rec")
    assert _cli(["--synthetic", "6,60,3", "--method", "coda", "--iters",
                 "4", "--seeds", "2", "--eig-backend", backend,
                 "--record-dir", out]) == 0
    rec = RunRecord.load(out)
    assert rec.meta["fingerprint"]["knobs"]["eig_backend"] == knob
    args = _args_from_record(rec)
    assert (args.method, args.eig_backend, args.n_parallel) == ("coda", knob,
                                                                2)
    task = make_synthetic_task(0, H=6, N=60, C=3)
    sel = build_selector_factory(args, task.name)(task.preds)
    assert sel.name == "coda"


@pytest.mark.parametrize("method", ["iid", "model_picker"])
def test_iid_and_modelpicker_records_keep_the_reference_conventions(method):
    from coda_tpu import selectors as jsel
    from coda_tpu.data import make_synthetic_task
    from coda_tpu.engine import run_seeds_recorded as jrun

    task = make_synthetic_task(0, H=6, N=128, C=4)
    kw = {"epsilon": 0.39} if method == "model_picker" else {}
    want = jrun(lambda p: jsel.SELECTOR_FACTORIES[method](p, **kw),
                task.preds, task.labels, iters=12, seeds=2)
    got = run_seeds_recorded(
        lambda p: SELECTOR_FACTORIES[method](p, device="cpu", **kw),
        np.asarray(task.preds), np.asarray(task.labels), iters=12, seeds=2,
        device="cpu")
    ref = trec.RunRecord.from_result(*want, {}, {})
    mine = trec.RunRecord.from_result(*got, {}, {})
    for f in ("round_key", "root_key", "init_key", "prior_key"):
        np.testing.assert_array_equal(mine.arrays[f], ref.arrays[f])
    a, b = mine.arrays, ref.arrays
    if method == "iid":
        # no posterior: NaN digests; uniform acquisition: every top-k
        # score is the selection probability
        assert np.isnan(a["pbest_max"]).all() and np.isnan(
            a["pbest_entropy"]).all()
        np.testing.assert_array_equal(a["topk_score"], b["topk_score"])
        np.testing.assert_array_equal(
            a["topk_score"], np.broadcast_to(a["select_prob"][..., None],
                                             a["topk_score"].shape))
        np.testing.assert_array_equal(a["runner_up_gap"], 0.0)
    else:
        # the multiplicative-weights posterior is the P(best) digest
        report = treplay.compare_records(ref, mine, score_tol=TOL)
        for s in range(2):
            T = report.seeds[s].first_divergent_round or 12
            np.testing.assert_allclose(a["pbest_max"][s, :T],
                                       b["pbest_max"][s, :T], rtol=1e-5)
            np.testing.assert_allclose(a["pbest_entropy"][s, :T],
                                       b["pbest_entropy"][s, :T], rtol=1e-5)
        assert (a["pbest_max"] > 1.0 / 6).all()
    assert not a["surrogate_fallback"].any()


def test_slot_zero_record_without_scores():
    """A select result without a score vector records its choice in slot 0
    (the reference's convention)."""
    from coda_tpu.engine.loop import make_round_trace as jtrace
    from coda_tpu.selectors.protocol import SelectResult as JResult
    from coda_tpu.selectors.protocol import Selector as JSelector
    from coda_tpu_torch.engine.loop import make_round_trace
    from coda_tpu_torch.selectors.protocol import SelectResult, Selector

    sel = Selector(name="x", init=None, select=None, update=None, best=None)
    jsel = JSelector(name="x", init=None, select=None, update=None,
                     best=None)
    want = jtrace(jsel, JResult(idx=jnp.asarray(7), prob=jnp.asarray(0.25),
                                stochastic=jnp.asarray(True)), None,
                  jax.random.PRNGKey(3), 4)
    got = make_round_trace(sel, SelectResult(
        idx=torch.tensor(7), prob=torch.tensor(0.25),
        stochastic=torch.tensor(True)), None,
        torch.tensor([0, 3]), 4)
    for f in ("topk_idx", "topk_score", "chosen_score", "runner_up_gap"):
        np.testing.assert_array_equal(getattr(got, f).numpy(),
                                      np.asarray(getattr(want, f)))
    assert np.isnan(float(got.pbest_max))


def _same_decisions(a, b):
    for f in ("chosen_idx", "true_class", "best_model", "regret",
              "select_prob", "regret_at_0", "stochastic"):
        assert torch.equal(getattr(a, f), getattr(b, f)), f


@pytest.mark.parametrize("config", ["batched", "sequential", "fused",
                                    "vma", "model_picker"])
def test_recording_changes_no_decision(config):
    """The recorded run is the unrecorded one: the same decisions, the
    recorder's scores those of each round's select (read before CODA's
    in-place update)."""
    from coda_tpu_torch.data import make_synthetic_task

    t = make_synthetic_task(2, H=7, N=90, C=4, device="cpu")
    if config in ("vma", "model_picker"):
        kw = {"budget": 9} if config == "vma" else {}

        def factory(p):
            return SELECTOR_FACTORIES[config](p, device="cpu", **kw)
    else:
        hp = tcoda.CODAHyperparams(
            n_parallel=3 if config == "batched" else 1,
            eig_refresh="fused" if config == "fused" else "precomputed")

        def factory(p):
            sel = tcoda.make_coda(p, hp, device="cpu")
            return (sel if config == "batched"
                    else dataclasses.replace(sel, batched=None))
    plain = run_seeds_compiled(factory, t.preds, t.labels, iters=9, seeds=3,
                               device="cpu")
    res, aux = run_seeds_recorded(factory, t.preds, t.labels, iters=9,
                                  seeds=3, device="cpu", trace_k=5)
    _same_decisions(plain, res)
    tr = aux.trace
    assert tr.topk_score.shape == (3, 9, 5)
    chosen = tr.chosen_score
    # the chosen point is a top-scored one (CODA's argmax up to its tie
    # tolerance), and the chosen score is its acquisition score
    if config != "vma":
        assert (chosen >= tr.topk_score[..., 0] - 1e-6).all()
    if config not in ("vma", "model_picker"):
        np.testing.assert_allclose(chosen.numpy(), res.select_prob.numpy())
    torch.testing.assert_close(tr.runner_up_gap,
                               tr.topk_score[..., 0] - tr.topk_score[..., 1])
    assert aux.root_key.shape == aux.init_key.shape == (3, 2)


def test_cli_method_names_and_defaults(capsys, tmp_path):
    from coda_tpu_torch.cli import build_selector_factory, parse_args

    d = parse_args([])
    assert (d.method, d.record_topk, d.record_dir, d.epsilon) == (
        "iid", 8, None, None)
    assert parse_args(["--eig-backend", "plain"]).eig_backend == "jnp"
    with pytest.raises(SystemExit):
        parse_args(["--epsilon", "1.5"])
    with pytest.raises(SystemExit):
        build_selector_factory(parse_args(["--method", "bogus"]), "t")
    # a bare command line runs IID, as the reference's does
    assert _cli(["--synthetic", "6,60,3", "--iters", "4", "--seeds",
                 "2"]) == 0
    out = capsys.readouterr().out
    assert "seed 1: regret@4=" in out and "stochastic=True" in out
    for method in ("uncertainty", "activetesting", "vma", "model_picker",
                   "coda_anything"):
        assert _cli(["--synthetic", "6,60,3", "--iters", "4", "--seeds",
                     "1", "--method", method, "--loss", "ce"]) == 0
    assert "synthetic_6x60x3 not in TASK_EPS; using default" in \
        capsys.readouterr().out
    # --eig-backend jnp runs the plain versions: on the CPU the same run
    args = parse_args(["--synthetic", "6,60,3", "--method", "coda",
                       "--eig-backend", "jnp", "--device", "cpu"])
    from coda_tpu_torch.cli import hyperparams

    assert hyperparams(args).eig_backend == "jnp"
    assert tcoda.make_coda(torch.full((3, 8, 2), 0.5), hyperparams(args),
                           device="cpu").name == "coda"


def test_record_violations_match_the_reference_checker(tmp_path,
                                                       digits_record):
    checker = _schema_checker()
    rec = trec.RunRecord.load(digits_record)
    broken = dict(rec.arrays)
    del broken["pbest_max"]
    broken["topk_score"] = broken["topk_score"][:, :, :3]
    bad = trec.RunRecord(rec.meta, broken)
    out = str(tmp_path / "bad")
    bad.save(out)
    mine = bad.violations()
    assert mine == checker.check_record(out) and len(mine) == 2
