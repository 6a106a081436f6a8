"""The port's checkpoint/resume (mirrors ``tests/test_checkpoint.py``).

A resumed run is **bitwise** the uninterrupted one in every trace (the
reference's chunked scan agrees with its single scan to about 1 ulp; the
port runs the same rounds either way): the chunked runner against the
one-seed ``build_experiment_fn`` and ``run_seeds_compiled``, a run cut and
resumed, a resume with a smaller ``iters``, and a bfloat16 cache, for
every method and the nested state layouts (sparse posterior, surrogate
fit, fused refresh). The fingerprint, garbage collection, budget guard
and stale-layout error follow the reference's rules. Across packages the
port's resumable traces hold the reference's ``run_experiment_resumable``
on the same tiny task: equal chosen indices, labels and best models,
float traces within 1e-6 (both are float32 on the same decisions).
"""

from __future__ import annotations

import json
import os
import shutil

import numpy as np
import pytest
import torch

from coda_tpu_torch.data import make_synthetic_task
from coda_tpu_torch.engine import (
    ExperimentCheckpointer,
    build_experiment_fn,
    latest_step,
    make_resumable_runner,
    run_experiment_resumable,
    run_seeds_compiled,
)
from coda_tpu_torch.oracle import true_losses
from coda_tpu_torch.random import PRNGKey
from coda_tpu_torch.selectors import (
    SELECTOR_FACTORIES,
    CODAHyperparams,
    make_activetesting,
    make_coda,
    make_iid,
)


@pytest.fixture(autouse=True)
def _one_torch_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture(scope="module")
def setup():
    # the reference fixture's task (tests/conftest.py tiny_task)
    task = make_synthetic_task(seed=0, H=5, N=48, C=4, device="cpu")
    return task, true_losses(task.preds, task.labels)


def _bitwise(a, b):
    for name in a._fields:
        x, y = getattr(a, name), getattr(b, name)
        assert x.dtype == y.dtype and x.shape == y.shape, name
        assert torch.equal(x, y), name


def _fresh(sel, task, losses, iters, seed):
    return build_experiment_fn(sel, task.labels, losses, iters)(
        PRNGKey(seed))


def _coda(task, **kw):
    return make_coda(task.preds, CODAHyperparams(eig_chunk=16, **kw),
                     device="cpu")


def test_port_resumable_equals_unchunked(setup, tmp_path):
    task, losses = setup
    sel = _coda(task)
    got = run_experiment_resumable(sel, task.labels, losses, iters=12,
                                   seed=3, ckpt_dir=str(tmp_path / "a"),
                                   every=5)
    _bitwise(_fresh(sel, task, losses, 12, 3), got)
    got0 = run_experiment_resumable(sel, task.labels, losses, iters=12,
                                    seed=0, ckpt_dir=str(tmp_path / "b"),
                                    every=5)
    want0 = run_seeds_compiled(lambda p: _coda(task), task.preds,
                               task.labels, iters=12, seeds=1, device="cpu")
    _bitwise(type(got0)(*(f[0] for f in want0)), got0)


def _factory(method, task):
    if method == "coda":
        return _coda(task)
    if method in ("activetesting", "vma"):
        return SELECTOR_FACTORIES[method](task.preds, budget=20,
                                          device="cpu")
    return SELECTOR_FACTORIES[method](task.preds, device="cpu")


_LAYOUTS = ["coda", "iid", "uncertainty", "activetesting", "vma",
            "model_picker", "coda_sparse", "coda_surrogate", "coda_fused",
            "coda_factored"]


def _layout(name, task):
    extra = {"coda_sparse": dict(posterior="sparse:2",
                                 eig_mode="incremental"),
             "coda_surrogate": dict(eig_scorer="surrogate:8",
                                    eig_mode="incremental"),
             "coda_fused": dict(eig_refresh="fused",
                                eig_mode="incremental"),
             "coda_factored": dict(eig_mode="factored")}
    if name in extra:
        return _coda(task, **extra[name])
    return _factory(name, task)


@pytest.mark.parametrize("layout", _LAYOUTS)
def test_port_resume_after_cut(layout, setup, tmp_path):
    """The first 10 of 20 rounds, then a cut; a fresh runner resumes from
    round 5 and completes all 20, bitwise the uninterrupted run."""
    task, losses = setup
    ckpt = str(tmp_path / "ck")
    sel = _layout(layout, task)
    run_experiment_resumable(sel, task.labels, losses, iters=10, seed=1,
                             ckpt_dir=ckpt, every=5)
    assert latest_step(ckpt) == 5   # the final chunk is not checkpointed
    resumed = run_experiment_resumable(_layout(layout, task), task.labels,
                                       losses, iters=20, seed=1,
                                       ckpt_dir=ckpt, every=5)
    _bitwise(_fresh(_layout(layout, task), task, losses, 20, 1), resumed)


def test_port_checkpoint_gc(tmp_path):
    ck = ExperimentCheckpointer(str(tmp_path / "ck"), keep=2)
    for r in (5, 10, 15, 20):
        ck.save(r, {"x": torch.arange(3), "r": r})
    assert sorted(os.listdir(str(tmp_path / "ck"))) == ["step_15",
                                                        "step_20"]
    assert latest_step(str(tmp_path / "ck")) == 20
    assert latest_step(str(tmp_path / "ck"), at_most=19) == 15
    got = ck.restore(20)
    assert got["r"] == 20 and torch.equal(got["x"], torch.arange(3))


def test_port_latest_step_of_nothing(tmp_path):
    assert latest_step(str(tmp_path / "nope")) is None
    os.makedirs(tmp_path / "only_tmp" / "step_5.tmp")
    assert latest_step(str(tmp_path / "only_tmp")) is None


def test_port_resume_at_fewer_rounds(setup, tmp_path):
    """Round keys are prefix-stable: a shorter rerun restores an earlier
    checkpoint (<= iters) and equals a fresh short run bitwise."""
    task, losses = setup
    ckpt = str(tmp_path / "ck")
    for sel in (make_iid(task.preds, device="cpu"), _coda(task)):
        shutil.rmtree(ckpt, ignore_errors=True)
        run_experiment_resumable(sel, task.labels, losses, iters=20, seed=0,
                                 ckpt_dir=ckpt, every=5)  # step_10, step_15
        short = run_experiment_resumable(sel, task.labels, losses, iters=12,
                                         seed=0, ckpt_dir=ckpt, every=5)
        _bitwise(_fresh(sel, task, losses, 12, 0), short)


def test_port_fingerprint_refuses_another_config(setup, tmp_path):
    task, losses = setup
    ckpt = str(tmp_path / "ck")
    run_experiment_resumable(_coda(task, alpha=0.9), task.labels, losses,
                             iters=6, seed=0, ckpt_dir=ckpt, every=3)
    with pytest.raises(ValueError, match="different configuration"):
        run_experiment_resumable(_coda(task, alpha=0.5), task.labels,
                                 losses, iters=6, seed=0, ckpt_dir=ckpt,
                                 every=3)
    with pytest.raises(ValueError, match="different configuration"):
        run_experiment_resumable(_coda(task), task.labels, losses, iters=6,
                                 seed=1, ckpt_dir=ckpt, every=3)


def test_port_fingerprint_takes_a_new_default_field(setup, tmp_path):
    """A checkpoint written before a hyperparam existed resumes while the
    new field sits at its default; an explicit override is a mismatch."""
    task, losses = setup
    ckpt = str(tmp_path / "ck")
    run_experiment_resumable(_coda(task), task.labels, losses, iters=6,
                             seed=0, ckpt_dir=ckpt, every=3)
    fp_path = os.path.join(ckpt, "fingerprint.json")
    with open(fp_path) as f:
        saved = json.load(f)
    del saved["hyperparams"]["eig_mode"]
    with open(fp_path, "w") as f:
        json.dump(saved, f)
    run_experiment_resumable(_coda(task), task.labels, losses, iters=6,
                             seed=0, ckpt_dir=ckpt, every=3)
    with pytest.raises(ValueError, match="different configuration"):
        run_experiment_resumable(_coda(task, eig_mode="direct"),
                                 task.labels, losses, iters=6, seed=0,
                                 ckpt_dir=ckpt, every=3)


def test_port_checkpoint_budget_guard(setup, tmp_path):
    task, losses = setup
    sel = make_activetesting(task.preds, budget=5, device="cpu")
    with pytest.raises(ValueError, match="fixed label buffer"):
        run_experiment_resumable(sel, task.labels, losses, iters=10, seed=0,
                                 ckpt_dir=str(tmp_path / "ck"), every=5)
    with pytest.raises(ValueError, match="labelable points"):
        make_resumable_runner(make_iid(task.preds, device="cpu"),
                              task.labels, losses, iters=49)


def test_port_stale_state_layout_is_refused(setup, tmp_path):
    """A checkpoint whose state lacks a field of this build's state class
    fails with the actionable message, not a mis-assigned leaf."""
    task, losses = setup
    ckpt = str(tmp_path / "ck")
    run_experiment_resumable(_coda(task), task.labels, losses, iters=9,
                             seed=0, ckpt_dir=ckpt, every=3)
    step = latest_step(ckpt)
    ckptr = ExperimentCheckpointer(ckpt)
    tree = ckptr.restore(step)
    fields = tree["state"]["fields"]
    fields.pop(next(iter(fields)))
    shutil.rmtree(os.path.join(ckpt, f"step_{step}"))
    ckptr.save(step, tree)
    with pytest.raises(ValueError, match="layout change"):
        run_experiment_resumable(_coda(task), task.labels, losses, iters=12,
                                 seed=0, ckpt_dir=ckpt, every=3)


def test_port_bf16_cache_roundtrips(setup, tmp_path):
    """The bfloat16 cache crosses the disk bit for bit: the resumed run is
    the uninterrupted one, and the restored cache is the saved one."""
    task, losses = setup
    kw = dict(eig_mode="incremental", eig_cache_dtype="bfloat16")
    ckpt = str(tmp_path / "ck16")
    run_experiment_resumable(_coda(task, **kw), task.labels, losses,
                             iters=8, seed=3, ckpt_dir=ckpt, every=4)
    tree = ExperimentCheckpointer(ckpt).restore(4)
    assert tree["state"]["fields"]["pbest_hyp"].dtype == torch.bfloat16
    got = run_experiment_resumable(_coda(task, **kw), task.labels, losses,
                                   iters=10, seed=3, ckpt_dir=ckpt, every=4)
    _bitwise(_fresh(_coda(task, **kw), task, losses, 10, 3), got)


def test_port_state_flattens_by_field_name(tmp_path):
    """Host leaves (a ``PriorStats``' float64 arrays and Python floats),
    None and nested NamedTuples survive the disk by field name; a type
    outside the port is refused."""
    from coda_tpu_torch.engine.checkpoint import (
        StaleLayoutError,
        flatten_state,
        unflatten_state,
    )
    from coda_tpu_torch.selectors.coda import CODAState
    from coda_tpu_torch.selectors.surrogate import PriorStats

    prior = PriorStats(A=np.arange(4.0).reshape(2, 2), b=np.ones(2), n=3.5,
                       rounds=2.0, sessions=1.0)
    state = CODAState(dirichlets=None, pi_hat_xi=torch.ones(3, 2),
                      pi_hat=torch.tensor([0.25, 0.75]),
                      unlabeled=torch.tensor([True, False, True]))
    ck = ExperimentCheckpointer(str(tmp_path / "ck"))
    ck.save(1, {"prior": flatten_state(prior), "state": flatten_state(state)})
    got = ck.restore(1)
    p2, s2 = unflatten_state(got["prior"]), unflatten_state(got["state"])
    assert type(p2) is PriorStats and p2.A.dtype == np.float64
    np.testing.assert_array_equal(p2.A, prior.A)
    assert (p2.n, p2.rounds, p2.sessions) == (3.5, 2.0, 1.0)
    assert type(s2) is CODAState and s2.dirichlets is None
    assert torch.equal(s2.unlabeled, state.unlabeled)
    bad = flatten_state(state)
    bad["__type__"] = "collections:OrderedDict"
    with pytest.raises(StaleLayoutError, match="not the port's"):
        unflatten_state(bad)
    with pytest.raises(TypeError, match="cannot checkpoint"):
        flatten_state([1, 2])


def test_port_checkpoint_timings_and_size(setup, tmp_path):
    task, losses = setup
    timings: list = []
    runner = make_resumable_runner(_coda(task), task.labels, losses,
                                   iters=9, every=3, timings=timings)
    runner(0, str(tmp_path / "ck"))
    runner(0, str(tmp_path / "ck"))
    assert [t["op"] for t in timings] == ["save", "save", "restore"]
    assert [t["round"] for t in timings] == [3, 6, 6]
    # the state's (C, N, H) fp32 cache is most of a checkpoint
    assert all(t["bytes"] > 4 * 4 * 48 * 5 for t in timings)


def test_port_cli_checkpoint_dir(tmp_path, capsys):
    """``--checkpoint-dir`` runs seeds one after another through the
    resumable runner (``n_parallel`` 1), a rerun resumes to the same
    numbers, and it refuses ``--record-dir`` and ``--acq-batch`` > 1."""
    from coda_tpu_torch.cli import hyperparams, main, parse_args

    base = ["--synthetic", "5,48,4", "--method", "coda", "--iters", "7",
            "--seeds", "2", "--device", "cpu", "--no-mlflow"]
    ck = str(tmp_path / "ck")
    args = parse_args(base + ["--checkpoint-dir", ck])
    assert args.checkpoint_every == 25 and hyperparams(args).n_parallel == 1
    assert main(base + ["--checkpoint-dir", ck, "--checkpoint-every",
                        "3"]) == 0
    first = capsys.readouterr().out
    assert sorted(os.listdir(ck)) == ["seed_0", "seed_1"]
    assert latest_step(os.path.join(ck, "seed_1")) == 6
    assert main(base + ["--checkpoint-dir", ck, "--checkpoint-every",
                        "3"]) == 0
    again = capsys.readouterr().out
    lines = lambda out: [ln for ln in out.splitlines()
                         if ln.startswith("seed ")]
    assert lines(first) == lines(again) and len(lines(first)) == 2
    with pytest.raises(SystemExit, match="--record-dir"):
        main(base + ["--checkpoint-dir", ck, "--record-dir",
                     str(tmp_path / "r")])
    with pytest.raises(SystemExit, match="--acq-batch"):
        main(base + ["--checkpoint-dir", ck, "--acq-batch", "2"])


@pytest.mark.parametrize("method", ["coda", "iid", "activetesting"])
def test_port_resumable_holds_the_reference_resumable(method, setup,
                                                      tmp_path):
    import jax.numpy as jnp

    from coda_tpu import selectors as jsel
    from coda_tpu.data import make_synthetic_task as jtask
    from coda_tpu.engine import run_experiment_resumable as jresumable
    from coda_tpu.oracle import true_losses as jlosses

    task, losses = setup
    jt = jtask(seed=0, H=5, N=48, C=4)
    np.testing.assert_array_equal(np.asarray(jt.preds), task.preds.numpy())
    if method == "coda":
        jsel_ = jsel.make_coda(jt.preds, jsel.CODAHyperparams(eig_chunk=16))
    elif method == "activetesting":
        jsel_ = jsel.make_activetesting(jt.preds, budget=20)
    else:
        jsel_ = jsel.make_iid(jt.preds)
    want = jresumable(jsel_, jt.labels, jlosses(jt.preds, jt.labels),
                      iters=12, seed=2, ckpt_dir=str(tmp_path / "j"),
                      every=5)
    got = run_experiment_resumable(_factory(method, task), task.labels,
                                   losses, iters=12, seed=2,
                                   ckpt_dir=str(tmp_path / "t"), every=5)
    for name in ("chosen_idx", "true_class", "best_model", "stochastic"):
        np.testing.assert_array_equal(getattr(got, name).numpy(),
                                      np.asarray(getattr(want, name)),
                                      err_msg=name)
    for name in ("regret", "cumulative_regret", "select_prob",
                 "regret_at_0"):
        np.testing.assert_allclose(getattr(got, name).numpy(),
                                   np.asarray(getattr(want, name),
                                              jnp.float32),
                                   rtol=0, atol=1e-6, err_msg=name)
