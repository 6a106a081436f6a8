"""The port's in-process suite (mirrors ``tests/test_suite.py``): one
experiment callable reused across tasks, seed dedup, ``run_batched``
bitwise ``run``, ModelPicker's per-task epsilon, DB-checked resume and
the reference's layout, the ``cli suite`` subcommand, width-divergent
tiers and ``batch_caps`` splits, the probe record streams.

Across packages: the port's suite against the reference's ``SuiteRunner``
on the same three tiny tasks, per pair equal chosen indices and regret
within 1e-6 (float32 on the same decisions), or for ModelPicker a
divergence that starts where two of its expected entropies tie within
2.34e-4 (the near-tie flips ``ROADMAP.md`` §3 names: its bucket sums are
float64 one-hot products on the port); and the reference's
``scripts/aggregate_results.py`` reads the port suite's database.
"""

from __future__ import annotations

import importlib.util
import os

import numpy as np
import pytest
import torch

from coda_tpu_torch.data import Dataset, make_synthetic_task
from coda_tpu_torch.engine.suite import SuiteRunner, family_of

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
METHODS = ["iid", "uncertainty", "coda", "activetesting", "vma",
           "model_picker"]
QUIET = dict(progress=lambda s: None)


@pytest.fixture(autouse=True)
def _one_torch_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _task(seed, H, N, C, name):
    return make_synthetic_task(seed=seed, H=H, N=N, C=C, name=name,
                               device="cpu")


@pytest.fixture()
def three_tasks():
    # two tasks share a shape, one differs (the reference fixture's)
    return [_task(1, 4, 40, 3, "alpha"), _task(2, 4, 40, 3, "beta"),
            _task(3, 3, 24, 4, "gamma")]


def _runner(**kw):
    return SuiteRunner(device="cpu", **kw)


def _bitwise(r_a: dict, r_b: dict) -> None:
    assert set(r_a) == set(r_b)
    for key in r_a:
        for name, fa, fb in zip(r_a[key]._fields, r_a[key], r_b[key]):
            fa, fb = np.asarray(fa), np.asarray(fb)
            assert fa.dtype == fb.dtype and fa.shape == fb.shape, key
            assert fa.tobytes() == fb.tobytes(), (key, name)


def test_port_suite_reuses_one_build_across_tasks(three_tasks):
    runner = _runner(iters=4, seeds=2)
    results = runner.run(three_tasks, ["iid", "coda"], **QUIET)
    assert len(results) == 6
    for res in results.values():
        assert np.asarray(res.regret).shape == (2, 4)
        assert np.isfinite(np.asarray(res.regret)).all()
    # one callable a method (widths 1 and 1 at two seeds): the count does
    # not grow with the tasks
    assert len(runner._jitted) == 2
    cold = [p["cold"] for p in runner.last_stats["pairs"]]
    assert cold == [True, True, False, False, False, False]
    a = np.asarray(results[("alpha", "coda")].chosen_idx)
    b = np.asarray(results[("beta", "coda")].chosen_idx)
    assert not np.array_equal(a, b)


def test_port_suite_seed_dedup(three_tasks):
    runner = _runner(iters=4, seeds=3)
    idx = np.asarray(runner.run_one("uncertainty", three_tasks[0])
                     .chosen_idx)
    assert idx.shape == (3, 4) and (idx == idx[0]).all()
    idx = np.asarray(runner.run_one("iid", three_tasks[0]).chosen_idx)
    assert len({tuple(r) for r in idx}) > 1
    # dedup off: every seed runs in one program of width 3
    full = _runner(iters=4, seeds=3, dedup_seeds=False)
    np.testing.assert_array_equal(
        np.asarray(full.run_one("iid", three_tasks[0]).chosen_idx), idx)
    assert {k[2] for k in full._jitted} == {3}


def test_port_suite_batched_equals_run(three_tasks):
    methods = ["iid", "uncertainty", "coda"]
    r_un = _runner(iters=4, seeds=3).run(three_tasks[:2], methods, **QUIET)
    runner = _runner(iters=4, seeds=3)
    r_ba = runner.run_batched([three_tasks[:2]], methods, **QUIET)
    _bitwise(r_un, r_ba)
    assert runner.last_stats["schedule"] == "serial"
    assert [p["batched"] for p in runner.last_stats["pairs"]] == [2] * 6


def test_port_suite_batched_guards(three_tasks):
    t1, _, t3 = three_tasks
    runner = _runner(iters=2, seeds=2)
    with pytest.raises(ValueError, match="mixes shapes"):
        runner.run_batched([[t1, t3]], ["iid"], **QUIET)
    # wine (0.37) and digits (0.39): different tuned epsilons, one group
    ta = Dataset(preds=t1.preds, labels=t1.labels, name="wine")
    tb = Dataset(preds=t1.preds, labels=t1.labels, name="digits")
    r_ba = runner.run_batched([[ta, tb]], ["model_picker"], **QUIET)
    r_un = _runner(iters=2, seeds=2).run([ta, tb], ["model_picker"],
                                         **QUIET)
    _bitwise(r_un, r_ba)
    # cost capture and telemetry are the runner's own knobs now
    from coda_tpu_torch.telemetry import Registry, Telemetry

    tele = Telemetry(registry=Registry())
    assert SuiteRunner(device="cpu", cost_capture=False).cost_capture is \
        False
    assert SuiteRunner(device="cpu", telemetry=tele).telemetry is tele


def test_port_suite_modelpicker_per_task_epsilon():
    """Tasks of different tuned epsilons share ONE callable a width, each
    task's run using its own epsilon: the same as selectors built with
    it."""
    from coda_tpu_torch.engine import run_seeds_compiled
    from coda_tpu_torch.selectors import TASK_EPS, make_modelpicker

    def mk(name):
        return _task(1, 4, 40, 3, name)

    runner = _runner(iters=4, seeds=2)
    results = {n: runner.run_one("model_picker", mk(n))
               for n in ("real_painting", "iwildcam", "cifar10_4070",
                         "glue/qqp")}
    assert len(runner._jitted) == 1
    assert all("epsilon" not in dict(k[1]) for k in runner._jitted)
    for name in ("real_painting", "iwildcam"):   # 0.35 vs 0.49
        ds = mk(name)
        ref = run_seeds_compiled(
            lambda p: make_modelpicker(p, epsilon=TASK_EPS[name],
                                       device="cpu"),
            ds.preds, ds.labels, iters=4, seeds=2, device="cpu")
        for f in ("chosen_idx", "regret", "best_model"):
            np.testing.assert_array_equal(
                np.asarray(getattr(results[name], f)),
                getattr(ref, f).numpy(), err_msg=name)


def test_port_suite_resume_skips_deterministic(three_tasks, tmp_path):
    from coda_tpu_torch.tracking import TrackingStore

    store = TrackingStore(str(tmp_path / "s.sqlite"))
    runner = _runner(iters=3, seeds=3)
    runner.run(three_tasks[:1], ["uncertainty"], store=store, **QUIET)
    msgs: list = []
    assert runner.run(three_tasks[:1], ["uncertainty"], store=store,
                      progress=msgs.append) == {}
    assert any("skip" in m for m in msgs)
    # every seed child was logged from the broadcast probe
    (n,) = store.query("SELECT COUNT(*) FROM tags WHERE "
                       "key='mlflow.parentRunId'")[0]
    assert n == 3
    store.close()


def test_port_suite_logs_and_resumes(three_tasks, tmp_path):
    from coda_tpu_torch.tracking import TrackingStore

    store = TrackingStore(str(tmp_path / "s.sqlite"))
    runner = _runner(iters=3, seeds=2)
    res = runner.run(three_tasks[:1], ["iid"], store=store, **QUIET)
    rows = store.query(
        """SELECT m.step, m.value FROM metrics m
           JOIN tags t ON t.run_uuid = m.run_uuid AND t.key='mlflow.runName'
           WHERE t.value='alpha-iid-0' AND m.key='regret' ORDER BY m.step""")
    assert [s for s, _ in rows] == [1, 2, 3]
    np.testing.assert_array_equal(
        np.float32([v for _, v in rows]),
        np.asarray(res[("alpha", "iid")].regret)[0])
    msgs: list = []
    assert runner.run(three_tasks[:1], ["iid"], store=store,
                      progress=msgs.append) == {}
    assert any("skip" in m for m in msgs)
    # --force-rerun runs it again
    assert len(runner.run(three_tasks[:1], ["iid"], store=store,
                          force_rerun=True, **QUIET)) == 1
    store.close()


def _write_npz(tasks, d):
    os.makedirs(d, exist_ok=True)
    for t in tasks:
        np.savez(os.path.join(d, f"{t.name}.npz"), preds=t.preds.numpy(),
                 labels=t.labels.numpy())


def test_port_cli_suite_subcommand(three_tasks, tmp_path, capsys):
    from coda_tpu_torch import cli
    from coda_tpu_torch.tracking import TrackingStore

    npdir = str(tmp_path / "preds")
    _write_npz(three_tasks, npdir)
    db = str(tmp_path / "db.sqlite")
    argv = ["suite", "--pred-dir", npdir, "--db", db, "--methods",
            "iid,coda", "--seeds", "2", "--iters", "3", "--device", "cpu"]
    assert cli.main(argv) == 0
    store = TrackingStore(db)
    assert store.query("SELECT COUNT(*) FROM experiments")[0][0] == 3
    store.close()
    capsys.readouterr()
    assert cli.main(argv) == 0
    out = capsys.readouterr().out
    assert out.count("skip ") == 6 and '"pairs_run": 0' in out
    # a mesh runs under torchrun, one process a shard: alone, this process
    # is short of the mesh's ranks (the reference's "needs" error)
    with pytest.raises(ValueError, match="mesh 2x1 needs 2 ranks, have 1"):
        cli.main(argv + ["--mesh", "data=2"])
    tdir = tmp_path / "t"
    assert cli.main(argv + ["--telemetry-dir", str(tdir)]) == 0
    assert {"trace.json", "telemetry.json", "metrics.prom"} <= \
        {p.name for p in tdir.iterdir()}


def test_port_suite_width_divergent_tiers(monkeypatch):
    """The 1-seed probe fits the incremental cache, the remaining seeds'
    batch does not: the two programs run different EIG tiers, and the
    result is whole."""
    import coda_tpu_torch.selectors.coda as coda_mod
    from coda_tpu_torch.selectors import CODAHyperparams
    from coda_tpu_torch.selectors.coda import resolve_eig_mode

    base = _task(3, 4, 24, 3, "base")
    # every point twice: EIG scores tie exactly, so the probe reports
    # stochastic and the remaining seeds run
    task = Dataset(preds=torch.cat([base.preds, base.preds], 1),
                   labels=torch.cat([base.labels, base.labels]),
                   name="ties")
    H, N, C = task.shape
    one = 4 * N * C * H
    monkeypatch.setattr(coda_mod, "_INCR_CACHE_MAX_BYTES",
                        2 * one + 4 * H * C * C)
    assert resolve_eig_mode(CODAHyperparams(n_parallel=1), H, N, C) == \
        "incremental"
    assert resolve_eig_mode(CODAHyperparams(n_parallel=4), H, N, C) == \
        "factored"
    runner = _runner(iters=5, seeds=5)
    res = runner.run_one("coda", task)
    assert np.asarray(res.stochastic).all()
    assert np.asarray(res.regret).shape == (5, 5)
    assert np.isfinite(np.asarray(res.regret)).all()
    assert {k[2] for k in runner._jitted} == {1, 4}


def test_port_suite_batched_single_task_group():
    t = _task(1, 4, 40, 3, "wine")
    r_ba = _runner(iters=2, seeds=2).run_batched(
        [[t]], ["model_picker", "iid"], **QUIET)
    r_un = _runner(iters=2, seeds=2).run([t], ["model_picker", "iid"],
                                         **QUIET)
    _bitwise(r_un, r_ba)


def test_port_suite_batch_caps_split(three_tasks):
    same = three_tasks[:2]
    r_un = _runner(iters=3, seeds=2).run(same, ["coda", "iid"], **QUIET)
    runner = _runner(iters=3, seeds=2)
    r_ba = runner.run_batched([same], ["coda", "iid"],
                              batch_caps={"coda": 1,
                                          "iid": lambda H, N, C: 2},
                              **QUIET)
    pairs = runner.last_stats["pairs"]
    assert [p["batched"] for p in pairs if p["method"] == "coda"] == [1, 1]
    assert [p["batched"] for p in pairs if p["method"] == "iid"] == [2, 2]
    _bitwise(r_un, r_ba)


@pytest.mark.parametrize("batched", [False, True])
def test_port_suite_record_streams_replay(batched, three_tasks, tmp_path):
    """Every pair's seed-0 probe lands as a record under
    ``<dir>/<family>__<method>/<task>/`` and replays bitwise on the
    port."""
    from coda_tpu_torch.engine import replay as treplay
    from coda_tpu_torch.telemetry.recorder import RunRecord

    rec_dir = str(tmp_path / "rec")
    runner = _runner(iters=3, seeds=2, record_dir=rec_dir, record_topk=4)
    if batched:
        runner.run_batched([three_tasks[:2]], ["coda", "model_picker"],
                           **QUIET)
    else:
        runner.run(three_tasks[:2], ["coda", "model_picker"], **QUIET)
    by_name = {t.name: t for t in three_tasks}
    for task in ("alpha", "beta"):
        for method in ("coda", "model_picker"):
            d = os.path.join(rec_dir, f"{family_of(task)}__{method}", task)
            rec = RunRecord.load(d)
            assert rec.violations() == []
            assert rec.meta["fingerprint"]["knobs"]["n_parallel"] == 1
            assert rec.seeds == 1 and rec.meta["trace_k"] == 4
            ds = by_name[task]
            args = treplay._args_from_record(rec)
            args.device = "cpu"
            from coda_tpu_torch.cli import build_selector_factory

            report = treplay.verify_replay(
                rec, build_selector_factory(args, task), ds.preds,
                ds.labels, score_tol=0.0, device="cpu")
            assert report.parity, treplay.format_triage(report)


def test_port_suite_db_reads_with_the_reference_aggregate(three_tasks,
                                                          tmp_path):
    """``scripts/aggregate_results.py`` (the reference's, loaded as it
    is) reads the port suite's database: the parent's mean regret is the
    mean over its seed children."""
    from coda_tpu.tracking import TrackingStore as JStore
    from coda_tpu_torch.tracking import TrackingStore

    db = str(tmp_path / "agg.sqlite")
    store = TrackingStore(db)
    res = _runner(iters=3, seeds=3).run(three_tasks[:1], ["iid"],
                                        store=store, **QUIET)
    store.close()
    spec = importlib.util.spec_from_file_location(
        "aggregate_results", os.path.join(ROOT, "scripts",
                                          "aggregate_results.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    jstore = JStore(db)
    assert mod.aggregate_metrics(jstore, quiet=True) == 6
    rows = jstore.query(
        """SELECT m.step, m.value FROM metrics m
           JOIN tags t ON t.run_uuid = m.run_uuid AND t.key='mlflow.runName'
           WHERE t.value='alpha-iid' AND m.key='mean_regret'
           ORDER BY m.step""")
    jstore.close()
    want = np.asarray(res[("alpha", "iid")].regret).astype(np.float64)
    np.testing.assert_allclose([v for _, v in rows], want.mean(0),
                               rtol=0, atol=1e-9)


def _mp_near_tie(task, seed: int, t0: int, tol: float) -> bool:
    """Whether ModelPicker's round ``t0`` of ``seed`` (the reference's
    run, replayed on the port with the reference's picks) had two
    candidates' expected entropies within ``tol``: the reference's
    recorder trace of the round's scores."""
    from coda_tpu import selectors as jsel
    from coda_tpu.data import make_synthetic_task as jtask
    from coda_tpu.engine import run_seeds_recorded as jrecorded

    jt = jtask(seed=task[0], H=task[1], N=task[2], C=task[3])
    _, aux = jrecorded(lambda p: jsel.make_modelpicker(p, epsilon=0.46),
                       jt.preds, jt.labels, iters=t0 + 1, seeds=seed + 1,
                       trace_k=2)
    gap = float(np.asarray(aux.trace.runner_up_gap)[seed, t0])
    return abs(gap) <= tol


def test_port_suite_holds_the_reference_suite():
    """The port's suite against the reference's ``SuiteRunner`` on three
    tiny tasks (one shape), every method, 3 seeds x 4 rounds."""
    import jax

    from coda_tpu.data import make_synthetic_task as jtask
    from coda_tpu.engine.suite import SuiteRunner as JSuite

    specs = {"alpha": (1, 4, 40, 3), "beta": (2, 4, 40, 3),
             "gamma": (3, 4, 40, 3)}
    jt = [jtask(seed=s, H=H, N=N, C=C, name=n)
          for n, (s, H, N, C) in specs.items()]
    tt = [_task(s, H, N, C, n) for n, (s, H, N, C) in specs.items()]
    want = JSuite(iters=4, seeds=3, cost_capture=False).run(
        jt, METHODS, **QUIET)
    got = _runner(iters=4, seeds=3).run(tt, METHODS, **QUIET)
    assert set(want) == set(got)
    flips = []
    for key in sorted(want):
        w = jax.tree.map(np.asarray, want[key])
        g = got[key]
        if key[1] == "model_picker" and not np.array_equal(
                w.chosen_idx, g.chosen_idx):
            for s in range(3):
                diff = np.nonzero(w.chosen_idx[s] != g.chosen_idx[s])[0]
                if diff.size:
                    assert _mp_near_tie(specs[key[0]], s, int(diff[0]),
                                        2.34e-4), (key, s)
                    flips.append((key, s))
            continue
        np.testing.assert_array_equal(g.chosen_idx, w.chosen_idx,
                                      err_msg=str(key))
        np.testing.assert_array_equal(g.best_model, w.best_model,
                                      err_msg=str(key))
        np.testing.assert_allclose(g.regret, w.regret, rtol=0, atol=1e-6,
                                   err_msg=str(key))
    assert len(flips) <= 3
