"""The port's tracking store against the reference's (mirrors
``tests/test_tracking.py``): the same MLflow-schema sqlite, read by the
reference's analysis SQL and by each package's ``TrackingStore``, and the
port CLI's logging against the reference CLI's on the same task.

Tolerances: run names, tags, statuses, steps and NaN flags equal; the
metric values of the two CLIs' runs equal within 1e-6 (their regret
trajectories are the same on this task; values pass through float32).
"""

from __future__ import annotations

import math
import os
import sqlite3
import sys

import numpy as np
import pytest
import torch

from coda_tpu_torch.tracking import TrackingStore

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(autouse=True)
def _one_torch_thread():
    """Each test on one PyTorch thread, restored after (xdist workers share
    the cores)."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _paper_sql() -> str:
    """The reference's analysis query (``paper/common.py``'s ``_SQL``)."""
    sys.path.insert(0, os.path.join(ROOT, "paper"))
    try:
        import common
    finally:
        sys.path.remove(os.path.join(ROOT, "paper"))
    return common._SQL


def test_store_schema_and_hierarchy(tmp_path):
    store = TrackingStore(str(tmp_path / "t.sqlite"))
    with store.run("taskA", "taskA-coda",
                   params={"method": "coda"}) as parent:
        with store.run("taskA", "taskA-coda-0", parent=parent,
                       params={"seed": 0}) as child:
            child.log_metric_series("regret", [0.5, 0.3, 0.1], start_step=1)
            child.log_metric_series("cumulative regret", [0.5, 0.8, 0.9],
                                    start_step=1)
    assert store.is_finished("taskA", "taskA-coda")
    assert store.is_finished("taskA", "taskA-coda-0")
    assert not store.is_finished("taskA", "nope")
    parent_uuid = store.find_run("taskA", "taskA-coda")[0]
    children = store.child_runs(parent_uuid)
    assert len(children) == 1
    assert store.metric_series(children[0], "regret") == [
        (1, 0.5), (2, 0.3), (3, 0.1)]
    tables = {r[0] for r in store.query(
        "SELECT name FROM sqlite_master WHERE type='table'")}
    assert {"experiments", "runs", "metrics", "params", "tags",
            "latest_metrics"} <= tables
    assert store.query("PRAGMA journal_mode")[0][0] == "wal"
    try:
        with store.run("taskA", "taskA-x-0"):
            raise RuntimeError("boom")
    except RuntimeError:
        pass
    assert store.find_run("taskA", "taskA-x-0")[1] == "FAILED"
    from coda_tpu_torch.utils.viz import plot_bar

    path = store.run("taskA", "taskA-coda").log_figure(
        "f", plot_bar([0.2, 0.8], highlight=1))
    assert path.endswith("f.png")
    with open(path, "rb") as f:
        assert f.read(8) == b"\x89PNG\r\n\x1a\n"
    store.close()


def test_nan_relog_and_latest_metrics(tmp_path):
    store = TrackingStore(str(tmp_path / "db.sqlite"))
    with store.run("exp", "run") as r:
        r.log_metric_series("m", [1.0, float("nan"), 3.0])
        r.log_metric("final", 7.0, step=0)
        uuid = r.run_uuid
    assert store.query("SELECT value, is_nan FROM metrics WHERE key='m' "
                       "ORDER BY step") == [(1.0, 0), (0.0, 1), (3.0, 0)]
    series = store.metric_series(uuid, "m")
    assert series[0] == (1, 1.0) and math.isnan(series[1][1])
    latest = dict((k, (v, s)) for k, v, s in store.query(
        "SELECT key, value, step FROM latest_metrics WHERE run_uuid=?",
        (uuid,)))
    assert latest == {"m": (3.0, 3), "final": (7.0, 0)}
    with store.run("exp", "run") as r2:         # a reused run re-logs
        assert r2.run_uuid == uuid
        r2.log_metric_series("m", [5.0, 6.0, 0.5])
    assert store.metric_series(uuid, "m") == [(1, 5.0), (2, 6.0), (3, 0.5)]
    assert store.query("SELECT value, step FROM latest_metrics WHERE "
                       "run_uuid=? AND key='m'", (uuid,)) == [(0.5, 3)]
    store.close()


def _fill(store_cls, db):
    store = store_cls(db)
    for seed, final in [(0, 1.25), (1, 0.75)]:
        with store.run("cifar10_5592", "cifar10_5592-coda") as parent:
            with store.run("cifar10_5592", f"cifar10_5592-coda-{seed}",
                           parent=parent, params={"seed": seed}) as child:
                child.log_metric_series(
                    "cumulative regret",
                    np.linspace(0.0, final, 100), start_step=1)
                child.log_metric_series("regret", [float("nan"), 0.5])
    store.close()


def _dump(db) -> dict:
    """Every table's rows, without the uuids and clocks that differ from
    one run to another."""
    with sqlite3.connect(db) as conn:
        names = dict(conn.execute(
            "SELECT run_uuid, value FROM tags WHERE key='mlflow.runName'"))
        return {
            "experiments": sorted(conn.execute(
                "SELECT name, lifecycle_stage FROM experiments")),
            "runs": sorted((names[u], n, s, lc) for u, n, s, lc in
                           conn.execute("SELECT run_uuid, name, status, "
                                        "lifecycle_stage FROM runs")),
            "tags": sorted((names[u], k, names.get(v, v)) for k, v, u in
                           conn.execute("SELECT key, value, run_uuid FROM "
                                        "tags")),
            "params": sorted((names[u], k, v) for k, v, u in conn.execute(
                "SELECT key, value, run_uuid FROM params")),
            "metrics": sorted((names[u], k, s, v, n) for k, v, s, u, n in
                              conn.execute("SELECT key, value, step, "
                                           "run_uuid, is_nan FROM metrics")),
            "latest": sorted((names[u], k, s, v, n) for k, v, s, u, n in
                             conn.execute("SELECT key, value, step, "
                                          "run_uuid, is_nan FROM "
                                          "latest_metrics")),
        }


def test_reference_analysis_sql_and_cross_reading(tmp_path):
    """The reference's analysis SQL reads a port DB as the reference's; a
    DB written by either package is, row for row, the other's, and each
    package's store reads the other's."""
    from coda_tpu.tracking import TrackingStore as JStore

    mine, ref = str(tmp_path / "port.sqlite"), str(tmp_path / "ref.sqlite")
    _fill(TrackingStore, mine)
    _fill(JStore, ref)
    assert _dump(mine) == _dump(ref)
    sql = _paper_sql()
    for db in (mine, ref):
        with sqlite3.connect(db) as conn:
            rows = conn.execute(sql + "  AND m.step = ?",
                                ("cumulative regret", 100)).fetchall()
        assert sorted((r[1], r[2]) for r in rows) == [
            ("cifar10_5592-coda-0", 1.25), ("cifar10_5592-coda-1", 0.75)]
    for store_cls, db in ((JStore, mine), (TrackingStore, ref)):
        store = store_cls(db)
        parent = store.find_run("cifar10_5592", "cifar10_5592-coda")[0]
        kids = sorted(store.child_runs(parent))
        assert len(kids) == 2 and store.is_finished(
            "cifar10_5592", "cifar10_5592-coda-1")
        series = [store.metric_series(k, "regret") for k in kids]
        assert all(s[1] == (2, 0.5) and math.isnan(s[0][1]) for s in series)
        store.close()


def test_cli_resume_skips_and_force_rerun_relogs(tmp_path, capsys):
    from coda_tpu_torch.cli import main

    db = str(tmp_path / "coda.sqlite")
    argv = ["--synthetic", "6,64,4", "--method", "coda", "--iters", "4",
            "--seeds", "2", "--device", "cpu", "--tracking-db", db,
            "--experiment-name", "exp"]
    assert main(argv) == 0
    first = _dump(db)
    assert {r[0] for r in first["runs"]} == {"exp-coda", "exp-coda-0",
                                             "exp-coda-1"}
    assert capsys.readouterr().out.count("finished. Skipping") == 0
    assert main(argv) == 0
    out = capsys.readouterr().out
    assert "Seed 0 finished. Skipping." in out
    assert "Seed 1 finished. Skipping." in out
    assert _dump(db)["metrics"] == first["metrics"]
    assert main(argv + ["--force-rerun"]) == 0
    assert "Skipping" not in capsys.readouterr().out
    again = _dump(db)
    assert again["metrics"] == first["metrics"]       # replaced, not added
    assert len(again["runs"]) == 3
    assert main(argv[:-4] + ["--no-mlflow", "--tracking-db",
                             str(tmp_path / "none.sqlite")]) == 0
    assert not os.path.exists(tmp_path / "none.sqlite")


def test_cli_logs_the_reference_cli_rows(tmp_path):
    """The port CLI's default run (IID) and the reference CLI's on the same
    synthetic task write the same runs, tags, steps and metric values;
    the parent's params hold every shared flag with the same value."""
    from coda_tpu.cli import main as jmain

    from coda_tpu_torch.cli import main as tmain

    argv = ["--synthetic", "6,128,4", "--iters", "12", "--seeds", "2"]
    mine, ref = str(tmp_path / "port.sqlite"), str(tmp_path / "ref.sqlite")
    assert tmain(argv + ["--device", "cpu", "--tracking-db", mine]) == 0
    jmain(argv + ["--platform", "cpu", "--tracking-db", ref])
    a, b = _dump(mine), _dump(ref)
    for table in ("experiments", "runs", "tags"):
        assert a[table] == b[table], table
    for table in ("metrics", "latest"):
        assert [r[:3] + r[4:] for r in a[table]] == \
            [r[:3] + r[4:] for r in b[table]]
        np.testing.assert_allclose([r[3] for r in a[table]],
                                   [r[3] for r in b[table]], atol=1e-6)
    pa = {(r, k): v for r, k, v in a["params"]}
    pb = {(r, k): v for r, k, v in b["params"]}
    shared = set(pa) & set(pb)
    assert {k for _, k in shared} >= {"seed", "stochastic", "method",
                                      "iters", "seeds", "acq_batch",
                                      "eig_scorer", "tracking_db"}
    assert all(pa[k] == pb[k] for k in shared if k[1] != "tracking_db")
