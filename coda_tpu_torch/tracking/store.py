"""Experiment tracking: a sqlite store with the MLflow schema (counterpart
of ``coda_tpu/tracking/store.py``, a copy: the port imports nothing of the
reference package).

The runs land in the reference's layout, experiment = task -> parent run
``<experiment>-<method>`` -> one child run a seed, joined by the
``mlflow.parentRunId`` / ``mlflow.runName`` tags, with the per-round
``regret`` and ``cumulative regret`` series in ``metrics``. So the
reference's analysis (``paper/common.py``'s raw SQL over ``metrics ⋈ runs
⋈ experiments ⋈ tags``, ``scripts/aggregate_results.py``) reads a port
run unchanged, and the reference's ``TrackingStore`` and this one read
each other's databases.

The tables are MLflow's subset the analysis joins on (experiments, runs,
metrics, params, tags) plus ``latest_metrics``; sqlite runs in WAL mode
with a busy timeout, so several processes may log to one file. A metric
series is written in one ``executemany``; NaN is stored as 0.0 with
``is_nan=1`` (MLflow's convention), and re-logging a step replaces it.
"""

from __future__ import annotations

import os
import sqlite3
import time
import uuid
from typing import Iterable, Optional

_SCHEMA = """
CREATE TABLE IF NOT EXISTS experiments (
    experiment_id    INTEGER PRIMARY KEY AUTOINCREMENT,
    name             TEXT UNIQUE NOT NULL,
    artifact_location TEXT,
    lifecycle_stage  TEXT DEFAULT 'active',
    creation_time    INTEGER,
    last_update_time INTEGER
);
CREATE TABLE IF NOT EXISTS runs (
    run_uuid         TEXT PRIMARY KEY,
    name             TEXT,
    source_type      TEXT,
    source_name      TEXT,
    entry_point_name TEXT,
    user_id          TEXT,
    status           TEXT,
    start_time       INTEGER,
    end_time         INTEGER,
    source_version   TEXT,
    lifecycle_stage  TEXT DEFAULT 'active',
    artifact_uri     TEXT,
    experiment_id    INTEGER,
    deleted_time     INTEGER
);
CREATE TABLE IF NOT EXISTS metrics (
    key       TEXT NOT NULL,
    value     REAL NOT NULL,
    timestamp INTEGER NOT NULL,
    run_uuid  TEXT NOT NULL,
    step      INTEGER DEFAULT 0,
    is_nan    INTEGER DEFAULT 0,
    PRIMARY KEY (key, timestamp, step, run_uuid, value, is_nan)
);
CREATE TABLE IF NOT EXISTS params (
    key      TEXT NOT NULL,
    value    TEXT NOT NULL,
    run_uuid TEXT NOT NULL,
    PRIMARY KEY (key, run_uuid)
);
CREATE TABLE IF NOT EXISTS tags (
    key      TEXT NOT NULL,
    value    TEXT,
    run_uuid TEXT NOT NULL,
    PRIMARY KEY (key, run_uuid)
);
CREATE TABLE IF NOT EXISTS latest_metrics (
    key       TEXT NOT NULL,
    value     REAL NOT NULL,
    timestamp INTEGER,
    step      INTEGER NOT NULL,
    is_nan    INTEGER NOT NULL,
    run_uuid  TEXT NOT NULL,
    PRIMARY KEY (key, run_uuid)
);
CREATE INDEX IF NOT EXISTS idx_metrics_run ON metrics(run_uuid);
CREATE INDEX IF NOT EXISTS idx_runs_experiment ON runs(experiment_id);
"""


def _now_ms() -> int:
    # wall-clock: MLflow-schema timestamp columns are epoch ms (a timestamp)
    return int(time.time() * 1000)


class Run:
    """An open tracking run; log params/metrics, then close (or use `with`)."""

    def __init__(self, store: "TrackingStore", run_uuid: str):
        self.store = store
        self.run_uuid = run_uuid

    def log_param(self, key: str, value) -> None:
        self.store._conn.execute(
            "INSERT OR REPLACE INTO params (key, value, run_uuid) VALUES (?,?,?)",
            (str(key), str(value), self.run_uuid),
        )

    def log_params(self, params: dict) -> None:
        self.store._conn.executemany(
            "INSERT OR REPLACE INTO params (key, value, run_uuid) VALUES (?,?,?)",
            [(str(k), str(v), self.run_uuid) for k, v in params.items()],
        )

    def set_tag(self, key: str, value) -> None:
        self.store._conn.execute(
            "INSERT OR REPLACE INTO tags (key, value, run_uuid) VALUES (?,?,?)",
            (str(key), str(value), self.run_uuid),
        )

    def log_metric(self, key: str, value: float, step: int = 0) -> None:
        self.log_metric_series(key, [value], start_step=step)

    def log_metric_series(
        self, key: str, values: Iterable[float], start_step: int = 1
    ) -> None:
        """Batch-insert a whole per-step series (one executemany)."""
        self.log_metric_points(
            key, [(start_step + i, v) for i, v in enumerate(values)])

    def log_metric_points(self, key: str, points: Iterable[tuple]) -> None:
        """Batch-insert explicit ``(step, value)`` points.

        Re-logging a step replaces the old row (the PRIMARY KEY includes the
        timestamp, so INSERT OR REPLACE alone would duplicate on rerun —
        e.g. ``--force-rerun`` of a reused seed run).
        """
        ts = _now_ms()
        # sqlite binds float('nan') as NULL which violates NOT NULL; store
        # 0.0 with is_nan=1 instead (MLflow's own convention)
        rows = []
        for i, (step, v) in enumerate(points):
            v = float(v)
            is_nan = v != v
            rows.append((key, 0.0 if is_nan else v, ts + i, self.run_uuid,
                         int(step), int(is_nan)))
        if not rows:
            return
        self.store._conn.executemany(
            "DELETE FROM metrics WHERE run_uuid=? AND key=? AND step=?",
            [(self.run_uuid, key, r[4]) for r in rows],
        )
        self.store._conn.executemany(
            "INSERT INTO metrics (key, value, timestamp, run_uuid,"
            " step, is_nan) VALUES (?,?,?,?,?,?)",
            rows,
        )
        # maintain MLflow's latest_metrics (max-step row per key; what the
        # MLflow UI's run table reads)
        last = max(rows, key=lambda r: r[4])
        self.store._conn.execute(
            "INSERT INTO latest_metrics (key, value, timestamp, step,"
            " is_nan, run_uuid) VALUES (?,?,?,?,?,?)"
            " ON CONFLICT(key, run_uuid) DO UPDATE SET"
            " value=excluded.value, timestamp=excluded.timestamp,"
            " step=excluded.step, is_nan=excluded.is_nan"
            " WHERE excluded.step >= latest_metrics.step",
            (key, last[1], last[2], last[4], last[5], self.run_uuid),
        )

    def log_artifact_bytes(self, name: str, data: bytes) -> str:
        """Write ``data`` under this run's artifact dir; returns the path.

        The artifact dir is ``<db>_artifacts/<run_uuid>/`` and is recorded in
        the run's ``artifact_uri`` column (the MLflow convention the
        reference's consumers expect to exist, reference ``main.py:101-103``
        under ``_DEBUG_VIZ``).
        """
        d = os.path.join(self.store.artifact_root, self.run_uuid)
        os.makedirs(d, exist_ok=True)
        path = os.path.join(d, name)
        with open(path, "wb") as f:
            f.write(data)
        self.store._conn.execute(
            "UPDATE runs SET artifact_uri=? WHERE run_uuid=?",
            (d, self.run_uuid),
        )
        return path

    def log_figure(self, name: str, fig) -> str:
        """Rasterize a matplotlib figure and log it as a PNG artifact."""
        from coda_tpu_torch.utils.viz import fig_to_png

        if not name.endswith(".png"):
            name += ".png"
        return self.log_artifact_bytes(name, fig_to_png(fig))

    def finish(self, status: str = "FINISHED") -> None:
        self.store._conn.execute(
            "UPDATE runs SET status=?, end_time=? WHERE run_uuid=?",
            (status, _now_ms(), self.run_uuid),
        )
        self.store._conn.commit()

    def __enter__(self) -> "Run":
        return self

    def __exit__(self, exc_type, exc, tb) -> None:
        self.finish("FINISHED" if exc_type is None else "FAILED")


class TrackingStore:
    """MLflow-schema sqlite store (see module docstring)."""

    def __init__(self, db_path: str = "coda.sqlite"):
        self.db_path = db_path
        self.artifact_root = db_path + "_artifacts"
        parent = os.path.dirname(os.path.abspath(db_path))
        os.makedirs(parent, exist_ok=True)
        self._conn = sqlite3.connect(db_path, timeout=60.0)
        self._conn.execute("PRAGMA journal_mode=WAL")
        self._conn.execute("PRAGMA busy_timeout=60000")
        self._conn.executescript(_SCHEMA)
        self._conn.commit()

    # -- experiments -------------------------------------------------------
    def get_or_create_experiment(self, name: str) -> int:
        row = self._conn.execute(
            "SELECT experiment_id FROM experiments WHERE name=?", (name,)
        ).fetchone()
        if row:
            return row[0]
        now = _now_ms()
        cur = self._conn.execute(
            "INSERT INTO experiments (name, lifecycle_stage, creation_time,"
            " last_update_time) VALUES (?, 'active', ?, ?)",
            (name, now, now),
        )
        self._conn.commit()
        return cur.lastrowid

    # -- runs --------------------------------------------------------------
    def find_run(self, experiment: str, run_name: str) -> Optional[tuple[str, str]]:
        """Return (run_uuid, status) of the run with this name tag, if any."""
        row = self._conn.execute(
            """SELECT r.run_uuid, r.status FROM runs r
               JOIN experiments e ON r.experiment_id = e.experiment_id
               JOIN tags t ON t.run_uuid = r.run_uuid AND t.key='mlflow.runName'
               WHERE e.name=? AND t.value=? AND r.lifecycle_stage='active'
               ORDER BY r.start_time DESC LIMIT 1""",
            (experiment, run_name),
        ).fetchone()
        return (row[0], row[1]) if row else None

    def is_finished(self, experiment: str, run_name: str) -> bool:
        found = self.find_run(experiment, run_name)
        return bool(found and found[1] == "FINISHED")

    def run(
        self,
        experiment: str,
        run_name: str,
        parent: Optional[Run] = None,
        params: Optional[dict] = None,
        reuse: bool = True,
    ) -> Run:
        """Open (or resume) a named run. Usable as a context manager."""
        exp_id = self.get_or_create_experiment(experiment)
        existing = self.find_run(experiment, run_name) if reuse else None
        if existing:
            run_uuid = existing[0]
            self._conn.execute(
                "UPDATE runs SET status='RUNNING' WHERE run_uuid=?", (run_uuid,)
            )
        else:
            run_uuid = uuid.uuid4().hex
            self._conn.execute(
                "INSERT INTO runs (run_uuid, name, status, start_time,"
                " lifecycle_stage, experiment_id, user_id) VALUES"
                " (?, ?, 'RUNNING', ?, 'active', ?, ?)",
                (run_uuid, run_name, _now_ms(), exp_id,
                 os.environ.get("USER", "coda")),
            )
        r = Run(self, run_uuid)
        r.set_tag("mlflow.runName", run_name)
        if parent is not None:
            r.set_tag("mlflow.parentRunId", parent.run_uuid)
        if params:
            r.log_params(params)
        self._conn.commit()
        return r

    # -- queries (used by aggregation / analysis scripts) ------------------
    def child_runs(self, parent_uuid: str) -> list[str]:
        rows = self._conn.execute(
            "SELECT run_uuid FROM tags WHERE key='mlflow.parentRunId' AND value=?",
            (parent_uuid,),
        ).fetchall()
        return [r[0] for r in rows]

    def metric_series(self, run_uuid: str, key: str) -> list[tuple[int, float]]:
        rows = self._conn.execute(
            "SELECT step, value, is_nan FROM metrics WHERE run_uuid=? AND"
            " key=? ORDER BY step",
            (run_uuid, key),
        ).fetchall()
        return [(int(s), float("nan") if n else float(v)) for s, v, n in rows]

    def query(self, sql: str, params: tuple = ()) -> list[tuple]:
        return self._conn.execute(sql, params).fetchall()

    def close(self) -> None:
        self._conn.commit()
        self._conn.close()
