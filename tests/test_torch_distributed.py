"""The port's multi-process runtime (``coda_tpu_torch/parallel/
distributed.py``) and the command line under ``--mesh`` (the counterparts
of ``tests/test_distributed.py``).

One world of two CPU ranks (gloo through a ``file://`` store; each rank
finds its rank and size in torchrun's environment variables) joins
through ``initialize``, sums across the ranks, and drives the CLI with
``--mesh data=2 --device cpu``: CODA and the five baselines print the
unsharded run's result lines on rank 0 alone (rank 1 prints nothing) and
only rank 0 writes the tracking store; ``cli suite`` shards ``pyfiles``
(N=500) and loads ``iris`` (N=105) unsharded with the reference's
warning, its rows those of the unsharded suite; a task whose N does not
divide the mesh is refused on every rank. Without a world: one process
is a no-op, and each refusal of ``--mesh`` raises (too few ranks, the
serve verbs under torchrun), while every flag runs on a one-rank mesh of
the data axis or of the model axis and prints the unsharded run's
result.
"""

from __future__ import annotations

import contextlib
import io
import os
import re
import sqlite3

import pytest

from _torch_mesh_workers import REPO, spawn
from coda_tpu_torch import cli
from coda_tpu_torch.parallel.distributed import (
    choose_backend,
    initialize,
    is_primary,
)


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("world2")
    return str(tmp), spawn(2, str(tmp), ("env", "cli"), env=True)


def _run(argv) -> str:
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        assert cli.main(argv) == 0
    return buf.getvalue()


def _results(out: str) -> list:
    """The lines that carry a run's result (timing lines dropped)."""
    keep = ("Loaded", "Best possible", "EIG tier", "seed ",
            "Method is not", "skip ", "[data]")
    return [re.sub(r", \d+ items a rank on data=\d+", "", ln)
            for ln in out.splitlines() if ln.startswith(keep)]


def test_port_single_process_is_noop(monkeypatch):
    for var in ("WORLD_SIZE", "RANK", "MASTER_ADDR", "MASTER_PORT"):
        monkeypatch.delenv(var, raising=False)
    assert initialize(device="cpu") is False
    assert is_primary()
    assert choose_backend("cuda", 2, 1) == "gloo"
    assert choose_backend("cuda", 2, 2) == "nccl"
    assert choose_backend("cpu", 1, 0) == "gloo"


def test_port_two_process_initialize(world):
    """Two ranks join through torchrun's variables (``RANK``,
    ``WORLD_SIZE``): gloo on the CPU, rank 0 primary, and a rank-order
    sum across the processes on both."""
    _, ranks = world
    for r, res in enumerate(ranks):
        env = res["env"]
        assert res["joined"] is True
        assert (env["rank"], env["size"], env["backend"]) == (r, 2, "gloo")
        assert env["primary"] == (r == 0)
        assert env["sum"] == 3.0


@pytest.mark.parametrize("method", ["coda", "iid", "uncertainty",
                                    "activetesting", "vma", "model_picker"])
def test_port_cli_mesh_prints_the_unsharded_result(world, method,
                                                   tmp_path):
    """``cli --mesh data=2``: rank 0 prints the unsharded run's result
    lines (and the mesh's backend line), rank 1 prints nothing; rank 0's
    tracking store holds every seed."""
    tmp, ranks = world
    one = _run(["--synthetic", "6,64,4", "--iters", "5", "--seeds", "2",
                "--device", "cpu", "--method", method, "--tracking-db",
                str(tmp_path / "one.sqlite")])
    got = ranks[0]["cli"]["runs"][method]
    assert _results(got) == _results(one)
    assert ranks[1]["cli"]["runs"][method] == ""
    assert ranks[0]["cli"]["primary"] and not ranks[1]["cli"]["primary"]
    with sqlite3.connect(f"{tmp}/t.sqlite") as db:
        names = {r[0] for r in db.execute("SELECT name FROM runs")}
    assert {f"synthetic_6x64x4-{method}-{s}" for s in (0, 1)} <= names


def test_port_cli_suite_mesh_matches_unsharded(world, tmp_path):
    """``cli suite --mesh data=2`` over ``pyfiles`` (sharded) and ``iris``
    (N=105: unsharded, the reference's warning): the rows of rank 0's
    store are the unsharded suite's; a task whose N does not divide the
    mesh is refused on every rank with the reference's message."""
    tmp, ranks = world
    _run(["suite", "--pred-dir", f"{REPO}/data", "--tasks", "pyfiles,iris",
          "--methods", "coda,iid", "--seeds", "2", "--iters", "6",
          "--device", "cpu", "--db", str(tmp_path / "one.sqlite")])
    out = ranks[0]["cli"]["suite"]
    assert '"mesh": "data=2"' in out and '"pairs_run": 4' in out
    assert ranks[1]["cli"]["suite"] == ""

    def rows(path):
        with sqlite3.connect(path) as db:
            return sorted(db.execute(
                "SELECT r.name, m.key, m.step, m.value FROM metrics m "
                "JOIN runs r ON r.run_uuid = m.run_uuid"))

    want = rows(str(tmp_path / "one.sqlite"))
    assert want and rows(f"{tmp}/s.sqlite") == want
    for res in ranks:
        assert "N=63 not divisible by the data axis (2)" in \
            res["cli"]["odd_n"]


@pytest.mark.parametrize("flags", [
    ["--acq-batch", "2"], ["--record-dir", "REC"],
    ["--checkpoint-dir", "CK"], ["--oracle-noise", "annotators=4,votes=3"],
    ["--eig-scorer", "surrogate:8"], ["--posterior", "sparse:2"],
    ["--eig-pbest", "amortized"], ["--prefilter-n", "16"],
    ["--debug-viz"], ["--mesh", "model=1", "--acq-batch", "2"],
    ["--acq-batch", "2", "--checkpoint-dir", "CK"]])
def test_port_cli_mesh_refusals(flags, tmp_path):
    """Every flag runs under ``--mesh`` (here a one-rank mesh, of the data
    axis or of the model axis) since slice 5d: ``--record-dir`` writes a
    record with the mesh among its knobs, ``--checkpoint-dir`` saves
    under ``seed_<s>/rank_0``, ``--debug-viz`` logs its figures, and
    ``--acq-batch 2``, ``--posterior sparse:2``, ``--eig-pbest
    amortized``, ``--prefilter-n 16``, ``--eig-scorer surrogate:8`` and a
    noisy ``--oracle-noise`` print the unsharded run's result line.
    ``--acq-batch`` with ``--checkpoint-dir`` stays the reference's
    refusal, as unsharded."""
    argv = ["--synthetic", "6,64,4", "--method", "coda", "--iters", "2",
            "--seeds", "1", "--device", "cpu", "--no-mlflow"]
    rec, ck = str(tmp_path / "r"), str(tmp_path / "c")
    flags = [f.replace("REC", rec).replace("CK", ck) for f in flags]
    mesh = [] if "--mesh" in flags else ["--mesh", "data=1"]
    knobs = ("--acq-batch", "--posterior", "--eig-pbest", "--prefilter-n",
             "--eig-scorer", "--oracle-noise")
    if "--checkpoint-dir" in flags and "--acq-batch" in flags:
        with pytest.raises(SystemExit, match="--acq-batch > 1 does not "
                           "compose with --checkpoint-dir"):
            cli.main(argv + flags + mesh)
    elif flags[0] in knobs or flags[2:3] == ["--acq-batch"]:
        plain = [f for f in flags if not f.startswith(("--mesh", "model="))]

        def seed_lines(out):
            return [x for x in out.splitlines() if x.startswith("seed ")]

        got = _run(argv + flags + mesh)
        assert "seed 0: regret@2=" in got
        assert seed_lines(got) == seed_lines(_run(argv + plain))
    elif flags[0] == "--record-dir":
        assert "decision record written to" in _run(argv + flags + mesh)
        from coda_tpu_torch.telemetry.recorder import RunRecord

        knobs = RunRecord.load(rec).meta["fingerprint"]["knobs"]
        assert knobs["mesh"] == "data=1"
    elif flags[0] == "--checkpoint-dir":
        assert "seed 0: regret@2=" in _run(argv + flags + mesh)
        assert os.listdir(os.path.join(ck, "seed_0")) == ["rank_0"]
    elif flags[0] == "--debug-viz":
        pytest.importorskip("matplotlib")
        db = str(tmp_path / "v.sqlite")
        out = _run(argv[:-1] + ["--tracking-db", db] + flags + mesh)
        assert f"Logged to {db}" in out
        pngs = sorted(f for _, _, fs in os.walk(db + "_artifacts")
                      for f in fs)
        assert pngs == ["pbest.png", "regret_curve.png"]
    else:
        raise AssertionError(f"no case for {flags}")


def test_port_cli_mesh_needs_its_ranks(monkeypatch, tmp_path):
    """A mesh of more shards than ranks raises the reference's "needs"
    error; ``--task-batch`` with ``--mesh`` is the reference's parse
    error; the serve verbs under torchrun refuse to start (they run one
    process, as the reference's serve does); a one-rank mesh runs, the
    suite's ``--record-dir`` too (its record carries the mesh)."""
    argv = ["--synthetic", "6,64,4", "--method", "coda", "--iters", "2",
            "--seeds", "1", "--device", "cpu", "--no-mlflow"]
    with pytest.raises(ValueError, match="mesh 2x1 needs 2 ranks, have 1"):
        cli.main(argv + ["--mesh", "data=2"])
    assert "seed 0: regret@2=" in _run(argv + ["--mesh", "data=1"])
    suite = ["suite", "--pred-dir", f"{REPO}/data", "--tasks", "iris",
             "--methods", "iid", "--seeds", "1", "--iters", "2", "--device",
             "cpu", "--no-db", "--mesh", "data=1"]
    with pytest.raises(SystemExit) as e:
        cli.main(suite + ["--task-batch"])
    assert e.value.code == 2
    assert '"record_dir"' in _run(suite + ["--record-dir",
                                          str(tmp_path / "r")])
    from coda_tpu_torch.telemetry.recorder import RunRecord

    rec = RunRecord.load(str(tmp_path / "r" / "iris__iid" / "iris"))
    assert rec.meta["fingerprint"]["knobs"]["mesh"] == "data=1"
    monkeypatch.setenv("WORLD_SIZE", "2")
    for verb in ("serve", "replay-serve"):
        with pytest.raises(SystemExit, match="runs one process, as the "
                           "reference's serve does"):
            cli.main([verb, "--help"])
