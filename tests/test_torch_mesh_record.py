"""The run plumbing of the port's mesh: the flight recorder, ``cli
replay``, ``cli suite --record-dir``, ``--checkpoint-dir`` and
``--debug-viz`` under ``--mesh``, against one process and against the
reference's mesh at the same spec on its 8 virtual CPU devices.

Two worlds of CPU ranks (gloo through a ``file://`` store,
``tests/_torch_mesh_workers.py``), each spawned once for the file: two
ranks that run the ``data=2`` and the ``model=2`` jobs, and four ranks at
``data=2,model=2``. On the reference's task ``make_synthetic_task(seed=7,
H=8, N=64, C=4)`` (as ``.npy`` files, so the ranks read their blocks of a
memory map), 8 rounds: every CODA tier and the four deterministic-score
baselines, and CODA's 2-seed batch, recorded under the mesh, triage as
parity against the port's unsharded records and the reference's
recorded runs at the same spec (the 2.34e-4 score contract; decisions
exact). A mesh record replays bitwise inside its world and is refused
outside it; the recorder's top k merges an exact tie across a data block
the unsharded way; a checkpointed mesh run resumes bitwise, also when a
rank lost its newest step, and not under another spec; ``cli suite
--mesh --record-dir`` writes the unsharded suite's records, and
``--debug-viz`` draws the unsharded P(best).
"""

from __future__ import annotations

import contextlib
import io
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_mesh_workers import (
    ITERS,
    REPO,
    RECORD_RUNS,
    RECORD_SPECS,
    REPLAYED,
    TASK,
    TASK_FILE,
    _tie_scores,
    record_argv,
    spawn,
    spec_dir,
)
from coda_tpu_torch import cli
from coda_tpu_torch.data import make_synthetic_arrays
from coda_tpu_torch.engine import replay as treplay
from coda_tpu_torch.parallel.mesh import DATA_AXIS, MODEL_AXIS, parse_spec
from coda_tpu_torch.telemetry import recorder as trec

SPECS = [spec for w in RECORD_SPECS for spec in RECORD_SPECS[w]]
CONTRACT = trec.CROSS_BACKEND_SCORE_TOL
JOBS = ("tie_topk", "records", "checkpoints", "suite_viz")


def _world_of(spec: str) -> int:
    sizes = parse_spec(spec)
    return sizes[DATA_AXIS] * sizes[MODEL_AXIS]


def _write_task(d) -> None:
    preds, labels = make_synthetic_arrays(**TASK)
    np.save(os.path.join(d, TASK_FILE + ".npy"), preds)
    np.save(os.path.join(d, TASK_FILE + "_labels.npy"), labels)


def _quiet(argv) -> str:
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        assert cli.main(argv) == 0
    return buf.getvalue()


@pytest.fixture(scope="module")
def worlds(tmp_path_factory):
    """Each world's tmp and per-rank results, spawned once for the
    file."""
    out = {}
    for w in RECORD_SPECS:
        tmp = tmp_path_factory.mktemp(f"record_world{w}")
        _write_task(tmp)
        out[w] = (str(tmp), spawn(w, str(tmp), JOBS))
    return out


@pytest.fixture(scope="module")
def one(tmp_path_factory):
    """The port's unsharded runs in this process: every record, the
    suite's records, the debug-viz P(best) and the CLI's printed lines."""
    tmp = tmp_path_factory.mktemp("record_one")
    _write_task(tmp)
    tmp = str(tmp)
    printed = {name: _quiet(record_argv(name, tmp) + [
        "--record-dir", os.path.join(tmp, "rec", name)])
        for name in RECORD_RUNS}
    _quiet(["suite", "--pred-dir", os.path.join(REPO, "data"),
            "--tasks", "pyfiles", "--methods", "coda,iid", "--seeds", "2",
            "--iters", "6", "--device", "cpu", "--no-db", "--record-dir",
            os.path.join(tmp, "suite")])
    from coda_tpu_torch.utils import viz

    drawn, plot_bar = [], viz.plot_bar
    viz.plot_bar = lambda v, *a, **k: (drawn.append(np.asarray(v)),
                                       plot_bar(v, *a, **k))[1]
    try:
        _quiet([a for a in record_argv("coda_batch2", tmp)
                if a != "--no-mlflow"]
               + ["--debug-viz", "--tracking-db",
                  os.path.join(tmp, "viz.sqlite")])
    finally:
        viz.plot_bar = plot_bar
    return {"tmp": tmp, "printed": printed, "pbest": drawn}


def _rank_results(worlds, spec, job):
    return [r[job][spec] for r in worlds[_world_of(spec)][1]]


def _mesh_record(worlds, spec, name) -> trec.RunRecord:
    tmp = worlds[_world_of(spec)][0]
    return trec.RunRecord.load(os.path.join(tmp, "rec", spec_dir(spec),
                                            name))


def _parity(a, b, what: str, tol: float = CONTRACT) -> None:
    report = treplay.compare_records(a, b, score_tol=tol)
    assert report.parity, f"{what}:\n{treplay.format_triage(report)}"


# -- records ---------------------------------------------------------------

@pytest.mark.parametrize("spec", SPECS)
@pytest.mark.parametrize("name", RECORD_RUNS)
def test_port_mesh_records_match_unsharded(worlds, one, spec, name):
    """A record made under ``--mesh`` triages as parity against the
    port's unsharded record of the same run (decisions exact, scores and
    the P(best) digest within 2.34e-4), with the mesh among its knobs and
    the whole task's digest; rank 0 alone writes and prints it, and every
    rank made the unsharded run's decisions."""
    got = _mesh_record(worlds, spec, name)
    want = trec.RunRecord.load(os.path.join(one["tmp"], "rec", name))
    assert got.meta["fingerprint"]["knobs"]["mesh"] == spec
    assert got.meta["fingerprint"]["dataset"] == \
        want.meta["fingerprint"]["dataset"]
    assert not got.violations()
    assert treplay._auto_tol(got, {}, against=want) == CONTRACT
    _parity(got, want, f"{name} {spec} vs unsharded")
    printed = [r["printed"][name] for r in
               _rank_results(worlds, spec, "records")]
    assert "decision record written to" in printed[0]
    assert all(p == "" for p in printed[1:])
    lines = [x for x in printed[0].splitlines() if x.startswith("seed ")]
    assert lines == [x for x in one["printed"][name].splitlines()
                     if x.startswith("seed ")]


def _ref_factory(name):
    from coda_tpu.selectors import SELECTOR_FACTORIES, CODAHyperparams
    from coda_tpu.selectors import make_coda as ref_coda

    if name.startswith("coda"):
        tier = {"coda": "incremental", "coda_batch2": "incremental"}.get(
            name, name.removeprefix("coda_"))
        return lambda p: ref_coda(p, CODAHyperparams(eig_mode=tier))
    return lambda p: SELECTOR_FACTORIES[name](p, budget=ITERS) if name in (
        "activetesting", "vma") else SELECTOR_FACTORIES[name](p)


@pytest.mark.parametrize("spec", SPECS)
@pytest.mark.parametrize("name", RECORD_RUNS)
def test_reference_mesh_records_hold(worlds, spec, name):
    """The mesh record holds against the reference's recorded run with
    the task sharded over its mesh of the same spec (``P(model, data,
    None)``, as ``tests/test_sharding.py`` shards it): the same decisions
    and round keys, scores within 2.34e-4."""
    from jax.sharding import NamedSharding, PartitionSpec as P

    from coda_tpu.data import make_synthetic_task as ref_task
    from coda_tpu.engine import run_seeds_recorded
    from coda_tpu.parallel import DATA_AXIS as REF_DATA
    from coda_tpu.parallel import mesh_from_spec, preds_sharding

    task = ref_task(**TASK)
    mesh = mesh_from_spec(spec)
    preds = jax.device_put(task.preds, preds_sharding(mesh))
    labels = jax.device_put(task.labels, NamedSharding(mesh, P(REF_DATA)))
    ref = trec.RunRecord.from_result(*run_seeds_recorded(
        _ref_factory(name), preds, labels, iters=ITERS,
        seeds=2 if name == "coda_batch2" else 1), {}, {})
    got = _mesh_record(worlds, spec, name)
    for f in ("chosen_idx", "best_model", "round_key"):
        np.testing.assert_array_equal(got.arrays[f], ref.arrays[f])
    _parity(got, ref, f"{name} {spec} vs the reference")


# -- replay ----------------------------------------------------------------

@pytest.mark.parametrize("spec", SPECS)
def test_port_mesh_replay_in_world_is_bitwise(worlds, spec):
    """``cli replay`` of a mesh record inside a world of its mesh's ranks
    re-executes it on that mesh: bitwise (the recording's backend and
    knobs), every rank exiting 0, rank 0 writing the report."""
    tmp = worlds[_world_of(spec)][0]
    for name in REPLAYED:
        assert [r["replay"][name] for r in
                _rank_results(worlds, spec, "records")] == \
            [0] * _world_of(spec)
        with open(os.path.join(tmp, "rep",
                               f"{spec_dir(spec)}_{name}.json")) as f:
            report = json.load(f)
        assert report["parity"] and report["score_tol"] == 0.0
        assert report["meta"]["mesh"] == spec
        assert len(report["seeds"]) == (2 if name == "coda_batch2" else 1)


def test_port_mesh_replay_outside_its_world_is_refused(worlds, one):
    """A mesh record is never re-executed unsharded: in one process, or
    in a world of another size, ``cli replay`` is refused naming the
    ranks it needs; ``--against`` an unsharded record compares the two
    records in one process at the 2.34e-4 contract."""
    rec = os.path.join(worlds[4][0], "rec", spec_dir("data=2,model=2"),
                       "coda")
    with pytest.raises(SystemExit, match=r"replay it on 4 ranks .*this "
                       "world has 1"):
        cli.main(["replay", rec, "--device", "cpu"])
    for w, (_, ranks) in worlds.items():
        for r in ranks:
            for spec in RECORD_SPECS[w]:
                assert "replay it on 8 ranks" in r["records"][spec][
                    "refused"]
                assert f"this world has {w}" in r["records"][spec][
                    "refused"]
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        rc = cli.main(["replay", rec, "--against",
                       os.path.join(one["tmp"], "rec", "coda")])
    assert rc == 0
    assert "knobs differ (mesh: 'data=2,model=2' vs None)" in buf.getvalue()


# -- the top k at a tie ------------------------------------------------------

@pytest.mark.parametrize("spec", SPECS)
def test_port_mesh_topk_tie_keeps_the_unsharded_order(worlds, spec):
    """Exact score ties across a data block boundary and at the k-th
    place: every rank's recorded top k (k = 8, and 40, more than a block
    holds) is the unsharded one, the lower index first among equal
    scores (``lax.top_k``'s order), and the chosen score is read from the
    rank that holds the pick."""
    from coda_tpu_torch.engine.loop import _score_digest
    from coda_tpu_torch.selectors.protocol import SelectResult

    scores, picks = _tie_scores()
    for k in (8, 40):
        one = SelectResult(idx=torch.tensor(picks[0]),
                           prob=torch.tensor(0.0),
                           stochastic=torch.tensor(False),
                           scores=torch.from_numpy(scores[0]))
        both = one._replace(idx=torch.from_numpy(picks),
                            scores=torch.from_numpy(scores))
        want = [tuple(t.numpy() for t in _score_digest(r, k))
                for r in (one, both)]
        ref_v, ref_i = jax.lax.top_k(jnp.asarray(scores), k)
        np.testing.assert_array_equal(want[1][0], np.asarray(ref_i))
        np.testing.assert_array_equal(want[1][1], np.asarray(ref_v))
        for rank, got in enumerate(_rank_results(worlds, spec, "tie_topk")):
            for g, w in zip(got[k], want):
                for a, b in zip(g, w):
                    np.testing.assert_array_equal(
                        a, b, err_msg=f"{spec} rank {rank} k={k}")


# -- checkpoints -------------------------------------------------------------

@pytest.mark.parametrize("spec", SPECS)
def test_port_mesh_checkpoint_resumes_bitwise(worlds, spec):
    """Each rank saves its own blocks under ``rank_<r>``; a run cut after
    5 rounds (saves at 2 and 4) resumes from 4 to 8, bitwise the
    uninterrupted mesh run in every field; when rank 1 lost its newest
    step, every rank resumes from the step all of them hold (2). ``cli
    --checkpoint-dir`` under ``--mesh``, cut and resumed, prints the
    uninterrupted run's lines."""
    for r in _rank_results(worlds, spec, "checkpoints"):
        for case in ("cut", "lost"):
            assert all(r[case]["bitwise"].values()), (case,
                                                      r[case]["bitwise"])
        assert r["cut"]["ops"] == [("save", 2), ("save", 4),
                                   ("restore", 4), ("save", 6)]
        assert r["lost"]["ops"] == [("save", 2), ("save", 4),
                                    ("restore", 2), ("save", 4),
                                    ("save", 6)]
        assert all(b > 0 for b in r["cut"]["bytes"])
    tmp = worlds[_world_of(spec)][0]
    ck = os.path.join(tmp, "ck", spec_dir(spec), "cut")
    assert sorted(os.listdir(ck)) == [f"rank_{r}" for r in
                                      range(_world_of(spec))]
    cut, resumed = _rank_results(worlds, spec, "checkpoints")[0]["cli"]
    printed = _rank_results(worlds, spec, "records")[0]["printed"]["coda"]
    assert "seed 0: regret@4=" in cut
    assert [x for x in resumed.splitlines() if x.startswith("seed ")] == \
        [x for x in printed.splitlines() if x.startswith("seed ")]


def test_port_mesh_checkpoint_refuses_another_layout(worlds, tmp_path):
    """A mesh checkpoint resumes only under its spec: the ``data=2``
    run's directory is refused under ``model=2`` on every rank, and by an
    unsharded runner; an unsharded run's directory is refused under a
    mesh."""
    from coda_tpu_torch.data import make_synthetic_task
    from coda_tpu_torch.engine.checkpoint import make_resumable_runner
    from coda_tpu_torch.oracle import true_losses
    from coda_tpu_torch.parallel import Mesh
    from _torch_mesh_workers import factory

    tmp, ranks = worlds[2]
    for r in ranks:
        assert "was written by a different configuration" in \
            r["checkpoints"]["other_spec"]
    task = make_synthetic_task(**TASK, device="cpu")
    losses = true_losses(task.preds, task.labels)
    sel = factory("coda")(task.preds)
    ck = os.path.join(tmp, "ck", spec_dir("data=2"), "cut")
    with pytest.raises(ValueError, match="written under a mesh"):
        make_resumable_runner(sel, task.labels, losses, ITERS, 2)(0, ck)
    plain = str(tmp_path / "plain")
    make_resumable_runner(sel, task.labels, losses, 3, 2)(0, plain)
    with pytest.raises(ValueError, match="written by an unsharded run"):
        make_resumable_runner(sel, task.labels, losses, ITERS, 2,
                              mesh=Mesh(data=1))(0, plain)


# -- the suite and --debug-viz ---------------------------------------------

@pytest.mark.parametrize("spec", SPECS)
def test_port_mesh_suite_records_match_unsharded(worlds, one, spec):
    """``cli suite --mesh SPEC --record-dir`` (``pyfiles``, CODA and
    IID): rank 0 writes each pair's record with the mesh among its knobs,
    and each triages as parity against the unsharded suite's."""
    tmp = worlds[_world_of(spec)][0]
    outs = [r["suite"] for r in _rank_results(worlds, spec, "suite_viz")]
    assert f'"mesh": "{spec}"' in outs[0] and '"record_dir"' in outs[0]
    assert all(o == "" for o in outs[1:])
    streams = sorted(os.listdir(os.path.join(one["tmp"], "suite")))
    assert len(streams) == 2
    for stream in streams:
        got = trec.RunRecord.load(os.path.join(
            tmp, "suite", spec_dir(spec), stream, "pyfiles"))
        want = trec.RunRecord.load(os.path.join(one["tmp"], "suite",
                                                stream, "pyfiles"))
        assert got.meta["fingerprint"]["knobs"]["mesh"] == spec
        assert got.meta["fingerprint"]["dataset"]["digest"] == \
            want.meta["fingerprint"]["dataset"]["digest"]
        _parity(got, want, f"suite {stream} {spec}")


@pytest.mark.parametrize("spec", SPECS)
def test_port_mesh_debug_viz_draws_the_unsharded_pbest(worlds, one, spec):
    """``--debug-viz`` under ``--mesh``: every rank replays the labels
    through ``update``, rank 0 alone draws, and each seed's P(best) bars
    are the unsharded run's within 2.34e-4 (every model's, gathered over
    the model group)."""
    ranks = _rank_results(worlds, spec, "suite_viz")
    drawn = ranks[0]["pbest"]
    assert len(drawn) == len(one["pbest"]) == 2
    for got, want in zip(drawn, one["pbest"]):
        assert got.shape == (TASK["H"],)
        np.testing.assert_allclose(got, want, rtol=0, atol=CONTRACT)
    assert all(r["pbest"] == [] for r in ranks[1:])
    assert "Logged to" in ranks[0]["viz"]
