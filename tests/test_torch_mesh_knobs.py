"""CODA's knobs and the q-wide round under ``--mesh``: ``--posterior
sparse:K``, ``--eig-pbest amortized``, ``--prefilter-n`` (on the EIG
acquisition and the ``q`` ablations) and ``--acq-batch q`` (CODA's
overlap re-rank on the incremental and factored tiers, the baselines'
top-q), against one process and against the reference's mesh at the same
spec on its 8 virtual CPU devices.

Two worlds of CPU ranks (gloo through a ``file://`` store,
``tests/_torch_mesh_workers.py``), each spawned once for the file (both
at once, while this process runs the reference): two ranks that run the
``data=2`` and the ``model=2`` jobs, and four ranks at
``data=2,model=2``. On the reference's task ``make_synthetic_task(seed=7,
H=8, N=64, C=4)`` (as ``.npy`` files), 8 rounds, every run of
``KNOB_RUNS`` is recorded under the mesh, triages as parity against the
port's unsharded record (decisions exact, scores within 2.34e-4) and
replays bitwise inside its world; each but the dense and ``sparse:4``
runs also holds against the reference's recorded run at the same spec.
``sparse:4`` (K >= C) is bitwise the dense posterior on the mesh; the amortized gate engages in the unsharded run's rounds on every
rank, and a class row whose models clear the gate on one rank's block
only is taken as closed by the whole model group; an exact tie of the
prefilter's uniforms across a data block boundary gives the unsharded
subset and threshold; a ``sparse:2`` run cut and resumed from its
checkpoint is bitwise the uninterrupted one.
"""

from __future__ import annotations

import contextlib
import io
import json
import os

import jax
import numpy as np
import pytest
import torch

from _torch_mesh_workers import (
    AMORT_MULTIPLIER,
    ITERS,
    KNOB_RUNS,
    PREFILTER_N,
    RECORD_SPECS,
    TASK,
    TASK_FILE,
    gate_case,
    gates_seen,
    finish,
    knob_argv,
    spec_dir,
    start,
    tie_factory,
    tie_select,
)
from coda_tpu_torch import cli
from coda_tpu_torch.data import make_synthetic_arrays, make_synthetic_task
from coda_tpu_torch.engine import replay as treplay
from coda_tpu_torch.parallel.mesh import DATA_AXIS, MODEL_AXIS, parse_spec
from coda_tpu_torch.telemetry import recorder as trec

SPECS = [spec for w in RECORD_SPECS for spec in RECORD_SPECS[w]]
CONTRACT = trec.CROSS_BACKEND_SCORE_TOL
JOBS = ("knobs", "knob_cases")
# the runs held to the reference: the dense ones are
# test_torch_mesh_record.py's, and sparse:4 (K >= C) is bitwise the dense
# posterior on the mesh (test_port_mesh_sparse_full_is_dense)
HELD = tuple(n for n in KNOB_RUNS if not n.startswith(("dense", "sparse4")))
MODEL_SPECS = [s for s in SPECS if parse_spec(s)[MODEL_AXIS] > 1]
# the reference's form of each held run: (method, CODA knobs, q)
_REF = {
    "sparse2": ("coda", dict(eig_mode="incremental", posterior="sparse:2"),
                1),
    "amortized": ("coda", dict(eig_mode="incremental",
                               eig_pbest="amortized",
                               multiplier=float(AMORT_MULTIPLIER)), 1),
    "prefilter": ("coda", dict(prefilter_n=PREFILTER_N), 1),
    "prefilter_iid": ("coda", dict(q="iid", prefilter_n=PREFILTER_N), 1),
    "prefilter_unc": ("coda", dict(q="uncertainty",
                                   prefilter_n=PREFILTER_N), 1),
    "q2": ("coda", dict(eig_mode="incremental"), 2),
    "q4": ("coda", dict(eig_mode="incremental"), 4),
    "q2_factored": ("coda", dict(eig_mode="factored"), 2),
    "q4_factored": ("coda", dict(eig_mode="factored"), 4),
    "iid_q4": ("iid", {}, 4),
    "uncertainty_q2": ("uncertainty", {}, 2),
    "model_picker_q4": ("model_picker", {}, 4),
}
_REF["sparse2_batch2"] = _REF["sparse2"]


def _world_of(spec: str) -> int:
    sizes = parse_spec(spec)
    return sizes[DATA_AXIS] * sizes[MODEL_AXIS]


def _write_task(d) -> None:
    preds, labels = make_synthetic_arrays(**TASK)
    np.save(os.path.join(d, TASK_FILE + ".npy"), preds)
    np.save(os.path.join(d, TASK_FILE + "_labels.npy"), labels)


def _ref_factory(name):
    from coda_tpu.selectors import SELECTOR_FACTORIES, CODAHyperparams
    from coda_tpu.selectors import make_coda as ref_coda

    method, knobs, _ = _REF[name]
    if method == "coda":
        return lambda p: ref_coda(p, CODAHyperparams(**knobs))
    return lambda p: SELECTOR_FACTORIES[method](p)


def _reference_record(spec: str, name: str) -> trec.RunRecord:
    """The reference's recorded run of ``name``'s knobs with the task
    sharded over its mesh of ``spec`` (``P(model, data, None)``, as
    ``tests/test_sharding.py`` shards it)."""
    from jax.sharding import NamedSharding, PartitionSpec as P

    from coda_tpu.data import make_synthetic_task as ref_task
    from coda_tpu.engine import run_seeds_recorded
    from coda_tpu.parallel import DATA_AXIS as REF_DATA
    from coda_tpu.parallel import mesh_from_spec, preds_sharding

    task = ref_task(**TASK)
    mesh = mesh_from_spec(spec)
    preds = jax.device_put(task.preds, preds_sharding(mesh))
    labels = jax.device_put(task.labels, NamedSharding(mesh, P(REF_DATA)))
    return trec.RunRecord.from_result(*run_seeds_recorded(
        _ref_factory(name), preds, labels, iters=ITERS,
        seeds=KNOB_RUNS[name][1], acq_batch=_REF[name][2]), {}, {})


@pytest.fixture(scope="module")
def worlds(tmp_path_factory):
    """Each world's tmp and per-rank results, both spawned once for the
    file and at once; meanwhile this process runs the reference's record
    of every held run at every spec (``refs``)."""
    started = {}
    try:
        for w in RECORD_SPECS:
            tmp = tmp_path_factory.mktemp(f"knob_world{w}")
            _write_task(tmp)
            started[w] = (str(tmp), start(w, str(tmp), JOBS))
        refs = {(spec, name): _reference_record(spec, name)
                for spec in SPECS for name in HELD}
        out = {w: (tmp, finish(ctx, w, tmp))
               for w, (tmp, ctx) in started.items()}
    except BaseException:
        for _, ctx in started.values():
            for proc in ctx.processes:
                proc.terminate()
        raise
    out["refs"] = refs
    return out


@pytest.fixture(scope="module")
def one(tmp_path_factory):
    """The port's unsharded runs in this process: every record of
    ``KNOB_RUNS``, the amortized run's gate verdicts, the prefilter's
    select under the tie draw and the amortized row of the gate case."""
    from coda_tpu_torch.ops.pbest import _pbest_hyp_row_gated

    tmp = tmp_path_factory.mktemp("knob_one")
    _write_task(tmp)
    tmp = str(tmp)
    gates: list = []
    for name in KNOB_RUNS:
        with contextlib.redirect_stdout(io.StringIO()), gates_seen(
                gates if name == "amortized" else []):
            assert cli.main(knob_argv(name, tmp) + [
                "--record-dir", os.path.join(tmp, "rec", name)]) == 0
    task = make_synthetic_task(**TASK, device="cpu")
    z = gate_case()
    rows = {}
    for case, lift in (("split", 0.0), ("both", 20.0)):
        b = z["b"] + np.where(np.arange(8) >= 4, lift, 0.0).astype(
            np.float32)
        seen: list = []
        with gates_seen(seen):
            rows[case] = (seen, _pbest_hyp_row_gated(
                torch.from_numpy(z["a"]), torch.from_numpy(b),
                torch.from_numpy(z["eq"]), 1.0, 64, 32.0).numpy())
    return {"tmp": tmp, "gates": gates, "rows": rows,
            "tie": tie_select(tie_factory, task.preds, task.labels)}


def _rank_results(worlds, spec, job):
    return [r[job][spec] for r in worlds[_world_of(spec)][1]]


def _mesh_record(worlds, spec, name) -> trec.RunRecord:
    tmp = worlds[_world_of(spec)][0]
    return trec.RunRecord.load(os.path.join(tmp, "knobs", spec_dir(spec),
                                            name))


def _parity(a, b, what: str, tol: float = CONTRACT) -> None:
    report = treplay.compare_records(a, b, score_tol=tol)
    assert report.parity, f"{what}:\n{treplay.format_triage(report)}"


def _block(a: np.ndarray, spec: str, rank: int, axis: int = -1):
    """Rank ``rank``'s N block of a per-item array at ``spec``."""
    sizes = parse_spec(spec)
    n = a.shape[axis] // sizes[DATA_AXIS]
    i = rank // sizes[MODEL_AXIS]
    return np.take(a, np.arange(i * n, (i + 1) * n), axis=axis)


# -- records ---------------------------------------------------------------

@pytest.mark.parametrize("spec", SPECS)
@pytest.mark.parametrize("name", list(KNOB_RUNS))
def test_port_mesh_knob_records_match_unsharded(worlds, one, spec, name):
    """A run of each knob recorded under ``--mesh`` triages as parity
    against the port's unsharded record of the same run (decisions
    exact, scores and the P(best) digest within 2.34e-4), with the mesh
    among its knobs; rank 0 alone writes and prints it, and its result
    lines are the unsharded run's."""
    got = _mesh_record(worlds, spec, name)
    want = trec.RunRecord.load(os.path.join(one["tmp"], "rec", name))
    assert got.meta["fingerprint"]["knobs"]["mesh"] == spec
    assert not got.violations()
    _parity(got, want, f"{name} {spec} vs unsharded")
    for f in ("chosen_idx", "true_class", "best_model"):
        np.testing.assert_array_equal(got.arrays[f], want.arrays[f],
                                      err_msg=f"{name} {spec} {f}")
    printed = [r["printed"][name] for r in
               _rank_results(worlds, spec, "knobs")]
    assert "decision record written to" in printed[0]
    assert all(p == "" for p in printed[1:])


@pytest.mark.parametrize("spec", SPECS)
@pytest.mark.parametrize("name", HELD)
def test_reference_mesh_knob_records_hold(worlds, spec, name):
    """The mesh record holds against the reference's recorded run of the
    same knobs with the task sharded over its mesh of the same spec
    (``P(model, data, None)``, as ``tests/test_sharding.py`` shards it):
    the same decisions and round keys, scores within 2.34e-4."""
    ref = worlds["refs"][(spec, name)]
    got = _mesh_record(worlds, spec, name)
    for f in ("chosen_idx", "best_model", "round_key"):
        np.testing.assert_array_equal(got.arrays[f], ref.arrays[f],
                                      err_msg=f"{name} {spec} {f}")
    _parity(got, ref, f"{name} {spec} vs the reference")


@pytest.mark.parametrize("spec", SPECS)
def test_port_mesh_knob_replay_in_world_is_bitwise(worlds, spec):
    """``cli replay`` of each knob's mesh record inside a world of its
    mesh's ranks re-executes it on that mesh: bitwise (the recording's
    backend and knobs), every rank exiting 0."""
    tmp = worlds[_world_of(spec)][0]
    ranks = _rank_results(worlds, spec, "knobs")
    for name in KNOB_RUNS:
        assert [r["replay"][name] for r in ranks] == \
            [0] * _world_of(spec), name
        with open(os.path.join(tmp, "knobrep",
                               f"{spec_dir(spec)}_{name}.json")) as f:
            report = json.load(f)
        assert report["parity"] and report["score_tol"] == 0.0, name
        assert report["meta"]["mesh"] == spec
        assert len(report["seeds"]) == KNOB_RUNS[name][1]


# -- the sparse posterior --------------------------------------------------

@pytest.mark.parametrize("spec", SPECS)
def test_port_mesh_sparse_full_is_dense(worlds, spec):
    """``sparse:K`` with K >= C keeps the parity layout on every rank's
    models: its mesh records, one seed and a 2-seed batch, are bitwise
    the dense posterior's mesh records in every array."""
    for sparse, dense in (("sparse4", "dense"),
                          ("sparse4_batch2", "dense_batch2")):
        got = _mesh_record(worlds, spec, sparse)
        want = _mesh_record(worlds, spec, dense)
        assert set(got.arrays) == set(want.arrays)
        for f, arr in got.arrays.items():
            np.testing.assert_array_equal(arr, want.arrays[f],
                                          err_msg=f"{sparse} {spec} {f}")


@pytest.mark.parametrize("spec", SPECS)
def test_port_mesh_sparse_checkpoint_resumes_bitwise(worlds, spec):
    """A ``sparse:2`` mesh run, each rank saving its own ``SparseRows``
    block under ``rank_<r>``, cut after 5 rounds (saves at 2 and 4) and
    resumed from 4 to 8, is bitwise the uninterrupted mesh run in every
    field."""
    tmp = worlds[_world_of(spec)][0]
    for r in _rank_results(worlds, spec, "knob_cases"):
        cut = r["sparse_ckpt"]["cut"]
        assert all(cut["bitwise"].values()), cut["bitwise"]
        assert cut["ops"] == [("save", 2), ("save", 4), ("restore", 4),
                              ("save", 6)]
    ck = os.path.join(tmp, "ck", spec_dir(spec), "sparse2_cut")
    assert sorted(os.listdir(ck)) == [f"rank_{r}" for r in
                                      range(_world_of(spec))]


# -- the amortized P(best) ---------------------------------------------------

@pytest.mark.parametrize("spec", SPECS)
def test_port_mesh_amortized_gate_engages_as_unsharded(worlds, one, spec):
    """The amortized run's gate (one verdict a round) is the same on
    every rank and engages in the unsharded run's rounds: some, not all
    (the prior's rows sit just under the gate)."""
    want = one["gates"]
    flat = [g for v in want for g in v]
    assert len(want) == ITERS and any(flat) and not all(flat)
    for rank, r in enumerate(_rank_results(worlds, spec, "knobs")):
        assert r["gates"] == want, f"{spec} rank {rank}"


@pytest.mark.parametrize("spec", MODEL_SPECS)
def test_port_mesh_amortized_gate_split_takes_one_branch(worlds, one,
                                                          spec):
    """A class row whose models clear the gate on one rank's H block and
    not on the other's: every rank of the model group takes the
    quadrature, as the unsharded refresh does over all 8 models, and its
    columns are the unsharded row's; with both blocks above the gate
    every rank takes the amortized tables."""
    b = parse_spec(spec)[MODEL_AXIS]
    h = 8 // b
    for rank, r in enumerate(_rank_results(worlds, spec, "knob_cases")):
        j = rank % b
        for case, engaged in (("split", False), ("both", True)):
            seen, row = one["rows"][case]
            assert seen == [[engaged]]
            got = r["gate"][case]
            assert got["gates"] == [[engaged]], (spec, rank, case)
            np.testing.assert_allclose(
                got["row"], row[:, j * h:(j + 1) * h], rtol=1e-6,
                atol=1e-7, err_msg=f"{spec} rank {rank} {case}")


# -- the prefilter -----------------------------------------------------------

@pytest.mark.parametrize("spec", SPECS)
def test_port_mesh_prefilter_tie_across_blocks(worlds, one, spec):
    """The prefilter's uniforms tied exactly across the data block
    boundary (31 | 32) and at the K-th place: every rank takes the
    unsharded subset (the largest candidates, then the 0.5 tie in index
    order, from both blocks) and the unsharded ablation threshold, picks
    the unsharded item, and records its block's scores (the pick's too)
    within 2.34e-4 of the unsharded ones."""
    want = one["tie"]
    values, subset = want["eig"]["subsets"][0]
    tied = [i for v, i in zip(values, subset) if v == 0.5]
    assert values[-1] == 0.5 and tied == sorted(tied)
    assert min(tied) < 32 <= max(tied)          # the tie spans the blocks
    assert want["iid"]["subsets"][0][0][PREFILTER_N - 1] == 0.5
    for rank, r in enumerate(_rank_results(worlds, spec, "knob_cases")):
        for q in ("eig", "iid"):
            got, w = r["tie"][q], want[q]
            what = f"{spec} rank {rank} q={q}"
            assert got["subsets"][0] == w["subsets"][0], what
            assert got["idx"] == w["idx"], what
            np.testing.assert_allclose(got["prob"], w["prob"], rtol=0,
                                       atol=CONTRACT, err_msg=what)
            ref = _block(w["scores"], spec, rank)
            np.testing.assert_array_equal(np.isfinite(got["scores"]),
                                          np.isfinite(ref), err_msg=what)
            fin = np.isfinite(ref)
            np.testing.assert_allclose(got["scores"][fin], ref[fin],
                                       rtol=0, atol=CONTRACT, err_msg=what)
