"""The surrogate scorer (``--eig-scorer surrogate:k``, ``--surrogate-prior
pool``) and the noisy crowd (``--oracle-noise``) under ``--mesh``, against
one process and against the reference's mesh at the same spec on its 8
virtual CPU devices.

Two worlds of CPU ranks (gloo through a ``file://`` store,
``tests/_torch_mesh_workers.py``), each spawned once for the file (both at
once, while this process runs the reference and the port's unsharded
runs): two ranks that run the ``data=2`` and the ``model=2`` jobs, and four
ranks at ``data=2,model=2``. On the reference's task
``make_synthetic_task(seed=7, H=8, N=64, C=4)`` (as ``.npy`` files):

  * every run of ``SC_RUNS`` (``surrogate:8`` over 16 rounds, cold and
    under the pool knob; the reference's noisy crowd over 8 rounds, one
    seed, a 2-seed batch and ``--acq-batch 2``) is recorded under the
    mesh, triages as parity — or as a ``tie-break-flip`` within 2.34e-4 —
    against the port's unsharded record and against the reference's
    recorded run at the same spec, and replays bitwise inside its world;
  * the surrogate's fit after every round is bitwise equal across the
    ranks of a world and within ``FIT`` of the unsharded fit (sums over
    models and items added in another order); the rounds that take the
    hybrid vector are the unsharded run's on every rank, some of them
    past warmup; the same with the fit seeded from a pool (a real
    session's normal equations with warmup credit), whose run also
    re-executes bitwise on the mesh;
  * the crowd's votes, applied labels, weights and reliability counts are
    bitwise the unsharded port's on every rank;
  * a crowd baseline and a noisy crowd with ``--checkpoint-dir`` still
    raise on a mesh;
  * the confusion prior's chunked data-group sum is bitwise the whole
    sum in a 2-rank world.
"""

from __future__ import annotations

import contextlib
import io
import json
import os

import jax
import numpy as np
import pytest

from _torch_mesh_workers import (
    CROWD_SPEC,
    PRIOR_FILE,
    RECORD_SPECS,
    SC_REFUSED,
    SC_RUNS,
    SURROGATE_ITERS,
    SURROGATE_K,
    TASK,
    TASK_FILE,
    crowd_seen,
    finish,
    sc_argv,
    spec_dir,
    start,
    surrogate_factory,
    surrogate_internals,
)
from coda_tpu_torch import cli
from coda_tpu_torch.data import make_synthetic_arrays, make_synthetic_task
from coda_tpu_torch.engine import replay as treplay
from coda_tpu_torch.parallel.mesh import DATA_AXIS, MODEL_AXIS, parse_spec
from coda_tpu_torch.selectors import surrogate as tsg
from coda_tpu_torch.telemetry import recorder as trec

SPECS = [spec for w in RECORD_SPECS for spec in RECORD_SPECS[w]]
CONTRACT = trec.CROSS_BACKEND_SCORE_TOL
CROWD_RUNS = tuple(n for n in SC_RUNS if n.startswith("crowd"))
# the runs held to the reference (the pool knob without a pool is the
# cold program, test_port_mesh_pool_knob_is_the_cold_program)
HELD = ("surrogate",) + CROWD_RUNS
CASES = ("cold", "seeded")
# the fit against the unsharded fit (the largest differences seen, at
# every spec: A 1.9e-5 relative, b 5.6e-5 and w 2.7e-6 absolute, n 0,
# the class summaries 1.2e-7): A and the class summaries add the same
# terms in another order; b sums features times residuals, each the
# difference of two O(1) scores that the mesh reproduces to a few ulps
# (the records' scores within 4.8e-7), so it is held absolutely, as is
# w, the 16x16 fp32 solve of A and b; n counts the pairs, exactly
FIT = {"A": dict(rtol=1e-4, atol=0), "b": dict(rtol=0, atol=2e-4),
       "n": dict(rtol=0, atol=0), "cls_feats": dict(rtol=1e-6, atol=1e-6),
       "w": dict(rtol=0, atol=2e-5)}


def _world_of(spec: str) -> int:
    sizes = parse_spec(spec)
    return sizes[DATA_AXIS] * sizes[MODEL_AXIS]


def _pool() -> tsg.PriorStats:
    """A pool of one real session: the normal equations of an unsharded
    ``surrogate:8`` run of 12 rounds on another draw of the task's shape
    (warmup credit 10)."""
    preds, labels = make_synthetic_arrays(seed=8, H=8, N=64, C=4)[:2]
    fits = surrogate_internals(surrogate_factory(), preds, labels)["fits"]
    f = fits[11]
    return tsg.prior_from_fit(f["A"], f["b"], f["n"], 12)


def _write_inputs(d, prior) -> None:
    preds, labels = make_synthetic_arrays(**TASK)
    np.save(os.path.join(d, TASK_FILE + ".npy"), preds)
    np.save(os.path.join(d, TASK_FILE + "_labels.npy"), labels)
    with open(os.path.join(d, PRIOR_FILE), "w") as f:
        json.dump(tsg.prior_to_dict(prior), f)


def _ref_record(spec: str, name: str, prior=None) -> trec.RunRecord:
    """The reference's recorded run of ``name`` (or of the seeded
    surrogate, ``prior``) with the task sharded over its mesh of ``spec``
    (``P(model, data, None)``, as ``tests/test_sharding.py`` shards it)."""
    from jax.sharding import NamedSharding, PartitionSpec as P

    from coda_tpu.crowd.loop import run_seeds_crowd_recorded
    from coda_tpu.crowd.oracle import parse_oracle_spec
    from coda_tpu.data import make_synthetic_task as ref_task
    from coda_tpu.engine import run_seeds_recorded
    from coda_tpu.parallel import DATA_AXIS as REF_DATA
    from coda_tpu.parallel import mesh_from_spec, preds_sharding
    from coda_tpu.selectors import CODAHyperparams, make_coda
    from coda_tpu.selectors import surrogate as jsg

    task = ref_task(**TASK)
    mesh = mesh_from_spec(spec)
    preds = jax.device_put(task.preds, preds_sharding(mesh))
    labels = jax.device_put(task.labels, NamedSharding(mesh, P(REF_DATA)))
    if name.startswith("crowd"):
        _, seeds, iters = SC_RUNS[name]
        hp = CODAHyperparams(eig_mode="incremental")
        res, aux, crowd = run_seeds_crowd_recorded(
            lambda p: make_coda(p, hp), preds, labels,
            parse_oracle_spec(CROWD_SPEC), iters=iters, seeds=seeds,
            acq_batch=2 if name == "crowd_q2" else 1)
        return trec.RunRecord.from_result(
            res, aux, {"knobs": {"oracle_noise": CROWD_SPEC}}, {},
            crowd=crowd)
    hp = CODAHyperparams(eig_mode="incremental",
                         eig_scorer=f"surrogate:{SURROGATE_K}",
                         surrogate_prior="off" if prior is None else "pool")
    jprior = None if prior is None else jsg.PriorStats(*prior)
    # the knobs the triage dispatches on, as the port's record has them
    knobs = {} if prior is not None else {"eig_scorer": hp.eig_scorer}
    return trec.RunRecord.from_result(*run_seeds_recorded(
        lambda p: make_coda(p, hp, prior=jprior), preds, labels,
        iters=SURROGATE_ITERS, seeds=1), {"knobs": knobs}, {})


def _one(tmp: str, prior) -> dict:
    """The port's unsharded runs: every record of ``SC_RUNS`` through the
    CLI (the crowd's votes and counts kept) and the surrogate's internals
    cold and seeded."""
    out = {"crowd": {}}
    for name in SC_RUNS:
        seen: dict = {}
        with contextlib.redirect_stdout(io.StringIO()), crowd_seen(seen):
            assert cli.main(sc_argv(name, tmp) + [
                "--record-dir", os.path.join(tmp, "rec", name)]) == 0
        out["crowd"][name] = seen
    task = make_synthetic_task(**TASK, device="cpu")
    for case, pool in (("cold", None), ("seeded", prior)):
        out[case] = surrogate_internals(surrogate_factory(pool), task.preds,
                                        task.labels)
    return out


@pytest.fixture(scope="module")
def worlds(tmp_path_factory):
    """Each world's tmp and per-rank results, both spawned once for the
    file and at once; meanwhile this process runs the reference's records
    (``refs``) and the port's unsharded runs (``one``)."""
    prior = _pool()
    started = {}
    try:
        for w in RECORD_SPECS:
            tmp = tmp_path_factory.mktemp(f"sc_world{w}")
            _write_inputs(tmp, prior)
            jobs = ("surrogate_crowd",) + (("prior_chunks",) if w == 2
                                           else ())
            started[w] = (str(tmp), start(w, str(tmp), jobs))
        one_tmp = str(tmp_path_factory.mktemp("sc_one"))
        _write_inputs(one_tmp, prior)
        one = _one(one_tmp, prior)
        refs = {(spec, name): _ref_record(spec, name)
                for spec in SPECS for name in HELD}
        refs.update({(spec, "seeded"): _ref_record(spec, "seeded", prior)
                     for spec in SPECS})
        out = {w: (tmp, finish(ctx, w, tmp))
               for w, (tmp, ctx) in started.items()}
    except BaseException:
        for _, ctx in started.values():
            for proc in ctx.processes:
                proc.terminate()
        raise
    out.update(refs=refs, one=one, one_tmp=one_tmp)
    return out


def _ranks(worlds, spec):
    return [r["surrogate_crowd"][spec] for r in worlds[_world_of(spec)][1]]


def _mesh_record(worlds, spec, name) -> trec.RunRecord:
    tmp = worlds[_world_of(spec)][0]
    return trec.RunRecord.load(os.path.join(tmp, "sc", spec_dir(spec),
                                            name))


def _hold(got, want, what: str) -> None:
    """Each seed at parity, or first diverging at a near tie (a
    ``tie-break-flip``, or the q-wide first-pick flip, at a gap within
    2.34e-4); before it the same decisions."""
    report = treplay.compare_records(got, want, score_tol=CONTRACT)
    for s in report.seeds:
        T = got.rounds if s.parity else s.first_divergent_round
        if not s.parity:
            gap = float(want.arrays["runner_up_gap"][s.seed, T])
            assert s.classification == "tie-break-flip" or (
                got.acq_batch > 1 and treplay.first_pick_flip(
                    want, got, s.seed, T, CONTRACT)), \
                f"{what}:\n{treplay.format_triage(report)}"
            assert abs(gap) <= CONTRACT, (what, s.to_dict(), gap)
        a, b = got.seed_arrays(s.seed), want.seed_arrays(s.seed)
        for f in ("chosen_idx", "true_class", "best_model", "round_key"):
            np.testing.assert_array_equal(a[f][:T], b[f][:T],
                                          err_msg=f"{what} {f}")


# -- records ---------------------------------------------------------------

@pytest.mark.parametrize("spec", SPECS)
@pytest.mark.parametrize("name", list(SC_RUNS))
def test_port_mesh_sc_records_match_unsharded(worlds, spec, name):
    """A run of each recorded under ``--mesh`` triages as parity (or a
    near-tie flip) against the port's unsharded record of the same run,
    with the mesh and the crowd's spec among its knobs; rank 0 alone
    writes and prints it."""
    got = _mesh_record(worlds, spec, name)
    want = trec.RunRecord.load(os.path.join(worlds["one_tmp"], "rec", name))
    knobs = got.meta["fingerprint"]["knobs"]
    assert knobs["mesh"] == spec
    assert knobs.get("oracle_noise") == (CROWD_SPEC if name in CROWD_RUNS
                                         else None)
    assert not got.violations()
    _hold(got, want, f"{name} {spec} vs unsharded")
    printed = [r["printed"][name] for r in _ranks(worlds, spec)]
    assert "decision record written to" in printed[0]
    assert all(p == "" for p in printed[1:])


@pytest.mark.parametrize("spec", SPECS)
def test_port_mesh_seeded_surrogate_matches_unsharded(worlds, spec):
    """The surrogate seeded from a pool (``surrogate_prior='pool'`` with
    a ``PriorStats``) on the mesh triages as parity (or a near-tie flip)
    against the port's unsharded seeded run, on every rank."""
    want = worlds["one"]["seeded"]["record"]
    for rank, r in enumerate(_ranks(worlds, spec)):
        _hold(r["seeded"]["record"], want, f"seeded {spec} rank {rank}")


@pytest.mark.parametrize("spec", SPECS)
@pytest.mark.parametrize("name", HELD + ("seeded",))
def test_reference_mesh_sc_records_hold(worlds, spec, name):
    """The mesh record holds against the reference's recorded run with the
    task sharded over its mesh of the same spec: the same decisions and
    round keys up to a near-tie flip, scores within 2.34e-4; the seeded
    surrogate's record too (the reference seeded from the same pool)."""
    ref = worlds["refs"][(spec, name)]
    got = (_ranks(worlds, spec)[0]["seeded"]["record"] if name == "seeded"
           else _mesh_record(worlds, spec, name))
    _hold(got, ref, f"{name} {spec} vs the reference")
    if name == "surrogate":
        T = SURROGATE_ITERS
        np.testing.assert_array_equal(got.arrays["surrogate_fallback"][:, :T],
                                      ref.arrays["surrogate_fallback"][:, :T])


@pytest.mark.parametrize("spec", SPECS)
def test_port_mesh_sc_replay_in_world_is_bitwise(worlds, spec):
    """``cli replay`` of each mesh record inside a world of its mesh's
    ranks re-executes it on that mesh (the crowd's records re-execute the
    crowd): bitwise, every rank exiting 0; the seeded surrogate's run
    re-executed through ``verify_replay`` on the mesh is bitwise too."""
    tmp = worlds[_world_of(spec)][0]
    ranks = _ranks(worlds, spec)
    for name in SC_RUNS:
        assert [r["replay"][name] for r in ranks] == \
            [0] * _world_of(spec), name
        with open(os.path.join(tmp, "screp",
                               f"{spec_dir(spec)}_{name}.json")) as f:
            report = json.load(f)
        assert report["parity"] and report["score_tol"] == 0.0, name
        assert report["meta"]["mesh"] == spec
        assert len(report["seeds"]) == SC_RUNS[name][1]
    for r in ranks:
        assert r["seeded_replay"]["parity"]
        assert r["seeded_replay"]["score_tol"] == 0.0


@pytest.mark.parametrize("spec", SPECS)
def test_port_mesh_pool_knob_is_the_cold_program(worlds, spec):
    """``--surrogate-prior pool`` from the CLI (which passes no pool) runs
    the cold program on the mesh: its record's arrays are bitwise the
    cold surrogate's."""
    got = _mesh_record(worlds, spec, "surrogate_pool")
    want = _mesh_record(worlds, spec, "surrogate")
    assert got.meta["fingerprint"]["knobs"]["surrogate_prior"] == "pool"
    for f, arr in want.arrays.items():
        np.testing.assert_array_equal(got.arrays[f], arr, err_msg=f)


# -- the surrogate's internals -------------------------------------------------

@pytest.mark.parametrize("spec", SPECS)
@pytest.mark.parametrize("case", CASES)
def test_port_mesh_surrogate_fit_is_bitwise_across_ranks(worlds, spec,
                                                          case):
    """The fit after every round (A, b, w, n and the class summaries) is
    bitwise the same on every rank of the world — the host branch each
    round takes depends on it — and within ``FIT`` of the unsharded
    fit."""
    ranks = _ranks(worlds, spec)
    want = worlds["one"][case]["fits"]
    assert len(want) == SURROGATE_ITERS
    for rank, r in enumerate(ranks):
        fits = r[case]["fits"]
        assert len(fits) == SURROGATE_ITERS
        for t, (f, f0, w) in enumerate(zip(fits, ranks[0][case]["fits"],
                                           want)):
            for k, tol in FIT.items():
                what = f"{spec} {case} rank {rank} round {t} {k}"
                assert f[k].tobytes() == f0[k].tobytes(), what
                np.testing.assert_allclose(f[k], w[k], err_msg=what, **tol)


@pytest.mark.parametrize("spec", SPECS)
@pytest.mark.parametrize("case", CASES)
def test_port_mesh_surrogate_hybrid_rounds_are_unsharded(worlds, spec,
                                                         case):
    """Every rank takes the hybrid vector (past warmup, the gate holding)
    in the unsharded run's rounds, some of them; cold, warmup ends inside
    the run (10 rounds); seeded, the pool's credit skips it."""
    want = worlds["one"][case]["hybrid"]
    assert any(want)
    first = want.index(True)
    assert first == (10 if case == "cold" else 0)
    for rank, r in enumerate(_ranks(worlds, spec)):
        assert r[case]["hybrid"] == want, f"{spec} {case} rank {rank}"


# -- the crowd ---------------------------------------------------------------

@pytest.mark.parametrize("spec", SPECS)
@pytest.mark.parametrize("name", CROWD_RUNS)
def test_port_mesh_crowd_is_bitwise_unsharded(worlds, spec, name):
    """On every rank the crowd's votes, its reliability counts after each
    aggregation, and the record's applied labels and weights are bitwise
    the unsharded run's, and the decisions are the same."""
    want = worlds["one"]["crowd"][name]
    assert want["votes"] and len(want["counts"]) == len(want["votes"]) * (
        2 if name == "crowd_batch2" else 1)
    for rank, r in enumerate(_ranks(worlds, spec)):
        seen = r["crowd"][name]
        for k in ("votes", "counts"):
            assert len(seen[k]) == len(want[k])
            for t, (a, b) in enumerate(zip(seen[k], want[k])):
                assert a.tobytes() == b.tobytes(), \
                    f"{spec} {name} rank {rank} {k} {t}"
    got = _mesh_record(worlds, spec, name)
    one = trec.RunRecord.load(os.path.join(worlds["one_tmp"], "rec", name))
    for f in ("oracle_label", "label_weight", "chosen_idx", "true_class",
              "best_model"):
        assert got.arrays[f].tobytes() == one.arrays[f].tobytes(), f


@pytest.mark.parametrize("spec", SPECS)
def test_port_mesh_crowd_refusals_stay(worlds, spec):
    """A crowd baseline (no weighted update) raises the weighted-update
    error on every rank, and a noisy crowd with ``--checkpoint-dir`` the
    reference's refusal, as unsharded."""
    assert set(SC_REFUSED) == {"baseline", "checkpoint"}
    for r in _ranks(worlds, spec):
        assert r["refused"]["baseline"].startswith("ValueError: ")
        assert "no reliability-weighted update" in r["refused"]["baseline"]
        assert r["refused"]["checkpoint"].startswith("SystemExit: ")
        assert "--oracle-noise does not compose with --checkpoint-dir" in \
            r["refused"]["checkpoint"]


# -- the confusion prior's chunked sum -------------------------------------

def test_port_chunked_gather_sum_is_bitwise(worlds):
    """In a 2-rank world, ``gather_sum`` in chunks of 4 and of 1 rows is
    bitwise the whole sum (the same on both ranks), and the confusion
    prior summed a model at a time is bitwise the prior summed whole."""
    ranks = [r["prior_chunks"] for r in worlds[2][1]]
    for r in ranks:
        assert r["whole"].tobytes() == ranks[0]["whole"].tobytes()
        for c, got in r["chunks"].items():
            assert got.tobytes() == r["whole"].tobytes(), c
        assert r["prior"]["per_model"].tobytes() == \
            r["prior"]["whole"].tobytes()
    assert np.abs(ranks[0]["whole"]).max() > 0
