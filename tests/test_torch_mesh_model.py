"""The port's model axis of the mesh (``coda_tpu_torch/parallel``, H
sharded over ``model``) against one process and against the reference's
mesh at the same spec on its 8 virtual CPU devices.

Two worlds of CPU ranks (gloo through a ``file://`` store,
``tests/_torch_mesh_workers.py``), each spawned once for the file: two
ranks at ``model=2``, and four ranks that run the ``model=4`` jobs and the
``data=2,model=2`` jobs in the same spawn. On the reference's task
``make_synthetic_task(seed=7, H=8, N=64, C=4)``, 8 rounds, every CODA tier
(incremental, factored, rowscan, direct; the first two also as a 2-seed
batch) and the four deterministic-score baselines give the chosen items
and best models of the port unsharded and of the reference at the same
spec, regret within 1e-7 (the reference's ``tests/test_sharding.py``
bar). ModelPicker's expected entropies hold within 1e-6, ``compute_pbest``
with H sharded within rtol 1e-6 / atol 1e-7, and the block entries' plain
versions of kernels 1, 2, 4, 5 and 3 within rtol 1e-4 / atol 1e-6 of the
reference's ``eig_scores_from_cache`` and its pi-hat column. A CODA
state's replicated parts are bitwise equal across each model group and
its H-sharded parts across each data group. At ``data=2,model=2`` the
large-C factored and rowscan tiers hold at set level; ``cli --mesh
model=2`` prints the unsharded result on rank 0. Without a world: the
groups' layout and the refusals.
"""

from __future__ import annotations

import contextlib
import io
import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_mesh_workers import (
    ITERS,
    MODEL_METHODS,
    MODEL_SPECS,
    TASK,
    factory,
    spawn,
)
from coda_tpu_torch.data import make_synthetic_task
from coda_tpu_torch.engine import run_seeds_compiled
from coda_tpu_torch.parallel import Mesh
from coda_tpu_torch.parallel.mesh import (
    DATA_AXIS,
    MODEL_AXIS,
    axis_ranks,
    parse_spec,
    shard_preds,
)

SPECS = [spec for d in MODEL_SPECS for spec in MODEL_SPECS[d]]
REGRET_ATOL = 1e-7


def _world_of(spec: str) -> int:
    sizes = parse_spec(spec)
    return sizes[DATA_AXIS] * sizes[MODEL_AXIS]


def _entries_arrays():
    """Block-entry operands with H = 8 (divisible by every model axis)."""
    rng = np.random.default_rng(1)
    C, N, H, S = 4, 64, 8, 2

    def softmax(x):
        e = np.exp(x - x.max(-1, keepdims=True))
        return (e / e.sum(-1, keepdims=True)).astype(np.float32)

    return dict(
        rows=softmax(rng.normal(size=(C, H))),
        rows_new=softmax(rng.normal(size=(C, H))),
        hyp=softmax(rng.normal(size=(C, N, H))),
        hyp_t=softmax(rng.normal(size=(N, H))),
        pi=np.full((C,), 1.0 / C, np.float32),
        pi_xi=softmax(rng.normal(size=(N, C))), c=np.asarray(2),
        rows_s=softmax(rng.normal(size=(S, C, H))),
        hyp_s=softmax(rng.normal(size=(S, C, N, H))),
        hyp_t_s=softmax(rng.normal(size=(S, N, H))),
        pi_s=softmax(rng.normal(size=(S, C))),
        pi_xi_s=softmax(rng.normal(size=(S, N, C))),
        c_s=np.asarray([1, 3]),
        pbc=rng.random((C, H, N)).astype(np.float32),
        classes=rng.integers(0, C, size=H),
        classes_s=rng.integers(0, C, size=(S, H)),
        a=(np.abs(rng.normal(size=(5, H))) * 10 + 1).astype(np.float32),
        b=(np.abs(rng.normal(size=(5, H))) * 10 + 1).astype(np.float32))


@pytest.fixture(scope="module")
def worlds(tmp_path_factory):
    """Each world's per-rank results, spawned once for the file."""
    out = {}
    for d, jobs in ((2, ("model_traces", "model_blocks", "model_cli")),
                    (4, ("model_traces", "model_blocks", "model_large_c"))):
        tmp = tmp_path_factory.mktemp(f"model_world{d}")
        np.savez(tmp / "model_entries.npz", **_entries_arrays())
        out[d] = spawn(d, str(tmp), jobs)
    return out


def _ranks(worlds, spec):
    """``[(data_index, model_index, job results), ...]`` of a spec."""
    return [(r["model_blocks"][spec]["coords"] + (r,))
            for r in worlds[_world_of(spec)]]


def _along(worlds, spec, job, key, fixed: str, axis: int):
    """The blocks of ``key`` of the ranks whose other coordinate is 0,
    joined along ``axis`` (``fixed``: the coordinate that varies)."""
    parts = sorted((i if fixed == DATA_AXIS else j, r[job][spec][key])
                   for i, j, r in _ranks(worlds, spec)
                   if (j if fixed == DATA_AXIS else i) == 0)
    return np.concatenate([p for _, p in parts], axis=axis)


# -- the reference -----------------------------------------------------------

def _ref_factory(method):
    from coda_tpu.selectors import SELECTOR_FACTORIES, CODAHyperparams
    from coda_tpu.selectors import make_coda as ref_coda

    if method.startswith("coda"):
        tier = {"coda": "incremental"}.get(method,
                                           method.removeprefix("coda_"))
        return lambda p: ref_coda(p, CODAHyperparams(eig_mode=tier))
    kw = {"budget": ITERS} if method in ("activetesting", "vma") else {}
    return lambda p: SELECTOR_FACTORIES[method](p, **kw)


def _ref_mesh_trace(method, spec):
    """The reference's trace with the task sharded over its mesh of
    ``spec`` (``P(model, data, None)``), the preds a traced argument."""
    from jax.sharding import NamedSharding, PartitionSpec as P

    from coda_tpu.data import make_synthetic_task as ref_task
    from coda_tpu.engine.loop import make_batched_experiment_fn
    from coda_tpu.parallel import DATA_AXIS as REF_DATA
    from coda_tpu.parallel import mesh_from_spec, preds_sharding

    task = ref_task(**TASK)
    mesh = mesh_from_spec(spec)
    preds = jax.device_put(task.preds, preds_sharding(mesh))
    labels = jax.device_put(task.labels, NamedSharding(mesh, P(REF_DATA)))
    fn = make_batched_experiment_fn(_ref_factory(method), iters=ITERS)
    res = jax.jit(fn)(preds, labels, jnp.stack([jax.random.PRNGKey(0)]))
    return {k: np.asarray(getattr(res, k)) for k in
            ("chosen_idx", "best_model", "regret")}


def _port_trace(method, task=None, iters=ITERS, seeds=1, make=None):
    task = task or make_synthetic_task(**TASK, device="cpu")
    res = run_seeds_compiled(make or factory(method), task.preds,
                             task.labels, iters=iters, seeds=seeds,
                             device="cpu")
    return {k: getattr(res, k).numpy() for k in
            ("chosen_idx", "best_model", "regret", "select_prob")}


def _same_trace(got, want, what):
    np.testing.assert_array_equal(got["chosen_idx"], want["chosen_idx"],
                                  err_msg=what)
    np.testing.assert_array_equal(got["best_model"], want["best_model"],
                                  err_msg=what)
    np.testing.assert_allclose(got["regret"], want["regret"], rtol=1e-6,
                               atol=REGRET_ATOL, err_msg=what)


# -- without a world -------------------------------------------------------

def test_port_model_mesh_layout(tmp_path):
    """The reference's layout: rank ``i * model + j`` holds N block ``i``
    and H block ``j``; a data group holds the ranks of one H block, a
    model group those of one N block; the specs round-trip; each rank's
    block of a task — the synthetic builder's, a memory-mapped ``.npy``
    file's and ``shard_preds`` of the reference's array — is bitwise its
    slice of the reference's arrays."""
    from coda_tpu_torch.data import Dataset

    assert axis_ranks(2, 2, DATA_AXIS) == [[0, 2], [1, 3]]
    assert axis_ranks(2, 2, MODEL_AXIS) == [[0, 1], [2, 3]]
    assert axis_ranks(1, 4, MODEL_AXIS) == [[0, 1, 2, 3]]
    assert axis_ranks(4, 2, DATA_AXIS) == [[0, 2, 4, 6], [1, 3, 5, 7]]
    for spec in SPECS + ["data=4"]:
        sizes = parse_spec(spec)
        assert Mesh(data=sizes[DATA_AXIS],
                    model=sizes[MODEL_AXIS]).spec == spec
    from coda_tpu.data import make_synthetic_task as ref_task

    ref = ref_task(**TASK)
    preds, labels = np.asarray(ref.preds), np.asarray(ref.labels)
    np.save(tmp_path / "t.npy", preds)
    np.save(tmp_path / "t_labels.npy", labels)
    for spec in SPECS:
        sizes = parse_spec(spec)
        a, b = sizes[DATA_AXIS], sizes[MODEL_AXIS]
        n, h = TASK["N"] // a, TASK["H"] // b
        for r in range(a * b):
            mesh = Mesh(data=a, model=b, rank=r)
            i, j = mesh.data_index, mesh.model_index
            assert (i, j) == (r // b, r % b)
            want = preds[j * h:(j + 1) * h, i * n:(i + 1) * n]
            got = make_synthetic_task(**TASK, mesh=mesh)
            assert got.shape == preds.shape
            np.testing.assert_array_equal(got.preds.numpy(), want)
            np.testing.assert_array_equal(got.labels.numpy(),
                                          labels[i * n:(i + 1) * n])
            ds = Dataset.from_file(str(tmp_path / "t.npy"), mesh=mesh)
            assert ds.shape == preds.shape
            np.testing.assert_array_equal(ds.preds.numpy(), want)
            np.testing.assert_array_equal(ds.labels.numpy(),
                                          labels[i * n:(i + 1) * n])
            blk = shard_preds(preds, mesh)
            assert (blk.start, blk.h_start) == (i * n, j * h)
            np.testing.assert_array_equal(blk.local.numpy(), want)


def test_port_model_axis_refusals(tmp_path):
    """H not divisible by the model axis raises, or loads unsharded with
    the reference's warning under ``unsharded_fallback``; the fused
    refresh raises under a model-axis mesh as under any mesh; every other
    knob passes the mesh's knob check (the sparse posterior, the
    amortized P(best), the prefilter and the surrogate scorer), and on a
    one-rank model axis (``--mesh model=1``) ``--checkpoint-dir``,
    ``--acq-batch 2``, ``--posterior sparse:2`` and ``--eig-scorer
    surrogate:8`` run; a model axis of more ranks than the world raises
    the reference's "needs" error."""
    from coda_tpu_torch import cli
    from coda_tpu_torch import data as tdata
    from coda_tpu_torch.selectors import CODAHyperparams, make_coda

    mesh3 = Mesh(data=1, model=3)
    with pytest.raises(ValueError, match="H=8 not divisible by the model "
                       r"axis \(3\)"):
        make_synthetic_task(**TASK, mesh=mesh3)
    warned = []
    assert tdata._placement(64, mesh3, True, "t", warn=warned.append,
                            H=8) is None
    assert warned and warned[0].startswith(
        "[data] t: sharded placement failed (mesh 'model=3': H=8 not "
        "divisible by the model axis (3)")
    whole = make_synthetic_task(**TASK, mesh=mesh3, unsharded_fallback=True,
                                device="cpu")
    assert whole.mesh is None and whole.preds.shape[0] == 8
    blk = make_synthetic_task(**TASK, mesh=Mesh(data=1, model=2))
    with pytest.raises(ValueError, match="eig_refresh='fused'"):
        make_coda(blk.preds, CODAHyperparams(eig_refresh="fused"),
                  device="cpu", mesh=Mesh(data=1, model=2))
    from coda_tpu_torch.selectors.coda import check_supported

    for knob in (dict(posterior="sparse:2"), dict(eig_pbest="amortized"),
                 dict(prefilter_n=16), dict(eig_scorer="surrogate:8")):
        # each runs since slice 5d
        check_supported(CODAHyperparams(**knob, shard_spec="model=2"), 64)
    argv = ["--synthetic", "6,64,4", "--method", "coda", "--iters", "2",
            "--seeds", "1", "--device", "cpu", "--no-mlflow", "--mesh",
            "model=1"]
    for flags in (["--acq-batch", "2"], ["--posterior", "sparse:2"],
                  ["--checkpoint-dir", str(tmp_path / "c")],
                  ["--eig-scorer", "surrogate:8"]):
        # each runs since slice 5d
        buf = io.StringIO()
        with contextlib.redirect_stdout(buf):
            assert cli.main(argv + flags) == 0
        assert "seed 0: regret@2=" in buf.getvalue()
        if flags[0] == "--checkpoint-dir":
            assert (tmp_path / "c" / "seed_0" / "rank_0").is_dir()
    with pytest.raises(ValueError, match="mesh 1x2 needs 2 ranks, have 1"):
        cli.main(argv[:-1] + ["model=2"])
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        assert cli.main(argv) == 0
    assert "seed 0: regret@2=" in buf.getvalue()


# -- the worlds ------------------------------------------------------------

@pytest.mark.parametrize("spec", SPECS)
@pytest.mark.parametrize("method", MODEL_METHODS)
def test_port_model_traces_match(worlds, spec, method):
    """Every CODA tier and the four deterministic-score baselines with H
    sharded: every rank's trace equals the port's unsharded trace and the
    reference's trace at the same spec (chosen items, best models; regret
    within 1e-7; the selection probabilities, CODA's the picks' EIG
    scores, within 1e-6)."""
    one = _port_trace(method)
    ref = _ref_mesh_trace(method, spec)
    for rank, r in enumerate(worlds[_world_of(spec)]):
        got = r["model_traces"][spec][method]
        _same_trace(got, one, f"{method} {spec} rank {rank} vs unsharded")
        _same_trace(got, ref, f"{method} {spec} rank {rank} vs reference")
        np.testing.assert_allclose(got["select_prob"], one["select_prob"],
                                   atol=1e-6)


@pytest.mark.parametrize("spec", SPECS)
@pytest.mark.parametrize("method", ["coda", "coda_factored"])
def test_port_model_seed_batches_match(worlds, spec, method):
    """CODA's 2-seed batch with H sharded (on the incremental tier the
    plain versions of kernels 4, 5 and the batched kernel 3 per block):
    every rank's traces are the unsharded batch's."""
    one = _port_trace(method, seeds=2)
    for r in worlds[_world_of(spec)]:
        _same_trace(r["model_traces"][spec][method + "_batch2"], one,
                    f"{method} {spec} batch")


@pytest.mark.parametrize("spec", SPECS)
def test_port_model_blocks_match(worlds, spec):
    """ModelPicker's expected entropies with H sharded within 1e-6 of the
    reference and the port unsharded; ``compute_pbest`` with H sharded
    within rtol 1e-6 / atol 1e-7 of the reference (its own bar); the
    incremental cache holds a rank's ``(C, N/a, H/b)`` block."""
    from coda_tpu.ops.pbest import compute_pbest as ref_pbest
    from coda_tpu.selectors.modelpicker import (
        expected_entropies as ref_entropies,
    )
    from coda_tpu_torch.selectors.modelpicker import expected_entropies

    task = make_synthetic_task(**TASK, device="cpu")
    hard = task.preds.argmax(-1).T.to(torch.int32)
    post = np.full((8,), 1.0 / 8, np.float32)
    want = np.asarray(ref_entropies(jnp.asarray(hard.numpy()),
                                    jnp.asarray(post), (1 - 0.46) / 0.46, 4))
    one = expected_entropies(hard, torch.from_numpy(post), (1 - 0.46) / 0.46,
                             4).numpy()
    ent = _along(worlds, spec, "model_blocks", "entropies", DATA_AXIS, 0)
    np.testing.assert_allclose(ent, want, rtol=1e-6, atol=1e-6)
    np.testing.assert_allclose(ent, one, rtol=1e-6, atol=1e-6)
    z = _entries_arrays()
    pb = _along(worlds, spec, "model_blocks", "compute_pbest", MODEL_AXIS,
                -1)
    np.testing.assert_allclose(pb, np.asarray(ref_pbest(z["a"], z["b"])),
                               rtol=1e-6, atol=1e-7)
    sizes = parse_spec(spec)
    for i, j, r in _ranks(worlds, spec):
        assert r["model_blocks"][spec]["cache_shape"] == (
            4, 64 // sizes[DATA_AXIS], 8 // sizes[MODEL_AXIS])


@pytest.mark.parametrize("spec", SPECS)
def test_reference_model_block_entries_match(worlds, spec):
    """The block entries' plain versions (kernels 1, 2, 4 and 5 on each
    rank's ``(C, N/a, H/b)`` block, the model group adding the parts;
    kernel 3 with and without the replica axis on its ``(C, H/b, N/a)``
    layout) within rtol 1e-4 / atol 1e-6 of the reference's
    ``eig_scores_from_cache`` (refreshed row written first for kernels 2
    and 5; ``vmap`` over the replicas for 4 and 5) and its pi-hat column
    (``gather_rows_sum_xla``). A block of the wrong H is refused."""
    from coda_tpu.ops.pallas_gather import gather_rows_sum_xla
    from coda_tpu.selectors.coda import eig_scores_from_cache

    z = _entries_arrays()
    tol = dict(rtol=1e-4, atol=1e-6)

    def refresh_ref(rows, hyp, hyp_t, c, pi, pi_xi):
        return eig_scores_from_cache(rows, hyp.at[c].set(hyp_t), pi, pi_xi)

    want = {
        "cache_scores": eig_scores_from_cache(z["rows"], z["hyp"], z["pi"],
                                              z["pi_xi"]),
        "refresh_scores": refresh_ref(z["rows_new"], jnp.asarray(z["hyp"]),
                                      z["hyp_t"], int(z["c"]), z["pi"],
                                      z["pi_xi"]),
        "cache_scores_s": jax.vmap(eig_scores_from_cache)(
            z["rows_s"], z["hyp_s"], z["pi_s"], z["pi_xi_s"]),
        "refresh_scores_s": jax.vmap(refresh_ref)(
            z["rows_s"], jnp.asarray(z["hyp_s"]), z["hyp_t_s"], z["c_s"],
            z["pi_s"], z["pi_xi_s"]),
        "column": gather_rows_sum_xla(z["pbc"], z["classes"]),
        "column_s": jax.vmap(gather_rows_sum_xla, (None, 0))(
            z["pbc"], z["classes_s"]),
    }
    for key, ref in want.items():
        got = _along(worlds, spec, "model_blocks", key, DATA_AXIS, -1)
        np.testing.assert_allclose(got, np.asarray(ref), err_msg=key, **tol)
        # the model group's ranks hold the same scores, bitwise
        for i, j, r in _ranks(worlds, spec):
            mine = r["model_blocks"][spec][key]
            n = mine.shape[-1]
            np.testing.assert_array_equal(
                mine, got[..., i * n:(i + 1) * n], err_msg=key)
    hyp = np.asarray(jnp.asarray(z["hyp"]).at[int(z["c"])].set(z["hyp_t"]))
    sizes = parse_spec(spec)
    n, h = 64 // sizes[DATA_AXIS], 8 // sizes[MODEL_AXIS]
    for i, j, r in _ranks(worlds, spec):
        blk = r["model_blocks"][spec]
        np.testing.assert_array_equal(
            blk["refresh_cache"],
            hyp[:, i * n:(i + 1) * n, j * h:(j + 1) * h])
        assert "a sharded entry takes this rank's block of H" in \
            blk["block_check"]


@pytest.mark.parametrize("spec", SPECS)
def test_port_model_state_replication(worlds, spec):
    """After 4 rounds of CODA's incremental tier: pi-hat, its item rows,
    the score-ahead and the unlabeled mask are bitwise equal across each
    model group; the Dirichlets and the P(best) rows across each data
    group; ``get_pbest`` (gathered) on every rank; and the ``(C, N/a,
    H/b)`` blocks of the cache assemble the unsharded run's within
    1e-6."""
    from coda_tpu_torch import random as trandom
    from coda_tpu_torch.engine.loop import answer
    from coda_tpu_torch.selectors import CODAHyperparams, make_coda

    ranks = _ranks(worlds, spec)
    st = {(i, j): r["model_blocks"][spec]["state"] for i, j, r in ranks}
    for (i, j), s in st.items():
        for f in ("pi_hat", "pi_hat_xi", "eig_scores_cached", "unlabeled"):
            np.testing.assert_array_equal(s[f], st[(i, 0)][f], err_msg=f)
        for f in ("dirichlets", "pbest_rows"):
            np.testing.assert_array_equal(s[f], st[(0, j)][f], err_msg=f)
    pbests = [r["model_blocks"][spec]["get_pbest"] for _, _, r in ranks]
    for p in pbests[1:]:
        np.testing.assert_array_equal(p, pbests[0])
    task = make_synthetic_task(**TASK, device="cpu")
    sel = make_coda(task.preds, CODAHyperparams(eig_mode="incremental"),
                    device="cpu")
    one = sel.init(None)
    for k in trandom.split(trandom.PRNGKey(3), 4):
        pick = sel.select(one, k)
        one = sel.update(one, pick.idx, answer(task.labels, pick.idx))
    sizes = parse_spec(spec)
    hyp = np.concatenate([np.concatenate(
        [st[(i, j)]["pbest_hyp"] for j in range(sizes[MODEL_AXIS])], -1)
        for i in range(sizes[DATA_AXIS])], 1)
    np.testing.assert_allclose(hyp, one.pbest_hyp.numpy(), atol=1e-6)
    np.testing.assert_allclose(pbests[0], sel.extras["get_pbest"](one),
                               rtol=1e-6, atol=1e-7)
    np.testing.assert_allclose(
        np.concatenate([st[(i, 0)]["eig_scores_cached"]
                        for i in range(sizes[DATA_AXIS])]),
        one.eig_scores_cached.numpy(), atol=1e-6)


@pytest.mark.parametrize("tier", ["factored", "rowscan"])
def test_port_model_large_c_set_parity(worlds, tier, monkeypatch):
    """The large-C tiers (C = 1000, the auto budgets shrunk until the
    resolver picks each) at ``data=2,model=2`` against the port
    unsharded, at the set level of the reference's
    ``test_large_c_sharded_execution_parity`` (the same mesh): the
    labelled sets agree, and best models and regrets wherever both runs
    have seen the same evidence."""
    from coda_tpu_torch.selectors import CODAHyperparams, make_coda
    from coda_tpu_torch.selectors import coda as coda_mod

    monkeypatch.setattr(coda_mod, "_INCR_CACHE_MAX_BYTES", 1 << 20)
    if tier == "rowscan":
        monkeypatch.setattr(coda_mod, "_TABLES_MAX_BYTES", 1 << 20)
    hp = CODAHyperparams(eig_chunk=128, num_points=32)
    task = make_synthetic_task(seed=13, H=16, N=512, C=1000, sharpness=12.0,
                               device="cpu")
    one = _port_trace(None, task=task, iters=4,
                      make=lambda p: make_coda(p, hp, device="cpu"))
    idx1, best1, reg1 = (one[k][0] for k in
                         ("chosen_idx", "best_model", "regret"))
    for r in worlds[4]:
        got = r["model_large_c"][tier]
        idx8, best8, reg8 = (got[k][0] for k in
                             ("chosen_idx", "best_model", "regret"))
        np.testing.assert_array_equal(np.sort(idx1), np.sort(idx8))
        same = np.array([set(idx1[:k + 1]) == set(idx8[:k + 1])
                         for k in range(len(idx1))])
        assert same[-1]
        np.testing.assert_array_equal(best1[same], best8[same])
        np.testing.assert_allclose(reg1[same], reg8[same], rtol=1e-6,
                                   atol=REGRET_ATOL)


def _results(out: str) -> list:
    """The lines that carry a run's result (timing lines dropped)."""
    keep = ("Loaded", "Best possible", "EIG tier", "seed ", "skip ",
            "[data]")
    return [re.sub(r", \d+ items( and \d+ models)? a rank on \S+", "", ln)
            for ln in out.splitlines() if ln.startswith(keep)]


@pytest.mark.parametrize("method", ["coda", "iid", "uncertainty",
                                    "activetesting", "vma", "model_picker"])
def test_port_cli_model_axis_prints_the_unsharded_result(worlds, method):
    """``cli --mesh model=2`` on two ranks: rank 0 prints the unsharded
    run's result lines, rank 1 nothing."""
    from coda_tpu_torch import cli

    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        assert cli.main(["--synthetic", "6,64,4", "--iters", "5", "--seeds",
                         "2", "--device", "cpu", "--no-mlflow", "--method",
                         method]) == 0
    ranks = worlds[2]
    got = ranks[0]["model_cli"]["runs"][method]
    assert "mesh model=2: gloo, 2 ranks" in got
    assert _results(got) == _results(buf.getvalue())
    assert ranks[1]["model_cli"]["runs"][method] == ""


def test_port_cli_suite_model_axis(worlds):
    """``cli suite --mesh model=2``: ``pyfiles`` (H=14) runs sharded over
    H, ``digits_clip`` (H=3) loads unsharded with the reference's
    warning; rank 0 reports every pair, rank 1 prints nothing."""
    out = worlds[2][0]["model_cli"]["suite"]
    assert '"mesh": "model=2"' in out and '"pairs_run": 4' in out
    assert worlds[2][1]["model_cli"]["suite"] == ""
