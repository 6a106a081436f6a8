"""The port's N-axis mesh (``coda_tpu_torch/parallel``) against one
process and against the reference's ``data=K`` mesh on its 8 virtual CPU
devices.

Two worlds of CPU ranks (``data=2`` and ``data=4``, gloo through a
``file://`` store, ``tests/_torch_mesh_workers.py``) each run, once for
the whole file: CODA (incremental, one seed and a 2-seed batch; factored)
and the four deterministic-score baselines on the reference's task
``make_synthetic_task(seed=7, H=8, N=64, C=4)``, 8 rounds; the per-item
blocks (ModelPicker's expected entropies, the direct tier's EIG scores,
the sharded entries' plain versions); the collectives and the mesh forms
of the selection primitives; and, at ``data=4``, the large-C factored and
rowscan tiers. The test process holds them to the port run unsharded and
to the reference: equal chosen indices and best models, regret within
1e-7 (the reference's ``tests/test_sharding.py`` bar), entropies and EIG
scores within 1e-6, the sharded entries within rtol 1e-4 / atol 1e-6 of
the reference's ``shard_map``'d Pallas entries in interpret mode. The
draws at global positions are held bitwise to slices of the unsharded
draws without a world.
"""

from __future__ import annotations

import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_mesh_workers import ITERS, TASK, TRACE_METHODS, factory, spawn
from coda_tpu_torch import random as trandom
from coda_tpu_torch.data import Dataset, make_synthetic_task
from coda_tpu_torch.engine import run_seeds_compiled
from coda_tpu_torch.ops.masked import (
    masked_argmax_tiebreak,
    masked_argmin_tiebreak,
    masked_categorical,
)
from coda_tpu_torch.parallel import Mesh, make_mesh, mesh_from_spec
from coda_tpu_torch.parallel.mesh import shard_preds

WORLDS = (2, 4)
REGRET_ATOL = 1e-7


@pytest.fixture(scope="module")
def worlds(tmp_path_factory):
    """Each world's per-rank results, spawned once for the file."""
    out = {}
    for d in WORLDS:
        tmp = tmp_path_factory.mktemp(f"world{d}")
        _write_inputs(tmp)
        jobs = ("traces", "blocks", "collectives") + (
            ("large_c",) if d == 4 else ())
        out[d] = spawn(d, str(tmp), jobs)
    return out


# -- inputs the ranks read ---------------------------------------------------

def _entries_arrays():
    rng = np.random.default_rng(0)
    C, N, H = 4, 64, 6

    def softmax(x):
        e = np.exp(x - x.max(-1, keepdims=True))
        return (e / e.sum(-1, keepdims=True)).astype(np.float32)

    return dict(rows=softmax(rng.normal(size=(C, H))),
                rows_new=softmax(rng.normal(size=(C, H))),
                hyp=softmax(rng.normal(size=(C, N, H))),
                hyp_t=softmax(rng.normal(size=(N, H))),
                pi=np.full((C,), 1.0 / C, np.float32),
                pi_xi=softmax(rng.normal(size=(N, C))),
                c=np.asarray(2))


def _collective_arrays():
    rng = np.random.default_rng(5)
    N = 64
    # integer-valued scores: exact ties across blocks; weights whose sums
    # are exact in float32, so the mesh's rank-order total is the
    # one-process total bitwise
    scores = rng.integers(0, 6, size=(4, N)).astype(np.float32)
    scores[1] = 3.0                                   # all tied
    scores[2, 40:] = 9.0                              # a tie set of one block
    scores[3] += rng.normal(scale=1e-4, size=N).astype(np.float32)
    mask = rng.random((4, N)) < 0.7
    mask[1, :] = True
    weights = rng.integers(0, 8, size=(4, N)).astype(np.float32)
    return dict(scores=scores, mask=mask, weights=weights,
                parts=rng.normal(size=(4, 3)).astype(np.float32),
                key=np.asarray([0, 17], np.int64),
                keys=np.asarray([[0, 3], [0, 4], [1, 5], [2, 6]], np.int64),
                items=np.asarray([5, 63, 0, 31, 32], np.int64),
                table=rng.integers(0, 9, size=(N, 3)).astype(np.int32))


def _write_inputs(tmp):
    np.savez(tmp / "entries.npz", **_entries_arrays())
    np.savez(tmp / "collectives.npz", **_collective_arrays())


def _blocks(results, job, key):
    return np.concatenate([r[job][key] for r in results], axis=-1)


# -- the reference -----------------------------------------------------------

def _ref_task():
    from coda_tpu.data import make_synthetic_task as ref_task

    return ref_task(**TASK)


def _ref_factory(method):
    from coda_tpu.selectors import SELECTOR_FACTORIES, CODAHyperparams
    from coda_tpu.selectors import make_coda as ref_coda

    if method == "coda":
        return lambda p: ref_coda(p, CODAHyperparams(eig_mode="incremental"))
    if method == "coda_factored":
        return lambda p: ref_coda(p, CODAHyperparams(eig_mode="factored"))
    kw = {"budget": ITERS} if method in ("activetesting", "vma") else {}
    return lambda p: SELECTOR_FACTORIES[method](p, **kw)


def _ref_mesh_trace(method, d, task=None, iters=ITERS, make=None):
    """The reference's trace with the task sharded over its ``data=d``
    mesh, the preds a traced argument (``tests/test_sharding.py``'s
    pattern, so GSPMD keeps the sharding live)."""
    from jax.sharding import NamedSharding, PartitionSpec as P

    from coda_tpu.engine.loop import make_batched_experiment_fn
    from coda_tpu.parallel import DATA_AXIS, preds_sharding
    from coda_tpu.parallel import mesh_from_spec as ref_mesh

    task = task or _ref_task()
    mesh = ref_mesh(f"data={d}")
    preds = jax.device_put(task.preds, preds_sharding(mesh))
    labels = jax.device_put(task.labels, NamedSharding(mesh, P(DATA_AXIS)))
    fn = make_batched_experiment_fn(make or _ref_factory(method),
                                    iters=iters)
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

def test_reference_mesh_spec_parsing_and_errors():
    """The reference's syntax and messages: an unknown axis, a mesh with
    more shards than ranks ("devices" there), the model axis's too (it
    runs since slice 5 ported it: ``test_torch_mesh_model.py``); a
    one-rank mesh needs no group."""
    from coda_tpu.parallel import make_mesh as ref_make_mesh
    from coda_tpu.parallel import mesh_from_spec as ref_mesh_from_spec

    for spec in ("bogus=2", "data=2,x=1"):
        with pytest.raises(ValueError) as ref:
            ref_mesh_from_spec(spec)
        with pytest.raises(ValueError) as got:
            mesh_from_spec(spec, device="cpu")
        assert str(got.value) == str(ref.value)
    with pytest.raises(ValueError) as ref:
        ref_make_mesh(data=64)
    with pytest.raises(ValueError) as got:
        make_mesh(data=64, device="cpu")
    pattern = r"mesh 64x1 needs 64 (devices|ranks), have \d+"
    assert re.fullmatch(pattern, str(ref.value))
    assert re.fullmatch(pattern, str(got.value))
    assert "ranks, have 1" in str(got.value)
    for spec, n in (("model=2", 2), ("data=2,model=2", 4)):
        sizes = re.findall(r"=(\d+)", spec)
        shape = "x".join(["1"] + sizes if len(sizes) == 1 else sizes)
        with pytest.raises(ValueError, match=f"mesh {shape} needs {n} "
                           "ranks, have 1"):
            mesh_from_spec(spec, device="cpu")
    one = mesh_from_spec("data=1", device="cpu")
    assert (one.shape, one.rank, one.size) == ({"data": 1, "model": 1}, 0, 1)


def test_port_shards_are_slices_of_the_reference_task(tmp_path):
    """Each rank's block of a task — the synthetic builder's, a memory-
    mapped ``.npy`` file's and ``shard_preds`` of the reference's array —
    is bitwise that rank's slice of the reference's arrays; an N the axis
    does not divide raises, or loads unsharded with the reference's
    warning under ``unsharded_fallback``."""
    ref = _ref_task()
    preds, labels = np.asarray(ref.preds), np.asarray(ref.labels)
    np.save(tmp_path / "t.npy", preds)
    np.save(tmp_path / "t_labels.npy", labels)
    for d in (2, 4):
        n = preds.shape[1] // d
        for r in range(d):
            mesh = Mesh(data=d, rank=r)
            want = preds[:, r * n:(r + 1) * n]
            got = make_synthetic_task(**TASK, mesh=mesh)
            assert got.shape == preds.shape and got.mesh is mesh
            np.testing.assert_array_equal(got.preds.numpy(), want)
            np.testing.assert_array_equal(got.labels.numpy(),
                                          labels[r * n:(r + 1) * n])
            ds = Dataset.from_file(str(tmp_path / "t.npy"), mesh=mesh)
            np.testing.assert_array_equal(ds.preds.numpy(), want)
            np.testing.assert_array_equal(ds.labels.numpy(),
                                          labels[r * n:(r + 1) * n])
            blk = shard_preds(preds, mesh)
            assert blk.start == r * n
            np.testing.assert_array_equal(blk.local.numpy(), want)
    mesh3 = Mesh(data=3, rank=1)
    with pytest.raises(ValueError, match="not divisible by the data axis"):
        make_synthetic_task(**TASK, mesh=mesh3)
    warned = []
    from coda_tpu_torch import data as tdata

    assert tdata._placement(64, Mesh(data=3), True, "t",
                            warn=warned.append) is None
    assert warned == ["[data] t: sharded placement failed (mesh 'data=3': "
                      "N=64 not divisible by the data axis (3); pad the task "
                      "or run it unsharded); loading unsharded"]
    whole = make_synthetic_task(**TASK, mesh=mesh3, unsharded_fallback=True,
                                device="cpu")
    assert whole.mesh is None
    np.testing.assert_array_equal(whole.preds.numpy(), preds)


def test_port_sharded_draws_are_slices_of_the_unsharded_draws():
    """A draw at global positions (``start``/``total``) is bitwise the
    slice of the unsharded draw — uniform, Gumbel, categorical scores and
    raw words, for one key and a batch of keys — and the unsharded
    uniform is ``jax.random.uniform``'s bits."""
    key = trandom.PRNGKey(11)
    keys = torch.stack([trandom.PRNGKey(s) for s in range(3)])
    N = 96
    logits = torch.from_numpy(np.random.default_rng(3).normal(
        size=(3, N)).astype(np.float32))
    for k, shape in ((key, (N,)), (keys, (N,)), (key, (2, N))):
        for fn in (trandom.uniform, trandom.gumbel, trandom.random_bits):
            full = fn(k, shape)
            for start, n in ((0, 24), (24, 24), (48, 48), (95, 1)):
                part = fn(k, shape[:-1] + (n,), start=start, total=N)
                assert torch.equal(part, full[..., start:start + n])
    full = trandom.categorical_scores(keys, logits)
    part = trandom.categorical_scores(keys, logits[:, 32:64], start=32,
                                      total=N)
    assert torch.equal(part, full[:, 32:64])
    assert torch.equal(trandom.categorical(keys, logits),
                       full.argmax(-1))
    ref = np.asarray(jax.random.uniform(jax.random.PRNGKey(11), (N,)))
    np.testing.assert_array_equal(
        trandom.uniform(key, (48,), start=48, total=N).numpy(), ref[48:])


# -- the worlds ------------------------------------------------------------

@pytest.mark.parametrize("d", WORLDS)
def test_port_collectives_match_one_process(worlds, d):
    """``gather_sum`` is the rank-order sum on every rank; the mesh forms
    of the tie-broken arg-max/arg-min (exact and ``isclose`` ties, a
    batch of keys), ``masked_categorical``, the draws at global positions,
    ``broadcast_from_owner`` and ``clear_items`` give the one-process
    answer on every rank."""
    z = _collective_arrays()
    res = worlds[d]
    want_sum = z["parts"][0]
    for p in z["parts"][1:d]:
        want_sum = want_sum + p
    key = torch.from_numpy(z["key"])
    want = []
    for r in range(z["scores"].shape[0]):
        s = torch.from_numpy(z["scores"][r])
        m = torch.from_numpy(z["mask"][r])
        for tol in ((0.0, 0.0), (1e-3, 1e-3)):
            idx, nt = masked_argmax_tiebreak(key, s, m, *tol)
            want.append((int(idx), int(nt), float(s[idx])))
            want.append(tuple(int(v) for v in
                              masked_argmin_tiebreak(key, s, m, *tol)))
        idx, p = masked_categorical(key, torch.from_numpy(z["weights"][r]),
                                    m)
        want.append((int(idx), float(p)))
    idx_b, nt_b = masked_argmax_tiebreak(
        torch.from_numpy(z["keys"]), torch.from_numpy(z["scores"]),
        torch.from_numpy(z["mask"]))
    items = torch.from_numpy(z["items"])
    N = z["scores"].shape[-1]
    u = trandom.uniform(key, (N,)).numpy()
    for rank, r in enumerate(res):
        c = r["collectives"]
        np.testing.assert_array_equal(c["gather_sum"], want_sum)
        assert c["picks"] == want, rank
        np.testing.assert_array_equal(c["batched"][0], idx_b.numpy())
        np.testing.assert_array_equal(c["batched"][1], nt_b.numpy())
        np.testing.assert_array_equal(c["owner_rows"],
                                      z["table"][z["items"]])
        np.testing.assert_array_equal(c["owner_cols"],
                                      z["scores"][:, z["items"]].T)
        n = N // d
        cleared = np.ones(n, bool)
        if rank * n <= z["items"][0] < (rank + 1) * n:
            cleared[z["items"][0] - rank * n] = False
        np.testing.assert_array_equal(c["cleared"], cleared)
    np.testing.assert_array_equal(_blocks(res, "collectives", "uniform"), u)
    assert [r["collectives"]["picks"][0][1] for r in res] == [want[0][1]] * d
    assert any(p[1] > 1 for p in want[::5]), "no tie was exercised"


@pytest.mark.parametrize("d", WORLDS)
@pytest.mark.parametrize("method", TRACE_METHODS)
def test_port_sharded_traces_match(worlds, d, method):
    """CODA (incremental, factored) and the four deterministic-score
    baselines at ``data=d``: every rank's trace equals the port's
    unsharded trace and the reference's ``data=d`` mesh trace (chosen
    items, best models; regret within 1e-7; selection probabilities,
    CODA's the picks' EIG scores, within 1e-6)."""
    one = _port_trace(method)
    ref = _ref_mesh_trace(method, d)
    for rank, r in enumerate(worlds[d]):
        got = r["traces"][method]
        _same_trace(got, one, f"{method} rank {rank} vs unsharded")
        _same_trace(got, ref, f"{method} rank {rank} vs reference data={d}")
        # CODA's select_prob is the pick's EIG score: the reference's
        # bar for sharded scores (test_sharded_eig_scores_match)
        np.testing.assert_allclose(got["select_prob"], one["select_prob"],
                                   atol=1e-6)


@pytest.mark.parametrize("d", WORLDS)
def test_port_sharded_seed_batch_matches(worlds, d):
    """CODA's seed-batched incremental tier (the plain versions of
    kernels 4, 5 and the batched kernel 3 per shard), 2 seeds: every
    rank's traces are the unsharded batch's."""
    one = _port_trace("coda", seeds=2)
    for r in worlds[d]:
        _same_trace(r["traces"]["coda_batch2"], one, f"data={d} batch")


@pytest.mark.parametrize("d", WORLDS)
def test_port_sharded_blocks_match(worlds, d):
    """The per-item blocks: ModelPicker's expected entropies and the
    direct tier's EIG scores within 1e-6 of the reference and the port
    unsharded (the EIG argmax the same); the incremental cache holds N/d
    items a rank; each rank's task block is bitwise the reference's
    slice."""
    from coda_tpu.data import make_synthetic_task as ref_task
    from coda_tpu.selectors import CODAHyperparams as RefHP
    from coda_tpu.selectors import make_coda as ref_coda
    from coda_tpu.selectors.coda import eig_scores as ref_eig_scores
    from coda_tpu.selectors.modelpicker import (
        expected_entropies as ref_entropies,
    )
    from coda_tpu_torch.selectors import CODAHyperparams, make_coda
    from coda_tpu_torch.selectors.modelpicker import expected_entropies

    res = worlds[d]
    ref = _ref_task()
    hard = jnp.argmax(ref.preds, -1).T.astype(jnp.int32)
    post = jnp.full((8,), 1.0 / 8, jnp.float32)
    ent_ref = np.asarray(ref_entropies(hard, post, (1 - 0.46) / 0.46, 4))
    port = make_synthetic_task(**TASK, device="cpu")
    ent_one = expected_entropies(
        port.preds.argmax(-1).T.to(torch.int32), torch.from_numpy(
            np.array(post)), (1 - 0.46) / 0.46, 4).numpy()
    ent = _blocks(res, "blocks", "entropies")
    np.testing.assert_allclose(ent, ent_ref, rtol=1e-6, atol=1e-6)
    np.testing.assert_allclose(ent, ent_one, rtol=1e-6, atol=1e-6)

    t11 = ref_task(seed=11, H=4, N=64, C=4)
    sel = ref_coda(t11.preds, RefHP(eig_chunk=64, num_points=64))
    st = jax.jit(sel.init)(jax.random.PRNGKey(0))
    hard11 = jnp.argmax(t11.preds, -1).T.astype(jnp.int32)
    s_ref = np.asarray(ref_eig_scores(st.dirichlets, st.pi_hat, st.pi_hat_xi,
                                      hard11, num_points=64, chunk=64))
    p11 = make_synthetic_task(seed=11, H=4, N=64, C=4, device="cpu")
    psel = make_coda(p11.preds, CODAHyperparams(eig_chunk=64, num_points=64),
                     device="cpu")
    pst = psel.init(None)
    s_one = psel.extras["eig_scores"](
        pst.dirichlets, pst.pi_hat, pst.pi_hat_xi,
        p11.preds.argmax(-1).T.to(torch.int32), num_points=64,
        chunk=64).numpy()
    s = _blocks(res, "blocks", "eig_scores")
    np.testing.assert_allclose(s, s_ref, atol=1e-6)
    np.testing.assert_allclose(s, s_one, atol=1e-6)
    assert int(s.argmax()) == int(s_ref.argmax()) == int(s_one.argmax())

    t9 = np.asarray(ref_task(seed=9, H=8, N=64, C=4).preds)
    n = 64 // d
    for rank, r in enumerate(res):
        assert r["blocks"]["cache_shape"] == (4, n, 8)
        np.testing.assert_array_equal(r["blocks"]["preds_block"],
                                      t9[:, rank * n:(rank + 1) * n])


@pytest.mark.parametrize("d", WORLDS)
def test_reference_sharded_entries_match(worlds, d):
    """The sharded entries' plain versions (kernels 1 and 2 per data
    shard, no collective) against the reference's
    ``eig_scores_cache_pallas_sharded`` and
    ``eig_scores_refresh_pallas_sharded`` in interpret mode on its
    ``data=d`` mesh, rtol 1e-4 / atol 1e-6; the refreshed block of the
    cache too. A block of the wrong size is refused."""
    from jax.sharding import NamedSharding, PartitionSpec as P

    from coda_tpu.ops.pallas_eig import (
        eig_scores_cache_pallas_sharded,
        eig_scores_refresh_pallas_sharded,
    )
    from coda_tpu.parallel import DATA_AXIS
    from coda_tpu.parallel import mesh_from_spec as ref_mesh

    a = _entries_arrays()
    mesh = ref_mesh(f"data={d}")
    hyp = jax.device_put(a["hyp"], NamedSharding(mesh, P(None, DATA_AXIS,
                                                         None)))
    pi_xi = jax.device_put(a["pi_xi"], NamedSharding(mesh, P(DATA_AXIS,
                                                             None)))
    hyp_t = jax.device_put(a["hyp_t"], NamedSharding(mesh, P(DATA_AXIS,
                                                             None)))
    want = np.asarray(eig_scores_cache_pallas_sharded(
        a["rows"], hyp, a["pi"], pi_xi, mesh=mesh, interpret=True))
    want_r, want_hyp = eig_scores_refresh_pallas_sharded(
        a["rows_new"], hyp, hyp_t, a["c"], a["pi"], pi_xi, mesh=mesh,
        interpret=True)
    res = worlds[d]
    np.testing.assert_allclose(_blocks(res, "blocks", "cache_scores"), want,
                               rtol=1e-4, atol=1e-6)
    np.testing.assert_allclose(_blocks(res, "blocks", "refresh_scores"),
                               np.asarray(want_r), rtol=1e-4, atol=1e-6)
    np.testing.assert_allclose(
        np.concatenate([r["blocks"]["refresh_cache"] for r in res], 1),
        np.asarray(want_hyp), rtol=1e-4, atol=1e-6)
    assert all("a sharded entry takes this rank's block" in
               r["blocks"]["block_check"] for r in res)


@pytest.mark.parametrize("tier", ["factored", "rowscan"])
def test_port_large_c_sharded_set_parity(worlds, tier, monkeypatch):
    """The large-C tiers (C = 1000, the auto budgets shrunk until the
    resolver picks each) at ``data=4`` against the port unsharded, at the
    set level as the reference's ``test_large_c_sharded_execution_parity``
    holds its mesh run (without its model axis): the labelled sets agree,
    and best models and regrets wherever both runs have seen the same
    evidence."""
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
        got = r["large_c"][tier]
        idx8, best8, reg8 = (got[k][0] for k in
                             ("chosen_idx", "best_model", "regret"))
        np.testing.assert_array_equal(np.sort(idx1), np.sort(idx8))
        same = np.array([set(idx1[:k + 1]) == set(idx8[:k + 1])
                         for k in range(len(idx1))])
        assert same[-1]
        np.testing.assert_array_equal(best1[same], best8[same])
        np.testing.assert_allclose(reg1[same], reg8[same], rtol=1e-6,
                                   atol=REGRET_ATOL)
