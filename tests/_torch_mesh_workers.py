"""Rank programs for the port's mesh tests (``test_torch_mesh.py``,
``test_torch_distributed.py``, ``test_torch_mesh_model.py``,
``test_torch_mesh_record.py``, ``test_torch_mesh_knobs.py``,
``test_torch_mesh_surrogate_crowd.py``).

:func:`spawn` starts a world of ``world`` CPU processes through
``torch.multiprocessing`` (spawn), each joining one gloo group through a
``file://`` store under the test's temporary directory (no port, so
parallel test workers cannot collide), running the named jobs and saving
what they return to ``rank<r>.pt``. This module imports neither JAX nor
the reference package: the ranks run only the port; the tests compare
what they saved against the reference in the test process.
"""

from __future__ import annotations

import contextlib
import io
import os
import sys
from typing import Optional

import numpy as np
import torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

# the reference's task of its sharding tests (tests/test_sharding.py)
TASK = dict(seed=7, H=8, N=64, C=4)
ITERS = 8
TRACE_METHODS = ("coda", "coda_factored", "iid", "uncertainty",
                 "activetesting", "vma")
# the model axis: every CODA tier and the four deterministic baselines, on
# each spec of a world (a 4-rank world runs both of its specs in one spawn)
MODEL_METHODS = ("coda", "coda_factored", "coda_rowscan", "coda_direct",
                 "iid", "uncertainty", "activetesting", "vma")
MODEL_SPECS = {2: ("model=2",), 4: ("model=4", "data=2,model=2")}


def spawn(world: int, tmp: str, jobs: tuple, env: bool = False) -> list:
    """Run ``jobs`` on ``world`` ranks; returns each rank's results.
    ``env``: the ranks find their rank and size in torchrun's
    environment variables instead of arguments."""
    return finish(start(world, tmp, jobs, env), world, tmp)


def start(world: int, tmp: str, jobs: tuple, env: bool = False):
    """:func:`spawn` without waiting: the ranks' process context, for
    :func:`finish` (the caller works meanwhile)."""
    import torch.multiprocessing as mp

    return mp.start_processes(
        _rank_main, args=(world, str(tmp), tuple(jobs), env), nprocs=world,
        join=False, start_method="spawn")


def finish(context, world: int, tmp: str) -> list:
    """Wait for the ranks :func:`start` began (raising if one failed);
    returns each rank's results."""
    while not context.join():
        pass
    return [torch.load(os.path.join(tmp, f"rank{r}.pt"), weights_only=False)
            for r in range(world)]


def _rank_main(rank: int, world: int, tmp: str, jobs: tuple,
               env: bool) -> None:
    if REPO not in sys.path:
        sys.path.insert(0, REPO)
    torch.set_num_threads(1)
    from coda_tpu_torch.parallel.distributed import initialize, shutdown

    store = f"file://{os.path.join(tmp, 'store')}"
    if env:
        os.environ.update(RANK=str(rank), WORLD_SIZE=str(world),
                          LOCAL_RANK=str(rank),
                          LOCAL_WORLD_SIZE=str(world))
        joined = initialize(init_method=store, device="cpu", timeout_s=120)
    else:
        joined = initialize(init_method=store, world_size=world, rank=rank,
                            device="cpu", timeout_s=120)
    out = {"joined": joined}
    try:
        for job in jobs:
            out[job] = JOBS[job](rank, world, tmp)
    finally:
        shutdown()
    torch.save(out, os.path.join(tmp, f"rank{rank}.pt"))


def _mesh(world: int):
    from coda_tpu_torch.parallel import make_mesh

    return make_mesh(data=world, device="cpu")


def factory(method: str):
    """``(preds, mesh=None) -> Selector`` of a method of the traces."""
    from coda_tpu_torch.selectors import (
        SELECTOR_FACTORIES,
        CODAHyperparams,
        make_coda,
    )

    if method.startswith("coda"):
        tier = {"coda": "incremental"}.get(method,
                                           method.removeprefix("coda_"))
        hp = CODAHyperparams(eig_mode=tier)
    else:
        kw = {"budget": ITERS} if method in ("activetesting", "vma") else {}
        return lambda p, mesh=None: SELECTOR_FACTORIES[method](
            p, device="cpu", mesh=mesh, **kw)
    return lambda p, mesh=None: make_coda(p, hp, device="cpu", mesh=mesh)


def _result(res) -> dict:
    return {k: getattr(res, k).numpy() for k in
            ("chosen_idx", "best_model", "regret", "select_prob")}


def job_traces(rank, world, tmp) -> dict:
    """Every method of :data:`TRACE_METHODS` on the reference's task, one
    seed x 8 rounds; CODA's incremental tier also as a 2-seed batch."""
    from coda_tpu_torch.data import make_synthetic_task
    from coda_tpu_torch.engine import run_seeds_compiled

    mesh = _mesh(world)
    task = make_synthetic_task(**TASK, mesh=mesh)
    out = {}
    for m in TRACE_METHODS:
        out[m] = _result(run_seeds_compiled(
            factory(m), task.preds, task.labels, iters=ITERS, seeds=1,
            device="cpu", mesh=mesh))
    out["coda_batch2"] = _result(run_seeds_compiled(
        factory("coda"), task.preds, task.labels, iters=ITERS, seeds=2,
        device="cpu", mesh=mesh))
    return out


def job_blocks(rank, world, tmp) -> dict:
    """This rank's block of the per-item quantities: ModelPicker's
    expected entropies, the direct-tier EIG scores of an initial CODA
    state (the reference's ``test_sharded_eig_scores_match`` task), the
    incremental cache's shape, and the sharded entries' plain versions on
    the arrays the test wrote."""
    from coda_tpu_torch.data import make_synthetic_task
    from coda_tpu_torch.ops import eig_kernels as ek
    from coda_tpu_torch.selectors import CODAHyperparams, make_coda
    from coda_tpu_torch.selectors.modelpicker import expected_entropies

    mesh = _mesh(world)
    out = {}
    task = make_synthetic_task(**TASK, mesh=mesh)
    hard = task.preds.argmax(-1).T.to(torch.int32)
    post = torch.full((8,), 1.0 / 8)
    out["entropies"] = expected_entropies(hard, post, (1 - 0.46) / 0.46,
                                          4).numpy()
    t11 = make_synthetic_task(seed=11, H=4, N=64, C=4, mesh=mesh)
    sel = make_coda(t11.preds, CODAHyperparams(eig_chunk=64, num_points=64),
                    device="cpu", mesh=mesh)
    st = sel.init(None)
    hard11 = t11.preds.argmax(-1).T.to(torch.int32)
    out["eig_scores"] = sel.extras["eig_scores"](
        st.dirichlets, st.pi_hat, st.pi_hat_xi, hard11, num_points=64,
        chunk=64).numpy()
    t9 = make_synthetic_task(seed=9, H=8, N=64, C=4, mesh=mesh)
    st9 = make_coda(t9.preds, CODAHyperparams(eig_mode="incremental",
                                              eig_chunk=64),
                    device="cpu", mesh=mesh).init(None)
    out["cache_shape"] = tuple(st9.pbest_hyp.shape)
    out["preds_block"] = t9.preds.numpy()
    arrs = np.load(os.path.join(tmp, "entries.npz"))
    n = arrs["hyp"].shape[1] // world
    blk = slice(rank * n, (rank + 1) * n)
    rows, pi = (torch.from_numpy(arrs[k]) for k in ("rows", "pi"))
    hyp = torch.from_numpy(np.ascontiguousarray(arrs["hyp"][:, blk]))
    pi_xi = torch.from_numpy(np.ascontiguousarray(arrs["pi_xi"][blk]))
    N = arrs["hyp"].shape[1]
    out["cache_scores"] = ek.eig_scores_cache_sharded(
        rows, hyp, pi, pi_xi, mesh, N).numpy()
    hyp_t = torch.from_numpy(np.ascontiguousarray(arrs["hyp_t"][blk]))
    c = torch.tensor(int(arrs["c"]))
    rows_new = torch.from_numpy(arrs["rows_new"])
    scores, hyp_out = ek.eig_scores_refresh_sharded(
        rows_new, hyp.clone(), hyp_t, c, pi, pi_xi, mesh, N)
    out["refresh_scores"] = scores.numpy()
    out["refresh_cache"] = hyp_out.numpy()
    try:
        ek.eig_scores_cache_sharded(rows, hyp, pi, pi_xi, mesh, N + world)
        out["block_check"] = None
    except ValueError as e:
        out["block_check"] = str(e)
    return out


def job_large_c(rank, world, tmp, spec: Optional[str] = None) -> dict:
    """The large-C factored and rowscan tiers (C = 1000) with the auto
    budgets shrunk until the resolver picks each, as the reference's
    ``test_large_c_sharded_execution_parity`` runs them; on ``data=world``
    or on ``spec``."""
    from coda_tpu_torch.data import make_synthetic_task
    from coda_tpu_torch.engine import run_seeds_compiled
    from coda_tpu_torch.selectors import CODAHyperparams, make_coda
    from coda_tpu_torch.selectors import coda as coda_mod

    mesh = _mesh(world) if spec is None else _spec_mesh(spec)
    H, N, C = 16, 512, 1000
    hp = CODAHyperparams(eig_chunk=128, num_points=32)
    task = make_synthetic_task(seed=13, H=H, N=N, C=C, sharpness=12.0,
                               mesh=mesh)
    out = {}
    saved = (coda_mod._INCR_CACHE_MAX_BYTES, coda_mod._TABLES_MAX_BYTES)
    for tier, tables in (("factored", saved[1]), ("rowscan", 1 << 20)):
        coda_mod._INCR_CACHE_MAX_BYTES, coda_mod._TABLES_MAX_BYTES = (
            1 << 20, tables)
        try:
            assert coda_mod.resolve_eig_mode(hp, H, N, C) == tier
            out[tier] = _result(run_seeds_compiled(
                lambda p, mesh=None: make_coda(p, hp, device="cpu",
                                               mesh=mesh),
                task.preds, task.labels, iters=4, seeds=1, device="cpu",
                mesh=mesh))
        finally:
            coda_mod._INCR_CACHE_MAX_BYTES, coda_mod._TABLES_MAX_BYTES = \
                saved
    return out


def job_collectives(rank, world, tmp) -> dict:
    """The collectives and the mesh forms of the selection primitives on
    the vectors the test wrote (``collectives.npz``): each rank takes its
    block and returns what every rank should agree on."""
    from coda_tpu_torch import random as trandom
    from coda_tpu_torch.ops.masked import (
        masked_argmax_tiebreak,
        masked_argmin_tiebreak,
        masked_categorical,
        mesh_masked_argmax_tiebreak,
    )
    from coda_tpu_torch.parallel.collectives import (
        broadcast_from_owner,
        clear_items,
        gather_sum,
    )

    mesh = _mesh(world)
    z = np.load(os.path.join(tmp, "collectives.npz"))
    N = z["scores"].shape[-1]
    n = N // world
    blk = slice(rank * n, (rank + 1) * n)

    def block(name):
        return torch.from_numpy(np.ascontiguousarray(z[name][..., blk]))

    out = {"gather_sum": gather_sum(torch.from_numpy(z["parts"][rank]),
                                    mesh).numpy()}
    key = torch.from_numpy(z["key"])
    keys = torch.from_numpy(z["keys"])
    picks = []
    for r in range(z["scores"].shape[0]):
        s, m = block("scores")[r], block("mask")[r]
        for tol in ((0.0, 0.0), (1e-3, 1e-3)):
            idx, nt, val = mesh_masked_argmax_tiebreak(key, s, m, mesh, *tol)
            picks.append((int(idx), int(nt), float(val)))
            picks.append(tuple(int(v) for v in masked_argmin_tiebreak(
                key, s, m, *tol, mesh=mesh)))
        idx, p = masked_categorical(key, block("weights")[r], m, mesh=mesh)
        picks.append((int(idx), float(p)))
    out["picks"] = picks
    idx, nt = masked_argmax_tiebreak(keys, block("scores"), block("mask"),
                                     mesh=mesh)
    out["batched"] = (idx.numpy(), nt.numpy())
    out["uniform"] = trandom.uniform(key, (n,), start=rank * n,
                                     total=N).numpy()
    items = torch.from_numpy(z["items"])
    out["owner_rows"] = broadcast_from_owner(
        torch.from_numpy(np.ascontiguousarray(z["table"][blk])), items,
        mesh).numpy()
    out["owner_cols"] = broadcast_from_owner(
        block("scores"), items, mesh, dim=1).numpy()
    mask = torch.ones(n, dtype=torch.bool)
    clear_items(mask, items[:1], mesh)
    out["cleared"] = mask.numpy()
    return out


def _captured(fn, *args) -> str:
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        fn(*args)
    return buf.getvalue()


def job_cli(rank, world, tmp) -> dict:
    """The command line under ``--mesh``: the single-task run of CODA and
    the baselines (their printed lines, rank 0's tracking store), ``cli
    suite`` on ``data/`` (``pyfiles``, N=500, shards; ``iris``, N=105,
    falls back unsharded), and the refusal of a task whose N does not
    divide the mesh."""
    from coda_tpu_torch import cli
    from coda_tpu_torch.parallel.distributed import is_primary

    out = {"primary": is_primary(), "runs": {}}
    base = ["--synthetic", "6,64,4", "--iters", "5", "--seeds", "2",
            "--device", "cpu", "--mesh", f"data={world}"]
    for m in ("coda", "iid", "uncertainty", "activetesting", "vma",
              "model_picker"):
        out["runs"][m] = _captured(cli.main, base + [
            "--method", m, "--tracking-db", os.path.join(tmp, "t.sqlite")])
    out["suite"] = _captured(cli.main, [
        "suite", "--pred-dir", os.path.join(REPO, "data"), "--tasks",
        "pyfiles,iris", "--methods", "coda,iid", "--seeds", "2", "--iters",
        "6", "--device", "cpu", "--mesh", f"data={world}", "--db",
        os.path.join(tmp, "s.sqlite")])
    try:
        cli.main(["--synthetic", "4,63,3", "--method", "coda", "--iters",
                  "2", "--device", "cpu", "--no-mlflow", "--mesh",
                  f"data={world}"])
        out["odd_n"] = None
    except ValueError as e:
        out["odd_n"] = str(e)
    return out


def job_env(rank, world, tmp) -> dict:
    """What a rank sees after joining through torchrun's variables."""
    import torch.distributed as dist

    from coda_tpu_torch.parallel.collectives import gather_sum
    from coda_tpu_torch.parallel.distributed import is_primary

    mesh = _mesh(world)
    total = gather_sum(torch.tensor([float(rank + 1)]), mesh)
    return {"rank": dist.get_rank(), "size": dist.get_world_size(),
            "backend": dist.get_backend(), "primary": is_primary(),
            "sum": float(total[0])}


# -- the model axis ----------------------------------------------------------

def _spec_mesh(spec: str):
    from coda_tpu_torch.parallel import mesh_from_spec

    return mesh_from_spec(spec, device="cpu")


def _blk(a: np.ndarray, mesh, n_dim: Optional[int], h_dim: Optional[int]):
    """This rank's block of a host array: N block ``mesh.data_index``
    along ``n_dim``, H block ``mesh.model_index`` along ``h_dim``."""
    index = [slice(None)] * a.ndim
    for dim, k, i in ((n_dim, mesh.data, mesh.data_index),
                      (h_dim, mesh.model, mesh.model_index)):
        if dim is not None:
            n = a.shape[dim] // k
            index[dim] = slice(i * n, (i + 1) * n)
    return torch.from_numpy(np.ascontiguousarray(a[tuple(index)]))


def job_model_traces(rank, world, tmp) -> dict:
    """Every method of :data:`MODEL_METHODS` on the reference's task at
    each spec of :data:`MODEL_SPECS`, one seed x 8 rounds; CODA's
    incremental and factored tiers also as 2-seed batches."""
    from coda_tpu_torch.data import make_synthetic_task
    from coda_tpu_torch.engine import run_seeds_compiled

    out = {}
    for spec in MODEL_SPECS[world]:
        mesh = _spec_mesh(spec)
        task = make_synthetic_task(**TASK, mesh=mesh)
        res = {}
        for m in MODEL_METHODS:
            res[m] = _result(run_seeds_compiled(
                factory(m), task.preds, task.labels, iters=ITERS, seeds=1,
                device="cpu", mesh=mesh))
        for m in ("coda", "coda_factored"):
            res[m + "_batch2"] = _result(run_seeds_compiled(
                factory(m), task.preds, task.labels, iters=ITERS, seeds=2,
                device="cpu", mesh=mesh))
        out[spec] = res
    return out


def job_model_blocks(rank, world, tmp) -> dict:
    """At each spec: this rank's block of ModelPicker's expected entropies
    and of ``compute_pbest`` with H sharded; the block entries of kernels
    1, 2, 4, 5 and 3 (their plain versions) on the arrays the test wrote
    (``model_entries.npz``); and the state of a CODA run of 4 rounds
    (incremental tier), for the test to hold its replicated parts equal
    across each model group and its H-sharded parts across each data
    group."""
    from coda_tpu_torch import random as trandom
    from coda_tpu_torch.data import make_synthetic_task
    from coda_tpu_torch.engine.loop import answer
    from coda_tpu_torch.ops import eig_kernels as ek
    from coda_tpu_torch.ops import gather_kernels as gk
    from coda_tpu_torch.ops.pbest import compute_pbest
    from coda_tpu_torch.selectors import CODAHyperparams, make_coda
    from coda_tpu_torch.selectors.modelpicker import expected_entropies

    z = np.load(os.path.join(tmp, "model_entries.npz"))
    out = {}
    for spec in MODEL_SPECS[world]:
        mesh = _spec_mesh(spec)
        res = {"coords": (mesh.data_index, mesh.model_index)}
        task = make_synthetic_task(**TASK, mesh=mesh)
        res["preds_block"] = task.preds.numpy()
        hard = task.preds.argmax(-1).T.to(torch.int32)
        post = torch.full((hard.shape[1],), 1.0 / TASK["H"])
        res["entropies"] = expected_entropies(
            hard, post, (1 - 0.46) / 0.46, TASK["C"], mesh).numpy()
        res["compute_pbest"] = compute_pbest(_blk(z["a"], mesh, None, 1),
                                     _blk(z["b"], mesh, None, 1),
                                     mesh=mesh).numpy()
        N, H = z["hyp"].shape[1], z["hyp"].shape[2]
        rows, rows_new = (_blk(z[k], mesh, None, 1)
                          for k in ("rows", "rows_new"))
        hyp = _blk(z["hyp"], mesh, 1, 2)
        pi = torch.from_numpy(z["pi"])
        pi_xi = _blk(z["pi_xi"], mesh, 0, None)
        on = dict(mesh=mesh, n_global=N, h_global=H, plain=True)
        res["cache_scores"] = ek.eig_scores_cache_sharded(
            rows, hyp, pi, pi_xi, **on).numpy()
        scores, hyp_out = ek.eig_scores_refresh_sharded(
            rows_new, hyp.clone(), _blk(z["hyp_t"], mesh, 0, 1),
            torch.tensor(int(z["c"])), pi, pi_xi, **on)
        res["refresh_scores"] = scores.numpy()
        res["refresh_cache"] = hyp_out.numpy()
        rows_s = _blk(z["rows_s"], mesh, None, 2)
        hyp_s = _blk(z["hyp_s"], mesh, 2, 3)
        pi_s = torch.from_numpy(z["pi_s"])
        pi_xi_s = _blk(z["pi_xi_s"], mesh, 1, None)
        res["cache_scores_s"] = ek.eig_scores_cache_batched_sharded(
            rows_s, hyp_s, pi_s, pi_xi_s, **on).numpy()
        scores, _ = ek.eig_scores_refresh_batched_sharded(
            rows_s, hyp_s.clone(), _blk(z["hyp_t_s"], mesh, 1, 2),
            torch.from_numpy(z["c_s"]), pi_s, pi_xi_s, **on)
        res["refresh_scores_s"] = scores.numpy()
        pbc = _blk(z["pbc"], mesh, 2, 1)
        res["column"] = gk.gather_rows_sum_sharded(
            pbc, _blk(z["classes"], mesh, None, 0), mesh).numpy()
        res["column_s"] = gk.gather_rows_sum_batched_sharded(
            pbc, _blk(z["classes_s"], mesh, None, 1), mesh).numpy()
        try:
            ek.eig_scores_cache_sharded(rows, hyp, pi, pi_xi, mesh, N,
                                        h_global=H + mesh.model)
            res["block_check"] = None
        except ValueError as e:
            res["block_check"] = str(e)
        sel = make_coda(task.preds, CODAHyperparams(eig_mode="incremental"),
                        device="cpu", mesh=mesh)
        st = sel.init(None)
        res["cache_shape"] = tuple(st.pbest_hyp.shape)
        for k in trandom.split(trandom.PRNGKey(3), 4):
            pick = sel.select(st, k)
            st = sel.update(st, pick.idx, answer(task.labels, pick.idx, mesh))
        res["state"] = {f: getattr(st, f).numpy() for f in (
            "pi_hat", "pi_hat_xi", "eig_scores_cached", "dirichlets",
            "pbest_rows", "pbest_hyp", "unlabeled")}
        res["get_pbest"] = sel.extras["get_pbest"](st).numpy()
        out[spec] = res
    return out


def job_model_large_c(rank, world, tmp) -> dict:
    """The large-C factored and rowscan tiers at ``data=2,model=2``
    (:func:`job_large_c`'s runs on the other mesh)."""
    return job_large_c(rank, world, tmp, spec="data=2,model=2")


def job_model_cli(rank, world, tmp) -> dict:
    """``cli --mesh model=2`` (CODA and the five baselines) and ``cli suite
    --mesh model=2`` on ``pyfiles`` (H=14, sharded) and ``digits_clip``
    (H=3: unsharded, the reference's warning)."""
    from coda_tpu_torch import cli

    out = {"runs": {}}
    base = ["--synthetic", "6,64,4", "--iters", "5", "--seeds", "2",
            "--device", "cpu", "--mesh", "model=2", "--no-mlflow"]
    for m in ("coda", "iid", "uncertainty", "activetesting", "vma",
              "model_picker"):
        out["runs"][m] = _captured(cli.main, base + ["--method", m])
    out["suite"] = _captured(cli.main, [
        "suite", "--pred-dir", os.path.join(REPO, "data"), "--tasks",
        "pyfiles,digits_clip", "--methods", "coda,iid", "--seeds", "2",
        "--iters", "6", "--device", "cpu", "--mesh", "model=2", "--db",
        os.path.join(tmp, "m.sqlite")])
    return out


# -- records, replays, checkpoints, the suite and --debug-viz on a mesh --------

RECORD_SPECS = {2: ("data=2", "model=2"), 4: ("data=2,model=2",)}
# every CODA tier and the four deterministic-score baselines, and CODA's
# incremental tier as a 2-seed batch
RECORD_RUNS = MODEL_METHODS + ("coda_batch2",)
REPLAYED = ("coda", "coda_batch2", "vma")      # replayed inside the world
TASK_FILE = "t7"             # TASK as .npy files under the world's tmp


def record_argv(name: str, data_dir: str) -> list:
    """The CLI flags of a recorded run of :data:`RECORD_RUNS` on the task
    files under ``data_dir`` (``--mesh`` and ``--record-dir`` added by the
    caller)."""
    argv = ["--task", TASK_FILE, "--data-dir", data_dir, "--iters",
            str(ITERS), "--seeds", "2" if name == "coda_batch2" else "1",
            "--device", "cpu", "--no-mlflow"]
    if name.startswith("coda"):
        tier = {"coda": "incremental", "coda_batch2": "incremental"}.get(
            name, name.removeprefix("coda_"))
        return argv + ["--method", "coda", "--eig-mode", tier]
    return argv + ["--method", name]


def spec_dir(spec: str) -> str:
    return spec.replace(",", "_").replace("=", "")


def _barrier(mesh) -> None:
    from coda_tpu_torch.parallel.collectives import all_gather_stack

    all_gather_stack(torch.zeros(1), mesh, axis=None)


def _tie_scores() -> tuple:
    """Scores of two replicas over the task's N = 64 items with exact
    ties across the data block boundary (items 31 | 32) and among the
    top k, and -inf non-candidates; the pick of each replica."""
    s = np.linspace(0.1, 0.5, 64, dtype=np.float32)[None].repeat(2, 0)
    s[:, [5, 31, 32, 40]] = 0.9             # the top, tied across blocks
    s[:, [2, 30, 33, 63]] = 0.7             # a tie at the k-th place
    s[0, 10:20] = -np.inf
    s[1, 28:36] = -np.inf                   # replica 1: the tie elsewhere
    s[1, [1, 60]] = 0.9
    return s, np.array([32, 60])


def job_tie_topk(rank, world, tmp) -> dict:
    """The recorder's top k (k = 8 and 40, more than a data block holds)
    of :func:`_tie_scores` from this rank's block at each spec, one
    replica and both."""
    from coda_tpu_torch.engine.loop import _score_digest
    from coda_tpu_torch.selectors.protocol import SelectResult

    scores, picks = _tie_scores()
    out = {}
    for spec in RECORD_SPECS[world]:
        mesh = _spec_mesh(spec)
        blk = _blk(scores, mesh, 1, None)
        res = {}
        for k in (8, 40):
            one = SelectResult(idx=torch.tensor(picks[0]),
                               prob=torch.tensor(0.0),
                               stochastic=torch.tensor(False),
                               scores=blk[0])
            both = one._replace(idx=torch.from_numpy(picks),
                                scores=blk)
            res[k] = [tuple(t.numpy() for t in _score_digest(r, k, mesh))
                      for r in (one, both)]
        out[spec] = res
    return out


def job_records(rank, world, tmp) -> dict:
    """At each spec: every run of :data:`RECORD_RUNS` through ``cli
    --mesh SPEC --record-dir`` (rank 0 writes ``tmp/rec/<spec>/<run>``);
    the runs of :data:`REPLAYED` replayed through ``cli replay`` inside
    the world (each rank's exit code; rank 0's report under
    ``tmp/rep/``); and a record whose mesh this world cannot hold,
    refused."""
    import json
    import shutil

    from coda_tpu_torch import cli

    out = {}
    for spec in RECORD_SPECS[world]:
        mesh = _spec_mesh(spec)
        res = {"printed": {}, "replay": {}}
        root = os.path.join(tmp, "rec", spec_dir(spec))
        for name in RECORD_RUNS:
            res["printed"][name] = _captured(cli.main, record_argv(
                name, tmp) + ["--mesh", spec, "--record-dir",
                              os.path.join(root, name)])
        _barrier(mesh)           # rank 0 has written every record
        for name in REPLAYED:
            report = os.path.join(tmp, "rep", f"{spec_dir(spec)}_{name}.json")
            res["replay"][name] = cli.main([
                "replay", os.path.join(root, name), "--device", "cpu",
                "--out", report])
        # a copy made under a mesh of another size: refused on every rank
        other = os.path.join(tmp, f"other_{spec_dir(spec)}_{rank}")
        shutil.copytree(os.path.join(root, "coda"), other)
        with open(os.path.join(other, "record.json")) as f:
            meta = json.load(f)
        meta["fingerprint"]["knobs"]["mesh"] = "data=4,model=2"
        with open(os.path.join(other, "record.json"), "w") as f:
            json.dump(meta, f)
        try:
            cli.main(["replay", other, "--device", "cpu"])
            res["refused"] = None
        except SystemExit as e:
            res["refused"] = str(e)
        out[spec] = res
    return out


def _checkpoint_runs(spec: str, tmp: str, make=None, name: str = "",
                     cases=("cut", "lost")) -> dict:
    """CODA (incremental; ``make``: another ``(preds, mesh)`` factory,
    its directories under ``name``) on the task at ``spec``: the
    uninterrupted run of :data:`ITERS` rounds; one cut after 5 rounds
    (saves at rounds 2 and 4) and resumed to 8; one whose newest step
    rank 1 lost, resumed from the step every rank holds. Each resumed run
    against the uninterrupted one, field by field (bitwise)."""
    import shutil

    from coda_tpu_torch import random as trandom
    from coda_tpu_torch.data import make_synthetic_task
    from coda_tpu_torch.engine import build_experiment_fn
    from coda_tpu_torch.engine.checkpoint import make_resumable_runner
    from coda_tpu_torch.oracle import true_losses

    mesh = _spec_mesh(spec)
    task = make_synthetic_task(**TASK, mesh=mesh)
    sel = (make or factory("coda"))(task.preds, mesh=mesh)
    losses = true_losses(task.preds, task.labels, mesh=mesh)
    full = build_experiment_fn(sel, task.labels, losses, ITERS,
                               mesh=mesh)(trandom.PRNGKey(0))
    out = {}
    for case in cases:
        ck = os.path.join(tmp, "ck", spec_dir(spec), name + case)
        timings: list = []
        make_resumable_runner(sel, task.labels, losses, 5, every=2,
                              timings=timings, mesh=mesh)(0, ck)
        if case == "lost":
            _barrier(mesh)
            if mesh.rank == 1:
                shutil.rmtree(os.path.join(ck, "rank_1", "step_4"))
            _barrier(mesh)
        got = make_resumable_runner(sel, task.labels, losses, ITERS,
                                    every=2, timings=timings,
                                    mesh=mesh)(0, ck)
        out[case] = {
            "bitwise": {f: bool(torch.equal(getattr(full, f),
                                            getattr(got, f)))
                        for f in full._fields},
            "ops": [(t["op"], t["round"]) for t in timings],
            "bytes": [t["bytes"] for t in timings]}
    return out


def job_checkpoints(rank, world, tmp) -> dict:
    """At each spec: :func:`_checkpoint_runs`; ``cli --checkpoint-dir``
    under ``--mesh`` (cut, then resumed; its printed lines); and a resume
    under another spec (the 2-rank world's model=2 on the data=2 run's
    directory), refused on every rank."""
    from coda_tpu_torch import cli

    out = {}
    for spec in RECORD_SPECS[world]:
        res = _checkpoint_runs(spec, tmp)
        ck = os.path.join(tmp, "ck_cli", spec_dir(spec))
        argv = record_argv("coda", tmp) + ["--mesh", spec,
                                           "--checkpoint-dir", ck,
                                           "--checkpoint-every", "3"]
        cut = [a if a != str(ITERS) else "4" for a in argv]
        res["cli"] = (_captured(cli.main, cut), _captured(cli.main, argv))
        out[spec] = res
    if world == 2:
        ck = os.path.join(tmp, "ck_cli", spec_dir("data=2"))
        try:
            out["other_spec"] = _captured(cli.main, record_argv(
                "coda", tmp) + ["--mesh", "model=2", "--checkpoint-dir", ck,
                                "--checkpoint-every", "3"])
        except ValueError as e:
            out["other_spec"] = str(e)
    return out


def job_suite_viz(rank, world, tmp) -> dict:
    """At each spec: ``cli suite --mesh SPEC --record-dir`` over
    ``pyfiles`` (N = 500, H = 14: sharded on every spec) with CODA and
    IID, and ``cli --debug-viz`` of CODA (2 seeds) on the task with the
    P(best) bars rank 0 draws captured."""
    from coda_tpu_torch import cli
    from coda_tpu_torch.utils import viz

    out = {}
    drawn: list = []
    plot_bar = viz.plot_bar

    def capture(values, *a, **k):
        drawn.append(np.asarray(values))
        return plot_bar(values, *a, **k)

    viz.plot_bar = capture
    try:
        for spec in RECORD_SPECS[world]:
            res = {}
            res["suite"] = _captured(cli.main, [
                "suite", "--pred-dir", os.path.join(REPO, "data"),
                "--tasks", "pyfiles", "--methods", "coda,iid", "--seeds",
                "2", "--iters", "6", "--device", "cpu", "--no-db",
                "--mesh", spec, "--record-dir",
                os.path.join(tmp, "suite", spec_dir(spec))])
            drawn.clear()
            argv = [a for a in record_argv("coda_batch2", tmp)
                    if a != "--no-mlflow"]
            res["viz"] = _captured(cli.main, argv + [
                "--mesh", spec, "--debug-viz", "--tracking-db",
                os.path.join(tmp, f"viz_{spec_dir(spec)}_{rank}.sqlite")])
            res["pbest"] = list(drawn)
            out[spec] = res
    finally:
        viz.plot_bar = plot_bar
    return out


# -- CODA's knobs and the q-wide round on a mesh ------------------------------

# eig_pbest=amortized at a prior whose class rows sit just under the gate
# (min_h(a + b) = 31.99): a row's first label leaves it closed, its second
# opens it, so the gate engages in some rounds and not others
AMORT_MULTIPLIER = "15.2309"
PREFILTER_N = 16
_INCR = ["--method", "coda", "--eig-mode", "incremental"]
# name -> (CLI flags, seeds)
KNOB_RUNS = {
    "dense": (_INCR, 1),
    "dense_batch2": (_INCR, 2),
    "sparse2": (_INCR + ["--posterior", "sparse:2"], 1),
    "sparse2_batch2": (_INCR + ["--posterior", "sparse:2"], 2),
    "sparse4": (_INCR + ["--posterior", "sparse:4"], 1),
    "sparse4_batch2": (_INCR + ["--posterior", "sparse:4"], 2),
    "amortized": (_INCR + ["--eig-pbest", "amortized", "--multiplier",
                           AMORT_MULTIPLIER], 1),
    "prefilter": (["--method", "coda", "--prefilter-n", str(PREFILTER_N)],
                  1),
    "prefilter_iid": (["--method", "coda", "--q", "iid", "--prefilter-n",
                       str(PREFILTER_N)], 1),
    "prefilter_unc": (["--method", "coda", "--q", "uncertainty",
                       "--prefilter-n", str(PREFILTER_N)], 1),
    "q2": (_INCR + ["--acq-batch", "2"], 1),
    "q4": (_INCR + ["--acq-batch", "4"], 1),
    "q2_factored": (["--method", "coda", "--eig-mode", "factored",
                     "--acq-batch", "2"], 1),
    "q4_factored": (["--method", "coda", "--eig-mode", "factored",
                     "--acq-batch", "4"], 1),
    "iid_q4": (["--method", "iid", "--acq-batch", "4"], 1),
    "uncertainty_q2": (["--method", "uncertainty", "--acq-batch", "2"], 1),
    "model_picker_q4": (["--method", "model_picker", "--acq-batch", "4"],
                        1),
}


def knob_argv(name: str, data_dir: str) -> list:
    """The CLI flags of a run of :data:`KNOB_RUNS` on the task files under
    ``data_dir`` (``--mesh`` and ``--record-dir`` added by the caller)."""
    flags, seeds = KNOB_RUNS[name]
    return ["--task", TASK_FILE, "--data-dir", data_dir, "--iters",
            str(ITERS), "--seeds", str(seeds), "--device", "cpu",
            "--no-mlflow"] + flags


@contextlib.contextmanager
def gates_seen(seen: list):
    """Every ``ops.pbest.amortized_gate`` verdict of the body, appended
    to ``seen`` as lists of bools."""
    from coda_tpu_torch.ops import pbest

    gate = pbest.amortized_gate

    def record(*args, **kw):
        out = gate(*args, **kw)
        seen.append(out.reshape(-1).tolist())
        return out

    pbest.amortized_gate = record
    try:
        yield seen
    finally:
        pbest.amortized_gate = gate


def job_knobs(rank, world, tmp) -> dict:
    """At each spec: every run of :data:`KNOB_RUNS` through ``cli --mesh
    SPEC --record-dir`` (rank 0 writes ``tmp/knobs/<spec>/<run>``; the
    amortized run's gate verdicts kept), then each replayed through ``cli
    replay`` inside the world (each rank's exit code; rank 0's report
    under ``tmp/knobrep/``)."""
    from coda_tpu_torch import cli

    out = {}
    for spec in RECORD_SPECS[world]:
        mesh = _spec_mesh(spec)
        res = {"printed": {}, "replay": {}, "gates": []}
        root = os.path.join(tmp, "knobs", spec_dir(spec))
        for name in KNOB_RUNS:
            argv = knob_argv(name, tmp) + [
                "--mesh", spec, "--record-dir", os.path.join(root, name)]
            with gates_seen(res["gates"] if name == "amortized" else []):
                res["printed"][name] = _captured(cli.main, argv)
        _barrier(mesh)           # rank 0 has written every record
        for name in KNOB_RUNS:
            res["replay"][name] = cli.main([
                "replay", os.path.join(root, name), "--device", "cpu",
                "--out", os.path.join(tmp, "knobrep",
                                      f"{spec_dir(spec)}_{name}.json")])
        out[spec] = res
    return out


def tie_draw() -> np.ndarray:
    """The prefilter's uniforms over the task's 64 items with exact ties
    across the data block boundary (31 | 32) and at the K-th place: 0.75
    at four items, 0.5 at sixteen (28-35, 45-52), 0.25 elsewhere. Of the
    candidates among them, the top 16 takes those at 0.75, then the 0.5
    tie in index order, from both blocks."""
    u = np.full(64, 0.25, np.float32)
    u[[3, 40, 50, 60]] = 0.75
    u[list(range(28, 36)) + list(range(45, 53))] = 0.5
    return u


@contextlib.contextmanager
def drawn(u: np.ndarray, k_sub: torch.Tensor, subsets: list):
    """The prefilter's draw (the one from ``k_sub``) replaced by ``u``
    (each rank its slice, at the global positions), and every top k CODA
    takes appended to ``subsets``."""
    from coda_tpu_torch import random as trandom
    from coda_tpu_torch.selectors import coda as coda_mod

    uniform, top_k = trandom.uniform, coda_mod.top_k

    def fixed(key, shape, device=None, start=0, total=None):
        if torch.equal(key, k_sub):
            return torch.from_numpy(u[start:start + shape[-1]].copy())
        return uniform(key, shape, device=device, start=start, total=total)

    def seen(*args, **kw):
        got = top_k(*args, **kw)
        subsets.append([t.numpy().tolist() for t in got])
        return got

    trandom.uniform, coda_mod.top_k = fixed, seen
    try:
        yield subsets
    finally:
        trandom.uniform, coda_mod.top_k = uniform, top_k


def tie_select(make, preds, labels, mesh=None) -> dict:
    """One select (and one ablation select) of a fresh CODA state under
    :func:`tie_draw`: the subsets and thresholds taken, the pick, its
    score and this block's recorded scores."""
    from coda_tpu_torch import random as trandom

    out = {}
    for q in ("eig", "iid"):
        sel = make(q)(preds) if mesh is None else make(q)(preds, mesh=mesh)
        st = sel.init(None)
        subsets: list = []
        key = trandom.PRNGKey(5)
        with drawn(tie_draw(), trandom.split(key)[0], subsets):
            res = sel.select(st, key)
        out[q] = {"subsets": subsets, "idx": int(res.idx),
                  "prob": float(res.prob),
                  "scores": res.scores.numpy()}
    return out


def tie_factory(q: str):
    from coda_tpu_torch.selectors import CODAHyperparams, make_coda

    hp = CODAHyperparams(q=q, prefilter_n=PREFILTER_N)
    return lambda p, mesh=None: make_coda(p, hp, device="cpu", mesh=mesh)


def gate_case() -> dict:
    """Beta parameters of one class row over the task's 8 models, the
    first four concentrated above the amortized gate (min 40) and the
    last four not (min 20), and which models predicted the class at each
    of 64 items (every model's)."""
    rng = np.random.default_rng(17)
    conc = np.array([40, 44, 52, 60, 20, 36, 48, 64], np.float32)
    a = (rng.uniform(0.3, 0.7, 8) * conc).astype(np.float32)
    return {"a": a, "b": (conc - a).astype(np.float32),
            "eq": rng.uniform(size=(64, 8)) < 0.3}


def job_knob_cases(rank, world, tmp) -> dict:
    """At each spec: the prefilter's select under :func:`tie_draw`; where
    the spec has a model axis, the amortized row refresh of
    :func:`gate_case` (one H block's models above the gate, the other's
    not, and the same with the second block raised above it too), its
    gate verdicts and this rank's columns; and a ``sparse:2`` run cut
    after 5 rounds and resumed (bitwise the uninterrupted run)."""
    from coda_tpu_torch.data import make_synthetic_task
    from coda_tpu_torch.ops.pbest import _pbest_hyp_row_gated
    from coda_tpu_torch.selectors import CODAHyperparams, make_coda

    out = {}
    for spec in RECORD_SPECS[world]:
        mesh = _spec_mesh(spec)
        task = make_synthetic_task(**TASK, mesh=mesh)
        res = {"tie": tie_select(tie_factory, task.preds, task.labels,
                                 mesh)}
        if mesh.model > 1:
            z = gate_case()
            res["gate"] = {}
            for case, lift in (("split", 0.0), ("both", 20.0)):
                b = z["b"] + np.where(np.arange(8) >= 4, lift, 0.0) \
                    .astype(np.float32)
                gates: list = []
                with gates_seen(gates):
                    row = _pbest_hyp_row_gated(
                        _blk(z["a"], mesh, None, 0), _blk(b, mesh, None, 0),
                        torch.from_numpy(z["eq"]), 1.0, 64, 32.0,
                        mesh=mesh)
                res["gate"][case] = {"gates": gates, "row": row.numpy()}
        hp = CODAHyperparams(eig_mode="incremental", posterior="sparse:2")
        res["sparse_ckpt"] = _checkpoint_runs(
            spec, tmp, make=lambda p, mesh=None: make_coda(
                p, hp, device="cpu", mesh=mesh),
            name="sparse2_", cases=("cut",))
        out[spec] = res
    return out


# -- the surrogate scorer and the noisy crowd ---------------------------------

# past the surrogate's 10 warmup rounds, so hybrid rounds run
SURROGATE_ITERS = 16
SURROGATE_K = 8
# the reference's noisy crowd (its robustness spec)
CROWD_SPEC = ("annotators=8,votes=3,acc=0.55:0.95,abstain=0.1,adversarial=1,"
              "trust=32,defer=0.2:4,reliability=learned,seed=0")
_SURR = _INCR + ["--eig-scorer", f"surrogate:{SURROGATE_K}"]
_CROWD = _INCR + ["--oracle-noise", CROWD_SPEC]
# name -> (CLI flags, seeds, rounds)
SC_RUNS = {
    "surrogate": (_SURR, 1, SURROGATE_ITERS),
    # the CLI passes no pool: the cold program under the pool knob
    "surrogate_pool": (_SURR + ["--surrogate-prior", "pool"], 1,
                       SURROGATE_ITERS),
    "crowd": (_CROWD, 1, ITERS),
    "crowd_batch2": (_CROWD, 2, ITERS),
    "crowd_q2": (_CROWD + ["--acq-batch", "2"], 1, ITERS),
}
PRIOR_FILE = "prior.json"     # the seeded surrogate's pool, written by the test


def sc_argv(name: str, data_dir: str) -> list:
    """The CLI flags of a run of :data:`SC_RUNS` on the task files under
    ``data_dir`` (``--mesh`` and ``--record-dir`` added by the caller)."""
    flags, seeds, iters = SC_RUNS[name]
    return ["--task", TASK_FILE, "--data-dir", data_dir, "--iters",
            str(iters), "--seeds", str(seeds), "--device", "cpu",
            "--no-mlflow"] + flags


# the crowd's refusals that stay on a mesh: a baseline (no weighted
# update) and the resumable runner
SC_REFUSED = {"baseline": ["--method", "iid", "--oracle-noise", CROWD_SPEC],
              "checkpoint": _CROWD + ["--checkpoint-dir", "CK"]}


def sc_refused_argv(case: str, data_dir: str, ck: str) -> list:
    return ["--task", TASK_FILE, "--data-dir", data_dir, "--iters",
            str(ITERS), "--device", "cpu", "--no-mlflow"] + [
        ck if f == "CK" else f for f in SC_REFUSED[case]]


@contextlib.contextmanager
def crowd_seen(seen: dict):
    """Every vote the crowd draws (``votes_from_draws``' responses) and
    every reliability state's counts after an aggregation, appended to
    ``seen["votes"]`` and ``seen["counts"]`` as arrays."""
    from coda_tpu_torch.crowd import loop

    votes, agg = loop.votes_from_draws, loop.aggregate_votes

    def drawn_votes(*args, **kw):
        out = votes(*args, **kw)
        seen.setdefault("votes", []).append(out.numpy().copy())
        return out

    def aggregated(*args, **kw):
        out = agg(*args, **kw)
        seen.setdefault("counts", []).append(out[2].counts.numpy().copy())
        return out

    loop.votes_from_draws, loop.aggregate_votes = drawn_votes, aggregated
    try:
        yield seen
    finally:
        loop.votes_from_draws, loop.aggregate_votes = votes, agg


def surrogate_factory(prior=None):
    """CODA's incremental tier with ``surrogate:8`` (the pool knob and
    ``prior``, a ``PriorStats``, when given)."""
    from coda_tpu_torch.selectors import CODAHyperparams, make_coda

    hp = CODAHyperparams(eig_mode="incremental",
                         eig_scorer=f"surrogate:{SURROGATE_K}",
                         surrogate_prior="off" if prior is None else "pool")
    return lambda p, mesh=None: make_coda(p, hp, device="cpu", prior=prior,
                                          mesh=mesh)


def surrogate_internals(make, preds, labels, mesh=None) -> dict:
    """A recorded ``surrogate:8`` run of one seed x
    :data:`SURROGATE_ITERS` through ``make`` (a factory), its fit after
    every round (``A``, ``b``, ``w``, ``n``, ``cls_feats``) and which
    rounds took the hybrid vector (past warmup, no fallback); the
    record."""
    import dataclasses

    from coda_tpu_torch.engine import run_seeds_recorded
    from coda_tpu_torch.selectors.surrogate import SURROGATE_WARMUP_ROUNDS
    from coda_tpu_torch.telemetry.recorder import RunRecord

    fits: list = []

    def capturing(p, mesh=None):
        sel = make(p) if mesh is None else make(p, mesh=mesh)

        def update(state, *args):
            st = sel.update(state, *args)
            f = st.surrogate
            warm = int(f.rounds) - 1 + int(f.prior_rounds) \
                < SURROGATE_WARMUP_ROUNDS
            fits.append({"hybrid": not warm and not bool(f.last_fallback),
                         **{k: getattr(f, k).numpy().copy() for k in
                            ("A", "b", "w", "n", "cls_feats")}})
            return st

        return dataclasses.replace(sel, update=update)

    out = run_seeds_recorded(capturing, preds, labels,
                             iters=SURROGATE_ITERS, seeds=1, device="cpu",
                             mesh=mesh)
    return {"fits": fits, "hybrid": [f.pop("hybrid") for f in fits],
            "record": RunRecord.from_result(*out, {}, {})}


def load_prior(tmp: str):
    from coda_tpu_torch.selectors import surrogate as sg

    with open(os.path.join(tmp, PRIOR_FILE)) as f:
        import json

        return sg.prior_from_dict(json.load(f))


def job_surrogate_crowd(rank, world, tmp) -> dict:
    """At each spec: every run of :data:`SC_RUNS` through ``cli --mesh
    SPEC --record-dir`` (rank 0 writes ``tmp/sc/<spec>/<run>``; the crowd
    runs' votes and reliability counts kept), each replayed through ``cli
    replay`` inside the world (exit codes; rank 0's report under
    ``tmp/screp/``); the surrogate's internals (:func:`surrogate_internals`)
    cold and seeded from the test's pool, the seeded run re-executed
    through ``engine.replay.verify_replay`` on the mesh; a crowd baseline
    and a noisy crowd with ``--checkpoint-dir`` refused."""
    from coda_tpu_torch import cli
    from coda_tpu_torch.data import make_synthetic_task
    from coda_tpu_torch.engine.replay import verify_replay

    prior = load_prior(tmp)
    out = {}
    for spec in RECORD_SPECS[world]:
        mesh = _spec_mesh(spec)
        res = {"printed": {}, "replay": {}, "crowd": {}, "refused": {}}
        root = os.path.join(tmp, "sc", spec_dir(spec))
        for name in SC_RUNS:
            seen: dict = {}
            with crowd_seen(seen):
                res["printed"][name] = _captured(cli.main, sc_argv(
                    name, tmp) + ["--mesh", spec, "--record-dir",
                                  os.path.join(root, name)])
            res["crowd"][name] = seen
        _barrier(mesh)           # rank 0 has written every record
        for name in SC_RUNS:
            res["replay"][name] = cli.main([
                "replay", os.path.join(root, name), "--device", "cpu",
                "--out", os.path.join(tmp, "screp",
                                      f"{spec_dir(spec)}_{name}.json")])
        task = make_synthetic_task(**TASK, mesh=mesh)
        for case, pool in (("cold", None), ("seeded", prior)):
            res[case] = surrogate_internals(surrogate_factory(pool),
                                            task.preds, task.labels, mesh)
        res["seeded_replay"] = verify_replay(
            res["seeded"]["record"], surrogate_factory(prior), task.preds,
            task.labels, device="cpu", mesh=mesh).to_dict()
        for case in SC_REFUSED:
            argv = sc_refused_argv(case, tmp, os.path.join(
                tmp, "sc_ck", f"{spec_dir(spec)}_{rank}"))
            try:
                _captured(cli.main, argv + ["--mesh", spec])
                res["refused"][case] = None
            except (ValueError, SystemExit) as e:
                res["refused"][case] = f"{type(e).__name__}: {e}"
        out[spec] = res
    return out


def job_prior_chunks(rank, world, tmp) -> dict:
    """``gather_sum`` over the data group of a ``(37, 5, 5)`` part a rank
    (seeded by the rank) whole and in chunks of 4 and 1 models, and the
    confusion prior of the task's block whole and a model at a time."""
    from coda_tpu_torch.data import make_synthetic_task
    from coda_tpu_torch.ops import confusion
    from coda_tpu_torch.parallel.collectives import gather_sum

    mesh = _mesh(world)
    gen = torch.Generator().manual_seed(100 + rank)
    part = torch.rand((37, 5, 5), generator=gen) * 10 ** torch.randint(
        -3, 4, (37, 5, 5), generator=gen).to(torch.float32)
    out = {"whole": gather_sum(part.clone(), mesh).numpy(),
           "chunks": {c: gather_sum(part.clone(), mesh, chunk=c).numpy()
                      for c in (4, 1)}}
    task = make_synthetic_task(**TASK, mesh=mesh)
    ens = confusion.ensemble_preds(task.preds, mesh).argmax(-1)
    prior = {}
    saved = confusion._PRIOR_CHUNK_BYTES
    for case, nbytes in (("whole", saved), ("per_model", 1)):
        confusion._PRIOR_CHUNK_BYTES = nbytes
        try:
            prior[case] = confusion.create_confusion_matrices(
                ens, task.preds, mode="soft", mesh=mesh).numpy()
        finally:
            confusion._PRIOR_CHUNK_BYTES = saved
    out["prior"] = prior
    return out


JOBS = {"traces": job_traces, "blocks": job_blocks, "large_c": job_large_c,
        "collectives": job_collectives, "cli": job_cli, "env": job_env,
        "model_traces": job_model_traces, "model_blocks": job_model_blocks,
        "model_large_c": job_model_large_c, "model_cli": job_model_cli,
        "tie_topk": job_tie_topk, "records": job_records,
        "checkpoints": job_checkpoints, "suite_viz": job_suite_viz,
        "knobs": job_knobs, "knob_cases": job_knob_cases,
        "surrogate_crowd": job_surrogate_crowd,
        "prior_chunks": job_prior_chunks}
