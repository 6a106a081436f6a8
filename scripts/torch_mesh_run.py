#!/usr/bin/env python3
"""Runs the port's command line on a mesh (``data=d`` by default, or
``--mesh model=b`` / ``data=a,model=b``) and records what a check of it
needs: each round's scores of this rank's block, the decisions, the
fingerprints of the state each group holds alike, the kernels' launch
counts, the bytes each axis's collectives carried and the device's peak
memory. One process a rank::

    python -m torch.distributed.run --standalone --nproc-per-node 2 \\
        scripts/torch_mesh_run.py --data-dir D --task headline --out OUT \\
        [--mesh model=2]

``D/<task>.npy`` (+ ``<task>_labels.npy``) is the task. Each job drives
``coda_tpu_torch.cli`` as a user would (``--task ... --mesh SPEC``),
with the selector factory wrapped to keep each round's score vector and
the final state, and the experiment timed (``run_seeds_compiled``'s
``timings``); every launch counter is set to 0 just before the job and
read just after. Each task file is read once a run, by the first job
that names it (:func:`loaded_once`). Rank r writes ``OUT/rank<r>.json`` and
``OUT/rank<r>.npz``. Without ``torchrun`` (one process, ``--unsharded``)
the same jobs run unsharded, the yardstick the mesh is held to;
``chip_smoke.py`` calls :func:`run_jobs` in its own process for that.
The jobs (``--jobs``):

  * ``main``: CODA with the CLI's defaults, 1 seed (the incremental
    tier: kernels 1, 2, 3);
  * ``batch``: 5 seeds as one batch on the incremental tier (kernels 4,
    5 and the batched kernel 3);
  * ``paper``: the paper's command, 5 seeds with auto knobs (the
    factored tier at the headline, no kernel);
  * ``iid``, ``uncertainty``, ``activetesting``, ``vma``,
    ``model_picker``: the baselines, 1 seed;
  * ``suite``: ``cli suite`` over ``--suite-tasks`` of ``--pred-dir``;
  * ``main_rec``, ``batch_rec``: ``main`` and ``batch`` with the flight
    recorder on (``--record-dir OUT/records/<job>``, written by rank 0);
  * ``ckpt_cut``, ``ckpt``: ``main`` with ``--checkpoint-dir
    OUT/records/ckpt --checkpoint-every 5``, cut after the ``ckpt_cut``
    rounds, then resumed to ``main``'s rounds (each rank saves its own
    blocks; the saves' and the restore's bytes and seconds kept);
  * ``viz``: CODA 1 seed with ``--debug-viz`` on ``--viz-task`` (a
    tracking store under ``OUT/records``); the figures' data are kept in
    place of drawing them (the P(best) bars rank 0 logs), so the job runs
    without matplotlib;
  * ``sparse_rec``: CODA 1 seed on ``--pool-task`` with ``--posterior
    sparse:32 --eig-chunk 64`` (the incremental tier: kernels 1, 2, 3);
  * ``amort_rec``: CODA 1 seed with ``--eig-pbest amortized --multiplier
    20`` (kernels 1, 2, 3; the gate's verdict each round kept);
  * ``prefilter_rec``: CODA 1 seed with ``--prefilter-n K`` (the
    script's ``--prefilter-n``, default 4096: the factored tier on the
    subset, no kernel);
  * ``q4_rec``: CODA 1 seed with ``--acq-batch 4`` (kernel 1 at init and
    once a round, kernel 3 once an answer);
  * ``surr_rec``: CODA 1 seed with ``--eig-scorer surrogate:32`` (kernel
    1 at init and on each warmup or fallback round, kernel 3 once a
    round; the rounds that took the hybrid vector and the final fit's
    digest kept);
  * ``crowd_rec``, ``crowd_batch_rec``: CODA 1 seed, and 5 seeds as one
    batch, labelled by the noisy crowd ``--oracle-noise`` (the script's
    ``--crowd-spec``; kernels 1-3, and 4, 5 and the batched 3; the applied
    labels and weights kept) — these seven recorded;
  * ``prior_chunks``: the confusion prior of a seeded random ``(64, 256,
    100)`` task (this rank's block) with its data-group sum a model at a
    time against the sum whole: bitwise or not;
  * ``replay``: ``cli replay`` of each record the earlier jobs wrote
    (after every rank has passed a barrier; ``--replays`` names them,
    default every one), on these ranks: each rank's exit code and wall
    seconds, rank 0's report under ``OUT/records/replay_<job>.json``.

It imports nothing of JAX or of the reference package.
"""

from __future__ import annotations

import argparse
import contextlib
import dataclasses
import gc
import hashlib
import io
import json
import os
import sqlite3
import sys
import time

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)

BASELINES = ("iid", "uncertainty", "activetesting", "vma", "model_picker")
# the knobs' jobs: name -> (CLI flags, their rounds' key)
KNOB_JOBS = {
    "sparse": (["--eig-mode", "incremental", "--posterior", "sparse:32",
                "--eig-chunk", "64"], "sparse"),
    "amort": (["--eig-pbest", "amortized", "--multiplier", "20"], "amort"),
    "prefilter": (["--prefilter-n"], "prefilter"),     # + the size
    "q4": (["--acq-batch", "4"], "q4"),
    "surr": (["--eig-mode", "incremental", "--eig-scorer", "surrogate:32"],
             "surr"),
    "crowd": (["--eig-mode", "incremental", "--oracle-noise"], "crowd"),
    "crowd_batch": (["--eig-mode", "incremental", "--oracle-noise"],
                    "crowd_batch"),                    # + the spec
}
# the crowd jobs' default spec (chip_smoke.py's CROWD_SPEC)
CROWD_SPEC = ("annotators=8,votes=3,acc=0.6:0.95,abstain=0.1,"
              "adversarial=1,trust=16,seed=0")


def job_argv(job: str, rounds: dict, root: str = ".",
             prefilter_n: int = 4096, crowd_spec: str = CROWD_SPEC) -> list:
    """The CLI flags of a job (the task and mesh flags added by the
    caller); ``rounds`` maps a job to its rounds; ``root`` takes the
    records, checkpoints and tracking stores of the jobs that write
    them; ``prefilter_n`` is the prefilter job's subset, ``crowd_spec``
    the crowd jobs' ``--oracle-noise``."""
    if job.endswith("_rec"):
        return job_argv(job.removesuffix("_rec"), rounds,
                        prefilter_n=prefilter_n, crowd_spec=crowd_spec) + [
            "--record-dir", os.path.join(root, job)]
    if job in ("ckpt_cut", "ckpt"):
        iters = rounds["ckpt_cut" if job == "ckpt_cut" else "main"]
        return ["--method", "coda", "--seeds", "1", "--iters", str(iters),
                "--checkpoint-dir", os.path.join(root, "ckpt"),
                "--checkpoint-every", "5"]
    if job == "viz":
        return ["--method", "coda", "--seeds", "1",
                "--iters", str(rounds["viz"]), "--debug-viz",
                "--tracking-db", os.path.join(root, "viz.sqlite")]
    if job == "main":
        return ["--method", "coda", "--seeds", "1",
                "--iters", str(rounds["main"])]
    if job in KNOB_JOBS:
        flags, key = KNOB_JOBS[job]
        if job == "prefilter":
            flags = flags + [str(prefilter_n)]
        elif job.startswith("crowd"):
            flags = flags + [crowd_spec]
        seeds = "5" if job == "crowd_batch" else "1"
        return ["--method", "coda", "--seeds", seeds,
                "--iters", str(rounds[key])] + flags
    if job == "batch":
        return ["--method", "coda", "--eig-mode", "incremental",
                "--seeds", "5", "--iters", str(rounds["batch"])]
    if job == "paper":
        return ["--method", "coda", "--iters", str(rounds["paper"])]
    if job in BASELINES:
        return ["--method", job, "--seeds", "1",
                "--iters", str(rounds["baselines"])]
    raise ValueError(f"unknown job {job!r}")


class Capture:
    """What a wrapped selector saw: each round's score vector (kept on
    the device, copied once at the end), the last state, under the
    surrogate scorer whether each round took the hybrid vector, and the
    bytes the collectives sent inside the rounds' select, update and best
    calls, q-wide, weighted or not (``parallel.collectives.traffic``, by
    axis)."""

    def __init__(self):
        self.scores: list = []
        self.state = None
        self.hybrid: list = []
        self.round_bytes: dict = {}

    def _keep(self, state):
        """The state after an update; a surrogate round's hybrid flag
        (past warmup, no fallback), on the device."""
        from coda_tpu_torch.selectors.surrogate import (
            SURROGATE_WARMUP_ROUNDS,
        )

        self.state = state
        fit = getattr(state, "surrogate", None)
        if fit is not None:
            warm = fit.rounds - 1 + fit.prior_rounds \
                < SURROGATE_WARMUP_ROUNDS
            self.hybrid.append(~warm & ~fit.last_fallback)
        return state

    def _counted(self, fn):
        from coda_tpu_torch.parallel import collectives

        def call(*args):
            before = dict(collectives.traffic)
            out = fn(*args)
            for k, v in collectives.traffic.items():
                self.round_bytes[k] = (self.round_bytes.get(k, 0) + v
                                       - before[k])
            return out
        return call

    def wrap(self, sel):
        def select(state, key):
            res = sel.select(state, key)
            self.scores.append(res.scores.detach().clone())
            return res

        def update(state, *args):
            return self._keep(sel.update(state, *args))

        q_wide = {}
        if sel.update_w is not None:
            def update_w(state, *args):
                return self._keep(sel.update_w(state, *args))

            q_wide["update_w"] = self._counted(update_w)
        if sel.update_qw is not None:
            def update_qw(state, *args):
                return self._keep(sel.update_qw(state, *args))

            q_wide["update_qw"] = self._counted(update_qw)
        if sel.select_q is not None:
            def select_q(state, key, q):
                res = sel.select_q(state, key, q)
                self.scores.append(res.scores.detach().clone())
                return res

            q_wide["select_q"] = self._counted(select_q)
        if sel.update_q is not None:
            def update_q(state, *args):
                return self._keep(sel.update_q(state, *args))

            q_wide["update_q"] = self._counted(update_q)
        inner = sel.batched
        batched = None
        if inner is not None:
            def bselect(state, keys):
                res = inner.select(state, keys)
                self.scores.append(res.scores.detach().clone())
                return res

            def bupdate(state, *args):
                return self._keep(inner.update(state, *args))

            weighted = {}
            if inner.update_w is not None:
                def bupdate_w(state, *args):
                    return self._keep(inner.update_w(state, *args))

                weighted["update_w"] = self._counted(bupdate_w)
            batched = dataclasses.replace(
                inner, select=self._counted(bselect),
                update=self._counted(bupdate),
                best=self._counted(inner.best), **weighted)
        return dataclasses.replace(sel, select=self._counted(select),
                                   update=self._counted(update),
                                   best=self._counted(sel.best),
                                   batched=batched, **q_wide)


def fingerprint(state, n_local: int) -> str:
    """sha256 of the fields of a selector state without an axis of
    length ``n_local``. With this rank's items, the fields its data group
    holds alike (on a ``data=d`` mesh every rank: the posterior, pi-hat,
    the P(best) rows); with its models, those its model group holds alike
    (pi-hat and its item rows, the scores, the unlabeled mask)."""
    import torch

    h = hashlib.sha256()
    for name in state._fields:
        t = getattr(state, name)
        if isinstance(t, torch.Tensor) and n_local not in t.shape:
            h.update(name.encode())
            h.update(t.detach().cpu().contiguous().view(-1).view(
                torch.uint8).numpy().tobytes())
    return h.hexdigest()


def fit_digest(state) -> str:
    """sha256 of the surrogate's carried fit (its normal equations, the
    ridge solution, the pair count, the class summaries and counters);
    empty without one."""
    import torch

    fit = getattr(state, "surrogate", None)
    if fit is None:
        return ""
    h = hashlib.sha256()
    for t in fit:
        h.update(t.detach().cpu().contiguous().reshape(-1).view(
            torch.uint8).numpy().tobytes())
    return h.hexdigest()


def counts() -> dict:
    from coda_tpu_torch.ops import eig_kernels as ek
    from coda_tpu_torch.ops import gather_kernels as gk

    out = {k: v for k, v in ek.launch_counts.items() if v}
    out.update({k: v for k, v in gk.launch_counts.items() if v})
    return out


def split_counts() -> dict:
    """Of :func:`counts`, kernels 1 and 2's launches that took the split
    decomposition, by flavour."""
    from coda_tpu_torch.ops import eig_kernels as ek

    return {k: v for k, v in ek.split_counts.items() if v}


def reset_counts() -> None:
    from coda_tpu_torch.ops import eig_kernels as ek
    from coda_tpu_torch.ops import gather_kernels as gk

    for d in (ek.launch_counts, gk.launch_counts, ek.split_counts):
        for k in d:
            d[k] = 0


def _sync(dev) -> None:
    import torch

    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def _dir_bytes(path: str) -> int:
    return sum(os.path.getsize(os.path.join(d, f))
               for d, _, fs in os.walk(path) for f in fs)


class _Figures:
    """``coda_tpu_torch.utils.viz`` with the drawing replaced: the P(best)
    bars' values are kept (``pbest``) and every figure logs as an empty
    artifact, so ``--debug-viz`` runs where matplotlib is not installed."""

    def __init__(self):
        self.pbest: list = []

    def __enter__(self):
        from coda_tpu_torch.utils import viz

        self.saved = {k: getattr(viz, k) for k in
                      ("_pyplot", "plot_bar", "plot_series", "fig_to_png")}
        viz._pyplot = lambda: None
        viz.plot_bar = lambda values, *a, **k: self.pbest.append(
            [float(v) for v in values])
        viz.plot_series = lambda *a, **k: None
        viz.fig_to_png = lambda fig: b""
        return self

    def __exit__(self, *exc):
        from coda_tpu_torch.utils import viz

        for k, v in self.saved.items():
            setattr(viz, k, v)


def run_cli_job(argv: list, dev) -> dict:
    """One ``cli.main(argv)`` with the factory wrapped (:class:`Capture`)
    and the experiment timed; the counters set to 0 just before and read
    just after, the device's peak memory reset and read. A recorded job
    keeps its record's bytes, a checkpointed one its saves' and
    restore's bytes and seconds, a ``--debug-viz`` one its P(best)
    bars, an amortized one its gate's verdicts (one a round)."""
    import numpy as np
    import torch

    from coda_tpu_torch import cli
    from coda_tpu_torch.engine import run_seeds_compiled
    from coda_tpu_torch.ops import pbest
    from coda_tpu_torch.parallel import collectives

    cap = Capture()
    gates: list = []
    gate_fn = pbest.amortized_gate

    def gate(*args, **kw):
        out = gate_fn(*args, **kw)
        gates.append(out.detach().clone())     # read after the run
        return out
    got: dict = {}
    orig_factory, orig_run = cli.build_selector_factory, cli.run_all_seeds

    def build(args, task_name):
        f = orig_factory(args, task_name)
        return lambda preds, mesh=None: cap.wrap(f(preds, mesh=mesh))

    def run(args, factory, dataset, loss_fn, dev_):
        # the CLI's own calls, timed
        got.update(h_local=dataset.preds.shape[0],
                   n_local=dataset.preds.shape[1], timings=[])
        cfg = cli.crowd_config(args)
        trace_k = args.record_topk if args.record_dir else 0
        if cfg is not None and not cfg.clean:
            from coda_tpu_torch.crowd import (
                run_seeds_crowd,
                run_seeds_crowd_recorded,
            )

            common = dict(iters=args.iters, seeds=args.seeds,
                          loss_fn=loss_fn, acq_batch=args.acq_batch,
                          device=dev_, timings=got["timings"],
                          cost_label=args.method, mesh=dataset.mesh)
            if trace_k:
                res, aux, crowd = run_seeds_crowd_recorded(
                    factory, dataset.preds, dataset.labels, cfg,
                    trace_k=trace_k, **common)
            else:
                (res, crowd), aux = run_seeds_crowd(
                    factory, dataset.preds, dataset.labels, cfg,
                    **common), None
            got.update(result=res, crowd=crowd)
            return res, aux, crowd
        if args.checkpoint_dir:
            ckpt: list = []
            res = cli._run_resumable(args, factory, dataset, loss_fn, dev_,
                                     timings=ckpt)
            got.update(result=res, checkpoint=ckpt)
            return res, None, None
        out = run_seeds_compiled(factory, dataset.preds, dataset.labels,
                                 iters=args.iters, seeds=args.seeds,
                                 loss_fn=loss_fn, device=dev_,
                                 timings=got["timings"],
                                 cost_label=args.method, trace_k=trace_k,
                                 acq_batch=args.acq_batch,
                                 mesh=dataset.mesh)
        res, aux = out if trace_k else (out, None)
        got["result"] = res
        return res, aux, None

    cli.build_selector_factory, cli.run_all_seeds = build, run
    pbest.amortized_gate = gate
    # an earlier job's selector (its closures form reference cycles) is
    # collected first: the peak is this job's own
    gc.collect()
    if dev.type == "cuda":
        torch.cuda.reset_peak_memory_stats(dev)
    out = io.StringIO()
    figures = _Figures()
    try:
        _sync(dev)
        reset_counts()
        sent = dict(collectives.traffic)
        with contextlib.redirect_stdout(out), (
                figures if "--debug-viz" in argv
                else contextlib.nullcontext()):
            rc = cli.main(argv)
        _sync(dev)
        launched, split = counts(), split_counts()
        sent = {k: v - sent[k] for k, v in collectives.traffic.items()}
    finally:
        cli.build_selector_factory, cli.run_all_seeds = orig_factory, \
            orig_run
        pbest.amortized_gate = gate_fn
    res = got["result"]
    rounds = sum(t["rounds_ms"] for t in got["timings"])
    iters = res.chosen_idx.shape[1]
    # one timing a seed (seeds one after another), or the batch's one
    per = max(1, len(got["timings"]))
    extra = {}
    if "--record-dir" in argv:
        rec = argv[argv.index("--record-dir") + 1]
        extra["record_bytes"] = _dir_bytes(rec) if os.path.isdir(rec) \
            else 0
    if "checkpoint" in got:
        extra["checkpoint"] = got["checkpoint"]
    if "--debug-viz" in argv:
        extra["pbest"] = figures.pbest
    if gates:
        extra["gates"] = [bool(g) for g in gates]
    if cap.hybrid:
        extra["hybrid"] = [bool(h) for h in
                           torch.stack(cap.hybrid).reshape(-1).cpu()]
        extra["fit_digest"] = fit_digest(cap.state)
    crowd = {}
    if got.get("crowd") is not None:
        crowd = {"applied_label": got["crowd"].applied_label.cpu().numpy(),
                 "label_weight": got["crowd"].label_weight.cpu().numpy()}
    q = int(argv[argv.index("--acq-batch") + 1]) \
        if "--acq-batch" in argv else 1
    return extra | {
        "rc": rc, "stdout": out.getvalue(), "launches": launched,
        "split_launches": split,
        "ms_per_round": rounds / (iters * per),
        "ms_per_label": rounds / (iters * per * q),
        "rounds_ms": rounds,
        "init_ms": sum(t["init_ms"] for t in got["timings"]),
        "peak_gb": (torch.cuda.max_memory_allocated(dev) / 1e9
                    if dev.type == "cuda" else 0.0),
        "fingerprint": fingerprint(cap.state, got["n_local"]),
        "fingerprint_model": fingerprint(cap.state, got["h_local"]),
        "bytes_sent": sent,
        "bytes_per_round": {k: v / iters for k, v in
                            cap.round_bytes.items()},
        "arrays": {
            "chosen_idx": res.chosen_idx.cpu().numpy(),
            "true_class": res.true_class.cpu().numpy(),
            "best_model": res.best_model.cpu().numpy(),
            "regret": res.regret.cpu().numpy(),
            "cumulative_regret": res.cumulative_regret.cpu().numpy(),
            "select_prob": res.select_prob.cpu().numpy(),
            "scores": torch.stack(cap.scores).cpu().numpy()
            if cap.scores else np.zeros(0),
        } | crowd,
    }


def run_replays(root: str, data_dir: str, dev, names=None) -> dict:
    """The ``replay`` job: ``cli replay`` of every record under ``root``
    (``names``: of those jobs only) on this world's ranks (they join the
    record's mesh), after a barrier (rank 0 wrote the records)."""
    import torch.distributed as dist

    from coda_tpu_torch import cli

    if dist.is_initialized():
        dist.barrier()        # rank 0 has written every record
    out = {}
    for job in sorted(os.listdir(root)):
        if names is not None and job not in names:
            continue
        rec = os.path.join(root, job)
        if not os.path.isfile(os.path.join(rec, "record.json")):
            continue
        t0 = time.perf_counter()
        buf = io.StringIO()
        with contextlib.redirect_stdout(buf):
            rc = cli.main(["replay", rec, "--data-dir", data_dir,
                           "--device", dev.type, "--out",
                           os.path.join(root, f"replay_{job}.json")])
        out[job] = {"rc": rc, "wall_s": time.perf_counter() - t0,
                    "stdout": buf.getvalue()}
    return out


def prior_chunks(dev, mesh_spec) -> dict:
    """The ``prior_chunks`` job: the soft confusion prior of a seeded
    random task's block (``mesh_spec``'s, or the whole task unsharded),
    its data-group sum in chunks of one model against the sum whole."""
    import torch

    from coda_tpu_torch.ops import confusion
    from coda_tpu_torch.parallel.mesh import mesh_from_spec

    H, N, C = 64, 256, 100
    gen = torch.Generator().manual_seed(11)
    preds = torch.softmax(4 * torch.randn((H, N, C), generator=gen), -1)
    mesh = None if mesh_spec is None else mesh_from_spec(mesh_spec,
                                                         device=dev.type)
    if mesh is not None:
        n, h = N // mesh.data, H // mesh.model
        preds = preds[mesh.model_index * h:(mesh.model_index + 1) * h,
                      mesh.data_index * n:(mesh.data_index + 1) * n]
    preds = preds.contiguous().to(dev)
    labels = confusion.ensemble_preds(preds, mesh).argmax(-1)
    got = {}
    saved = confusion._PRIOR_CHUNK_BYTES
    for case, nbytes in (("whole", saved), ("per_model", 1)):
        confusion._PRIOR_CHUNK_BYTES = nbytes
        try:
            got[case] = confusion.create_confusion_matrices(
                labels, preds, mode="soft", mesh=mesh).cpu()
        finally:
            confusion._PRIOR_CHUNK_BYTES = saved
    return {"rc": 0, "bitwise": bool(torch.equal(got["whole"],
                                                  got["per_model"])),
            "launches": {}}


def suite_rows(db: str) -> list:
    """Every metric row of a suite's store: (run name, key, step, value)."""
    with sqlite3.connect(db) as con:
        return sorted(con.execute(
            "SELECT r.name, m.key, m.step, m.value FROM metrics m "
            "JOIN runs r ON r.run_uuid = m.run_uuid"))


@contextlib.contextmanager
def loaded_once():
    """``cli.load_dataset`` read once for a run of jobs on the same task
    (and mesh spec): the first loads its file (or its block of it), the
    next take the same tensors on their own call's mesh, and a job on
    another task drops them first (a job's peak memory holds its own task
    alone). The jobs run the CLI as a user would but for the reading of a
    file already read."""
    from coda_tpu_torch import cli

    load, cache = cli.load_dataset, {}

    def cached(args, mesh=None):
        key = (args.task, args.data_dir, args.synthetic, args.device,
               None if mesh is None else mesh.spec)
        if key not in cache:
            cache.clear()
            cache[key] = load(args) if mesh is None else load(args, mesh)
        ds = cache[key]
        return ds if mesh is None else dataclasses.replace(ds, mesh=mesh)

    cli.load_dataset = cached
    try:
        yield
    finally:
        cli.load_dataset = load
        cache.clear()


def run_jobs(jobs, data_dir: str, task: str, rounds: dict, dev, mesh_spec,
             pred_dir: str, suite_tasks: str, suite_db: str,
             log=print, root: str = ".", viz_task: str = "digits_h80",
             pool_task: str = "pool", replays=None,
             prefilter_n: int = 4096, crowd_spec: str = CROWD_SPEC) -> dict:
    """Every job in turn; ``mesh_spec`` None runs them unsharded. ``root``
    takes the jobs' records, checkpoints and tracking stores; the ``viz``
    job runs on ``viz_task`` of ``data_dir``, ``sparse_rec`` on
    ``pool_task``; ``replays``: the records the ``replay`` job replays
    (None: every one); ``prefilter_n``: the prefilter job's subset;
    ``crowd_spec``: the crowd jobs' ``--oracle-noise``. Each
    task is read once (:func:`loaded_once`)."""
    with loaded_once():
        return _run_jobs(jobs, data_dir, task, rounds, dev, mesh_spec,
                         pred_dir, suite_tasks, suite_db, log, root,
                         viz_task, pool_task, replays, prefilter_n,
                         crowd_spec)


def _run_jobs(jobs, data_dir, task, rounds, dev, mesh_spec, pred_dir,
              suite_tasks, suite_db, log, root, viz_task, pool_task,
              replays, prefilter_n, crowd_spec) -> dict:
    mesh = [] if mesh_spec is None else ["--mesh", mesh_spec]
    device = [] if dev.type == "cuda" else ["--device", "cpu"]
    out = {}
    for job in jobs:
        t0 = time.perf_counter()
        if job == "suite":
            buf = io.StringIO()
            reset_counts()
            with contextlib.redirect_stdout(buf):
                from coda_tpu_torch import cli

                cli.main(["suite", "--pred-dir", pred_dir, "--tasks",
                          suite_tasks, "--methods", "coda", "--seeds", "2",
                          "--iters", str(rounds["suite"]), "--db", suite_db,
                          "--force-rerun"] + device + mesh)
            out[job] = {"stdout": buf.getvalue(), "launches": counts(),
                        "split_launches": split_counts()}
        elif job == "replay":
            out[job] = {"records": run_replays(root, data_dir, dev,
                                               replays)}
        elif job == "prior_chunks":
            out[job] = prior_chunks(dev, mesh_spec)
        else:
            argv = job_argv(job, rounds, root, prefilter_n, crowd_spec)
            track = [] if job == "viz" else ["--no-mlflow"]
            on = {"viz": viz_task, "sparse_rec": pool_task}.get(job, task)
            out[job] = run_cli_job(["--task", on, "--data-dir", data_dir]
                                   + track + argv + device + mesh, dev)
        out[job]["wall_s"] = time.perf_counter() - t0
        log(f"  {job}: {out[job]['wall_s']:.1f} s")
    return out


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--data-dir", required=True)
    p.add_argument("--task", default="headline")
    p.add_argument("--out", required=True)
    p.add_argument("--jobs", default="main,batch,paper," + ",".join(BASELINES)
                   + ",suite")
    p.add_argument("--rounds", default="main=30,batch=10,paper=5,"
                   "baselines=20,suite=10,ckpt_cut=10,viz=10,sparse=20,"
                   "amort=10,prefilter=10,q4=10,surr=20,crowd=10,"
                   "crowd_batch=5")
    p.add_argument("--viz-task", default="digits_h80",
                   help="the viz job's task under --data-dir")
    p.add_argument("--pool-task", default="pool",
                   help="the sparse_rec job's task under --data-dir")
    p.add_argument("--replays", default=None,
                   help="the records the replay job replays (default all)")
    p.add_argument("--prefilter-n", type=int, default=4096,
                   help="the prefilter job's subset")
    p.add_argument("--crowd-spec", default=CROWD_SPEC,
                   help="the crowd jobs' --oracle-noise")
    p.add_argument("--pred-dir", default=os.path.join(ROOT, "data"))
    p.add_argument("--suite-tasks", default="pyfiles,iris")
    p.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    p.add_argument("--mesh", default=None, metavar="AXIS=K,...",
                   help="the mesh (default data=<ranks>)")
    p.add_argument("--unsharded", action="store_true",
                   help="run the jobs in this one process, unsharded")
    args = p.parse_args(argv)
    import numpy as np

    from coda_tpu_torch.parallel.distributed import initialize, shutdown
    from coda_tpu_torch.parallel.mesh import shard_device, world
    from coda_tpu_torch.utils.platform import pin_fp32_matmul

    pin_fp32_matmul()
    rounds = {k: int(v) for k, v in
              (kv.split("=") for kv in args.rounds.split(","))}
    spec = None
    if not args.unsharded:
        initialize(device=args.device)
        spec = args.mesh or f"data={world()[1]}"
    rank = world()[0]
    dev = shard_device(args.device)
    os.makedirs(args.out, exist_ok=True)
    t0 = time.perf_counter()
    try:
        res = run_jobs(args.jobs.split(","), args.data_dir, args.task,
                       rounds, dev, spec, args.pred_dir, args.suite_tasks,
                       os.path.join(args.out, f"suite{rank}.sqlite"),
                       log=print if rank == 0 else (lambda *a: None),
                       root=os.path.join(args.out, "records"),
                       viz_task=args.viz_task, pool_task=args.pool_task,
                       replays=(args.replays.split(",") if args.replays
                                else None), prefilter_n=args.prefilter_n,
                       crowd_spec=args.crowd_spec)
    finally:
        if spec is not None:
            shutdown()
    arrays = {f"{job}/{k}": v for job, r in res.items()
              for k, v in r.pop("arrays", {}).items()}
    np.savez(os.path.join(args.out, f"rank{rank}.npz"), **arrays)
    meta = {"rank": rank, "mesh": spec, "wall_s": time.perf_counter() - t0,
            "device": str(dev), "jobs": res}
    if rank == 0 and "suite" in res:
        meta["suite_rows"] = suite_rows(
            os.path.join(args.out, f"suite{rank}.sqlite"))
    with open(os.path.join(args.out, f"rank{rank}.json"), "w") as f:
        json.dump(meta, f, default=str)
    return 0


if __name__ == "__main__":
    sys.exit(main())
