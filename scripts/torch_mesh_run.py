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
read just after. Rank r writes ``OUT/rank<r>.json`` and
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
  * ``suite``: ``cli suite`` over ``--suite-tasks`` of ``--pred-dir``.

It imports nothing of JAX or of the reference package.
"""

from __future__ import annotations

import argparse
import contextlib
import dataclasses
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


def job_argv(job: str, rounds: dict) -> list:
    """The CLI flags of a job (the task and mesh flags added by the
    caller); ``rounds`` maps a job to its rounds."""
    if job == "main":
        return ["--method", "coda", "--seeds", "1",
                "--iters", str(rounds["main"])]
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
    the device, copied once at the end), the last state, and the bytes
    the collectives sent inside the rounds' select, update and best
    calls (``parallel.collectives.traffic``, by axis)."""

    def __init__(self):
        self.scores: list = []
        self.state = None
        self.round_bytes: dict = {}

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
            self.state = sel.update(state, *args)
            return self.state

        inner = sel.batched
        batched = None
        if inner is not None:
            def bselect(state, keys):
                res = inner.select(state, keys)
                self.scores.append(res.scores.detach().clone())
                return res

            def bupdate(state, *args):
                self.state = inner.update(state, *args)
                return self.state

            batched = dataclasses.replace(
                inner, select=self._counted(bselect),
                update=self._counted(bupdate),
                best=self._counted(inner.best))
        return dataclasses.replace(sel, select=self._counted(select),
                                   update=self._counted(update),
                                   best=self._counted(sel.best),
                                   batched=batched)


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


def counts() -> dict:
    from coda_tpu_torch.ops import eig_kernels as ek
    from coda_tpu_torch.ops import gather_kernels as gk

    out = {k: v for k, v in ek.launch_counts.items() if v}
    out.update({k: v for k, v in gk.launch_counts.items() if v})
    return out


def reset_counts() -> None:
    from coda_tpu_torch.ops import eig_kernels as ek
    from coda_tpu_torch.ops import gather_kernels as gk

    for d in (ek.launch_counts, gk.launch_counts):
        for k in d:
            d[k] = 0


def _sync(dev) -> None:
    import torch

    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def run_cli_job(argv: list, dev) -> dict:
    """One ``cli.main(argv)`` with the factory wrapped (:class:`Capture`)
    and the experiment timed; the counters set to 0 just before and read
    just after, the device's peak memory reset and read."""
    import numpy as np
    import torch

    from coda_tpu_torch import cli
    from coda_tpu_torch.engine import run_seeds_compiled
    from coda_tpu_torch.parallel import collectives

    cap = Capture()
    got: dict = {}
    orig_factory, orig_run = cli.build_selector_factory, cli.run_all_seeds

    def build(args, task_name):
        f = orig_factory(args, task_name)
        return lambda preds, mesh=None: cap.wrap(f(preds, mesh=mesh))

    def run(args, factory, dataset, loss_fn, dev_):
        # the CLI's own call (no recorder, crowd or checkpoint), timed
        timings: list = []
        res = run_seeds_compiled(factory, dataset.preds, dataset.labels,
                                 iters=args.iters, seeds=args.seeds,
                                 loss_fn=loss_fn, device=dev_,
                                 timings=timings, cost_label=args.method,
                                 mesh=dataset.mesh)
        got.update(result=res, timings=timings,
                   h_local=dataset.preds.shape[0],
                   n_local=dataset.preds.shape[1])
        return res, None, None

    cli.build_selector_factory, cli.run_all_seeds = build, run
    if dev.type == "cuda":
        torch.cuda.reset_peak_memory_stats(dev)
    out = io.StringIO()
    try:
        _sync(dev)
        reset_counts()
        sent = dict(collectives.traffic)
        with contextlib.redirect_stdout(out):
            rc = cli.main(argv)
        _sync(dev)
        launched = counts()
        sent = {k: v - sent[k] for k, v in collectives.traffic.items()}
    finally:
        cli.build_selector_factory, cli.run_all_seeds = orig_factory, \
            orig_run
    res = got["result"]
    rounds = sum(t["rounds_ms"] for t in got["timings"])
    iters = res.chosen_idx.shape[1]
    # one timing a seed (seeds one after another), or the batch's one
    per = len(got["timings"])
    return {
        "rc": rc, "stdout": out.getvalue(), "launches": launched,
        "ms_per_round": rounds / (iters * per),
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
            "best_model": res.best_model.cpu().numpy(),
            "regret": res.regret.cpu().numpy(),
            "select_prob": res.select_prob.cpu().numpy(),
            "scores": torch.stack(cap.scores).cpu().numpy()
            if cap.scores else np.zeros(0),
        },
    }


def suite_rows(db: str) -> list:
    """Every metric row of a suite's store: (run name, key, step, value)."""
    with sqlite3.connect(db) as con:
        return sorted(con.execute(
            "SELECT r.name, m.key, m.step, m.value FROM metrics m "
            "JOIN runs r ON r.run_uuid = m.run_uuid"))


def run_jobs(jobs, data_dir: str, task: str, rounds: dict, dev, mesh_spec,
             pred_dir: str, suite_tasks: str, suite_db: str,
             log=print) -> dict:
    """Every job in turn; ``mesh_spec`` None runs them unsharded."""
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
            out[job] = {"stdout": buf.getvalue(), "launches": counts()}
        else:
            out[job] = run_cli_job(
                ["--task", task, "--data-dir", data_dir, "--no-mlflow"]
                + job_argv(job, rounds) + device + mesh, dev)
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
                   "baselines=20,suite=10")
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
                       log=print if rank == 0 else (lambda *a: None))
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
