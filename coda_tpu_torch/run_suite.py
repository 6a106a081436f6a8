"""The in-process sweep's command line: every task x method x seed in one
process on the card (the port's copy of ``scripts/run_suite.py``'s flags,
with ``--device`` in place of ``--platform``).

    python -m coda_tpu_torch.cli suite --pred-dir data --db coda.sqlite \\
        --methods iid,uncertainty,coda,activetesting,vma,model_picker \\
        --seeds 5 --iters 100
    python -m coda_tpu_torch.cli suite --pred-dir data --db coda.sqlite \\
        --task-batch --suite-devices 1 --device cpu

Results land in the tracking store (``--db``) in the reference's layout; a
rerun skips finished pairs unless ``--force-rerun``. ``--task-batch``
dispatches same-size tasks a (group, method) at a time
(``SuiteRunner.run_batched``); ``--suite-devices`` (which implies it)
hands the dispatches to the task-parallel scheduler. ``--telemetry-dir``
writes ``trace.json`` (a span a dispatch on its device's lane),
``telemetry.json`` and ``metrics.prom`` there and flushes the scalars into
the store. The last line printed is a JSON object with the sweep's wall
seconds.

``--mesh data=a,model=b`` shards each task over N and H, one process a
shard, under ``torchrun`` (``python -m torch.distributed.run
--nproc-per-node <a*b> -m coda_tpu_torch.cli suite ... --mesh
data=a,model=b``; either axis alone too): a task whose N the data axis,
or whose H the model axis, does not divide loads unsharded on every rank,
with the reference's warning. Rank 0 alone prints, writes the store and,
under ``--record-dir``, writes each pair's record (the mesh among its
knobs). ``--task-batch`` with ``--mesh`` is the reference's error.
"""

from __future__ import annotations

import argparse
import json
import os
import time

DEFAULT_METHODS = "iid,uncertainty,coda,activetesting,vma,model_picker"


def parse_args(argv=None):
    p = argparse.ArgumentParser(
        prog="coda_tpu_torch.cli suite",
        description="sweep tasks x methods x seeds in one process")
    p.add_argument("--pred-dir", default="data")
    p.add_argument("--db", default="coda.sqlite")
    p.add_argument("--methods", default=DEFAULT_METHODS)
    p.add_argument("--tasks", default=None,
                   help="comma-separated subset (default: all in --pred-dir)")
    p.add_argument("--seeds", type=int, default=5)
    p.add_argument("--iters", type=int, default=100)
    p.add_argument("--loss", default="acc")
    p.add_argument("--force-rerun", action="store_true")
    p.add_argument("--no-db", action="store_true")
    p.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    p.add_argument("--mesh", default=None, metavar="AXIS=K,...",
                   help="shard each task tensor over N (data) and H "
                        "(model), one process a shard (torchrun); tasks "
                        "whose N or H does not divide its axis load "
                        "unsharded with a warning. Incompatible with "
                        "--task-batch.")
    p.add_argument("--task-batch", action="store_true",
                   help="dispatch same-size tasks a (group, method) at a "
                        "time (SuiteRunner.run_batched); groups by file "
                        "size, a size shared across shapes fails at "
                        "dispatch")
    p.add_argument("--suite-devices", default=None, metavar="auto|N",
                   help="with --task-batch (implied): schedule the "
                        "dispatches across this many devices ('auto' = "
                        "every visible CUDA device; on --device cpu, N "
                        "names the CPU N times)")
    p.add_argument("--suite-hosts", type=int, default=None, metavar="H",
                   help="with --suite-devices: two-level placement, chunks "
                        "to H host groups by weighted LPT, then to their "
                        "devices")
    p.add_argument("--schedule", default="lpt", choices=["lpt", "fifo"],
                   help="with --suite-devices: dispatch order")
    p.add_argument("--cost-profile", default=None, metavar="BENCH.json",
                   help="with --suite-devices: JSON with per_family_warm_s"
                        "/per_method_warm_s to seed the LPT costs")
    p.add_argument("--telemetry-dir", default=None,
                   help="write trace.json (a span a dispatch on its "
                        "device's lane), telemetry.json (kernel builds and "
                        "launches, device memory, the cost book) and "
                        "metrics.prom there; the scalars also flush into "
                        "--db")
    p.add_argument("--record-dir", default=None,
                   help="write each pair's seed-0 probe as a flight-"
                        "recorder record under <dir>/<family>__<method>/"
                        "<task>/ (replay: python -m coda_tpu_torch.cli "
                        "replay)")
    p.add_argument("--record-topk", type=int, default=8,
                   help="top-k scores recorded a round (--record-dir)")
    args = p.parse_args(argv)
    if args.suite_devices is not None:
        args.task_batch = True   # scheduling runs through run_batched
    if args.task_batch and args.mesh:
        p.error("--task-batch is per-device (the task axis would need its "
                "own mesh dimension); drop one of the flags")
    return args


def main(argv=None) -> int:
    args = parse_args(argv)
    if not args.mesh:
        return _main(args, None)
    import torch.distributed as dist

    from coda_tpu_torch.parallel.distributed import initialize, shutdown
    from coda_tpu_torch.parallel.mesh import mesh_from_spec

    joined = not dist.is_initialized()
    initialize(device=args.device)
    try:
        return _main(args, mesh_from_spec(args.mesh, device=args.device))
    finally:
        if joined:
            shutdown()


def _main(args, mesh) -> int:
    """The sweep, on ``mesh`` (each task's block) or alone."""
    from coda_tpu_torch.data import Dataset, find_task_file, list_tasks
    from coda_tpu_torch.engine.suite import SuiteRunner
    from coda_tpu_torch.tracking import TrackingStore
    from coda_tpu_torch.utils.platform import resolve_device

    primary = mesh is None or mesh.rank == 0
    dev = mesh.device if mesh is not None else resolve_device(args.device)
    tasks = (args.tasks.split(",") if args.tasks
             else list_tasks(args.pred_dir))
    if not tasks:
        raise SystemExit(f"no tasks under {args.pred_dir}")
    # tasks ordered by file size (a shape proxy), loaded one at a time
    paths = []
    for t in tasks:
        fp = find_task_file(args.pred_dir, t)
        if fp is None:
            raise SystemExit(f"no data file for task {t!r}")
        paths.append((os.path.getsize(fp), fp, t))

    def loader(fp, t):
        return lambda: Dataset.from_file(fp, name=t, device=dev, mesh=mesh,
                                         unsharded_fallback=True)

    methods = args.methods.split(",")
    telemetry = None
    if args.telemetry_dir:
        from coda_tpu_torch.telemetry import Telemetry

        telemetry = Telemetry(out_dir=args.telemetry_dir)
    store = None if args.no_db or not primary else TrackingStore(args.db)
    runner = SuiteRunner(iters=args.iters, seeds=args.seeds, loss=args.loss,
                         telemetry=telemetry, record_dir=args.record_dir,
                         record_topk=args.record_topk, device=dev, mesh=mesh)
    progress = print if primary else (lambda *a, **k: None)
    t0 = time.perf_counter()
    if args.task_batch:
        groups: dict = {}
        for size, fp, t in sorted(paths):
            groups.setdefault(size, []).append(loader(fp, t))
        cost_profile = None
        if args.cost_profile:
            with open(args.cost_profile) as f:
                cost_profile = json.load(f)
        results = runner.run_batched(
            list(groups.values()), methods, store=store,
            force_rerun=args.force_rerun, devices=args.suite_devices,
            schedule=args.schedule, cost_profile=cost_profile,
            hosts=args.suite_hosts)
    else:
        results = runner.run([loader(fp, t) for _, fp, t in sorted(paths)],
                             methods, store=store,
                             force_rerun=args.force_rerun, progress=progress)
    wall = time.perf_counter() - t0
    if not primary:
        return 0
    stats = getattr(runner, "last_stats", {})
    line = {"metric": "suite-wall-clock", "tasks": len(paths),
            "methods": len(methods), "seeds": args.seeds,
            "iters": args.iters, "pairs_run": len(results),
            "value": round(wall, 2), "unit": "seconds",
            "device": str(dev)}
    if mesh is not None:
        line["mesh"] = mesh.spec
    if args.suite_devices is not None:
        line["n_devices"] = stats.get("n_devices")
        line["schedule"] = stats.get("schedule")
        line["occupancy"] = stats.get("occupancy")
        line["compute_s"] = round(stats.get("compute_s", 0.0), 2)
        line["compute_device_s"] = round(
            stats.get("compute_device_s", 0.0), 2)
    if args.record_dir:
        line["record_dir"] = args.record_dir
    if telemetry is not None:
        paths = telemetry.write(extra={"suite": {
            k: stats.get(k) for k in ("total_s", "compute_s",
                                      "compute_device_s", "n_devices",
                                      "schedule", "occupancy")
            if k in stats}})
        if store is not None:
            telemetry.flush_to_store(store, experiment="suite",
                                     run_name="suite-telemetry")
        line["telemetry"] = paths.get("telemetry")
    if store is not None:
        store.close()
    print(json.dumps(line))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
