"""Where a replica's dispatch time goes when several replicas share one
card: the same 12 headline slots served as 1 replica x 12 and as
3 replicas x 4, 12 closed-loop clients labeling through the router.

Each configuration is a fleet of ``cli serve`` arguments (tiering and
quality on, ``--eig-mode incremental``) built by ``build_fleet``:

  ================  =====================================================
  1x12              one replica, its batcher on the default stream
  3x4               three replicas in this process, every batcher on the
                    shared default stream (what ``build_fleet`` runs)
  3x4-hashed        as 3x4, but each session stays where the rendezvous
                    hash puts it: 12 sessions seldom split 4/4/4, and a
                    replica with more sessions than slots pages them
                    through its tiers (the placement of the smoke's
                    scaling step)
  3x4-streams       three replicas in this process, each batcher thread
                    dispatching under a CUDA stream of its own; every
                    session's stream is then replayed from init in a
                    fresh slot (``verify_session_stream``): the streams
                    may change no bit of any row
  3x4-processes     three ``cli serve`` processes (one interpreter each)
                    behind ``HttpReplica`` handles, the router here
  ================  =====================================================

Apart from 3x4-hashed, sessions are opened until every replica holds as
many as it has slots (a session opened on a full replica is closed
again), so no replica pages.

The two in-process 3x4 kinds run twice each, in the order default,
streams, streams, default, so a drift over the run shows. For every
in-process configuration the script reports labels a second and label
p50/p99 over the timed window, the tiers' demotions and wakes in it, and
for each replica's batcher, per dispatch: its wall ms, the CPU ms of its
own thread (``time.thread_time``) and the requests it served. A second,
shorter window counts the host synchronizations each dispatch makes (``torch.cuda.set_sync_debug_mode``,
one warning per synchronizing call, tallied by the replica whose batcher
made it), and a profiled second gives the device's busy share (the union
of its kernel and copy intervals). The batcher threads' stacks are
sampled through the timed window; the most frequent are kept.

    python scripts/torch_fleet_scaling.py [--device cuda]
        [--synthetic 1000,50000,10] [--seconds 8] [--out results.json]

On the CPU (``--device cpu``, a small ``--synthetic``) it rehearses every
part but the sync count, the profile and the processes.
"""

from __future__ import annotations

import argparse
import collections
import gc
import json
import os
import shutil
import signal
import socket
import statistics
import subprocess
import sys
import tempfile
import threading
import time
import traceback
import urllib.request
import uuid
import warnings

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SLOTS = 12
REPLICAS = 3


def fleet_argv(shape: str, cap: int, tmp: str, device: str) -> list:
    return ["--synthetic", shape, "--capacity", str(cap),
            "--record-dir", os.path.join(tmp, "rec"),
            "--tier-spill-dir", os.path.join(tmp, "spill"),
            "--idle-warm-s", "3600", "--idle-cold-s", "3600",
            "--eig-mode", "incremental", "--device", device]


class Clients:
    """One closed-loop client thread a session: label the proposed item
    with its true label, again and again (one request id a label, retried
    while a replica's slab is full); the router call's ms kept."""

    def __init__(self, router, cur: dict, labels):
        self.router, self.cur, self.labels = router, cur, labels
        self.ms: list = []
        self.errors: list = []
        self.stop = threading.Event()
        self.threads = [threading.Thread(target=self._run, args=(s,),
                                         daemon=True) for s in cur]

    def _run(self, sid) -> None:
        from coda_tpu_torch.serve.state import SlabFull

        try:
            while not self.stop.is_set():
                t0 = time.perf_counter()
                rid = uuid.uuid4().hex
                while True:
                    try:
                        o = self.router.label(
                            sid, int(self.labels[self.cur[sid]["idx"]]),
                            request_id=rid)
                        break
                    except SlabFull:
                        if time.perf_counter() - t0 > 300:
                            raise
                        time.sleep(0.02)
                self.ms.append((time.perf_counter() - t0) * 1e3)
                self.cur[sid] = o
        except BaseException as e:
            self.errors.append(e)

    def __enter__(self):
        for t in self.threads:
            t.start()
        return self

    def __exit__(self, *exc):
        self.stop.set()
        for t in self.threads:
            t.join()
        if self.errors and exc[0] is None:
            raise self.errors[0]


def pct(xs, q):
    xs = sorted(xs)
    return xs[min(len(xs) - 1, int(q * len(xs)))] if xs else None


def instrument(apps: dict) -> dict:
    """Wrap each replica's ``Batcher._dispatch``: per dispatch its wall
    seconds, its thread's CPU seconds and its requests; ``rid`` on a
    thread-local while it runs (the sync counter's key)."""
    local = threading.local()
    acc = {rid: {"n": 0, "wall": 0.0, "cpu": 0.0, "req": 0, "on": False,
                 "all": 0} for rid in apps}

    for rid, app in apps.items():
        orig = app.batcher._dispatch

        def wrapped(batch, orig=orig, rid=rid):
            t0, c0 = time.perf_counter(), time.thread_time()
            local.rid = rid
            try:
                orig(batch)
            finally:
                local.rid = None
                a = acc[rid]
                a["all"] += 1
                if a["on"]:
                    a["n"] += 1
                    a["wall"] += time.perf_counter() - t0
                    a["cpu"] += time.thread_time() - c0
                    a["req"] += len(batch)

        app.batcher._dispatch = wrapped
    return {"acc": acc, "local": local}


def per_stream(apps: dict, torch) -> None:
    """Each batcher thread dispatches under a CUDA stream of its own (the
    current stream is per thread)."""
    for app in apps.values():
        orig = app.batcher._loop
        stream = torch.cuda.Stream()

        def loop(orig=orig, stream=stream):
            with torch.cuda.stream(stream):
                orig()

        app.batcher._loop = loop


def sample_stacks(stop: threading.Event, out: collections.Counter) -> None:
    while not stop.is_set():
        frames = sys._current_frames()
        for th in threading.enumerate():
            if th.name == "serve-batcher" and th.ident in frames:
                st = traceback.extract_stack(frames[th.ident])[-3:]
                out[" <- ".join(f"{os.path.basename(f.filename)}:{f.lineno}"
                                f" {f.name}" for f in reversed(st))] += 1
        stop.wait(0.005)


def busy_share(torch, seconds: float = 1.0) -> dict:
    """The device's busy share of a profiled window: the union of its
    kernel and copy intervals over the window's wall time."""
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        time.sleep(seconds)
        torch.cuda.synchronize()
    spans = sorted((e.time_range.start, e.time_range.end)
                   for e in prof.events()
                   if e.device_type == torch.autograd.DeviceType.CUDA)
    busy, end = 0.0, None
    for a, b in spans:
        if end is None or a > end:
            busy += b - a
            end = b
        elif b > end:
            busy += b - end
            end = b
    return {"busy": busy / 1e6 / seconds, "events": len(spans)}


def count_syncs(torch, inst: dict, seconds: float) -> dict:
    """Synchronizing CUDA calls a dispatch makes, by replica, over a
    window (one warning per call under ``set_sync_debug_mode``), and the
    Python lines that make them, most frequent first."""
    counts, sites = collections.Counter(), collections.Counter()
    local = inst["local"]

    def tally(message, category, filename, lineno, *a, **k):
        rid = getattr(local, "rid", None)
        if rid is not None and "synchroniz" in str(message):
            counts[rid] += 1
            sites[f"{os.path.relpath(filename, HERE)}:{lineno}"] += 1

    acc = inst["acc"]
    n0 = {rid: a["all"] for rid, a in acc.items()}
    with warnings.catch_warnings():
        warnings.simplefilter("always")
        warnings.showwarning = tally
        torch.cuda.set_sync_debug_mode("warn")
        try:
            time.sleep(seconds)
        finally:
            torch.cuda.set_sync_debug_mode(0)
    n = sum(a["all"] - n0[rid] for rid, a in acc.items())
    return {"per_dispatch": {rid: counts[rid] / max(1, acc[rid]["all"]
                                                    - n0[rid])
                             for rid in acc},
            "sites_per_dispatch": [(site, k / max(1, n))
                                   for site, k in sites.most_common(12)]}


def open_sessions(router, cap: int, balanced: bool) -> dict:
    """12 sessions (seeds 100 on), each where the rendezvous hash puts
    it; ``balanced`` closes one opened on a replica that already holds
    ``cap`` and opens another, until every replica holds ``cap``."""
    cur, held = {}, collections.Counter()
    seed = 100
    while len(cur) < SLOTS:
        o = router.open_session(seed=seed)
        seed += 1
        rid = router._locate(o["session"])
        if balanced and held[rid] >= cap:
            router.close_session(o["session"])
            continue
        held[rid] += 1
        cur[o["session"]] = o
    return cur


def tier_events(apps: dict) -> int:
    return sum(a.metrics.demotions + a.metrics.wakes for a in apps.values())


def run_inproc(kind: str, n_rep: int, task, labels, shape: str,
               device: str, seconds: float) -> dict:
    import torch

    from coda_tpu_torch.serve import build_fleet
    from coda_tpu_torch.serve.recovery import (data_rows,
                                               load_session_stream,
                                               verify_session_stream)
    from coda_tpu_torch.serve.server import parse_args
    from coda_tpu_torch.serve.state import SessionStore

    cuda = device == "cuda"
    cap = SLOTS // n_rep
    tmp = tempfile.mkdtemp(prefix="scale_")
    fleet = build_fleet(parse_args(fleet_argv(shape, cap, tmp, device)),
                        n_rep, dataset=task)
    streams = kind.endswith("streams")
    if streams:
        per_stream(fleet.apps, torch)
    inst = instrument(fleet.apps)
    fleet.start(warm=True)
    r = fleet.router
    res: dict = {"config": kind, "replicas": n_rep, "slots": cap}
    try:
        for rid, app in fleet.apps.items():
            h = app.healthz()
            if h["status"] != "ok":
                raise RuntimeError(f"{kind}: replica {rid} {h}")
        cur = open_sessions(r, cap, balanced=kind != "3x4-hashed")
        res["sessions"] = dict(collections.Counter(
            r._locate(s) for s in cur))
        if cuda:
            torch.cuda.synchronize()
        with Clients(r, cur, labels) as c:
            time.sleep(1.0)                       # into the steady state
            for a in inst["acc"].values():
                a["on"] = True
            stacks: collections.Counter = collections.Counter()
            stop = threading.Event()
            sampler = threading.Thread(target=sample_stacks,
                                       args=(stop, stacks), daemon=True)
            n0, t0, p0 = len(c.ms), time.perf_counter(), time.process_time()
            e0 = tier_events(fleet.apps)
            sampler.start()
            time.sleep(seconds)
            stop.set()
            sampler.join()
            wall = time.perf_counter() - t0
            cpu = time.process_time() - p0
            ms = c.ms[n0:]
            res["tier_events"] = tier_events(fleet.apps) - e0
            for a in inst["acc"].values():
                a["on"] = False
            if cuda:
                syncs = count_syncs(torch, inst, 2.0)
                res["syncs_per_dispatch"] = syncs["per_dispatch"]
                res["sync_sites"] = syncs["sites_per_dispatch"]
                res.update(busy_share(torch))
        res.update({
            "labels_per_s": len(ms) / wall, "labels": len(ms),
            "p50_ms": statistics.median(ms) if ms else None,
            "p99_ms": pct(ms, 0.99), "window_s": wall,
            "process_cpu_per_wall": cpu / wall,
            "dispatch": {rid: {
                "n": a["n"], "wall_ms": a["wall"] / max(1, a["n"]) * 1e3,
                "thread_cpu_ms": a["cpu"] / max(1, a["n"]) * 1e3,
                "cpu_share": a["cpu"] / a["wall"] if a["wall"] else None,
                "requests": a["req"] / max(1, a["n"])}
                for rid, a in inst["acc"].items()},
            "stacks": stacks.most_common(8)})
        if streams:
            # every row the streams produced replays bitwise from init
            where = {s: r._locate(s) for s in cur}
            ref = SessionStore(capacity=1, device=device)
            ref.register_task(task.name, task.preds)
            n = 0
            for sid, rid in where.items():
                meta, rows, _ = load_session_stream(os.path.join(
                    tmp, "rec", rid, f"session_{sid}.jsonl"))
                rows = data_rows(rows)
                verify_session_stream(ref, meta, rows, sid=sid)
                n += len(rows)
            res["rows_verified"] = n
            del ref
    finally:
        fleet.close(timeout=60)
        del fleet, r
        gc.collect()
        if cuda:
            torch.cuda.empty_cache()
        shutil.rmtree(tmp, ignore_errors=True)
    return res


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _healthy(port: int) -> bool:
    try:
        with urllib.request.urlopen(f"http://127.0.0.1:{port}/healthz",
                                    timeout=5) as resp:
            return resp.status == 200 and \
                json.loads(resp.read())["status"] == "ok"
    except OSError:
        return False


def run_processes(labels, shape: str, device: str, seconds: float,
                  build_dir: str) -> dict:
    """3 x 4 as three ``cli serve`` processes behind ``HttpReplica``."""
    from coda_tpu_torch.serve import HttpReplica, SessionRouter

    tmp = tempfile.mkdtemp(prefix="scale_proc_")
    procs, ports = [], {}
    router = None
    cap = SLOTS // REPLICAS
    try:
        for i in range(REPLICAS):
            rid, port = f"p{i}", _free_port()
            procs.append(subprocess.Popen(
                [sys.executable, "-m", "coda_tpu_torch.cli", "serve",
                 *fleet_argv(shape, cap, os.path.join(tmp, rid), device),
                 "--port", str(port), "--compilation-cache-dir", build_dir],
                cwd=HERE, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                text=True))
            ports[rid] = port
        t0 = time.perf_counter()
        for p, port in zip(procs, ports.values()):
            while not _healthy(port):
                if p.poll() is not None:
                    raise RuntimeError(f"cli serve exited {p.returncode}: "
                                       f"{p.stdout.read()[-2000:]}")
                if time.perf_counter() - t0 > 600:
                    raise RuntimeError("cli serve never became ready")
                time.sleep(0.2)
        router = SessionRouter({rid: HttpReplica(
            rid, f"http://127.0.0.1:{port}") for rid, port in ports.items()})
        cur = open_sessions(router, cap, balanced=True)
        with Clients(router, cur, labels) as c:
            time.sleep(1.0)
            n0, t1 = len(c.ms), time.perf_counter()
            time.sleep(seconds)
            wall = time.perf_counter() - t1
            ms = c.ms[n0:]
        steps = {rid: h.stats()["step_latency"].get("p50_ms")
                 for rid, h in router.replicas.items()}
        return {"config": "3x4-processes", "replicas": REPLICAS,
                "slots": cap, "labels_per_s": len(ms) / wall,
                "labels": len(ms), "p50_ms": statistics.median(ms),
                "p99_ms": pct(ms, 0.99), "window_s": wall,
                "step_p50_ms": steps}
    finally:
        if router is not None:
            router.drain()
        for p in procs:
            if p.poll() is None:
                p.send_signal(signal.SIGTERM)
                try:
                    p.communicate(timeout=120)
                except subprocess.TimeoutExpired:
                    p.kill()
                    p.communicate()
        shutil.rmtree(tmp, ignore_errors=True)


def summary(res: dict) -> str:
    line = (f"{res['config']}: {res['labels_per_s']:.1f} labels a second "
            f"({res['labels']} in {res['window_s']:.1f} s), p50 "
            f"{res['p50_ms']:.1f} ms, p99 {res['p99_ms']:.1f} ms")
    if "tier_events" in res:
        line += (f"; sessions {res['sessions']}, {res['tier_events']} "
                 "demotions and wakes")
    if "dispatch" in res:
        line += (f"; process CPU {res['process_cpu_per_wall']:.2f} cores; "
                 "per dispatch (wall ms, own-thread CPU ms, requests"
                 + (", syncs" if "syncs_per_dispatch" in res else "") + "): "
                 + ", ".join(
                     f"{rid} ({d['wall_ms']:.1f}, {d['thread_cpu_ms']:.1f}, "
                     f"{d['requests']:.2f}"
                     + (f", {res['syncs_per_dispatch'][rid]:.1f}"
                        if "syncs_per_dispatch" in res else "") + ")"
                     for rid, d in res["dispatch"].items()))
    if "busy" in res:
        line += (f"; device busy {res['busy']:.3f} of a profiled second "
                 f"({res['events']} events)")
    if "rows_verified" in res:
        line += f"; {res['rows_verified']} rows replayed bitwise"
    if "step_p50_ms" in res:
        line += f"; replica step p50 ms {res['step_p50_ms']}"
    return line


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    p.add_argument("--synthetic", default="1000,50000,10", metavar="H,N,C")
    p.add_argument("--seconds", type=float, default=8.0)
    p.add_argument("--out", default=None, help="write the results JSON")
    args = p.parse_args(argv)
    sys.path.insert(0, HERE)
    import torch

    from coda_tpu_torch.data import make_synthetic_task
    from coda_tpu_torch.ops import build

    cuda = args.device == "cuda"
    if cuda and not torch.cuda.is_available():
        print("torch_fleet_scaling: no CUDA device", file=sys.stderr)
        return 2
    build_dir = tempfile.mkdtemp(prefix="scale_build_")
    out = {}
    if cuda:
        from coda_tpu_torch.utils.platform import pin_fp32_matmul

        pin_fp32_matmul()
        build.set_build_dir(build_dir)
        build.build_all()
        smi = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True)
        out["card"] = smi.stdout.strip()
        print(f"card: {out['card']}", flush=True)
    H, N, C = (int(x) for x in args.synthetic.split(","))
    task = make_synthetic_task(seed=0, H=H, N=N, C=C,
                               name=f"synthetic_{H}x{N}x{C}",
                               device=args.device)
    labels = task.labels.cpu().numpy()
    runs = []
    plan = [("1x12", 1), ("3x4", REPLICAS), ("3x4-streams", REPLICAS),
            ("3x4-streams", REPLICAS), ("3x4", REPLICAS),
            ("3x4-hashed", REPLICAS)]
    try:
        for kind, n_rep in plan:
            if kind.endswith("streams") and not cuda:
                continue
            res = run_inproc(kind, n_rep, task, labels, args.synthetic,
                             args.device, args.seconds)
            runs.append(res)
            print(summary(res), flush=True)
            print("  stacks: " + "; ".join(f"{n} x {s}"
                                           for s, n in res["stacks"][:3]),
                  flush=True)
            if "sync_sites" in res:
                print("  syncs a dispatch by line: " + ", ".join(
                    f"{site} {k:.1f}" for site, k in res["sync_sites"]),
                    flush=True)
        if cuda:
            del task
            gc.collect()
            torch.cuda.empty_cache()
            res = run_processes(labels, args.synthetic, args.device,
                                args.seconds, build_dir)
            runs.append(res)
            print(summary(res), flush=True)
    finally:
        shutil.rmtree(build_dir, ignore_errors=True)
    out["runs"] = runs
    if args.out:
        os.makedirs(os.path.dirname(os.path.abspath(args.out)),
                    exist_ok=True)
        with open(args.out, "w") as f:
            json.dump(out, f, indent=1)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
