#!/usr/bin/env python3
"""Where ``chip_smoke.py``'s time goes, for choosing what a new phase cuts.

    python scripts/torch_smoke_loops.py [--root DIR] [--out FILE.json]
    python scripts/torch_smoke_loops.py --phase demo

Without ``--phase`` it runs the whole smoke (``chip_smoke.main`` of the
checkout at ``--root``, default this one) with every call of its timing
helpers (``time_ms``, and ``_launch_parts`` where the checkout has it)
wrapped: the wall seconds of those calls summed by helper, calling
function and repeat count, written as JSON to ``--out`` (without it,
printed after the smoke's own output); the smoke's closing ``phase
seconds`` line, where the checkout has one, gives each phase's total. With
``--phase demo`` it builds the kernels and the headline task, then runs
the smoke's "demo" phase alone and prints its seconds. Needs a CUDA
device; to compare two checkouts, run it on each in one call.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _wrap_timers(cs, acc: dict) -> None:
    for helper in ("time_ms", "_launch_parts"):
        inner = getattr(cs, helper, None)
        if inner is None:
            continue

        def timed(fn, *args, _inner=inner, _helper=helper, **kw):
            caller = sys._getframe(1).f_code.co_name
            t0 = time.perf_counter()
            try:
                return _inner(fn, *args, **kw)
            finally:
                key = (f"{_helper}:{caller}:reps="
                       f"{kw.get('reps', args[0] if args else 'default')}"
                       f":warmup={kw.get('warmup', 'default')}")
                calls, secs = acc.get(key, (0, 0.0))
                acc[key] = (calls + 1, secs + time.perf_counter() - t0)

        setattr(cs, helper, timed)


def _demo_alone(cs) -> int:
    import torch

    from coda_tpu_torch.data import make_synthetic_task
    from coda_tpu_torch.ops import build
    from coda_tpu_torch.utils.platform import pin_fp32_matmul

    pin_fp32_matmul()
    dev = torch.device("cuda")
    smi = cs.smi_line()
    print(f"build: {build.build_all()['seconds']:.1f} s; {smi}", flush=True)
    C, N, H = cs.HEADLINE
    task = make_synthetic_task(0, H=H, N=N, C=C, device=dev)
    launches: dict = {}
    t0 = time.perf_counter()
    cs.phase_demo(dev, task, launches, smi)
    print(f"demo phase alone: {time.perf_counter() - t0:.1f} s, launches "
          f"{json.dumps(launches)}", flush=True)
    return 0


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--phase", choices=["demo"], default=None)
    p.add_argument("--root", default=ROOT,
                   help="the checkout whose chip_smoke.py runs")
    p.add_argument("--out", default=None, help="write the sums' JSON")
    args = p.parse_args(argv)
    out = None if args.out is None else os.path.abspath(args.out)
    root = os.path.abspath(args.root)
    sys.path.insert(0, root)
    os.chdir(root)
    import chip_smoke as cs

    if args.phase == "demo":
        return _demo_alone(cs)
    acc: dict = {}
    _wrap_timers(cs, acc)
    rc = cs.main()
    sums = {k: {"calls": n, "seconds": s} for k, (n, s) in sorted(acc.items())}
    if out is None:
        print(json.dumps(sums), flush=True)
    else:
        os.makedirs(os.path.dirname(out), exist_ok=True)
        with open(out, "w") as f:
            json.dump(sums, f, indent=1)
    return rc


if __name__ == "__main__":
    sys.exit(main())
