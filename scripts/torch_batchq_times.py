#!/usr/bin/env python3
"""Host-clock times and peak device memory of the headline's q-wide CODA
runs, for one checkout of the port.

    python scripts/torch_batchq_times.py [--root DIR] [--shape H,N,C]
        [--refresh-temp-gib G]

Imports ``coda_tpu_torch`` from ``--root`` (default: this checkout), so
two checkouts can be timed in one call on the same card, in turns (parent,
change, change, parent). At ``make_synthetic_task(0, H, N, C)`` (default
the headline, 1000,50000,10), after an untimed q = 1 run that pays the
process's first-use costs, it runs, each with the card's peak memory
reset just before: one seed at q = 1 (20 rounds), q = 4 (20) and q = 8
(10), and 5 seeds at q = 4 (5 rounds, ``eig_mode='incremental'``; the
engine decides whether they run as one batch). ``--refresh-temp-gib``
sets the q-wide row refresh's temporary budget
(``selectors.coda._REFRESH_TEMP_BYTES``) for the process. Prints one
JSON line: the card's name and power limit, and per run the ms a round
(all seeds' rounds summed), a label and a seed-label, the peak GB, and a
digest of the chosen items (equal digests: the same decisions). Needs a
CUDA device.
"""

from __future__ import annotations

import argparse
import hashlib
import json
import os
import subprocess
import sys

RUNS = ((1, 1, 20), (4, 1, 20), (8, 1, 10), (4, 5, 5))   # (q, seeds, rounds)


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--root", default=os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))))
    p.add_argument("--shape", default="1000,50000,10", help="H,N,C")
    p.add_argument("--refresh-temp-gib", type=float, default=None)
    args = p.parse_args(argv)
    root = os.path.abspath(args.root)
    sys.path.insert(0, root)

    import torch

    if not torch.cuda.is_available():
        print("needs a CUDA device", file=sys.stderr)
        return 2
    from coda_tpu_torch.data import make_synthetic_task
    from coda_tpu_torch.engine import run_seeds_compiled
    from coda_tpu_torch.selectors import CODAHyperparams, make_coda
    from coda_tpu_torch.selectors import coda as coda_mod

    if args.refresh_temp_gib is not None:
        coda_mod._REFRESH_TEMP_BYTES = int(args.refresh_temp_gib * 2**30)

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60).stdout.strip()
    H, N, C = (int(x) for x in args.shape.split(","))
    dev = torch.device("cuda")
    task = make_synthetic_task(0, H=H, N=N, C=C, device=dev)
    out = {"card": smi, "root": root, "shape_HNC": [H, N, C],
           "refresh_temp_gib": args.refresh_temp_gib, "runs": []}
    run_seeds_compiled(lambda pr: make_coda(pr, CODAHyperparams(
        eig_chunk=1024), device=dev), task.preds, task.labels, iters=5,
        seeds=1, device=dev)
    for q, seeds, rounds in RUNS:
        knobs = dict(eig_chunk=1024, n_parallel=seeds)
        if seeds > 1:
            knobs["eig_mode"] = "incremental"
        hp = CODAHyperparams(**knobs)
        timings: list = []
        torch.cuda.synchronize()
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        res = run_seeds_compiled(
            lambda pr: make_coda(pr, hp, device=dev), task.preds,
            task.labels, iters=rounds, seeds=seeds, device=dev,
            timings=timings, acq_batch=q)
        torch.cuda.synchronize()
        peak = torch.cuda.max_memory_allocated() / 1e9
        ms = sum(t["rounds_ms"] for t in timings) / rounds
        idx = res.chosen_idx.cpu().numpy().astype("int64")
        out["runs"].append({
            "q": q, "seeds": seeds, "rounds": rounds,
            "one_batch": len(timings) == 1 and seeds > 1,
            "ms_per_round": ms, "ms_per_label": ms / q,
            "ms_per_seed_label": ms / (q * seeds), "peak_mem_gb": peak,
            "chosen_digest": hashlib.sha256(idx.tobytes()).hexdigest()[:16],
            "seed0_chosen_digest": hashlib.sha256(
                idx[0].tobytes()).hexdigest()[:16]})
        del res
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    sys.exit(main())
