#!/usr/bin/env python3
"""Where a round's time goes on the GPU (coda_tpu_torch: CODA's main path
or a baseline).

    python scripts/torch_round_profile.py [--shape H,N,C] [--rounds 5]
        [--seeds S] [--eig-refresh precomputed|fused]
        [--eig-cache-dtype float32|bfloat16] [--eig-entropy exact|approx]
        [--eig-mode incremental|auto|factored|rowscan|direct]
        [--eig-precision highest|high|default] [--posterior dense|sparse:K]
        [--eig-pbest quad|amortized] [--pi-update auto|delta|exact]
        [--multiplier M] [--acq-batch Q] [--eig-scorer exact|surrogate:k]
        [--method coda|iid|uncertainty|activetesting|vma|model_picker]
        [--record-topk K] [--out profile.json]

Builds the synthetic task of ``--shape`` (default the headline 1000,50000,10)
on the card, builds CODA with the given numerics knobs (default: the
reference's precomputed refresh, fp32 cache, exact entropy), runs its init
twice (cold, then warm; host clock with the device synchronised) and two
warm-up rounds, then times ``--rounds`` rounds twice: on the host clock
with the device synchronised (ms/round), and under ``torch.profiler``
(device time per kernel, grouped into the port's CUDA kernels, matrix
products, and other PyTorch kernels; only device-side events are summed,
so an operator and the kernels it launched are not counted twice).
``--seeds S`` (S > 1) profiles one round of the seed-batched engine: S
replicas in one state, each round one pass for all of them (kernel 5,
the batched products, the batched kernel 3); ms/round is then the round
of all S seeds, and ms/seed-round that over S. ``--eig-mode`` (default
``incremental``, the tier every earlier profile ran) picks CODA's EIG
tier; off the incremental tier a third window of ``--rounds`` rounds
splits the round's device time, by CUDA events around each part's calls,
into the Beta tables, the three table products, the integrand and
normalisation between them, the entropy pass and the full pi-hat
recompute. ``--method`` profiles a baseline instead (one seed; ActiveTesting and VMA with a label buffer of
the rounds run, ModelPicker with the default epsilon); ``--record-topk K``
profiles the flight recorder's round (the same round with its top-K
scores and posterior digest kept on the device). ``--acq-batch Q``
profiles the round of Q labels (one scoring pass, Q answers as one
update); ``--eig-scorer surrogate:k`` the surrogate scorer's round (its
first 10 rounds are the full pass: profile with ``--rounds`` past them,
the two warm-up rounds included, to see a gated round).
Kernels on one stream do not overlap, so the device's busy share is the
summed kernel time over the profiled wall time. Prints a summary and, with
``--out``, writes the full table as JSON there. Needs a CUDA device;
prints the card's name and power limit beside the numbers.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))


def _group(name: str) -> str:
    n = name.lower()
    if "refresh_compute" in n:     # kernel 6's row and scoring launches
        return "kernel: eig_refresh_compute (csrc/eig_refresh_compute.cu)"
    if "score_kernel" in n:
        return "kernel: eig_score/refresh (csrc/eig_score.cu)"
    if "gather_kernel" in n:      # kernel 3's ring and 4-byte paths
        return "kernel: row_gather (csrc/row_gather.cu)"
    if "gemm" in n or "cutlass" in n or "xmma" in n or "matmul" in n:
        return "matrix products (cuBLAS fp32)"
    if "memcpy" in n or "memset" in n:
        return "copies"
    return "other PyTorch kernels"


# the parts of a recomputing tier's round, by the functions that run them:
# (part, module attribute); the products are called inside the integrand
# and are subtracted from it
_PARTS = (("Beta tables", "coda._beta_rows"), ("Beta tables",
                                               "coda.compute_pbest"),
          ("Beta tables", "coda.compute_pbest_rows"),
          ("Beta tables", "coda._bump_tables"),
          ("integrand and normalisation", "coda._pbest_hyp_from_tables"),
          ("three table products", "pbest.eig_matmul"),
          ("entropy pass", "coda._class_entropy_drop"),
          ("pi-hat recompute", "coda.update_pi_hat"))


def _split_parts(step, state, cum, keys, rounds: int) -> dict:
    """Device ms a round of each part in ``_PARTS``: CUDA events around
    every call of the part's function over ``keys``' rounds."""
    import torch

    from coda_tpu_torch.ops import pbest
    from coda_tpu_torch.selectors import coda

    mods = {"coda": coda, "pbest": pbest}
    pairs: list = []
    saved = []
    for part, path in _PARTS:
        mod_name, attr = path.split(".")
        mod = mods[mod_name]
        fn = getattr(mod, attr)
        saved.append((mod, attr, fn))

        def timed(*a, _fn=fn, _part=part, **k):
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            out = _fn(*a, **k)
            end.record()
            pairs.append((_part, start, end))
            return out
        setattr(mod, attr, timed)
    try:
        for k in keys:
            state, cum, _ = step(state, cum, k)
        torch.cuda.synchronize()
    finally:
        for mod, attr, fn in saved:
            setattr(mod, attr, fn)
    ms: dict = {}
    for part, start, end in pairs:
        ms[part] = ms.get(part, 0.0) + start.elapsed_time(end) / rounds
    if "integrand and normalisation" in ms:
        ms["integrand and normalisation"] -= ms.get("three table products",
                                                    0.0)
    return ms


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--shape", default="1000,50000,10")
    p.add_argument("--rounds", type=int, default=5)
    p.add_argument("--seeds", type=int, default=1,
                   help="replicas of the seed-batched engine (1: one seed)")
    p.add_argument("--eig-refresh", default="precomputed",
                   choices=["precomputed", "fused"])
    p.add_argument("--eig-cache-dtype", default="float32",
                   choices=["float32", "bfloat16"])
    p.add_argument("--eig-entropy", default="exact",
                   choices=["exact", "approx"])
    p.add_argument("--eig-mode", default="incremental",
                   choices=["incremental", "auto", "factored", "rowscan",
                            "direct"])
    p.add_argument("--eig-precision", default="highest",
                   choices=["highest", "high", "default"])
    p.add_argument("--posterior", default="dense")
    p.add_argument("--eig-pbest", default="quad",
                   choices=["quad", "amortized"])
    p.add_argument("--pi-update", default="auto",
                   choices=["auto", "delta", "exact"])
    p.add_argument("--acq-batch", type=int, default=1,
                   help="labels a round (q-wide select and update)")
    p.add_argument("--eig-scorer", default="exact")
    p.add_argument("--multiplier", type=float, default=2.0,
                   help="the prior's multiplier (20 engages the amortized "
                        "gate at the headline)")
    p.add_argument("--method", default="coda",
                   choices=["coda", "iid", "uncertainty", "activetesting",
                            "vma", "model_picker"])
    p.add_argument("--record-topk", type=int, default=0,
                   help="profile the recording round (0: unrecorded)")
    p.add_argument("--out", default=None,
                   help="also write the full table as JSON here")
    args = p.parse_args(argv)

    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    if not torch.cuda.is_available():
        print("needs a CUDA device", file=sys.stderr)
        return 2
    from coda_tpu_torch import random as trandom
    from coda_tpu_torch.data import make_synthetic_task
    from coda_tpu_torch.engine.loop import (
        batched_select_keys,
        make_batched_step_fn,
        make_step_fn,
    )
    from coda_tpu_torch.oracle import true_losses
    from coda_tpu_torch.selectors import (
        DEFAULT_EPS,
        SELECTOR_FACTORIES,
        CODAHyperparams,
        make_coda,
    )

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60).stdout.strip()
    H, N, C = (int(x) for x in args.shape.split(","))
    dev = torch.device("cuda")
    task = make_synthetic_task(0, H=H, N=N, C=C, device=dev)
    knobs = dict(eig_refresh=args.eig_refresh,
                 eig_cache_dtype=args.eig_cache_dtype,
                 eig_entropy=args.eig_entropy, eig_mode=args.eig_mode,
                 eig_precision=args.eig_precision, posterior=args.posterior,
                 eig_pbest=args.eig_pbest, pi_update=args.pi_update,
                 multiplier=args.multiplier, eig_scorer=args.eig_scorer)
    Q = args.acq_batch
    S = args.seeds
    n_keys = 2 + 3 * args.rounds
    if args.method == "coda":
        sel = make_coda(task.preds, CODAHyperparams(
            eig_chunk=1024, n_parallel=S, **knobs), device=dev)
        knobs["resolved_eig_mode"] = sel.extras["eig_mode"]
    else:
        if S > 1:
            p.error("the baselines have no seed-batched form: --seeds 1")
        knobs = {"method": args.method}
        kw = ({"budget": n_keys * Q}
              if args.method in ("activetesting", "vma")
              else {"epsilon": DEFAULT_EPS}
              if args.method == "model_picker" else {})
        sel = SELECTOR_FACTORIES[args.method](task.preds, device=dev, **kw)
    if args.record_topk:
        knobs["record_topk"] = args.record_topk
    if Q > 1:
        if S > 1:
            p.error("a q-wide round has no seed-batched form (the engine "
                    "runs its seeds one after another): --seeds 1")
        knobs["acq_batch"] = Q
    losses = true_losses(task.preds, task.labels)
    if S > 1:
        # the engine's per-seed schedule for seeds 0..S-1, on the device
        step = make_batched_step_fn(sel, task.labels, losses,
                                    trace_k=args.record_topk)
        keys = batched_select_keys(sel, torch.stack(
            [trandom.PRNGKey(s) for s in range(S)]), n_keys, dev)

        def init():
            return sel.batched.init(S)
    else:
        step = make_step_fn(sel, task.labels, losses,
                            trace_k=args.record_topk, acq_batch=Q)
        k_init, _, k_scan = trandom.split(trandom.PRNGKey(0), 3)
        keys = trandom.split(k_scan, n_keys)

        def init():
            return sel.init(k_init)
    init_ms = []
    for _ in range(2):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        state = init()
        torch.cuda.synchronize()
        init_ms.append((time.perf_counter() - t0) * 1e3)
    cum = torch.zeros(S if S > 1 else (), device=dev)
    for k in keys[:2]:
        state, cum, _ = step(state, cum, k)
    torch.cuda.synchronize()

    t0 = time.perf_counter()
    for k in keys[2:2 + args.rounds]:
        state, cum, _ = step(state, cum, k)
    torch.cuda.synchronize()
    round_ms = (time.perf_counter() - t0) * 1e3 / args.rounds

    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for k in keys[2 + args.rounds:2 + 2 * args.rounds]:
            state, cum, _ = step(state, cum, k)
        torch.cuda.synchronize()
        prof_wall_ms = (time.perf_counter() - t0) * 1e3
    parts = {}
    if args.method == "coda" and sel.extras["eig_mode"] != "incremental":
        parts = _split_parts(step, state, cum, keys[2 + 2 * args.rounds:],
                             args.rounds)
    rows = []
    for ev in prof.key_averages():
        # device-side events only: a CPU operator's "self device time" is
        # the time of the kernels it launched, which appear as rows too
        if ev.device_type != DeviceType.CUDA:
            continue
        dev_us = ev.self_device_time_total
        if dev_us > 0:
            rows.append({"name": ev.key, "count": ev.count,
                         "device_ms_per_round": dev_us / 1e3 / args.rounds})
    rows.sort(key=lambda r: -r["device_ms_per_round"])
    groups: dict = {}
    for r in rows:
        g = _group(r["name"])
        groups[g] = groups.get(g, 0.0) + r["device_ms_per_round"]
    device_ms = sum(groups.values())
    launches = sum(r["count"] for r in rows) / args.rounds
    busy = device_ms * args.rounds / prof_wall_ms if prof_wall_ms else 0.0
    summary = {
        "card": smi, "shape_HNC": [H, N, C], "rounds": args.rounds,
        "seeds": S, "knobs": knobs,
        "init_ms_cold": init_ms[0], "init_ms_warm": init_ms[1],
        "ms_per_round": round_ms, "ms_per_seed_round": round_ms / S,
        "device_launches_per_round": launches,
        "profiled_wall_ms_per_round": prof_wall_ms / args.rounds,
        "device_ms_per_round": device_ms, "device_busy_share": busy,
        # the profiler slows the host; this share is against the round
        # timed without it (the same kernels, another window)
        "device_share_of_unprofiled_round": device_ms / round_ms,
        "groups_ms_per_round": dict(sorted(groups.items(),
                                           key=lambda kv: -kv[1])),
        "parts_ms_per_round_by_events": parts,
        "top_ops": rows[:25],
    }
    if args.out:
        os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
        with open(args.out, "w") as f:
            json.dump(summary, f, indent=1)
    print(f"card: {smi}")
    print(f"knobs: {knobs}, seeds {S} "
          f"({'one batch' if S > 1 else 'one replica'})")
    print(f"shape (H, N, C) = ({H}, {N}, {C}): init {init_ms[0]:.1f} ms "
          f"cold, {init_ms[1]:.1f} ms warm; {round_ms:.3f} ms/round (host "
          f"clock, synchronised; {round_ms / S:.3f} ms/seed-round); "
          f"profiled device time {device_ms:.3f} "
          f"ms/round in {launches:.0f} device events, busy share "
          f"{busy:.3f} of the profiled wall, "
          f"{device_ms / round_ms:.3f} of the unprofiled round")
    for g, ms in summary["groups_ms_per_round"].items():
        print(f"  {g}: {ms:.3f} ms/round")
    for part, ms in parts.items():
        print(f"  part (CUDA events, another window): {part}: {ms:.3f} "
              "ms/round")
    for r in rows[:12]:
        print(f"  {r['device_ms_per_round']:8.3f} ms  x{r['count']:<4d} "
              f"{r['name'][:90]}")
    if not rows:
        print("  torch.profiler recorded no device time: not measured")
    return 0


if __name__ == "__main__":
    sys.exit(main())
