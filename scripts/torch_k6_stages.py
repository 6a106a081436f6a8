#!/usr/bin/env python3
"""Where kernel 6's time goes, stage by stage and launch by launch, on the GPU.

    python scripts/torch_k6_stages.py [--shape H,N,C] [--num-points 256]
        [--paths single,rule] [--warpgroups 2,1]

Builds ``coda_tpu_torch/csrc/eig_refresh_compute.cu`` (the fused
refresh-compute-score kernel) a second time with ``-DK6_STAGES`` into the
git-ignored ``coda_tpu_torch/_build/``: thread 0 of every block of its
persistent row launch then adds up the ``clock64()`` cycles of each of the
block's three stages (loading the tile's w and eq mask, the MMA
warpgroups' base and diff products, the epilogue; the last two summed over
the model chunks) over all its work items, and, apart, the cycles the
consumers spent waiting for full product stages and those the producer
warp spent waiting for free slots. That build is launched through the
port's own wrapper on random inputs of ``--shape`` (default the headline
1000,50000,10), fp32 and bf16 cache, at each consumer warpgroup count of
``--warpgroups`` (default: the rule's; two are cut to one where they do
not fit), on each of ``--paths``: ``single`` (one scoring launch after the
row launch: ``class_chunks=1, row_split=False``) and ``rule`` (the
decompositions the wrapper's rules pick). For each the script prints the mean
SM cycles per work item in each stage and their shares, the waits, and the
device time of each of kernel 6's launches (``split``, the tables' TF32
planes; ``S``, eq, S and w; ``rows``; the row split's ``den`` sum;
``score``, or the class split's ``chunk`` and ``mix``) and of the
wrapper's PyTorch work
(``other``) from ``torch.profiler`` (the uninstrumented build, median over
5 calls), and the wrapper
call's span between CUDA events beside the host time it takes to enqueue
one call (20 calls back to back, no synchronisation). Needs a CUDA device
and ``nvcc``; prints the card's name, power limit and SM clock beside the
numbers. The instrumented build's outputs are checked bitwise against the
uninstrumented kernel's, and each path's against the first path's.
"""

from __future__ import annotations

import argparse
import ctypes
import os
import re
import statistics
import subprocess
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

# as in the source: K6_MARK(0..2), the consumers' and the producer's waits
# (3, 4) and the work items (5) of the row launch, kStampBlocks
STAGES = ("tile loads", "products", "epilogue")
STAMPS = len(STAGES) + 3
MAX_BLOCKS = 1 << 14
# a device event's part of a call, by a pattern of its demangled name
PARTS = (("split", r"split_tables_kernel"), ("S", r"refresh_s_kernel"),
         ("rows", r"refresh_compute_rows_kernel"),
         ("den", r"row_den_kernel"),
         ("score", r"refresh_compute_score_kernel"),
         ("chunk", r"class_chunk_kernel"),
         ("mix", r"class_mix_kernel"))


def _launch_ms(call, reps: int = 5) -> dict:
    """Device ms of each of kernel 6's launches in a call, median over
    ``reps`` calls, and of the call's other device work (``other``, the
    sum over a call), from torch.profiler (empty when it records no device
    time)."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    call()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            call()
        torch.cuda.synchronize()
    per: dict = {}
    other = 0.0
    for ev in prof.events():
        if ev.device_type != DeviceType.CUDA:
            continue
        kind = next((k for k, pat in PARTS if re.search(pat, ev.name)),
                    None)
        if kind is None:
            other += ev.device_time_total / 1e3
        else:
            per.setdefault(kind, []).append(ev.device_time_total / 1e3)
    out = {k: statistics.median(v) for k, v in per.items()}
    if out:
        out["other"] = other / reps
    return out


def _wrapper_ms(call, reps: int = 20) -> tuple:
    """(host ms to enqueue one wrapper call, ms between CUDA events around
    one call): the host clock over ``reps`` calls enqueued back to back
    without a synchronisation, over ``reps``; and the median span of
    ``reps`` calls, each between two CUDA events. Where the span is near
    the host's time and above the launches' device time, the host holds
    the call back."""
    import time

    import torch

    for _ in range(3):
        call()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(reps):
        call()
    host = (time.perf_counter() - t0) * 1e3 / reps
    torch.cuda.synchronize()
    spans = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        call()
        end.record()
        spans.append((start, end))
    torch.cuda.synchronize()
    return host, statistics.median(a.elapsed_time(b) for a, b in spans)


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--shape", default="1000,50000,10")
    p.add_argument("--num-points", type=int, default=256)
    p.add_argument("--paths", default="single,rule")
    p.add_argument("--warpgroups", default=None,
                   help="comma-separated consumer warpgroup counts of the "
                   "row block (1, 2; default: the rule's)")
    args = p.parse_args(argv)

    import numpy as np
    import torch

    if not torch.cuda.is_available():
        print("needs a CUDA device", file=sys.stderr)
        return 2
    from coda_tpu_torch.ops import eig_kernels as ek
    from coda_tpu_torch.ops.beta import dirichlet_to_beta
    from coda_tpu_torch.ops.pbest import compute_pbest
    from coda_tpu_torch.utils.platform import pin_fp32_matmul

    pin_fp32_matmul()
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit,clocks.max.sm",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60).stdout.strip()
    H, N, C = (int(x) for x in args.shape.split(","))
    G = args.num_points
    staged = ek._lib6(("K6_STAGES",))
    staged.eig_refresh_compute_stamps.argtypes = [ctypes.c_void_p,
                                                  ctypes.c_int]
    staged.eig_refresh_compute_stamps.restype = ctypes.c_int

    dev = torch.device("cuda")
    gen = torch.Generator(device=dev)
    gen.manual_seed(0)

    def simplex(*shape):
        x = torch.rand(shape, generator=gen, device=dev) + 0.1
        return x / x.sum(-1, keepdim=True)

    d = torch.rand((H, C, C), generator=gen, device=dev) * 3 + 0.5
    a, b = dirichlet_to_beta(d)
    ci = C // 2
    a_t, b_t = a[:, ci].contiguous(), b[:, ci].contiguous()
    rows = compute_pbest(a.T, b.T)
    rows[ci] = compute_pbest(a_t, b_t)
    hyp32, pi_xi = simplex(C, N, H), simplex(N, C)
    pi = pi_xi.mean(0)
    pi = pi / pi.sum()
    hard = torch.randint(0, C, (N, H), generator=gen, device=dev,
                         dtype=torch.int32)
    c = torch.tensor(ci, dtype=torch.int32, device=dev)
    plain_lib = ek._lib6
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    print(f"card: {smi}")
    wgs = ([None] if args.warpgroups is None
           else [int(x) for x in args.warpgroups.split(",")])
    for dtype in (torch.float32, torch.bfloat16):
        hyp = hyp32.to(dtype)
        first = None
        for nwg in wgs:
            for path in args.paths.split(","):
                rule = path == "rule"
                k = ek.choose_class_chunks(C, N, H, False, sms) if rule else 1
                layout, split = ek.row_plan(C, N, H, G, sms, nwg,
                                            None if rule else False)
                wg = layout["warpgroups"]

                def call(cache):
                    return ek.eig_scores_refresh_compute(
                        rows, cache, a_t, b_t, hard, c, pi, pi_xi,
                        num_points=G, class_chunks=k, row_split=split,
                        warpgroups=wg)

                n_blocks = ek.row_blocks(N, H, split, sms,
                                         layout["blocks_per_sm"],
                                         layout["items_per_block"])
                if n_blocks > MAX_BLOCKS:
                    print(f"{n_blocks} blocks exceed the stamp buffers",
                          file=sys.stderr)
                    return 2
                outs = []
                try:
                    for use in (plain_lib, lambda *_: staged):
                        ek._lib6 = use
                        outs.append(call(hyp.clone()))
                finally:
                    ek._lib6 = plain_lib
                torch.cuda.synchronize()
                first = first or outs[0]
                same = all(torch.equal(o[0], first[0])
                           and torch.equal(o[1], first[1]) for o in outs)
                st = np.zeros(n_blocks * STAMPS, np.int64)
                rc = staged.eig_refresh_compute_stamps(
                    st.ctypes.data_as(ctypes.c_void_p), st.size)
                if rc != 0 or not same:
                    print(f"instrumented kernel failed (rc {rc}, bitwise "
                          f"the uninstrumented first path {same})",
                          file=sys.stderr)
                    return 1
                del outs
                st = st.reshape(n_blocks, STAMPS)
                per_item = st[:, :-1].sum(0) / max(1, st[:, -1].sum())
                stage, waits = per_item[:len(STAGES)], per_item[len(STAGES):]
                work = hyp.clone()
                ms = _launch_ms(lambda: call(work))
                host, span = _wrapper_ms(lambda: call(work))
                del work
                name = str(dtype).removeprefix("torch.")
                print(f"{name} cache, (H, N, C) = ({H}, {N}, {C}), G={G}, "
                      f"path {path} ({k} class chunk(s), row split "
                      f"{'on' if split else 'off'}), {layout['ring_stages']}"
                      f" ring stages, {layout['warpgroups']} consumer "
                      f"warpgroup(s), {n_blocks} persistent row blocks "
                      f"({layout['blocks_per_sm']} an SM): mean SM cycles "
                      f"per work item of {layout['items_per_block']} items by "
                      "stage "
                      + ", ".join(
                          f"{i} {s}: {m:.0f} ({m / stage.sum():.3f})"
                          for i, (s, m) in enumerate(zip(STAGES, stage)))
                      + f"; consumers waiting for full stages "
                      f"{waits[0]:.0f}, producer waiting for free slots "
                      f"{waits[1]:.0f}; device ms (torch.profiler) "
                      + (", ".join(f"{n} {v:.4f}" for n, v in ms.items())
                         or "not measured")
                      + f"; the wrapper call {span:.4f} ms between CUDA "
                      f"events, {host:.4f} ms of host time to enqueue it",
                      flush=True)
        del hyp, first
    return 0


if __name__ == "__main__":
    sys.exit(main())
