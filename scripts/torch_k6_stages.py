#!/usr/bin/env python3
"""Where kernel 6's time goes, stage by stage, on the GPU.

    python scripts/torch_k6_stages.py [--shape H,N,C] [--num-points 256]
        [--paths single,rule]

Builds ``coda_tpu_torch/csrc/eig_refresh_compute.cu`` (the fused
refresh-compute-score kernel) a second time with ``-DK6_STAGES`` into the
git-ignored ``coda_tpu_torch/_build/``: thread 0 of every block of its row
launch then adds up the ``clock64()`` cycles of each of that launch's five
stages (eq mask, S, exp, the base and diff products, epilogue; the last two
summed over the model chunks) and, apart, the cycles of S and the products
spent waiting for the shared-memory ring's copies. That build is launched
through the port's own wrapper on random inputs of ``--shape`` (default
the headline 1000,50000,10), fp32 and bf16 cache, on each of ``--paths``:
``single`` (both launches on their single decomposition: ``class_chunks=1,
row_split=False``) and ``rule`` (the decompositions the wrapper's rules
pick; at a short item axis the row split, one block a tile and model
chunk, and the class-chunk scoring split). For each the script prints the
mean SM cycles per row block in each stage and their shares (under the row
split a block's stages 3-4 cover its one chunk), and the device time of
each of kernel 6's launches (``rows``; the row split's ``den`` sum;
``score``, or the split's ``chunk`` and ``mix``) and of the wrapper's
PyTorch work (``other``: the Beta tables, the mixture, the scratch) from
``torch.profiler`` (the uninstrumented build, median over 5 calls), and
the wrapper call's span between CUDA events beside the host time it takes
to enqueue one call (20 calls back to back, no synchronisation). Needs
a CUDA device and ``nvcc``; prints the card's name, power limit and SM
clock beside the numbers. The instrumented build's outputs are checked
bitwise against the uninstrumented kernel's, and each path's against the
single path's.
"""

from __future__ import annotations

import argparse
import ctypes
import os
import statistics
import subprocess
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

# as in the source: K6_MARK(0..4) and the wait counter (5) of the row
# launch, kStampBlocks, kB
STAGES = ("eq mask", "S", "exp", "products", "epilogue")
STAMPS = len(STAGES) + 1
MAX_BLOCKS = 1 << 14
# a device event's part of a call, by a pattern of its demangled name
PARTS = (("rows", "refresh_compute_rows_kernel"), ("den", "row_den_kernel"),
         ("score", "refresh_compute_score_kernel"),
         ("chunk", "class_chunk_kernel"), ("mix", "class_mix_kernel"))


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
        kind = next((k for k, pat in PARTS if pat in ev.name), None)
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
    tiles = -(-N // ek.ROW_ITEMS)
    if tiles * -(-H // ek.ROW_MODELS) > MAX_BLOCKS:
        print(f"N={N}, H={H} exceed the stamp buffers", file=sys.stderr)
        return 2
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
    layout = ek.refresh_compute_layout(C, H, G)
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    print(f"card: {smi}")
    print(f"layout: {layout}")
    paths = {"single": (1, False), "rule": (None, None)}
    for dtype in (torch.float32, torch.bfloat16):
        hyp = hyp32.to(dtype)
        first = None
        for path in args.paths.split(","):
            k, split = paths[path]
            if k is None:
                k = ek.choose_class_chunks(C, N, H, False, sms)
                split = ek.choose_row_split(N, H, sms,
                                            layout["blocks_per_sm"])

            def call(cache):
                return ek.eig_scores_refresh_compute(
                    rows, cache, a_t, b_t, hard, c, pi, pi_xi,
                    num_points=G, class_chunks=k, row_split=split)

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
            n_blocks = tiles * (-(-H // ek.ROW_MODELS) if split else 1)
            st = np.zeros(n_blocks * STAMPS, np.int64)
            rc = staged.eig_refresh_compute_stamps(
                st.ctypes.data_as(ctypes.c_void_p), st.size)
            if rc != 0 or not same:
                print(f"instrumented kernel failed (rc {rc}, bitwise the "
                      f"uninstrumented single path {same})", file=sys.stderr)
                return 1
            del outs
            mean = st.reshape(n_blocks, STAMPS).mean(0)
            waited, mean = mean[-1], mean[:-1]
            work = hyp.clone()
            ms = _launch_ms(lambda: call(work))
            host, span = _wrapper_ms(lambda: call(work))
            del work
            name = str(dtype).removeprefix("torch.")
            print(f"{name} cache, (H, N, C) = ({H}, {N}, {C}), G={G}, path "
                  f"{path} ({k} class chunk(s), row split "
                  f"{'on' if split else 'off'}): row launch mean SM cycles "
                  f"per block of {ek.ROW_ITEMS} items by stage "
                  + ", ".join(
                      f"{i} {s}: {m:.0f} ({m / mean.sum():.3f})"
                      for i, (s, m) in enumerate(zip(STAGES, mean)))
                  + f"; {n_blocks} blocks; of S and the products "
                  f"{waited:.0f} ({waited / mean[[1, 3]].sum():.3f}) "
                  "waiting for the ring's copies; device ms "
                  "(torch.profiler) "
                  + (", ".join(f"{n} {v:.4f}" for n, v in ms.items())
                     or "not measured")
                  + f"; the wrapper call {span:.4f} ms between CUDA events, "
                  f"{host:.4f} ms of host time to enqueue it", flush=True)
        del hyp, first
    return 0


if __name__ == "__main__":
    sys.exit(main())
