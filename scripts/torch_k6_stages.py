#!/usr/bin/env python3
"""Where kernel 6's time goes, stage by stage, on the GPU.

    python scripts/torch_k6_stages.py [--shape H,N,C] [--num-points 256]

Builds ``coda_tpu_torch/csrc/eig_refresh_compute.cu`` (the fused
refresh-compute-score kernel) a second time with ``-DK6_STAGES`` into the
git-ignored ``coda_tpu_torch/_build/``: thread 0 of every block of its row
launch then adds up the ``clock64()`` cycles of each of that launch's five
stages (eq mask, S, exp, the base and diff products, epilogue; the last two
summed over the model chunks) and, apart, the cycles of S and the products
spent waiting for the shared-memory ring's copies. That build is launched
through the port's own wrapper on random inputs of ``--shape`` (default
the headline 1000,50000,10), fp32 and bf16 cache, and the script prints
the mean SM cycles per row block in each stage and their shares, and the
device time of each of the two launches (rows, scoring) from
``torch.profiler`` (the uninstrumented build, median over 5 calls). Needs
a CUDA device and
``nvcc``; prints the card's name, power limit and SM clock beside the
numbers. The instrumented build's outputs are checked bitwise against the
uninstrumented kernel's.
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
MAX_BLOCKS, ITEMS_PER_BLOCK = 1 << 14, 64


def _launch_ms(call, reps: int = 5) -> dict:
    """Device ms of each of kernel 6's two launches, median over ``reps``
    calls, from torch.profiler (empty when it records no device time)."""
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
    for ev in prof.events():
        if ev.device_type == DeviceType.CUDA and "refresh_compute" in ev.name:
            kind = "rows" if "rows_kernel" in ev.name else "score"
            per.setdefault(kind, []).append(ev.device_time_total / 1e3)
    return {k: statistics.median(v) for k, v in per.items()}


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--shape", default="1000,50000,10")
    p.add_argument("--num-points", type=int, default=256)
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
    n_blocks = -(-N // ITEMS_PER_BLOCK)
    if n_blocks > MAX_BLOCKS:
        print(f"N={N} exceeds the stamp buffers", file=sys.stderr)
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
    print(f"card: {smi}")
    print(f"layout: {layout}")
    for dtype in (torch.float32, torch.bfloat16):
        hyp = hyp32.to(dtype)

        def call():
            return ek.eig_scores_refresh_compute(rows, hyp.clone(), a_t, b_t,
                                                 hard, c, pi, pi_xi,
                                                 num_points=G)

        outs = []
        try:
            for use in (plain_lib, lambda *_: staged):
                ek._lib6 = use
                outs.append(call())
        finally:
            ek._lib6 = plain_lib
        torch.cuda.synchronize()
        same = torch.equal(outs[0][0], outs[1][0]) and torch.equal(
            outs[0][1], outs[1][1])
        st = np.zeros(n_blocks * STAMPS, np.int64)
        rc = staged.eig_refresh_compute_stamps(
            st.ctypes.data_as(ctypes.c_void_p), st.size)
        if rc != 0 or not same:
            print(f"instrumented kernel failed (rc {rc}, bitwise same "
                  f"{same})", file=sys.stderr)
            return 1
        del outs
        mean = st.reshape(n_blocks, STAMPS).mean(0)
        waited, mean = mean[-1], mean[:-1]
        ms = _launch_ms(call)
        name = str(dtype).removeprefix("torch.")
        print(f"{name} cache, (H, N, C) = ({H}, {N}, {C}), G={G}: row "
              f"launch mean SM cycles per block of {ITEMS_PER_BLOCK} items "
              "by stage "
              + ", ".join(
                  f"{k} {s}: {m:.0f} ({m / mean.sum():.3f})"
                  for k, (s, m) in enumerate(zip(STAGES, mean)))
              + f"; {n_blocks} blocks; of S and the products {waited:.0f} "
              f"({waited / mean[[1, 3]].sum():.3f}) waiting for the ring's "
              "copies; device ms (torch.profiler) "
              + (", ".join(f"{k} {v:.4f}" for k, v in ms.items())
                 or "not measured"))
        del hyp
    return 0


if __name__ == "__main__":
    sys.exit(main())
