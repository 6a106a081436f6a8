#!/usr/bin/env python3
"""Time the port's scoring kernels at the headline shape, for comparing two
checkouts on one card.

    python scripts/torch_kernel_times.py [--root DIR]

Imports ``coda_tpu_torch`` from ``--root`` (default: this checkout), builds
its kernels there, and prints one JSON line: the median time of 50
launches (CUDA events, after warm-up) of kernel 3 (``gather_rows_sum``;
``[4-byte]``: the same rows one float past 16-byte alignment, which takes
the kernel's 4-byte path) and, at (C, N, H) = (10, 50000, 1000) in each
of their four flavours (fp32 or bf16 cache, exact or approx entropy),
kernels 1 and 2 (``eig_scores_cache``, ``eig_scores_refresh``), kernel 6
(``eig_scores_refresh_compute``, G = 256 grid points) and, where the
checkout has them, kernels 4 and 5 (``eig_scores_cache_batched``,
``eig_scores_refresh_batched``) and the batched kernel 3 at 5 replicas (the
CLI's default seeds); beside them the registers ``ptxas`` reports for each
library and the card's name and power limit.
Two checkouts are compared in one call, in turns (parent, change, change,
parent), each in its own process. Needs a CUDA device.
"""

from __future__ import annotations

import argparse
import json
import os
import re
import statistics
import subprocess
import sys

REPS = 50
SEEDS = 5


def _median_ms(fn) -> float:
    import torch

    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    pairs = []
    for _ in range(REPS):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        pairs.append((start, end))
    torch.cuda.synchronize()
    return statistics.median(s.elapsed_time(e) for s, e in pairs)


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--root", default=os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))))
    args = p.parse_args(argv)

    import torch

    if not torch.cuda.is_available():
        print("needs a CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, os.path.abspath(args.root))
    from coda_tpu_torch.ops import build
    from coda_tpu_torch.ops import eig_kernels as ek
    from coda_tpu_torch.ops import gather_kernels as gk
    from coda_tpu_torch.ops.beta import dirichlet_to_beta
    from coda_tpu_torch.ops.pbest import compute_pbest

    logs = build.build_all()["logs"]
    regs = {lib: sorted({int(m) for m in re.findall(r"Used (\d+) registers",
                                                     text)})
            for lib, text in logs.items()}
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60).stdout.strip()
    dev = torch.device("cuda")
    S, C, N, H = SEEDS, 10, 50_000, 1000
    gen = torch.Generator(device=dev)
    gen.manual_seed(0)

    def simplex(*shape):
        x = torch.rand(shape, generator=gen, device=dev) + 0.1
        return x / x.sum(-1, keepdim=True)

    out = {"root": os.path.abspath(args.root), "card": smi,
           "registers": regs, "ms": {}}
    # the gather first, on a fresh allocator in both checkouts
    pbc = torch.rand((C, H, N), generator=gen, device=dev)
    s = torch.randint(0, C, (S, H), generator=gen, device=dev,
                      dtype=torch.int32)
    out["ms"]["row_gather"] = _median_ms(
        lambda: gk.gather_rows_sum(pbc, s[0]))
    if hasattr(gk, "gather_rows_sum_batched"):
        out["ms"]["row_gather_batched"] = _median_ms(
            lambda: gk.gather_rows_sum_batched(pbc, s))
    # the same rows one float past 16-byte alignment: kernel 3's 4-byte path
    flat = torch.empty(C * H * N + 1, device=dev)
    pbc4 = flat[1:].view(C, H, N)
    pbc4.copy_(pbc)
    del pbc
    out["ms"]["row_gather[4-byte]"] = _median_ms(
        lambda: gk.gather_rows_sum(pbc4, s[0]))
    if hasattr(gk, "gather_rows_sum_batched"):
        out["ms"]["row_gather_batched[4-byte]"] = _median_ms(
            lambda: gk.gather_rows_sum_batched(pbc4, s))
    del flat, pbc4
    torch.cuda.empty_cache()

    batched = hasattr(ek, "eig_scores_cache_batched")
    lead = (S,) if batched else ()
    rows, hyp32, pi_xi, hyp_t = (simplex(*lead, C, H),
                                 simplex(*lead, C, N, H),
                                 simplex(*lead, N, C), simplex(*lead, N, H))
    pi = pi_xi.mean(-2)
    pi = pi / pi.sum(-1, keepdim=True)
    cls = torch.arange(S, dtype=torch.int32, device=dev) % C
    # kernel 6's operands: the Beta parameters of class c and hard
    # predictions, on replica 0's rows
    d = torch.rand((H, C, C), generator=gen, device=dev) * 3 + 0.5
    a, b = dirichlet_to_beta(d)
    a_t, b_t = a[:, 0].contiguous(), b[:, 0].contiguous()
    hard = torch.randint(0, C, (N, H), generator=gen, device=dev,
                         dtype=torch.int32)
    for dtype in (torch.float32, torch.bfloat16):
        hyp = hyp32.to(dtype)
        # the single-replica kernels on replica 0's operands
        one = [t[0] for t in (rows, hyp, pi, pi_xi, hyp_t)] if batched \
            else [rows, hyp, pi, pi_xi, hyp_t]
        r1, h1, p1, px1, ht1 = one
        c1 = cls[0]
        r6 = r1.clone()
        r6[0] = compute_pbest(a_t, b_t)
        for approx in (False, True):
            out["ms"][ek.flavour("eig_refresh_compute_score", dtype,
                                 approx)] = _median_ms(
                lambda: ek.eig_scores_refresh_compute(
                    r6, h1, a_t, b_t, hard, c1, p1, px1, approx=approx))
            out["ms"][ek.flavour("eig_score", dtype, approx)] = _median_ms(
                lambda: ek.eig_scores_cache(r1, h1, p1, px1, approx=approx))
            out["ms"][ek.flavour("eig_refresh_score", dtype, approx)] = \
                _median_ms(lambda: ek.eig_scores_refresh(
                    r1, h1, ht1, c1, p1, px1, approx=approx))
            if not batched:
                continue
            out["ms"][ek.flavour("eig_score_batched", dtype, approx)] = \
                _median_ms(lambda: ek.eig_scores_cache_batched(
                    rows, hyp, pi, pi_xi, approx=approx))
            out["ms"][ek.flavour("eig_refresh_score_batched", dtype,
                                 approx)] = _median_ms(
                lambda: ek.eig_scores_refresh_batched(
                    rows, hyp, hyp_t, cls, pi, pi_xi, approx=approx))
        del hyp, one, r1, h1, p1, px1, ht1, r6
        torch.cuda.empty_cache()
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    sys.exit(main())
