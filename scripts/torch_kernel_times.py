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
CLI's default seeds); then kernels 1, 2 and 6 in the four flavours at the
imagenet_sparse pool's (C, N, H) = (1000, 256, 500) (keys ending
``@1000,256,500``; kernel 6's class row refreshed from the Beta marginals
of random 10-entry Dirichlet rows), and kernels 4 and 5 at 5 replicas of
it (keys ending ``@5x1000,256,500``), on the decompositions the
checkout's wrappers take there; then kernel 6 in fp32 and bf16 (exact
entropy) at the item axes between the pool and the headline, ``MID``
(C = 10, H = 1000, N from 2048 to 24000, and digits_h80's (10, 1797,
80)), with ``k6_parts`` and ``dev_ms`` as at the pool; beside them the registers ``ptxas``
reports for each library and the card's name and power limit. For kernel
6 in every flavour at both shapes, ``k6_parts`` holds each of its launches'
device ms (``torch.profiler``, 10 calls, each kernel's median launch
times its launches a call, by the kernel's name; launches that run
concurrently each count their own time). At the
pool's short item axis a call's span between CUDA events is bound by the
host's enqueue and varies from run to run, so ``dev_ms`` holds, for every
entry at the pool, the device ms of its kernels' launches a call (the
same profile, PyTorch's own kernels left out).
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
POOL = (1000, 256, 500)   # (C, N, H): scripts/imagenet_sparse.py's pool
MID = ((10, 2048, 1000), (10, 4096, 1000), (10, 8192, 1000),
       (10, 12000, 1000), (10, 16000, 1000), (10, 24000, 1000),
       (10, 1797, 80))


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


def _kernel_name(name: str) -> str:
    """A device kernel's short name: its function and, for the class
    split's first launch, its template arguments (the scoring part)."""
    base = re.sub(r"^void |\(anonymous namespace\)::|eig::", "", name)
    base = base.split("(")[0]
    return base if base.startswith("class_chunk") else base.split("<")[0]


def _parts_ms(fn, reps: int = 10) -> dict:
    """Device ms of each kernel a call of ``fn`` launches: the median of
    its launches' device times over ``reps`` calls, times its launches a
    call (one slow launch does not move it)."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    per: dict = {}
    for ev in prof.events():
        if ev.device_type == DeviceType.CUDA:
            per.setdefault(_kernel_name(ev.name), []).append(
                ev.device_time_total / 1e3)
    return {k: statistics.median(v) * len(v) / reps
            for k, v in sorted(per.items())}


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
           "registers": regs, "ms": {}, "k6_parts": {}, "dev_ms": {}}

    def own(parts: dict) -> float:
        return sum(v for k, v in parts.items() if not k.startswith(
            ("at::", "Memcpy", "lgamma", "void at::")))
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
            name6 = ek.flavour("eig_refresh_compute_score", dtype, approx)

            def k6():
                return ek.eig_scores_refresh_compute(
                    r6, h1, a_t, b_t, hard, c1, p1, px1, approx=approx)

            out["ms"][name6] = _median_ms(k6)
            out["k6_parts"][name6] = _parts_ms(k6)
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
    del rows, hyp32, pi_xi, hyp_t, pi, hard
    torch.cuda.empty_cache()
    # kernels 1 and 2 at the imagenet_sparse pool's short item axis, on
    # whichever decomposition the checkout's wrappers take there
    Cp, Np, Hp = POOL
    rows, hyp32, pi_xi, hyp_t = (simplex(Cp, Hp), simplex(Cp, Np, Hp),
                                 simplex(Np, Cp), simplex(Np, Hp))
    pi = pi_xi.mean(0)
    pi = pi / pi.sum()
    cp = torch.tensor(3, dtype=torch.int32, device=dev)
    d = torch.rand((Hp, 10), generator=gen, device=dev) * 3 + 0.5
    a_p = d[:, 0].contiguous()
    b_p = (d.sum(-1) - a_p).contiguous()
    rows6 = rows.clone()
    rows6[3] = compute_pbest(a_p, b_p)
    hard = torch.randint(0, Cp, (Np, Hp), generator=gen, device=dev,
                         dtype=torch.int32)
    tag = "@" + ",".join(map(str, POOL))
    for dtype in (torch.float32, torch.bfloat16):
        hyp = hyp32.to(dtype)
        for approx in (False, True):
            k1 = ek.flavour("eig_score", dtype, approx) + tag
            k2 = ek.flavour("eig_refresh_score", dtype, approx) + tag

            def f1():
                return ek.eig_scores_cache(rows, hyp, pi, pi_xi,
                                           approx=approx)

            def f2():
                return ek.eig_scores_refresh(rows, hyp, hyp_t, cp, pi, pi_xi,
                                             approx=approx)

            out["ms"][k1] = _median_ms(f1)
            out["dev_ms"][k1] = own(_parts_ms(f1))
            out["ms"][k2] = _median_ms(f2)
            out["dev_ms"][k2] = own(_parts_ms(f2))
            name6 = ek.flavour("eig_refresh_compute_score", dtype,
                               approx) + tag

            def k6():
                return ek.eig_scores_refresh_compute(
                    rows6, hyp, a_p, b_p, hard, cp, pi, pi_xi,
                    approx=approx)

            out["ms"][name6] = _median_ms(k6)
            out["k6_parts"][name6] = _parts_ms(k6)
            out["dev_ms"][name6] = own(out["k6_parts"][name6])
        del hyp
    del rows, rows6, hyp32, pi_xi, hyp_t, pi, hard
    torch.cuda.empty_cache()
    # kernels 4 and 5 at SEEDS replicas of the pool, likewise
    rows, hyp32, pi_xi, hyp_t = (simplex(S, Cp, Hp), simplex(S, Cp, Np, Hp),
                                 simplex(S, Np, Cp), simplex(S, Np, Hp))
    pi = pi_xi.mean(-2)
    pi = pi / pi.sum(-1, keepdim=True)
    cls = torch.tensor([(3 * r + 1) % Cp for r in range(S)],
                       dtype=torch.int32, device=dev)
    tag = f"@{S}x" + ",".join(map(str, POOL))
    for dtype in (torch.float32, torch.bfloat16):
        hyp = hyp32.to(dtype)
        for approx in (False, True):
            k4 = ek.flavour("eig_score_batched", dtype, approx) + tag
            k5 = ek.flavour("eig_refresh_score_batched", dtype, approx) + tag

            def f4():
                return ek.eig_scores_cache_batched(rows, hyp, pi, pi_xi,
                                                   approx=approx)

            def f5():
                return ek.eig_scores_refresh_batched(rows, hyp, hyp_t, cls,
                                                     pi, pi_xi, approx=approx)

            out["ms"][k4] = _median_ms(f4)
            out["dev_ms"][k4] = own(_parts_ms(f4))
            out["ms"][k5] = _median_ms(f5)
            out["dev_ms"][k5] = own(_parts_ms(f5))
        del hyp
    del rows, hyp32, pi_xi, hyp_t, pi
    torch.cuda.empty_cache()
    for Cm, Nm, Hm in MID:
        rows, hyp32, pi_xi = simplex(Cm, Hm), simplex(Cm, Nm, Hm), \
            simplex(Nm, Cm)
        pi = pi_xi.mean(0)
        pi = pi / pi.sum()
        cm = torch.tensor(Cm // 2, dtype=torch.int32, device=dev)
        d = torch.rand((Hm, 10), generator=gen, device=dev) * 3 + 0.5
        a_m = d[:, 0].contiguous()
        b_m = (d.sum(-1) - a_m).contiguous()
        rows[Cm // 2] = compute_pbest(a_m, b_m)
        hard = torch.randint(0, Cm, (Nm, Hm), generator=gen, device=dev,
                             dtype=torch.int32)
        tag = "@" + ",".join(map(str, (Cm, Nm, Hm)))
        for dtype in (torch.float32, torch.bfloat16):
            hyp = hyp32.to(dtype)
            name6 = ek.flavour("eig_refresh_compute_score", dtype,
                               False) + tag

            def k6():
                return ek.eig_scores_refresh_compute(
                    rows, hyp, a_m, b_m, hard, cm, pi, pi_xi)

            out["ms"][name6] = _median_ms(k6)
            out["k6_parts"][name6] = _parts_ms(k6)
            out["dev_ms"][name6] = own(out["k6_parts"][name6])
            del hyp
        del rows, hyp32, pi_xi, pi, hard
        torch.cuda.empty_cache()
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    sys.exit(main())
