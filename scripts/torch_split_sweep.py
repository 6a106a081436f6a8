#!/usr/bin/env python3
"""Sweep the class-chunk count of kernels 1 and 2 (``eig_scores_cache``,
``eig_scores_refresh``), or with ``--seeds S`` of kernels 4 and 5 at S
replicas (``eig_scores_cache_batched``, ``eig_scores_refresh_batched``),
over cache blocks, to set the split rule's crossover
(``ops/eig_kernels.choose_class_chunks``).

    python scripts/torch_split_sweep.py [--blocks C,N,H;C,N,H...]
        [--flavours float32,bfloat16,float32:approx,bfloat16:approx]
        [--seeds S | --k6 [--warpgroups 1,2]] [--reps 20] [--chunks K,K...]
        [--out sweep.json]

For each ``(C, N, H)`` block (default: the ranks' blocks that
``chip_smoke.py`` phase 15 times, the imagenet_sparse pool's data=2 rank
``(1000, 128, 500)`` and ``digits_h80``'s ``(10, 899, 80)``) and each
flavour (cache dtype, exact or approx entropy) it builds a random
normalised cache on the card, launches kernels 1 and 2 at one chunk and
at a ladder of chunk counts (powers of two up to C, and the rule's),
holds every split launch's scores, and kernel 2's refreshed cache,
bitwise (``torch.equal``) to the single launch's, and times each beside
its bound (bytes at the card's memory rate, ``telemetry/costs``): the
wrapper call (median of ``--reps`` calls, CUDA events around each, after
warm-up; ``k1_ms``, ``k2_ms``) and the launch alone (``--reps`` launches
of the library's entry on operands prepared once, back to back between
two CUDA events; ``k1_launch_ms``, ``k2_launch_ms``). Prints
one JSON line a block and flavour (the item grid, the load path, the
rule's chunks, the time at each count) and, last, the card's name and
power limit. Exits 1 if any split launch differs from the single one.
With ``--seeds S`` (S > 1) every operand has a leading axis of S
replicas (a block is one replica's ``(C, N, H)``), each replica refreshes
its own class row, the launches are kernels 4 and 5 (the ``k1``/``k2``
keys then name them), the bound is S times a replica's, and the single
batched launch is also held bitwise to kernels 1 and 2 launched per
replica. With ``--k6`` the kernel is kernel 6 (``eig_scores_refresh_compute``,
G = 256, its class row refreshed from random Beta tables and hard
predictions): at each chunk count of the ladder, with its row launch's
model-chunk split off and on (``row_split``) and at each consumer
warpgroup count of ``--warpgroups`` (``warpgroups``; default: the rule's),
the scores and the whole refreshed cache are held bitwise to the single
path's (one chunk, no row split, the first warpgroup count), the wrapper
call is timed with CUDA events (``k6_ms``, keyed ``"<chunks>/<row split 0
or 1>"``, then ``"/<warpgroups>"`` where ``--warpgroups`` is given) and
each launch alone from ``torch.profiler`` (``k6_rows_ms``: the tables'
split, the S launch, the row launch and the row split's sum launch;
``k6_score_ms``: the scoring launch or the split's two; the mean of
``--reps`` calls in one window), beside the bound of the whole function
(``costs.kernel_work``), the rules' choices and the wrapper's other device
work (``k6_other_ms``). Needs a CUDA device.
"""

from __future__ import annotations

import argparse
import json
import os
import statistics
import subprocess
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

BLOCKS = ((10, 50_000, 500), (10, 50_000, 250), (10, 25_000, 500),
          (1000, 256, 500), (1000, 256, 250), (126, 2048, 500),
          (10, 8192, 1000), (1000, 128, 500), (10, 899, 80))
FLAVOURS = ("float32", "bfloat16", "float32:approx", "bfloat16:approx")


def _median_ms(fn, reps: int) -> float:
    import torch

    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    pairs = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        pairs.append((start, end))
    torch.cuda.synchronize()
    return statistics.median(s.elapsed_time(e) for s, e in pairs)


def _kernel_ms(ek, rows, hyp, pi, pi_xi, hyp_t, c, approx, k,
               refresh: bool, reps: int) -> float:
    """The launch alone (the wrapper's ctypes call on operands prepared
    once): ``reps`` launches back to back between two CUDA events, over
    ``reps``. A leading replica axis on ``hyp`` launches kernel 4 or 5."""
    import torch

    *lead, C, N, H = hyp.shape
    mixture0, h_before = ek.mixture_stats(rows, pi, approx)
    out = torch.empty((*lead, N), dtype=torch.float32, device=hyp.device)
    ent = torch.empty((*lead, N, C), dtype=torch.float32, device=hyp.device)
    c32 = c.reshape(-1).to(torch.int32)
    lib = ek._lib()
    flags = (*lead, C, N, H, ek._vec(H, hyp, rows, hyp_t, mixture0),
             int(hyp.dtype == torch.bfloat16), int(approx))
    kern = ("eig_refresh_score" if refresh else "eig_score") + (
        "_batched" if lead else "")
    one = getattr(lib, kern + "_launch")
    split = getattr(lib, kern + "_split_launch")
    if refresh:
        args = (rows.data_ptr(), hyp.data_ptr(), hyp_t.data_ptr(),
                c32.data_ptr(), pi.data_ptr(), pi_xi.data_ptr(),
                mixture0.data_ptr(), h_before.data_ptr(), out.data_ptr())
    else:
        args = (rows.data_ptr(), hyp.data_ptr(), pi.data_ptr(),
                pi_xi.data_ptr(), mixture0.data_ptr(), h_before.data_ptr(),
                out.data_ptr())
    fn = (lambda: one(*args, *flags, stream)) if k == 1 else (
        lambda: split(*args, ent.data_ptr(), *flags, k, stream))
    stream = torch.cuda.current_stream().cuda_stream
    for _ in range(3):
        assert fn() == 0
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


# kernel 6's launches by a pattern of their demangled names: the row launch
# (and the row split's sum), the scoring launch (single, or the split's two)
K6_PARTS = (("rows", ("split_tables_kernel", "refresh_s_kernel",
                      "refresh_compute_rows_kernel", "row_den_kernel")),
            ("score", ("refresh_compute_score_kernel", "class_chunk_kernel",
                       "class_mix_kernel")))


def _k6_parts_ms(fn, reps: int) -> dict:
    """Device ms a call of kernel 6's row and scoring launches and of the
    wrapper's other device work: the means over ``reps`` calls in one
    torch.profiler window."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    per = {"rows": 0.0, "score": 0.0, "other": 0.0}
    for ev in prof.events():
        if ev.device_type != DeviceType.CUDA:
            continue
        kind = next((k for k, pats in K6_PARTS
                     if any(p in ev.name for p in pats)), "other")
        per[kind] += ev.device_time_total / 1e3
    return {k: v / reps for k, v in per.items()}


def _sweep_k6(args, blocks, gen, peaks, sms, bad) -> list:
    """Kernel 6 at each block and flavour over the chunk ladder, the row
    split off and on; see the module docstring."""
    import torch

    from coda_tpu_torch.ops import eig_kernels as ek
    from coda_tpu_torch.ops.pbest import compute_pbest
    from coda_tpu_torch.telemetry import costs

    dev, G, out = torch.device("cuda"), 256, []
    for C, N, H in blocks:
        def simplex(*shape):
            x = torch.rand(shape, generator=gen, device=dev) + 0.1
            return x / x.sum(-1, keepdim=True)

        # the labelled class's Beta marginals, of random 10-entry Dirichlet
        # rows as at the headline (their spread, not C, shapes the tables)
        ci = C // 2
        d = torch.rand((H, 10), generator=gen, device=dev) * 3 + 0.5
        a_t = d[:, 0].contiguous()
        b_t = (d.sum(-1) - a_t).contiguous()
        rows = simplex(C, H)
        rows[ci] = compute_pbest(a_t, b_t)
        hyp32, pi_xi = simplex(C, N, H), simplex(N, C)
        pi = pi_xi.mean(0)
        pi = pi / pi.sum()
        hard = torch.randint(0, C, (N, H), generator=gen, device=dev,
                             dtype=torch.int32)
        c = torch.tensor(ci, dtype=torch.int32, device=dev)
        nnz = int((hard == ci).sum())
        layout, row_rule = ek.row_plan(C, N, H, G, sms)
        wgs = ([None] if args.warpgroups is None
               else [int(x) for x in args.warpgroups.split(",")])
        for fl in args.flavours.split(","):
            dname, _, tag = fl.partition(":")
            dtype, approx = getattr(torch, dname), tag == "approx"
            hyp = hyp32.to(dtype)
            rule = ek.choose_class_chunks(C, N, H, approx, sms)

            def call(k, rs, cache, wg=None):
                return ek.eig_scores_refresh_compute(
                    rows, cache, a_t, b_t, hard, c, pi, pi_xi, num_points=G,
                    approx=approx, class_chunks=k, row_split=rs,
                    warpgroups=wg)

            ref = hyp.clone()
            one = call(1, False, ref, wgs[0])[0]
            nb, ops, tops = costs.kernel_work(
                "eig_refresh_compute_score", C, N, H, hyp.element_size(),
                G=G, nnz=nnz)
            rec = {"kernel": 6, "C": C, "N": N, "H": H, "flavour": fl,
                   "path": ("vector" if ek._vec(H, hyp, rows) > 1
                            else "scalar"),
                   "rule_chunks": rule,
                   "rule_row_split": row_rule,
                   "rule_warpgroups": layout["warpgroups"],
                   "k6_bound_ms": costs.bound_ms(nb, ops, peaks, tops)[0],
                   "k6_ms": {}, "k6_rows_ms": {}, "k6_score_ms": {},
                   "k6_other_ms": {}}
            ladder = _ladder(C, rule) if args.chunks is None else sorted(
                {1, rule} | {min(C, int(x)) for x in args.chunks.split(",")})
            work = hyp.clone()
            for k, rs, wg in ((k, rs, wg) for k in ladder
                              for rs in (False, True) for wg in wgs):
                got_hyp = hyp.clone()
                got = call(k, rs, got_hyp, wg)[0]
                torch.cuda.synchronize()
                if not (torch.equal(got, one)
                        and torch.equal(got_hyp, ref)):
                    bad.append((C, N, H, fl, k, rs, wg))
                del got_hyp
                key = f"{k}/{int(rs)}" + ("" if wg is None else f"/{wg}")
                rec["k6_ms"][key] = _median_ms(
                    lambda: call(k, rs, work, wg), args.reps)
                parts = _k6_parts_ms(lambda: call(k, rs, work, wg),
                                     args.reps)
                rec["k6_rows_ms"][key] = parts["rows"]
                rec["k6_score_ms"][key] = parts["score"]
                rec["k6_other_ms"][key] = parts["other"]
            rec["k6_best"] = min(rec["k6_ms"], key=rec["k6_ms"].get)
            out.append(rec)
            print(json.dumps(rec), flush=True)
            del hyp, ref, work
        del rows, hyp32, pi_xi, hard
        torch.cuda.empty_cache()
    return out


def _ladder(C: int, rule: int) -> list:
    ks = {1, rule, C}
    k = 2
    while k < C:
        ks.add(k)
        k *= 2
    return sorted(ks)


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--blocks", default=";".join(
        ",".join(map(str, b)) for b in BLOCKS))
    p.add_argument("--flavours", default=",".join(FLAVOURS))
    p.add_argument("--seeds", type=int, default=1,
                   help="replicas: S > 1 sweeps kernels 4 and 5")
    p.add_argument("--k6", action="store_true",
                   help="sweep kernel 6 (one replica)")
    p.add_argument("--warpgroups", default=None,
                   help="with --k6: comma-separated consumer warpgroup "
                        "counts (1, 2) of the row launch (default: the "
                        "rule's)")
    p.add_argument("--reps", type=int, default=20)
    p.add_argument("--chunks", default=None,
                   help="comma-separated chunk counts (default: 1, the "
                        "rule's, C and the powers of two below C)")
    p.add_argument("--out", default=None)
    args = p.parse_args(argv)

    import torch

    if not torch.cuda.is_available():
        print("needs a CUDA device", file=sys.stderr)
        return 2
    from coda_tpu_torch.ops import eig_kernels as ek
    from coda_tpu_torch.telemetry import costs

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60).stdout.strip()
    dev = torch.device("cuda")
    name = torch.cuda.get_device_name(0)
    peaks = costs.card_peaks(name) or costs.card_peaks("H100")
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    gen = torch.Generator(device=dev).manual_seed(19)
    blocks = [tuple(int(x) for x in b.split(","))
              for b in args.blocks.split(";")]
    S = args.seeds
    if args.k6:
        bad: list = []
        rows_out = _sweep_k6(args, blocks, gen, peaks, sms, bad)
        if args.out:
            with open(args.out, "w") as f:
                json.dump({"card": smi, "sms": sms, "kernel": 6,
                           "rows": rows_out}, f, indent=1)
        if bad:
            print(f"kernel 6's split paths differ from the single path: "
                  f"{bad}", file=sys.stderr)
        print(smi)
        return 1 if bad else 0
    lead = (S,) if S > 1 else ()
    if S > 1:
        score, refresh = (ek.eig_scores_cache_batched,
                          ek.eig_scores_refresh_batched)
        kernels = ("eig_score_batched", "eig_refresh_score_batched")
    else:
        score, refresh = ek.eig_scores_cache, ek.eig_scores_refresh
        kernels = ("eig_score", "eig_refresh_score")
    rows_out, bad = [], []
    for C, N, H in blocks:
        def simplex(*shape):
            x = torch.rand((*lead, *shape), generator=gen, device=dev) + 0.1
            return x / x.sum(-1, keepdim=True)

        rows, hyp32, pi_xi, hyp_t = (simplex(C, H), simplex(C, N, H),
                                     simplex(N, C), simplex(N, H))
        pi = pi_xi.mean(-2)
        pi = pi / pi.sum(-1, keepdim=True)
        # each replica refreshes its own class row
        c = (torch.tensor([(C // 2 + 7 * s) % C for s in range(S)],
                          dtype=torch.int32, device=dev) if S > 1
             else torch.tensor(C // 2, dtype=torch.int32, device=dev))
        for fl in args.flavours.split(","):
            dname, _, tag = fl.partition(":")
            dtype, approx = getattr(torch, dname), tag == "approx"
            hyp = hyp32.to(dtype)
            rule = ek.choose_class_chunks(C, N, H, approx, sms, S)
            one1 = score(rows, hyp, pi, pi_xi, approx=approx, class_chunks=1)
            ref2 = hyp.clone()
            one2, _ = refresh(rows, ref2, hyp_t, c, pi, pi_xi, approx=approx,
                              class_chunks=1)
            if S > 1:
                # the single batched launch against kernels 1 and 2 per
                # replica
                hyp_q = hyp.clone()
                per1 = torch.stack([ek.eig_scores_cache(
                    rows[s], hyp[s], pi[s], pi_xi[s], approx=approx,
                    class_chunks=1) for s in range(S)])
                per2 = torch.stack([ek.eig_scores_refresh(
                    rows[s], hyp_q[s], hyp_t[s], c[s], pi[s], pi_xi[s],
                    approx=approx, class_chunks=1)[0] for s in range(S)])
                torch.cuda.synchronize()
                if not (torch.equal(per1, one1) and torch.equal(per2, one2)
                        and torch.equal(hyp_q, ref2)):
                    bad.append((C, N, H, fl, "per replica"))
                del hyp_q
            work = hyp.clone()
            rec = {"C": C, "N": N, "H": H, "S": S, "flavour": fl,
                   "item_blocks": -(-N // (8 if approx else 32)),
                   "path": ("vector" if ek._vec(H, hyp, rows) > 1
                            else "scalar"),
                   "rule_chunks": rule, "k1_ms": {}, "k2_ms": {},
                   "k1_launch_ms": {}, "k2_launch_ms": {}}
            for k, kernel in zip(("k1", "k2"), kernels):
                nb, ops, _ = costs.kernel_work(kernel, C, N, H,
                                               hyp.element_size(), S)
                rec[k + "_bound_ms"] = costs.bound_ms(nb, ops, peaks)[0]
            ladder = _ladder(C, rule) if args.chunks is None else sorted(
                {1, rule} | {min(C, int(x)) for x in args.chunks.split(",")})
            for k in ladder:
                got1 = score(rows, hyp, pi, pi_xi, approx=approx,
                             class_chunks=k)
                hyp2 = hyp.clone()
                got2, _ = refresh(rows, hyp2, hyp_t, c, pi, pi_xi,
                                  approx=approx, class_chunks=k)
                torch.cuda.synchronize()
                if not (torch.equal(got1, one1) and torch.equal(got2, one2)
                        and torch.equal(hyp2, ref2)):
                    bad.append((C, N, H, fl, k))
                del hyp2
                rec["k1_ms"][k] = _median_ms(
                    lambda: score(rows, hyp, pi, pi_xi, approx=approx,
                                  class_chunks=k), args.reps)
                rec["k2_ms"][k] = _median_ms(
                    lambda: refresh(rows, work, hyp_t, c, pi, pi_xi,
                                    approx=approx, class_chunks=k),
                    args.reps)
                rec["k1_launch_ms"][k] = _kernel_ms(
                    ek, rows, hyp, pi, pi_xi, hyp_t, c, approx, k, False,
                    args.reps)
                rec["k2_launch_ms"][k] = _kernel_ms(
                    ek, rows, work, pi, pi_xi, hyp_t, c, approx, k, True,
                    args.reps)
            for k in ("k1", "k2"):
                best = min(rec[k + "_ms"], key=rec[k + "_ms"].get)
                rec[k + "_best_chunks"] = best
                launch = rec[k + "_launch_ms"]
                rec[k + "_launch_best_chunks"] = min(launch, key=launch.get)
            rows_out.append(rec)
            print(json.dumps(rec), flush=True)
            del hyp, ref2, work
        del rows, hyp32, pi_xi, hyp_t
        torch.cuda.empty_cache()
    if args.out:
        with open(args.out, "w") as f:
            json.dump({"card": smi, "sms": sms, "seeds": S,
                       "rows": rows_out}, f,
                      indent=1)
    if bad:
        print(f"split launches differ from the single launch: {bad}",
              file=sys.stderr)
    print(smi)
    return 1 if bad else 0


if __name__ == "__main__":
    sys.exit(main())
