#!/usr/bin/env python3
"""Chip smoke test of the PyTorch/CUDA port (``coda_tpu_torch``) on one GPU.

    python3 chip_smoke.py

Run from the root of a checkout on a machine with an NVIDIA H100 and the
CUDA toolkit. It imports nothing of JAX or of the ``coda_tpu`` package and:

1. builds the CUDA kernels from ``coda_tpu_torch/csrc`` (one ``nvcc`` per
   source, all started together) and prints the build time, the compiler's
   register/spill report and the card's name and power limit;
2. holds each kernel to its plain PyTorch version on the card at the
   headline shape (C, N, H) = (10, 50000, 1000) and at a ragged N = 50001,
   printing the largest error against the stated tolerance, the median
   time of 20 launches (CUDA events, after warm-up), the plain version's
   time, the least time the card could take (bytes or operations over the
   card's peak rates) and, for the gather, the time of the PyTorch
   indexing expression that computes the same sum;
3. drives the main path — ``make_synthetic_task(0, H=1000, N=50000, C=10)``
   through ``run_seeds_compiled`` with CODA, 20 rounds, one seed — with
   every launch counter set to 0 just before and read just after, and
   checks that kernel 1 ran once (init) and kernels 2 and 3 once a round;
4. runs ``data/digits_h80.npz`` for 30 rounds on the kernel path and on the
   plain path and requires identical trajectories; runs ``data/digits.npz``
   for 100 rounds x 3 seeds and compares it with the reference package's
   committed record ``runs/surrogate_r17/exact`` (same key schedule; the
   rounds before the record's first near-tie must agree).

It prints one JSON line with every kernel, then the card's name and power
limit, and as its last line ``{"ok": true, "device": {...}}``. Any failed
check raises and the script exits non-zero; without a CUDA device, or
outside a checkout of the repository, it exits non-zero and prints no
result.
"""

from __future__ import annotations

import json
import math
import os
import statistics
import subprocess
import sys
import time
import traceback

HERE = os.path.dirname(os.path.abspath(__file__))
HEADLINE = (10, 50_000, 1000)        # (C, N, H)
RAGGED_N = 50_001
REPS = 20
SCORE_RTOL = 1e-4


def log(*args):
    print(*args, flush=True)


def smi_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60)
    if out.returncode != 0:
        raise RuntimeError(f"nvidia-smi failed: {out.stderr.strip()}")
    return out.stdout.strip().splitlines()[0]


def card_peaks(name: str) -> tuple[float, float]:
    """(memory bytes/s, fp32 non-tensor FLOP/s) of the card, from NVIDIA's
    data sheets (H100 SXM: 3.35 TB/s, 67 TFLOP/s)."""
    if "H200" in name:
        return 4.8e12, 67e12
    if "H100" in name and "PCIe" in name:
        return 2.0e12, 51e12
    if "H100" in name and "NVL" in name:
        return 3.9e12, 60e12
    return 3.35e12, 67e12


def time_ms(fn, reps: int = REPS, warmup: int = 3) -> float:
    """Median device time of one call, CUDA events around each call."""
    import torch

    for _ in range(warmup):
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


def bound(nbytes: float, nops: float, peaks) -> tuple[float, str]:
    t_bytes, t_ops = nbytes / peaks[0] * 1e3, nops / peaks[1] * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def score_atol(H: int) -> float:
    """Scores are differences of ~log2(H)-bit entropies, each a sum of H
    fp32 terms; two summation orders differ by about sqrt(H) ulps of the
    entropy, so the absolute tolerance is 4*sqrt(H)*2^-24*log2(H) (7.5e-5
    at H=1000), plus the reference's rtol 1e-4."""
    return 4 * math.sqrt(H) * 2.0 ** -24 * max(1.0, math.log2(H))


def random_cache(gen, C, N, H, dev):
    import torch

    def simplex(*shape):
        x = torch.rand(shape, generator=gen, device=dev) + 0.1
        return x / x.sum(-1, keepdim=True)

    rows, hyp, pi_xi, hyp_t = (simplex(C, H), simplex(C, N, H),
                               simplex(N, C), simplex(N, H))
    pi = pi_xi.mean(0)
    return rows, hyp, pi / pi.sum(), pi_xi, hyp_t


def phase_kernels(dev, peaks):
    """Kernels 1-3 against their plain versions at the headline and a
    ragged shape. Returns per-kernel records (times at the headline)."""
    import torch

    from coda_tpu_torch.ops import eig_kernels as ek
    from coda_tpu_torch.ops import gather_kernels as gk

    recs = {
        "eig_score": dict(source="coda_tpu_torch/csrc/eig_score.cu",
                          replaces="coda_tpu/ops/pallas_eig.py:163"),
        "eig_refresh_score": dict(source="coda_tpu_torch/csrc/eig_score.cu",
                                  replaces="coda_tpu/ops/pallas_eig.py:646"),
        "row_gather": dict(source="coda_tpu_torch/csrc/row_gather.cu",
                           replaces="coda_tpu/ops/pallas_gather.py:66"),
    }
    for r in recs.values():
        r["max_abs_err"] = 0.0
    gen = torch.Generator(device=dev)
    C, _, H = HEADLINE
    for N in (HEADLINE[1], RAGGED_N):
        headline = N == HEADLINE[1]
        gen.manual_seed(N)
        rows, hyp, pi, pi_xi, hyp_t = random_cache(gen, C, N, H, dev)
        atol = score_atol(H)

        # kernel 1
        got = ek.eig_scores_cache(rows, hyp, pi, pi_xi)
        want = ek.eig_scores_from_cache(rows, hyp, pi, pi_xi, chunk=1024)
        torch.cuda.synchronize()
        err = float((got - want).abs().max())
        torch.testing.assert_close(got, want, rtol=SCORE_RTOL, atol=atol)
        r = recs["eig_score"]
        r["max_abs_err"] = max(r["max_abs_err"], err)
        nbytes = 4 * (C * N * H + C * H + C + N * C + H + 1 + N)
        ms = time_ms(lambda: ek.eig_scores_cache(rows, hyp, pi, pi_xi))
        plain = time_ms(lambda: ek.eig_scores_from_cache(
            rows, hyp, pi, pi_xi, chunk=1024), reps=5)
        b, by = bound(nbytes, 8.0 * C * N * H, peaks)
        log(f"kernel eig_score N={N}: max_abs_err={err:.3e} "
            f"(tol atol={atol:.2e} rtol={SCORE_RTOL}) ms={ms:.4f} "
            f"plain_ms={plain:.4f} bound_ms={b:.4f} ({by})")
        if headline:
            r.update(ms=ms, plain_ms=plain, bound_ms=b, bound_by=by,
                     library_ms=None)

        # kernel 2: refresh row c in place, score; other rows untouched
        c_idx = C // 2
        c = torch.tensor(c_idx, dtype=torch.int32, device=dev)
        hyp_k = hyp.clone()
        got, _ = ek.eig_scores_refresh(rows, hyp_k, hyp_t, c, pi, pi_xi)
        hyp_p = hyp.clone()
        want, _ = ek.eig_scores_refresh_plain(rows, hyp_p, hyp_t, c, pi,
                                              pi_xi, chunk=1024)
        torch.cuda.synchronize()
        err = float((got - want).abs().max())
        torch.testing.assert_close(got, want, rtol=SCORE_RTOL, atol=atol)
        if not torch.equal(hyp_k[c_idx], hyp_t):
            raise AssertionError("refresh kernel: row c != hyp_t")
        others = [i for i in range(C) if i != c_idx]
        if not torch.equal(hyp_k[others], hyp[others]):
            raise AssertionError("refresh kernel touched another class row")
        if not torch.equal(hyp_k, hyp_p):
            raise AssertionError("refresh kernel cache != plain cache")
        del hyp_p
        r = recs["eig_refresh_score"]
        r["max_abs_err"] = max(r["max_abs_err"], err)
        nbytes = 4 * ((C - 1) * N * H + N * H + N * H + C * H + C + N * C
                      + H + 1 + N + 1)
        ms = time_ms(lambda: ek.eig_scores_refresh(rows, hyp_k, hyp_t, c, pi,
                                                   pi_xi))
        plain = time_ms(lambda: ek.eig_scores_refresh_plain(
            rows, hyp_k, hyp_t, c, pi, pi_xi, chunk=1024), reps=5)
        b, by = bound(nbytes, 8.0 * C * N * H, peaks)
        log(f"kernel eig_refresh_score N={N}: max_abs_err={err:.3e} "
            f"(tol atol={atol:.2e} rtol={SCORE_RTOL}) other rows bitwise "
            f"untouched ms={ms:.4f} plain_ms={plain:.4f} bound_ms={b:.4f} "
            f"({by})")
        if headline:
            r.update(ms=ms, plain_ms=plain, bound_ms=b, bound_by=by,
                     library_ms=None)
        del rows, hyp, hyp_k, hyp_t, pi, pi_xi

        # kernel 3: (C, H, N) row gather-sum
        pbc = torch.rand((C, H, N), generator=gen, device=dev)
        s = torch.randint(0, C, (H,), generator=gen, device=dev,
                          dtype=torch.int32)
        got = gk.gather_rows_sum(pbc, s)
        want = gk.gather_rows_sum_plain(pbc, s)
        torch.cuda.synchronize()
        err = float((got - want).abs().max())
        # H positive fp32 adds in two orders: |diff| <= H*2^-24*|sum|
        torch.testing.assert_close(got, want, rtol=H * 2.0 ** -24, atol=0)
        r = recs["row_gather"]
        r["max_abs_err"] = max(r["max_abs_err"], err)
        hidx = torch.arange(H, device=dev)
        s64 = s.long()
        ms = time_ms(lambda: gk.gather_rows_sum(pbc, s))
        plain = time_ms(lambda: gk.gather_rows_sum_plain(pbc, s))
        lib = time_ms(lambda: pbc[s64, hidx].sum(0))
        b, by = bound(4 * (H * N + H + N), float(H * N), peaks)
        log(f"kernel row_gather N={N}: max_abs_err={err:.3e} "
            f"(tol rtol={H * 2.0 ** -24:.2e}) ms={ms:.4f} plain_ms="
            f"{plain:.4f} library_ms={lib:.4f} bound_ms={b:.4f} ({by})")
        if headline:
            r.update(ms=ms, plain_ms=plain, bound_ms=b, bound_by=by,
                     library_ms=lib)
        del pbc
        torch.cuda.empty_cache()
    return recs


def reset_counts():
    from coda_tpu_torch.ops import eig_kernels as ek
    from coda_tpu_torch.ops import gather_kernels as gk

    for d in (ek.launch_counts, gk.launch_counts):
        for k in d:
            d[k] = 0


def read_counts() -> dict:
    from coda_tpu_torch.ops import eig_kernels as ek
    from coda_tpu_torch.ops import gather_kernels as gk

    return {**ek.launch_counts, **gk.launch_counts}


def phase_main_path(dev) -> dict:
    """The headline CODA run through the user's entry points."""
    import torch

    from coda_tpu_torch.data import make_synthetic_task
    from coda_tpu_torch.engine import run_seeds_compiled
    from coda_tpu_torch.selectors import CODAHyperparams, make_coda

    C, N, H = HEADLINE
    iters, seeds = 20, 1
    t0 = time.perf_counter()
    task = make_synthetic_task(0, H=H, N=N, C=C, device=dev)
    log(f"main path: synthetic task ({H}, {N}, {C}) built in "
        f"{time.perf_counter() - t0:.1f} s")
    hp = CODAHyperparams(eig_chunk=1024)
    timings = []
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_counts()
    res = run_seeds_compiled(lambda p: make_coda(p, hp, device=dev),
                             task.preds, task.labels, iters=iters,
                             seeds=seeds, device=dev, timings=timings)
    torch.cuda.synchronize()
    counts = read_counts()
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    want = {"eig_score": seeds, "eig_refresh_score": iters * seeds,
            "row_gather": iters * seeds}
    if counts != want:
        raise AssertionError(f"launch counts {counts}, expected {want}")
    regret = res.regret.cpu()
    idx = res.chosen_idx.cpu()
    if not (torch.isfinite(regret).all() and torch.isfinite(
            res.select_prob.cpu()).all()):
        raise AssertionError("non-finite regret or select_prob")
    if not ((idx >= 0).all() and (idx < N).all()
            and len(set(idx[0].tolist())) == iters):
        raise AssertionError(f"chosen indices out of range or repeated: {idx}")
    if (regret < 0).any():
        raise AssertionError("negative regret")
    init_ms = timings[0]["init_ms"]
    round_ms = timings[0]["rounds_ms"] / iters
    log(f"main path: init_ms={init_ms:.1f} ms_per_round={round_ms:.3f} "
        f"regret@{iters}={float(regret[0, -1]):.4f} "
        f"regret@0={float(res.regret_at_0[0]):.4f} "
        f"peak_mem_gb={peak_gb:.2f} launches={json.dumps(counts)}")
    return counts


def phase_parity(dev):
    """digits_h80: kernel path == plain path on the card; digits: agree
    with the reference package's committed record."""
    import numpy as np
    import torch

    from coda_tpu_torch import random as trandom
    from coda_tpu_torch.data import Dataset
    from coda_tpu_torch.engine import run_seeds_compiled
    from coda_tpu_torch.selectors import CODAHyperparams, make_coda

    ds = Dataset.from_file(os.path.join(HERE, "data", "digits_h80.npz"),
                           device=dev)
    runs = {}
    for backend in ("auto", "plain"):
        hp = CODAHyperparams(eig_chunk=1024, eig_backend=backend)
        runs[backend] = run_seeds_compiled(
            lambda p, hp=hp: make_coda(p, hp, device=dev), ds.preds,
            ds.labels, iters=30, seeds=1, device=dev)
    k, p = runs["auto"], runs["plain"]
    for f in ("chosen_idx", "true_class", "best_model", "regret"):
        if not torch.equal(getattr(k, f), getattr(p, f)):
            raise AssertionError(f"digits_h80 kernel vs plain: {f} differs")
    dprob = float((k.select_prob - p.select_prob).abs().max())
    if dprob > 1e-5:
        raise AssertionError(f"digits_h80 select_prob differs by {dprob}")
    log(f"parity digits_h80 {tuple(ds.shape)}: 30 rounds kernel == plain "
        f"(idx, class, best, regret identical; max |d select_prob|="
        f"{dprob:.3e} <= 1e-5), regret@30={float(k.regret[0, -1]):.4f}")

    rec = np.load(os.path.join(HERE, "runs", "surrogate_r17", "exact",
                               "rounds.npz"))
    ds = Dataset.from_file(os.path.join(HERE, "data", "digits.npz"),
                           device=dev)
    seeds, iters = rec["chosen_idx"].shape
    for s in range(seeds):
        k_scan = trandom.split(trandom.PRNGKey(s), 3)[2]
        if not np.array_equal(trandom.split(k_scan, iters).numpy(),
                              rec["round_key"][s].astype(np.int64)):
            raise AssertionError(f"round keys differ from the record, "
                                 f"seed {s}")
    res = run_seeds_compiled(
        lambda p: make_coda(p, CODAHyperparams(eig_chunk=1024), device=dev),
        ds.preds, ds.labels, iters=iters, seeds=seeds, device=dev)
    same = np.ones((seeds, iters), bool)
    for f in ("chosen_idx", "true_class", "best_model", "regret"):
        same &= getattr(res, f).cpu().numpy() == rec[f]
    agree = [int(np.argmin(r)) if not r.all() else iters for r in same]
    # the record's first round whose top-2 gap is below 1e-5: before it,
    # a difference is a port fault, not a near-tie
    clean = [int(np.argmax(g < 1e-5)) if (g < 1e-5).any() else iters
             for g in rec["runner_up_gap"]]
    if any(a < c for a, c in zip(agree, clean)):
        raise AssertionError(f"digits diverges from the reference record "
                             f"at rounds {agree} (near-tie-free prefix "
                             f"{clean})")
    log(f"reference record digits {tuple(ds.shape)}: rounds agreeing with "
        f"runs/surrogate_r17/exact per seed {agree} of {iters} "
        f"(required: the near-tie-free prefix {clean}); round keys equal")


def main() -> int:
    try:
        import torch
    except ImportError:
        print("chip_smoke: PyTorch is not installed", file=sys.stderr)
        return 2
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this script runs only on a GPU",
              file=sys.stderr)
        return 2
    if not os.path.isdir(os.path.join(HERE, "coda_tpu_torch", "csrc")):
        print("chip_smoke: run from a checkout of the repository (no "
              "coda_tpu_torch/csrc beside this script)", file=sys.stderr)
        return 2
    sys.path.insert(0, HERE)
    from coda_tpu_torch.ops import build
    from coda_tpu_torch.utils.platform import pin_fp32_matmul

    pin_fp32_matmul()
    dev = torch.device("cuda")
    name = torch.cuda.get_device_name(0)
    smi = smi_line()
    peaks = card_peaks(name)
    log(f"card: {smi} (torch {torch.__version__}, CUDA {torch.version.cuda}; "
        f"peaks used for bounds: {peaks[0] / 1e12:.2f} TB/s, "
        f"{peaks[1] / 1e12:.0f} TFLOP/s fp32)")
    phase = "build"
    try:
        info = build.build_all()
        log(f"build: {info['seconds']:.1f} s for {len(info['logs'])} "
            "libraries (nvcc -gencode arch=compute_90a,code=sm_90a)")
        for lib, text in info["logs"].items():
            for line in text.splitlines():
                if "registers" in line or "spill" in line:
                    log(f"  ptxas {lib}: {line.strip()}")
        phase = "kernels"
        recs = phase_kernels(dev, peaks)
        phase = "main path"
        counts = phase_main_path(dev)
        phase = "parity"
        phase_parity(dev)
    except Exception:
        traceback.print_exc()
        print(f"chip_smoke: phase '{phase}' FAILED", file=sys.stderr)
        return 1
    kernels = []
    for kname, r in recs.items():
        kernels.append({"name": kname, "route": "cuda", "source": r["source"],
                        "replaces": r["replaces"], "launches": counts[kname],
                        "max_abs_err": r["max_abs_err"], "ms": r["ms"],
                        "plain_ms": r["plain_ms"], "bound_ms": r["bound_ms"],
                        "bound_by": r["bound_by"],
                        "library_ms": r["library_ms"]})
    log(json.dumps({"kernels": kernels}))
    log(smi)
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name,
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
