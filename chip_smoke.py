#!/usr/bin/env python3
"""Chip smoke test of the PyTorch/CUDA port (``coda_tpu_torch``) on one GPU.

    python3 chip_smoke.py

Run from the root of a checkout on a machine with an NVIDIA H100 and the
CUDA toolkit. It imports nothing of JAX or of the ``coda_tpu`` package and:

1. builds the CUDA kernels from ``coda_tpu_torch/csrc`` (one ``nvcc`` per
   source, all started together) and prints the build time, the compiler's
   register/spill report and the card's name and power limit; then sweeps
   every fp32 p in [1e-12, 1] through the exact entropy's log term on the
   card and holds each to its contract, within 4 * 2^-24 * max(|t|, p) of
   t = p*log2(p) in float64 (beside it, the worst error of the full-precision
   ``logf`` term and of the bare ``lg2.approx``);
2. holds each kernel, in each flavour (fp32 or bf16 cache; exact or approx
   entropy), to its plain PyTorch version on the card at the headline
   shape (C, N, H) = (10, 50000, 1000) and at a ragged N = 50001, printing
   the largest error against the stated tolerance, the median time of 20
   launches (CUDA events, after warm-up), the plain version's time, the
   least time the card could take (bytes or operations over the card's
   peak rates) and, for the gather, the time of the PyTorch indexing
   expression that computes the same sum. Kernel 6 (the fused
   refresh-compute-score) also shows its row against the plain one, logs
   its tiling and shared memory, and runs once more at H = 4000 models
   (past its first design's shared-memory limit); its bound counts its
   products at the tensor cores' TF32 rate, as it runs them. The
   seed-batched kernels 4 and 5 and kernel 3 with a replica axis run at
   S = 5 replicas (the CLI's default seeds) of the same shapes, held to
   their plain versions and, bitwise, to kernels 1, 2 and 3 launched on
   each replica; kernel 3 and its batched form are also held bitwise to
   the in-order fp32 sum over models (``gather_rows_sum_inorder``, the
   Pallas kernel's accumulator);
3. drives the main path — ``make_synthetic_task(0, H=1000, N=50000, C=10)``
   through ``run_seeds_compiled`` with CODA, one seed — once per
   configuration of MAIN_PATHS: the reference's default (precomputed
   refresh, fp32 cache), its headline-speed configuration (fused refresh,
   bf16 cache) and the precomputed refresh over a bf16 cache for 20
   rounds each, every other flavour for 5.
   Each run has every launch counter set to 0 just before and read just
   after, and must have launched kernel 1 once (init), kernel 3 once a
   round and kernel 2 (precomputed) or kernel 6 (fused) once a round, in
   the run's flavour, and nothing else. Then the seed-batched engine, once
   per configuration of BATCHED_PATHS: 5 seeds in one batch
   (``eig_mode='incremental'``, precomputed refresh), fp32 exact for 20
   rounds and the other three flavours for 5, each of which must have
   launched kernel 4 once and kernel 5 and the batched kernel 3 once a
   round, and nothing else;
4. runs ``data/digits_h80.npz`` for 30 rounds on the kernel path and on the
   plain path, precomputed and fused, and requires identical trajectories;
   runs it for 100 rounds fused and precomputed on the kernels and requires
   the same chosen items and best models; runs it for 3 seeds x 30 rounds
   batched on the kernels, one seed after another on the kernels and
   batched on the plain versions, and requires identical trajectories;
   records ``data/digits.npz`` for 100 rounds x 3 seeds with the reference
   package's committed knobs, batched and one seed after another, into a
   temporary directory, holds each record to the schema and the committed
   dataset digest, and triages it against the committed record
   ``runs/surrogate_r17/exact`` with the port's ``compare_records`` at the
   cross-backend contract (2.34e-4): every seed must be at parity or
   diverge first as a ``tie-break-flip`` where the committed runner-up gap
   is at most 2.34e-4; each seed's triage line is printed;
5. runs the five baselines (IID, Uncertainty, ActiveTesting, VMA,
   ModelPicker) at the headline width, 1 seed x 20 rounds, twice each: the
   two runs must be identical; prints each one's init ms, ms per round
   (host clock) and peak memory; then runs each on ``digits_h80`` for 3
   seeds x 30 rounds on the card and on the CPU and triages the card's
   record against the CPU's as in 4;
6. records CODA at the headline with its default knobs, 1 seed x 20
   rounds, through the CLI's ``--record-dir`` into a temporary directory,
   holds the record to the schema and its decisions to the unrecorded
   run's, and prints the recording round's ms beside the unrecorded one.
   These runs are counted like the main path's (kernel 1 once, kernels 2
   and 3 once a round) and add to its launches;
7. the "tiers" phase, the rest of CODA, each run through
   ``run_seeds_recorded`` with the counters set to 0 just before and read
   just after: the paper's command at the headline (5 seeds in one batch,
   auto knobs, 5 rounds after an untimed one) must resolve to the
   factored tier and launch no kernel, its seed 0 bitwise a one-seed factored run, its round-0 scores
   within 2.34e-4 of the incremental tier's and its trajectories triaged
   against an ``eig_mode='incremental'`` batch; ``eig_precision`` high and
   default (2 rounds each: high bitwise highest, default's score and
   intermediate products' differences from highest, and TF32 off
   afterwards); rowscan at the headline (scores within 2.34e-4 of
   factored) and at the imagenet_sparse pool (500, 256, 1000) with 5
   seeds (auto must name rowscan); direct on ``digits_h80`` (3 seeds x 10
   rounds) triaged against factored; the pool's ``sparse:32`` and dense
   posteriors for 51 rounds on kernels 1-3, triaged against
   ``runs/imagenet_sparse_r12`` and held to them in every round with the
   records' items and labels forced (top-8 scores and posterior digests
   within 2.34e-4, the same best model, the sparse state bitwise a host
   mirror of its scatters; seeded labels that reach untracked columns
   drive the eviction and residual branches against the host mirror),
   ``sparse:1000`` bitwise dense and
   ``sparse:32`` fused on kernel 6 once a round; and at the headline, 1
   seed x 10 rounds, the amortized P(best) at multiplier 20 (kernel 2 once
   a round; the gate's engaged rounds; scores within 2.34e-4 of quad),
   ``pi_update=exact`` (kernel 3 never) triaged against delta,
   ``prefilter_n=4096`` (the factored tier) and the ``q`` ablations. Its
   launches add to the JSON line's. Every time and peak memory is
   printed.

8. the "batchq and surrogate" phase, each run with the counters set to 0
   just before and read just after, its launches checked and added to the
   JSON line's: at the headline, 1 seed, ``acq_batch`` q = 4 for 20 rounds
   and q = 8 for 10 (kernel 1 once a round and at init, kernel 3 q times
   a round, nothing else; ms per round and per label, peak memory, beside
   the q = 1 round), q = 4 in bf16 + approx and fused + bf16 (kernel 6
   and kernel 3 q times a round) for 5; 5 seeds at q = 4 for 5 rounds,
   one after another (kernel 1 once a round and at init, kernel 3 q times
   a round, for every seed; seed 0 bitwise the one-seed run), beside the
   5-seed q = 1 batch; ``data/digits.npz`` at q = 4 and q = 8 with
   ``runs/batchq_r14``'s knobs, triaged against those records (q4 against
   q1 by the acq-batch envelope); the five baselines at q = 4 on
   ``digits_h80``, card against CPU; the surrogate scorer
   (``surrogate:32``) on ``digits``, 3 seeds x 100 rounds, triaged
   against ``runs/surrogate_r17/surrogate`` and by the scorer envelope
   against ``.../exact``, kernel 1 once a full round; a donor session's
   pool prior seeding ``surrogate:16`` runs, triaged against
   ``runs/prior_r18`` and held to the reference's prior envelope; the
   surrogate's ms per round against the exact scorer's at the
   imagenet_sparse pool and the headline; and the CLI's tracking store in
   a temporary database, read back with the reference's analysis SQL,
   resumed ("Seed 0 finished. Skipping.") and re-logged with
   ``--force-rerun``. It prints the phase's wall time.
9. the "replay, checkpoint and suite" phase, each in-process run with the
   counters set to 0 just before and read just after, its launches
   checked and added to the JSON line's: three headline CODA records (1
   seed x 20 rounds with the default knobs; 5 seeds x 10 as one batch on
   the incremental tier, kernels 4, 5 and batched 3; ``--eig-refresh
   fused --eig-cache-dtype bfloat16``, 1 seed x 10, kernel 6), each
   re-executed by ``python -m coda_tpu_torch.cli replay`` in a subprocess
   (PARITY, bitwise, exit 0; its ms per round beside the recorded run's);
   the first record with one ``chosen_idx`` changed, replayed in-process
   (exit 2, DIVERGED at that round); ``runs/surrogate_r17/exact``
   re-executed on the card (each seed at parity or a ``tie-break-flip``
   within 2.34e-4); headline checkpoint runs (fp32 and bf16 CODA,
   ActiveTesting; 1 seed, every 10 rounds) cut after round 20 and resumed
   to 30, every trace bitwise the uninterrupted run, with a checkpoint's
   bytes and its save and restore seconds; the suite over ``data/`` (the
   six methods, 5 seeds x 50 rounds, ``runs/real.sqlite``'s sweep cut
   from 100 rounds) into
   a fresh database, its rerun skipping every pair, a 3-task x 2-seed x
   30-round subset under ``--task-batch --suite-devices 1`` bitwise the
   serial run, two pairs' rows bitwise the single-task CLI's, and a
   table of mean cumulative regret x100 at step 50 beside
   ``runs/real.sqlite``'s (information, not a gate). It prints the
   sweep's and the phase's wall time.
10. the "crowd and telemetry" phase, each in-process run with the
   counters set to 0 just before and read just after, its launches checked
   against the main path's for its configuration and added to the JSON
   line's: CODA at the headline under the reference's noisy crowd
   (``ROBUSTNESS_CPU_r18.json``'s spec) 1 seed x 20 rounds precomputed
   fp32 and fused bf16, 5 seeds x 10 as one batch (incremental) and q = 4
   x 5, each beside the clean run of its knobs (ms a round, peak memory)
   and the device events a round of crowd and clean (``torch.profiler``);
   ``digits_h80`` 3 seeds x 30 rounds under the noisy spec batched on the
   kernels, one seed after another and on the plain versions, identical
   with every ``CrowdAux`` array; the reference's reliability recovery
   (corr >= 0.8, mae <= 0.25, adversaries separated); the fused bf16 crowd
   run recorded, re-executed by ``cli replay`` in a subprocess (PARITY
   bitwise) and against a clean record the ``oracle-noise-envelope``
   within the reference's bounds; the CLI at the headline with
   ``--telemetry-dir`` and ``--profile-dir`` (the device peak of
   ``telemetry.json`` equal to ``torch.cuda.max_memory_allocated()``,
   ``metrics.prom`` clean by ``lint``, the ``load_dataset`` and
   ``experiment`` spans, kernels 1-3 in the profiler trace, each cost
   entry's bytes over those kernels' measured time under the card's
   memory rate), ms a round with telemetry off, on, and on with the
   profiler; and the suite with ``--telemetry-dir`` on a 2-task x
   2-method x 2-seed subset (spans on ``device:0``, the store flushed).

It prints one JSON line with every kernel flavour (its ``launches`` summed
over the main-path runs), then the card's name and power
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
SEEDS = 5                            # replicas of the batched kernels and
#                                      engine: the CLI's default --seeds
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


def card_peaks(name: str) -> tuple[float, float, float]:
    """(memory bytes/s, fp32 non-tensor FLOP/s, dense TF32 tensor FLOP/s)
    of the card, from the package's table
    (``coda_tpu_torch.telemetry.costs.CARD_PEAKS``, NVIDIA's data sheets;
    H100 SXM: 3.35 TB/s, 67 and 495 TFLOP/s, also for a name it lacks)."""
    from coda_tpu_torch.telemetry import costs

    return costs.card_peaks(name) or costs.card_peaks("H100")


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


def bound(nbytes: float, nops: float, peaks,
          tensor_ops: float = 0.0) -> tuple[float, str]:
    """The least time in ms (``costs.bound_ms``): bytes at the memory
    rate, or operations — ``nops`` on the fp32 CUDA cores and
    ``tensor_ops`` on the TF32 tensor cores, the two pipes overlapping —
    whichever is longer."""
    from coda_tpu_torch.telemetry import costs

    return costs.bound_ms(nbytes, nops, peaks, tensor_ops)


def work(kernel: str, *args, **kw) -> tuple[float, float, float]:
    """(bytes, fp32 ops, TF32 tensor ops) of one launch: the package's
    analytic model (``costs.kernel_work``), which the cost book reads
    too."""
    from coda_tpu_torch.telemetry import costs

    return costs.kernel_work(kernel, *args, **kw)


def score_atol(H: int) -> float:
    """Scores are differences of ~log2(H)-bit entropies, each a sum of H
    fp32 terms; two summation orders differ by about sqrt(H) ulps of the
    entropy, so the absolute tolerance is 4*sqrt(H)*2^-24*log2(H) (7.5e-5
    at H=1000), plus the reference's rtol 1e-4."""
    return 4 * math.sqrt(H) * 2.0 ** -24 * max(1.0, math.log2(H))


def random_cache(gen, C, N, H, dev, lead=()):
    """Random normalised (rows, hyp, pi, pi_xi, hyp_t), each with the
    leading axes ``lead`` (a batch of replicas)."""
    import torch

    def simplex(*shape):
        x = torch.rand((*lead, *shape), generator=gen, device=dev) + 0.1
        return x / x.sum(-1, keepdim=True)

    rows, hyp, pi_xi, hyp_t = (simplex(C, H), simplex(C, N, H),
                               simplex(N, C), simplex(N, H))
    pi = pi_xi.mean(-2)
    return rows, hyp, pi / pi.sum(-1, keepdim=True), pi_xi, hyp_t


FLAVOURS = [(dt, approx) for dt in ("float32", "bfloat16")
            for approx in (False, True)]
K6_RTOL, K6_ATOL = 1e-3, 2e-5        # kernel 6 scores: the reference's own
# kernel 6's fp32 row: the CPU tests' rtol 2e-5, and their atol 2e-6 (set
# for rows of H=10, elements about 0.1) scaled to elements about 1/H, so a
# product run at TF32 or bf16 fails
K6_ROW_RTOL = 2e-5


def _check_refresh_rows(hyp_k, hyp_p, hyp0, c_idx, C):
    """Kernel and plain cache after a refresh of row c: equal elsewhere,
    and equal to the input outside row c."""
    import torch

    others = [i for i in range(C) if i != c_idx]
    if not torch.equal(hyp_k[others], hyp0[others]):
        raise AssertionError("refresh kernel touched another class row")
    if not torch.equal(hyp_p[others], hyp0[others]):
        raise AssertionError("plain refresh touched another class row")


def _k12(dev, peaks, recs, N, dtype, approx, rows, hyp32, pi, pi_xi, hyp_t):
    """Kernels 1 and 2 in one flavour against their plain versions."""
    import torch

    from coda_tpu_torch.ops import eig_kernels as ek

    C, _, H = hyp32.shape
    headline = N == HEADLINE[1]
    tdt = getattr(torch, dtype)
    size = torch.finfo(tdt).bits // 8
    hyp = hyp32.to(tdt)
    atol = score_atol(H)
    tag = f"{dtype}{',approx' if approx else ''}"

    # kernel 1
    name = ek.flavour("eig_score", tdt, approx)
    got = ek.eig_scores_cache(rows, hyp, pi, pi_xi, approx=approx)
    want = ek.eig_scores_from_cache(rows, hyp, pi, pi_xi, chunk=1024,
                                    approx=approx)
    torch.cuda.synchronize()
    err = float((got - want).abs().max())
    torch.testing.assert_close(got, want, rtol=SCORE_RTOL, atol=atol)
    r = recs.setdefault(name, dict(
        source="coda_tpu_torch/csrc/eig_score.cu",
        replaces="coda_tpu/ops/pallas_eig.py:163", max_abs_err=0.0))
    r["max_abs_err"] = max(r["max_abs_err"], err)
    nbytes, nops, _ = work("eig_score", C, N, H, size)
    ms = time_ms(lambda: ek.eig_scores_cache(rows, hyp, pi, pi_xi,
                                             approx=approx))
    plain = time_ms(lambda: ek.eig_scores_from_cache(
        rows, hyp, pi, pi_xi, chunk=1024, approx=approx), reps=5)
    b, by = bound(nbytes, nops, peaks)
    log(f"kernel {name} N={N} ({tag}): max_abs_err={err:.3e} (tol atol="
        f"{atol:.2e} rtol={SCORE_RTOL}) ms={ms:.4f} plain_ms={plain:.4f} "
        f"bound_ms={b:.4f} ({by})")
    if headline:
        r.update(ms=ms, plain_ms=plain, bound_ms=b, bound_by=by,
                 library_ms=None)

    # kernel 2: refresh row c in place (rounded to the storage type), score
    name = ek.flavour("eig_refresh_score", tdt, approx)
    c_idx = C // 2
    c = torch.tensor(c_idx, dtype=torch.int32, device=dev)
    hyp_k = hyp.clone()
    got, _ = ek.eig_scores_refresh(rows, hyp_k, hyp_t, c, pi, pi_xi,
                                   approx=approx)
    hyp_p = hyp.clone()
    want, _ = ek.eig_scores_refresh_plain(rows, hyp_p, hyp_t, c, pi, pi_xi,
                                          chunk=1024, approx=approx)
    torch.cuda.synchronize()
    err = float((got - want).abs().max())
    torch.testing.assert_close(got, want, rtol=SCORE_RTOL, atol=atol)
    if not torch.equal(hyp_k[c_idx], hyp_t.to(tdt)):
        raise AssertionError("refresh kernel: row c != hyp_t rounded")
    _check_refresh_rows(hyp_k, hyp_p, hyp, c_idx, C)
    if not torch.equal(hyp_k, hyp_p):
        raise AssertionError("refresh kernel cache != plain cache")
    del hyp_p
    r = recs.setdefault(name, dict(
        source="coda_tpu_torch/csrc/eig_score.cu",
        replaces="coda_tpu/ops/pallas_eig.py:646", max_abs_err=0.0))
    r["max_abs_err"] = max(r["max_abs_err"], err)
    nbytes, nops, _ = work("eig_refresh_score", C, N, H, size)
    ms = time_ms(lambda: ek.eig_scores_refresh(rows, hyp_k, hyp_t, c, pi,
                                               pi_xi, approx=approx))
    plain = time_ms(lambda: ek.eig_scores_refresh_plain(
        rows, hyp_k, hyp_t, c, pi, pi_xi, chunk=1024, approx=approx), reps=5)
    b, by = bound(nbytes, nops, peaks)
    log(f"kernel {name} N={N} ({tag}): max_abs_err={err:.3e} (tol atol="
        f"{atol:.2e} rtol={SCORE_RTOL}) cache == plain cache, other rows "
        f"bitwise untouched ms={ms:.4f} plain_ms={plain:.4f} "
        f"bound_ms={b:.4f} ({by})")
    if headline:
        r.update(ms=ms, plain_ms=plain, bound_ms=b, bound_by=by,
                 library_ms=None)
    del hyp, hyp_k


def _bf16_boundary_count(row_k, row_p, row32_k, row32_p) -> int:
    """bf16 rows from kernel and plain: where they differ, by one ulp and
    only where their fp32 rows round differently. Returns that count."""
    import torch

    bk, bp = row_k.view(torch.int16), row_p.view(torch.int16)
    differ = bk != bp
    straddle = row32_k.to(torch.bfloat16).view(torch.int16) != \
        row32_p.to(torch.bfloat16).view(torch.int16)
    if (differ & ~straddle).any():
        raise AssertionError("bf16 rows differ off a rounding boundary")
    gap = (bk.to(torch.int32) - bp.to(torch.int32)).abs()
    if (gap[differ] != 1).any():
        raise AssertionError("bf16 rows differ by more than one ulp")
    return int(differ.sum())


def _k6(dev, peaks, recs, N, gen, rows0, hyp32, pi, pi_xi):
    """Kernel 6 in all four flavours against its plain version."""
    import torch

    from coda_tpu_torch.ops import eig_kernels as ek
    from coda_tpu_torch.ops.beta import dirichlet_to_beta
    from coda_tpu_torch.ops.pbest import compute_pbest

    C, _, H = hyp32.shape
    G = 256
    headline = N == HEADLINE[1]
    c_idx = C // 2
    c = torch.tensor(c_idx, dtype=torch.int32, device=dev)
    d = torch.rand((H, C, C), generator=gen, device=dev) * 3 + 0.5
    a, b = dirichlet_to_beta(d)
    a_t, b_t = a[:, c_idx].contiguous(), b[:, c_idx].contiguous()
    rows = rows0.clone()
    rows[c_idx] = compute_pbest(a_t, b_t)
    hard = torch.randint(0, C, (N, H), generator=gen, device=dev,
                         dtype=torch.int32)
    args = (a_t, b_t, hard, c, pi, pi_xi)
    # the operations the function needs on these inputs: the base product
    # densely and the diff product only where eq = hard == c is 1, in the
    # design's 3xTF32 on the tensor cores (three TF32 products each); S
    # only where eq is 1 and the scoring of C*N*H elements on the fp32
    # CUDA cores
    nnz = int((hard == c_idx).sum())
    lay = ek.refresh_compute_layout(C, H, G)
    log(f"kernel 6 layout at (C, H, G) = ({C}, {H}, {G}): "
        f"{lay['items_per_block']} items a block, products in chunks of "
        f"{lay['models_per_chunk']} models x {lay['points_per_stage']} grid "
        f"points a stage, {lay['smem_bytes']} bytes of shared memory a "
        f"block, {lay['blocks_per_sm']} blocks an SM, H up to "
        f"{lay['max_models']}")
    rows32 = {}
    for dtype, approx in FLAVOURS:
        tdt = getattr(torch, dtype)
        size = torch.finfo(tdt).bits // 8
        name = ek.flavour("eig_refresh_compute_score", tdt, approx)
        hyp = hyp32.to(tdt)
        hyp_k, hyp_p = hyp.clone(), hyp.clone()
        got, _ = ek.eig_scores_refresh_compute(rows, hyp_k, *args,
                                               approx=approx)
        want, _ = ek.eig_scores_refresh_compute_plain(rows, hyp_p, *args,
                                                      approx=approx,
                                                      chunk=1024)
        torch.cuda.synchronize()
        err = float((got - want).abs().max())
        atol = K6_ATOL + score_atol(H)
        torch.testing.assert_close(got, want, rtol=K6_RTOL, atol=atol)
        _check_refresh_rows(hyp_k, hyp_p, hyp, c_idx, C)
        row_k, row_p = hyp_k[c_idx], hyp_p[c_idx]
        if dtype == "float32":
            rows32[approx] = (row_k.clone(), row_p.clone())
            row_err = float((row_k - row_p).abs().max())
            rel = float(((row_k - row_p).abs() / row_p.abs().clamp_min(
                1e-30)).max())
            row_atol = K6_ROW_RTOL / H
            torch.testing.assert_close(row_k, row_p, rtol=K6_ROW_RTOL,
                                       atol=row_atol)
            row_note = (f"row max_abs_err={row_err:.3e} max_rel_err="
                        f"{rel:.3e} (tol rtol={K6_ROW_RTOL} atol="
                        f"{row_atol:.1e})")
        else:
            n_b = _bf16_boundary_count(row_k, row_p, *rows32[approx])
            row_note = (f"bf16 row == plain but for {n_b} of {N * H} "
                        "elements one ulp apart where the fp32 rows "
                        "straddle a rounding boundary")
        del hyp_p
        r = recs.setdefault(name, dict(
            source="coda_tpu_torch/csrc/eig_refresh_compute.cu",
            replaces="coda_tpu/ops/pallas_eig.py:320", max_abs_err=0.0))
        r["max_abs_err"] = max(r["max_abs_err"], err)
        nbytes, nops, tensor_ops = work("eig_refresh_compute_score", C, N,
                                        H, size, G=G, nnz=nnz)
        ms = time_ms(lambda: ek.eig_scores_refresh_compute(
            rows, hyp_k, *args, approx=approx))
        plain = time_ms(lambda: ek.eig_scores_refresh_compute_plain(
            rows, hyp_k, *args, approx=approx, chunk=1024), reps=5)
        b_ms, by = bound(nbytes, nops, peaks, tensor_ops)
        log(f"kernel {name} N={N}: max_abs_err={err:.3e} (tol atol="
            f"{atol:.2e} rtol={K6_RTOL}) {row_note}; other rows bitwise "
            f"untouched ms={ms:.4f} plain_ms={plain:.4f} bound_ms="
            f"{b_ms:.4f} ({by}; eq nonzeros {nnz} of {N * H})")
        if headline:
            r.update(ms=ms, plain_ms=plain, bound_ms=b_ms, bound_by=by,
                     library_ms=None)
        del hyp, hyp_k
    del hard


WIDE_H = 4000   # past the first kernel 6's shared-memory limit (~3,300)


def _k6_wide(dev, gen):
    """Kernel 6 at the headline's C and N with H = WIDE_H models (fp32
    cache, exact entropy) against its plain version: scores, the refreshed
    row, the other rows untouched."""
    import torch

    from coda_tpu_torch.ops import eig_kernels as ek
    from coda_tpu_torch.ops.beta import dirichlet_to_beta
    from coda_tpu_torch.ops.pbest import compute_pbest

    C, N, H = HEADLINE[0], HEADLINE[1], WIDE_H
    c_idx = C // 2
    c = torch.tensor(c_idx, dtype=torch.int32, device=dev)
    hyp = torch.rand((C, N, H), generator=gen, device=dev).add_(0.1)
    hyp.div_(hyp.sum(-1, keepdim=True))
    pi_xi = torch.rand((N, C), generator=gen, device=dev) + 0.1
    pi_xi /= pi_xi.sum(-1, keepdim=True)
    pi = pi_xi.mean(0)
    pi /= pi.sum()
    d = torch.rand((H, C, C), generator=gen, device=dev) * 3 + 0.5
    a, b = dirichlet_to_beta(d)
    a_t, b_t = a[:, c_idx].contiguous(), b[:, c_idx].contiguous()
    rows = compute_pbest(a.T, b.T)
    rows[c_idx] = compute_pbest(a_t, b_t)
    hard = torch.randint(0, C, (N, H), generator=gen, device=dev,
                         dtype=torch.int32)
    args = (a_t, b_t, hard, c, pi, pi_xi)
    hyp_k = hyp.clone()
    got, _ = ek.eig_scores_refresh_compute(rows, hyp_k, *args)
    torch.cuda.synchronize()
    hyp_p = hyp.clone()
    want, _ = ek.eig_scores_refresh_compute_plain(rows, hyp_p, *args,
                                                  chunk=256)
    torch.cuda.synchronize()
    atol = K6_ATOL + score_atol(H)
    torch.testing.assert_close(got, want, rtol=K6_RTOL, atol=atol)
    _check_refresh_rows(hyp_k, hyp_p, hyp, c_idx, C)
    row_rel = float(((hyp_k[c_idx] - hyp_p[c_idx]).abs()
                     / hyp_p[c_idx].abs().clamp_min(1e-30)).max())
    torch.testing.assert_close(hyp_k[c_idx], hyp_p[c_idx], rtol=K6_ROW_RTOL,
                               atol=K6_ROW_RTOL / H)
    del hyp, hyp_p
    ms = time_ms(lambda: ek.eig_scores_refresh_compute(rows, hyp_k, *args),
                 reps=5)
    log(f"kernel eig_refresh_compute_score (C, N, H) = ({C}, {N}, {H}): "
        f"max_abs_err={float((got - want).abs().max()):.3e} (tol atol="
        f"{atol:.2e} rtol={K6_RTOL}), row max_rel_err={row_rel:.3e} (tol "
        f"rtol={K6_ROW_RTOL} atol={K6_ROW_RTOL / H:.1e}), other rows "
        f"bitwise untouched, ms={ms:.4f}")
    del hyp_k, hard
    torch.cuda.empty_cache()


def _k45(dev, peaks, recs, N, gen):
    """Kernels 4 and 5 (the seed-batched kernels 1 and 2) in all four
    flavours at S = SEEDS replicas: against their plain versions, and
    bitwise against kernels 1 and 2 launched on each replica."""
    import torch

    from coda_tpu_torch.ops import eig_kernels as ek

    S, (C, _, H) = SEEDS, HEADLINE
    headline = N == HEADLINE[1]
    rows, hyp32, pi, pi_xi, hyp_t = random_cache(gen, C, N, H, dev, lead=(S,))
    # each replica refreshes its own class row
    cls = torch.tensor([(3 * s + 1) % C for s in range(S)],
                       dtype=torch.int32, device=dev)
    atol = score_atol(H)
    for dtype, approx in FLAVOURS:
        tdt = getattr(torch, dtype)
        size = torch.finfo(tdt).bits // 8
        hyp = hyp32.to(tdt)
        tag = f"S={S} N={N} ({dtype}{',approx' if approx else ''})"

        # kernel 4
        name = ek.flavour("eig_score_batched", tdt, approx)
        got = ek.eig_scores_cache_batched(rows, hyp, pi, pi_xi, approx=approx)
        want = ek.eig_scores_from_cache_batched(rows, hyp, pi, pi_xi,
                                                chunk=1024, approx=approx)
        one = torch.stack([ek.eig_scores_cache(rows[s], hyp[s], pi[s],
                                               pi_xi[s], approx=approx)
                           for s in range(S)])
        torch.cuda.synchronize()
        err = float((got - want).abs().max())
        torch.testing.assert_close(got, want, rtol=SCORE_RTOL, atol=atol)
        if not torch.equal(got, one):
            raise AssertionError(f"{name}: scores != kernel 1 per replica")
        r = recs.setdefault(name, dict(
            source="coda_tpu_torch/csrc/eig_score.cu",
            replaces="coda_tpu/ops/pallas_eig.py:556", max_abs_err=0.0))
        r["max_abs_err"] = max(r["max_abs_err"], err)
        nbytes, nops, _ = work("eig_score_batched", C, N, H, size, S)
        ms = time_ms(lambda: ek.eig_scores_cache_batched(rows, hyp, pi, pi_xi,
                                                         approx=approx))
        plain = time_ms(lambda: ek.eig_scores_from_cache_batched(
            rows, hyp, pi, pi_xi, chunk=1024, approx=approx), reps=5)
        b, by = bound(nbytes, nops, peaks)
        log(f"kernel {name} {tag}: max_abs_err={err:.3e} (tol atol="
            f"{atol:.2e} rtol={SCORE_RTOL}) == kernel 1 per replica bitwise "
            f"ms={ms:.4f} plain_ms={plain:.4f} bound_ms={b:.4f} ({by})")
        if headline:
            r.update(ms=ms, plain_ms=plain, bound_ms=b, bound_by=by,
                     library_ms=None)

        # kernel 5: replica s refreshes row cls[s] in place, then scores
        name = ek.flavour("eig_refresh_score_batched", tdt, approx)
        hyp_k, hyp_p, hyp_q = hyp.clone(), hyp.clone(), hyp.clone()
        got, _ = ek.eig_scores_refresh_batched(rows, hyp_k, hyp_t, cls, pi,
                                               pi_xi, approx=approx)
        want, _ = ek.eig_scores_refresh_batched_plain(
            rows, hyp_p, hyp_t, cls, pi, pi_xi, chunk=1024, approx=approx)
        one = torch.stack([ek.eig_scores_refresh(
            rows[s], hyp_q[s], hyp_t[s], cls[s], pi[s], pi_xi[s],
            approx=approx)[0] for s in range(S)])
        torch.cuda.synchronize()
        err = float((got - want).abs().max())
        torch.testing.assert_close(got, want, rtol=SCORE_RTOL, atol=atol)
        if not torch.equal(hyp_k, hyp_p):
            raise AssertionError(f"{name}: cache != plain cache")
        if not (torch.equal(got, one) and torch.equal(hyp_k, hyp_q)):
            raise AssertionError(f"{name}: scores or cache != kernel 2 per "
                                 "replica")
        for s in range(S):
            c_idx = int(cls[s])
            if not torch.equal(hyp_k[s, c_idx], hyp_t[s].to(tdt)):
                raise AssertionError(f"{name}: replica {s} row != hyp_t")
            _check_refresh_rows(hyp_k[s], hyp_p[s], hyp[s], c_idx, C)
        del hyp_p, hyp_q
        r = recs.setdefault(name, dict(
            source="coda_tpu_torch/csrc/eig_score.cu",
            replaces="coda_tpu/ops/pallas_eig.py:825", max_abs_err=0.0))
        r["max_abs_err"] = max(r["max_abs_err"], err)
        nbytes, nops, _ = work("eig_refresh_score_batched", C, N, H, size,
                               S)
        ms = time_ms(lambda: ek.eig_scores_refresh_batched(
            rows, hyp_k, hyp_t, cls, pi, pi_xi, approx=approx))
        plain = time_ms(lambda: ek.eig_scores_refresh_batched_plain(
            rows, hyp_k, hyp_t, cls, pi, pi_xi, chunk=1024, approx=approx),
            reps=5)
        b, by = bound(nbytes, nops, peaks)
        log(f"kernel {name} {tag}: max_abs_err={err:.3e} (tol atol="
            f"{atol:.2e} rtol={SCORE_RTOL}) cache == plain cache, == kernel 2 "
            f"per replica bitwise, other rows untouched ms={ms:.4f} "
            f"plain_ms={plain:.4f} bound_ms={b:.4f} ({by})")
        if headline:
            r.update(ms=ms, plain_ms=plain, bound_ms=b, bound_by=by,
                     library_ms=None)
        del hyp, hyp_k
        torch.cuda.empty_cache()
    del rows, hyp32, pi, pi_xi, hyp_t
    torch.cuda.empty_cache()


def _gather(dev, peaks, recs, N, gen):
    """Kernel 3, and kernel 3 with a replica axis at S = SEEDS (bitwise
    kernel 3 on each replica), against their plain versions."""
    import torch

    from coda_tpu_torch.ops import gather_kernels as gk

    S, (C, _, H) = SEEDS, HEADLINE
    headline = N == HEADLINE[1]
    pbc = torch.rand((C, H, N), generator=gen, device=dev)
    hidx = torch.arange(H, device=dev)
    s = torch.randint(0, C, (S, H), generator=gen, device=dev,
                      dtype=torch.int32)
    s64 = s.long()
    # H positive fp32 adds in two orders: |diff| <= H*2^-24*|sum|
    rtol = H * 2.0 ** -24
    for name, fn, plain_fn, lib_fn, sel in (
            ("row_gather", gk.gather_rows_sum, gk.gather_rows_sum_plain,
             lambda: pbc[s64[0], hidx].sum(0), s[0]),
            ("row_gather_batched", gk.gather_rows_sum_batched,
             gk.gather_rows_sum_batched_plain,
             lambda: pbc[s64, hidx].sum(1), s)):
        got = fn(pbc, sel)
        want = plain_fn(pbc, sel)
        inorder = gk.gather_rows_sum_inorder(pbc, sel)
        torch.cuda.synchronize()
        err = float((got - want).abs().max())
        torch.testing.assert_close(got, want, rtol=rtol, atol=0)
        # the kernel sums in h order from 0, as the Pallas kernel does
        if not torch.equal(got, inorder):
            raise AssertionError(f"{name}: != the in-order sum bitwise")
        note = "== the in-order sum bitwise, "
        if sel.dim() == 2:
            if not all(torch.equal(got[r], gk.gather_rows_sum(pbc, sel[r]))
                       for r in range(S)):
                raise AssertionError(f"{name}: != kernel 3 per replica")
            note += f"S={S}, == kernel 3 per replica bitwise, "
        r = recs.setdefault(name, dict(
            source="coda_tpu_torch/csrc/row_gather.cu",
            replaces="coda_tpu/ops/pallas_gather.py:66", max_abs_err=0.0))
        r["max_abs_err"] = max(r["max_abs_err"], err)
        ms = time_ms(lambda: fn(pbc, sel))
        plain = time_ms(lambda: plain_fn(pbc, sel))
        lib = time_ms(lib_fn)
        # the distinct (class, model) rows these classes select, each read
        # once, the classes and the output
        rows_needed = int(torch.unique(sel.long() * H + hidx).numel())
        b, by = bound(*work(name, C, N, H, S=sel.numel() // H,
                            rows=rows_needed)[:2], peaks)
        log(f"kernel {name} N={N}: {note}max_abs_err={err:.3e} (tol rtol="
            f"{rtol:.2e}) ms={ms:.4f} plain_ms={plain:.4f} library_ms="
            f"{lib:.4f} bound_ms={b:.4f} ({by}; {rows_needed} distinct rows)")
        if headline:
            r.update(ms=ms, plain_ms=plain, bound_ms=b, bound_by=by,
                     library_ms=lib)
    del pbc
    torch.cuda.empty_cache()


LOG_SWEEP_CHUNK = 1 << 25


def phase_log_sweep(dev) -> dict:
    """Every fp32 p in [1e-12, 1] through the exact flavour's log term on
    the card (``eig_plogp_sweep_launch``), held to its error contract
    against ``p * log2(p)`` in float64; beside it the full-precision
    ``logf(p) * log2(e) * p`` and the bare ``lg2.approx`` term, below and
    above the threshold where the exact flavour leaves the latter. Returns
    the worst error of each in units of the contract; fails if the exact
    term breaks it."""
    import numpy as np
    import torch

    from coda_tpu_torch.ops import eig_kernels as ek

    lo = int(np.float32(1e-12).view(np.int32))
    hi = int(np.float32(1.0).view(np.int32))
    wide = int(np.float32(0.0625).view(np.int32))
    worst = {"exact": 0.0, "logf": 0.0, "lg2 p<=1/16": 0.0, "lg2 p>1/16": 0.0}
    at = {}
    t0 = time.perf_counter()
    for start in range(lo, hi + 1, LOG_SWEEP_CHUNK):
        bits = torch.arange(start, min(start + LOG_SWEEP_CHUNK, hi + 1),
                            dtype=torch.int32, device=dev)
        p = bits.view(torch.float32)
        for form in ek.PLOGP_FORMS:
            ratio = ek.plogp_error_units(p, ek.plogp_terms(p, form))
            parts = ([(form, ratio, p)] if form != "lg2" else
                     [("lg2 p<=1/16", ratio[bits <= wide], p[bits <= wide]),
                      ("lg2 p>1/16", ratio[bits > wide], p[bits > wide])])
            for key, r, pp in parts:
                if r.numel() == 0:
                    continue
                m, i = r.max(0)
                if float(m) > worst[key]:
                    worst[key], at[key] = float(m), float(pp[i])
            del ratio
        del bits, p
    torch.cuda.synchronize()
    n = hi - lo + 1
    log(f"log-term sweep: {n} fp32 p in [1e-12, 1] in "
        f"{time.perf_counter() - t0:.1f} s; worst |t - p*log2(p)| in units "
        f"of {ek.PLOGP_CONTRACT_ULPS}*2^-24*max(|t|, p): "
        + ", ".join(f"{k} {v:.4f} (p={at.get(k, float('nan')):.6e})"
                    for k, v in worst.items()))
    if worst["exact"] > 1.0:
        raise AssertionError(f"the exact log term breaks its contract: "
                             f"{worst['exact']:.4f} units at p={at['exact']}")
    return worst


def phase_kernels(dev, peaks):
    """Every kernel, in every flavour, against its plain version at the
    headline and a ragged shape. Returns per-flavour records (times at the
    headline)."""
    import torch

    recs = {}
    gen = torch.Generator(device=dev)
    C, _, H = HEADLINE
    for N in (HEADLINE[1], RAGGED_N):
        gen.manual_seed(N)
        rows, hyp, pi, pi_xi, hyp_t = random_cache(gen, C, N, H, dev)
        for dtype, approx in FLAVOURS:
            _k12(dev, peaks, recs, N, dtype, approx, rows, hyp, pi, pi_xi,
                 hyp_t)
        del hyp_t
        torch.cuda.empty_cache()
        _k6(dev, peaks, recs, N, gen, rows, hyp, pi, pi_xi)
        del rows, hyp, pi, pi_xi
        torch.cuda.empty_cache()
        _k45(dev, peaks, recs, N, gen)
        _gather(dev, peaks, recs, N, gen)
    _k6_wide(dev, gen)
    return recs


def reset_counts():
    from coda_tpu_torch.ops import eig_kernels as ek
    from coda_tpu_torch.ops import gather_kernels as gk

    for d in (ek.launch_counts, gk.launch_counts):
        for k in d:
            d[k] = 0


def read_counts() -> tuple[dict, dict]:
    """(launches by kernel, launches by flavour) since the last reset; a
    kernel's count is the sum over its flavours."""
    from coda_tpu_torch.ops import eig_kernels as ek
    from coda_tpu_torch.ops import gather_kernels as gk

    by_flavour = {**ek.launch_counts, **gk.launch_counts}
    by_kernel = dict.fromkeys(("eig_score", "eig_refresh_score",
                               "eig_refresh_compute_score", "row_gather",
                               "eig_score_batched",
                               "eig_refresh_score_batched",
                               "row_gather_batched"), 0)
    for name, n in by_flavour.items():
        kernel = name.split("[")[0]
        by_kernel[kernel] = by_kernel.get(kernel, 0) + n
    return by_kernel, {k: n for k, n in by_flavour.items() if n}


# (eig_refresh, eig_cache_dtype, eig_entropy, rounds): the two headline
# configurations and the precomputed bf16 exact one (the path of kernel 2's
# bf16 flavour) at 20 rounds, then every other flavour at 5
_DEEP = (("precomputed", "float32", "exact"),
         ("precomputed", "bfloat16", "exact"), ("fused", "bfloat16", "exact"))
MAIN_PATHS = [(*k, 20) for k in _DEEP] + [
    (r, d, e, 5) for r in ("precomputed", "fused")
    for d in ("float32", "bfloat16") for e in ("exact", "approx")
    if (r, d, e) not in _DEEP]
# (eig_cache_dtype, eig_entropy, rounds) of the seed-batched engine
# (precomputed refresh, SEEDS seeds in one batch): the reference's default
# at 20 rounds, the other flavours at 5
BATCHED_PATHS = [("float32", "exact", 20), ("float32", "approx", 5),
                 ("bfloat16", "exact", 5), ("bfloat16", "approx", 5)]


def _check_run(res, config, iters, N):
    """Finite, in range, no item chosen twice by a seed, regret >= 0."""
    import torch

    regret = res.regret.cpu()
    idx = res.chosen_idx.cpu()
    if not (torch.isfinite(regret).all() and torch.isfinite(
            res.select_prob.cpu()).all()):
        raise AssertionError(f"{config}: non-finite regret or select_prob")
    if not ((idx >= 0).all() and (idx < N).all()
            and all(len(set(row.tolist())) == iters for row in idx)):
        raise AssertionError(f"{config}: chosen indices out of range or "
                             f"repeated: {idx}")
    if (regret < 0).any():
        raise AssertionError(f"{config}: negative regret")


def phase_main_path(dev, task) -> dict:
    """The headline CODA run through the user's entry points, once per
    configuration of MAIN_PATHS (one seed) and of BATCHED_PATHS (SEEDS
    seeds in one batch), each with the launch counters set to 0 just
    before and read just after. Returns the launches by flavour, summed
    over the runs."""
    import torch

    from coda_tpu_torch.engine import run_seeds_compiled
    from coda_tpu_torch.ops.eig_kernels import flavour
    from coda_tpu_torch.selectors import CODAHyperparams, make_coda

    C, N, H = HEADLINE
    seeds = 1
    total: dict = {}
    for refresh, dtype, entropy, iters in MAIN_PATHS:
        hp = CODAHyperparams(eig_chunk=1024, eig_refresh=refresh,
                             eig_cache_dtype=dtype, eig_entropy=entropy)
        timings = []
        torch.cuda.synchronize()
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        reset_counts()
        res = run_seeds_compiled(lambda p: make_coda(p, hp, device=dev),
                                 task.preds, task.labels, iters=iters,
                                 seeds=seeds, device=dev, timings=timings)
        torch.cuda.synchronize()
        counts, by_flavour = read_counts()
        peak_gb = torch.cuda.max_memory_allocated() / 1e9
        fused = refresh == "fused"
        refresh_kernel = ("eig_refresh_compute_score" if fused
                          else "eig_refresh_score")
        tdt, approx = getattr(torch, dtype), entropy == "approx"
        want = {flavour("eig_score", tdt, approx): seeds,
                flavour(refresh_kernel, tdt, approx): iters * seeds,
                "row_gather": iters * seeds}
        config = f"eig_refresh={refresh} eig_cache_dtype={dtype} " \
                 f"eig_entropy={entropy}"
        if by_flavour != want:
            raise AssertionError(f"{config}: launch counts {by_flavour}, "
                                 f"expected {want}")
        for k, v in by_flavour.items():
            total[k] = total.get(k, 0) + v
        _check_run(res, config, iters, N)
        regret = res.regret.cpu()
        init_ms = timings[0]["init_ms"]
        round_ms = timings[0]["rounds_ms"] / iters
        log(f"main path {config}, {iters} rounds: init_ms={init_ms:.1f} "
            f"ms_per_round={round_ms:.3f} "
            f"regret@{iters}={float(regret[0, -1]):.4f} "
            f"regret@0={float(res.regret_at_0[0]):.4f} "
            f"peak_mem_gb={peak_gb:.2f} launches={json.dumps(counts)}")
        del res

    # the seed-batched engine: SEEDS seeds in one round loop
    for dtype, entropy, iters in BATCHED_PATHS:
        hp = CODAHyperparams(eig_chunk=1024, eig_mode="incremental",
                             eig_cache_dtype=dtype, eig_entropy=entropy,
                             n_parallel=SEEDS)
        timings = []
        torch.cuda.synchronize()
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        reset_counts()
        res = run_seeds_compiled(lambda p: make_coda(p, hp, device=dev),
                                 task.preds, task.labels, iters=iters,
                                 seeds=SEEDS, device=dev, timings=timings)
        torch.cuda.synchronize()
        counts, by_flavour = read_counts()
        peak_gb = torch.cuda.max_memory_allocated() / 1e9
        tdt, approx = getattr(torch, dtype), entropy == "approx"
        want = {flavour("eig_score_batched", tdt, approx): 1,
                flavour("eig_refresh_score_batched", tdt, approx): iters,
                "row_gather_batched": iters}
        config = f"batched seeds={SEEDS} eig_cache_dtype={dtype} " \
                 f"eig_entropy={entropy}"
        if by_flavour != want or len(timings) != 1:
            raise AssertionError(f"{config}: launch counts {by_flavour}, "
                                 f"expected {want}; timings {timings}")
        for k, v in by_flavour.items():
            total[k] = total.get(k, 0) + v
        _check_run(res, config, iters, N)
        regret = res.regret.cpu()
        round_ms = timings[0]["rounds_ms"] / iters
        log(f"main path {config}, {iters} rounds: init_ms="
            f"{timings[0]['init_ms']:.1f} ms_per_round={round_ms:.3f} "
            f"ms_per_seed_round={round_ms / SEEDS:.3f} "
            f"regret@{iters} per seed="
            f"{[round(float(x), 4) for x in regret[:, -1]]} "
            f"regret@0={float(res.regret_at_0[0]):.4f} "
            f"peak_mem_gb={peak_gb:.2f} launches={json.dumps(counts)}")
        del res
    return total


def _same_run(a, b, fields, what):
    import torch

    for f in fields:
        if not torch.equal(getattr(a, f), getattr(b, f)):
            raise AssertionError(f"{what}: {f} differs")


def phase_parity(dev):
    """digits_h80: kernel path == plain path on the card, and the
    seed-batched engine == seeds one after another; digits: agree with the
    reference package's committed record, batched and one after another."""
    import dataclasses

    from coda_tpu_torch.data import Dataset
    from coda_tpu_torch.engine import run_seeds_compiled
    from coda_tpu_torch.selectors import CODAHyperparams, make_coda

    ds = Dataset.from_file(os.path.join(HERE, "data", "digits_h80.npz"),
                           device=dev)

    def run(iters, seeds=1, sequential=False, **kw):
        hp = CODAHyperparams(eig_chunk=1024, n_parallel=seeds, **kw)

        def factory(p):
            sel = make_coda(p, hp, device=dev)
            # without its batched form, the engine runs seeds one after
            # another
            return dataclasses.replace(sel, batched=None) if sequential \
                else sel

        return run_seeds_compiled(factory, ds.preds, ds.labels, iters=iters,
                                  seeds=seeds, device=dev)

    trajectory = ("chosen_idx", "true_class", "best_model", "regret")
    for refresh, tol in (("precomputed", 1e-5), ("fused", 1e-4)):
        k = run(30, eig_refresh=refresh)
        p = run(30, eig_refresh=refresh, eig_backend="plain")
        _same_run(k, p, trajectory,
                  f"digits_h80 {refresh} kernel vs plain")
        dprob = float((k.select_prob - p.select_prob).abs().max())
        if dprob > tol:
            raise AssertionError(f"digits_h80 {refresh} select_prob differs "
                                 f"by {dprob}")
        log(f"parity digits_h80 {tuple(ds.shape)} eig_refresh={refresh}: "
            f"30 rounds kernel == plain (idx, class, best, regret "
            f"identical; max |d select_prob|={dprob:.3e} <= {tol}), "
            f"regret@30={float(k.regret[0, -1]):.4f}")
    # the reference's long-horizon pin of the fused numerics
    # (test_fused_compute_long_horizon_widepool_trace), on the kernels
    f100, p100 = run(100, eig_refresh="fused"), run(100)
    _same_run(f100, p100, ("chosen_idx", "best_model"),
              "digits_h80 fused vs precomputed, 100 rounds")
    log(f"parity digits_h80: 100 rounds eig_refresh=fused == precomputed on "
        f"the kernels (chosen_idx, best_model identical), regret@100="
        f"{float(f100.regret[0, -1]):.4f}")
    # the seed-batched engine (kernels 4, 5 and the batched kernel 3)
    # against seeds one after another on the kernels and against the
    # batched plain versions
    reset_counts()
    b = run(30, seeds=3)
    counts, _ = read_counts()
    if (counts["eig_score_batched"], counts["eig_refresh_score_batched"],
            counts["row_gather_batched"]) != (1, 30, 30):
        raise AssertionError(f"digits_h80 batched run: launches {counts}")
    for other, what in ((run(30, seeds=3, sequential=True),
                         "one seed after another on the kernels"),
                        (run(30, seeds=3, eig_backend="plain"),
                         "batched on the plain versions")):
        _same_run(b, other, trajectory, f"digits_h80 batched vs {what}")
        dprob = float((b.select_prob - other.select_prob).abs().max())
        if dprob > 1e-5:
            raise AssertionError(f"digits_h80 batched vs {what}: "
                                 f"select_prob differs by {dprob}")
        log(f"parity digits_h80: 3 seeds x 30 rounds batched on the kernels "
            f"== {what} (idx, class, best, regret identical; max |d "
            f"select_prob|={dprob:.3e} <= 1e-05)")

    phase_digits_triage(dev)


def _save_and_load(res, aux, ds, dev, out_dir, run, knobs):
    """Write ``(res, aux)`` as a record under ``out_dir`` the way
    ``--record-dir`` does, read it back and hold it to the schema."""
    from coda_tpu_torch.telemetry.recorder import (
        RunRecord,
        environment_fingerprint,
    )

    RunRecord.from_result(
        res, aux, environment_fingerprint(dataset=ds, knobs=knobs,
                                          device=dev), run=run).save(out_dir)
    rec = RunRecord.load(out_dir)
    bad = rec.violations()
    if bad:
        raise AssertionError(f"record {out_dir} breaks the schema: {bad}")
    return rec


def _triage(got, ref, what: str, tol: float) -> list:
    """The port's triage of ``got`` against ``ref``: every seed at parity,
    or first diverging as a ``tie-break-flip`` (at q > 1 also a near tie
    of a round's first pick, ``replay.first_pick_flip``) where ``ref``'s
    runner-up gap is at most ``tol``. Prints each seed's line; returns
    them."""
    from coda_tpu_torch.engine.replay import compare_records, first_pick_flip

    report = compare_records(got, ref, score_tol=tol)
    lines, bad = [], []
    for s in report.seeds:
        if s.parity:
            line = f"seed {s.seed}: PARITY ({got.rounds} rounds)"
        else:
            t0 = s.first_divergent_round
            gap = float(ref.arrays["runner_up_gap"][s.seed, t0])
            tie = s.classification == "tie-break-flip"
            first = (not tie and ref.acq_batch > 1
                     and first_pick_flip(ref, got, s.seed, t0, tol))
            flip = tie or first
            note = ", a first-pick near tie" if first else ""
            line = (f"seed {s.seed}: first divergence at round {t0}, "
                    f"{s.quantity} [{s.classification}{note}], recorded "
                    f"runner-up gap {gap:.3e}")
            if not flip or abs(gap) > tol:
                bad.append(line)
        lines.append(line)
        log(f"triage {what}: {line}")
    if bad:
        raise AssertionError(f"{what}: divergence not a near-tie flip: "
                             f"{bad}")
    return lines


def phase_digits_triage(dev):
    """digits (14, 899, 10), 100 rounds x 3 seeds with the committed
    record's knobs, batched and one seed after another on the kernels:
    each recorded, and triaged against the reference package's committed
    record ``runs/surrogate_r17/exact`` at the cross-backend contract."""
    import dataclasses
    import tempfile

    from coda_tpu_torch.data import Dataset
    from coda_tpu_torch.engine import run_seeds_recorded
    from coda_tpu_torch.selectors import CODAHyperparams, make_coda
    from coda_tpu_torch.telemetry.recorder import (
        CROSS_BACKEND_SCORE_TOL,
        RunRecord,
    )

    ref = RunRecord.load(os.path.join(HERE, "runs", "surrogate_r17",
                                      "exact"))
    ds = Dataset.from_file(os.path.join(HERE, "data", "digits.npz"),
                           device=dev)
    seeds, iters = ref.seeds, ref.rounds
    want_digest = ref.meta["fingerprint"]["dataset"]["digest"]
    run = {"task": ds.name, "synthetic": None, "data_dir": "data",
           "method": "coda", "loss": "acc", "iters": iters, "seeds": seeds,
           "acq_batch": 1}
    with tempfile.TemporaryDirectory() as tmp:
        for sequential, how in ((False, "seeds batched"),
                                (True, "one seed after another")):
            hp = CODAHyperparams(eig_chunk=1024,
                                 n_parallel=1 if sequential else seeds)

            def factory(p):
                sel = make_coda(p, hp, device=dev)
                return dataclasses.replace(sel, batched=None) \
                    if sequential else sel

            reset_counts()
            res, aux = run_seeds_recorded(factory, ds.preds, ds.labels,
                                          iters=iters, seeds=seeds,
                                          device=dev)
            counts, _ = read_counts()
            k1, k2, k3 = (("eig_score", "eig_refresh_score", "row_gather")
                          if sequential else
                          ("eig_score_batched", "eig_refresh_score_batched",
                           "row_gather_batched"))
            n = seeds if sequential else 1
            if (counts[k1], counts[k2], counts[k3]) != (n, n * iters,
                                                        n * iters):
                raise AssertionError(f"digits ({how}): launches {counts}")
            got = _save_and_load(
                res, aux, ds, dev, os.path.join(tmp, how.replace(" ", "_")),
                run, {"method": "coda", "eig_chunk": 1024, "seeds": seeds,
                      "n_parallel": hp.n_parallel})
            digest = got.meta["fingerprint"]["dataset"]["digest"]
            if digest != want_digest:
                raise AssertionError(f"digits digest {digest} != the "
                                     f"record's {want_digest}")
            _triage(got, ref, f"digits {tuple(ds.shape)} ({how}) vs "
                    "runs/surrogate_r17/exact", CROSS_BACKEND_SCORE_TOL)
    log(f"reference record digits: dataset digest {want_digest}, schema "
        f"v{got.meta['schema_version']} record clean, every seed at parity "
        "or a near-tie flip")


BASELINE_ROUNDS = 20
H80_SEEDS, H80_ROUNDS = 3, 30


def _baseline_factory(method, iters, dev):
    from coda_tpu_torch.selectors import DEFAULT_EPS, SELECTOR_FACTORIES

    kw = ({"budget": iters} if method in ("activetesting", "vma") else
          {"epsilon": DEFAULT_EPS} if method == "model_picker" else {})
    return lambda p: SELECTOR_FACTORIES[method](p, device=dev, **kw)


BASELINES = ("iid", "uncertainty", "activetesting", "vma", "model_picker")


def phase_baselines(dev, task) -> dict:
    """The five baselines at the headline width, 1 seed x BASELINE_ROUNDS
    rounds on the card, twice in one process (identical trajectories);
    then on digits_h80, 3 seeds x 30 rounds on the card and on the CPU,
    triaged. Returns {method: (init_ms, ms_per_round, peak_gb)} of the
    second headline run. None of them launches a kernel of this repo."""
    import numpy as np
    import torch

    from coda_tpu_torch.data import Dataset
    from coda_tpu_torch.engine import run_seeds_compiled, run_seeds_recorded
    from coda_tpu_torch.telemetry.recorder import (
        CROSS_BACKEND_SCORE_TOL,
        RunRecord,
    )

    C, N, H = HEADLINE
    iters = BASELINE_ROUNDS
    fields = ("chosen_idx", "true_class", "best_model", "regret",
              "select_prob", "regret_at_0", "stochastic")
    out = {}
    for method in BASELINES:
        runs, timings = [], []
        for _ in range(2):
            torch.cuda.synchronize()
            torch.cuda.empty_cache()
            torch.cuda.reset_peak_memory_stats()
            timings.clear()
            reset_counts()
            res = run_seeds_compiled(_baseline_factory(method, iters, dev),
                                     task.preds, task.labels, iters=iters,
                                     seeds=1, device=dev, timings=timings)
            torch.cuda.synchronize()
            _, by_flavour = read_counts()
            if by_flavour:
                raise AssertionError(f"{method}: launched {by_flavour}")
            _check_run(res, method, iters, N)
            runs.append(res)
        _same_run(runs[0], runs[1], fields, f"{method} headline, run 1 vs 2")
        peak_gb = torch.cuda.max_memory_allocated() / 1e9
        init_ms = timings[0]["init_ms"]
        round_ms = timings[0]["rounds_ms"] / iters
        out[method] = (init_ms, round_ms, peak_gb)
        log(f"baseline {method} ({H}, {N}, {C}), 1 seed x {iters} rounds: "
            f"two runs identical; second run init_ms={init_ms:.2f} "
            f"ms_per_round={round_ms:.3f} peak_mem_gb={peak_gb:.3f} "
            f"regret@{iters}={float(runs[1].regret[0, -1]):.4f}")
        del runs, res

    ds = {d: Dataset.from_file(os.path.join(HERE, "data", "digits_h80.npz"),
                               device=d) for d in (dev, "cpu")}
    for method in BASELINES:
        recs = {}
        for d in (dev, "cpu"):
            res, aux = run_seeds_recorded(
                _baseline_factory(method, H80_ROUNDS, d), ds[d].preds,
                ds[d].labels, iters=H80_ROUNDS, seeds=H80_SEEDS, device=d)
            recs[d] = RunRecord.from_result(res, aux, {}, {})
        lines = _triage(recs[dev], recs["cpu"],
                        f"digits_h80 {method} card vs CPU",
                        CROSS_BACKEND_SCORE_TOL)
        a, b = recs[dev].arrays, recs["cpu"].arrays
        # regrets are differences of mean losses over N, which the card
        # and the CPU sum in other orders
        same = all(np.array_equal(a[f], b[f]) for f in (
            "chosen_idx", "true_class", "best_model")) and np.allclose(
                a["regret"], b["regret"], rtol=0, atol=1e-6)
        log(f"baseline {method} digits_h80 {tuple(ds['cpu'].shape)}, "
            f"{H80_SEEDS} seeds x {H80_ROUNDS} rounds: card vs CPU "
            f"trajectories {'identical' if same else 'triaged'} "
            f"({'; '.join(lines)})")
    return out


def phase_recorded(dev, task, total: dict) -> None:
    """CODA at the headline with its default knobs, 1 seed x 20 rounds:
    unrecorded, then recorded through the CLI's ``--record-dir`` into a
    temporary directory (the record held to the schema and to the
    unrecorded trajectory), then recorded through ``run_seeds_recorded``
    for the recording round's time. Each run's launches are counted and
    added to ``total``."""
    import tempfile

    import numpy as np
    import torch

    from coda_tpu_torch import cli
    from coda_tpu_torch.engine import run_seeds_compiled, run_seeds_recorded
    from coda_tpu_torch.ops.eig_kernels import flavour
    from coda_tpu_torch.selectors import CODAHyperparams, make_coda
    from coda_tpu_torch.telemetry.recorder import RunRecord

    C, N, H = HEADLINE
    iters = 20
    hp = CODAHyperparams(eig_chunk=1024)
    want = {flavour("eig_score", torch.float32, False): 1,
            flavour("eig_refresh_score", torch.float32, False): iters,
            "row_gather": iters}

    def counted(what, fn):
        torch.cuda.synchronize()
        reset_counts()
        out = fn()
        torch.cuda.synchronize()
        _, by_flavour = read_counts()
        if by_flavour != want:
            raise AssertionError(f"{what}: launches {by_flavour}, expected "
                                 f"{want}")
        for k, v in by_flavour.items():
            total[k] = total.get(k, 0) + v
        return out

    with tempfile.TemporaryDirectory() as tmp:
        out_dir = os.path.join(tmp, "record")
        counted("recorded run (CLI --record-dir)", lambda: cli.main([
            "--synthetic", f"{H},{N},{C}", "--method", "coda", "--iters",
            str(iters), "--seeds", "1", "--record-dir", out_dir,
            "--no-mlflow"]))
        rec = RunRecord.load(out_dir)
        bad = rec.violations()
        if bad:
            raise AssertionError(f"the CLI's record breaks the schema: {bad}")
    t_plain, t_rec = [], []
    plain = counted("unrecorded run", lambda: run_seeds_compiled(
        lambda p: make_coda(p, hp, device=dev), task.preds, task.labels,
        iters=iters, seeds=1, device=dev, timings=t_plain))
    res, aux = counted("recorded run", lambda: run_seeds_recorded(
        lambda p: make_coda(p, hp, device=dev), task.preds, task.labels,
        iters=iters, seeds=1, device=dev, timings=t_rec))
    for f in ("chosen_idx", "best_model", "regret"):
        if not (np.array_equal(rec.arrays[f], getattr(plain, f).cpu().numpy())
                and torch.equal(getattr(res, f), getattr(plain, f))):
            raise AssertionError(f"recording changed {f}")
    top = aux.trace.topk_score[0].cpu()
    if not torch.allclose(aux.trace.chosen_score[0].cpu(),
                          res.select_prob[0].cpu()):
        raise AssertionError("recorded chosen score != select_prob")
    log(f"recorded CODA ({H}, {N}, {C}), 1 seed x {iters} rounds: CLI "
        f"--record-dir record clean (schema v{rec.meta['schema_version']}, "
        f"digest {rec.meta['fingerprint']['dataset']['digest']}); chosen_idx, "
        f"best_model, regret == the unrecorded run's; ms_per_round "
        f"recorded={t_rec[0]['rounds_ms'] / iters:.3f} unrecorded="
        f"{t_plain[0]['rounds_ms'] / iters:.3f}; init_ms recorded="
        f"{t_rec[0]['init_ms']:.1f} unrecorded={t_plain[0]['init_ms']:.1f}; "
        f"round-0 top-2 scores {top[0, :2].tolist()}")
    del plain, res, aux


# -- the rest of CODA: the EIG tiers and knobs ------------------------------

TIER_ROUNDS = 5                    # the headline's 5-seed factored batch
SPARSE_POOL = (500, 256, 1000)     # (H, N, C): scripts/imagenet_sparse.py
SPARSE_ROUNDS, SPARSE_CHUNK = 51, 64
REST_ROUNDS = 10
CONTRACT = 2.34e-4                 # the cross-backend score contract


def _tier_run(dev, task, iters, seeds, what, total=None, want=None,
              warmup=False, **knobs):
    """One recorded CODA run through ``run_seeds_recorded``, counters set
    to 0 just before and read just after; ``want`` (launches by flavour)
    is checked and added to ``total``. ``warmup`` runs one untimed round
    of the same configuration first (the first products of a shape load
    their cuBLAS kernels and grow the allocator's pool), so the timed
    window does not depend on which phases ran before it. Returns
    ``(record, timings, peak_gb, resolved eig_mode)``; the selector is
    dropped, so a later run's peak memory is its own."""
    import torch

    from coda_tpu_torch.engine import run_seeds_recorded
    from coda_tpu_torch.selectors import CODAHyperparams, make_coda
    from coda_tpu_torch.telemetry.recorder import RunRecord

    knobs.setdefault("eig_chunk", 1024)
    hp = CODAHyperparams(n_parallel=seeds, **knobs)
    sels, timings = [], []

    def factory(p):
        sels.append(make_coda(p, hp, device=dev))
        return sels[-1]

    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    if warmup:
        run_seeds_recorded(factory, task.preds, task.labels, iters=1,
                           seeds=seeds, device=dev)
        torch.cuda.synchronize()
        sels.clear()
    torch.cuda.reset_peak_memory_stats()
    reset_counts()
    res, aux = run_seeds_recorded(factory, task.preds, task.labels,
                                  iters=iters, seeds=seeds, device=dev,
                                  timings=timings)
    torch.cuda.synchronize()
    _, by_flavour = read_counts()
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    if want is not None:
        if by_flavour != want:
            raise AssertionError(f"{what}: launches {by_flavour}, expected "
                                 f"{want}")
        for k, v in by_flavour.items():
            total[k] = total.get(k, 0) + v
    _check_run(res, what, iters, task.preds.shape[1])
    rec = RunRecord.from_result(res, aux, {}, {})
    return rec, timings, peak_gb, sels[0].extras["eig_mode"]


def _round_ms(timings, iters) -> float:
    return sum(t["rounds_ms"] for t in timings) / iters


def _same_record(a, b, what, seed_a=None):
    import numpy as np

    for f, arr in b.arrays.items():
        got = a.arrays[f] if seed_a is None else a.arrays[f][seed_a:seed_a + 1]
        if not np.array_equal(got, arr, equal_nan=True):
            raise AssertionError(f"{what}: {f} differs")


def _first_scores(sel, state, key):
    """The round-0 score vector of a selector's state (candidates only)."""
    import torch

    res = sel.select(state, key)
    s = res.scores
    return torch.where(torch.isfinite(s), s, torch.zeros_like(s))


def _score_gap(a, b) -> float:
    return float((a - b).abs().max())


def _precision_products(sel, state, precision: str, block: int = 1024):
    """The factored tier's intermediate products for the first ``block``
    items of every class row, on ``state``'s posterior, at an
    ``eig_precision``: ``(S, t_base, hyp)``, S the exclusive log-cdf sum
    ``(C, B, G)``, t_base the base product ``(C, B, H)`` and hyp the
    normalised hypothetical rows, each from its own precision's
    predecessors, as the tier computes them."""
    import torch

    from coda_tpu_torch.ops.pbest import (_bump_tables,
                                          _pbest_hyp_from_tables,
                                          _trapz_weights, eig_matmul,
                                          pbest_grid)
    from coda_tpu_torch.selectors.coda import _beta_rows, _class_eq

    hard = sel.extras["hard_preds"]
    aT, bT = _beta_rows(state.dirichlets)
    C, G = aT.shape[0], 256
    x = pbest_grid(G, aT.device)
    dx = x[1] - x[0]
    w = _trapz_weights(G, dx)
    tables = _bump_tables(aT, bT, x, dx, 1.0)
    S0, dlog, F_u, _ = tables
    eq = _class_eq(hard[:block], torch.arange(C, dtype=hard.dtype,
                                              device=hard.device))
    S = S0.unsqueeze(-2) + eig_matmul(eq, dlog, precision)
    wE = w * torch.exp(S - S.amax(-1, keepdim=True))
    t_base = eig_matmul(wE, F_u.transpose(-1, -2), precision)
    return S, t_base, _pbest_hyp_from_tables(tables, eq, w, precision)


def _forced_replay(dev, task, ref, **knobs) -> dict:
    """A one-seed run with a committed record's items and labels forced on
    it: each round scores the posterior the record's run had reached, then
    takes the record's item and label. Returns the largest |difference|
    from the record over every round of the top-k scores, ``pbest_max``
    and ``pbest_entropy``, and the rounds whose best model differs. A
    sparse posterior is also mirrored on the host from the card's initial
    state through the same ``scatter_row`` calls: ``sparse_equal`` says
    whether the card's state after the last round is bitwise the host's,
    ``untracked`` counts the model updates that hit an untracked column
    (the eviction and residual branches of K < C)."""
    import numpy as np
    import torch

    from coda_tpu_torch import random as trandom
    from coda_tpu_torch.ops.masked import entropy2
    from coda_tpu_torch.ops.sparse_rows import SparseRows, scatter_row
    from coda_tpu_torch.selectors import CODAHyperparams, make_coda

    A = ref.arrays
    hp = CODAHyperparams(**knobs)
    sel = make_coda(task.preds, hp, device=dev)
    state = sel.init()
    hard = sel.extras["hard_preds"]
    host = (None if state.sparse is None
            else SparseRows(*(t.cpu().clone() for t in state.sparse)))
    k = A["topk_score"].shape[-1]
    worst = {"topk_score": 0.0, "pbest_max": 0.0, "pbest_entropy": 0.0}
    best_differs = untracked = 0
    for t in range(A["chosen_idx"].shape[1]):
        key = torch.from_numpy(A["round_key"][0, t].astype(np.int64)).to(dev)
        k_sel, k_best = trandom.split(key)
        res = sel.select(state, k_sel)
        top = torch.topk(res.scores.float(), k).values.cpu().numpy()
        idx = torch.tensor(int(A["chosen_idx"][0, t]), device=dev)
        state = sel.update(state, idx, task.labels.take(idx), res.prob)
        c = int(A["true_class"][0, t])
        if int(task.labels[idx]) != c:
            raise AssertionError(f"round {t}: the task's label differs "
                                 "from the record's")
        if host is not None:
            pred = hard[idx].cpu()
            hit = (host.idx[:, c, :] == pred[:, None].to(host.idx.dtype)
                   ).any(-1)
            untracked += int(((pred != c) & ~hit).sum())
            scatter_row(host, torch.tensor(c), pred, hp.learning_rate)
        best, _ = sel.best(state, k_best)
        best_differs += int(best) != int(A["best_model"][0, t])
        pb = sel.extras["get_pbest"](state).float()
        got = {"topk_score": top, "pbest_max": float(pb.max()),
               "pbest_entropy": float(entropy2(pb))}
        for q, v in got.items():
            d = float(np.max(np.abs(np.asarray(v) - A[q][0, t])))
            if not d <= worst[q]:
                worst[q] = d
    worst["best_model_rounds"] = best_differs
    if host is not None:
        worst["sparse_equal"] = all(torch.equal(a.cpu(), b) for a, b in
                                    zip(state.sparse, host))
        worst["untracked"] = untracked
    return worst


def _scatter_branches(dev, pool, spec: str, rounds: int = 192) -> tuple:
    """The K < C scatter on the card against a host mirror: ``rounds``
    labels of two classes with seeded model predictions (most of them
    untracked columns) scattered into the pool's sparse prior on the card
    and on the host, at increments of 1 and 1e-3 in turn: the unit ones
    evict the prior's entries until a row holds only larger ones, and
    then a small one goes to the residual.
    Returns ``(bitwise equal, updates that hit an untracked column,
    entries evicted, the fields that differ)``."""
    import numpy as np
    import torch

    from coda_tpu_torch.ops.sparse_rows import SparseRows, scatter_row
    from coda_tpu_torch.selectors import CODAHyperparams, make_coda

    card = make_coda(pool.preds, CODAHyperparams(
        eig_mode="incremental", eig_chunk=SPARSE_CHUNK, posterior=spec),
        device=dev).init().sparse
    host = SparseRows(*(t.cpu().clone() for t in card))
    H, C = host.diag.shape
    rng = np.random.default_rng(0)
    untracked = evicted = 0
    for t in range(rounds):
        lr = 1e-3 if t % 2 else 1.0
        c = int(rng.integers(2))
        pred = torch.from_numpy(rng.integers(C, size=H).astype(np.int32))
        hit = (host.idx[:, c, :] == pred[:, None]).any(-1)
        untracked += int(((pred != c) & ~hit).sum())
        before = host.idx[:, c, :].clone()
        scatter_row(card, torch.tensor(c, device=dev), pred.to(dev), lr)
        scatter_row(host, torch.tensor(c), pred, lr)
        evicted += int((host.idx[:, c, :] != before).sum())
    differ = [f for f, a, b in zip(SparseRows._fields, card, host)
              if not torch.equal(a.cpu(), b)]
    return not differ, untracked, evicted, differ


def phase_tiers(dev, task, total: dict) -> dict:
    """The rest of CODA on the card. The headline's CLI default (5 seeds
    in one batch, auto knobs) resolving to the factored tier and launching
    no kernel, held bitwise to a one-seed factored run and triaged against
    the incremental tier; eig_precision high/default; rowscan at the
    headline and at the imagenet_sparse pool; direct on digits_h80; the
    sparse posterior at the imagenet_sparse pool against the committed
    records; the amortized P(best), pi_update=exact, the prefilter and the
    q ablations at the headline. Returns the measured figures."""
    import numpy as np
    import torch

    from coda_tpu_torch import random as trandom
    from coda_tpu_torch.data import Dataset, make_synthetic_task
    from coda_tpu_torch.ops.eig_kernels import flavour
    from coda_tpu_torch.selectors import CODAHyperparams, make_coda
    from coda_tpu_torch.selectors.coda import row_beta
    from coda_tpu_torch.telemetry.recorder import RunRecord

    C, N, H = HEADLINE
    f32 = torch.float32
    out: dict = {}
    key0 = trandom.PRNGKey(0)

    # 1. the CLI default at the headline: 5 seeds, auto -> factored
    rec_f, tm, peak, mode = _tier_run(dev, task, TIER_ROUNDS, SEEDS,
                                      "factored headline", total, {},
                                      warmup=True)
    if mode != "factored":
        raise AssertionError(f"auto at the headline with {SEEDS} seeds "
                             f"resolved to {mode}")
    out["factored"] = (tm[0]["init_ms"], _round_ms(tm, TIER_ROUNDS), peak)
    log(f"tiers: headline ({H}, {N}, {C}), CLI default knobs, {SEEDS} seeds "
        f"in one batch x {TIER_ROUNDS} rounds after an untimed one: "
        f"eig_mode auto -> factored, "
        f"0 kernel launches; init_ms={tm[0]['init_ms']:.1f} "
        f"ms_per_round={out['factored'][1]:.3f} ms_per_seed_round="
        f"{out['factored'][1] / SEEDS:.3f} peak_mem_gb={peak:.2f}")
    one, _, _, _ = _tier_run(dev, task, TIER_ROUNDS, 1, "factored one seed",
                             total, {}, eig_mode="factored")
    _same_record(rec_f, one, "factored seed 0 of 5 vs one seed", seed_a=0)
    log("tiers: factored seed 0 of the 5-seed batch == the one-seed "
        "factored run (every recorded array bitwise)")
    rec_i, tmi, peak_i, _ = _tier_run(
        dev, task, TIER_ROUNDS, SEEDS, "incremental headline", total,
        {flavour("eig_score_batched", f32, False): 1,
         flavour("eig_refresh_score_batched", f32, False): TIER_ROUNDS,
         "row_gather_batched": TIER_ROUNDS}, eig_mode="incremental")
    out["incremental"] = (tmi[0]["init_ms"], _round_ms(tmi, TIER_ROUNDS),
                          peak_i)
    fac1 = make_coda(task.preds, CODAHyperparams(eig_mode="factored",
                                                 eig_chunk=1024), device=dev)
    inc1 = make_coda(task.preds, CODAHyperparams(eig_mode="incremental",
                                                 eig_chunk=1024), device=dev)
    s_f = _first_scores(fac1, fac1.init(), key0)
    gap = _score_gap(s_f, _first_scores(inc1, inc1.init(), key0))
    del inc1
    if gap > CONTRACT:
        raise AssertionError(f"round-0 scores factored vs incremental "
                             f"differ by {gap}")
    lines = _triage(rec_f, rec_i, "headline factored vs incremental",
                    CONTRACT)
    log(f"tiers: round-0 scores factored vs incremental max |d|={gap:.3e} "
        f"<= {CONTRACT}; incremental batch init_ms={tmi[0]['init_ms']:.1f} "
        f"ms_per_round={out['incremental'][1]:.3f} peak_mem_gb="
        f"{peak_i:.2f}; triage {'; '.join(lines)}")
    # high is the fp32 product on this card: bitwise highest; default's
    # one TF32 pass reaches the products, and the scores by as much as
    # the hypothetical rows' relative error times the scores' size
    st0 = fac1.init()
    ref_p = _precision_products(fac1, st0, "highest")
    for prec in ("high", "default"):
        selp = make_coda(task.preds, CODAHyperparams(
            eig_mode="factored", eig_chunk=1024, eig_precision=prec),
            device=dev)
        d = _score_gap(_first_scores(selp, selp.init(), key0), s_f)
        del selp
        dp = [float((p - r).abs().max() / r.abs().max())
              for p, r in zip(_precision_products(fac1, st0, prec), ref_p)]
        if prec == "high" and (d != 0.0 or max(dp) != 0.0):
            raise AssertionError(f"eig_precision=high is not the fp32 "
                                 f"product: scores {d}, products {dp}")
        if prec == "default" and min(dp) == 0.0:
            raise AssertionError("eig_precision=default left a product "
                                 f"in fp32: {dp}")
        _, tp, _, _ = _tier_run(dev, task, 2, SEEDS, f"factored {prec}",
                                total, {}, warmup=True, eig_precision=prec)
        out[f"precision_{prec}"] = (d, _round_ms(tp, 2), dp)
        if torch.backends.cuda.matmul.allow_tf32:
            raise AssertionError(f"eig_precision={prec} left TF32 on")
        log(f"tiers: eig_precision={prec} factored {SEEDS} seeds x 2 rounds "
            f"after an untimed one: round-0 max |d score| vs highest="
            f"{d:.3e} (scores up to {float(s_f.abs().max()):.4f}); "
            f"first 1024 items' products vs highest, max |d| / max |.|: "
            f"S {dp[0]:.3e}, t_base {dp[1]:.3e}, hypothetical rows "
            f"{dp[2]:.3e}; ms_per_round={out[f'precision_{prec}'][1]:.3f}; "
            f"allow_tf32 after: {torch.backends.cuda.matmul.allow_tf32}")
    del st0, ref_p
    del fac1

    # 2. rowscan: at the headline, then the imagenet_sparse pool
    rows1 = make_coda(task.preds, CODAHyperparams(eig_mode="rowscan",
                                                  eig_chunk=1024), device=dev)
    d = _score_gap(_first_scores(rows1, rows1.init(), key0), s_f)
    del rows1, s_f
    if d > CONTRACT:
        raise AssertionError(f"rowscan vs factored round-0 scores: {d}")
    _, tr, pr, _ = _tier_run(dev, task, 2, 1, "rowscan headline", total, {},
                             eig_mode="rowscan")
    log(f"tiers: rowscan headline 1 seed x 2 rounds: round-0 max |d score| "
        f"vs factored={d:.3e}; ms_per_round={_round_ms(tr, 2):.3f} "
        f"peak_mem_gb={pr:.2f}")
    Hs, Ns, Cs = SPARSE_POOL
    pool = make_synthetic_task(seed=5, H=Hs, N=Ns, C=Cs, device=dev)
    _, trs, prs, mode = _tier_run(dev, pool, 3, SEEDS, "rowscan pool", total,
                                  {}, warmup=True)
    if mode != "rowscan":
        raise AssertionError(f"auto at {SPARSE_POOL} with {SEEDS} seeds "
                             f"resolved to {mode}")
    out["rowscan_pool"] = (trs[0]["init_ms"], _round_ms(trs, 3), prs)
    log(f"tiers: imagenet_sparse pool {SPARSE_POOL}, {SEEDS} seeds x 3 "
        f"rounds after an untimed one: eig_mode auto -> rowscan; init_ms={trs[0]['init_ms']:.1f} "
        f"ms_per_round={out['rowscan_pool'][1]:.3f} peak_mem_gb={prs:.2f}")

    # 3. direct on digits_h80, triaged against factored
    h80 = Dataset.from_file(os.path.join(HERE, "data", "digits_h80.npz"),
                            device=dev)
    rd, td, _, _ = _tier_run(dev, h80, 10, 3, "direct digits_h80", total, {},
                             eig_mode="direct")
    rfa, _, _, _ = _tier_run(dev, h80, 10, 3, "factored digits_h80", total,
                             {}, eig_mode="factored")
    lines = _triage(rd, rfa, "digits_h80 direct vs factored", CONTRACT)
    out["direct_h80"] = _round_ms(td, 10)
    log(f"tiers: direct digits_h80 {tuple(h80.shape)} 3 seeds x 10 rounds: "
        f"ms_per_round={out['direct_h80']:.3f}; triage {'; '.join(lines)}")

    # 4. the sparse posterior at the imagenet_sparse pool
    sp_knobs = dict(eig_mode="incremental", eig_chunk=SPARSE_CHUNK)
    want1 = {flavour("eig_score", f32, False): 1,
             flavour("eig_refresh_score", f32, False): SPARSE_ROUNDS,
             "row_gather": SPARSE_ROUNDS}
    recs = {}
    for spec in ("sparse:32", "dense", f"sparse:{Cs}"):
        recs[spec], ts, ps, _ = _tier_run(dev, pool, SPARSE_ROUNDS, 1,
                                          f"pool {spec}", total, want1,
                                          posterior=spec, **sp_knobs)
        out[f"pool_{spec}"] = (_round_ms(ts, SPARSE_ROUNDS), ps)
        log(f"tiers: pool {spec} 1 seed x {SPARSE_ROUNDS} rounds on kernels "
            f"1-3: ms_per_round={out[f'pool_{spec}'][0]:.3f} "
            f"peak_mem_gb={ps:.2f}")
    refs = {}
    for spec, ref_dir in (("sparse:32", "sparse"), ("dense", "dense")):
        refs[spec] = RunRecord.load(os.path.join(
            HERE, "runs", "imagenet_sparse_r12", ref_dir))
        lines = _triage(recs[spec], refs[spec], f"pool {spec} vs runs/"
                        f"imagenet_sparse_r12/{ref_dir}", CONTRACT)
    # the triage stops at the first divergence (round 0, a tie): every
    # round is held by forcing the record's items and labels on the card's
    # run, each record with its own posterior and the sparse record with
    # the dense posterior too (what the truncation moves)
    for spec, ref_spec in (("sparse:32", "sparse:32"), ("dense", "dense"),
                           ("dense", "sparse:32")):
        w = _forced_replay(dev, pool, refs[ref_spec], posterior=spec,
                           **sp_knobs)
        if ref_spec == spec and (w["best_model_rounds"] or max(
                w[q] for q in ("topk_score", "pbest_max", "pbest_entropy"))
                > CONTRACT or not w.get("sparse_equal", True)):
            raise AssertionError(f"pool {spec} forced on the {ref_spec} "
                                 f"record: {w}")
        out[f"forced_{spec}_on_{ref_spec}"] = w
        log(f"tiers: pool {spec} with the runs/imagenet_sparse_r12 "
            f"{ref_spec} record's {SPARSE_ROUNDS} items and labels forced: "
            f"max |d| over every round: top-8 scores "
            f"{w['topk_score']:.3e}, pbest_max {w['pbest_max']:.3e}, "
            f"pbest_entropy {w['pbest_entropy']:.3e}; best model differs in "
            f"{w['best_model_rounds']} rounds"
            + ("" if "untracked" not in w else
               f"; {w['untracked']} model updates hit an untracked column "
               f"(eviction or residual), the card's sparse state after the "
               f"last round bitwise the host's scatter_row mirror: "
               f"{w['sparse_equal']}")
            + ("" if spec == ref_spec else " (not checked: another "
               "posterior)"))
    # the records' labels may never reach an untracked column: the
    # eviction and residual branches get seeded labels of their own
    same, miss, evicted, differ = _scatter_branches(dev, pool, "sparse:32")
    if not same or not evicted or miss == evicted:
        raise AssertionError(f"sparse:32 scatter on the card: fields "
                             f"differing from the host {differ}, untracked "
                             f"{miss}, evicted {evicted}")
    log(f"tiers: pool sparse:32 scatter_row, 192 seeded labels: {miss} "
        f"model updates hit an untracked column, {evicted} evicted a "
        f"tracked entry, the rest went to the residual; the card's state "
        f"bitwise the host's")
    _same_record(recs[f"sparse:{Cs}"], recs["dense"],
                 f"sparse:{Cs} vs dense on the card")
    log(f"tiers: sparse:{Cs} == dense on the card (every recorded array "
        "bitwise)")
    _tier_run(dev, pool, SPARSE_ROUNDS, 1, "pool sparse:32 fused", total,
              {flavour("eig_score", f32, False): 1,
               flavour("eig_refresh_compute_score", f32, False):
                   SPARSE_ROUNDS, "row_gather": SPARSE_ROUNDS},
              posterior="sparse:32", eig_refresh="fused", **sp_knobs)
    log(f"tiers: pool sparse:32 eig_refresh=fused: kernel 6 launched once a "
        f"round ({SPARSE_ROUNDS})")
    del pool

    # 5. the rest at the headline, 1 seed x REST_ROUNDS
    R = REST_ROUNDS
    inc_want = {flavour("eig_score", f32, False): 1,
                flavour("eig_refresh_score", f32, False): R,
                "row_gather": R}
    rq, _, _, _ = _tier_run(dev, task, R, 1, "quad multiplier 20", total,
                            inc_want, multiplier=20.0)
    # twice: the logistic-normal tables' special functions are compiled
    # at their first call on the card; the second run is timed
    for _ in range(2):
        ra, ta, _, _ = _tier_run(dev, task, R, 1, "amortized multiplier 20",
                                 total, inc_want, multiplier=20.0,
                                 eig_pbest="amortized")
    # the gate per round, from the recorded labels: min_h(a + b) of the
    # labelled row after its label, on the run's prior
    sela = make_coda(task.preds, CODAHyperparams(
        eig_mode="factored", multiplier=20.0), device=dev)
    st = sela.init()
    hard = sela.extras["hard_preds"]
    engaged = 0
    for t in range(R):
        c = torch.tensor(int(ra.arrays["true_class"][0, t]), device=dev)
        idx = int(ra.arrays["chosen_idx"][0, t])
        st.dirichlets[torch.arange(H, device=dev), c,
                      hard[idx].long()] += 0.01
        a_t, b_t = row_beta(st.dirichlets, c)
        engaged += int(float((a_t + b_t).min()) >= 32.0)
    del st, sela, hard
    shared = int(np.argmax(np.append(ra.arrays["chosen_idx"][0]
                                     != rq.arrays["chosen_idx"][0], True)))
    d_am = max(float(np.max(np.abs(ra.arrays[q][0, :shared]
                                   - rq.arrays[q][0, :shared])))
               for q in ("topk_score", "chosen_score")) if shared else 0.0
    if d_am > CONTRACT:
        raise AssertionError(f"amortized scores differ from quad by {d_am}")
    lines = _triage(ra, rq, "amortized vs quad", CONTRACT)
    out["amortized"] = (_round_ms(ta, R), engaged, d_am)
    log(f"tiers: eig_pbest=amortized (multiplier 20) 1 seed x {R} rounds: "
        f"kernel 2 once a round; gate engaged in {engaged}/{R} rounds; max "
        f"|d score| vs quad over the {shared} shared rounds={d_am:.3e}; "
        f"ms_per_round={out['amortized'][0]:.3f}; triage {'; '.join(lines)}")
    rd_, td_, _, _ = _tier_run(dev, task, R, 1, "delta", total, inc_want)
    rex, tex, pex, _ = _tier_run(
        dev, task, R, 1, "pi_update exact", total,
        {flavour("eig_score", f32, False): 1,
         flavour("eig_refresh_score", f32, False): R}, pi_update="exact")
    lines = _triage(rex, rd_, "pi_update exact vs delta", CONTRACT)
    out["pi_exact"] = (_round_ms(tex, R), _round_ms(td_, R), pex)
    log(f"tiers: pi_update=exact 1 seed x {R} rounds: kernel 3 0 launches; "
        f"ms_per_round={out['pi_exact'][0]:.3f} (delta "
        f"{out['pi_exact'][1]:.3f}); peak_mem_gb={pex:.2f}; triage "
        f"{'; '.join(lines)}")
    for what, kw in (("prefilter_n=4096", dict(prefilter_n=4096)),
                     ("q=iid", dict(q="iid")),
                     ("q=uncertainty", dict(q="uncertainty"))):
        _, tq, pq, mode = _tier_run(dev, task, R, 1, what, total, {}, **kw)
        if what.startswith("prefilter") and mode != "factored":
            raise AssertionError(f"{what} resolved to {mode}")
        out[what] = (_round_ms(tq, R), pq)
        log(f"tiers: {what} 1 seed x {R} rounds (eig_mode "
            f"{mode}): ms_per_round={out[what][0]:.3f} "
            f"peak_mem_gb={pq:.2f}; finite, in range, no repeats")
    return out


# -- batched acquisition, the surrogate scorer, the tracking store ----------

BATCHQ_PATHS = ((1, 20), (4, 20), (8, 10))   # (q, rounds), headline, 1 seed
BATCHQ_SEED_ROUNDS = 5                 # the 5-seed q = 4 batch
BATCHQ_FLAVOUR_ROUNDS = 5              # bf16 + approx; fused + bf16
BATCHQ_BASELINE_ROUNDS = 10            # the baselines at q = 4 on digits_h80
SURROGATE_ROUNDS = 20                  # the speed runs, 1 seed
DONOR_ROUNDS = 20                      # the pool's donor session
TRACKING_ROUNDS = 5

# the reference's analysis query (paper/common.py's _SQL), copied here:
# the smoke reads the port's database with sqlite3 alone
_PAPER_SQL = """
SELECT  e.name   AS task,
        rn.value AS run_name,
        m.value  AS value,
        m.step   AS step
FROM    metrics   m
JOIN    runs      r   ON m.run_uuid      = r.run_uuid
JOIN    experiments e ON r.experiment_id = e.experiment_id
JOIN    tags t_parent
       ON r.run_uuid = t_parent.run_uuid
      AND t_parent.key = 'mlflow.parentRunId'
LEFT JOIN tags rn
       ON r.run_uuid = rn.run_uuid
      AND rn.key     = 'mlflow.runName'
WHERE   m.key  = ?
  AND   m.is_nan = 0
  AND   r.lifecycle_stage = 'active'
  AND   e.lifecycle_stage = 'active'
"""


def _q_run(dev, preds, labels, iters, seeds, q, what, total, want,
           prior=None, **knobs):
    """One recorded CODA run at ``q`` labels a round, counters set to 0
    just before and read just after. ``want`` (launches by flavour, or a
    function of the run's ``(result, aux)`` giving them) is checked and
    added to ``total``. Returns ``(result, aux, timings, peak_gb,
    selector)``."""
    import torch

    from coda_tpu_torch.engine import run_seeds_recorded
    from coda_tpu_torch.selectors import CODAHyperparams, make_coda

    knobs.setdefault("eig_chunk", 1024)
    # the replicas the engine batches: a q-wide run's seeds go one after
    # another
    hp = CODAHyperparams(n_parallel=seeds if q == 1 else 1, **knobs)
    sels, timings = [], []

    def factory(p):
        sels.append(make_coda(p, hp, device=dev, prior=prior))
        return sels[-1]

    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    reset_counts()
    res, aux = run_seeds_recorded(factory, preds, labels, iters=iters,
                                  seeds=seeds, device=dev, timings=timings,
                                  acq_batch=q)
    torch.cuda.synchronize()
    _, by_flavour = read_counts()
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    if callable(want):
        want = want(res, aux)
    if by_flavour != want:
        raise AssertionError(f"{what}: launches {by_flavour}, expected "
                             f"{want}")
    for k, v in by_flavour.items():
        total[k] = total.get(k, 0) + v
    idx = res.chosen_idx.cpu().reshape(seeds, -1)
    regret = res.regret.cpu()
    N = preds.shape[1]
    if not (torch.isfinite(regret).all() and (regret >= 0).all()
            and (idx >= 0).all() and (idx < N).all()
            and all(len(set(r.tolist())) == iters * q for r in idx)):
        raise AssertionError(f"{what}: regret not finite and >= 0, or an "
                             "index out of range or labelled twice")
    return res, aux, timings, peak_gb, sels[0]


def phase_batchq_surrogate(dev, task, total: dict) -> dict:
    """Batched acquisition (``acq_batch`` q), the surrogate scorer and the
    tracking store on the card (see the module docstring, item 8). Every
    run has the counters set to 0 just before and read just after, its
    launches checked and added to ``total``. Returns the measured
    figures."""
    import contextlib
    import io
    import sqlite3
    import tempfile

    import numpy as np
    import torch

    from coda_tpu_torch import cli
    from coda_tpu_torch import random as trandom
    from coda_tpu_torch.data import Dataset, make_synthetic_task
    from coda_tpu_torch.engine import run_seeds_recorded
    from coda_tpu_torch.engine.replay import (
        compare_records,
        within_prior_envelope,
    )
    from coda_tpu_torch.ops.eig_kernels import flavour
    from coda_tpu_torch.selectors import CODAHyperparams, make_coda
    from coda_tpu_torch.selectors import surrogate as sg
    from coda_tpu_torch.telemetry.recorder import RunRecord

    t_phase = time.perf_counter()
    C, N, H = HEADLINE
    f32, bf16 = torch.float32, torch.bfloat16
    k1, k3 = flavour("eig_score", f32, False), "row_gather"
    out: dict = {}

    def warm_full(aux, credit=0):
        """A surrogate run's full-pass rounds over its seeds: the warmup
        rounds its prior's credit leaves, then every fallback."""
        fb = aux.trace.surrogate_fallback.cpu().numpy()
        T = fb.shape[1]
        warm = max(0, min(T, sg.SURROGATE_WARMUP_ROUNDS - credit))
        return fb.shape[0] * warm + int(fb.sum())

    def record(res, aux, ds, tmp, name, knobs, q=1):
        run = {"task": ds.name, "synthetic": None, "data_dir": "data",
               "method": "coda", "loss": "acc",
               "iters": int(res.regret.shape[1]),
               "seeds": int(res.regret.shape[0]), "acq_batch": q}
        return _save_and_load(res, aux, ds, dev, os.path.join(tmp, name),
                              run, dict(knobs, method="coda"))

    # 1. the headline at q labels a round, one seed (q = 1 first, in the
    # same window, for the comparison)
    one = {}
    for q, iters in BATCHQ_PATHS:
        want = ({k1: 1 + iters, k3: q * iters} if q > 1 else
                {k1: 1, flavour("eig_refresh_score", f32, False): iters,
                 k3: iters})
        res, aux, tm, peak, _ = _q_run(
            dev, task.preds, task.labels, iters, 1, q, f"headline q={q}",
            total, want)
        ms = _round_ms(tm, iters)
        one[q] = RunRecord.from_result(res, aux, {}, {})
        out[f"q{q}"] = (ms, ms / q, peak)
        log(f"batchq: headline ({H}, {N}, {C}), 1 seed, q={q} x {iters} "
            f"rounds, default knobs: launches {json.dumps(want)}, nothing "
            f"else; ms_per_round={ms:.3f} ms_per_label={ms / q:.3f} "
            f"peak_mem_gb={peak:.2f}; regret@{iters}="
            f"{float(res.regret[0, -1]):.4f} cumulative="
            f"{float(res.cumulative_regret[0, -1]):.4f}")
        del res, aux
    R = BATCHQ_FLAVOUR_ROUNDS
    for what, knobs, want in (
            ("bf16 + approx", dict(eig_cache_dtype="bfloat16",
                                   eig_entropy="approx"),
             {flavour("eig_score", bf16, True): 1 + R, k3: 4 * R}),
            ("fused + bf16", dict(eig_refresh="fused",
                                  eig_cache_dtype="bfloat16"),
             {flavour("eig_score", bf16, False): 1,
              flavour("eig_refresh_compute_score", bf16, False): 4 * R,
              k3: 4 * R})):
        res, aux, tm, peak, sel = _q_run(
            dev, task.preds, task.labels, R, 1, 4, f"headline q=4 {what}",
            total, want, **knobs)
        ms = _round_ms(tm, R)
        out[f"q4 {what}"] = (ms, ms / 4, peak)
        log(f"batchq: headline q=4 {what}, 1 seed x {R} rounds: launches "
            f"{json.dumps(want)}; ms_per_round={ms:.3f} ms_per_label="
            f"{ms / 4:.3f} peak_mem_gb={peak:.2f}; fused update_q "
            f"{'off (q updates a round)' if sel.update_q is None else 'on'}")
        del res, aux, sel

    # 2. SEEDS seeds at the headline, q = 4: one after another (a seed
    # batch refreshes its rows replica by replica and measured slower)
    R = BATCHQ_SEED_ROUNDS
    res, aux, tm, peak, _ = _q_run(
        dev, task.preds, task.labels, R, SEEDS, 4, "headline seeds q=4",
        total, {k1: SEEDS * (1 + R), k3: SEEDS * 4 * R},
        eig_mode="incremental")
    # the 5-seed q = 1 batch in the same window, for the comparison
    _, _, tm1, peak1, _ = _q_run(
        dev, task.preds, task.labels, R, SEEDS, 1, "headline seed batch q=1",
        total, {flavour("eig_score_batched", f32, False): 1,
                flavour("eig_refresh_score_batched", f32, False): R,
                "row_gather_batched": R}, eig_mode="incremental")
    ms1 = _round_ms(tm1, R)
    batch = RunRecord.from_result(res, aux, {}, {})
    ms = _round_ms(tm, R)      # one timing entry a seed, summed
    out["q4 seeds"] = (ms, ms / (4 * SEEDS), peak)
    seed0 = {f: v[:1, :R] for f, v in batch.arrays.items()
             if v.ndim >= 2 and f not in ("root_key", "init_key",
                                          "prior_key")}
    ref0 = {f: one[4].arrays[f][:1, :R] for f in seed0}
    for f in ("chosen_idx", "true_class", "best_model"):
        if not np.array_equal(seed0[f], ref0[f]):
            raise AssertionError(f"{SEEDS} seeds: seed 0's {f} differs "
                                 "from the one-seed q=4 run")
    diff = {f: float(np.max(np.abs(seed0[f].astype(np.float64)
                                   - ref0[f].astype(np.float64))))
            for f in seed0 if not np.array_equal(seed0[f], ref0[f],
                                                 equal_nan=True)}
    bitwise = not diff
    out["q4 seeds seed 0 bitwise"] = bitwise
    log(f"batchq: headline {SEEDS} seeds one after another, q=4 x {R} "
        f"rounds (eig_mode=incremental): kernel 1 x {SEEDS * (1 + R)}, "
        f"kernel 3 x {SEEDS * 4 * R}; ms_per_round (all seeds)={ms:.3f} "
        f"ms_per_seed_label={ms / (4 * SEEDS):.3f} peak_mem_gb={peak:.2f} "
        f"(the q=1 batch: ms_per_round={ms1:.3f} ms_per_seed_label="
        f"{ms1 / SEEDS:.3f} peak_mem_gb={peak1:.2f}); seed 0 vs the "
        f"one-seed q=4 run's first {R} rounds: "
        + ("bitwise" if bitwise else f"decisions equal, max |d| {diff}"))
    del res, aux, batch
    if not bitwise:
        raise AssertionError(f"{SEEDS} seeds: seed 0 not bitwise the "
                             f"one-seed q=4 run: {diff}")

    with tempfile.TemporaryDirectory() as tmp:
        # 3. the committed digits records at q = 4 and q = 8
        ds = Dataset.from_file(os.path.join(HERE, "data", "digits.npz"),
                               device=dev)
        q1_ref = RunRecord.load(os.path.join(HERE, "runs", "batchq_r14",
                                             "q1"))
        for name in ("q4", "q8"):
            ref = RunRecord.load(os.path.join(HERE, "runs", "batchq_r14",
                                              name))
            kn = ref.meta["fingerprint"]["knobs"]
            q, iters, seeds = ref.acq_batch, ref.rounds, ref.seeds
            res, aux, tm, _, _ = _q_run(
                dev, ds.preds, ds.labels, iters, seeds, q,
                f"digits {name}", total,
                {k1: seeds * (1 + iters), k3: seeds * q * iters},
                eig_chunk=kn["eig_chunk"])
            got = record(res, aux, ds, tmp, name,
                         {"eig_chunk": kn["eig_chunk"], "seeds": seeds,
                          "n_parallel": 1, "acq_batch": q}, q)
            digest = got.meta["fingerprint"]["dataset"]["digest"]
            if digest != ref.meta["fingerprint"]["dataset"]["digest"]:
                raise AssertionError(f"digits digest {digest}")
            _triage(got, ref, f"digits {name} vs runs/batchq_r14/{name}",
                    CONTRACT)
            if name == "q4":
                env = compare_records(q1_ref, got)
                if not all(s.classification == "acq-batch-envelope"
                           for s in env.seeds):
                    raise AssertionError("q1 vs q4: not the envelope")
                e = env.meta["batchq_envelope"]
                log(f"batchq: runs/batchq_r14/q1 vs the card's q4 by the "
                    f"acq-batch envelope: worst final cum-regret ratio "
                    f"{e['max_final_ratio_b_over_a']:.3f}, worst aligned "
                    f"gap {e['max_aligned_gap']:.4f}")

        # 4. the five baselines at q = 4, card against CPU
        R = BATCHQ_BASELINE_ROUNDS
        h80 = {d: Dataset.from_file(os.path.join(HERE, "data",
                                                 "digits_h80.npz"), device=d)
               for d in (dev, "cpu")}
        for method in BASELINES:
            recs = {}
            for d in (dev, "cpu"):
                reset_counts()
                res, aux = run_seeds_recorded(
                    _baseline_factory(method, 4 * R, d), h80[d].preds,
                    h80[d].labels, iters=R, seeds=H80_SEEDS, device=d,
                    acq_batch=4)
                if read_counts()[1]:
                    raise AssertionError(f"{method} q=4 launched "
                                         f"{read_counts()[1]}")
                recs[d] = RunRecord.from_result(res, aux, {}, {})
            lines = _triage(recs[dev], recs["cpu"],
                            f"digits_h80 {method} q=4 card vs CPU",
                            CONTRACT)
            log(f"batchq: {method} q=4 digits_h80, {H80_SEEDS} seeds x {R} "
                f"rounds: card vs CPU ({'; '.join(lines)})")

        # 5. the surrogate on digits, the committed record's knobs
        ref = RunRecord.load(os.path.join(HERE, "runs", "surrogate_r17",
                                          "surrogate"))
        exact_ref = RunRecord.load(os.path.join(HERE, "runs",
                                                "surrogate_r17", "exact"))
        seeds, iters = ref.seeds, ref.rounds
        res, aux, tm, _, _ = _q_run(
            dev, ds.preds, ds.labels, iters, seeds, 1, "digits surrogate:32",
            total, lambda r, a: {k1: seeds + warm_full(a),
                                 k3: seeds * iters},
            eig_scorer="surrogate:32")
        got = record(res, aux, ds, tmp, "surrogate",
                     {"eig_chunk": 1024, "seeds": seeds, "n_parallel": 1,
                      "eig_scorer": "surrogate:32"})
        fb = got.arrays["surrogate_fallback"]
        share = fb.sum() / (seeds * (iters - sg.SURROGATE_WARMUP_ROUNDS))
        out["digits surrogate fallback share"] = float(share)
        _triage(got, ref, "digits surrogate:32 vs "
                "runs/surrogate_r17/surrogate", CONTRACT)
        env = compare_records(exact_ref, got)
        if not all(s.classification == "eig-scorer-envelope"
                   for s in env.seeds):
            raise AssertionError("surrogate vs exact: not the envelope")
        e = env.meta["scorer_envelope"]
        log(f"surrogate: digits {tuple(ds.shape)} surrogate:32, {seeds} "
            f"seeds x {iters} rounds (seeds one after another): kernel 1 x "
            f"{seeds + warm_full(aux)} (1 + full rounds a seed), kernel 2 "
            f"x 0; fallback share {share:.4f} ({int(fb.sum())} of "
            f"{seeds * (iters - sg.SURROGATE_WARMUP_ROUNDS)} gated rounds; "
            f"the committed record's: {int(ref.arrays['surrogate_fallback'].sum())}); "
            f"vs runs/surrogate_r17/exact by the eig-scorer envelope: worst "
            f"final ratio {e['max_final_ratio_b_over_a']:.3f}")

        # 6. the pool-seeded surrogate: a donor session, then seeded and
        # cold runs
        hp16 = CODAHyperparams(eig_scorer="surrogate:16", eig_chunk=1024)
        donor_sel = make_coda(ds.preds, hp16, device=dev)
        st = donor_sel.init(None)
        key = trandom.PRNGKey(1)
        reset_counts()
        for _ in range(DONOR_ROUNDS):
            key, k = trandom.split(key)
            r = donor_sel.select(st, k)
            st = donor_sel.update(st, r.idx, ds.labels.take(r.idx), r.prob)
        for kk, v in read_counts()[1].items():
            total[kk] = total.get(kk, 0) + v
        fit = st.surrogate
        donor = sg.clip_prior(sg.prior_from_fit(fit.A, fit.b, fit.n,
                                                fit.rounds))
        digest = sg.prior_digest(donor)
        credit = sg.prior_warmup_credit(donor)
        del donor_sel, st
        runs = {}
        for name, prior, knobs in (
                ("cold", None, {"eig_scorer": "surrogate:16"}),
                ("seeded", donor, {"eig_scorer": "surrogate:16",
                                   "surrogate_prior": "pool",
                                   "surrogate_prior_digest": digest})):
            c = 0 if prior is None else credit
            res, aux, tm, _, _ = _q_run(
                dev, ds.preds, ds.labels, iters, seeds, 1,
                f"digits surrogate:16 {name}", total,
                lambda r, a, c=c: {k1: seeds + warm_full(a, c),
                                   k3: seeds * iters},
                prior=prior, eig_scorer="surrogate:16",
                surrogate_prior="off" if prior is None else "pool")
            runs[name] = (record(res, aux, ds, tmp, f"prior_{name}",
                                 dict(knobs, seeds=seeds, n_parallel=1)),
                          seeds + warm_full(aux, c))
        for name in ("cold", "seeded"):
            ref = RunRecord.load(os.path.join(HERE, "runs", "prior_r18",
                                              name))
            got = runs[name][0]
            if name == "cold":
                _triage(got, ref, "digits surrogate:16 cold vs "
                        "runs/prior_r18/cold", CONTRACT)
            rep = compare_records(ref, got, score_tol=CONTRACT)
            cls = {s.classification or "parity" for s in rep.seeds}
            log(f"surrogate prior: runs/prior_r18/{name} vs the card's "
                f"{name} run: {sorted(cls)}"
                + (f", worst final ratio "
                   f"{rep.meta['prior_envelope']['max_final_ratio_b_over_a']:.3f}"
                   if "prior_envelope" in rep.meta else ""))
            if name == "seeded" and cls != {"surrogate-prior-envelope"}:
                raise AssertionError("seeded vs the committed seeded record: "
                                     f"{cls}, not the prior envelope")
        cold_mean = float(runs["cold"][0].arrays["cumulative_regret"][
            :, -1].mean())
        seeded_mean = float(runs["seeded"][0].arrays["cumulative_regret"][
            :, -1].mean())
        env = compare_records(runs["cold"][0], runs["seeded"][0])
        if {s.classification for s in env.seeds} != {
                "surrogate-prior-envelope"}:
            raise AssertionError("cold vs seeded: not the prior envelope")
        ok = within_prior_envelope(cold_mean, seeded_mean)
        out["prior"] = (digest, credit, runs["cold"][1], runs["seeded"][1],
                        cold_mean, seeded_mean, ok)
        log(f"surrogate prior: donor {DONOR_ROUNDS} rounds -> digest "
            f"{digest} (the committed records': "
            f"{RunRecord.load(os.path.join(HERE, 'runs', 'prior_r18', 'seeded')).meta['fingerprint']['knobs']['surrogate_prior_digest']}), "
            f"warmup credit {credit}; kernel 1 cold x {runs['cold'][1]}, "
            f"seeded x {runs['seeded'][1]}; final cumulative regret mean "
            f"cold {cold_mean:.4f} seeded {seeded_mean:.4f}: "
            f"{'within' if ok else 'OUTSIDE'} the reference's envelope "
            f"(1.05 x cold + 0.02)")
        if not ok:
            raise AssertionError("the seeded run is outside the prior "
                                 "envelope")

    # 7. the surrogate's speed against the exact scorer
    pool = make_synthetic_task(5, H=SPARSE_POOL[0], N=SPARSE_POOL[1],
                               C=SPARSE_POOL[2], device=dev)
    for label, t, k in (("pool", pool, 16), ("headline", task, 32)):
        Ht, Nt, Ct = t.preds.shape
        got = {}
        for scorer in ("exact", f"surrogate:{k}"):
            ms = {}
            for iters in (sg.SURROGATE_WARMUP_ROUNDS, SURROGATE_ROUNDS
                          + sg.SURROGATE_WARMUP_ROUNDS):
                want = ((lambda r, a: {k1: 1 + warm_full(a), k3: iters})
                        if scorer != "exact" else
                        {k1: 1, flavour("eig_refresh_score", f32, False):
                         iters, k3: iters})
                res, aux, tm, peak, _ = _q_run(
                    dev, t.preds, t.labels, iters, 1, 1,
                    f"{label} {scorer}", total, want, eig_scorer=scorer)
                ms[iters] = tm[0]["rounds_ms"]
            fb = aux.trace.surrogate_fallback.cpu().numpy()
            gated = (ms[max(ms)] - ms[min(ms)]) / SURROGATE_ROUNDS
            got[scorer] = (gated, int(fb.sum()), peak)
            del res, aux
        ex, su = got["exact"], got[f"surrogate:{k}"]
        out[f"surrogate speed {label}"] = (ex, su)
        log(f"surrogate speed: {label} ({Ht}, {Nt}, {Ct}), 1 seed, rounds "
            f"{sg.SURROGATE_WARMUP_ROUNDS + 1}-"
            f"{sg.SURROGATE_WARMUP_ROUNDS + SURROGATE_ROUNDS} (past the "
            f"warmup): exact ms_per_round={ex[0]:.3f} peak_mem_gb="
            f"{ex[2]:.2f}; surrogate:{k} ms_per_round={su[0]:.3f} "
            f"fallbacks {su[1]} of {SURROGATE_ROUNDS} peak_mem_gb="
            f"{su[2]:.2f}; speed-up {ex[0] / su[0]:.2f}x")
    del pool

    # 8. the tracking store through the CLI
    with tempfile.TemporaryDirectory() as tmp:
        db = os.path.join(tmp, "coda.sqlite")
        argv = ["--synthetic", f"{H},{N},{C}", "--method", "coda",
                "--iters", str(TRACKING_ROUNDS), "--seeds", "1",
                "--tracking-db", db]
        want = {k1: 1, flavour("eig_refresh_score", f32, False):
                TRACKING_ROUNDS, k3: TRACKING_ROUNDS}
        outs = []
        for extra in ([], [], ["--force-rerun"]):
            buf = io.StringIO()
            torch.cuda.synchronize()
            reset_counts()
            with contextlib.redirect_stdout(buf):
                cli.main(argv + extra)
            torch.cuda.synchronize()
            by_flavour = read_counts()[1]
            if by_flavour != want:
                raise AssertionError(f"tracking CLI run: launches "
                                     f"{by_flavour}")
            for kk, v in by_flavour.items():
                total[kk] = total.get(kk, 0) + v
            outs.append(buf.getvalue())
            with sqlite3.connect(db) as conn:
                rows = conn.execute(_PAPER_SQL + "  AND m.step = ?",
                                    ("cumulative regret",
                                     TRACKING_ROUNDS)).fetchall()
                n_metrics = conn.execute(
                    "SELECT COUNT(*) FROM metrics").fetchone()[0]
            name = f"synthetic_{H}x{N}x{C}-coda-0"
            if [(r[0], r[1], r[3]) for r in rows] != [
                    (f"synthetic_{H}x{N}x{C}", name, TRACKING_ROUNDS)] \
                    or n_metrics != 2 * TRACKING_ROUNDS \
                    or not math.isfinite(rows[0][2]):
                raise AssertionError(f"tracking DB: {rows}, {n_metrics} "
                                     "metric rows")
        if "Skipping" in outs[0] or "Seed 0 finished. Skipping." not in \
                outs[1] or "Skipping" in outs[2]:
            raise AssertionError("tracking: resume / --force-rerun")
        log(f"tracking: CLI at the headline, 1 seed x {TRACKING_ROUNDS} "
            f"rounds into a temporary --tracking-db: the reference's "
            f"analysis SQL reads run {name}, cumulative regret "
            f"{rows[0][2]:.4f} at step {TRACKING_ROUNDS}; the second run "
            f"printed 'Seed 0 finished. Skipping.'; --force-rerun re-logged "
            f"({n_metrics} metric rows, not doubled)")
    out["wall_s"] = time.perf_counter() - t_phase
    log(f"batchq and surrogate phase: {out['wall_s']:.1f} s")
    return out


# -- re-executing records, checkpoint/resume and the in-process suite -------

# (label, CLI flags, seeds, rounds) of the headline records re-executed
# through ``python -m coda_tpu_torch.cli replay`` in a subprocess
REPLAY_PATHS = (
    ("default", [], 1, 20),
    ("5 seeds batched", ["--eig-mode", "incremental"], SEEDS, 10),
    ("fused bf16", ["--eig-refresh", "fused", "--eig-cache-dtype",
                    "bfloat16"], 1, 10),
)
TAMPER_ROUND = 7
CKPT_ROUNDS, CKPT_EVERY, CKPT_CUT = 30, 10, 25   # the cut run saves 10, 20
# runs/real.sqlite's sweep (5 seeds x 100 rounds) cut to 50 rounds, its
# table read at step 50
SUITE_SEEDS, SUITE_ROUNDS = 5, 50
SUBSET = ("digits", "iris", "wine")              # --task-batch subset
SUBSET_SEEDS, SUBSET_ROUNDS = 2, 30
CLI_PAIRS = (("digits", "coda"), ("digits", "model_picker"))
SUITE_METHODS = ("iid", "uncertainty", "coda", "activetesting", "vma",
                 "model_picker")


def _headline_wants(argv, seeds, iters):
    """The launches a recorded headline run of ``argv`` must make."""
    import torch

    from coda_tpu_torch.ops.eig_kernels import flavour

    dt = (torch.bfloat16 if "bfloat16" in argv else torch.float32)
    if seeds > 1:
        return {flavour("eig_score_batched", dt, False): 1,
                flavour("eig_refresh_score_batched", dt, False): iters,
                "row_gather_batched": iters}
    refresh = ("eig_refresh_compute_score" if "fused" in argv
               else "eig_refresh_score")
    return {flavour("eig_score", dt, False): 1,
            flavour(refresh, dt, False): iters, "row_gather": iters}


def _counted(what, want, total, fn):
    """Run ``fn`` with the counters set to 0 just before and read just
    after; the launches must be ``want`` (a dict) or, for a callable,
    pass it; they add to ``total``."""
    import torch

    torch.cuda.synchronize()
    reset_counts()
    out = fn()
    torch.cuda.synchronize()
    by_kernel, by_flavour = read_counts()
    ok = want(by_kernel) if callable(want) else by_flavour == want
    if not ok:
        raise AssertionError(f"{what}: launches {by_flavour}")
    for k, v in by_flavour.items():
        total[k] = total.get(k, 0) + v
    return out


def _hold_replay(report: dict, record, what: str, tol: float) -> list:
    """Each seed of a replay report at parity, or first diverging as a
    ``tie-break-flip`` where the record's runner-up gap is at most
    ``tol``; prints and returns each seed's line."""
    lines, bad = [], []
    for s in report["seeds"]:
        if s["parity"]:
            line = f"seed {s['seed']}: PARITY"
        else:
            t0 = s["first_divergent_round"]
            gap = float(record.arrays["runner_up_gap"][s["seed"], t0])
            line = (f"seed {s['seed']}: first divergence at round {t0}, "
                    f"{s['quantity']} [{s['classification']}], recorded "
                    f"runner-up gap {gap:.3e}")
            if s["classification"] != "tie-break-flip" or abs(gap) > tol:
                bad.append(line)
        lines.append(line)
        log(f"replay {what}: {line}")
    if bad:
        raise AssertionError(f"{what}: not parity or a near-tie flip: {bad}")
    return lines


def _suite_rows(db: str, runs) -> dict:
    """``{run name: [(key, step, value), ...]}`` of the named runs."""
    import sqlite3

    with sqlite3.connect(db) as conn:
        out = {}
        for name in runs:
            out[name] = conn.execute(
                """SELECT m.key, m.step, m.value FROM metrics m
                   JOIN tags t ON t.run_uuid = m.run_uuid
                     AND t.key = 'mlflow.runName'
                   WHERE t.value = ? ORDER BY m.key, m.step""",
                (name,)).fetchall()
    return out


def _cum_regret_table(db: str, step: int) -> dict:
    """``{(task, method): mean over seed children of the cumulative
    regret at ``step``}`` (the paper's table entry, x100)."""
    import sqlite3

    with sqlite3.connect(db) as conn:
        rows = conn.execute(
            """SELECT t.value, m.value FROM metrics m
               JOIN tags t ON t.run_uuid = m.run_uuid
                 AND t.key = 'mlflow.runName'
               WHERE m.key = 'cumulative regret' AND m.step = ?
                 AND m.run_uuid IN (SELECT run_uuid FROM tags
                                    WHERE key = 'mlflow.parentRunId')""",
            (step,)).fetchall()
    acc: dict = {}
    for name, v in rows:
        task, method, _ = name.rsplit("-", 2)
        acc.setdefault((task, method), []).append(v)
    return {k: 100.0 * sum(v) / len(v) for k, v in acc.items()}


def phase_replay_checkpoint_suite(dev, task, total: dict) -> dict:
    """Re-executed records, checkpoint/resume and the in-process suite on
    the card (see the module docstring, item 9). Every in-process run has
    the counters set to 0 just before and read just after, its launches
    checked and added to ``total``. Returns the measured figures."""
    import contextlib
    import io
    import json as _json
    import shutil
    import tempfile

    import torch

    from coda_tpu_torch import cli
    from coda_tpu_torch.engine import (
        build_experiment_fn,
        make_resumable_runner,
        run_seeds_compiled,
    )
    from coda_tpu_torch.engine.replay import replay_main
    from coda_tpu_torch.ops.eig_kernels import flavour
    from coda_tpu_torch.oracle import true_losses
    from coda_tpu_torch.random import PRNGKey
    from coda_tpu_torch.selectors import (
        CODAHyperparams,
        make_activetesting,
        make_coda,
    )
    from coda_tpu_torch.telemetry.recorder import RunRecord

    t_phase = time.perf_counter()
    C, N, H = HEADLINE
    data = os.path.join(HERE, "data")
    out: dict = {"replay": {}, "checkpoint": {}, "suite": {}}
    tmp = tempfile.mkdtemp(prefix="coda_smoke_")
    try:
        # 1. record three headline runs, re-execute each in a subprocess
        for label, flags, seeds, iters in REPLAY_PATHS:
            argv = ["--synthetic", f"{H},{N},{C}", "--method", "coda",
                    "--iters", str(iters), "--seeds", str(seeds),
                    "--record-dir", os.path.join(tmp, label.replace(" ", "_")),
                    "--no-mlflow", "--device", dev.type] + flags
            args = cli.parse_args(argv)
            factory = cli.build_selector_factory(args, task.name)
            width = cli.hyperparams(args).n_parallel
            timings: list = []
            res, aux = _counted(
                f"recorded {label}", _headline_wants(flags, seeds, iters),
                total, lambda: run_seeds_compiled(
                    factory, task.preds, task.labels, iters=iters,
                    seeds=seeds, device=dev, trace_k=args.record_topk,
                    timings=timings))
            cli._write_record(args, task, res, aux, width, dev)
            rec_ms = sum(t["rounds_ms"] for t in timings) / iters
            report = os.path.join(tmp, "report.json")
            t0 = time.perf_counter()
            proc = subprocess.run(
                [sys.executable, "-m", "coda_tpu_torch.cli", "replay",
                 args.record_dir, "--out", report], cwd=HERE,
                capture_output=True, text=True, timeout=600)
            wall = time.perf_counter() - t0
            if proc.returncode != 0:
                raise AssertionError(
                    f"replay {label}: exit {proc.returncode}\n"
                    f"{proc.stdout[-3000:]}\n{proc.stderr[-3000:]}")
            with open(report) as f:
                rep = _json.load(f)
            if not rep["parity"] or rep["score_tol"] != 0.0:
                raise AssertionError(f"replay {label}: {rep['seeds']}")
            rep_ms = sum(t["rounds_ms"] for t in rep["meta"]["timings"]) \
                / iters
            out["replay"][label] = {"recorded_ms": rec_ms,
                                    "replay_ms": rep_ms,
                                    "subprocess_s": wall, "width": width}
            log(f"replay {label} ({H}, {N}, {C}), {seeds} seed(s) x "
                f"{iters} rounds, n_parallel={width}: PARITY bitwise, exit "
                f"0; ms_per_round recorded={rec_ms:.3f} replayed="
                f"{rep_ms:.3f}; the replay subprocess took {wall:.1f} s")
            del res, aux

        # 2. the default record with one chosen_idx changed: exit 2
        rec = RunRecord.load(os.path.join(tmp, "default"))
        t, iters = TAMPER_ROUND, REPLAY_PATHS[0][3]
        rec.arrays["chosen_idx"][0, t] = rec.arrays["topk_idx"][0, t, 1]
        rec.save(os.path.join(tmp, "tampered"))
        report = os.path.join(tmp, "tampered.json")
        rc = _counted("tampered replay",
                      _headline_wants([], 1, iters), total,
                      lambda: replay_main([os.path.join(tmp, "tampered"),
                                           "--out", report]))
        with open(report) as f:
            seed0 = _json.load(f)["seeds"][0]
        if rc != 2 or seed0["parity"] or \
                seed0["first_divergent_round"] != t:
            raise AssertionError(f"tampered replay: exit {rc}, {seed0}")
        log(f"replay of the default record with chosen_idx changed at round "
            f"{t}: exit 2, DIVERGED at round {t} ({seed0['quantity']} "
            f"[{seed0['classification']}])")

        # 3. the committed digits record on the card
        r17 = os.path.join(HERE, "runs", "surrogate_r17", "exact")
        report = os.path.join(tmp, "r17.json")
        committed = RunRecord.load(r17)
        rc = _counted(
            "runs/surrogate_r17/exact replay",
            lambda k: k["eig_score_batched"] == 1 and
            k["eig_refresh_score_batched"] == committed.rounds ==
            k["row_gather_batched"], total,
            lambda: replay_main([r17, "--data-dir", data, "--out", report]))
        with open(report) as f:
            rep = _json.load(f)
        if rep["score_tol"] != CONTRACT or rc != (0 if rep["parity"] else 2):
            raise AssertionError(f"r17 replay: exit {rc}, tol "
                                 f"{rep['score_tol']}")
        out["replay"]["r17"] = _hold_replay(rep, committed,
                                            "runs/surrogate_r17/exact",
                                            CONTRACT)

        # 4. checkpoint/resume at the headline: cut after round 20 (the
        # cut run reaches round 25; its last save is step 20), resume,
        # every trace bitwise the uninterrupted run
        losses = true_losses(task.preds, task.labels)
        for label, make, dt in (
                ("fp32", lambda: make_coda(task.preds, CODAHyperparams(
                    eig_chunk=1024), device=dev), "float32"),
                ("bf16", lambda: make_coda(task.preds, CODAHyperparams(
                    eig_chunk=1024, eig_cache_dtype="bfloat16"),
                    device=dev), "bfloat16"),
                ("activetesting", lambda: make_activetesting(
                    task.preds, budget=CKPT_ROUNDS, device=dev), None)):
            def wants(rounds, init, dt=dt):
                if dt is None:
                    return {}
                tdt = getattr(torch, dt)
                w = {flavour("eig_refresh_score", tdt, False): rounds,
                     "row_gather": rounds}
                if init:
                    w[flavour("eig_score", tdt, False)] = 1
                return w

            sel = make()
            full = _counted(f"checkpoint {label} uninterrupted",
                            wants(CKPT_ROUNDS, True), total,
                            lambda: build_experiment_fn(
                                sel, task.labels, losses,
                                CKPT_ROUNDS)(PRNGKey(0)))
            ck = os.path.join(tmp, f"ck_{label}")
            timings: list = []
            _counted(f"checkpoint {label} cut", wants(CKPT_CUT, True), total,
                     lambda: make_resumable_runner(
                         sel, task.labels, losses, CKPT_CUT, CKPT_EVERY,
                         timings=timings)(0, ck))
            got = _counted(f"checkpoint {label} resumed",
                           wants(CKPT_ROUNDS - 20, False), total,
                           lambda: make_resumable_runner(
                               sel, task.labels, losses, CKPT_ROUNDS,
                               CKPT_EVERY, timings=timings)(0, ck))
            for f in full._fields:
                if not torch.equal(getattr(full, f), getattr(got, f)):
                    raise AssertionError(f"checkpoint {label}: resumed {f} "
                                         "differs from the uninterrupted run")
            saves = [x for x in timings if x["op"] == "save"]
            restore = [x for x in timings if x["op"] == "restore"]
            if [x["round"] for x in saves] != [10, 20] or \
                    [x["round"] for x in restore] != [20]:
                raise AssertionError(f"checkpoint {label}: {timings}")
            out["checkpoint"][label] = {
                "bytes": saves[-1]["bytes"],
                "save_s": [x["seconds"] for x in saves],
                "restore_s": restore[0]["seconds"]}
            log(f"checkpoint {label} ({H}, {N}, {C}), 1 seed, cut after "
                f"round 20 and resumed to {CKPT_ROUNDS}: every trace "
                f"bitwise the uninterrupted run; a checkpoint "
                f"{saves[-1]['bytes']} bytes, save "
                f"{', '.join(f'{x:.3f}' for x in out['checkpoint'][label]['save_s'])}"
                f" s, restore {restore[0]['seconds']:.3f} s")
            shutil.rmtree(ck)
            del sel, full, got
        torch.cuda.empty_cache()

        # 5. the suite over data/: the sweep of runs/real.sqlite
        def suite(db, *extra):
            buf = io.StringIO()
            argv = ["suite", "--pred-dir", data, "--db", db, "--methods",
                    ",".join(SUITE_METHODS)] + list(extra)
            with contextlib.redirect_stdout(buf):
                rc = cli.main(argv)
            text = buf.getvalue()
            if rc != 0:
                raise AssertionError(f"suite {extra}: exit {rc}\n{text}")
            return text, _json.loads(text.strip().splitlines()[-1])

        def kernels_ran(k):
            return k["eig_score"] > 0 and k["eig_refresh_score"] > 0 and \
                k["row_gather"] > 0

        db = os.path.join(tmp, "suite.sqlite")
        full_args = ("--seeds", str(SUITE_SEEDS), "--iters",
                     str(SUITE_ROUNDS))
        text, line = _counted("suite sweep", kernels_ran, total,
                              lambda: suite(db, *full_args))
        n_pairs = line["tasks"] * line["methods"]
        if line["pairs_run"] != n_pairs:
            raise AssertionError(f"suite sweep: {line}")
        out["suite"]["wall_s"] = line["value"]
        out["suite"]["pairs"] = n_pairs
        # a pair whose seed-0 probe was deterministic logged it to every
        # seed (all False); the others ran seeds 1-4 too
        import sqlite3

        with sqlite3.connect(db) as conn:
            flags: dict = {}
            for name, v in conn.execute(
                    """SELECT t.value, p.value FROM params p
                       JOIN tags t ON t.run_uuid = p.run_uuid
                         AND t.key = 'mlflow.runName'
                       WHERE p.key = 'stochastic'"""):
                flags.setdefault(name.rsplit("-", 1)[0], []).append(
                    v == "True")
        n_stoch = sum(any(v) for v in flags.values())
        seed_rounds = SUITE_ROUNDS * (n_pairs + (SUITE_SEEDS - 1) * n_stoch)
        out["suite"].update(stochastic_pairs=n_stoch,
                            seed_rounds=seed_rounds)
        log(f"suite: {line['tasks']} tasks x {line['methods']} methods x "
            f"{SUITE_SEEDS} seeds x {SUITE_ROUNDS} rounds on the card in "
            f"{line['value']} s ({n_pairs} pairs; {n_stoch} stochastic, "
            f"whose seeds 1-{SUITE_SEEDS - 1} ran: {seed_rounds} "
            f"seed-rounds, {1e3 * line['value'] / seed_rounds:.3f} ms "
            "each)")
        for ln in text.splitlines():
            if " seeds x " in ln:
                log(f"  {ln}")
        text, line = suite(db, *full_args)
        if line["pairs_run"] != 0 or text.count("skip ") != n_pairs:
            raise AssertionError(f"suite rerun: {line}")
        log(f"suite rerun: every one of the {n_pairs} pairs skipped "
            f"({line['value']} s)")

        # the task-batch subset through the scheduler, against serial
        sub = ("--tasks", ",".join(SUBSET), "--seeds", str(SUBSET_SEEDS),
               "--iters", str(SUBSET_ROUNDS))
        db_ser = os.path.join(tmp, "subset_serial.sqlite")
        db_sch = os.path.join(tmp, "subset_sched.sqlite")
        _, l_ser = _counted("suite subset serial", kernels_ran, total,
                            lambda: suite(db_ser, *sub))
        _, l_sch = _counted("suite subset scheduled", kernels_ran, total,
                            lambda: suite(db_sch, *sub, "--task-batch",
                                          "--suite-devices", "1"))
        names = [f"{t}-{m}-{s}" for t in SUBSET for m in SUITE_METHODS
                 for s in range(SUBSET_SEEDS)]
        a, b = _suite_rows(db_ser, names), _suite_rows(db_sch, names)
        if a != b or not all(len(v) == 2 * SUBSET_ROUNDS
                             for v in a.values()):
            raise AssertionError("suite subset: --task-batch "
                                 "--suite-devices 1 differs from serial")
        log(f"suite subset {','.join(SUBSET)} x {len(SUITE_METHODS)} "
            f"methods x {SUBSET_SEEDS} seeds x {SUBSET_ROUNDS} rounds: "
            f"--task-batch --suite-devices 1 ({l_sch['value']} s, occupancy "
            f"{l_sch.get('occupancy')}) bitwise the serial run "
            f"({l_ser['value']} s), {len(names)} seed runs")

        # two pairs against the single-task CLI
        def batch_ran(k):   # CODA's 5 seeds as one batch
            return k["eig_score_batched"] == 1 and \
                k["eig_refresh_score_batched"] == SUITE_ROUNDS == \
                k["row_gather_batched"]

        for tname, method in CLI_PAIRS:
            db_cli = os.path.join(tmp, f"cli_{method}.sqlite")
            with contextlib.redirect_stdout(io.StringIO()):
                _counted(f"CLI {tname}/{method}",
                         batch_ran if method == "coda"
                         else (lambda k: not any(k.values())), total,
                         lambda: cli.main([
                             "--task", tname, "--data-dir", data,
                             "--method", method, "--iters",
                             str(SUITE_ROUNDS), "--seeds", str(SUITE_SEEDS),
                             "--tracking-db", db_cli]))
            runs = [f"{tname}-{method}-{s}" for s in range(SUITE_SEEDS)]
            a, b = _suite_rows(db, runs), _suite_rows(db_cli, runs)
            if a != b or not all(len(v) == 2 * SUITE_ROUNDS
                                 for v in a.values()):
                raise AssertionError(f"{tname}/{method}: the suite's rows "
                                     "differ from the single-task CLI's")
            log(f"suite {tname}/{method}: its {SUITE_SEEDS} seed runs' "
                "regret and cumulative regret rows bitwise the single-task "
                "CLI's")

        # the paper's table entry beside runs/real.sqlite (information)
        mine = _cum_regret_table(db, SUITE_ROUNDS)
        ref = _cum_regret_table(os.path.join(HERE, "runs", "real.sqlite"),
                                SUITE_ROUNDS)
        agree = 0
        log(f"mean cumulative regret x100 at step {SUITE_ROUNDS}, port "
            "(card) | runs/real.sqlite (an older reference on JAX's CPU):")
        for key in sorted(mine):
            r = ref.get(key)
            same = r is not None and round(mine[key], 1) == round(r, 1)
            agree += same
            log(f"  {key[0]:>14} {key[1]:>13}: {mine[key]:9.3f} | "
                + (f"{r:9.3f}" if r is not None else "      n/a")
                + ("  =" if same else ""))
        shared = sum(1 for k in mine if k in ref)
        out["suite"]["agree"] = (agree, shared)
        log(f"  {agree} of the {shared} pairs in both agree to the decimal")
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    out["wall_s"] = time.perf_counter() - t_phase
    log(f"replay, checkpoint and suite phase: {out['wall_s']:.1f} s")
    return out


# -- the crowd oracle and the telemetry core --------------------------------

CROWD_SPEC = ("annotators=8,votes=3,acc=0.6:0.95,abstain=0.1,"
              "adversarial=1,trust=16,seed=0")     # ROBUSTNESS_CPU_r18 noisy
RELIABILITY_SPEC = ("annotators=8,votes=3,acc=0.55:0.95,abstain=0.05,"
                    "adversarial=2,trust=24,seed=1")
RELIABILITY_ROUNDS = 400
CORR_BOUND, MAE_BOUND = 0.8, 0.25                   # its reliability bounds
ENVELOPE_RATIO, ENVELOPE_ABS = 2.0, 1.0             # its oracle envelope
# (label, CODA knobs, seeds, rounds, labels a round)
CROWD_PATHS = (
    ("precomputed fp32", {}, 1, 20, 1),
    ("fused bf16", {"eig_refresh": "fused", "eig_cache_dtype": "bfloat16"},
     1, 20, 1),
    ("5 seeds batched", {"eig_mode": "incremental"}, SEEDS, 10, 1),
    ("q = 4", {}, 1, 5, 4),
)
CROWD_PARITY_SEEDS, CROWD_PARITY_ROUNDS = 3, 30     # digits_h80
TELEMETRY_ROUNDS = 20
SUITE_TELEMETRY = ("digits,iris", "iid,coda", 2, 10)   # tasks, methods, seeds,
#                                                        rounds


def _crowd_wants(knobs: dict, seeds: int, iters: int, q: int) -> dict:
    """The launches a headline crowd run of ``knobs`` must make: the main
    path's for the configuration."""
    import torch

    from coda_tpu_torch.ops.eig_kernels import flavour

    dt = getattr(torch, knobs.get("eig_cache_dtype", "float32"))
    if q > 1:
        return {flavour("eig_score", dt, False): 1 + iters,
                "row_gather": q * iters}
    if seeds > 1:
        return {flavour("eig_score_batched", dt, False): 1,
                flavour("eig_refresh_score_batched", dt, False): iters,
                "row_gather_batched": iters}
    refresh = ("eig_refresh_compute_score"
               if knobs.get("eig_refresh") == "fused"
               else "eig_refresh_score")
    return {flavour("eig_score", dt, False): 1,
            flavour(refresh, dt, False): iters, "row_gather": iters}


def _cuda_events(fn) -> int:
    """CUDA activities (kernels, copies, sets) ``fn`` puts on the card,
    counted by ``torch.profiler``."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    return sum(1 for e in prof.events()
               if e.device_type == torch.autograd.DeviceType.CUDA)


class _headline_cli:
    """``cli.main`` with the headline task already built: ``load_dataset``
    returns ``task`` for ``--synthetic`` at its shape (the numpy build is
    deterministic and takes about 20 s on the host)."""

    def __init__(self, task):
        from coda_tpu_torch import cli

        self.cli, self.task = cli, task
        self.shape = ",".join(str(x) for x in task.shape)

    def __enter__(self):
        self.orig = self.cli.load_dataset
        self.cli.load_dataset = lambda args: (
            self.task if args.synthetic == self.shape else self.orig(args))
        return self.cli

    def __exit__(self, *exc):
        self.cli.load_dataset = self.orig
        return False


_KERNEL_NAMES = {   # kernel -> a pattern of its demangled name in a trace
    "kernel 1": r"score_kernel<float, \d+, false, false, false>",
    "kernel 2": r"score_kernel<float, \d+, true, false, false>",
    "kernel 3": r"gather_kernel<false>",
}


def _trace_kernels(path: str) -> list:
    """The CUDA kernel events (``cat`` kernel) of a profiler trace."""
    with open(path) as f:
        return [e for e in json.load(f)["traceEvents"]
                if e.get("cat") == "kernel"]


def phase_crowd_telemetry(dev, task, total: dict, smi: str, peaks) -> dict:
    """The crowd oracle and the telemetry core on the card (see the module
    docstring, item 10). Every in-process run has the counters set to 0
    just before and read just after, its launches checked and added to
    ``total``. Returns the measured figures."""
    import contextlib
    import dataclasses
    import io
    import json as _json
    import re
    import shutil
    import tempfile

    import numpy as np
    import torch

    from coda_tpu_torch import random as trandom
    from coda_tpu_torch.crowd import (
        aggregate_votes,
        annotator_accuracy,
        init_reliability,
        make_annotators,
        parse_oracle_spec,
        run_seeds_crowd,
        run_seeds_crowd_recorded,
        sample_votes,
    )
    from coda_tpu_torch.data import Dataset
    from coda_tpu_torch.engine import run_seeds_compiled, run_seeds_recorded
    from coda_tpu_torch.engine.replay import compare_records
    from coda_tpu_torch.selectors import CODAHyperparams, make_coda
    from coda_tpu_torch.telemetry import Telemetry, costs, lint_prometheus
    from coda_tpu_torch.telemetry.recorder import RunRecord
    from coda_tpu_torch.tracking import TrackingStore
    from coda_tpu_torch.utils.profiling import TRACE_FILE
    from coda_tpu_torch.utils.profiling import trace as profiler_trace

    t_phase = time.perf_counter()
    C, N, H = HEADLINE
    cfg = parse_oracle_spec(CROWD_SPEC)
    out: dict = {"runs": {}, "telemetry": {}}
    log(f"crowd and telemetry on {smi}: --oracle-noise {CROWD_SPEC}")

    def factory_of(hp, sequential=False):
        def factory(p):
            sel = make_coda(p, hp, device=dev)
            return dataclasses.replace(sel, batched=None) if sequential \
                else sel
        return factory

    # 1. the crowd at the headline, each beside the clean run of its knobs
    for label, knobs, seeds, iters, q in CROWD_PATHS:
        hp = CODAHyperparams(eig_chunk=1024, n_parallel=seeds, **knobs)
        want = _crowd_wants(knobs, seeds, iters, q)
        # clean, crowd, clean, crowd: the second of each is timed (the
        # first pays the configuration's first uses)
        for rep in range(2):
            t_clean: list = []
            t_crowd: list = []
            clean = _counted(f"clean {label}", want, total,
                             lambda: run_seeds_compiled(
                                 factory_of(hp), task.preds, task.labels,
                                 iters=iters, seeds=seeds, device=dev,
                                 timings=t_clean, acq_batch=q))
            del clean
            torch.cuda.empty_cache()
            torch.cuda.reset_peak_memory_stats()
            res, crowd = _counted(f"crowd {label}", want, total,
                                  lambda: run_seeds_crowd(
                                      factory_of(hp), task.preds,
                                      task.labels, cfg, iters=iters,
                                      seeds=seeds, device=dev,
                                      timings=t_crowd, acq_batch=q))
            peak_gb = torch.cuda.max_memory_allocated() / 1e9
        if len(t_crowd) != len(t_clean):
            raise AssertionError(f"crowd {label}: {len(t_crowd)} timed "
                                 f"experiments, clean {len(t_clean)}")
        idx = res.chosen_idx.cpu()
        w = crowd.label_weight.cpu()
        if not (torch.isfinite(res.regret.cpu()).all()
                and ((w >= 0) & (w <= 1)).all()
                and (res.regret.cpu() >= 0).all()
                and all(len(set(r.reshape(-1).tolist())) == iters * q
                        for r in idx)
                and crowd.annotator_accuracy.shape[-1] == cfg.annotators):
            raise AssertionError(f"crowd {label}: bad trajectory")
        flips = int((crowd.applied_label != crowd.oracle_label).sum())
        ms = sum(t["rounds_ms"] for t in t_crowd) / iters
        ms_clean = sum(t["rounds_ms"] for t in t_clean) / iters
        out["runs"][label] = {"ms": ms, "clean_ms": ms_clean,
                              "peak_gb": peak_gb, "flips": flips}
        log(f"crowd {label} ({H}, {N}, {C}), {seeds} seed(s) x {iters} "
            f"rounds x {q} label(s): launches == the main path's "
            f"{_json.dumps(want)}; ms_per_round crowd={ms:.3f} "
            f"clean={ms_clean:.3f}; peak_mem_gb={peak_gb:.2f}; "
            f"{flips} of {w.numel()} applied labels differ from the truth, "
            f"mean weight {float(w.mean()):.4f}")
        del res, crowd
    torch.cuda.empty_cache()

    # device events a round, crowd against clean (precomputed fp32, rounds
    # 3-7: the difference of a 7-round and a 2-round run)
    hp = CODAHyperparams(eig_chunk=1024)
    ev = {}
    for name, run in (
            ("clean", lambda r: run_seeds_compiled(
                factory_of(hp), task.preds, task.labels, iters=r, seeds=1,
                device=dev)),
            ("crowd", lambda r: run_seeds_crowd(
                factory_of(hp), task.preds, task.labels, cfg, iters=r,
                seeds=1, device=dev))):
        counts = [_counted(f"events {name} {r}",
                           _crowd_wants({}, 1, r, 1), total,
                           lambda r=r: _cuda_events(lambda: run(r)))
                  for r in (2, 7)]
        ev[name] = (counts[1] - counts[0]) / 5
    out["events"] = ev
    log(f"device events a round (torch.profiler, precomputed fp32, 1 seed): "
        f"crowd={ev['crowd']:.1f} clean={ev['clean']:.1f}")

    # 2. digits_h80 under the noisy spec: kernels batched == kernels one
    # seed after another, bitwise with the crowd's arrays; the plain
    # versions batched at parity or first diverging at a near tie (the
    # kernels' scores differ from the plain ones within their tolerance),
    # identical before it
    ds = Dataset.from_file(os.path.join(HERE, "data", "digits_h80.npz"),
                           device=dev)
    S, T = CROWD_PARITY_SEEDS, CROWD_PARITY_ROUNDS

    def digits(sequential=False, **kw):
        hp = CODAHyperparams(eig_chunk=1024, n_parallel=S, **kw)
        return run_seeds_crowd_recorded(
            factory_of(hp, sequential), ds.preds, ds.labels, cfg, iters=T,
            seeds=S, device=dev)

    kb = _counted("digits_h80 crowd batched", {
        "eig_score_batched": 1, "eig_refresh_score_batched": T,
        "row_gather_batched": T}, total, digits)
    ks = _counted("digits_h80 crowd in turn", {
        "eig_score": S, "eig_refresh_score": S * T, "row_gather": S * T},
        total, lambda: digits(sequential=True))
    pb = _counted("digits_h80 crowd plain", {}, total,
                  lambda: digits(eig_backend="plain"))
    leaves = torch.utils._pytree.tree_leaves
    if not all(torch.equal(x, y) for x, y in zip(leaves(kb), leaves(ks))):
        raise AssertionError("digits_h80 crowd: the batch differs from the "
                             "seeds one after another")
    log(f"crowd parity digits_h80 {tuple(ds.shape)}: {S} seeds x {T} "
        f"rounds batched on the kernels == one seed after another, bitwise "
        f"(every result, trace and CrowdAux array)")

    def record(o):
        return RunRecord.from_result(o[0], o[1], {"backend": "torch-cuda"},
                                     {"iters": T}, crowd=o[2])

    kr, pr = record(kb), record(pb)
    _triage(pr, kr, "digits_h80 crowd plain versions vs kernels", CONTRACT)
    for sd in compare_records(pr, kr, score_tol=CONTRACT).seeds:
        t0 = T if sd.parity else sd.first_divergent_round
        for f in ("chosen_idx", "true_class", "best_model", "oracle_label",
                  "label_weight"):
            if not np.array_equal(kr.arrays[f][sd.seed, :t0],
                                  pr.arrays[f][sd.seed, :t0]):
                raise AssertionError(f"digits_h80 crowd plain seed "
                                     f"{sd.seed}: {f} differs before round "
                                     f"{t0}")
    log(f"crowd parity digits_h80: the plain versions batched hold the "
        f"kernels' decisions and crowd arrays bitwise up to each seed's "
        f"first divergence (above)")
    del kb, ks, pb, ds

    # 3. the learned reliability: the reference's recovery check
    rcfg = parse_oracle_spec(RELIABILITY_SPEC)
    conf = make_annotators(rcfg, 4, dev)
    rel = init_reliability(rcfg, 4, dev)
    keys = trandom.split(trandom.PRNGKey(7), RELIABILITY_ROUNDS)
    for t in range(RELIABILITY_ROUNDS):
        k_z, k_votes = trandom.split(keys[t])
        z = trandom.randint(k_z, (), 0, 4)
        rel = aggregate_votes(rel, *sample_votes(k_votes, conf, z, rcfg),
                              rcfg)[2]
    learned = annotator_accuracy(rel).cpu().numpy()
    planted = torch.diagonal(conf, dim1=-2, dim2=-1).mean(-1).cpu().numpy()
    honest = np.arange(rcfg.annotators) < rcfg.annotators - rcfg.adversarial
    corr = float(np.corrcoef(learned, planted)[0, 1])
    mae = float(np.abs(learned - planted).mean())
    separated = bool(learned[~honest].max() < learned[honest].min())
    if not (corr >= CORR_BOUND and mae <= MAE_BOUND and separated):
        raise AssertionError(f"reliability: corr {corr}, mae {mae}, "
                             f"separated {separated}")
    out["reliability"] = {"corr": corr, "mae": mae}
    log(f"reliability ({RELIABILITY_SPEC}, {RELIABILITY_ROUNDS} rounds on "
        f"the card): corr={corr:.4f} >= {CORR_BOUND}, mae={mae:.4f} <= "
        f"{MAE_BOUND}, adversaries separated; learned "
        f"{[round(float(x), 4) for x in learned]}")

    tmp = tempfile.mkdtemp(prefix="coda_smoke_crowd_")
    try:
        # 4. record the fused bf16 crowd run, replay it in a subprocess;
        # against a clean record it is the oracle-noise envelope
        with _headline_cli(task) as cli:
            fused = ["--eig-refresh", "fused", "--eig-cache-dtype",
                     "bfloat16"]
            iters = 20
            base = ["--synthetic", f"{H},{N},{C}", "--method", "coda",
                    "--iters", str(iters), "--seeds", "1", "--no-mlflow",
                    "--device", dev.type] + fused
            recs = {}
            for name, extra in (("noisy", ["--oracle-noise", CROWD_SPEC]),
                                ("clean", [])):
                args = cli.parse_args(base + extra + [
                    "--record-dir", os.path.join(tmp, name)])
                fac = cli.build_selector_factory(args, task.name)
                want = _crowd_wants(dict(eig_refresh="fused",
                                         eig_cache_dtype="bfloat16"),
                                    1, iters, 1)
                if name == "noisy":
                    res, aux, crowd = _counted(
                        "recorded crowd fused bf16", want, total,
                        lambda: run_seeds_crowd_recorded(
                            fac, task.preds, task.labels, cfg, iters=iters,
                            seeds=1, device=dev,
                            trace_k=args.record_topk))
                else:
                    (res, aux), crowd = _counted(
                        "recorded clean fused bf16", want, total,
                        lambda: run_seeds_recorded(
                            fac, task.preds, task.labels, iters=iters,
                            seeds=1, device=dev,
                            trace_k=args.record_topk)), None
                cli._write_record(args, task, res, aux, 1, dev, crowd)
                recs[name] = RunRecord.load(args.record_dir)
                bad = recs[name].violations()
                if bad:
                    raise AssertionError(f"{name} record: {bad}")
        report = os.path.join(tmp, "replay.json")
        t0 = time.perf_counter()
        proc = subprocess.run(
            [sys.executable, "-m", "coda_tpu_torch.cli", "replay",
             os.path.join(tmp, "noisy"), "--out", report], cwd=HERE,
            capture_output=True, text=True, timeout=600)
        wall = time.perf_counter() - t0
        if proc.returncode != 0:
            raise AssertionError(f"crowd replay: exit {proc.returncode}\n"
                                 f"{proc.stdout[-3000:]}\n"
                                 f"{proc.stderr[-3000:]}")
        with open(report) as f:
            rep = _json.load(f)
        if not rep["parity"] or rep["score_tol"] != 0.0:
            raise AssertionError(f"crowd replay: {rep['seeds']}")
        rep_ms = sum(t["rounds_ms"] for t in rep["meta"]["timings"]) / iters
        env = compare_records(recs["clean"], recs["noisy"])
        per_seed = env.meta["oracle_envelope"]["seeds"]
        ok = all(s.classification == "oracle-noise-envelope"
                 for s in env.seeds) and all(
            p["final_cum_b"] <= ENVELOPE_RATIO * p["final_cum_a"]
            + ENVELOPE_ABS for p in per_seed)
        if not ok:
            raise AssertionError(f"noisy vs clean: {env.to_dict()}")
        out["replay"] = {"replay_ms": rep_ms, "subprocess_s": wall}
        log(f"crowd record fused bf16 ({H}, {N}, {C}), 1 seed x {iters}: "
            f"schema clean, oracle_label/label_weight recorded; cli replay "
            f"in a subprocess: PARITY bitwise, exit 0, {rep_ms:.3f} ms a "
            f"round, {wall:.1f} s; against the clean record: "
            f"oracle-noise-envelope, final cum regret "
            f"{per_seed[0]['final_cum_b']:.4f} vs clean "
            f"{per_seed[0]['final_cum_a']:.4f} (envelope_ok: <= "
            f"{ENVELOPE_RATIO} x clean + {ENVELOPE_ABS})")

        # 5. telemetry at the headline: the CLI with --telemetry-dir and
        # --profile-dir
        tdir, pdir = os.path.join(tmp, "tel"), os.path.join(tmp, "prof")
        iters = TELEMETRY_ROUNDS
        with _headline_cli(task) as cli:
            torch.cuda.synchronize()
            torch.cuda.empty_cache()
            torch.cuda.reset_peak_memory_stats()
            costs.COSTS.clear()    # the book then holds this run's entry
            buf = io.StringIO()
            with contextlib.redirect_stdout(buf):
                rc = _counted("telemetry CLI run",
                              _crowd_wants({}, 1, iters, 1), total,
                              lambda: cli.main([
                                  "--synthetic", f"{H},{N},{C}", "--method",
                                  "coda", "--iters", str(iters), "--seeds",
                                  "1", "--no-mlflow", "--telemetry-dir",
                                  tdir, "--profile-dir", pdir]))
            peak = torch.cuda.max_memory_allocated()
        if rc != 0:
            raise AssertionError(f"telemetry CLI run: exit {rc}\n"
                                 f"{buf.getvalue()}")
        with open(os.path.join(tdir, "telemetry.json")) as f:
            snap = _json.load(f)
        dev_peak = snap["devices"].get(str(dev.index or 0), {}).get(
            "peak_bytes_in_use")
        if dev_peak != peak:
            raise AssertionError(f"telemetry.json device peak {dev_peak} != "
                                 f"max_memory_allocated {peak}")
        with open(os.path.join(tdir, "metrics.prom")) as f:
            bad = lint_prometheus(f.read())
        if bad:
            raise AssertionError(f"metrics.prom: {bad}")
        with open(os.path.join(tdir, "trace.json")) as f:
            spans = {e["name"] for e in _json.load(f)["traceEvents"]
                     if e["ph"] == "X"}
        if not {"load_dataset", "experiment"} <= spans:
            raise AssertionError(f"trace.json spans {spans}")
        kern = _trace_kernels(os.path.join(pdir, TRACE_FILE))
        found = {k: sum(e["dur"] for e in kern if re.search(p, e["name"]))
                 for k, p in _KERNEL_NAMES.items()}
        if not all(found.values()):
            names = sorted({e["name"][:90] for e in kern
                            if "kernel" in e["name"]})[:20]
            raise AssertionError(f"profiler trace: kernels {found}; names "
                                 f"{names}")
        ours = sum(e["dur"] for e in kern if any(
            re.search(p, e["name"]) for p in _KERNEL_NAMES.values()))
        entries = snap["costs"]
        name = f"engine/run_seeds/coda/{H}x{N}x{C}/s1x{iters}"
        if list(entries) != [name]:
            raise AssertionError(f"telemetry.json cost entries {entries}")
        shares = {}
        for name, e in entries.items():
            rate = e["bytes_accessed"] / (ours * 1e-6)
            shares[name] = rate / peaks[0]
            if rate >= peaks[0] or e.get("source") != "analytic" or \
                    e.get("peak_source") != "table":
                raise AssertionError(f"cost entry {name}: {rate / 1e12:.3f} "
                                     f"TB/s over the kernels' measured "
                                     f"{ours / 1e3:.3f} ms, {e}")
        out["telemetry"].update(
            peak_bytes=peak, kernel_ms={k: v / 1e3 for k, v in found.items()},
            share=shares)
        log(f"telemetry CLI run ({H}, {N}, {C}), 1 seed x {iters}: "
            f"telemetry.json device peak {dev_peak} == max_memory_allocated; "
            f"metrics.prom lints clean; trace.json spans load_dataset, "
            f"experiment; the profiler trace names kernels 1-3, device ms "
            f"{ {k: round(v / 1e3, 3) for k, v in found.items()} }; cost "
            f"entries' bytes over those kernels' time, share of "
            f"{peaks[0] / 1e12:.2f} TB/s: "
            f"{ {k: round(v, 4) for k, v in shares.items()} }")

        # telemetry on and off, the same entry (run_seeds_compiled, 1 seed
        # x 20 rounds, precomputed fp32), in turns: plain; under the CLI's
        # span and cost harvest; then once under the profiler as well
        hp = CODAHyperparams(eig_chunk=1024)
        tele = Telemetry()
        ms: dict = {"off": [], "on": [], "on+profile": []}
        for mode in ("off", "on", "off", "on", "on+profile"):
            timings: list = []
            prof = (profiler_trace(os.path.join(tmp, "p2"), dev)
                    if mode == "on+profile" else contextlib.nullcontext())
            span = (tele.span("experiment", lane="host:main", annotate=True)
                    if mode != "off" else contextlib.nullcontext())
            with prof, span:
                _counted(f"telemetry {mode}", _crowd_wants({}, 1, iters, 1),
                         total, lambda: run_seeds_compiled(
                             factory_of(hp), task.preds, task.labels,
                             iters=iters, seeds=1, device=dev,
                             timings=timings,
                             cost_label=None if mode == "off" else "coda"))
            ms[mode].append(timings[0]["rounds_ms"] / iters)
        out["telemetry"]["ms"] = ms
        log(f"ms_per_round (off, on in turns; then on with the profiler): "
            f"off={[round(x, 3) for x in ms['off']]} "
            f"on={[round(x, 3) for x in ms['on']]} "
            f"on+profile={round(ms['on+profile'][0], 3)}")

        # 6. the suite with --telemetry-dir on a subset
        tasks, methods, seeds, rounds = SUITE_TELEMETRY
        sdir, db = os.path.join(tmp, "suite_tel"), os.path.join(tmp, "s.db")
        buf = io.StringIO()
        with contextlib.redirect_stdout(buf):
            rc = _counted(
                "suite telemetry",
                lambda k: k["eig_score"] > 0 and k["row_gather"] > 0, total,
                lambda: cli.main([
                    "suite", "--pred-dir", os.path.join(HERE, "data"),
                    "--tasks", tasks, "--methods", methods, "--seeds",
                    str(seeds), "--iters", str(rounds), "--db", db,
                    "--telemetry-dir", sdir]))
        if rc != 0:
            raise AssertionError(f"suite telemetry: exit {rc}\n"
                                 f"{buf.getvalue()}")
        with open(os.path.join(sdir, "trace.json")) as f:
            tr = _json.load(f)["traceEvents"]
        lanes = {e["args"]["name"] for e in tr if e["name"] == "thread_name"}
        n_spans = sum(1 for e in tr if e["ph"] == "X")
        store = TrackingStore(db)
        flushed = store.find_run("suite", "suite-telemetry")
        store.close()
        if lanes != {"device:0"} or n_spans != 4 or flushed is None:
            raise AssertionError(f"suite telemetry: lanes {lanes}, "
                                 f"{n_spans} spans, flushed {flushed}")
        log(f"suite --telemetry-dir ({tasks} x {methods} x {seeds} seeds x "
            f"{rounds} rounds): {n_spans} dispatch spans on device:0, the "
            f"scalars flushed to the store as suite-telemetry")
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    out["wall_s"] = time.perf_counter() - t_phase
    log(f"crowd and telemetry phase: {out['wall_s']:.1f} s")
    return out



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
        f"{peaks[1] / 1e12:.0f} TFLOP/s fp32, {peaks[2] / 1e12:.0f} TFLOP/s "
        "TF32 tensor)")
    phase = "build"
    try:
        info = build.build_all()
        log(f"build: {info['seconds']:.1f} s for {len(info['logs'])} "
            "libraries (nvcc -gencode arch=compute_90a,code=sm_90a)")
        for lib, text in info["logs"].items():
            for line in text.splitlines():
                if "registers" in line or "spill" in line:
                    log(f"  ptxas {lib}: {line.strip()}")
        phase = "log sweep"
        phase_log_sweep(dev)
        phase = "kernels"
        recs = phase_kernels(dev, peaks)
        from coda_tpu_torch.data import make_synthetic_task

        C, N, H = HEADLINE
        t0 = time.perf_counter()
        task = make_synthetic_task(0, H=H, N=N, C=C, device=dev)
        log(f"main path: synthetic task ({H}, {N}, {C}) built in "
            f"{time.perf_counter() - t0:.1f} s")
        phase = "main path"
        launches = phase_main_path(dev, task)
        phase = "parity"
        phase_parity(dev)
        phase = "baselines"
        phase_baselines(dev, task)
        phase = "recorded"
        phase_recorded(dev, task, launches)
        phase = "tiers"
        phase_tiers(dev, task, launches)
        phase = "batchq and surrogate"
        phase_batchq_surrogate(dev, task, launches)
        phase = "replay, checkpoint and suite"
        phase_replay_checkpoint_suite(dev, task, launches)
        phase = "crowd and telemetry"
        phase_crowd_telemetry(dev, task, launches, smi, peaks)
    except Exception:
        traceback.print_exc()
        print(f"chip_smoke: phase '{phase}' FAILED", file=sys.stderr)
        return 1
    kernels = []
    for kname, r in recs.items():
        kernels.append({"name": kname, "route": "cuda", "source": r["source"],
                        "replaces": r["replaces"],
                        "launches": launches.get(kname, 0),
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
