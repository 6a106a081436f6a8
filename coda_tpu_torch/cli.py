"""Command line for the port's main path (counterpart of the single-task
run of ``coda_tpu/cli.py``).

    python -m coda_tpu_torch.cli --synthetic 1000,50000,10 --method coda \\
        --iters 20 --seeds 1
    python -m coda_tpu_torch.cli --synthetic 1000,50000,10 --method coda \\
        --eig-refresh fused --eig-cache-dtype bfloat16 --iters 20 --seeds 1
    python -m coda_tpu_torch.cli --synthetic 1000,50000,10 --method coda \\
        --eig-backend pallas --eig-mode incremental --iters 20 --seeds 5
    python -m coda_tpu_torch.cli --task digits --data-dir data --method coda \\
        --device cpu

Runs CODA on the card (``--device cuda``, the default) and prints the
reference CLI's per-seed ``seed s: regret@T=... cumulative=...
stochastic=...`` lines. More than one seed runs as one batch (kernels 4
and 5) unless ``--eig-refresh fused``, whose seeds run one after another;
``n_parallel``, the auto tier's replica count, is the batch's width, as in
the reference. The tracking store and the flight recorder come with later
slices of the port.
"""

from __future__ import annotations

import argparse
import sys
import time


def parse_args(argv=None):
    p = argparse.ArgumentParser(
        description="CODA active model selection on the card (PyTorch/CUDA)")
    p.add_argument("--task", default=None, help="task name, e.g. digits")
    p.add_argument("--data-dir", default="data")
    p.add_argument("--synthetic", default=None, metavar="H,N,C",
                   help="run on a seeded synthetic task of this shape")
    p.add_argument("--iters", type=int, default=100)
    p.add_argument("--seeds", type=int, default=5)
    p.add_argument("--loss", default="acc", choices=["acc", "ce"])
    p.add_argument("--method", default="coda", choices=["coda"],
                   help="selection method (the baselines are a later slice)")
    p.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    # CODA prior knobs (same flags and defaults as the reference)
    p.add_argument("--alpha", default=0.9, type=float)
    p.add_argument("--learning-rate", default=0.01, type=float)
    p.add_argument("--multiplier", default=2.0, type=float)
    p.add_argument("--no-diag-prior", action="store_true",
                   help="Disable diagonal prior (ablation 1).")
    p.add_argument("--eig-chunk", type=int, default=1024,
                   help="N-block of the cache build and the plain scoring")
    p.add_argument("--eig-mode", default="auto",
                   choices=["auto", "incremental"],
                   help="EIG tier: auto (the reference's budget over every "
                        "batched replica) or incremental (the (C, N, H) "
                        "cache tier regardless of the budget)")
    # the incremental tier's numerics knobs (the reference's flags)
    p.add_argument("--eig-backend", default="auto",
                   choices=["auto", "plain", "pallas"],
                   help="scoring backend: auto (default) = the CUDA kernels "
                        "on the card, the plain PyTorch versions on the CPU; "
                        "plain = the plain versions everywhere; pallas "
                        "(the reference's name for its kernels) = auto")
    p.add_argument("--eig-cache-dtype", default="float32",
                   choices=["float32", "bfloat16"],
                   help="storage dtype of the incremental P(best) cache: "
                        "bfloat16 halves the scoring pass's memory stream "
                        "(opt-in numerics)")
    p.add_argument("--eig-refresh", default="precomputed",
                   choices=["precomputed", "fused"],
                   help="where the row-refresh products run: precomputed = "
                        "fp32 matrix products before the scoring pass "
                        "(reference numerics); fused = inside the scoring "
                        "kernel (opt-in numerics). Fused has no seed-batched "
                        "form: its seeds run one after another, so it takes "
                        "any --seeds, where the reference's vmapped CLI "
                        "refuses it for more than one")
    p.add_argument("--eig-entropy", default="exact",
                   choices=["exact", "approx"],
                   help="log2 of the expected-entropy chain: exact, or a "
                        "bit-extracted exponent + degree-6 mantissa "
                        "polynomial (max |Dscore| <= 1e-4; opt-in numerics)")
    return p.parse_args(argv)


def load_dataset(args):
    from coda_tpu_torch.data import Dataset, find_task_file, make_synthetic_task

    if args.synthetic:
        H, N, C = (int(x) for x in args.synthetic.split(","))
        return make_synthetic_task(seed=0, H=H, N=N, C=C,
                                   name=args.task or f"synthetic_{H}x{N}x{C}",
                                   device=args.device)
    if args.task is None:
        raise SystemExit("--task or --synthetic is required")
    fp = find_task_file(args.data_dir, args.task)
    if fp is None:
        raise SystemExit(
            f"No data file for task '{args.task}' under {args.data_dir}/")
    return Dataset.from_file(fp, name=args.task, device=args.device)


def hyperparams(args):
    """The run's ``CODAHyperparams``. ``n_parallel`` is the number of
    replicas the engine batches — ``--seeds`` where the selector has a
    seed-batched form, 1 where seeds run one after another — so the auto
    tier's budget sees every replica (the reference's rule)."""
    from coda_tpu_torch.selectors import CODAHyperparams
    from coda_tpu_torch.selectors.coda import batches_seeds

    hp = CODAHyperparams(alpha=args.alpha, learning_rate=args.learning_rate,
                         multiplier=args.multiplier,
                         disable_diag_prior=args.no_diag_prior,
                         eig_chunk=args.eig_chunk, eig_mode=args.eig_mode,
                         eig_backend=("auto" if args.eig_backend == "pallas"
                                      else args.eig_backend),
                         eig_cache_dtype=args.eig_cache_dtype,
                         eig_refresh=args.eig_refresh,
                         eig_entropy=args.eig_entropy)
    batched = args.seeds > 1 and batches_seeds(hp)
    return hp._replace(n_parallel=args.seeds if batched else 1)


def main(argv=None):
    args = parse_args(sys.argv[1:] if argv is None else argv)
    import torch

    from coda_tpu_torch.engine import run_seeds_compiled
    from coda_tpu_torch.losses import LOSS_FNS
    from coda_tpu_torch.oracle import true_losses
    from coda_tpu_torch.selectors import make_coda
    from coda_tpu_torch.utils.platform import device_name, resolve_device

    dev = resolve_device(args.device)
    print("device:", device_name(dev))
    dataset = load_dataset(args)
    H, N, C = dataset.shape
    print(f"Loaded preds of shape ({H}, {N}, {C})")
    if dataset.labels is None:
        raise SystemExit("Oracle needs labels!")
    loss_fn = LOSS_FNS[args.loss]
    best_loss = float(true_losses(dataset.preds, dataset.labels,
                                  loss_fn).min())
    print("Best possible loss is", best_loss)

    hp = hyperparams(args)
    t0 = time.perf_counter()
    result = run_seeds_compiled(
        lambda preds: make_coda(preds, hp, name=args.method, device=dev),
        dataset.preds, dataset.labels, iters=args.iters, seeds=args.seeds,
        loss_fn=loss_fn, device=dev)
    regrets = result.regret.cpu().numpy()            # (seeds, iters)
    wall = time.perf_counter() - t0
    cums = result.cumulative_regret.cpu().numpy()
    stoch = result.stochastic.cpu().numpy()
    steps = args.iters * args.seeds
    how = ("seeds run as one batch" if hp.n_parallel > 1
           else "seeds run one after another")
    print(f"{steps} selection steps in {wall:.2f}s "
          f"({steps / wall:.2f} steps/s, {how})")
    if dev.type == "cuda":
        print(f"peak device memory "
              f"{torch.cuda.max_memory_allocated(dev) / 1e9:.2f} GB")
    for s in range(args.seeds):
        print(f"seed {s}: regret@{args.iters}={regrets[s, -1]:.4f} "
              f"cumulative={cums[s, -1]:.4f} stochastic={bool(stoch[s])}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
