"""Command line for the port's single-task run (counterpart of the
single-task run of ``coda_tpu/cli.py``).

    python -m coda_tpu_torch.cli --synthetic 1000,50000,10 --method coda \\
        --iters 20
    python -m coda_tpu_torch.cli --synthetic 1000,50000,10 --method coda \\
        --eig-refresh fused --eig-cache-dtype bfloat16 --iters 20 --seeds 1
    python -m coda_tpu_torch.cli --synthetic 500,256,1000 --method coda \\
        --posterior sparse:32 --eig-mode incremental --eig-chunk 64
    python -m coda_tpu_torch.cli --task digits --data-dir data --method coda \\
        --device cpu

Runs a method on the card (``--device cuda``, the default) and prints the
reference CLI's per-seed ``seed s: regret@T=... cumulative=...
stochastic=...`` lines. ``--method`` defaults to ``iid``, as in the
reference, and takes its names: ``iid``, ``uncertainty``, any ``coda*``,
``activetesting``, ``vma``, ``model_picker``. More than one CODA seed runs
as one batch on every EIG tier unless ``--eig-refresh fused`` or
``--acq-batch`` Q > 1, whose seeds run one after another, as the
baselines' do; ``n_parallel``, the auto
tier's replica count, is the batch's width, as in the reference. So the
paper's command at the headline, ``--synthetic 1000,50000,10 --method
coda`` with the default 5 seeds, resolves to the factored tier, as the
reference's resolver does (5 fp32 caches and delta layouts pass its 4 GiB
budget).

The CODA flags are the reference's, with its choices: ``--eig-mode``,
``--eig-precision``, ``--eig-cache-dtype``, ``--eig-refresh``,
``--eig-entropy``, ``--posterior``, ``--eig-pbest``, ``--pi-update``,
``--prefilter-n``, ``--q``, ``--no-diag-prior``, ``--eig-scorer
exact|surrogate:k`` and ``--surrogate-prior off|pool``.

``--mesh data=K`` shards the ``(H, N, C)`` tensor over N, ``model=K``
over H (the candidate models), ``data=a,model=b`` over both, one process
a shard (``coda_tpu_torch/parallel``): start it under ``torchrun``, which
sets each rank's environment, e.g. ``python -m torch.distributed.run
--nproc-per-node 4 -m coda_tpu_torch.cli --synthetic 1000,50000,10
--method coda --mesh data=2,model=2`` (add ``--device cpu`` on the CPU).
Every rank runs the same rounds on its block and reaches the same
decisions; rank 0 alone prints and writes the tracking store. Ranks
sharing one card talk over gloo, ranks with a card each over NCCL. A mesh
without enough ranks raises the reference's "needs" error, a task whose
H the model axis does not divide the reference's placement error.
``--record-dir`` records a mesh run (rank 0 writes the record, the mesh
among its knobs and the whole task's digest), which ``cli replay``
re-executes under ``torchrun`` on as many ranks; ``--checkpoint-dir``
saves each rank's blocks under ``D/seed_<s>/rank_<r>``; ``--debug-viz``
replays the labels on every rank and logs from rank 0. Every other flag
runs on a mesh too: ``--posterior sparse:K``, ``--eig-pbest amortized``,
``--prefilter-n``, ``--acq-batch`` above 1, ``--eig-scorer surrogate:k``
(with ``--surrogate-prior``) and a noisy ``--oracle-noise``
(``--acq-batch`` or ``--oracle-noise`` with ``--checkpoint-dir`` stays
refused, as unsharded); ``--profile-dir`` traces rank 0. The serve verbs
run one process, as the reference's ``serve`` does, and refuse to start
under ``torchrun``.
``--acq-batch Q`` labels Q points a round (``--iters`` counts rounds, so a
run takes Q x iters labels; the cumulative regret is label-weighted).
``--record-dir`` writes a flight-recorder record (schema v4, the
reference's ``record.json`` + ``rounds.npz``) that ``python -m
coda_tpu_torch.cli replay <dir>`` re-executes and the reference's
``replay`` reads too. ``python -m coda_tpu_torch.cli serve ...`` runs the
labeling service (``serve/server.py``), ``replay-serve <dir>`` verifies its
session streams bitwise (exit 2 on a divergence), ``quality --url U``
reads a server's decision-quality scorecard (exit 1 on a diverged audit,
a miscalibration or a firing drift detector; pointed at a fleet router it
reads each replica's scorecard and the fleet verdict), and ``trace <id>
--url U --out F`` writes one distributed trace, stitched across a fleet's
process lanes, as Chrome/Perfetto JSON.

``--oracle-noise SPEC`` labels with a noisy crowd (``crowd/``): each
answer is a vote of ``votes`` annotators from a seeded pool, aggregated by
a Dawid-Skene reliability posterior and applied through the weighted
update; ``--oracle-annotators`` and ``--oracle-reliability`` override the
spec, a clean spec runs the plain engine, and ``--checkpoint-dir`` is
refused with it, as in the reference. ``--telemetry-dir D`` writes
``trace.json`` (the ``load_dataset`` and ``experiment`` spans),
``telemetry.json`` (kernel builds and launches, the device memory
watermarks, the analytic cost book) and ``metrics.prom`` there;
``--profile-dir`` captures a ``torch.profiler`` trace (CPU and CUDA
activity) of the experiment; ``--no-cost-capture`` turns the cost book
off; ``--debug-viz`` logs each seed's regret curve and final P(best) as
PNG artifacts of the tracking store (it needs matplotlib).

Every seed's ``regret`` and ``cumulative regret`` series go to the
tracking store (``--tracking-db``, default ``coda.sqlite``, the
reference's MLflow-schema sqlite; ``--no-mlflow`` turns it off): a parent
run ``<experiment>-<method>`` and a child run a seed, the experiment
named ``--experiment-name`` or the task. A seed whose run finished is
skipped ("Seed N finished. Skipping.") unless ``--force-rerun``.

``--checkpoint-dir D`` makes the run resumable: seeds run one after
another (``n_parallel`` 1), each saving its state every
``--checkpoint-every`` rounds under ``D/seed_<s>/step_<r>``
(``engine/checkpoint.py``); the same command after a cut resumes from the
newest checkpoint, bitwise the uninterrupted run. It refuses
``--record-dir`` and ``--acq-batch`` > 1, as the reference does.

Two subcommands:

    python -m coda_tpu_torch.cli replay <record-dir> [--against DIR] ...
    python -m coda_tpu_torch.cli suite --pred-dir data --db coda.sqlite ...

``replay`` re-executes a flight-recorder record and triages any
divergence (``engine/replay.py``; exit 0 on PARITY, 2 on DIVERGED);
``suite`` sweeps tasks x methods x seeds in one process
(``coda_tpu_torch/run_suite.py``, ``engine/suite.py``,
``engine/scheduler.py``).
"""

from __future__ import annotations

import argparse
import contextlib
import os
import sys
import time
from typing import Optional


def parse_args(argv=None):
    p = argparse.ArgumentParser(
        description="CODA active model selection on the card (PyTorch/CUDA)")
    p.add_argument("--task", default=None, help="task name, e.g. digits")
    p.add_argument("--data-dir", default="data")
    p.add_argument("--synthetic", default=None, metavar="H,N,C",
                   help="run on a seeded synthetic task of this shape")
    p.add_argument("--iters", type=int, default=100)
    p.add_argument("--seeds", type=int, default=5)
    p.add_argument("--force-rerun", action="store_true",
                   help="Overwrite existing finished runs.")
    p.add_argument("--experiment-name", default=None)
    p.add_argument("--no-mlflow", action="store_true",
                   help="Disable tracking-store logging.")
    p.add_argument("--tracking-db", default="coda.sqlite",
                   help="Path of the sqlite tracking database.")
    p.add_argument("--loss", default="acc", choices=["acc", "ce"])
    p.add_argument("--method", default="iid",
                   help="{iid, uncertainty, coda*, activetesting, vma, "
                        "model_picker}")

    def _acq_batch(v):
        q = int(v)
        if q < 1:
            raise argparse.ArgumentTypeError(
                f"acq-batch must be >= 1, got {q}")
        return q

    p.add_argument("--acq-batch", type=_acq_batch, default=1, metavar="Q",
                   help="oracle labels acquired per round (default 1, the "
                        "paper's protocol). Q > 1 selects Q points a round "
                        "from one scoring pass (CODA: greedy EIG with an "
                        "information-overlap penalty; the others: their "
                        "top-Q or draws without replacement) and applies "
                        "the Q answers as one update (--iters counts "
                        "rounds: Q*iters labels)")
    p.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    p.add_argument("--compilation-cache-dir", default=None,
                   help="the directory the CUDA kernels are built into "
                        "and loaded from (ops/build.py; default "
                        "coda_tpu_torch/_build): a later run loads the "
                        "libraries an earlier one built, with no nvcc")
    p.add_argument("--record-dir", default=None,
                   help="decision flight recorder: write a per-round "
                        "provenance record (record.json + rounds.npz) "
                        "there")
    p.add_argument("--record-topk", type=int, default=8,
                   help="top-scored candidates the recorder keeps a round")
    # CODA prior knobs (same flags and defaults as the reference)
    p.add_argument("--alpha", default=0.9, type=float)
    p.add_argument("--learning-rate", default=0.01, type=float)
    p.add_argument("--multiplier", default=2.0, type=float)
    p.add_argument("--prefilter-n", type=int, default=0,
                   help="Randomly subsample n candidates per iteration.")
    p.add_argument("--no-diag-prior", action="store_true",
                   help="Disable diagonal prior (ablation 1).")
    p.add_argument("--q", default="eig",
                   help="Acquisition function {eig, iid, uncertainty} "
                        "(ablation 2).")

    def _epsilon(v):
        f = float(v)
        if not 0.0 < f < 1.0:
            raise argparse.ArgumentTypeError(
                f"epsilon must be in (0, 1), got {f}")
        return f

    p.add_argument("--epsilon", type=_epsilon, default=None,
                   help="ModelPicker epsilon in (0, 1); default: the "
                        "per-task tuned TASK_EPS table")
    p.add_argument("--eig-chunk", type=int, default=1024,
                   help="N-block of the cache build and the plain scoring")
    p.add_argument("--eig-mode", default="auto",
                   choices=["auto", "incremental", "factored", "rowscan",
                            "direct"],
                   help="EIG tier: auto picks incremental (the cached "
                        "(C, N, H) P(best) rows) while every batched "
                        "replica's cache fits the reference's budget, else "
                        "factored, else rowscan; direct is the reference "
                        "choreography's cross-check")
    # the numerics knobs (the reference's flags)
    p.add_argument("--eig-backend", default="auto",
                   type=lambda v: "jnp" if v == "plain" else v,
                   choices=["auto", "jnp", "pallas"],
                   help="scoring backend: auto (default) = the CUDA kernels "
                        "on the card, the plain PyTorch versions on the CPU; "
                        "jnp (the reference's name; plain is an alias) = "
                        "the plain versions everywhere; pallas (the "
                        "reference's name for its kernels) = auto")
    p.add_argument("--eig-precision", default="highest",
                   choices=["highest", "high", "default"],
                   help="precision of the EIG table products: highest = "
                        "fp32 (reference numerics); high = fp32 too (it "
                        "stands for the TPU's 3-pass bf16, which fp32 "
                        "meets); default = one TF32 pass (opt-in numerics; "
                        "no effect on the CPU)")
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
    p.add_argument("--posterior", default="dense", metavar="dense|sparse:K",
                   help="Dirichlet posterior: dense = the (H, C, C) "
                        "tensor; sparse:K keeps each class row as diagonal "
                        "+ top-K off-diagonal entries + one residual mass "
                        "(incremental tier only; sparse:K>=C is bitwise "
                        "dense)")
    p.add_argument("--eig-pbest", default="quad",
                   choices=["quad", "amortized"],
                   help="hypothetical P(best) row refresh: quad = the "
                        "Beta quadrature; amortized = logistic-normal "
                        "tables where the labelled row's concentration "
                        "holds the 2.34e-4 score contract (opt-in "
                        "numerics)")
    p.add_argument("--pi-update", default="auto",
                   choices=["auto", "delta", "exact"],
                   help="incremental pi-hat refresh: auto (= delta) adds "
                        "the label's exact increment (kernel 3); exact "
                        "recomputes the column from the posterior row")
    p.add_argument("--eig-scorer", default="exact",
                   metavar="exact|surrogate:k",
                   help="who scores the round: exact = the full scoring "
                        "pass; surrogate:k = a ridge regressor over cheap "
                        "per-candidate features scores all N, its top-k "
                        "and a rotating audit set are re-scored exactly, "
                        "and a trust gate (the 2.34e-4 score contract) "
                        "falls back to the full pass when violated; "
                        "warmup rounds are full (incremental tier, "
                        "precomputed refresh; seeds run one after another; "
                        "surrogate:k>=N equals exact)")
    p.add_argument("--surrogate-prior", default="off",
                   choices=["off", "pool"],
                   help="surrogate scorer only: pool seeds the fit from a "
                        "cross-session prior instead of zeros (the CLI "
                        "passes none, so its run is the cold program under "
                        "the pool knob)")
    p.add_argument("--mesh", default=None, metavar="AXIS=K,...",
                   help="shard the (H, N, C) tensor over N (data) and H "
                        "(model), e.g. 'data=2', 'model=2' or "
                        "'data=2,model=2': one process a shard, started "
                        "by python -m torch.distributed.run "
                        "--nproc-per-node <data*model>")
    p.add_argument("--checkpoint-dir", default=None,
                   help="resumable run: save the selector state every "
                        "--checkpoint-every rounds under "
                        "<dir>/seed_<s>/step_<r> and resume from the "
                        "newest (seeds run one after another)")
    p.add_argument("--checkpoint-every", type=int, default=25,
                   help="rounds between checkpoints (--checkpoint-dir)")
    # the crowd oracle (the reference's flags)
    p.add_argument("--oracle-noise", default=None, metavar="SPEC",
                   help="label with a noisy crowd instead of the clean "
                        "oracle: 'clean' or comma-separated k=v, e.g. "
                        "annotators=8,votes=3,acc=0.55:0.95,abstain=0.1,"
                        "adversarial=1,trust=32,reliability=learned,seed=0 "
                        "(votes aggregate through a Dawid-Skene "
                        "reliability posterior; answers apply through the "
                        "weighted update)")
    p.add_argument("--oracle-annotators", type=int, default=None,
                   help="override the spec's annotator pool size")
    p.add_argument("--oracle-reliability", default=None,
                   choices=["learned", "majority"],
                   help="override the spec's vote aggregation")
    # telemetry (the reference's flags)
    p.add_argument("--telemetry-dir", default=None,
                   help="write trace.json (host spans), telemetry.json "
                        "(kernel builds and launches, device memory, the "
                        "analytic cost book) and metrics.prom there")
    p.add_argument("--profile-dir", default=None,
                   help="capture a torch.profiler trace (CPU and CUDA "
                        "activity) of the experiment into this directory")
    p.add_argument("--no-cost-capture", action="store_true",
                   help="do not harvest the analytic kernel costs")
    p.add_argument("--debug-viz", action="store_true",
                   help="log a regret curve and the final P(best) of each "
                        "seed as PNG artifacts of the tracking store "
                        "(needs matplotlib)")
    return p.parse_args(argv)


def load_dataset(args, mesh=None):
    """The task ``args`` name (``--synthetic`` or ``--task``), placed on
    ``args.device``; under a ``mesh`` this rank's block."""
    from coda_tpu_torch.data import Dataset, find_task_file, make_synthetic_task

    if args.synthetic:
        H, N, C = (int(x) for x in args.synthetic.split(","))
        return make_synthetic_task(seed=0, H=H, N=N, C=C,
                                   name=args.task or f"synthetic_{H}x{N}x{C}",
                                   device=args.device, mesh=mesh)
    if args.task is None:
        raise SystemExit("--task or --synthetic is required")
    fp = find_task_file(args.data_dir, args.task)
    if fp is None:
        raise SystemExit(
            f"No data file for task '{args.task}' under {args.data_dir}/")
    return Dataset.from_file(fp, name=args.task, device=args.device,
                             mesh=mesh)


def hyperparams(args):
    """The run's ``CODAHyperparams``. ``n_parallel`` is the number of
    replicas the engine batches — ``--seeds`` on every tier, 1 under the
    fused refresh, ``--acq-batch`` Q > 1 or ``--checkpoint-dir``, whose
    seeds run one after another — so the auto tier's budget sees every
    replica (the reference's rule). An ``args.n_parallel`` set by a caller
    with another execution width (a replay's recorded width, the suite's
    probe and remaining seeds) wins."""
    from coda_tpu_torch.selectors import CODAHyperparams
    from coda_tpu_torch.selectors.coda import batches_seeds

    hp = CODAHyperparams(prefilter_n=args.prefilter_n, alpha=args.alpha,
                         learning_rate=args.learning_rate,
                         multiplier=args.multiplier,
                         disable_diag_prior=args.no_diag_prior, q=args.q,
                         eig_chunk=args.eig_chunk, eig_mode=args.eig_mode,
                         eig_backend=("auto" if args.eig_backend == "pallas"
                                      else args.eig_backend),
                         eig_precision=args.eig_precision,
                         eig_cache_dtype=args.eig_cache_dtype,
                         eig_refresh=args.eig_refresh,
                         eig_entropy=args.eig_entropy,
                         posterior=args.posterior,
                         eig_pbest=args.eig_pbest,
                         eig_scorer=args.eig_scorer,
                         surrogate_prior=args.surrogate_prior,
                         pi_update=args.pi_update,
                         shard_spec=args.mesh or "")
    explicit = getattr(args, "n_parallel", None)
    if explicit:
        return hp._replace(n_parallel=int(explicit))
    batched = (args.seeds > 1 and args.acq_batch == 1 and batches_seeds(hp)
               and not getattr(args, "checkpoint_dir", None))
    return hp._replace(n_parallel=args.seeds if batched else 1)


def build_selector_factory(args, task_name: str):
    """``(preds, mesh=None) -> Selector`` for the configured method on
    ``args.device`` (the reference's ``build_selector_factory``:
    ActiveTesting and VMA get a label buffer of ``--iters``; ModelPicker
    takes ``--epsilon``, else the task's tuned value, else the default).
    ``mesh``: ``preds`` is this rank's block of a sharded task."""
    from coda_tpu_torch.losses import LOSS_FNS
    from coda_tpu_torch.parallel.distributed import is_primary
    from coda_tpu_torch.selectors import (
        SELECTOR_FACTORIES,
        TASK_EPS,
        make_coda,
        make_modelpicker,
    )

    loss_fn = LOSS_FNS[args.loss]
    method, dev = args.method, args.device
    if method.startswith("coda"):
        hp = hyperparams(args)
        return lambda preds, mesh=None: make_coda(preds, hp, name=method,
                                                  device=dev, mesh=mesh)
    if method == "model_picker":
        eps = args.epsilon
        if eps is None:
            eps = TASK_EPS.get(task_name)
        if eps is None:
            if is_primary():
                print(f"{task_name} not in TASK_EPS; using default")
            return lambda preds, mesh=None: make_modelpicker(
                preds, device=dev, mesh=mesh)
        return lambda preds, mesh=None: make_modelpicker(
            preds, epsilon=eps, device=dev, mesh=mesh)
    if method in ("activetesting", "vma"):
        return lambda preds, mesh=None: SELECTOR_FACTORIES[method](
            preds, loss_fn=loss_fn, budget=args.iters, device=dev, mesh=mesh)
    if method in SELECTOR_FACTORIES:
        return lambda preds, mesh=None: SELECTOR_FACTORIES[method](
            preds, loss_fn=loss_fn, device=dev, mesh=mesh)
    raise SystemExit(f"{method} is not a supported method.")


def build_selector(args, dataset):
    """The configured method's selector over ``dataset``'s predictions
    (under a mesh, its rank's block)."""
    factory = build_selector_factory(args, dataset.name)
    mesh = getattr(dataset, "mesh", None)
    return (factory(dataset.preds) if mesh is None
            else factory(dataset.preds, mesh=mesh))


def crowd_config(args):
    """The run's ``CrowdConfig`` from ``--oracle-noise`` and its overrides
    (the reference's dispatch), or None without the flag. An override that
    leaves no honest annotator is refused."""
    if args.oracle_noise is None:
        return None
    from coda_tpu_torch.crowd import parse_oracle_spec

    cfg = parse_oracle_spec(args.oracle_noise)
    if args.oracle_annotators:
        cfg = cfg._replace(annotators=int(args.oracle_annotators))
    if args.oracle_reliability:
        cfg = cfg._replace(reliability=args.oracle_reliability)
    if cfg.adversarial >= cfg.annotators:
        raise SystemExit(
            "--oracle-annotators override leaves no honest annotator "
            f"(adversarial={cfg.adversarial} of {cfg.annotators})")
    return cfg


def debug_pbest(factory, dataset, result, seed: int, dev):
    """The seed's final P(best) as a host array, or None for a method
    without a posterior: the recorded labels applied to a fresh selector
    through ``update`` (the reference's ``_log_debug_viz``). Under a mesh
    every rank calls this (``update`` runs collectives) on its block, and
    each gets every model's P(best) (``get_pbest`` gathers the model
    group's)."""
    import torch

    from coda_tpu_torch import random as trandom

    preds = dataset.preds.to(dev, torch.float32)
    selector = (factory(preds) if dataset.mesh is None
                else factory(preds, mesh=dataset.mesh))
    get_pbest = selector.extras.get("get_pbest")
    if get_pbest is None:
        return None
    state = selector.init(trandom.PRNGKey(seed))
    prob = torch.zeros((), device=dev)
    for idx, tc in zip(result.chosen_idx[seed].reshape(-1).tolist(),
                       result.true_class[seed].reshape(-1).tolist()):
        state = selector.update(state, torch.tensor(idx, device=dev),
                                torch.tensor(tc, device=dev), prob)
    return get_pbest(state).cpu().numpy()


def _log_debug_viz(run, result, seed: int, pbest) -> None:
    """The seed's regret curve and, for a method with a posterior, its
    final P(best) (:func:`debug_pbest`), as PNG artifacts of ``run``."""
    from coda_tpu_torch.utils.viz import plot_bar, plot_series

    regret = result.regret[seed].cpu().numpy()
    cum = result.cumulative_regret[seed].cpu().numpy()
    run.log_figure("regret_curve", plot_series(
        [regret, cum], title=f"seed {seed}", ylabel="regret",
        labels=["regret", "cumulative"]))
    if pbest is None:
        return
    n = result.chosen_idx[seed].numel()
    run.log_figure("pbest", plot_bar(
        pbest, title=f"P(best) after {n} labels (seed {seed})",
        highlight=int(pbest.argmax()), xlabel="model", ylabel="P(best)"))


def _log_to_store(args, dataset, result, regrets, cums, stoch, pbests,
                  telemetry=None) -> None:
    """The reference's tracking layout: parent run ``<experiment>-
    <method>`` with the run's flags as params, a child run a seed with
    the ``regret`` and ``cumulative regret`` series from step 1 (and,
    under ``--debug-viz``, its figures, with ``pbests[s]`` the seed's
    final P(best)); a seed whose run finished is skipped unless
    ``--force-rerun``. Telemetry's scalars go to a run
    ``<experiment>-<method>-telemetry``."""
    from coda_tpu_torch.tracking import TrackingStore

    store = TrackingStore(args.tracking_db)
    experiment = args.experiment_name or dataset.name
    run_name = f"{experiment}-{args.method}"
    with store.run(experiment, run_name, params=vars(args)) as parent:
        for s in range(args.seeds):
            seed_run = f"{experiment}-{args.method}-{s}"
            if store.is_finished(experiment, seed_run) \
                    and not args.force_rerun:
                print("Seed", s, "finished. Skipping.")
                continue
            with store.run(experiment, seed_run, parent=parent,
                           params={"seed": s,
                                   "stochastic": bool(stoch[s])}) as r:
                r.log_metric_series("regret", regrets[s], start_step=1)
                r.log_metric_series("cumulative regret", cums[s],
                                    start_step=1)
                if args.debug_viz:
                    _log_debug_viz(r, result, s, pbests[s])
        if not stoch.any():
            print("Method is not stochastic for this task.")
    if telemetry is not None:
        telemetry.flush_to_store(store, experiment=experiment,
                                 run_name=f"{run_name}-telemetry",
                                 params={"method": args.method})
    store.close()
    print(f"Logged to {args.tracking_db}")


def _write_record(args, dataset, result, aux, n_parallel: int, dev,
                  crowd=None, registry=None) -> None:
    """The run's flight-recorder record under ``--record-dir`` (the mesh
    among its knobs, the whole task's digest; rank 0 alone calls this
    under a mesh)."""
    from coda_tpu_torch.telemetry.recorder import (
        RunRecord,
        environment_fingerprint,
        knobs_from_args,
    )

    knobs = knobs_from_args(args)
    # the replica width the auto tier's budget saw (the reference's knob)
    knobs["n_parallel"] = n_parallel
    record = RunRecord.from_result(
        result, aux,
        environment_fingerprint(dataset=dataset, knobs=knobs, device=dev),
        run={"task": dataset.name, "synthetic": args.synthetic,
             "data_dir": args.data_dir, "method": args.method,
             "loss": args.loss, "iters": args.iters, "seeds": args.seeds,
             "acq_batch": args.acq_batch},
        crowd=crowd)
    record.save(args.record_dir, registry=registry)
    print(f"decision record written to {args.record_dir} (replay: python "
          f"-m coda_tpu_torch.cli replay {args.record_dir})")


def _run_resumable(args, factory, dataset, loss_fn, dev,
                   timings: Optional[list] = None):
    """The ``--checkpoint-dir`` run: seeds one after another, each through
    ``make_resumable_runner`` under ``<dir>/seed_<s>`` (under a mesh each
    rank saves its blocks under ``<dir>/seed_<s>/rank_<r>``); the result
    stacked on a leading seed axis. ``timings``: the runner's save and
    restore entries."""
    import torch

    from coda_tpu_torch.engine import ExperimentResult, make_resumable_runner
    from coda_tpu_torch.oracle import true_losses

    if args.record_dir:
        raise SystemExit(
            "--record-dir does not compose with --checkpoint-dir: the "
            "chunked resumable scan is a different program from the "
            "recorded one, so the record could not honor the bitwise "
            "replay contract; drop one of the flags")
    if args.acq_batch > 1:
        raise SystemExit(
            "--acq-batch > 1 does not compose with --checkpoint-dir: "
            "the chunked resumable runner drives the single-label "
            "step; drop one of the flags")
    mesh = dataset.mesh
    preds = dataset.preds.to(dev, torch.float32)
    labels = dataset.labels.to(dev)
    runner = make_resumable_runner(
        factory(preds) if mesh is None else factory(preds, mesh=mesh),
        labels, true_losses(preds, labels, loss_fn, mesh=mesh),
        iters=args.iters, every=args.checkpoint_every,
        dataset_id=dataset.name, timings=timings, mesh=mesh)
    per_seed = [runner(s, os.path.join(args.checkpoint_dir, f"seed_{s}"))
                for s in range(args.seeds)]
    return ExperimentResult(*(torch.stack(f) for f in zip(*per_seed)))


def run_all_seeds(args, factory, dataset, loss_fn, dev):
    """``(ExperimentResult, RunTraceAux | None, CrowdAux | None)``: the
    flight recorder's sidecar under ``--record-dir``, the crowd's
    provenance under a noisy ``--oracle-noise`` (a clean spec runs the
    engine's paths below, as the reference's dispatch does)."""
    from coda_tpu_torch.engine import run_seeds_compiled

    q = args.acq_batch
    trace_k = args.record_topk if args.record_dir else 0
    mesh = dataset.mesh
    cfg = crowd_config(args)
    if cfg is not None and not cfg.clean:
        if args.checkpoint_dir:
            raise SystemExit(
                "--oracle-noise does not compose with --checkpoint-dir: "
                "the chunked resumable runner drives the perfect-oracle "
                "step; drop one flag")
        from coda_tpu_torch.crowd import (
            run_seeds_crowd,
            run_seeds_crowd_recorded,
        )

        common = dict(iters=args.iters, seeds=args.seeds, loss_fn=loss_fn,
                      acq_batch=q, device=dev, cost_label=args.method,
                      mesh=mesh)
        if trace_k:
            return run_seeds_crowd_recorded(
                factory, dataset.preds, dataset.labels, cfg,
                trace_k=trace_k, **common)
        result, crowd = run_seeds_crowd(factory, dataset.preds,
                                        dataset.labels, cfg, **common)
        return result, None, crowd
    if args.checkpoint_dir:
        return _run_resumable(args, factory, dataset, loss_fn, dev), \
            None, None
    out = run_seeds_compiled(factory, dataset.preds, dataset.labels,
                             iters=args.iters, seeds=args.seeds,
                             loss_fn=loss_fn, device=dev, trace_k=trace_k,
                             acq_batch=q, cost_label=args.method, mesh=mesh)
    result, aux = out if trace_k else (out, None)
    return result, aux, None


def _quality_report(card: dict) -> list:
    """Human lines for one decision-quality scorecard (replica shape —
    the per-replica half of a router card goes through this too)."""
    lines = []
    verdict = card.get("verdict") or {}
    if verdict:
        worst = verdict.get("worst_ece")
        lines.append("verdict: calibration=%s%s  audit=%s  drift=%s" % (
            verdict.get("calibration"),
            f" (worst ECE {worst:.4f})" if worst is not None else "",
            verdict.get("audit"), verdict.get("drift")))
    for task, cal in sorted((card.get("calibration") or {}).items()):
        ece, brier = cal.get("ece"), cal.get("brier")
        lines.append(
            f"  calibration[{task}]: n={cal.get('n')}"
            + (f" ece={ece:.4f}" if ece is not None else " ece=-")
            + (f" brier={brier:.4f}" if brier is not None else ""))
    audit = card.get("audit") or {}
    if audit:
        lines.append(
            "  audit: %d replayed (%d rounds), %d skipped, "
            "%d divergence(s) (%d recent), %d tampered" % (
                audit.get("audits_total", 0),
                audit.get("rounds_verified", 0),
                audit.get("audits_skipped", 0),
                audit.get("divergences_total", 0),
                audit.get("divergences_recent", 0),
                audit.get("tampered_total", 0)))
        gap = audit.get("prior_gap")
        if gap is not None:
            lines.append(f"  audit: seeded-vs-cold prior gap "
                         f"{gap:.3f} over "
                         f"{audit.get('prior_gap_sessions')} session(s)")
        for d in audit.get("last_divergences") or ():
            lines.append(f"    diverged: session {d.get('session')} "
                         f"round {d.get('round')}: {d.get('detail')}")
    for name, det in sorted((card.get("drift") or {}).items()):
        lines.append(
            "  drift[%s]: %s stat=%.4f fired=%d cleared=%d obs=%d" % (
                name, "FIRING" if det.get("firing") else "ok",
                det.get("statistic") or 0.0, det.get("fired_total", 0),
                det.get("cleared_total", 0), det.get("observations", 0)))
    return lines


def trace_main(argv=None):
    """``cli trace <trace_id> --url http://host:port --out trace.json``.

    Hits the serve front door's ``GET /trace/id/{trace_id}``. Against a
    router that is the cross-process stitched Chrome file (one Perfetto
    process lane per replica); against a single replica it is that
    replica's own spans for the trace, wrapped for the same viewer."""
    import json as _json
    import urllib.request

    p = argparse.ArgumentParser(
        prog="coda_tpu_torch.cli trace",
        description="fetch one distributed trace as Chrome/Perfetto JSON")
    p.add_argument("trace_id", help="32-hex trace id (from an exemplar, a "
                   "recorder row, or a traced client)")
    p.add_argument("--url", default="http://127.0.0.1:8000",
                   help="serve front door (router or replica) base URL")
    p.add_argument("--out", default="trace.json",
                   help="output path for the Chrome trace_event JSON")
    args = p.parse_args(argv)

    url = args.url.rstrip("/") + f"/trace/id/{args.trace_id}"
    with urllib.request.urlopen(url, timeout=30.0) as resp:
        payload = _json.loads(resp.read().decode("utf-8"))
    if "traceEvents" not in payload:
        # a bare replica returns its trace_payload wire form; wrap it so
        # the output is always Perfetto-loadable
        from coda_tpu_torch.telemetry.spans import stitch_traces

        payload = stitch_traces(
            [dict(payload, process=payload.get("process") or "replica")])
    n = len([e for e in payload.get("traceEvents", ())
             if e.get("ph") == "X"])
    procs = payload.get("processes")
    with open(args.out, "w") as f:
        _json.dump(payload, f)
    print(f"trace {args.trace_id}: {n} span(s)"
          + (f" across {procs}" if procs else "")
          + f" -> {args.out}")
    if n == 0:
        print("warning: no spans retained for this trace "
              "(evicted, unsampled, or tracing disabled)")
        return 1
    return 0


def quality_main(argv=None):
    """``cli quality --url http://host:port``: the decision-quality
    report. Hits ``GET /fleet/quality`` (router: per-replica scorecards
    + fleet verdict; replica: its own plane), falls back to the
    ``quality`` section of ``/stats``; exits 1 when any organ grades
    diverged / miscalibrated / firing."""
    import json as _json
    import urllib.error
    import urllib.request

    p = argparse.ArgumentParser(
        prog="coda_tpu_torch.cli quality",
        description="decision-quality scorecard: live calibration, drift "
                    "detectors, shadow-audit divergences")
    p.add_argument("--url", default="http://127.0.0.1:8000",
                   help="serve front door (router or replica) base URL")
    p.add_argument("--json", action="store_true",
                   help="print the raw scorecard JSON instead of the "
                        "report")
    args = p.parse_args(argv)

    base = args.url.rstrip("/")
    try:
        with urllib.request.urlopen(base + "/fleet/quality",
                                    timeout=30.0) as resp:
            card = _json.loads(resp.read().decode("utf-8"))
    except urllib.error.HTTPError as e:
        if e.code != 404:
            raise
        # --no-quality replica, or a server without the plane: try /stats
        with urllib.request.urlopen(base + "/stats", timeout=30.0) as resp:
            stats = _json.loads(resp.read().decode("utf-8"))
        card = stats.get("quality")
        if card is None:
            print("quality plane disabled on this server (--no-quality)")
            return 1
    if args.json:
        print(_json.dumps(card, indent=2, sort_keys=True))
    lines = []
    if card.get("role") == "router":
        verdict = card.get("verdict") or {}
        worst = verdict.get("worst_ece")
        lines.append("fleet verdict: calibration=%s%s  audit=%s  "
                     "drift=%s" % (
                         verdict.get("calibration"),
                         f" (worst ECE {worst:.4f})"
                         if worst is not None else "",
                         verdict.get("audit"), verdict.get("drift")))
        for rid, rep in sorted((card.get("replicas") or {}).items()):
            if rep.get("error"):
                lines.append(f"replica {rid}: ERROR {rep['error']}")
            elif rep.get("enabled") is False:
                lines.append(f"replica {rid}: quality plane disabled")
            else:
                lines.append(f"replica {rid}:")
                lines.extend(_quality_report(rep))
        bad = verdict
    else:
        lines.extend(_quality_report(card))
        bad = card.get("verdict") or {}
    if not args.json:
        print("\n".join(lines) if lines else "no quality evidence yet")
    ok = (bad.get("audit") != "diverged"
          and bad.get("calibration") != "miscalibrated"
          and bad.get("drift") != "firing")
    return 0 if ok else 1


def refuse_serve_on_mesh(verb: str) -> None:
    """The serve verbs run one process, as the reference's ``serve`` does
    (it takes no ``--mesh``); under ``torchrun`` (more than one rank) they
    refuse to start."""
    if int(os.environ.get("WORLD_SIZE", "1")) > 1:
        raise SystemExit(
            f"cli {verb} runs one process, as the reference's serve does; "
            "start it without torchrun")


def main(argv=None):
    argv = sys.argv[1:] if argv is None else argv
    if argv and argv[0] in ("serve", "replay-serve"):
        refuse_serve_on_mesh(argv[0])
    if argv and argv[0] == "serve":
        from coda_tpu_torch.serve.server import main as serve_main

        return serve_main(argv[1:])
    if argv and argv[0] == "replay-serve":
        # offline bitwise verification of serve session streams
        from coda_tpu_torch.serve.recovery import replay_serve_main

        return replay_serve_main(argv[1:])
    if argv and argv[0] == "quality":
        return quality_main(argv[1:])
    if argv and argv[0] == "trace":
        # one distributed trace, stitched across a fleet's process lanes
        return trace_main(argv[1:])
    if argv and argv[0] == "replay":
        from coda_tpu_torch.engine.replay import replay_main

        return replay_main(argv[1:])
    if argv and argv[0] == "suite":
        from coda_tpu_torch.run_suite import main as suite_main

        return suite_main(argv[1:])
    args = parse_args(argv)
    if not args.mesh:
        return _main(args, None)
    import torch.distributed as dist

    from coda_tpu_torch.parallel.distributed import initialize, shutdown
    from coda_tpu_torch.parallel.mesh import mesh_from_spec

    joined = not dist.is_initialized()
    initialize(device=args.device)
    try:
        return _main(args, mesh_from_spec(args.mesh, device=args.device))
    finally:
        if joined:
            shutdown()


def _main(args, mesh):
    """The single-task run, on ``mesh`` (this rank's block) or alone."""
    import torch

    from coda_tpu_torch.losses import LOSS_FNS
    from coda_tpu_torch.oracle import best_loss as lowest_loss
    from coda_tpu_torch.oracle import true_losses
    from coda_tpu_torch.telemetry import costs
    from coda_tpu_torch.utils.platform import device_name, resolve_device
    from coda_tpu_torch.utils.profiling import trace as profiler_trace

    primary = mesh is None or mesh.rank == 0
    say = print if primary else (lambda *a, **k: None)
    dev = mesh.device if mesh is not None else resolve_device(args.device)
    if args.no_cost_capture:
        costs.set_enabled(False)
    if getattr(args, "compilation_cache_dir", None):
        from coda_tpu_torch.ops import build

        build.set_build_dir(args.compilation_cache_dir)
    if args.debug_viz:
        # before the run: a missing matplotlib fails here, not after it
        from coda_tpu_torch.utils.viz import _pyplot

        _pyplot()
    crowd_config(args)    # the spec's errors before any work
    # telemetry before any kernel build, so the build hook sees them all
    telemetry = None
    if args.telemetry_dir:
        from coda_tpu_torch.telemetry import Telemetry

        telemetry = Telemetry(out_dir=args.telemetry_dir)

    def tele_span(name, **attrs):
        return (telemetry.span(name, lane="host:main", annotate=True,
                               **attrs)
                if telemetry is not None else contextlib.nullcontext())

    say("device:", device_name(dev))
    with tele_span("load_dataset"):
        # one argument unsharded: callers replace load_dataset with a
        # function of the args alone (a task already built)
        dataset = (load_dataset(args) if mesh is None
                   else load_dataset(args, mesh))
    H, N, C = dataset.shape
    where = ""
    if mesh is not None:
        models = (f" and {H // mesh.model} models" if mesh.model > 1
                  else "")
        where = f", {N // mesh.data} items{models} a rank on {mesh.spec}"
    say(f"Loaded preds of shape ({H}, {N}, {C}){where}")
    if dataset.labels is None:
        raise SystemExit("Oracle needs labels!")
    loss_fn = LOSS_FNS[args.loss]
    best_loss = float(lowest_loss(true_losses(
        dataset.preds, dataset.labels, loss_fn, mesh=mesh), mesh))
    say("Best possible loss is", best_loss)

    factory = build_selector_factory(args, dataset.name)
    coda = args.method.startswith("coda")
    q = args.acq_batch
    n_parallel = hyperparams(args).n_parallel if coda else max(1, args.seeds)
    if coda:
        from coda_tpu_torch.selectors.coda import resolve_eig_mode

        say(f"EIG tier: {resolve_eig_mode(hyperparams(args), H, N, C)} "
            f"(n_parallel={n_parallel})")
    t0 = time.perf_counter()
    # under a mesh rank 0 alone writes the profile (one trace file)
    with profiler_trace(args.profile_dir if primary else None, dev):
        with tele_span("experiment", method=args.method, iters=args.iters,
                       seeds=args.seeds):
            result, aux, crowd = run_all_seeds(args, factory, dataset,
                                               loss_fn, dev)
            regrets = result.regret.cpu().numpy()    # (seeds, iters)
    wall = time.perf_counter() - t0
    if args.profile_dir:
        say(f"Profiler trace written to {args.profile_dir}")
    if telemetry is not None:
        telemetry.sample_devices([dev])
    if aux is not None and primary:
        _write_record(args, dataset, result, aux, n_parallel, dev, crowd,
                      telemetry.registry if telemetry is not None else None)
    pbests = None
    if args.debug_viz and not args.no_mlflow:
        # every rank replays the labels (update runs collectives)
        pbests = [debug_pbest(factory, dataset, result, s, dev)
                  for s in range(args.seeds)]
    cums = result.cumulative_regret.cpu().numpy()
    stoch = result.stochastic.cpu().numpy()
    steps = args.iters * args.seeds
    how = ("seeds run as one batch" if coda and n_parallel > 1
           else "seeds run one after another")
    batch_note = f", {q} labels/round" if q > 1 else ""
    say(f"{steps} selection steps in {wall:.2f}s "
        f"({steps / wall:.2f} steps/s, {how}{batch_note})")
    if dev.type == "cuda":
        say(f"peak device memory "
            f"{torch.cuda.max_memory_allocated(dev) / 1e9:.2f} GB"
            + (" (rank 0)" if mesh else ""))
    for s in range(args.seeds):
        say(f"seed {s}: regret@{args.iters}={regrets[s, -1]:.4f} "
            f"cumulative={cums[s, -1]:.4f} stochastic={bool(stoch[s])}")
    if not primary:
        return 0
    if not args.no_mlflow:
        _log_to_store(args, dataset, result, regrets, cums, stoch, pbests,
                      telemetry)
    if telemetry is not None:
        paths = telemetry.write(extra={
            "run": {"task": dataset.name, "method": args.method,
                    "iters": args.iters, "seeds": args.seeds,
                    "wall_s": round(wall, 4)}})
        print(f"Telemetry written to {args.telemetry_dir} "
              f"({', '.join(sorted(paths))})")
    return 0


if __name__ == "__main__":
    sys.exit(main())
