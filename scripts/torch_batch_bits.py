#!/usr/bin/env python3
"""Whether a seed batch of the port is bitwise its seeds run one after
another on the card, and what the batched CODA round costs.

    python scripts/torch_batch_bits.py [--root DIR] [--out FILE.json]

For the checkout at ``--root`` (default: this one) it prints one JSON line:

  * ``refresh``: the class-row refresh ``selectors.coda.
    update_eig_cache_parts`` of S = 3 replicas in one batched call against
    three one-replica calls, on seeded random posteriors at
    ``digits_h80``'s shape (80, 899, 10) and at the headline (1000, 50000,
    10): whether the rows and the hypothetical rows are bitwise equal, and
    the largest difference;
  * ``digits_h80``: CODA on ``data/digits_h80.npz``, 3 seeds x 30 rounds
    as one batch against one seed after another: whether every field of
    the results is bitwise equal and in how many rounds ``select_prob``
    is; the same under the reference's noisy crowd spec where the
    checkout has the crowd oracle;
  * ``batched_ms``: the headline's 5-seed incremental batch, 10 rounds,
    three runs, ms a round on the host clock.

Run it on two checkouts in one call to compare them (a parent unpacked
with ``git archive <commit> coda_tpu_torch`` into a git-ignored
directory), in turns: parent, change, change, parent. It needs a CUDA
device.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os
import sys

CROWD_SPEC = ("annotators=8,votes=3,acc=0.6:0.95,abstain=0.1,"
              "adversarial=1,trust=16,seed=0")


def main() -> int:
    p = argparse.ArgumentParser()
    p.add_argument("--root", default=os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))))
    p.add_argument("--out", default=None)
    args = p.parse_args()
    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    sys.path.insert(0, os.path.abspath(args.root))
    import torch

    from coda_tpu_torch.data import Dataset, make_synthetic_arrays
    from coda_tpu_torch.engine import run_seeds_compiled
    from coda_tpu_torch.selectors import CODAHyperparams, make_coda
    from coda_tpu_torch.selectors.coda import update_eig_cache_parts
    from coda_tpu_torch.utils.platform import pin_fp32_matmul

    pin_fp32_matmul()
    dev = torch.device("cuda")
    out: dict = {"root": os.path.abspath(args.root), "refresh": {}}

    gen = torch.Generator(device=dev)
    gen.manual_seed(0)
    for (H, N, C) in ((80, 899, 10), (1000, 50_000, 10)):
        d = torch.rand((3, H, C, C), generator=gen, device=dev) * 3 + 0.5
        hard = torch.randint(0, C, (N, H), generator=gen, device=dev,
                             dtype=torch.int32)
        c = torch.tensor([1, 4, 7], device=dev)
        rows, hyps = update_eig_cache_parts(d, c, hard)
        one = [update_eig_cache_parts(d[s], c[s], hard) for s in range(3)]
        out["refresh"][f"{H}x{N}x{C}"] = {
            "rows_bitwise": all(torch.equal(rows[s], o[0])
                                for s, o in enumerate(one)),
            "hyp_bitwise": all(torch.equal(hyps[s], o[1])
                               for s, o in enumerate(one)),
            "max_abs_diff": max(float((hyps[s] - o[1]).abs().max())
                                for s, o in enumerate(one))}
        del d, hard, rows, hyps, one

    ds = Dataset.from_file(os.path.join(repo, "data", "digits_h80.npz"),
                           device=dev)
    S, T = 3, 30

    def factory(sequential):
        hp = CODAHyperparams(eig_chunk=1024, n_parallel=S)

        def f(preds):
            sel = make_coda(preds, hp, device=dev)
            return dataclasses.replace(sel, batched=None) if sequential \
                else sel
        return f

    def compare(a, b):
        """Bitwise equality of two runs' results (and crowd arrays)."""
        res_a, res_b = (a[0], b[0]) if isinstance(a[0], tuple) else (a, b)
        leaves = torch.utils._pytree.tree_leaves
        return {"bitwise": all(torch.equal(x, y) for x, y in
                               zip(leaves(a), leaves(b))),
                "select_prob_bitwise_rounds": int(
                    (res_a.select_prob == res_b.select_prob).all(0).sum()),
                "rounds": T}

    out["digits_h80"] = compare(
        run_seeds_compiled(factory(False), ds.preds, ds.labels, iters=T,
                           seeds=S, device=dev),
        run_seeds_compiled(factory(True), ds.preds, ds.labels, iters=T,
                           seeds=S, device=dev))
    try:
        from coda_tpu_torch.crowd import parse_oracle_spec, run_seeds_crowd
    except ImportError:
        run_seeds_crowd = None
    if run_seeds_crowd is not None:
        cfg = parse_oracle_spec(CROWD_SPEC)
        out["digits_h80_crowd"] = compare(
            run_seeds_crowd(factory(False), ds.preds, ds.labels, cfg,
                            iters=T, seeds=S, device=dev),
            run_seeds_crowd(factory(True), ds.preds, ds.labels, cfg,
                            iters=T, seeds=S, device=dev))
    del ds

    p_, y_ = make_synthetic_arrays(seed=0, H=1000, N=50_000, C=10)[:2]
    preds = torch.from_numpy(p_).to(dev)
    labels = torch.from_numpy(y_).to(dev)
    hp = CODAHyperparams(eig_chunk=1024, eig_mode="incremental",
                         n_parallel=5)
    out["batched_ms"] = []
    for _ in range(3):
        timings: list = []
        run_seeds_compiled(lambda q: make_coda(q, hp, device=dev), preds,
                           labels, iters=10, seeds=5, device=dev,
                           timings=timings)
        out["batched_ms"].append(timings[0]["rounds_ms"] / 10)
    out["device"] = torch.cuda.get_device_name(0)
    line = json.dumps(out)
    print(line, flush=True)
    if args.out:
        os.makedirs(os.path.dirname(os.path.abspath(args.out)),
                    exist_ok=True)
        with open(args.out, "a") as f:
            f.write(line + "\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())
