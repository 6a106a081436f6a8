"""Where the reference's serve slab leaves its ``InteractiveSelector``.

``tests/test_serve.py::test_serve_batch_step_parity_coda`` holds the
reference's ``Bucket`` (16 CODA sessions on a synthetic (5, 48, 4) task,
one ``lax.map`` dispatch a round) bitwise against 16 sequential
``InteractiveSelector`` sessions. This script re-runs that comparison
without asserting and reports, for each session, the first round at which
a served field (``next_idx``, ``best``, ``next_prob``) differs, and the
first round at which a state leaf differs (the slab's slot state against
the sequential state after the same round), with the size of each
difference. It edits nothing.

    python scripts/serve_parity_diag.py [--rounds 4] [--cap 16]
"""

from __future__ import annotations

import argparse
import json
import os
import sys

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--rounds", type=int, default=4)
    p.add_argument("--cap", type=int, default=16)
    args = p.parse_args(argv)

    import jax

    jax.config.update("jax_platforms", "cpu")
    import jax.numpy as jnp
    import numpy as np

    from coda_tpu.data import make_synthetic_task
    from coda_tpu.selectors import CODAHyperparams, make_coda
    from coda_tpu.selectors.protocol import InteractiveSelector
    from coda_tpu.serve import SelectorSpec, SessionStore

    task = make_synthetic_task(seed=0, H=5, N=48, C=4)
    labels = np.asarray(task.labels)
    cap, rounds = args.cap, args.rounds
    spec = SelectorSpec.create("coda", n_parallel=cap)
    store = SessionStore(capacity=cap)
    store.register_task("t", task.preds)
    sessions = [store.open("t", spec, seed=s) for s in range(cap)]
    bucket = sessions[0].bucket
    served = {se.seed: [] for se in sessions}
    states = {se.seed: [] for se in sessions}   # host leaves a round

    def keep(res):
        for se in sessions:
            se.last = res[se.slot]
            served[se.seed].append(res[se.slot])
            states[se.seed].append([
                None if x is None else np.asarray(x)
                for x in bucket.slot_state(se.slot)])

    keep(bucket.dispatch({se.slot: {"do_update": False}
                          for se in sessions}))
    for _ in range(rounds):
        keep(bucket.dispatch({
            se.slot: {"do_update": True, "idx": se.last["next_idx"],
                      "label": int(labels[se.last["next_idx"]]),
                      "prob": se.last["next_prob"]} for se in sessions}))

    sel = make_coda(jnp.asarray(task.preds), CODAHyperparams(n_parallel=cap))
    fields = type(bucket.slot_state(0))._fields
    report = {"jax": jax.__version__, "backend": jax.default_backend(),
              "step_impl": bucket.step_impl, "sessions": []}
    for se in sessions:
        ref = InteractiveSelector(sel, seed=se.seed)
        first = first_leaf = None
        idx, prob = ref.get_next_item_to_label()
        best = ref.get_best_model_prediction()
        for k in range(rounds + 1):
            if k:
                ref.add_label(idx, int(labels[idx]), prob)
                idx, prob = ref.get_next_item_to_label()
                best = ref.get_best_model_prediction()
            for name, a, b in zip(fields, ref.state, states[se.seed][k]):
                if a is None or first_leaf is not None:
                    continue
                a = np.asarray(a)
                if a.tobytes() != b.tobytes():
                    first_leaf = {
                        "round": k, "leaf": name,
                        "elements_differing": int((a != b).sum()),
                        "max_abs_diff": float(np.abs(
                            a.astype(np.float64) - b.astype(np.float64))
                            .max())}
            g = served[se.seed][k]
            for name, want, got in (("next_idx", idx, g["next_idx"]),
                                    ("best", best, g["best"]),
                                    ("next_prob", prob, g["next_prob"])):
                same = (np.float32(want).tobytes()
                        == np.float32(got).tobytes())
                if not same and first is None:
                    first = {"round": k, "field": name,
                             "sequential": float(want),
                             "slab": float(got),
                             "abs_diff": abs(float(want) - float(got))}
        leaves = []
        slab_state = bucket.slot_state(se.slot)
        for name, a, b in zip(fields, ref.state, slab_state):
            if a is None:
                continue
            a, b = np.asarray(a), np.asarray(b)
            if a.tobytes() != b.tobytes():
                diff = (np.abs(a.astype(np.float64) - b.astype(np.float64))
                        .max() if a.dtype.kind == "f" else None)
                leaves.append({"leaf": name, "max_abs_diff": diff,
                               "elements_differing": int(
                                   (a != b).sum())})
        report["sessions"].append({"seed": se.seed, "first": first,
                                   "first_state_leaf": first_leaf,
                                   "state_leaves_differing": leaves})
    print(json.dumps(report, indent=1, default=float))
    return 0


if __name__ == "__main__":
    sys.exit(main())
