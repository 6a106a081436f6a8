"""The reference package's remaining public API in the port, each function
against its reference on seeded inputs, on the CPU.

* ``engine.run_experiment`` and ``engine.run_seeds`` on a built selector
  at (H, N, C) = (5, 48, 4): the decisions (chosen index, true class,
  best model) equal to the reference's, regret and selection probability
  within ``ATOL``; seed s of ``run_seeds`` (one batch with a replica axis
  where the selector has one) bitwise ``run_experiment(seed=s)``.
* ``build_recording_experiment_fn``: each seed's result and
  :class:`RoundTrace` bitwise ``run_seeds_recorded``'s; ``key_bits`` the
  identity on the port's keys.
* ``Oracle``: the labels, ``answer_batch`` (one host read) and the true
  losses, as the reference's.
* ``replay.record_calibration`` on the committed record
  ``runs/surrogate_r17/exact``: the reference's dict.
* ``selectors.coda.update_eig_cache``: the refreshed row and cache within
  ``ATOL`` of the reference's, the other rows untouched.
* ``ops.sparse_rows.scatter_rows`` with two answers on one class row:
  bitwise ``scatter_row`` in order, and within ``ATOL`` of the
  reference's fused scatter (the column indices equal).
* ``cli.build_selector``: the configured method over the dataset.

``ATOL = 1e-6`` (absolute): fp32 values of order 1 whose sums the two
packages reduce in different orders.
"""

from __future__ import annotations

import json
import os

import numpy as np
import pytest
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ATOL = 1e-6
SHAPE = (5, 48, 4)        # (H, N, C)
ITERS, SEEDS = 12, 3
METHODS = ("coda", "iid", "uncertainty", "vma")


@pytest.fixture(autouse=True)
def _one_torch_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _tasks():
    from coda_tpu.data import make_synthetic_task as jtask

    from coda_tpu_torch.data import make_synthetic_task as ttask

    H, N, C = SHAPE
    return jtask(0, H=H, N=N, C=C), ttask(0, H=H, N=N, C=C, device="cpu")


def _selectors(method, jtask, ttask):
    from coda_tpu.selectors import SELECTOR_FACTORIES as JF

    from coda_tpu_torch.selectors import SELECTOR_FACTORIES as TF

    kw = {"budget": ITERS} if method in ("activetesting", "vma") else {}
    return (JF[method](jtask.preds, **kw),
            TF[method](ttask.preds, device="cpu", **kw))


def _assert_trajectory(t, j, what):
    for f in ("chosen_idx", "true_class", "best_model"):
        np.testing.assert_array_equal(getattr(t, f).numpy(),
                                      np.asarray(getattr(j, f)),
                                      err_msg=f"{what}: {f}")
    for f in ("regret", "cumulative_regret", "select_prob", "regret_at_0"):
        np.testing.assert_allclose(getattr(t, f).numpy(),
                                   np.asarray(getattr(j, f)), rtol=0,
                                   atol=ATOL, err_msg=f"{what}: {f}")
    assert bool(t.stochastic.all()) == bool(np.asarray(j.stochastic).all())


def _assert_same(a, b, what):
    for f, x, y in zip(a._fields, a, b):
        assert torch.equal(x, y), f"{what}: {f} differs"


@pytest.mark.parametrize("method", METHODS)
def test_port_run_experiment_and_run_seeds_match_reference(method):
    from coda_tpu.engine import run_experiment as jrun_experiment
    from coda_tpu.engine import run_seeds as jrun_seeds

    from coda_tpu_torch.engine import run_experiment, run_seeds

    jtask, ttask = _tasks()
    jsel, tsel = _selectors(method, jtask, ttask)
    got = run_seeds(tsel, ttask, iters=ITERS, seeds=SEEDS)
    want = jrun_seeds(jsel, jtask, iters=ITERS, seeds=SEEDS)
    _assert_trajectory(got, want, f"{method} run_seeds")
    for s in range(SEEDS):
        one = run_experiment(tsel, ttask, iters=ITERS, seed=s)
        _assert_same(one, type(one)(*(f[s] for f in got)),
                     f"{method} seed {s}: run_seeds against run_experiment")
    _assert_trajectory(run_experiment(tsel, ttask, iters=ITERS, seed=1),
                       jrun_experiment(jsel, jtask, iters=ITERS, seed=1),
                       f"{method} run_experiment(seed=1)")


def test_port_run_seeds_batches_coda_replicas():
    """CODA has a seed-batched form, so ``run_seeds`` runs its seeds as one
    batch (one init launch of the batched scorer's plain version) and
    still gives each seed its one-seed run bitwise."""
    from coda_tpu_torch.engine import loop

    _, ttask = _tasks()
    from coda_tpu_torch.selectors import make_coda

    sel = make_coda(ttask.preds, device="cpu")
    assert loop.seeds_batch(sel)
    calls = []
    inner = loop.build_batched_experiment_fn

    def spy(*a, **k):
        calls.append(1)
        return inner(*a, **k)

    loop.build_batched_experiment_fn = spy
    try:
        got = loop.run_seeds(sel, ttask, iters=5, seeds=2,
                             model_losses=torch.zeros(SHAPE[0]))
    finally:
        loop.build_batched_experiment_fn = inner
    assert calls == [1]
    assert got.chosen_idx.shape == (2, 5)
    assert float(got.regret.abs().max()) == 0.0   # the given losses


def test_port_recording_fn_matches_run_seeds_recorded():
    from coda_tpu_torch import random as trandom
    from coda_tpu_torch.engine import (
        build_recording_experiment_fn,
        key_bits,
        run_seeds_recorded,
    )
    from coda_tpu_torch.oracle import true_losses
    from coda_tpu_torch.selectors import make_coda

    _, ttask = _tasks()
    res, aux = run_seeds_recorded(lambda p: make_coda(p, device="cpu"),
                                  ttask.preds, ttask.labels, iters=ITERS,
                                  seeds=SEEDS, device="cpu")
    sel = make_coda(ttask.preds, device="cpu")
    fn = build_recording_experiment_fn(
        sel, ttask.labels, true_losses(ttask.preds, ttask.labels), ITERS)
    for s in range(SEEDS):
        key = trandom.PRNGKey(s)
        r1, a1 = fn(key)
        _assert_same(r1, type(r1)(*(f[s] for f in res)), f"seed {s}")
        _assert_same(a1.trace, type(a1.trace)(*(f[s] for f in aux.trace)),
                     f"seed {s} trace")
        assert torch.equal(a1.root_key, aux.root_key[s])
        assert a1.trace.topk_idx.shape == (ITERS, 8)
        assert torch.equal(key_bits(key), key)
        assert key_bits(key).dtype == torch.int64
    # trace_k = 0 still records one candidate a round (the reference's
    # clamp)
    _, a0 = build_recording_experiment_fn(
        sel, ttask.labels, true_losses(ttask.preds, ttask.labels), 3,
        trace_k=0)(trandom.PRNGKey(0))
    assert a0.trace.topk_idx.shape == (3, 1)


def test_port_key_bits_matches_reference_words():
    import jax

    from coda_tpu.engine.loop import key_bits as jkey_bits

    from coda_tpu_torch import random as trandom
    from coda_tpu_torch.engine import key_bits

    for seed in (0, 7, 2 ** 31 + 5):
        j = np.asarray(jkey_bits(jax.random.PRNGKey(seed)))
        np.testing.assert_array_equal(
            key_bits(trandom.PRNGKey(seed)).numpy(), j.astype(np.int64))


def test_port_oracle_matches_reference():
    from coda_tpu import Oracle as JOracle

    from coda_tpu_torch import Oracle

    jtask, ttask = _tasks()
    jo, to = JOracle(jtask), Oracle(ttask)
    rng = np.random.default_rng(3)
    idxs = rng.integers(0, SHAPE[1], 7)
    assert [to(i) for i in idxs] == [jo(int(i)) for i in idxs]
    assert to.answer_batch(idxs) == jo.answer_batch(idxs)
    assert to.answer_batch(torch.from_numpy(idxs)) == jo.answer_batch(idxs)
    assert to.answer_batch(list(idxs)) == [to(i) for i in idxs]
    np.testing.assert_allclose(to.true_losses(ttask.preds).numpy(),
                               np.asarray(jo.true_losses(jtask.preds)),
                               rtol=0, atol=ATOL)
    with pytest.raises(ValueError, match="labels"):
        Oracle(type(ttask)(preds=ttask.preds, labels=None))


def _canonical(x):
    return json.loads(json.dumps(x, default=float))


def test_port_record_calibration_matches_reference():
    from coda_tpu.engine.replay import record_calibration as jcal
    from coda_tpu.telemetry.recorder import RunRecord as JRecord

    from coda_tpu_torch.engine.replay import record_calibration
    from coda_tpu_torch.telemetry.recorder import RunRecord

    path = os.path.join(ROOT, "runs", "surrogate_r17", "exact")
    got = record_calibration(RunRecord.load(path))
    want = jcal(JRecord.load(path))
    assert len(got["seeds"]) == 3
    assert _canonical(got) == _canonical(want)


@pytest.mark.parametrize("cache_dtype", ["float32", "bfloat16"])
def test_port_update_eig_cache_matches_reference(cache_dtype):
    import jax.numpy as jnp

    from coda_tpu.selectors.coda import update_eig_cache as jupdate

    from coda_tpu_torch.selectors.coda import update_eig_cache

    H, N, C, G = 6, 40, 5, 64
    rng = np.random.default_rng(11)
    d = (rng.uniform(0.1, 1.0, (H, C, C)) + 2.0 * np.eye(C)).astype(
        np.float32)
    hard = rng.integers(0, C, (N, H)).astype(np.int32)
    rows = rng.uniform(0, 1, (C, H)).astype(np.float32)
    hyp = rng.uniform(0, 1, (C, N, H)).astype(np.float32)
    c = 3
    jdt = jnp.bfloat16 if cache_dtype == "bfloat16" else jnp.float32
    want_rows, want_hyp = jupdate(
        jnp.asarray(d), jnp.asarray(c), jnp.asarray(hard), jnp.asarray(rows),
        jnp.asarray(hyp).astype(jdt), num_points=G)
    t_rows = torch.from_numpy(rows.copy())
    t_hyp = torch.from_numpy(hyp).to(getattr(torch, cache_dtype))
    before = t_hyp.clone()
    got_rows, got_hyp = update_eig_cache(
        torch.from_numpy(d), torch.tensor(c), torch.from_numpy(hard), t_rows,
        t_hyp, num_points=G)
    assert got_rows is t_rows and got_hyp is t_hyp      # in place
    np.testing.assert_allclose(got_rows.numpy(), np.asarray(want_rows),
                               rtol=0, atol=ATOL)
    # bf16 storage: the fp32 values within ATOL may round to neighbouring
    # bf16 values, one bf16 ulp apart at most
    tol = ATOL if cache_dtype == "float32" else 2.0 ** -8
    np.testing.assert_allclose(got_hyp.float().numpy(),
                               np.asarray(want_hyp.astype(jnp.float32)),
                               rtol=0, atol=tol)
    keep = [r for r in range(C) if r != c]
    assert torch.equal(got_hyp[keep], before[keep])
    np.testing.assert_array_equal(got_rows[keep].numpy(), rows[keep])


@pytest.mark.parametrize("k", [3, 12])
@pytest.mark.parametrize("weighted", [False, True])
def test_port_scatter_rows_sequences_collisions(k, weighted):
    import jax.numpy as jnp

    from coda_tpu.ops import sparse_rows as jsr

    from coda_tpu_torch.ops import sparse_rows as tsr

    H, C, lr = 5, 12, 0.05
    rng = np.random.default_rng(7)
    d = (rng.uniform(0.05, 1.0, (H, C, C)) + 3.0 * np.eye(C)).astype(
        np.float32)
    j = jsr.sparsify(jnp.asarray(d), k)
    classes = np.array([4, 9, 4, 2, 4], np.int32)     # row 4 three times
    preds = rng.choice([1, 2, 7, 4, 10], (len(classes), H)).astype(np.int32)
    w = (rng.uniform(0.2, 1.0, len(classes)).astype(np.float32)
         if weighted else None)

    def fresh():
        return tsr.SparseRows(*(torch.from_numpy(np.array(x)) for x in j))

    got = tsr.scatter_rows(fresh(), torch.from_numpy(classes),
                           torch.from_numpy(preds), lr,
                           weights=None if w is None else torch.from_numpy(w))
    seq = fresh()
    for q in range(len(classes)):
        tsr.scatter_row(seq, torch.tensor(int(classes[q])),
                        torch.from_numpy(preds[q]), lr,
                        weight=None if w is None else torch.tensor(w[q]))
    for name, a, b in zip(tsr.SparseRows._fields, got, seq):
        assert torch.equal(a, b), f"{name}: not the sequential scatter"
    want = jsr.scatter_rows(j, jnp.asarray(classes), jnp.asarray(preds), lr,
                            weights=None if w is None else jnp.asarray(w))
    for name, a, b in zip(tsr.SparseRows._fields, got, want):
        if name == "idx":
            np.testing.assert_array_equal(a.numpy(), np.asarray(b))
        else:
            np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=0,
                                       atol=ATOL, err_msg=name)
    # q = 1 is scatter_row itself
    one = tsr.scatter_rows(fresh(), torch.from_numpy(classes[:1]),
                           torch.from_numpy(preds[:1]), lr)
    ref = tsr.scatter_row(fresh(), torch.tensor(int(classes[0])),
                          torch.from_numpy(preds[0]), lr)
    for a, b in zip(one, ref):
        assert torch.equal(a, b)


@pytest.mark.parametrize("method", ["coda", "model_picker"])
def test_port_build_selector(method):
    from coda_tpu_torch.cli import build_selector, load_dataset, parse_args

    args = parse_args(["--synthetic", "5,48,4", "--method", method,
                       "--device", "cpu", "--iters", "4"])
    ds = load_dataset(args)
    sel = build_selector(args, ds)
    assert sel.name == method
    from coda_tpu_torch.engine import run_experiment

    res = run_experiment(sel, ds, iters=4, seed=0)
    assert res.chosen_idx.shape == (4,)
