"""The cross-session surrogate prior pool of the port
(``coda_tpu_torch/serve/priors.py`` and its ``ServeApp`` glue) on the CPU.

Inputs: seeded numpy fit statistics, and ``data/digits_h80.npz`` for the
serve runs, as the reference's ``tests/test_prior.py`` builds its own.
Tolerances:

  * ``PriorPool`` against the reference's on the same contributions,
    drained deltas, snapshots and replacements: every pool's ``A``, ``b``,
    ``n`` and ``rounds`` within 1e-6 (relative; both are float64 numpy
    folds), the counters and the pool keys equal;
  * within the port: bitwise. A session admitted after a donor closed
    carries the applied prior, and its import through the replay path
    reproduces its rows bitwise (the stream meta re-applies the prior).
"""

from __future__ import annotations

import os

import numpy as np
import pytest

try:
    import jax  # noqa: F401
except ImportError:  # a card machine without JAX
    jax = None

from coda_tpu_torch.data import Dataset
from coda_tpu_torch.selectors import surrogate as sg
from coda_tpu_torch.serve import PriorPool, SelectorSpec, ServeApp
from coda_tpu_torch.serve.priors import pool_key

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
DEV = "cpu"
F = sg.N_FEATURES

needs_jax = pytest.mark.skipif(jax is None, reason="needs the JAX reference")


def _fit(rng, rounds):
    X = rng.standard_normal((int(rng.integers(8, 40)), F))
    y = rng.standard_normal(X.shape[0])
    return {"A": (X.T @ X).astype(np.float32),
            "b": (X.T @ y).astype(np.float32),
            "n": np.float32(X.shape[0]), "rounds": np.int32(rounds),
            "fits": np.int32(rounds - 2)}


class _Clock:
    def __init__(self):
        self.t = 1000.0

    def __call__(self):
        self.t += 1.5
        return self.t


def _close(a: dict, b: dict) -> None:
    assert sorted(a["pools"]) == sorted(b["pools"])
    for k in a["pools"]:
        for f in ("A", "b", "n", "rounds", "sessions"):
            x, y = np.asarray(a["pools"][k][f]), np.asarray(b["pools"][k][f])
            assert np.allclose(x, y, rtol=1e-6, atol=0.0), (k, f)


@needs_jax
def test_reference_prior_pool_matches_the_reference():
    """The same contributions (a green one skipped), drains, delta merges,
    snapshots and replacements in both pools: equal within 1e-6, with
    the same counters, keys and staleness ages."""
    from coda_tpu.serve.priors import PriorPool as RefPool
    from coda_tpu.serve.priors import pool_key as ref_key

    kw = [("eig_mode", "incremental"), ("eig_scorer", "surrogate:8"),
          ("surrogate_prior", "pool")]
    assert pool_key("t", "coda", kw, "d1") == ref_key("t", "coda", kw, "d1")
    ours, theirs = PriorPool(clock=_Clock()), RefPool(clock=_Clock())
    for pool in (ours, theirs):
        rng = np.random.default_rng(0)
        for i in range(7):
            key = f"t:{i % 2}"
            pool.contribute(key, _fit(rng, 4 if i == 3 else 12 + i))
        delta = pool.drain_delta()
        pool.merge_delta(delta, count=False)
        pool.merge_delta({"t:9": sg.prior_to_dict(sg.prior_from_fit(
            **{k: v for k, v in _fit(rng, 20).items() if k != "fits"}))})
    a, b = ours.snapshot(), theirs.snapshot()
    _close(a, b)
    assert a["touched"] == b["touched"]
    assert a["sessions_contributed"] == b["sessions_contributed"] == 7
    sa, sb = ours.stats(), theirs.stats()
    assert sa == sb and sa["contributions_skipped"] == 1
    for pool, snap in ((ours, b), (theirs, a)):
        assert pool.replace(snap) == 3
    _close(ours.snapshot(), theirs.snapshot())
    g_o, g_t = ours.get("t:0"), theirs.get("t:0")
    assert np.allclose(g_o.A, g_t.A, rtol=1e-6, atol=0.0)


@pytest.fixture(scope="module")
def h80():
    return Dataset.from_file(os.path.join(ROOT, "data", "digits_h80.npz"),
                             name="digits_h80", device=DEV)


def _pool_app(ds, **kw):
    app = ServeApp(capacity=2, max_wait=0.001, quality=False, device=DEV,
                   spec=SelectorSpec.create(
                       "coda", n_parallel=2, eig_scorer="surrogate:8",
                       surrogate_prior="pool"), **kw)
    app.add_task(ds.name, ds.preds)
    app.start(warm=True)
    return app


def _drive(app, ds, rounds, seed):
    labels = ds.labels.numpy()
    out = app.open_session(seed=seed)
    for _ in range(rounds):
        out = app.label(out["session"], int(labels[out["idx"]]))
    return out["session"]


def test_port_donor_seeds_the_next_session_and_replays_bitwise(h80):
    """A donor closing after a full warmup contributes once; the next
    admission carries ``prior_fit`` with the full warmup credit (on its
    stream's meta too), the credit shows on /stats, and its export
    imported through the replay path reproduces its rows bitwise."""
    from coda_tpu_torch.telemetry import SessionRecorder

    app = _pool_app(h80, recorder=SessionRecorder())
    try:
        donor = _drive(app, h80, sg.SURROGATE_PRIOR_MIN_ROUNDS + 2, 0)
        assert app.store.get(donor).prior_fit is None
        app.close_session(donor)
        st = app.stats()["prior_pool"]
        assert (st["sessions_contributed"], st["pools"]) == (1, 1)
        seeded = _drive(app, h80, 4, 1)
        sess = app.store.get(seeded)
        pf = sess.prior_fit
        assert pf is not None and pf["credit"] == sg.SURROGATE_WARMUP_ROUNDS
        assert app.recorder.history(seeded) is not None
        snap = app.stats()
        assert snap["prior_warmup_rounds_skipped"] >= \
            sg.SURROGATE_WARMUP_ROUNDS
        d0 = sess.bucket.slot_digest(sess.slot)
        payload = app.export_session(seeded, close=True)
        assert payload["prior_fit"]["digest"] == pf["digest"]
        info = app.import_session(dict(payload, carries=None, key=None))
        assert info["restored_via"] == "replay" and info["rounds"] == 5
        s2 = app.store.get(seeded)
        assert s2.prior_fit == pf
        assert s2.bucket.slot_digest(s2.slot) == d0
    finally:
        app.drain()


def test_port_pool_survives_a_restart_and_contributes_once(h80, tmp_path):
    """save_prior_pool -> a new app -> load_prior_pool seeds the next
    admission; a session contributes at most once (a green one is
    skipped and counted)."""
    from coda_tpu_torch.tracking import TrackingStore

    db = str(tmp_path / "prior.sqlite")
    app = _pool_app(h80)
    try:
        green = _drive(app, h80, 3, 5)
        app.close_session(green)
        assert app.stats()["prior_pool"]["contributions_skipped"] >= 1
        donor = _drive(app, h80, sg.SURROGATE_PRIOR_MIN_ROUNDS + 2, 0)
        sess = app.store.get(donor)
        fit = sess.bucket.slot_fit(sess.slot)
        assert app.contribute_prior(sess, fit)
        assert not app.contribute_prior(sess, fit)
        app.close_session(donor)
        assert app.stats()["prior_pool"]["sessions_contributed"] == 1
        store = TrackingStore(db)
        app.save_prior_pool(store)
        store.close()
    finally:
        app.drain()
    app2 = _pool_app(h80)
    try:
        store = TrackingStore(db)
        assert app2.load_prior_pool(store) == 1
        store.close()
        seeded = _drive(app2, h80, 1, 2)
        assert app2.store.get(seeded).prior_fit["credit"] == \
            sg.SURROGATE_WARMUP_ROUNDS
        assert app2.sync_prior()["delta"] == {}
    finally:
        app2.drain()
