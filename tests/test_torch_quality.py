"""The decision-quality plane and the SLO objectives of the port
(``coda_tpu_torch/telemetry/quality.py``, ``telemetry/slo.py``) on the CPU.

Inputs: seeded numpy sequences for the host organs, the seeded
``make_synthetic_task(0, 4, 48, 4)`` for the serve runs, as the
reference's ``tests/test_quality.py`` builds its own. Tolerances:

  * host-only code fed the same sequences as the reference's
    (``CalibrationBuckets``, ``CalibrationMonitor``, ``CusumDetector``,
    ``PageHinkley``, ``DriftBank``, ``SloSweeper`` with
    ``default_fleet_slos`` and ``quality_slos``): snapshots equal;
  * ``pred_label_prob`` of the same session against the reference's:
    within 1e-6 (float64 host arithmetic over each backend's P(best)
    rows and the same float32 predictions);
  * quality on against off: the decision rows bitwise equal apart from
    the additive ``pred_label_prob``; a clean shadow audit reports ``ok``
    and a one-ulp ``stream_tamper`` reports ``diverged`` at the tampered
    round.
"""

from __future__ import annotations

import json
import threading

import numpy as np
import pytest

try:
    import jax  # noqa: F401
except ImportError:  # a card machine without JAX
    jax = None

from coda_tpu_torch.data import make_synthetic_task
from coda_tpu_torch.serve import SelectorSpec, ServeApp, make_server
from coda_tpu_torch.telemetry import SessionRecorder, lint_prometheus
from coda_tpu_torch.telemetry import quality as tq
from coda_tpu_torch.telemetry import slo as tslo

DEV = "cpu"
H, N, C = 4, 48, 4

needs_jax = pytest.mark.skipif(jax is None, reason="needs the JAX reference")


@pytest.fixture(scope="module")
def task():
    return make_synthetic_task(0, H=H, N=N, C=C, device=DEV)


def _feed(mod, rng_seed=0):
    """Drive one package's host organs with a seeded sequence; returns
    their snapshots."""
    rng = np.random.default_rng(rng_seed)
    t = [0.0]

    def clock():
        return t[0]

    cal = mod.CalibrationMonitor()
    bk = mod.CalibrationBuckets()
    for _ in range(300):
        conf = float(rng.random())
        hit = bool(rng.random() < conf)
        p = float(rng.random())
        bk.observe(conf, hit, p)
        cal.observe("t" if conf > 0.3 else "u", conf, hit, p)
    bank = mod.default_drift_bank(clock)
    bank.add(mod.CusumDetector("extra", mu0=0.2, k=0.1, h=1.0, clear=0.3,
                               clock=clock))
    events = []
    for i in range(200):
        t[0] += 1.0
        shift = 0.8 if 60 <= i < 120 else 0.05
        for name in ("surrogate_residual", "prior_staleness",
                     "crowd_reliability", "extra"):
            events.append(bank.observe(name,
                                       shift + 0.05 * float(rng.random())))
    ph = mod.PageHinkley("ph", delta=0.01, lam=0.5, clock=clock)
    for i in range(100):
        events.append(ph.observe(0.1 if i < 50 else 0.9, t=float(i)))
    return {"buckets": bk.snapshot(), "monitor": cal.snapshot(),
            "worst": cal.worst_ece(), "bank": bank.snapshot(),
            "ph": ph.snapshot(), "events": events,
            "curve": mod.reliability_curve(rng.random(50),
                                           rng.random(50) < 0.5),
            "pbest_cal": mod.pbest_calibration(rng.random(40),
                                               rng.random(40) - 0.5)}


def _fleet(i: int) -> dict:
    """A synthetic fleet snapshot whose quality and latency degrade in a
    window, the shape the router's stats() gives the sweeper."""
    bad = 40 <= i < 80
    q = {"audit": {"audits_total": 3, "divergences_recent": int(bad)},
         "calibration": {"t": {"n": 60, "ece": 0.4 if bad else 0.05}},
         "drift": {"prior_staleness": {"firing": bad}}}
    rep = {"quality": q, "dispatches": i,
           "request_latency": {"p99_ms": 400.0 if bad else 20.0},
           "wake_latency": {"p99_ms": 5.0}, "sessions_rejected": 0}
    return {"replicas": {"r0": rep, "r1": dict(rep, quality=None)},
            "router": {"counters": {"requests_routed": 10 * i}}}


def _sweep(mod_slo, mod_q):
    t = [0.0]
    sw = mod_slo.SloSweeper(mod_slo.default_fleet_slos()
                            + mod_q.quality_slos(), fast_s=10.0,
                            slow_s=30.0, clock=lambda: t[0])
    events = []
    for i in range(140):
        t[0] += 1.0
        events += sw.observe(_fleet(i))
    return events, sw.snapshot()


@needs_jax
def test_reference_host_organs_match_the_reference():
    """The calibration accumulators, the drift detectors and the SLO
    sweeper, fed the same sequences in both packages: equal snapshots,
    equal transitions."""
    from coda_tpu.telemetry import quality as rq
    from coda_tpu.telemetry import slo as rslo

    assert _feed(tq) == _feed(rq)
    ours, theirs = _sweep(tslo, tq), _sweep(rslo, rq)
    assert ours[0] and ours == theirs


def _app(task, quality=True, **kw):
    app = ServeApp(capacity=4, max_wait=0.001, device=DEV, quality=quality,
                   spec=SelectorSpec.create("coda", n_parallel=4,
                                            eig_mode="incremental"),
                   recorder=SessionRecorder(), **kw)
    app.add_task("t", task.preds)
    app.start(warm=True)
    return app


def _drive(app, task, seeds=(1, 2), rounds=6, close=True):
    labels = task.labels.numpy()
    streams = {}
    for seed in seeds:
        out = app.open_session(seed=seed)
        sid = out["session"]
        for _ in range(rounds):
            out = app.label(sid, int(labels[out["idx"]]))
        streams[sid] = [dict(r) for r in app.recorder.history(sid)]
        if close:
            app.close_session(sid)
    return streams


def test_port_quality_on_off_rows_bitwise(task):
    """Quality on and off take the same decisions: the streams are bitwise
    equal once the additive ``pred_label_prob`` is dropped, which every
    labeled row carries with quality on and none with it off."""
    on, off = _app(task), _app(task, quality=False)
    try:
        rows_on, rows_off = _drive(on, task), _drive(off, task)
    finally:
        on.drain()
        off.drain()
    upd = [r for rows in rows_on.values() for r in rows if r["do_update"]]
    assert upd and all(0.0 <= r["pred_label_prob"] <= 1.0 for r in upd)
    assert not any("pred_label_prob" in r for rows in rows_off.values()
                   for r in rows)

    def canon(streams):
        return [json.dumps([{k: v for k, v in r.items()
                             if k not in ("pred_label_prob", "trace_id")}
                            for r in rows], sort_keys=True)
                for rows in streams.values()]

    assert canon(rows_on) == canon(rows_off)


def test_port_shadow_audit_ok_and_tamper_diverged(task):
    """Closed sessions replay alone in a scratch slot and verify (``ok``);
    an armed ``stream_tamper`` is reported ``diverged`` at the tampered
    round of the tampered session."""
    app = _app(task, quality_audit_frac=1.0)
    try:
        _drive(app, task)
        assert app.quality.drain(30)
        audit = app.quality.snapshot()["audit"]
        assert (audit["audits_total"], audit["divergences_total"]) == (2, 0)
        assert audit["rounds_verified"] == 14
        assert app.quality_scorecard()["verdict"]["audit"] == "ok"
        cal = app.quality.snapshot()["calibration"]["t"]
        assert cal["n"] == 12 and 0.0 <= cal["ece"] <= 1.0
    finally:
        app.drain()
    app = _app(task, quality_audit_frac=1.0,
               fault_spec="stream_tamper:every=1")
    try:
        (sid,) = _drive(app, task, seeds=(3,))
        assert app.quality.drain(30)
        audit = app.quality.snapshot()["audit"]
        assert audit["tampered_total"] == audit["divergences_total"] == 1
        (div,) = audit["last_divergences"]
        assert div["session"] == sid and div["round"] == 7 // 2
        assert app.quality_scorecard()["verdict"]["audit"] == "diverged"
    finally:
        app.drain()


def test_port_scorecard_metrics_and_cli_quality(task, tmp_path):
    """``GET /fleet/quality`` answers the scorecard, ``/metrics`` carries the
    quality families clean under lint, ``cli quality --url`` exits 0 on a
    clean server, and the shutdown scorecard lands in the tracking
    store."""
    import urllib.request

    from coda_tpu_torch import cli
    from coda_tpu_torch.tracking import TrackingStore

    app = _app(task, quality_audit_frac=1.0)
    srv = make_server(app, 0)
    threading.Thread(target=srv.serve_forever, daemon=True).start()
    srv._started.wait(30)
    port = srv.server_address[1]
    try:
        _drive(app, task, seeds=(4,))
        assert app.quality.drain(30)
        with urllib.request.urlopen(
                f"http://127.0.0.1:{port}/fleet/quality") as resp:
            card = json.loads(resp.read())
        assert card["verdict"]["audit"] == "ok"
        with urllib.request.urlopen(
                f"http://127.0.0.1:{port}/metrics") as resp:
            text = resp.read().decode()
        assert lint_prometheus(text) == []
        assert "# TYPE coda_quality_audits_total counter" in text
        assert "coda_quality_calibration_ece{task=\"t\"}" in text
        assert cli.main(["quality", "--url",
                         f"http://127.0.0.1:{port}"]) == 0
        store = TrackingStore(str(tmp_path / "q.sqlite"))
        app.quality.log_to_store(store, params={"method": "coda"})
        assert store.find_run("serve_quality", "quality-snapshot")
        store.close()
    finally:
        srv.shutdown()
        app.drain()
        srv.server_close()


@needs_jax
def test_reference_pred_label_prob_matches_the_reference(task):
    """The same session with quality on in both packages: every labeled
    row's ``pred_label_prob`` within 1e-6 of the reference's."""
    from coda_tpu.serve import SelectorSpec as RefSpec
    from coda_tpu.serve.server import ServeApp as RefApp
    from coda_tpu.telemetry import SessionRecorder as RefRecorder

    ref = RefApp(capacity=4, max_wait=0.001, tiering=False,
                 spec=RefSpec.create("coda", n_parallel=4,
                                     eig_mode="incremental"),
                 recorder=RefRecorder())
    ref.add_task("t", task.preds.numpy())
    ref.start(warm=True)
    app = _app(task)
    try:
        ours = _drive(app, task, seeds=(7,), rounds=8)
        theirs = _drive(ref, task, seeds=(7,), rounds=8)
    finally:
        app.drain()
        ref.drain()
    (a,), (b,) = ours.values(), theirs.values()
    pa = [r["pred_label_prob"] for r in a if r.get("do_update")]
    pb = [r["pred_label_prob"] for r in b if r.get("do_update")]
    assert [r["next_idx"] for r in a] == [r["next_idx"] for r in b]
    assert len(pa) == 8 and np.allclose(pa, pb, rtol=0.0, atol=1e-6)
