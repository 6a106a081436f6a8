"""Fleet observability of the port (``render_fleet``, the router's SLO
sweeper, its quality scorecard, distributed traces across replicas and
``cli trace``) on the CPU.

Inputs are the seeded ``make_synthetic_task(0, 4, 48, 4)`` and scripted
fleet snapshots, the same dicts fed to both packages. Held exactly:

  * ``render_fleet`` gives the reference's text on the same replica
    snapshots and router stats, and the port's ``lint`` finds it clean;
  * ``default_fleet_slos`` with ``quality_slos`` fire and clear in the
    same sequence as the reference's on the same scripted snapshots and
    clock;
  * the router's ``quality_scorecard`` is the reference's aggregation of
    the same replica snapshots;
  * ``cli trace <id> --url`` against a port router behind ``make_server``
    writes the reference's ``stitch_traces`` of the same payloads, with
    the router's and both replicas' lanes after a forced migration; a
    rolling restart hands the restarted replica's spans to the router.
"""

from __future__ import annotations

import copy
import json
import os
import threading
import urllib.request

import pytest

try:
    import jax  # noqa: F401
except ImportError:  # a card machine without JAX
    jax = None

from coda_tpu_torch.data import make_synthetic_task
from coda_tpu_torch.serve import Fleet, SelectorSpec, ServeApp, \
    SessionRouter, make_server
from coda_tpu_torch.telemetry.prometheus import lint, render_fleet
from coda_tpu_torch.telemetry.trace import mint

DEV = "cpu"
H, N, C = 4, 48, 4

needs_jax = pytest.mark.skipif(jax is None, reason="needs the JAX reference")


@pytest.fixture(scope="module")
def task():
    return make_synthetic_task(0, H=H, N=N, C=C, device=DEV)


def _factory(task, **kw):
    def make(rid):
        app = ServeApp(capacity=4, max_wait=0.001, device=DEV,
                       spec=SelectorSpec.create("coda", n_parallel=4), **kw)
        app.add_task(task.name, task.preds)
        return app

    return make


@pytest.fixture(scope="module")
def fleet_stats(task):
    """A live 2-replica fleet's ``stats()`` after traffic, a forced
    migration and a closed, audited session (quality on)."""
    fleet = Fleet(_factory(task, quality_audit_frac=1.0),
                  n_replicas=2).start(warm=True)
    r = fleet.router
    try:
        sids = []
        for i in range(4):
            o = r.open_session(seed=i)
            sids.append(o["session"])
            for _ in range(3):
                o = r.label(o["session"], int(o["idx"]) % C)
        src = r._locate(sids[0])
        dst = [x for x in fleet.replica_ids if x != src][0]
        assert r.migrate_session(sids[0], src, dst).get("migrated")
        r.close_session(sids[1])
        for app in fleet.apps.values():
            assert app.quality.drain(30)
        return json.loads(json.dumps(fleet.stats()))
    finally:
        fleet.drain(timeout=10)


@needs_jax
def test_reference_render_fleet_same_text(fleet_stats):
    """The same replica snapshots and router stats render to the
    reference's text, each serve family once with per-replica labels."""
    from coda_tpu.telemetry.prometheus import render_fleet as ref_render
    from coda_tpu.telemetry.registry import Registry as RefRegistry

    from coda_tpu_torch.telemetry.registry import Registry

    snaps = fleet_stats["replicas"]
    ours = render_fleet(snaps, registry=Registry(),
                        router_stats=fleet_stats["router"])
    theirs = ref_render(snaps, registry=RefRegistry(),
                        router_stats=fleet_stats["router"])
    assert ours == theirs
    assert lint(ours) == []
    for rid in ("r0", "r1"):
        assert f'coda_serve_requests_total{{replica="{rid}"}}' in ours
    assert ours.count("# TYPE coda_serve_requests_total counter") == 1
    for family in ("coda_router_migrations_total",
                   "coda_router_requests_to_replica_total",
                   "coda_replica_breaker_state",
                   "coda_quality_audits_total"):
        assert family in ours, family


def _scripted_snapshots(base: dict) -> list:
    """A fleet snapshot series that makes several objectives burn, then
    recover: label p99 past its bound, failed requests, an unverified
    migration, a diverged audit and a firing drift detector."""
    out = []
    for step in range(24):
        s = copy.deepcopy(base)
        bad = 4 <= step < 14
        for rid, rep in s["replicas"].items():
            rep.setdefault("request_latency", {})["p99_ms"] = (
                900.0 if bad and rid == "r0" else 12.0)
            rep["requests"] = 100 + 10 * step
            rep["requests_failed"] = 50 if bad else 0
            q = rep.setdefault("quality", {})
            q.setdefault("audit", {})["audits_total"] = 1
            q["audit"]["divergences_recent"] = int(bad and step % 2 == 0)
            q["drift"] = {"surrogate_residual": {"firing": bad}}
        s["aggregate"]["requests"] = sum(r["requests"]
                                         for r in s["replicas"].values())
        s["aggregate"]["requests_failed"] = sum(
            r["requests_failed"] for r in s["replicas"].values())
        s["router"]["counters"]["migrations"] = 3
        s["router"]["migration_verified"] = 2 if bad else 3
        out.append(s)
    return out


@needs_jax
def test_reference_fleet_slos_fire_and_clear_alike(fleet_stats):
    """``default_fleet_slos`` + ``quality_slos`` on the same scripted
    router snapshots and clock: the same alerts, in the same order, with
    the same burn rates, as the reference's sweeper."""
    from coda_tpu.telemetry.quality import quality_slos as ref_quality
    from coda_tpu.telemetry.slo import SloSweeper as RefSweeper
    from coda_tpu.telemetry.slo import default_fleet_slos as ref_fleet

    from coda_tpu_torch.telemetry.quality import quality_slos
    from coda_tpu_torch.telemetry.slo import SloSweeper, default_fleet_slos

    snaps = _scripted_snapshots(fleet_stats)
    runs = []
    for sweeper in (SloSweeper(default_fleet_slos() + quality_slos(),
                               fast_s=5.0, slow_s=30.0),
                    RefSweeper(ref_fleet() + ref_quality(),
                               fast_s=5.0, slow_s=30.0)):
        alerts = [sweeper.observe(s, t=float(i))
                  for i, s in enumerate(snaps)]
        runs.append((alerts, sweeper.snapshot()))
    assert runs[0] == runs[1]
    fired = {a["slo"] for step in runs[0][0] for a in step
             if a["state"] == "firing"}
    cleared = {a["slo"] for step in runs[0][0] for a in step
               if a["state"] == "resolved"}
    assert {"label_p99", "error_ratio", "migrations_verified",
            "quality_drift"} <= fired
    assert fired == cleared


class _Snap:
    """A replica handle that answers ``stats`` with a fixed snapshot."""

    transport = None

    def __init__(self, snap):
        self.snap = snap

    def stats(self):
        return copy.deepcopy(self.snap)


@needs_jax
def test_reference_router_quality_scorecard(fleet_stats):
    """The router's ``quality_scorecard`` over the same replica snapshots
    (a live one, a diverged miscalibrated one, one with the plane off, one
    that errs) is the reference's aggregation."""
    from coda_tpu.serve.router import SessionRouter as RefRouter

    live = fleet_stats["replicas"]["r0"]
    bad = copy.deepcopy(live)
    bad["quality"]["audit"].update(audits_total=3, divergences_recent=1)
    bad["quality"]["calibration"] = {"t": {"n": 500, "ece": 0.4}}
    off = {k: v for k, v in live.items() if k != "quality"}

    class _Err:
        transport = None

        def stats(self):
            raise ConnectionError("gone")

    for members in ({"a": live}, {"a": live, "b": off},
                    {"a": live, "b": bad, "c": off, "d": None}):
        handles = {rid: (_Err() if s is None else _Snap(s))
                   for rid, s in members.items()}
        ours = SessionRouter(dict(handles), tracing=False)
        theirs = RefRouter(dict(handles), tracing=False)
        try:
            assert ours.quality_scorecard() == theirs.quality_scorecard()
        finally:
            ours.drain()
            theirs.drain()
    card = ours.quality_scorecard()
    assert card["verdict"]["audit"] == "diverged"
    assert card["replicas"]["c"] == {"enabled": False}


def _serve(router):
    srv = make_server(router, 0)
    threading.Thread(target=srv.serve_forever, daemon=True).start()
    srv._started.wait(30)
    return srv, f"http://127.0.0.1:{srv.server_address[1]}"


def _get(base, path):
    with urllib.request.urlopen(base + path, timeout=60) as resp:
        return resp.status, resp.read()


@needs_jax
def test_reference_cli_trace_stitches_a_migrated_session(task, tmp_path):
    """A traced session force-migrated mid-trajectory: ``cli trace <id>
    --url`` against the router behind ``make_server`` writes the
    reference's ``stitch_traces`` of the same payloads, with the router's
    and both replicas' lanes and the route, dispatch, serve and tick
    spans."""
    from coda_tpu.telemetry.spans import stitch_traces as ref_stitch

    from coda_tpu_torch import cli

    fleet = Fleet(_factory(task), n_replicas=2).start(warm=False)
    router = fleet.router
    srv, base = _serve(router)
    try:
        o = router.open_session(seed=3)
        sid = o["session"]
        src = router.owner_of(sid)
        ctx = mint()
        o = router.label(sid, int(o["idx"]) % C, trace_ctx=ctx)
        dst = next(x for x in fleet.replica_ids if x != src)
        assert router.migrate_session(sid, src, dst).get("migrated") == sid
        router.label(sid, int(o["idx"]) % C, trace_ctx=ctx)
        out = str(tmp_path / "trace.json")
        assert cli.main(["trace", ctx.trace_id, "--url", base,
                         "--out", out]) == 0
        with open(out) as f:
            got = json.load(f)
        payloads = [router.telemetry.spans.trace_payload(ctx.trace_id,
                                                         process="router")]
        for rid in sorted(fleet.apps):
            p = dict(fleet.apps[rid].trace_by_id(ctx.trace_id))
            p["process"] = p.get("process") or rid
            payloads.append(p)
        payloads = router._merge_process_payloads(
            [p for p in payloads if p.get("events")])
        want = json.loads(json.dumps(ref_stitch(payloads)))
        assert got.pop("trace_id") == ctx.trace_id
        assert set(got.pop("processes")) == {"router", src, dst}
        assert got == want
        names = [e["name"] for e in got["traceEvents"] if e.get("ph") == "X"]
        for prefix in ("route/", "dispatch/", "serve/", "tick/"):
            assert any(n.startswith(prefix) for n in names), prefix
    finally:
        srv.shutdown()
        srv.server_close()
        fleet.drain(timeout=10)


def test_port_restart_adopts_spans_so_traces_survive(task):
    """``restart_replica`` rebuilds the app with a fresh span recorder;
    the router adopts the old one's retained spans first, so the trace
    keeps that replica's lane, once."""
    fleet = Fleet(_factory(task), n_replicas=2).start(warm=False)
    router = fleet.router
    try:
        o = router.open_session(seed=1)
        rid = router.owner_of(o["session"])
        ctx = mint()
        router.label(o["session"], int(o["idx"]) % C, trace_ctx=ctx)
        assert rid in router.collect_trace(ctx.trace_id)["processes"]
        fleet.restart_replica(rid, warm=False)
        after = router.collect_trace(ctx.trace_id)["processes"]
        assert after.count(rid) == 1
    finally:
        fleet.drain(timeout=10)


def test_port_router_http_front_door(task, capsys):
    """The router over ``AsyncHTTPServer``: open, label and close land on
    the rendezvous owner; ``/stats``, ``/healthz``, ``/metrics`` (replica
    labels, the SLO families, lint-clean), ``/fleet/slo`` and
    ``/fleet/quality``; ``cli quality --url`` reads the fleet verdict."""
    from coda_tpu_torch import cli

    fleet = Fleet(_factory(task, quality_audit_frac=1.0),
                  n_replicas=2, slo_fast_s=5.0,
                  slo_slow_s=30.0).start(warm=True)
    router = fleet.router
    srv, base = _serve(router)
    try:
        def post(path, body):
            rq = urllib.request.Request(base + path,
                                        data=json.dumps(body).encode(),
                                        method="POST")
            with urllib.request.urlopen(rq, timeout=60) as resp:
                return json.loads(resp.read())

        out = post("/session", {"seed": 0})
        sid = out["session"]
        assert fleet.apps[router.owner_of(sid)].store.alive(sid)
        for _ in range(3):
            out = post(f"/session/{sid}/label",
                       {"label": int(out["idx"]) % C})
        assert out["n_labeled"] == 3
        rq = urllib.request.Request(f"{base}/session/{sid}", method="DELETE")
        with urllib.request.urlopen(rq, timeout=60) as resp:
            assert resp.status == 200
        for app in fleet.apps.values():
            assert app.quality.drain(30)
        st = json.loads(_get(base, "/stats")[1])
        assert st["role"] == "router" and st["aggregate"]["requests"] >= 4
        code, body = _get(base, "/healthz")
        assert code == 200 and json.loads(body)["role"] == "router"
        router.slo.observe(router.stats())
        text = _get(base, "/metrics")[1].decode()
        assert 'coda_serve_requests_total{replica="r0"}' in text
        assert 'coda_slo_firing{slo="label_p99"}' in text
        assert lint(text) == []
        slo = json.loads(_get(base, "/fleet/slo")[1])
        assert slo["windows_s"] == {"fast": 5.0, "slow": 30.0}
        assert {"label_p99", "quality_drift"} <= set(slo["objectives"])
        card = json.loads(_get(base, "/fleet/quality")[1])
        assert card["role"] == "router" and card["verdict"]["audit"] == "ok"
        assert cli.main(["quality", "--url", base]) == 0
        assert "fleet verdict:" in capsys.readouterr().out
    finally:
        srv.shutdown()
        srv.server_close()
        fleet.drain(timeout=10)


def test_port_single_replica_routes_stay_their_own(task, tmp_path):
    """A lone ``ServeApp`` keeps its own surfaces: ``/trace/id`` answers
    its raw payload (which ``cli trace`` wraps for the viewer) and
    ``/fleet/slo`` is not served."""
    from coda_tpu_torch import cli

    app = _factory(task)("solo")
    app.start(warm=False)
    srv, base = _serve(app)
    try:
        ctx = mint()
        o = app.open_session(seed=0, trace_ctx=ctx)
        app.label(o["session"], int(o["idx"]) % C, trace_ctx=ctx)
        raw = json.loads(_get(base, f"/trace/id/{ctx.trace_id}")[1])
        assert raw["events"] and "traceEvents" not in raw
        out = str(tmp_path / "t.json")
        assert cli.main(["trace", ctx.trace_id, "--url", base,
                         "--out", out]) == 0
        with open(out) as f:
            assert json.load(f)["traceEvents"]
        with pytest.raises(urllib.error.HTTPError) as e:
            _get(base, "/fleet/slo")
        assert e.value.code == 404
    finally:
        srv.shutdown()
        srv.server_close()
        app.drain(timeout=10)
