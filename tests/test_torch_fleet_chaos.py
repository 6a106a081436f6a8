"""Fleet chaos on the port (``coda_tpu_torch/serve``): the six fleet fault
scenarios, epoch fencing, the transport's breaker and retry budget, on
the CPU.

Inputs are the seeded ``make_synthetic_task(0, 4, 48, 4)`` (the same arrays
in both packages). Held:

  * each scenario of ``scripts/torch_fleet_chaos.py`` (the port's
    ``scripts/check_fault_matrix.py --fleet``) ends with zero violations:
    sessions reachable, labels exact, nothing applied twice;
  * the counts the counter-addressed faults fix equal the reference's
    matrix (``FAULT_MATRIX_FLEET_CPU_r16.json``): fencing rejections,
    fence failures, migrations, kills, journal resolutions, evictions,
    the partition's window, dropped sessions (0); and, with the health
    poller off so every arrival is the traffic's, the transport chaos
    fires the same faults and retries as a reference fleet driven alike;
  * an ownership epoch survives demote, wake and the stream, and only a
    committed move bumps it; a black-holed replica fails fast, typed.
"""

from __future__ import annotations

import json
import os
import time
import uuid

import pytest

try:
    import jax  # noqa: F401
except ImportError:  # a card machine without JAX
    jax = None

from coda_tpu_torch.data import make_synthetic_task
from coda_tpu_torch.serve import (ReplicaTransport, ReplicaUnavailable,
                                  SlabFull)
from scripts import torch_fleet_chaos as chaos

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
DEV = "cpu"
H, N, C = 4, 48, 4

needs_jax = pytest.mark.skipif(jax is None, reason="needs the JAX reference")


@pytest.fixture(scope="module")
def task():
    return make_synthetic_task(0, H=H, N=N, C=C, device=DEV)


@pytest.fixture(scope="module")
def reference_matrix():
    with open(os.path.join(ROOT, "FAULT_MATRIX_FLEET_CPU_r16.json")) as f:
        return json.load(f)["scenarios"]


def _fixed_counts(name: str, stats: dict) -> dict:
    """The counts of a scenario that its faults fix (not its timing)."""
    if name == "fleet_stale_owner_fence":
        return {k: stats[k] for k in ("fencing_rejections", "fence_failures",
                                      "migrations", "migration_verified")}
    if name == "fleet_kill_replica_mid_migration":
        return {"kills": sum(stats["kills"].values()),
                "migration_failures": stats["migration_failures"],
                "sessions_dropped": stats["sessions_dropped"]}
    if name == "fleet_router_restart_journal":
        return stats["phases"]
    if name == "fleet_healthz_flap":
        return {"evictions": stats["evictions"]}
    if name == "fleet_transport_chaos":
        return {"dropped_sessions": stats["dropped_sessions"]}
    return {"partition_fired": stats["partition_fired"],
            "partition_window": stats["partition_window"]}


@pytest.mark.parametrize("name", list(chaos.SCENARIOS))
def test_port_fleet_fault_matrix(task, tmp_path, reference_matrix, name):
    """One scenario of the fleet fault matrix on the port: zero
    violations, and the counts its faults fix equal the reference's."""
    violations, stats = chaos.SCENARIOS[name](str(tmp_path), task, DEV)
    assert violations == []
    assert _fixed_counts(name, stats) == _fixed_counts(
        name, reference_matrix[name])


@needs_jax
def test_reference_transport_chaos_fires_alike(task, tmp_path):
    """Drop, delay and duplicate on live label traffic with the health
    poller off: the port fleet and a reference fleet driven alike fire
    each fault the same number of times and retry the same number of
    calls, and lose nothing."""
    from coda_tpu.serve import Fleet as RefFleet
    from coda_tpu.serve import SelectorSpec as RefSpec
    from coda_tpu.serve import ServeApp as RefApp

    violations, ours = chaos.transport_chaos(str(tmp_path / "p"), task, DEV,
                                             poll=False)
    assert violations == []

    def factory(rid):
        app = RefApp(capacity=6, max_wait=0.001,
                     spec=RefSpec.create("coda", n_parallel=6))
        app.add_task(task.name, task.preds.numpy())
        return app

    fleet = RefFleet(factory, n_replicas=2, fault_spec=chaos.TRANSPORT_CHAOS)
    for h in fleet.router.replicas.values():
        h.transport.backoff_s = 0.01
        h.transport.breaker.cooldown_s = 0.05
    for app in fleet.apps.values():
        app.start(warm=True)
    r = fleet.router
    try:
        sids, errors = chaos.drive_router(r, C, n_sessions=4)
        assert errors == []
        fired = {f["name"]: f["fired"] for f in r.faults.snapshot()}
        retries = sum(r.stats()["router"]["transport_retries"].values())
        assert chaos.reachability(r, sids) == []
    finally:
        fleet.drain(timeout=10)
    assert ours["faults_fired"] == fired
    assert ours["transport_retries"] == retries
    assert ours["dropped_sessions"] == r.counters["sessions_dropped"] == 0


def test_port_epoch_preserved_through_demote_wake_and_stream(task,
                                                             tmp_path):
    """A demote/wake round trip does not advance the ownership epoch (a
    wake is a page-in, not an ownership change), and the epoch rides the
    stream's meta so a crash-restored copy keeps it; the source's fenced
    stream still reads epoch 0."""
    from coda_tpu_torch.serve.recovery import load_session_stream

    fleet = chaos.make_fleet(str(tmp_path), task, DEV, capacity=4)
    r = fleet.router
    try:
        out = r.open_session(seed=0)
        sid = out["session"]
        out = r.label(sid, int(out["idx"]) % C)
        src = r._locate(sid)
        dst = [x for x in fleet.replica_ids if x != src][0]
        assert r.migrate_session(sid, src, dst).get("migrated") == sid
        app = fleet.apps[dst]
        assert app.store.get(sid).epoch == 1
        assert app.tiers.try_demote(sid)
        assert int(app.tiers.parked_payload(sid)["epoch"]) == 1
        out = r.label(sid, int(out["idx"]) % C)   # a transparent wake
        assert out["n_labeled"] == 2
        assert app.store.get(sid).epoch == 1
        meta, _, _ = load_session_stream(
            os.path.join(str(tmp_path), dst, f"session_{sid}.jsonl"))
        assert int(meta.get("epoch") or 0) == 1
        meta_src, _, closed = load_session_stream(
            os.path.join(str(tmp_path), src, f"session_{sid}.jsonl"))
        assert closed and int(meta_src.get("epoch") or 0) == 0
    finally:
        fleet.drain(timeout=10)


def test_port_demotion_window_is_parked_not_gone(task):
    """Between a demotion's unpublishing of a session and the warm map's
    payload (a slow stream park here), the session reads as parked and
    listed, and a label arriving then waits for the payload and wakes it:
    never a 404 for a live session."""
    import threading

    from coda_tpu_torch.serve import SelectorSpec, ServeApp

    app = ServeApp(capacity=2, max_wait=0.001, device=DEV, quality=False,
                   spec=SelectorSpec.create("coda", n_parallel=2))
    app.add_task(task.name, task.preds)
    app.start(warm=True)
    entered, go = threading.Event(), threading.Event()
    try:
        o = app.open_session(seed=0)
        sid = o["session"]
        park = app.recorder.park

        def slow_park(s):
            entered.set()
            assert go.wait(30)
            park(s)

        app.recorder.park = slow_park
        demoted = []
        t = threading.Thread(target=lambda: demoted.append(
            app.tiers.try_demote(sid)))
        t.start()
        assert entered.wait(30)
        assert not app.store.alive(sid) and app.tiers.parked(sid)
        assert sid in app.list_sessions()["sessions"]
        got = []
        lab = threading.Thread(target=lambda: got.append(
            app.label(sid, int(o["idx"]) % C)))
        lab.start()
        time.sleep(0.1)              # far past the 3 x 2 ms of misses
        assert lab.is_alive() and not got
        go.set()
        t.join(30)
        lab.join(30)
        assert demoted == [True] and got[0]["n_labeled"] == 1
        assert app.store.alive(sid)
    finally:
        go.set()
        app.drain(timeout=10)


def test_port_mid_wake_session_is_listed_and_migrates(task, monkeypatch):
    """A session whose wake is still importing is listed (a fleet's drain
    of the replica must not miss it), and a migration's prepare waits
    for that wake instead of finding the session nowhere."""
    import threading

    from coda_tpu_torch.serve import SelectorSpec, ServeApp
    from coda_tpu_torch.serve import recovery

    app = ServeApp(capacity=2, max_wait=0.001, device=DEV, quality=False,
                   spec=SelectorSpec.create("coda", n_parallel=2))
    app.add_task(task.name, task.preds)
    app.start(warm=True)
    entered, go = threading.Event(), threading.Event()
    real = recovery.import_session

    def slow_import(*a, **k):
        entered.set()
        assert go.wait(30)
        return real(*a, **k)

    try:
        o = app.open_session(seed=0)
        sid = o["session"]
        assert app.tiers.try_demote(sid)
        monkeypatch.setattr(recovery, "import_session", slow_import)
        got, payload = [], []
        woke = threading.Thread(target=lambda: got.append(
            app.label(sid, int(o["idx"]) % C)))
        woke.start()
        assert entered.wait(30)
        assert sid in app.list_sessions()["sessions"]
        prep = threading.Thread(target=lambda: payload.append(
            app.begin_migration(sid, raw=True)))
        prep.start()
        time.sleep(0.1)
        assert prep.is_alive() and not payload
        go.set()
        woke.join(30)
        prep.join(30)
        assert got[0]["n_labeled"] == 1 and payload[0]["n_labeled"] == 1
        assert app.end_migration(sid, drop=False)["held"]
    finally:
        go.set()
        app.drain(timeout=10)


def test_port_retry_budget_exhaustion_is_typed_503_not_hang():
    """A black-holed replica burns its retry budget once, then fails fast
    with the typed retryable error the front door answers 503 — bounded
    time, bounded call amplification, never a hang."""
    t = ReplicaTransport("r0", max_retries=3, backoff_s=0.001,
                         breaker_threshold=10_000, retry_budget=4)

    def dead(deadline):
        raise ConnectionRefusedError("refused")

    t0 = time.perf_counter()
    outcomes = []
    for _ in range(10):
        try:
            t.call("best", dead)
        except ReplicaUnavailable:
            outcomes.append("unavailable")
        except ConnectionRefusedError:
            outcomes.append("refused")
    assert time.perf_counter() - t0 < 2.0
    assert "unavailable" in outcomes and t.budget.exhaustions > 0
    assert issubclass(ReplicaUnavailable, SlabFull)
    t.call("best", lambda d: {"ok": True})
    assert t.budget.tokens > 0


@pytest.mark.parametrize("when", ["start", "restart", "revive"])
def test_port_replica_warmup_failure_fails_the_fleet(task, tmp_path, when):
    """A replica whose warm-up fails (a kernel that does not build or
    launch) is not served with lazy warm-up: the fleet's start, a
    restart's rebuild and a revival raise ``ReplicaWarmupFailed`` naming
    it. A failed start stops the replicas already started; a failed
    restart or revival leaves the replica dead and out of routing, and
    the other replica's sessions serve on."""
    from coda_tpu_torch.serve import Fleet, SelectorSpec, ServeApp
    from coda_tpu_torch.serve.fleet import ReplicaWarmupFailed, _DeadApp
    from coda_tpu_torch.serve.router import DeadReplica
    from coda_tpu_torch.telemetry import SessionRecorder

    planted = set()        # replica ids whose next app fails its warm-up

    def factory(rid):
        app = ServeApp(capacity=4, max_wait=0.001, device=DEV,
                       spec=SelectorSpec.create("coda", n_parallel=4),
                       recorder=SessionRecorder(
                           out_dir=str(tmp_path / rid)))
        app.add_task(task.name, task.preds)
        if rid in planted:
            def warm():
                raise RuntimeError("kernel build failed (planted)")
            app.warm = warm
        return app

    if when == "start":
        planted.add("r1")
        fleet = Fleet(factory, n_replicas=2)
        with pytest.raises(ReplicaWarmupFailed,
                           match="replica r1 warm-up failed.*planted"):
            fleet.start(warm=True)
        assert fleet.apps["r0"].draining
        assert "warmup_failed" in fleet.apps["r1"].healthz()["problems"]
        return
    fleet = Fleet(factory, n_replicas=2).start(warm=True)
    r = fleet.router
    try:
        outs = [r.open_session(seed=s) for s in range(4)]
        outs = [r.label(o["session"], int(o["idx"]) % C) for o in outs]
        keep = [o["session"] for o in outs]
        if when == "revive":
            keep = [s for s in keep if r._locate(s) == "r0"]
            fleet.kill_replica("r1")
        planted.add("r1")
        with pytest.raises(ReplicaWarmupFailed, match="replica r1"):
            if when == "restart":
                fleet.restart_replica("r1")
            else:
                fleet.revive_replica("r1")
        assert isinstance(fleet.apps["r1"], _DeadApp)
        assert isinstance(r.replicas["r1"], DeadReplica)
        for _ in range(3):          # the health poll finds it still dead
            r.check_health()
        assert "r1" not in r.routable()
        for sid in keep:
            assert r._locate(sid) == "r0"
            assert r.best(sid)["n_labeled"] == 1
    finally:
        fleet.drain(timeout=10)


def test_port_fleet_close_frees_every_replica(task, tmp_path):
    """``Fleet.close`` drains the fleet and frees every replica's device
    memory (each bucket ``freed``), a killed replica's included, so the
    next fleet on the card allocates at once; the streams are closed."""
    fleet = chaos.make_fleet(str(tmp_path), task, DEV, capacity=4)
    r = fleet.router
    out = r.open_session(seed=0)
    r.label(out["session"], int(out["idx"]) % C)
    apps = dict(fleet.apps)
    fleet.kill_replica("r1")
    fleet.close(timeout=10)
    assert apps["r0"].draining and r.draining
    for app in apps.values():
        buckets = app.store.buckets()
        assert buckets and all(b.failed == "freed" for b in buckets)


def test_port_breaker_drives_eviction_distinct_from_health(task, tmp_path):
    """A tripped breaker evicts the replica as ``breaker_open``, reported
    apart from health on ``/stats``; the half-open probe of the health
    poll re-admits it after recovery."""
    fleet = chaos.make_fleet(str(tmp_path), task, DEV, capacity=4)
    r = fleet.router
    try:
        r.stop()
        h = r.replicas["r0"]
        for _ in range(h.transport.breaker.threshold):
            h.transport.breaker.record_failure()
        assert r.check_health()["r0"] == "breaker_open"
        assert "r0" not in r.routable()
        st = r.stats()["router"]
        assert st["breakers"]["r0"]["state"] in ("open", "half_open")
        assert st["health"]["r0"] == "breaker_open"
        time.sleep(0.06)
        r.check_health()
        r.check_health()
        assert "r0" in r.routable()
        assert r.stats()["router"]["breakers"]["r0"]["state"] == "closed"
    finally:
        fleet.drain(timeout=10)


def test_port_chaos_metrics_families_lint_clean(task, tmp_path):
    """Dropped label calls are retried (exactly once applied), and the
    chaos families render lint-clean on the router's ``/metrics``."""
    from coda_tpu_torch.telemetry.prometheus import lint

    fleet = chaos.make_fleet(str(tmp_path), task, DEV, capacity=4,
                             fault_spec="net_drop:after=2,times=2,"
                                        "task=label")
    r = fleet.router
    try:
        out = r.open_session(seed=0)
        sid = out["session"]
        for _ in range(4):
            out = r.label(sid, int(out["idx"]) % C,
                          request_id=uuid.uuid4().hex)
        text = r.render_metrics()
        assert lint(text) == []
        for family in ("coda_replica_breaker_state{",
                       "coda_transport_retries_total{",
                       "coda_fencing_rejections_total",
                       "coda_migration_journal_replays_total"):
            assert family in text, family
        st = r.stats()["router"]
        assert st["journal"]["moves"] == 0
        assert sum(st["transport_retries"].values()) >= 1
        assert out["n_labeled"] == 4
    finally:
        fleet.drain(timeout=10)
