"""The serve fleet of the port (``coda_tpu_torch/serve/router.py``,
``transport.py``, ``journal.py``, ``fleet.py``) on the CPU.

Inputs are the seeded ``make_synthetic_task(0, 4, 48, 4)`` (the same arrays
in both packages) and, for the HTTP fleet, ``cli serve --synthetic
4,48,4``. Held:

  * the pure host code against the reference on the same inputs, exactly:
    rendezvous owners and ranks over 10,000 ids, the transport's breaker
    states, retries, budget and jitter for one scripted call sequence,
    the journal read across packages and ``payload_digest``;
  * a 3-replica in-process fleet of each package driven through the same
    operations (the same session ids, seeds and labels; an explicit
    migration, a rolling restart under traffic, a peer page, a
    ``kill_replica`` with ``revive_replica`` and crash restore): the same
    owners and router counters, the same items and best models in every
    row, the scores within the cross-backend contract 2.34e-4 (or a first
    divergence that is a tie-break flip of the reference's own scores);
  * the port fleet against the port itself: every session's rows bitwise
    those of the same session on one ``ServeApp``, every stream verified
    from init with every label applied once;
  * an HTTP fleet of two ``cli serve`` subprocesses behind ``HttpReplica``
    handles: a migration through hold and fence, bitwise a direct app.
"""

from __future__ import annotations

import gc
import itertools
import os
import re
import subprocess
import sys
import threading
import time
import uuid

import numpy as np
import pytest

try:
    import jax  # noqa: F401
except ImportError:  # a card machine without JAX
    jax = None

from coda_tpu_torch.data import make_synthetic_task
from coda_tpu_torch.serve import (
    VERB_DEADLINES,
    Fleet,
    HttpReplica,
    MigrationJournal,
    SelectorSpec,
    ServeApp,
    SessionRouter,
    SlabFull,
    payload_digest,
    rendezvous_owner,
    rendezvous_rank,
)
from coda_tpu_torch.serve.recovery import (data_rows, load_session_stream,
                                           verify_session_stream)
from coda_tpu_torch.serve.state import SessionStore
from coda_tpu_torch.serve.transport import _jitter
from coda_tpu_torch.telemetry import SessionRecorder
from coda_tpu_torch.telemetry.recorder import CROSS_BACKEND_SCORE_TOL as TOL

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
DEV = "cpu"
H, N, C = 4, 48, 4
CAP = 4
ROW_KEYS = ("next_idx", "next_prob", "best", "pbest_max", "pbest_entropy")
SEEDS = tuple(range(6))

needs_jax = pytest.mark.skipif(jax is None, reason="needs the JAX reference")


@pytest.fixture(scope="module")
def task():
    return make_synthetic_task(0, H=H, N=N, C=C, device=DEV)


def _f32(x) -> bytes:
    return np.float32(x).tobytes()


def _bitwise(a: dict, b: dict, what="") -> None:
    for k in ROW_KEYS:
        if isinstance(a[k], float):
            assert _f32(a[k]) == _f32(b[k]), (what, k, a[k], b[k])
        else:
            assert a[k] == b[k], (what, k, a[k], b[k])


def _port_factory(task, tmp, capacity=CAP, **kw):
    def make(rid):
        rec = SessionRecorder(out_dir=os.path.join(tmp, rid)) if tmp else None
        app = ServeApp(capacity=capacity, max_wait=0.001, device=DEV,
                       spec=SelectorSpec.create("coda", n_parallel=capacity,
                                                eig_mode="incremental"),
                       recorder=rec, **kw)
        app.add_task("t", task.preds)
        return app

    return make


def _ref_factory(task, tmp, capacity=CAP, **kw):
    from coda_tpu.serve import SelectorSpec as RefSpec
    from coda_tpu.serve import ServeApp as RefApp
    from coda_tpu.telemetry import SessionRecorder as RefRecorder

    def make(rid):
        rec = RefRecorder(out_dir=os.path.join(tmp, rid)) if tmp else None
        app = RefApp(capacity=capacity, max_wait=0.001,
                     spec=RefSpec.create("coda", n_parallel=capacity,
                                         eig_mode="incremental"),
                     recorder=rec, **kw)
        app.add_task("t", task.preds.numpy())
        return app

    return make


class _Ids:
    """Deterministic ``uuid.uuid4`` while a fleet runs, so both packages'
    routers mint the same session ids (and so place them alike)."""

    def __init__(self, monkeypatch, base: int):
        counter = itertools.count(base)
        monkeypatch.setattr(uuid, "uuid4",
                            lambda: uuid.UUID(int=next(counter)))


# ---------------------------------------------------------------------------
# the pure host code against the reference
# ---------------------------------------------------------------------------

@needs_jax
def test_reference_rendezvous_owner_and_rank():
    """``rendezvous_owner`` and ``rendezvous_rank`` equal the reference's
    for 10,000 ids over replica sets of 2-5 ids; a replica removed re-owns
    only its own ids, each to where the rank said."""
    from coda_tpu.serve.router import rendezvous_owner as ref_owner
    from coda_tpu.serve.router import rendezvous_rank as ref_rank

    ids = [f"{i:032x}" for i in range(10_000)]
    for n in range(2, 6):
        reps = [f"r{i}" for i in range(n)]
        owners = [rendezvous_owner(s, reps) for s in ids]
        assert owners == [ref_owner(s, reps) for s in ids], n
        for s in ids[:500]:
            assert rendezvous_rank(s, reps) == ref_rank(s, reps)
        gone = reps[-1]
        for s, o in zip(ids, owners):
            after = rendezvous_owner(s, reps[:-1])
            if o != gone:
                assert after == o      # nobody else's id moves
            else:
                assert after == rendezvous_rank(s, reps)[1]
    with pytest.raises(SlabFull):
        rendezvous_owner("ab", [])


def _scripted(mod, sleeps):
    """One scripted sequence of call outcomes through a package's
    transports; the log of answers, breaker states, retries and budget."""
    log = []

    def outcomes(*seq):
        it = iter(seq)

        def fn(deadline):
            o = next(it)
            if isinstance(o, BaseException):
                raise o
            return o
        return fn

    def call(t, verb, fn, idempotent=False):
        try:
            log.append(("ok", verb, t.call(verb, fn, idempotent=idempotent)))
        except mod.ReplicaUnavailable as e:
            log.append(("unavailable", verb, str(e).split(" (")[0]))
        except Exception as e:
            log.append((type(e).__name__, verb))
        log.append((t.breaker.state, t.breaker.trips,
                    t.breaker.consecutive_failures, round(t.budget.tokens, 3),
                    t.budget.exhaustions, t.retries_total,
                    dict(t.retries_by_verb), t.calls, t.failures))

    # retries by verb and idempotence, then a dead edge burns the budget
    t = mod.ReplicaTransport("r1", max_retries=2, backoff_s=0.01,
                             breaker_threshold=100, retry_budget=5)
    call(t, "best", outcomes(TimeoutError("x"), {"a": 1}))
    call(t, "label", outcomes(TimeoutError("x"), {"a": 2}))
    call(t, "label", outcomes(TimeoutError("x"), {"a": 3}), idempotent=True)
    call(t, "open", outcomes(ConnectionRefusedError("x"), {"a": 4}))
    call(t, "import", outcomes(ConnectionResetError("x"), {"a": 5}))
    call(t, "fence", outcomes(TimeoutError("x"), {"a": 6}), idempotent=True)
    for _ in range(3):
        call(t, "stats", outcomes(*[ConnectionRefusedError("x")] * 4))
    call(t, "healthz", outcomes({"ok": True}))
    # the breaker: trips at 3, fails fast while open, one half-open probe
    b = mod.ReplicaTransport("r2", max_retries=0, breaker_threshold=3,
                             breaker_cooldown_s=3600.0)
    for _ in range(4):
        call(b, "best", outcomes(OSError("x")))
    b.breaker.cooldown_s = 0.0
    log.append((b.breaker.state, b.breaker.allow(), b.breaker.allow()))
    b.breaker.record_failure()
    log.append((b.breaker.state, b.breaker.trips))
    call(b, "best", outcomes({"ok": 1}))
    log.append(sorted(round(d, 9) for d in sleeps))
    return log


@needs_jax
def test_reference_transport_same_states_retries_and_jitter(monkeypatch):
    """One scripted sequence of call outcomes through the port's and the
    reference's ``ReplicaTransport``: the same breaker states, retry
    decisions per verb and idempotence, budget exhaustion into
    ``ReplicaUnavailable`` and backoff delays (the counter-addressed
    jitter); ``VERB_DEADLINES`` is the reference's dict."""
    from coda_tpu.serve import transport as ref

    from coda_tpu_torch.serve import transport as ours

    assert VERB_DEADLINES == ref.VERB_DEADLINES
    for n in range(50):
        for verb in ("best", "label", "import"):
            assert _jitter("r1", verb, n) == ref._jitter("r1", verb, n)
    logs = []
    for mod in (ours, ref):
        sleeps: list = []
        monkeypatch.setattr(mod.time, "sleep", sleeps.append)
        logs.append(_scripted(mod, sleeps))
        monkeypatch.undo()
    assert logs[0] == logs[1]
    answers = [e for e in logs[0] if isinstance(e, tuple) and len(e) <= 3]
    assert ("TimeoutError", "label") in answers       # no request_id
    assert ("ok", "label", {"a": 3}) in answers       # dedupe-gated retry
    assert ("ConnectionResetError", "import") in answers
    assert ("unavailable", "stats",
            "replica r1: retry budget exhausted retrying stats") in answers
    assert ("unavailable", "best", "replica r2: circuit open after 3 "
            "consecutive transport failures") in answers


@needs_jax
def test_reference_journal_read_both_ways(tmp_path):
    """Each package reads the other's migration log and folds it to the
    same ``committed()`` and ``in_doubt()``; a torn tail is dropped; the
    same rows give the same ``payload_digest``."""
    from coda_tpu.serve import journal as ref

    def write(cls, path):
        j = cls(path)
        m1 = j.begin("aaaa", "r0", "r1", 1)
        j.record(m1, "exported", digest="d1", n_labeled=3)
        j.record(m1, "imported")
        j.record(m1, "committed", epoch=1, fenced=True)
        m2 = j.begin("bbbb", "r1", "r0", 4)
        j.record(m2, "exported", digest="d2", n_labeled=7)
        m3 = j.begin("aaaa", "r1", "r2", 2)
        j.record(m3, "committed", epoch=2, fenced=False)
        j.close()
        with open(path, "a") as f:
            f.write('{"mid": "cccc#9", "phase": "int')   # torn tail

    for writer, reader in ((MigrationJournal, ref.MigrationJournal),
                           (ref.MigrationJournal, MigrationJournal)):
        p = str(tmp_path / f"{writer.__module__}.log")
        write(writer, p)
        a, b = MigrationJournal(p), ref.MigrationJournal(p)
        for j in (a, b):
            assert j.torn_tail_dropped and j.records_loaded == 8
        assert a.committed() == b.committed() == {
            "aaaa": {"epoch": 2, "dst": "r2"}}
        assert a.in_doubt() == b.in_doubt()
        assert [d["sid"] for d in a.in_doubt()] == ["bbbb"]
        assert a.stats()["phases"] == b.stats()["phases"]
        assert a.begin("dddd", "r0", "r1", 1) == b.begin("dddd", "r0", "r1",
                                                         1)
        a.close()
        b.close()
    rows = [{"pbest_max": 0.5, "pbest_entropy": 1.25, "next_idx": 3},
            {"pbest_max": 0.625, "pbest_entropy": 0.75, "next_idx": 9}]
    payload = {"session": "ab12", "epoch": 3, "n_labeled": 1, "rows": rows,
               "carries": [np.zeros(3, np.float32)]}
    assert payload_digest(payload) == ref.payload_digest(payload)
    assert payload_digest({}) == ref.payload_digest({})


# ---------------------------------------------------------------------------
# the fleet against the reference fleet, and against one port app
# ---------------------------------------------------------------------------

def _run_fleet(factory, fleet_cls, labels, rid_base):
    """Six sessions through a 3-replica fleet: 2 labels each, an explicit
    migration, 1 label each, a rolling restart with a client thread
    labeling every session twice through it, a peer page, 1 label each, a
    kill of one replica and its revival with crash restore, 1 label
    each. Returns what the comparisons need."""
    fleet = fleet_cls(factory, n_replicas=3).start(warm=True)
    r = fleet.router
    rids = itertools.count(rid_base)
    out: dict = {"owners": {}, "cur": {}}
    try:
        cur = out["cur"]
        for s in SEEDS:
            o = r.open_session(seed=s)
            cur[o["session"]] = o
            out["owners"][o["session"]] = r._locate(o["session"])
        sids = list(cur)

        def label(sid):
            o = cur[sid]
            rid = f"{next(rids):032x}"
            for attempt in range(40):
                try:
                    cur[sid] = r.label(sid, int(labels[o["idx"]]),
                                       request_id=rid)
                    return
                except SlabFull:
                    time.sleep(0.01 * (attempt + 1))
            raise AssertionError(f"label of {sid} never landed")

        def each():
            for sid in sids:
                label(sid)

        each()
        each()
        src = r._locate(sids[0])
        dst = min(x for x in fleet.replica_ids if x != src)
        out["migration"] = r.migrate_session(sids[0], src, dst)
        each()
        traffic = threading.Thread(target=lambda: (each(), each()))
        traffic.start()
        out["rolling"] = fleet.rolling_restart()
        traffic.join()
        page = r._locate(sids[1])
        app = fleet.apps[page]
        assert app.tiers.try_demote(sids[1])
        out["paged"] = (app.tiers.page_to_peer(sids[1]),
                        r._placed.get(sids[1]))
        each()
        victim = r._locate(sids[2])
        before = {s: r.best(s) for s in sids}
        fleet.kill_replica(victim)
        out["restored"] = sorted(fleet.revive_replica(victim)["restored"])
        for _ in range(3):
            r.check_health()
        assert victim in r.routable()
        out["best_after_revive"] = {s: r.best(s) for s in sids}
        out["best_before_kill"] = before
        each()
        out["rows"] = {s: data_rows(r.trace(s)["rounds"]) for s in sids}
        out["where"] = {s: r._locate(s) for s in sids}
        out["counters"] = dict(r.counters)
        out["n_labeled"] = {s: cur[s]["n_labeled"] for s in sids}
        return out
    finally:
        fleet.drain(timeout=10)


@pytest.fixture(scope="module")
def port_run(task, tmp_path_factory):
    tmp = str(tmp_path_factory.mktemp("port_fleet"))
    mp = pytest.MonkeyPatch()
    try:
        _Ids(mp, 1 << 100)
        run = _run_fleet(_port_factory(task, tmp), Fleet,
                         task.labels.numpy(), 1 << 20)
    finally:
        mp.undo()
    run["tmp"] = tmp
    return run


def _hold_rows(ours: list, theirs: list, what: str) -> None:
    """Integers equal and floats within 2.34e-4 up to a first divergence,
    which must be a tie-break flip (the two picks' probabilities within
    2.34e-4 where the reference scored them)."""
    assert len(ours) == len(theirs), what
    for k, (a, b) in enumerate(zip(ours, theirs)):
        if a["next_idx"] != b["next_idx"]:
            assert abs(a["next_prob"] - b["next_prob"]) <= TOL, (what, k)
            return
        assert a["best"] == b["best"], (what, k)
        for q in ("next_prob", "pbest_max", "pbest_entropy"):
            assert abs(a[q] - b[q]) <= TOL, (what, k, q, a[q], b[q])


@needs_jax
def test_reference_fleet_holds_the_reference_fleet(task, port_run, tmp_path,
                                                   monkeypatch):
    """The same operations on a 3-replica fleet of each package: every
    session on the same owner, the router's migrations, peer pages and
    dropped sessions (0) equal, the same replicas restored, and every row
    within the cross-backend contract."""
    from coda_tpu.serve import Fleet as RefFleet

    _Ids(monkeypatch, 1 << 100)
    ref = _run_fleet(_ref_factory(task, str(tmp_path)), RefFleet,
                     task.labels.numpy(), 1 << 20)
    monkeypatch.undo()
    assert port_run["owners"] == ref["owners"]
    for sid, rid in port_run["owners"].items():
        assert rid == rendezvous_owner(sid, ["r0", "r1", "r2"])
    for k in ("migrations", "peer_pages", "sessions_dropped",
              "migration_failures"):
        assert port_run["counters"][k] == ref["counters"][k], k
    assert port_run["counters"]["sessions_dropped"] == 0
    assert port_run["migration"] == ref["migration"]
    assert port_run["paged"] == ref["paged"]
    assert port_run["restored"] == ref["restored"]
    assert port_run["where"] == ref["where"]
    assert port_run["n_labeled"] == ref["n_labeled"]
    rr = {k: v for k, v in port_run["rolling"].items() if k != "rounds"}
    assert rr == {k: v for k, v in ref["rolling"].items() if k != "rounds"}
    for sid in port_run["rows"]:
        _hold_rows(port_run["rows"][sid], ref["rows"][sid], sid)


def test_port_fleet_rows_bitwise_one_app(task, port_run):
    """Each session the port fleet served (migrated, paged, restarted,
    killed and crash-restored) has rows bitwise the same seed's on one
    ``ServeApp`` with the same labels, and ``/best`` bitwise across the
    kill and revival."""
    labels = task.labels.numpy()
    app = _port_factory(task, None)("direct")
    app.start(warm=True)
    try:
        for sid, seed in zip(port_run["rows"], SEEDS):
            rows = port_run["rows"][sid]
            o = app.open_session(seed=seed)
            for _ in range(len(rows) - 1):
                o = app.label(o["session"], int(labels[o["idx"]]))
            mine = data_rows(app.recorder.history(o["session"]))
            assert len(mine) == len(rows) == 8
            for a, b in zip(rows, mine):
                _bitwise(a, b, sid)
            a = port_run["best_before_kill"][sid]
            b = port_run["best_after_revive"][sid]
            assert a["best"] == b["best"] and a["n_labeled"] == \
                b["n_labeled"]
            assert _f32(a["pbest"][a["best"]]) == _f32(b["pbest"][b["best"]])
    finally:
        app.drain(timeout=10)
    c = port_run["counters"]
    assert c["migrations"] == port_run["rolling"]["migrations"] > 1
    assert c["peer_pages"] == 1 and port_run["paged"][0]
    assert port_run["rolling"]["replicas_restarted"] == 3
    assert port_run["rolling"]["migration_failures"] == 0
    assert sum(port_run["rolling"]["migrations_via"].values()) == \
        port_run["rolling"]["migrations"]


def test_port_fleet_streams_verify_from_init(task, port_run):
    """Every session's stream on its current replica replays from init
    bitwise in a fresh slot, each label applied once (8 rows: the start
    and 7 labels)."""
    store = SessionStore(capacity=2, device=DEV)
    store.register_task("t", task.preds)
    for sid, rows in port_run["rows"].items():
        path = os.path.join(port_run["tmp"], port_run["where"][sid],
                            f"session_{sid}.jsonl")
        meta, stream, _ = load_session_stream(path)   # closed by the drain
        stream = data_rows(stream)
        assert len(stream) == 8 == port_run["n_labeled"][sid] + 1
        assert [bool(r["do_update"]) for r in stream] == [False] + [True] * 7
        labels = task.labels.numpy()
        assert [r["label"] for r in stream[1:]] == [
            int(labels[r["next_idx"]]) for r in stream[:-1]]
        for a, b in zip(stream, rows):
            _bitwise(a, b, sid)
        assert verify_session_stream(store, meta, stream, sid=sid) == {
            "parity": True, "rounds": 8}


def test_port_fleet_releases_a_dead_replica(task, tmp_path):
    """``kill_replica`` and ``restart_replica`` free the old app's buckets
    (slab, cached init, predictions) before the factory builds the next,
    and the fleet and the router keep no reference to the old app; the
    revived replica crash-restores its sessions, and the health poll and
    the verbs answer for it."""
    import weakref

    fleet = Fleet(_port_factory(task, str(tmp_path)),
                  n_replicas=2).start(warm=True)
    r = fleet.router
    try:
        o = r.open_session(seed=1)
        sid = o["session"]
        o = r.label(sid, 0)
        for rid, drop in (("r0", fleet.restart_replica),
                          ("r1", fleet.kill_replica)):
            old = fleet.apps[rid]
            buckets = old.store.buckets()
            gone = weakref.ref(old)
            del old
            drop(rid)
            assert buckets and all(
                b.failed == "freed" and b._slab is None and b.preds is None
                for b in buckets)
            del buckets
            gc.collect()
            assert gone() is None, rid
        fleet.revive_replica("r1")
        for _ in range(3):
            r.check_health()
        assert r.routable() == ["r0", "r1"]
        assert r.label(sid, 1)["n_labeled"] == 2
    finally:
        fleet.drain(timeout=10)


def test_port_build_fleet_from_serve_args(tmp_path):
    """``build_fleet`` from ``cli serve``'s arguments: the task loaded
    once for every replica, each with its own record and spill
    directories, the router's journal under the record directory, and a
    tier pinned by ``args.eig_mode`` (no flag sets it)."""
    from coda_tpu_torch import cli
    from coda_tpu_torch.serve import build_fleet
    from coda_tpu_torch.serve.server import parse_args

    loads = []
    load = cli.load_dataset

    def counted(a):
        loads.append(a.synthetic)
        return load(a)

    args = parse_args(["--synthetic", f"{H},{N},{C}", "--capacity", "2",
                       "--device", "cpu", "--no-quality",
                       "--record-dir", str(tmp_path / "rec"),
                       "--tier-spill-dir", str(tmp_path / "spill")])
    args.eig_mode = "factored"
    cli.load_dataset = counted
    try:
        fleet = build_fleet(args, 2).start(warm=False)
    finally:
        cli.load_dataset = load
    try:
        a, b = (fleet.apps[r] for r in ("r0", "r1"))
        assert loads == [f"{H},{N},{C}"]
        assert a.store.task_meta(a.default_task) == \
            b.store.task_meta(b.default_task)
        assert a.recorder.out_dir == str(tmp_path / "rec" / "r0")
        assert dict(a.spec.kwargs)["eig_mode"] == "factored"
        assert fleet.router.journal.path == str(
            tmp_path / "rec" / "router_migrations.log")
        o = fleet.router.open_session(seed=0)
        assert fleet.router.label(o["session"], 1)["n_labeled"] == 1
        assert fleet.router.import_body_cap() == max(
            x.import_body_cap() for x in (a, b))
    finally:
        fleet.drain(timeout=10)


def test_port_sweep_pages_past_the_watermark(task):
    """A warm session past ``max_warm`` goes to the least loaded peer on
    the tiers' sweep (not to disk): imported there, the router pointing
    at it, its next label served by the peer."""
    labels = task.labels.numpy()
    fleet = Fleet(_port_factory(task, None), n_replicas=2).start(warm=True)
    r = fleet.router
    try:
        o = r.open_session(seed=4)
        sid = o["session"]
        o = r.label(sid, int(labels[o["idx"]]))
        src = r._locate(sid)
        app = fleet.apps[src]
        app.tiers.stop()            # the sweep below is the only one
        assert app.tiers.try_demote(sid)
        app.tiers.max_warm = 0
        assert app.tiers.sweep()["hibernated"] == 1
        peer = r._placed[sid]
        assert peer != src and fleet.apps[peer].store.alive(sid)
        assert r.counters["peer_pages"] == 1 and not app.tiers.parked(sid)
        assert r.label(sid, int(labels[o["idx"]]))["n_labeled"] == 2
    finally:
        fleet.drain(timeout=10)


def test_port_health_eviction_and_peer_page_refusal(task):
    """Health eviction needs ``health_hysteresis`` consecutive bad probes
    and rejoins symmetrically; a pager that refuses leaves the session
    warm and reachable."""
    fleet = Fleet(_port_factory(task, None), n_replicas=2).start(warm=False)
    r = fleet.router
    try:
        r.stop()
        app0 = fleet.apps["r0"]
        app0.ready.clear()
        assert r.check_health()["r0"] == "unready"
        assert r.routable() == ["r0", "r1"]
        r.check_health()
        assert r.routable() == ["r1"] and r.healthz()["status"] == \
            "degraded"
        app0.ready.set()
        r.check_health()
        r.check_health()
        assert r.routable() == ["r0", "r1"]
        assert (r.counters["evictions"], r.counters["rejoins"]) == (1, 1)
        o = r.open_session(seed=2)
        sid = o["session"]
        o = r.label(sid, int(o["idx"]) % C)
        app = fleet.apps[r._locate(sid)]
        assert app.tiers.try_demote(sid)
        app.tiers.page_out = lambda s, p: False
        assert app.tiers.page_to_peer(sid) is False and app.tiers.parked(sid)
        assert r.label(sid, int(o["idx"]) % C)["n_labeled"] == 2
    finally:
        fleet.drain(timeout=10)


# ---------------------------------------------------------------------------
# the multi-process HTTP fleet
# ---------------------------------------------------------------------------

def _spawn_replicas(n=2, extra=()):
    env = dict(os.environ)
    procs, urls = [], {}
    for i in range(n):
        rid = f"h{i}"
        p = subprocess.Popen(
            [sys.executable, "-u", "-m", "coda_tpu_torch.cli", "serve",
             "--synthetic", f"{H},{N},{C}", "--port", "0", "--capacity",
             str(CAP), "--device", "cpu", "--no-quality", *extra],
            cwd=ROOT, env=env, stdout=subprocess.PIPE,
            stderr=subprocess.STDOUT, text=True)
        procs.append(p)
        while True:
            line = p.stdout.readline()
            m = re.search(r"http://127\.0\.0\.1:(\d+)/", line or "")
            if m:
                urls[rid] = f"http://127.0.0.1:{m.group(1)}"
                break
            if not line and p.poll() is not None:
                raise RuntimeError(f"replica {rid} died at startup")
    for p in procs:   # keep the pipes drained
        threading.Thread(target=p.stdout.read, daemon=True).start()
    return procs, urls


def test_port_multiprocess_http_fleet(task):
    """Two ``cli serve --device cpu`` subprocesses behind ``HttpReplica``
    handles: open, label, migrate over HTTP (hold, export, import, fence),
    label, close — the rows bitwise a direct app's on the same seed; the
    per-verb deadlines are the reference's."""
    procs, urls = _spawn_replicas()
    r = None
    try:
        replicas = {rid: HttpReplica(rid, url) for rid, url in urls.items()}
        t = replicas["h0"].transport
        assert t.deadline("healthz") == VERB_DEADLINES["healthz"] < 60
        assert t.deadline("import") == VERB_DEADLINES["import"] > 60
        r = SessionRouter(replicas)
        o = None
        for _ in range(600):   # until both warm pools answer
            try:
                o = r.open_session(seed=7)
                break
            except SlabFull:
                time.sleep(0.1)
        sid = o["session"]
        labels = task.labels.numpy()
        for _ in range(3):
            o = r.label(sid, int(labels[o["idx"]]))
        src = r._locate(sid)
        dst = [x for x in urls if x != src][0]
        info = r.migrate_session(sid, src, dst)
        assert info.get("migrated") == sid, info
        assert info["via"] == "snapshot" and info["epoch"] == 1
        assert not replicas[src].has_session(sid)   # fenced over HTTP
        assert replicas[dst].session_epoch(sid) == 1
        for _ in range(3):
            o = r.label(sid, int(labels[o["idx"]]))
        assert o["n_labeled"] == 6
        rows = data_rows(r.trace(sid)["rounds"])
        r.close_session(sid)
        app = _port_factory(task, None, quality=False)("direct")
        app.start(warm=True)
        try:
            c = app.open_session(seed=7)
            for _ in range(6):
                c = app.label(c["session"], int(labels[c["idx"]]))
            mine = data_rows(app.recorder.history(c["session"]))
        finally:
            app.drain(timeout=10)
        assert len(rows) == len(mine) == 7
        for a, b in zip(rows, mine):
            _bitwise(a, b, "http fleet vs direct")
    finally:
        if r is not None:
            r.drain()
        for p in procs:
            p.kill()
        for p in procs:
            p.wait(timeout=30)
