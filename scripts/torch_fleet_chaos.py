"""The fleet fault matrix on the PyTorch port: every fleet-layer failure
mode driven against a 2-replica ``coda_tpu_torch`` fleet, each ending with
sessions reachable, labels exact and nothing applied twice (counterpart of
``scripts/check_fault_matrix.py --fleet``, the same six scenarios and the
same checks):

  ========================  ==============================================
  fleet_stale_owner_fence   a partition eats the migration's source fence;
                            the healed stale copy refuses the router's
                            epoch stamp (``StaleOwner``) and the routed
                            retry commits once on the new owner
  fleet_kill_replica_mid_   the destination is killed between export and
  migration                 import: didn't-move, the source serves on, the
                            revived replica rejoins
  fleet_router_restart_     the router dies mid-migration at ``intent``,
  journal                   ``exported`` and ``imported``; a fresh router
                            resolves each from the journal
  fleet_healthz_flap        a flapping ``/healthz`` never evicts
                            (hysteresis), nothing migrates
  fleet_transport_chaos     drop + delay + duplicate on live labels:
                            retries and the request-id dedupe absorb them
  fleet_partition_heal      one replica partitions for 30 arrivals and
                            heals: breaker, retries, exact counts
  ========================  ==============================================

Every function takes the task (a ``coda_tpu_torch.data.Dataset``) and the
device, so the same matrix runs at a test shape on the CPU and at
``digits_h80`` on the card. ``poll=False`` keeps the router's health poller
off during the label traffic, so the counter-addressed faults fire a
fixed number of times (the CPU tests compare those counts with the
reference's).

    python scripts/torch_fleet_chaos.py [--task digits_h80] [--device cpu]
        [--only NAME,...] [--out results.json]
"""

from __future__ import annotations

import argparse
import json
import os
import shutil
import sys
import tempfile
import threading
import time
import uuid

ROUNDS = 3


def with_retries(fn, retries: int, backoff_s: float):
    """Run ``fn`` with exponential backoff on transient failures (the
    request-id dedupe makes a retried label exactly-once)."""
    attempt = 0
    while True:
        try:
            return fn()
        except (ValueError, KeyError, TypeError):
            raise
        except Exception:
            if attempt >= retries:
                raise
            time.sleep(backoff_s * (2 ** attempt))
            attempt += 1


def make_fleet(tmpdir, task, device, n=2, fault_spec=None, hysteresis=2,
               capacity=6, poll_s=None, poll=True):
    """A 2-replica in-process fleet with per-replica record dirs and the
    router's migration journal armed (``<tmpdir>/router_migrations.log``).
    ``poll=False`` starts the replicas only (no health poller)."""
    from coda_tpu_torch.serve import Fleet, SelectorSpec, ServeApp
    from coda_tpu_torch.telemetry import SessionRecorder

    def factory(rid):
        rec = SessionRecorder(out_dir=os.path.join(tmpdir, rid))
        app = ServeApp(capacity=capacity, max_wait=0.001, device=device,
                       spec=SelectorSpec.create("coda",
                                                n_parallel=capacity),
                       recorder=rec)
        app.add_task(task.name, task.preds)
        return app

    fleet = Fleet(factory, n_replicas=n,
                  journal_path=os.path.join(tmpdir,
                                            "router_migrations.log"),
                  fault_spec=fault_spec, health_hysteresis=hysteresis)
    # matrix-speed knobs: the policies under test are the same, only the
    # waits shrink (breaker heals in 50 ms, backoff base 10 ms)
    for h in fleet.router.replicas.values():
        h.transport.backoff_s = 0.01
        h.transport.breaker.cooldown_s = 0.05
    if poll:
        fleet.start(warm=True, **({"poll_s": poll_s} if poll_s else {}))
    else:
        fleet.start_replicas(warm=True)
    return fleet


def _classes(task) -> int:
    return int(task.preds.shape[-1])


def drive_router(router, C, n_sessions=4, rounds=ROUNDS, retries=12,
                 backoff_s=0.03):
    """Closed-loop retrying traffic through the router front door (one
    idempotent request_id per logical label). Returns (sids, errors)."""
    sids = [None] * n_sessions
    errors: list = []

    def worker(i):
        try:
            out = with_retries(lambda: router.open_session(seed=i),
                               retries, backoff_s)
            sids[i] = out["session"]
            for _ in range(rounds):
                lab = int(out["idx"]) % C
                rid = uuid.uuid4().hex
                out = with_retries(
                    lambda: router.label(sids[i], lab, request_id=rid),
                    retries, backoff_s)
            if out["n_labeled"] != rounds:
                errors.append(
                    f"session {sids[i]}: server applied "
                    f"{out['n_labeled']} labels, client issued {rounds}")
        except Exception as e:
            errors.append(f"session {i}: {e!r}")

    threads = [threading.Thread(target=worker, args=(i,))
               for i in range(n_sessions)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    return sids, errors


def reachability(router, sids, rounds=ROUNDS) -> list:
    """Every session must still answer through the router with the exact
    committed label count — the all-scenarios postcondition."""
    out = []
    for sid in sids:
        if sid is None:
            continue
        try:
            b = router.best(sid)
        except Exception as e:
            out.append(f"session {sid} unreachable after recovery: {e!r}")
            continue
        if b["n_labeled"] != rounds:
            out.append(f"session {sid}: {b['n_labeled']} labels committed"
                       f", client issued {rounds} (lost or double)")
    return out


def stale_owner_fence(tmpdir, task, device) -> tuple:
    """Partition → migrate (the source fence is eaten) → heal (the stale
    copy revives) → old-owner write with the router's stamp: the epoch
    fence MUST reject it, and the routed retry commits exactly once."""
    from coda_tpu_torch.serve.state import StaleOwner

    C = _classes(task)
    fleet = make_fleet(tmpdir, task, device,
                       fault_spec="net_drop:task=fence,times=8")
    r = fleet.router
    out: list = []
    stats: dict = {}
    try:
        o = r.open_session(seed=0)
        sid = o["session"]
        o = r.label(sid, int(o["idx"]) % C, request_id=uuid.uuid4().hex)
        src = r._locate(sid)
        dst = [x for x in fleet.replica_ids if x != src][0]
        info = r.migrate_session(sid, src, dst)
        if info.get("migrated") != sid:
            out.append(f"stale_owner: migration did not commit: {info}")
            return out, stats
        if not info.get("fence_pending"):
            out.append("stale_owner: the injected partition should have "
                       "eaten the source fence, but it landed")
        # the partition heals AND the source restarts (losing its
        # in-memory hold): the stale copy is live again
        src_app = fleet.apps[src]
        with src_app.store.lock:
            src_app._holds.clear()
        epoch = r._epochs.get(sid)
        try:
            fleet.router.replicas[src].label(
                sid, 0, request_id=uuid.uuid4().hex, epoch=epoch)
            out.append("stale_owner: SPLIT BRAIN — the stale copy "
                       "COMMITTED a fenced label (the epoch fence is "
                       "dead)")
        except StaleOwner:
            pass  # the fence held
        except Exception as e:
            out.append(f"stale_owner: expected StaleOwner, got {e!r}")
        o = r.label(sid, int(o["idx"]) % C, request_id=uuid.uuid4().hex)
        if o["n_labeled"] != 2:
            out.append(f"stale_owner: {o['n_labeled']} labels after 2 "
                       "issued (lost or double-applied)")
        fenced = src_app.metrics.snapshot()["fencing_rejections"]
        if fenced < 1:
            out.append("stale_owner: the replica never counted a "
                       "fencing rejection")
        stats = {"fencing_rejections": fenced,
                 "fence_failures": r.counters["fence_failures"],
                 "migrations": r.counters["migrations"],
                 "migration_verified": sum(r.migrations_via.values())}
        return out, stats
    finally:
        fleet.drain(timeout=10)


def kill_replica_mid_migration(tmpdir, task, device) -> tuple:
    """The destination is killed between a migration's export and its
    import (the ``kill_replica`` fault at ``migrate_mid``): the move
    degrades to didn't-move, nothing is dropped, and the revived replica
    rejoins."""
    from coda_tpu_torch.serve.faults import FaultInjector

    C = _classes(task)
    fleet = make_fleet(tmpdir, task, device, poll_s=0.05)
    r = fleet.router
    out: list = []
    stats: dict = {}
    try:
        o = r.open_session(seed=0)
        sid = o["session"]
        o = r.label(sid, int(o["idx"]) % C, request_id=uuid.uuid4().hex)
        src = r._locate(sid)
        dst = [x for x in fleet.replica_ids if x != src][0]
        r.faults = FaultInjector(f"kill_replica:edge={dst}")
        info = r.migrate_session(sid, src, dst)
        if fleet.kills.get(dst, 0) != 1:
            out.append("kill_mid_migration: the fault never killed the "
                       "destination")
        if "failed" not in info:
            out.append(f"kill_mid_migration: migration against a dead "
                       f"destination should fail didn't-move: {info}")
        if r.counters["sessions_dropped"]:
            out.append("kill_mid_migration: a session was counted "
                       "dropped")
        o = r.label(sid, int(o["idx"]) % C, request_id=uuid.uuid4().hex)
        if o["n_labeled"] != 2:
            out.append(f"kill_mid_migration: {o['n_labeled']} labels "
                       "after 2 issued")
        r.faults = None
        fleet.revive_replica(dst)
        for _ in range(3):
            r.check_health()
        if dst not in r.routable():
            out.append("kill_mid_migration: revived replica never "
                       "rejoined routing")
        o = r.label(sid, int(o["idx"]) % C, request_id=uuid.uuid4().hex)
        if o["n_labeled"] != 3:
            out.append(f"kill_mid_migration: {o['n_labeled']} labels "
                       "after 3 issued (post-revive)")
        stats = {"kills": dict(fleet.kills),
                 "migration_failures": r.counters["migration_failures"],
                 "sessions_dropped": r.counters["sessions_dropped"]}
        return out, stats
    finally:
        fleet.drain(timeout=10)


def router_restart_journal(tmpdir, task, device) -> tuple:
    """The router dies mid-migration at each journal phase; a fresh router
    over the same replicas and journal resolves every in-doubt move to
    didn't-move (``intent``/``exported``) or moved-exactly-once
    (``imported``), the session reachable and exact either way."""
    from coda_tpu_torch.serve import InprocReplica, SessionRouter
    from coda_tpu_torch.serve.journal import payload_digest

    C = _classes(task)
    out: list = []
    stats: dict = {"phases": {}}
    for phase in ("intent", "exported", "imported"):
        d = os.path.join(tmpdir, f"journal_{phase}")
        os.makedirs(d, exist_ok=True)
        fleet = make_fleet(d, task, device)
        r = fleet.router
        r2 = None
        try:
            o = r.open_session(seed=0)
            sid = o["session"]
            o = r.label(sid, int(o["idx"]) % C,
                        request_id=uuid.uuid4().hex)
            src = r._locate(sid)
            dst = [x for x in fleet.replica_ids if x != src][0]
            # the migration's steps by hand up to `phase`, then "die":
            # the journal and replica state a kill at that point leaves
            epoch_next = r._epochs.get(sid, 0) + 1
            mid = r.journal.begin(sid, src, dst, epoch_next)
            if phase in ("exported", "imported"):
                payload = dict(
                    r.replicas[src].export_for_migration(sid),
                    epoch=epoch_next)   # the source is now HELD
                r.journal.record(mid, "exported",
                                 digest=payload_digest(payload),
                                 n_labeled=payload.get("n_labeled"))
            if phase == "imported":
                r.replicas[dst].import_payload(payload)
                r.journal.record(mid, "imported")
            r.stop()   # the old router is dead; its gate died with it
            r2 = SessionRouter(
                {rid: InprocReplica(rid, app)
                 for rid, app in fleet.apps.items()},
                journal_path=os.path.join(d, "router_migrations.log"))
            rep = r2.recover_from_journal()
            expect = "finalized" if phase == "imported" else "restored"
            if sid not in rep.get(expect, []):
                out.append(f"journal[{phase}]: expected {expect}, got "
                           f"{rep}")
            if phase == "imported":
                if not fleet.apps[dst].store.alive(sid):
                    out.append(f"journal[{phase}]: finalized session "
                               "not live on the destination")
                if fleet.apps[src].store.alive(sid) or \
                        fleet.apps[src].tiers.parked(sid):
                    out.append(f"journal[{phase}]: the source copy "
                               "survived finalization (split brain)")
                if r2._epochs.get(sid) != epoch_next:
                    out.append(f"journal[{phase}]: recovered epoch "
                               f"{r2._epochs.get(sid)} != {epoch_next}")
            elif fleet.apps[src].held(sid):
                out.append(f"journal[{phase}]: the source hold was "
                           "never lifted — the session is wedged")
            o2 = r2.label(sid, int(o["idx"]) % C,
                          request_id=uuid.uuid4().hex)
            if o2["n_labeled"] != 2:
                out.append(f"journal[{phase}]: {o2['n_labeled']} labels "
                           "after 2 issued")
            stats["phases"][phase] = {
                "resolved": rep["resolved"],
                "journal_replays": r2.counters["journal_replays"]}
        finally:
            if r2 is not None:
                r2.drain()
            fleet.drain(timeout=10)
            shutil.rmtree(d, ignore_errors=True)
    return out, stats


def healthz_flap(tmpdir, task, device) -> tuple:
    """A flapping ``/healthz`` must NOT churn the routing set: with
    hysteresis K=2 an alternating probe never evicts, so no needless
    drain-and-migrate runs and traffic is untouched."""
    fleet = make_fleet(tmpdir, task, device,
                       fault_spec="flap_healthz:edge=r0,every=2,times=64",
                       hysteresis=2, poll_s=0.02)
    r = fleet.router
    try:
        sids, errors = drive_router(r, _classes(task), n_sessions=4)
        out = list(errors)
        time.sleep(0.3)   # a few dozen flapping poll cycles
        fired = sum(f["fired"] for f in r.faults.snapshot()
                    if f["name"] == "flap_healthz")
        if fired < 4:
            out.append(f"healthz_flap: the flap only fired {fired} "
                       "times (unexercised)")
        if r.counters["evictions"]:
            out.append(f"healthz_flap: {r.counters['evictions']} "
                       "eviction(s) from a flapping probe — hysteresis "
                       "is dead and the keyspace churned")
        if r.counters["migrations"]:
            out.append(f"healthz_flap: {r.counters['migrations']} "
                       "needless migration(s) triggered by the flap")
        out += reachability(r, sids)
        return out, {"flaps_fired": fired,
                     "evictions": r.counters["evictions"]}
    finally:
        fleet.drain(timeout=10)


TRANSPORT_CHAOS = ("net_drop:every=9,times=8;"
                   "net_delay:every=5,ms=4,times=24;"
                   "net_dup:every=7,times=8,task=label")


def transport_chaos(tmpdir, task, device, poll=True) -> tuple:
    """Drop + delay + duplicate on live label traffic: transport retries
    absorb the drops, the request-id dedupe absorbs the duplicates, and
    every session ends with the exact label count."""
    fleet = make_fleet(tmpdir, task, device, fault_spec=TRANSPORT_CHAOS,
                       poll=poll)
    r = fleet.router
    try:
        sids, errors = drive_router(r, _classes(task), n_sessions=4)
        out = list(errors)
        fired = {f["name"]: f["fired"] for f in r.faults.snapshot()}
        for name in ("net_drop", "net_delay", "net_dup"):
            if not fired.get(name):
                out.append(f"transport_chaos: {name} never fired "
                           "(unexercised)")
        retries = sum(
            (r.stats()["router"].get("transport_retries") or {}).values())
        out += reachability(r, sids)
        return out, {"faults_fired": fired,
                     "transport_retries": retries,
                     "dropped_sessions": r.counters["sessions_dropped"]}
    finally:
        fleet.drain(timeout=10)


def partition_heal(tmpdir, task, device) -> tuple:
    """One replica partitions for an arrival window and heals: (1) clean
    traffic, at least one session on the soon-partitioned replica; (2)
    labels under the partition — the breaker trips, client retries wait
    the outage out; (3) the window burns through and traffic completes
    clean. 0 errors and exact counts end to end."""
    from coda_tpu_torch.serve.faults import FaultInjector

    C = _classes(task)
    fleet = make_fleet(tmpdir, task, device, poll_s=0.03)
    r = fleet.router
    out: list = []
    try:
        sessions: dict = {}
        for i in range(4):
            o = with_retries(lambda: r.open_session(seed=i), 8, 0.03)
            sessions[o["session"]] = o

        def label_all(expected):
            for sid in list(sessions):
                o = sessions[sid]
                lab = int(o["idx"]) % C
                rid = uuid.uuid4().hex
                o = with_retries(
                    lambda: r.label(sid, lab, request_id=rid), 16, 0.05)
                sessions[sid] = o
                if o["n_labeled"] != expected:
                    out.append(
                        f"partition_heal: session {sid} committed "
                        f"{o['n_labeled']} labels, client issued "
                        f"{expected} (lost or double)")

        label_all(1)   # phase 1: clean
        if not any(r._locate(sid) == "r1" for sid in sessions):
            # rendezvous put nothing on r1: move one there (a clean
            # migration) so the partition provably has traffic to eat
            sid = next(iter(sessions))
            info = r.migrate_session(sid, r._locate(sid), "r1")
            if "migrated" not in info:
                out.append(f"partition_heal: setup migration failed: "
                           f"{info}")
        window = 30
        inj = FaultInjector(f"partition:edge=r1,times={window}")
        r.faults = inj
        for h in r.replicas.values():
            h.transport.faults = inj
        label_all(2)   # phase 2: under the partition, retries absorb
        deadline = time.monotonic() + 30
        while time.monotonic() < deadline:
            fired = sum(f["fired"] for f in inj.snapshot()
                        if f["name"] == "partition")
            if fired >= window:
                break
            time.sleep(0.05)
        label_all(3)   # post-heal: clean again
        fired = sum(f["fired"] for f in inj.snapshot()
                    if f["name"] == "partition")
        if fired < 1:
            out.append("partition_heal: the partition never fired")
        t1 = r.replicas["r1"].transport.snapshot()
        if not (t1["breaker_trips"] > 0 or r.counters["evictions"] > 0
                or t1["retries_total"] > 0):
            out.append("partition_heal: the partition was invisible to "
                       "breaker, eviction, AND retries")
        out += reachability(r, list(sessions))
        return out, {"partition_fired": fired,
                     "partition_window": window,
                     "breaker_trips": t1["breaker_trips"],
                     "evictions": r.counters["evictions"],
                     "transport_retries": t1["retries_total"]}
    finally:
        fleet.drain(timeout=10)


SCENARIOS = {
    "fleet_stale_owner_fence": stale_owner_fence,
    "fleet_kill_replica_mid_migration": kill_replica_mid_migration,
    "fleet_router_restart_journal": router_restart_journal,
    "fleet_healthz_flap": healthz_flap,
    "fleet_transport_chaos": transport_chaos,
    "fleet_partition_heal": partition_heal,
}


def run_matrix(task, device, only=None) -> dict:
    """{scenario: {"violations": [...], ...stats}}, each scenario in its
    own temporary directory (``only`` filters by name)."""
    results: dict = {}
    for name, fn in SCENARIOS.items():
        if only and name not in only:
            continue
        d = tempfile.mkdtemp(prefix="fleet_chaos_")
        try:
            violations, stats = fn(d, task, device)
        finally:
            shutil.rmtree(d, ignore_errors=True)
        results[name] = dict({"violations": violations}, **stats)
    return results


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--task", default="digits_h80")
    p.add_argument("--data-dir", default="data")
    p.add_argument("--device", default="cuda")
    p.add_argument("--only", default=None,
                   help="comma-separated scenario filter")
    p.add_argument("--out", default=None, help="write the results JSON")
    args = p.parse_args(argv)
    sys.path.insert(0, os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))))
    from coda_tpu_torch.data import Dataset, find_task_file

    task = Dataset.from_file(find_task_file(args.data_dir, args.task),
                             name=args.task, device=args.device)
    only = set(args.only.split(",")) if args.only else None
    results = run_matrix(task, args.device, only=only)
    bad = 0
    for name, sc in results.items():
        for v in sc["violations"]:
            print(f"FAIL {v}")
            bad += 1
        if not sc["violations"]:
            print(f"ok   {name}")
    if args.out:
        with open(args.out, "w") as f:
            json.dump(results, f, indent=2)
    print(f"fleet fault matrix: {len(results)} scenario(s), {bad} "
          "violation(s)")
    return 1 if bad else 0


if __name__ == "__main__":
    raise SystemExit(main())
