"""The hot/warm/cold session tiers and the cold tier's spill store of the
port (``coda_tpu_torch/serve/tiering.py``, ``serve/spill.py``) on the CPU.

Inputs are the seeded ``make_synthetic_task(0, 4, 48, 4)``, as the
reference's ``tests/test_tiering.py`` builds its own. Tolerances:

  * within the port: bitwise. A session demoted to the warm tier (or
    hibernated to the cold one) and woken keeps its slot digest (every
    state leaf and the key) through the snapshot path, with no replay, and
    continues bitwise a session that never left the slab; the race rules
    hold (a demotion loses to a pinned label, concurrent wakes of one
    session coalesce into one, an export pins);
  * the spill store's files: the port's are read by the reference's
    ``SpillStore`` and the reference's by the port's, payload for payload
    (the parallel deflate of a large leaf is one ordinary zlib stream);
  * against the reference's ``ServeApp`` demoting and waking the same
    session: integers equal, floats within the cross-backend contract
    2.34e-4.
"""

from __future__ import annotations

import os
import threading

import numpy as np
import pytest

try:
    import jax  # noqa: F401
except ImportError:  # a card machine without JAX
    jax = None

from coda_tpu_torch.data import make_synthetic_task
from coda_tpu_torch.serve import SelectorSpec, ServeApp, SpillStore
from coda_tpu_torch.serve import spill as tspill
from coda_tpu_torch.telemetry.recorder import CROSS_BACKEND_SCORE_TOL as TOL

DEV = "cpu"
H, N, C = 4, 48, 4
ROW_KEYS = ("next_idx", "next_prob", "best", "pbest_max", "pbest_entropy")

needs_jax = pytest.mark.skipif(jax is None, reason="needs the JAX reference")


@pytest.fixture(scope="module")
def task():
    return make_synthetic_task(0, H=H, N=N, C=C, device=DEV)


def _app(task, capacity=4, **kw):
    kw.setdefault("quality", False)
    app = ServeApp(capacity=capacity, max_wait=0.001, device=DEV,
                   spec=SelectorSpec.create("coda", n_parallel=4,
                                            eig_mode="incremental"), **kw)
    app.add_task("t", task.preds)
    app.start(warm=True)
    return app


def _drive(app, seed, rounds, labels):
    out = app.open_session(seed=seed)
    for _ in range(rounds):
        out = app.label(out["session"], int(labels[out["idx"]]))
    return out["session"], out


def _row(app, sid):
    return {k: app.store.get(sid).last[k] for k in ROW_KEYS}


def _bits(a: dict, b: dict) -> bool:
    return all(np.float32(a[k]).tobytes() == np.float32(b[k]).tobytes()
               if isinstance(a[k], float) else a[k] == b[k]
               for k in ROW_KEYS)


def _digest(app, sid):
    s = app.store.get(sid)
    return s.bucket.slot_digest(s.slot)


@pytest.mark.parametrize("tier", ["warm", "cold"])
def test_port_wake_keeps_the_digest_bitwise(task, tmp_path, tier):
    """Demote (and hibernate) a session, wake it by labeling it: its slot
    digest is bitwise the pre-demotion one, through the snapshot path (no
    replay), and it continues bitwise a never-demoted twin."""
    labels = task.labels.numpy()
    app = _app(task, tier_spill_dir=str(tmp_path / "spill"))
    ctl = _app(task)
    try:
        sid, out = _drive(app, 5, 3, labels)
        csid, cout = _drive(ctl, 5, 3, labels)
        d0 = _digest(app, sid)
        assert app.tiers.try_demote(sid)
        assert not app.store.alive(sid)
        if tier == "cold":
            assert app.tiers.hibernate(sid)
            assert app.tiers.counts() == {"hot": 0, "warm": 0, "cold": 1}
        assert app.session_epoch(sid) == {"session": sid, "epoch": 0}
        assert app.best(sid)["n_labeled"] == 3      # the wake
        assert _digest(app, sid) == d0
        m = app.metrics
        assert (m.wakes, m.wakes_via_replay) == (1, 0)
        assert getattr(m, f"wakes_from_{tier}") == 1
        for k in range(3):
            out = app.label(sid, int(labels[out["idx"]]))
            cout = ctl.label(csid, int(labels[cout["idx"]]))
            assert _bits(_row(app, sid), _row(ctl, csid)), k
    finally:
        app.drain()
        ctl.drain()


def test_port_admission_past_capacity_demotes_not_503(task):
    """A full two-slot slab admits a third session by demoting the least
    recently used one; every session stays addressable, no label lost."""
    labels = task.labels.numpy()
    app = _app(task, capacity=2)
    try:
        sids = [_drive(app, s, 2, labels)[0] for s in range(3)]
        st = app.stats()
        assert st["open_sessions"] == 3 and st["slab_occupancy"] == 2
        assert st["tiers"] == {"hot": 2, "warm": 1, "cold": 0}
        assert sorted(app.list_sessions()["sessions"]) == sorted(sids)
        for sid in sids:
            assert app.best(sid)["n_labeled"] == 2
    finally:
        app.drain()


def test_port_race_rules(task):
    """A demotion loses to a pinned label and to an export in flight;
    concurrent wakes of one session coalesce into one wake."""
    labels = task.labels.numpy()
    app = _app(task)
    try:
        sid, _ = _drive(app, 1, 2, labels)
        sess = app.store.get_pinned(sid)          # a label in flight
        assert not app.tiers.try_demote(sid)
        app.store.unpin(sess)
        # an export pins: a demotion attempted inside its snapshot loses
        bucket = sess.bucket
        real = bucket.snapshot_slot
        lost = []

        def snap(slot):
            lost.append(app.tiers.try_demote(sid))
            return real(slot)

        bucket.snapshot_slot = snap
        payload = app.export_session(sid)
        bucket.snapshot_slot = real
        assert lost == [False] and payload["n_labeled"] == 2
        assert app.tiers.try_demote(sid)
        errors = []

        def wake():
            try:
                app.best(sid)
            except Exception as e:  # noqa: BLE001 - surfaced below
                errors.append(e)

        threads = [threading.Thread(target=wake) for _ in range(6)]
        for t in threads:
            t.start()
        for t in threads:
            t.join()
        assert errors == [] and app.metrics.wakes == 1
    finally:
        app.drain()


def test_port_demote_during_label_exactly_once(task):
    """``demote_during_label`` demotes the session at the moment each label
    arrives: every label still applies exactly once and the trajectory is
    bitwise a fault-free twin's."""
    labels = task.labels.numpy()
    app = _app(task, fault_spec="demote_during_label:every=1")
    ctl = _app(task)
    try:
        sid, out = _drive(app, 4, 4, labels)
        csid, _ = _drive(ctl, 4, 4, labels)
        assert out["n_labeled"] == 4 and app.metrics.wakes >= 3
        assert _bits(_row(app, sid), _row(ctl, csid))
    finally:
        app.drain()
        ctl.drain()


def _payload(rng, big: int):
    from coda_tpu_torch.serve.recovery import _pack

    return {"v": 1, "kind": "session_export", "session": "ab12",
            "task": "t", "rows": [{"next_idx": 3, "next_prob": 0.25}],
            "carries": [_pack(rng.random(big, dtype=np.float32)),
                        _pack(np.arange(5, dtype=np.int64)),
                        _pack(np.float32(2.5))],
            "key": _pack(np.array([1, 2], np.int64))}


def test_port_spill_store_round_trip_and_parallel_deflate(tmp_path,
                                                          monkeypatch):
    """Put, get (lazy), delete, restart: the payloads come back equal; a
    large leaf deflated in parallel pieces inflates with ``zlib``."""
    import zlib

    monkeypatch.setattr(tspill, "PARALLEL_MIN_BYTES", 1 << 12)
    monkeypatch.setattr(tspill, "CHUNK_BYTES", 1 << 10)
    rng = np.random.default_rng(0)
    data = rng.random(3000, dtype=np.float32).tobytes()
    assert zlib.decompress(tspill.compress(data)) == data
    store = SpillStore(str(tmp_path))
    p1, p2 = _payload(rng, 4000), _payload(rng, 7)
    assert store.put("aa", p1) and store.put("bb", p2)
    assert tspill.materialize(store.get("aa")) == p1
    assert store.delete("bb") and "bb" not in store
    store.close()
    again = SpillStore(str(tmp_path))
    assert again.sids() == ["aa"] and again.get("aa") == p1
    again.close()


@needs_jax
@pytest.mark.parametrize("writer", ["port", "reference"])
def test_reference_spill_files_read_both_ways(tmp_path, monkeypatch, writer):
    """A spill directory written by one package is read by the other,
    payload for payload (the port's parallel-deflated large leaf too)."""
    from coda_tpu.serve import spill as rspill

    monkeypatch.setattr(tspill, "PARALLEL_MIN_BYTES", 1 << 12)
    monkeypatch.setattr(tspill, "CHUNK_BYTES", 1 << 10)
    rng = np.random.default_rng(1)
    payloads = {"aa": _payload(rng, 5000), "bb": _payload(rng, 3)}
    w, r = (tspill, rspill) if writer == "port" else (rspill, tspill)
    store = w.SpillStore(str(tmp_path))
    for sid, p in payloads.items():
        assert store.put(sid, p)
    assert store.delete("bb")
    store.close()
    other = r.SpillStore(str(tmp_path))
    assert other.sids() == ["aa"]
    assert r.materialize(other.get("aa")) == payloads["aa"]
    other.close()


@needs_jax
def test_reference_demote_and_wake_matches_the_reference(task):
    """The same session demoted after 3 labels and woken by 3 more, in the
    port and in the reference: the trajectories agree within the
    cross-backend contract."""
    from coda_tpu.serve import SelectorSpec as RefSpec
    from coda_tpu.serve.server import ServeApp as RefApp

    labels = task.labels.numpy()
    ref = RefApp(capacity=4, max_wait=0.001, quality=False,
                 spec=RefSpec.create("coda", n_parallel=4,
                                     eig_mode="incremental"))
    ref.add_task("t", task.preds.numpy())
    ref.start(warm=True)
    app = _app(task)
    try:
        rows = []
        for a in (app, ref):
            out = a.open_session(seed=6)
            sid, got = out["session"], []
            for k in range(6):
                if k == 3:
                    assert a.tiers.try_demote(sid)
                out = a.label(sid, int(labels[out["idx"]]))
                got.append(dict(a.store.get(sid).last))
            assert a.metrics.wakes == 1 and a.metrics.wakes_via_replay == 0
            rows.append(got)
        for k, (x, y) in enumerate(zip(*rows)):
            assert x["next_idx"] == y["next_idx"] and x["best"] == y["best"]
            for q in ("next_prob", "pbest_max", "pbest_entropy"):
                assert abs(x[q] - y[q]) <= TOL, (k, q)
    finally:
        app.drain()
        ref.drain()


def test_port_page_out_hook_names_slice_9(task):
    """The fleet's peer paging hook is slice 9 of the port."""
    app = _app(task)
    try:
        assert app.tiers.page_out is None
        assert not app.tiers.page_to_peer("ab")
        with pytest.raises(NotImplementedError, match="slice 9"):
            app.tiers.page_out = lambda sid, payload: True
    finally:
        app.drain()


def test_port_hibernated_session_survives_a_restart(task, tmp_path):
    """A cold session's spill frame outlives its process: a new app on the
    same spill directory wakes it with its digest bitwise."""
    labels = task.labels.numpy()
    spill_dir = str(tmp_path / "spill")
    app = _app(task, tier_spill_dir=spill_dir)
    sid, _ = _drive(app, 2, 3, labels)
    d0 = _digest(app, sid)
    assert app.tiers.try_demote(sid) and app.tiers.hibernate(sid)
    app.drain()
    assert os.listdir(spill_dir)
    app2 = _app(task, tier_spill_dir=spill_dir)
    try:
        assert app2.tiers.counts()["cold"] == 1
        assert app2.best(sid)["n_labeled"] == 3
        assert _digest(app2, sid) == d0
    finally:
        app2.drain()


def test_port_pooled_host_copies_come_back_only_when_unreferenced():
    """On the card a demotion copies a large carry out of the pinned
    staging buffers into a pooled host array; the array returns to its
    pool only once every view a payload holds of it is gone, so it is
    never rewritten while read. (The staging buffers are set by hand
    here: the card pins them.)"""
    import gc

    import torch

    from coda_tpu_torch.serve.recovery import _pack, _unpack
    from coda_tpu_torch.serve.state import Bucket

    b = Bucket.__new__(Bucket)
    b._staging = [torch.arange(1 << 19, dtype=torch.float32),
                  torch.ones(3)]
    b._host_free, b.capacity = {}, 2
    first = Bucket._from_stage(b)
    assert first[0].flags.writeable and first[0][7] == 7.0
    view = _unpack(_pack(first[0], raw=True))     # the warm payload's form
    del first
    gc.collect()
    assert b._host_free.get(0) == []              # still lent to the view
    del view
    gc.collect()
    assert len(b._host_free[0]) == 1 and 1 not in b._host_free
    b._staging[0].fill_(3.0)
    again = Bucket._from_stage(b)
    assert b._host_free[0] == [] and float(again[0].sum()) == 3.0 * (1 << 19)
