"""The serve slab of the port (``coda_tpu_torch/serve``: the slab, the
store, the batcher, the session recorder and the healer) on the CPU.

Inputs are seeded synthetic tasks (``make_synthetic_task``, the same
arrays in both packages) and ``data/digits_h80.npz``. Tolerances:

  * the port's ``InteractiveSelector`` against the reference's (coda, iid,
    model_picker): equal trajectories (items and best models equal, the
    selection scores within the cross-backend contract 2.34e-4), or a
    first divergence that is a near tie: the reference's own scores of
    the two picks within 2.34e-4 (the triage of ``engine.replay``'s
    ``tie-break-flip``);
  * the port's slab against the port's ``InteractiveSelector``, the
    ``batched`` lowering against ``map``, a healed bucket against the
    unfaulted run: bitwise (items, scores, best models and the P(best)
    digest), idle slots' states and keys bitwise unchanged;
  * the port's slab against the reference's ``Bucket(step_impl="map")``,
    and its session stream against the reference's, row for row: the
    integers equal, the floats within 2.34e-4, or the near-tie triage.
"""

from __future__ import annotations

import json
import os

import numpy as np
import pytest
import torch

try:
    import jax
    import jax.numpy as jnp
except ImportError:  # a card machine without JAX
    jax = jnp = None

from coda_tpu_torch.data import Dataset, make_synthetic_task
from coda_tpu_torch.selectors import coda as tcoda
from coda_tpu_torch.selectors.protocol import InteractiveSelector
from coda_tpu_torch.serve import (
    BucketHealer,
    FaultInjector,
    ReplayMismatch,
    SelectorSpec,
    ServeApp,
    SessionStore,
    SlabFull,
    Ticket,
    heal_bucket,
)
from coda_tpu_torch.serve.batcher import Batcher
from coda_tpu_torch.serve.faults import PENDING_SITES, parse_fault_spec
from coda_tpu_torch import random as trandom
from coda_tpu_torch.serve.state import state_digest, tree_leaves
from coda_tpu_torch.telemetry import SessionRecorder
from coda_tpu_torch.telemetry.recorder import CROSS_BACKEND_SCORE_TOL as TOL

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)
DEV = "cpu"
SHAPE = (6, 96, 4)        # (H, N, C)

needs_jax = pytest.mark.skipif(jax is None, reason="needs the JAX reference")


@pytest.fixture(scope="module")
def task():
    H, N, C = SHAPE
    return make_synthetic_task(0, H=H, N=N, C=C, device=DEV)


@pytest.fixture(scope="module")
def h80():
    return Dataset.from_file(os.path.join(ROOT, "data", "digits_h80.npz"),
                             name="digits_h80", device=DEV)


def _spec(**kw):
    kw.setdefault("eig_mode", "incremental")
    return SelectorSpec.create("coda", n_parallel=4, **kw)


def _store(preds, spec, cap=4, impl="map", **kw):
    store = SessionStore(capacity=cap, step_impl=impl, device=DEV, **kw)
    store.register_task("t", preds)
    return store, store._bucket_for("t", spec)


def _f32(x) -> bytes:
    return np.float32(x).tobytes()


def _same(a: dict, b: dict) -> bool:
    return (a["next_idx"] == b["next_idx"] and a["best"] == b["best"]
            and all(_f32(a[k]) == _f32(b[k])
                    for k in ("next_prob", "pbest_max", "pbest_entropy")))


def _drive(bucket, store, spec, seeds, labels, plan):
    """Admit a session a seed; run ``plan`` (lists of session positions a
    dispatch; the first dispatch of a session is its start). Returns the
    rows of each session and the sessions."""
    sess = [store.open("t", spec, seed=s) for s in seeds]
    rows = [[] for _ in seeds]
    for group in plan:
        reqs = {}
        for i in group:
            if not rows[i]:
                reqs[sess[i].slot] = {"do_update": False}
            else:
                last = rows[i][-1]
                reqs[sess[i].slot] = {
                    "do_update": True, "idx": last["next_idx"],
                    "label": int(labels[last["next_idx"]]),
                    "prob": last["next_prob"]}
        with bucket.lock:
            res = bucket.dispatch(reqs)
        for i in group:
            rows[i].append(res[sess[i].slot])
    return rows, sess


def _twin(selector, seed, rows, labels, out_sel=None):
    """The port's ``InteractiveSelector`` through a slab session's
    requests; its rows (``out_sel``, a list, receives the selector)."""
    from coda_tpu_torch.ops.masked import entropy2

    isel = InteractiveSelector(selector, seed=seed)
    get_pbest = selector.extras.get("get_pbest")
    out = []
    for j in range(len(rows)):
        if j:
            p = rows[j - 1]
            isel.add_label(p["next_idx"], int(labels[p["next_idx"]]),
                           p["next_prob"])
        idx, prob = isel.get_next_item_to_label()
        best = isel.get_best_model_prediction()
        row = {"next_idx": idx, "next_prob": prob, "best": best,
               "pbest_max": None, "pbest_entropy": None}
        if get_pbest is not None:
            pb = get_pbest(isel.state).float()
            row["pbest_max"] = float(pb.max())
            row["pbest_entropy"] = float(entropy2(pb))
        out.append(row)
    if out_sel is not None:
        out_sel.append(isel)
    return out


# -- the port's InteractiveSelector against the reference's -----------------

def _ref_selector(method, preds):
    from coda_tpu.selectors import (CODAHyperparams, make_coda, make_iid,
                                    make_modelpicker)

    p = jnp.asarray(preds)
    if method == "coda":
        return make_coda(p, CODAHyperparams(eig_mode="incremental"))
    if method == "iid":
        return make_iid(p)
    return make_modelpicker(p)


def _port_selector(method, preds):
    from coda_tpu_torch.selectors import make_iid, make_modelpicker

    if method == "coda":
        return tcoda.make_coda(preds, tcoda.CODAHyperparams(
            eig_mode="incremental"), device=DEV)
    if method == "iid":
        return make_iid(preds, device=DEV)
    return make_modelpicker(preds, device=DEV)


@needs_jax
@pytest.mark.parametrize("method", ["coda", "iid", "model_picker"])
def test_reference_interactive_selector(task, method):
    """The port's InteractiveSelector is the reference's: the same key
    choreography, the same trajectory (or a first near-tie flip)."""
    from coda_tpu.selectors.protocol import InteractiveSelector as RefIS

    preds = task.preds.numpy()
    labels = task.labels.numpy()
    ref_sel = _ref_selector(method, preds)
    port_sel = _port_selector(method, task.preds)
    for seed in range(3):
        ref, port = RefIS(ref_sel, seed=seed), InteractiveSelector(
            port_sel, seed=seed)
        assert (np.asarray(ref._key).tolist()
                == port._key.tolist()), "the init split"
        for k in range(8):
            _, sub = jax.random.split(ref._key)
            scores = ref._select(ref.state, sub).scores
            r_idx, r_prob = ref.get_next_item_to_label()
            p_idx, p_prob = port.get_next_item_to_label()
            r_best = ref.get_best_model_prediction()
            p_best = port.get_best_model_prediction()
            if r_idx != p_idx:
                s = np.asarray(scores)
                gap = abs(float(s[r_idx]) - float(s[p_idx]))
                assert gap <= TOL, (method, seed, k, gap)
                break   # a near-tie flip: the trajectories part here
            assert r_best == p_best, (method, seed, k)
            assert abs(r_prob - p_prob) <= TOL, (method, seed, k)
            ref.add_label(r_idx, int(labels[r_idx]), r_prob)
            port.add_label(p_idx, int(labels[p_idx]), p_prob)
        assert np.asarray(ref._key).tolist() == port._key.tolist() or \
            r_idx != p_idx


# -- the slab against the sequential twin, and the lowerings ---------------

@pytest.mark.parametrize("method", ["coda", "iid", "uncertainty",
                                    "model_picker", "activetesting"])
def test_port_slab_map_bitwise_interactive(task, method):
    """Every slab session (map lowering, all slots in one dispatch, then
    staggered dispatches) is bitwise its InteractiveSelector: each row,
    and the state and key it carries at the end."""
    spec = (_spec() if method == "coda"
            else SelectorSpec.create(method))
    store, bucket = _store(task.preds, spec)
    plan = [[0, 1, 2, 3]] * 4 + [[1], [0, 3], [2, 3]]
    rows, sess = _drive(bucket, store, spec, [0, 1, 2, 3],
                        task.labels.numpy(), plan)
    for i, seed in enumerate([0, 1, 2, 3]):
        isel = []
        twin = _twin(bucket.selector, seed, rows[i], task.labels.numpy(),
                     isel)
        # the carried state and key too, leaf for leaf
        assert bucket.slot_digest(sess[i].slot) == state_digest(
            isel[0].state, isel[0]._key), (method, seed)
        for j, (a, b) in enumerate(zip(rows[i], twin)):
            assert a["next_idx"] == b["next_idx"], (method, seed, j)
            assert a["best"] == b["best"], (method, seed, j)
            assert _f32(a["next_prob"]) == _f32(b["next_prob"])
            if a["pbest_max"] is None:
                assert b["pbest_max"] is None
            else:
                assert _f32(a["pbest_max"]) == _f32(b["pbest_max"])
                assert _f32(a["pbest_entropy"]) == _f32(b["pbest_entropy"])


@pytest.mark.parametrize("where", ["synthetic", "digits_h80"])
def test_port_batched_bitwise_map(task, h80, where):
    """The batched lowering is bitwise the map lowering, full and
    partial (runs of one, two and three slots), and a dispatch leaves every
    idle slot's state and key bit for bit as it was."""
    ds = task if where == "synthetic" else h80
    labels = ds.labels.numpy()
    spec = SelectorSpec.create("coda", n_parallel=8, eig_mode="incremental")
    plan = ([list(range(8))] * 3 + [[0, 2, 3, 5, 6, 7]] * 2 + [[4]]
            + [list(range(8))])
    got = {}
    for impl in ("map", "batched"):
        store, bucket = _store(ds.preds, spec, cap=8, impl=impl)
        rows, sess = _drive(bucket, store, spec, list(range(8)), labels,
                            plan[:3])
        idle = [s.slot for s in sess if s.slot in (1, 4)]
        before = {s: bucket.slot_digest(s) for s in idle}
        more, _ = _drive_more(bucket, sess, rows, labels, plan[3:5])
        for s in idle:
            assert bucket.slot_digest(s) == before[s], (impl, s)
        _drive_more(bucket, sess, rows, labels, plan[5:])
        got[impl] = rows
    for i in range(8):
        assert len(got["map"][i]) == len(got["batched"][i])
        for a, b in zip(got["map"][i], got["batched"][i]):
            assert _same(a, b), (where, i)


def _drive_more(bucket, sess, rows, labels, plan):
    for group in plan:
        reqs = {}
        for i in group:
            last = rows[i][-1]
            reqs[sess[i].slot] = {
                "do_update": True, "idx": last["next_idx"],
                "label": int(labels[last["next_idx"]]),
                "prob": last["next_prob"]}
        with bucket.lock:
            res = bucket.dispatch(reqs)
        for i in group:
            rows[i].append(res[sess[i].slot])
    return rows, sess


def test_port_batched_needs_a_batched_form(task):
    """A spec without a batched form (the fused refresh, q > 1) refuses
    the batched lowering; ``vmap`` reads as ``batched``."""
    fused = SelectorSpec.create("coda", n_parallel=1, eig_mode="incremental",
                                eig_refresh="fused")
    with pytest.raises(ValueError, match="batched form"):
        _store(task.preds, fused, impl="vmap")
    _, b = _store(task.preds, fused, impl=None)
    assert b.impl == "map"
    _, b = _store(task.preds, _spec(), impl="vmap")
    assert b.impl == "batched"
    with pytest.raises(ValueError, match="unknown slab-step impl"):
        SessionStore(step_impl="scan", device=DEV)


@needs_jax
def test_reference_slab_matches_reference_bucket(task):
    """The port's slab against the reference's ``Bucket(step_impl="map")``
    on the same task, seeds and label stream."""
    from coda_tpu.serve import SelectorSpec as RefSpec
    from coda_tpu.serve import SessionStore as RefStore

    labels = task.labels.numpy()
    plan = [[0, 1, 2, 3]] * 6 + [[0, 2], [1]]
    spec = _spec()
    store, bucket = _store(task.preds, spec)
    ours, _ = _drive(bucket, store, spec, [0, 1, 2, 3], labels, plan)
    rstore = RefStore(capacity=4, step_impl="map")
    rstore.register_task("t", task.preds.numpy())
    rspec = RefSpec.create("coda", n_parallel=4, eig_mode="incremental")
    rsess = [rstore.open("t", rspec, seed=s) for s in range(4)]
    rbucket = rsess[0].bucket
    theirs = [[] for _ in range(4)]
    for group in plan:
        reqs = {}
        for i in group:
            if not theirs[i]:
                reqs[rsess[i].slot] = {"do_update": False}
            else:
                last = theirs[i][-1]
                reqs[rsess[i].slot] = {
                    "do_update": True, "idx": last["next_idx"],
                    "label": int(labels[last["next_idx"]]),
                    "prob": last["next_prob"]}
        res = rbucket.dispatch(reqs)
        for i in group:
            theirs[i].append(res[rsess[i].slot])
    for i in range(4):
        for j, (a, b) in enumerate(zip(ours[i], theirs[i])):
            if a["next_idx"] != b["next_idx"]:
                break   # a flip; the twin test triages the selector
            assert a["best"] == b["best"], (i, j)
            for k in ("next_prob", "pbest_max", "pbest_entropy"):
                assert abs(a[k] - b[k]) <= TOL, (i, j, k)


# -- slot lifecycle ---------------------------------------------------------

def test_port_slot_reuse_and_backpressure(task):
    """A closed session's slot is the next one admitted (LIFO); a full
    slab refuses with SlabFull; a reused slot starts from the init."""
    spec = _spec()
    store, bucket = _store(task.preds, spec, cap=2)
    a = store.open("t", spec, seed=0)
    b = store.open("t", spec, seed=1)
    with pytest.raises(SlabFull):
        store.open("t", spec, seed=2)
    assert bucket.live == 2
    with bucket.lock:
        first_b = bucket.dispatch({b.slot: {"do_update": False}})[b.slot]
        bucket.dispatch({b.slot: {
            "do_update": True, "idx": first_b["next_idx"], "label": 0,
            "prob": first_b["next_prob"]}})
    store.close(b.sid)
    c = store.open("t", spec, seed=1)
    assert c.slot == b.slot
    with bucket.lock:
        again = bucket.dispatch({c.slot: {"do_update": False}})[c.slot]
    assert _same(again, first_b)       # a fresh session, not b's state
    assert store.live_sessions() == 2 and a.slot != c.slot


def test_port_staged_admission(task):
    """Admission stages its slot write without the dispatch lock; the
    next slab access applies it, and a release drops it."""
    spec = _spec()
    store, bucket = _store(task.preds, spec)
    bucket.warm()
    with bucket.lock:      # an in-flight dispatch holds the lock
        sess = store.open("t", spec, seed=5)
        assert len(bucket._staged) == 1
    assert state_digest(bucket.slot_state(sess.slot)) == state_digest(
        bucket._init_state)
    assert bucket._staged == []
    leaves, key = bucket.snapshot_slot(sess.slot)   # host copies
    # the carries: the state's tensor leaves (a None leaf is not carried)
    init = [x for x in tree_leaves(bucket._init_state)
            if isinstance(x, torch.Tensor)]
    assert len(leaves) == len(init) and key.tolist() == \
        trandom.split(trandom.PRNGKey(5))[0].tolist()
    for a, b in zip(leaves, init):
        assert a.tobytes() == b.numpy().tobytes()
    other = store.open("t", spec, seed=6)
    store.close(other.sid)
    assert bucket._staged == []


def test_port_stale_ticket_never_dispatched(task):
    """A cancelled ticket and a ticket of a closed session are failed at
    collection, never dispatched against a slot."""
    spec = _spec()
    store, bucket = _store(task.preds, spec)
    batcher = Batcher(store)
    sess = store.open("t", spec, seed=0)
    t1 = Ticket(session=sess, do_update=False)
    t1.cancel()
    closed = store.open("t", spec, seed=1)
    t2 = Ticket(session=closed, do_update=False)
    store.close(closed.sid)
    before = bucket.slot_digest(sess.slot)
    batcher._dispatch([t1, t2])
    assert t1.error is not None and t2.error is not None
    assert bucket.slot_digest(sess.slot) == before


def test_port_padded_bucket_never_proposes_phantom(task):
    """A bucket padded to N = 128 proposes only real items, for every
    method."""
    H, N, C = SHAPE
    for spec in (_spec(), SelectorSpec.create("iid"),
                 SelectorSpec.create("model_picker")):
        store = SessionStore(capacity=2, bucket_n=128, device=DEV)
        store.register_task("t", task.preds)
        sess = [store.open("t", spec, seed=s) for s in range(2)]
        bucket = sess[0].bucket
        assert bucket.shape[1] == 128 and bucket.n_valid == N
        rows = [None, None]
        for _ in range(20):
            reqs = {}
            for i, s in enumerate(sess):
                if rows[i] is None:
                    reqs[s.slot] = {"do_update": False}
                else:
                    reqs[s.slot] = {"do_update": True,
                                    "idx": rows[i]["next_idx"],
                                    "label": int(task.labels[
                                        rows[i]["next_idx"]]),
                                    "prob": rows[i]["next_prob"]}
            with bucket.lock:
                res = bucket.dispatch(reqs)
            for i, s in enumerate(sess):
                rows[i] = res[s.slot]
                assert rows[i]["next_idx"] < N, spec.method


def test_port_q2_bucket_labels(task):
    """A q = 2 bucket proposes two items a round and takes both answers
    through one ``labels`` dispatch, bitwise the q-wide selector driven by
    hand with the slab's key choreography."""
    from coda_tpu_torch import random as trandom
    from coda_tpu_torch.selectors.batch import make_batched_selector

    spec = SelectorSpec.create("coda", acq_batch=2, n_parallel=4,
                               eig_mode="incremental")
    app = ServeApp(capacity=2, spec=spec, tiering=False, quality=False,
                   device=DEV)
    app.add_task("t", task.preds)
    app.start(warm=True)
    labels = task.labels.numpy()
    try:
        out = app.open_session(seed=3)
        got = [out]
        for k in range(3):
            out = app.labels(out["session"],
                             [int(labels[i]) for i in out["idx"]],
                             request_id=f"r{k}")
            got.append(out)
        with pytest.raises(ValueError, match="exactly 2 labels"):
            app.labels(out["session"], [0])
        assert out["n_labeled"] == 6
    finally:
        app.drain()
    sel = make_batched_selector(tcoda.make_coda(task.preds, tcoda.
                                CODAHyperparams(eig_mode="incremental",
                                                n_parallel=4), device=DEV), 2)
    key, sub = trandom.split(trandom.PRNGKey(3))
    state = sel.init(sub)
    for k, g in enumerate(got):
        if k:
            prev = got[k - 1]
            state = sel.update(
                state, torch.tensor(prev["idx"]),
                torch.tensor([int(labels[i]) for i in prev["idx"]]),
                torch.tensor(prev["prob"], dtype=torch.float32))
        key, k_sel = trandom.split(key)
        key, _ = trandom.split(key)
        res = sel.select(state, k_sel)
        assert res.idx.tolist() == g["idx"]
        assert [_f32(x) for x in res.prob.tolist()] == [_f32(x)
                                                        for x in g["prob"]]


# -- the session stream -----------------------------------------------------

def _load_checker():
    import importlib.util

    spec = importlib.util.spec_from_file_location(
        "check_record_schema",
        os.path.join(ROOT, "scripts", "check_record_schema.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _stream(app_cls, spec, tmp, task, rounds=5, **kw):
    rec = SessionRecorder(out_dir=str(tmp)) if app_cls is ServeApp else \
        kw.pop("recorder")
    app = app_cls(capacity=2, spec=spec, tiering=False, quality=False,
                  recorder=rec, **kw)
    app.add_task("t", task.preds if app_cls is ServeApp
                 else task.preds.numpy())
    app.start(warm=True)
    labels = task.labels.numpy()
    out = app.open_session(seed=4)
    sid = out["session"]
    for k in range(rounds):
        out = app.label(sid, int(labels[out["idx"]]), request_id=f"r{k}")
    app.close_session(sid)
    app.drain()
    with open(os.path.join(str(tmp), f"session_{sid}.jsonl")) as f:
        return [json.loads(line) for line in f]


@needs_jax
def test_reference_session_stream_schema_and_rows(task, tmp_path):
    """A port session stream passes ``check_session_stream`` and is, row
    for row, the reference's stream for the same session."""
    from coda_tpu.serve import SelectorSpec as RefSpec
    from coda_tpu.serve.server import ServeApp as RefApp
    from coda_tpu.telemetry import SessionRecorder as RefRecorder

    ours = _stream(ServeApp, _spec(), tmp_path / "port", task, device=DEV)
    files = os.listdir(tmp_path / "port")
    assert _load_checker().check_session_stream(
        str(tmp_path / "port" / files[0])) == []
    theirs = _stream(RefApp, RefSpec.create("coda", n_parallel=4,
                                            eig_mode="incremental"),
                     tmp_path / "ref", task,
                     recorder=RefRecorder(out_dir=str(tmp_path / "ref")))
    assert len(ours) == len(theirs)
    meta_o, meta_t = ours[0], theirs[0]
    for k in ("v", "kind", "task", "method", "spec_kwargs", "acq_batch",
              "seed", "shape", "digest"):
        assert meta_o[k] == meta_t[k], k
    for a, b in zip(ours[1:], theirs[1:]):
        assert set(a) - {"trace_id"} == set(b) - {"trace_id"}
        for k in a:
            if k in ("trace_id", "session"):
                continue
            if isinstance(a[k], float) and isinstance(b[k], float):
                assert abs(a[k] - b[k]) <= TOL, k
            else:
                assert a[k] == b[k], (k, a[k], b[k])


def test_port_record_eio_degrades_to_memory(task, tmp_path):
    """``record_eio`` degrades the stream to memory-only: the session keeps
    serving, its history keeps every row, /healthz reports degraded."""
    app = ServeApp(capacity=2, spec=_spec(), tiering=False, quality=False,
                   recorder=SessionRecorder(out_dir=str(tmp_path)),
                   fault_spec="record_eio:after=2", device=DEV)
    app.add_task("t", task.preds)
    app.start(warm=True)
    labels = task.labels.numpy()
    try:
        out = app.open_session(seed=0)
        for k in range(4):
            out = app.label(out["session"], int(labels[out["idx"]]))
        rows = app.trace(out["session"])["rounds"]
        assert len(rows) == 5 and out["n_labeled"] == 4
        assert app.recorder.degraded_streams == 1
        h = app.healthz()
        assert h["status"] == "degraded" and "recorder_degraded" in \
            h["problems"]
    finally:
        app.drain()


# -- faults and the healer ----------------------------------------------------

def _labelled(app, seeds, labels, n, retry=False):
    got = {s: [app.open_session(seed=s)] for s in seeds}
    faults = 0
    for k in range(n):
        for s in seeds:
            for _ in range(100):
                try:
                    r = app.label(got[s][0]["session"],
                                  int(labels[got[s][-1]["idx"]]),
                                  request_id=f"{s}-{k}")
                    break
                except Exception as e:
                    if not retry:
                        raise
                    faults += type(e).__name__ == "FaultInjected"
                    import time
                    time.sleep(0.02)
            got[s].append(r)
    return got, faults


def test_port_step_raise_heals_bitwise(task):
    """``step_raise`` quarantines the bucket; the healer rebuilds the slab
    from the recorder streams with every digest verified, and the sessions
    finish bitwise the unfaulted run."""
    labels = task.labels.numpy()
    runs = {}
    for spec_str in (None, "step_raise:after=4"):
        app = ServeApp(capacity=3, spec=_spec(), tiering=False,
                       quality=False, fault_spec=spec_str, device=DEV)
        app.add_task("t", task.preds)
        app.start(warm=True)
        try:
            runs[spec_str], faults = _labelled(app, [0, 1, 2], labels, 4,
                                               retry=True)
            bucket = app.store.buckets()[0]
            if spec_str:
                assert faults == 1 and bucket.heals == 1
                assert app.healer.last_report["sessions"] == 3
                assert app.healthz()["status"] == "ok"
        finally:
            app.drain()
    for s in range(3):
        for a, b in zip(runs[None][s], runs["step_raise:after=4"][s]):
            assert a["idx"] == b["idx"] and a["best"] == b["best"]
            assert _f32(a["prob"]) == _f32(b["prob"])


def test_port_step_nan_caught_by_digest(task):
    """``step_nan`` poisons a served row; the healer's replay then finds the
    recorded digest does not verify, and the bucket goes terminal."""
    labels = task.labels.numpy()
    app = ServeApp(capacity=2, spec=_spec(), tiering=False, quality=False,
                   fault_spec="step_nan:after=2", device=DEV)
    app.add_task("t", task.preds)
    app.start(warm=True)
    try:
        got, _ = _labelled(app, [0], labels, 3)
        rows = app.trace(got[0][0]["session"])["rounds"]
        assert any(np.isnan(r["pbest_max"]) for r in rows)
        bucket = app.store.buckets()[0]
        with pytest.raises(ReplayMismatch, match="bitwise"):
            heal_bucket(bucket, app.store, app.recorder)
        healer = BucketHealer(app.store, app.recorder)
        bucket.quarantined = "test"
        healer.schedule(bucket, sync=True)
        assert bucket.failed is not None and "digest" in bucket.failed
    finally:
        app.drain()


def test_port_fault_grammar_is_the_reference(tmp_path):
    """Every reference spec parses the same; only the sites of slice 8a
    fire here, every other one is refused naming its slice."""
    specs = ["step_raise:after=5;slow_step:every=3,ms=20",
             "step_nan:p=0.5,seed=3,task=t", "record_eio:times=2,after=1",
             "net_drop:edge=r1,times=3", "crash_before_tick:after=9",
             "oracle_poison:every=2", "kill_replica"]
    for s in specs:
        ours = [vars(f) for f in parse_fault_spec(s)]
        if jax is not None:
            from coda_tpu.serve.faults import parse_fault_spec as ref_parse

            assert ours == [vars(f) for f in ref_parse(s)], s
    FaultInjector("step_raise:after=1;step_nan;record_eio;slow_step:ms=1")
    for name, where in PENDING_SITES.items():
        with pytest.raises(NotImplementedError, match=where.split()[0]):
            FaultInjector(f"{name}:after=1")
    with pytest.raises(ValueError, match="unknown fault"):
        parse_fault_spec("disk_fire")


@needs_jax
def test_reference_metrics_and_trace_context():
    """ServeMetrics' snapshot keys and the serve Prometheus families are the
    reference's for the same events; the trace context parses alike."""
    from coda_tpu.serve.metrics import ServeMetrics as RefMetrics
    from coda_tpu.telemetry import trace as rtrace
    from coda_tpu.telemetry.prometheus import _render_serve as ref_render

    from coda_tpu_torch.serve import ServeMetrics
    from coda_tpu_torch.telemetry import trace as ttrace
    from coda_tpu_torch.telemetry.prometheus import _render_serve

    ms = [ServeMetrics(), RefMetrics()]
    for m in ms:
        m.record_dispatch(3, 1, 0.01, step_seconds=0.005, warm=True)
        m.record_request_latency(0.02, trace_id="ab" * 16)
        m.record_queue_wait(0.001)
        m.record_session("open")
        m.record_warm_pool(3, 0.5)
    a, b = ms[0].snapshot(), ms[1].snapshot()
    assert set(a) == set(b)
    snap = dict(b, uptime_s=1.0)
    out_a, out_b = [], []
    _render_serve(out_a, snap, "coda")
    ref_render(out_b, {k: v for k, v in snap.items() if k != "quality"},
               "coda")
    assert out_a == out_b
    hdr = "0123456789abcdef0123456789abcdef-0123456789abcdef"
    assert tuple(ttrace.parse(hdr)) == tuple(rtrace.parse(hdr))
