"""Export/import, crash restore and ``replay-serve`` of the port
(``coda_tpu_torch/serve/recovery.py``) on the CPU.

Inputs are the seeded ``make_synthetic_task(0, 4, 48, 4)`` (the same arrays
in both packages), as the reference's ``tests/test_recovery.py`` builds
its own. Tolerances:

  * within the port: bitwise. An imported session (snapshot path or replay
    fallback) keeps its slot digest (every state leaf and the key) and
    continues with rows bitwise those of a session that was never
    exported; a crash-restored session answers ``/best`` bitwise its
    uninterrupted twin; a one-ulp tamper of a stream fails its replay;
  * against the reference's ``ServeApp`` on the same session and the same
    operations: the integers equal and the floats within the cross-backend
    contract 2.34e-4, or a first divergence that is a tie-break flip (the
    reference's own two picks' selection scores within 2.34e-4).
"""

from __future__ import annotations

import json
import os
import signal
import subprocess
import sys
import threading
import urllib.error
import urllib.request

import numpy as np
import pytest

try:
    import jax  # noqa: F401
except ImportError:  # a card machine without JAX
    jax = None

from coda_tpu_torch.data import make_synthetic_task
from coda_tpu_torch.serve import (
    SESSION_EXPORT_VERSION,
    ImportRejected,
    SelectorSpec,
    ServeApp,
)
from coda_tpu_torch.telemetry import SessionRecorder
from coda_tpu_torch.telemetry.recorder import CROSS_BACKEND_SCORE_TOL as TOL

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
DEV = "cpu"
H, N, C = 4, 48, 4
ROW_KEYS = ("next_idx", "next_prob", "best", "pbest_max", "pbest_entropy")

needs_jax = pytest.mark.skipif(jax is None, reason="needs the JAX reference")


@pytest.fixture(scope="module")
def task():
    return make_synthetic_task(0, H=H, N=N, C=C, device=DEV)


def _spec():
    return SelectorSpec.create("coda", n_parallel=4, eig_mode="incremental")


def _app(task, capacity=4, **kw):
    kw.setdefault("quality", False)
    app = ServeApp(capacity=capacity, max_wait=0.001, spec=_spec(),
                   device=DEV, **kw)
    app.add_task("t", task.preds)
    app.start(warm=True)
    return app


def _label(app, sid, out, labels, rid=None):
    return app.label(sid, int(labels[out["idx"]]), request_id=rid)


def _drive(app, seed, rounds, labels):
    out = app.open_session(seed=seed)
    sid = out["session"]
    for k in range(rounds):
        out = _label(app, sid, out, labels, rid=f"{seed}-{k}")
    return sid, out


def _row(app, sid):
    return {k: app.store.get(sid).last[k] for k in ROW_KEYS}


def _bits(a: dict, b: dict) -> bool:
    return all(np.float32(a[k]).tobytes() == np.float32(b[k]).tobytes()
               if isinstance(a[k], float) else a[k] == b[k]
               for k in ROW_KEYS)


def _digest(app, sid):
    s = app.store.get(sid)
    return s.bucket.slot_digest(s.slot)


def test_port_export_import_bitwise_snapshot_and_replay(task):
    """Export -> JSON -> close -> import goes through the snapshot path
    with the slot digest bitwise; the same payload without carries goes
    through the replay path, bitwise too; and the imported session
    continues bitwise the session that was never exported. The payload
    has the reference's keys and version."""
    labels = task.labels.numpy()
    app, ctl = _app(task), _app(task)
    try:
        sid, out = _drive(app, 5, 3, labels)
        csid, cout = _drive(ctl, 5, 3, labels)
        d0 = _digest(app, sid)
        payload = json.loads(json.dumps(app.export_session(sid)))
        assert payload["v"] == SESSION_EXPORT_VERSION == 1
        assert payload["fingerprint"]["backend"] == "torch-cpu"
        assert {"v", "kind", "session", "task", "method", "spec_kwargs",
                "acq_batch", "seed", "epoch", "dataset", "fingerprint",
                "carries", "key", "rows", "n_labeled", "last"} \
            == set(payload)
        app.close_session(sid)
        info = app.import_session(payload)
        assert info["restored_via"] == "snapshot" and info["session"] == sid
        assert info["n_labeled"] == 3 and _digest(app, sid) == d0
        assert app.label(sid, 0, request_id="5-2")["n_labeled"] == 3  # dedupe
        app.close_session(sid)
        info = app.import_session(dict(payload, carries=None, key=None))
        assert info["restored_via"] == "replay" and _digest(app, sid) == d0
        for k in range(3):
            out = _label(app, sid, out, labels)
            cout = _label(ctl, csid, cout, labels)
            assert _bits(_row(app, sid), _row(ctl, csid)), k
    finally:
        app.drain()
        ctl.drain()


def test_port_import_rejects_tamper_and_mismatch(task):
    """A one-ulp stream tamper fails the replay (ImportRejected, nothing
    admitted); an unknown task, another selector config and an invalid
    session id are refused with their reason."""
    from coda_tpu_torch.telemetry.quality import tamper_rows_ulp

    labels = task.labels.numpy()
    app = _app(task)
    try:
        sid, _ = _drive(app, 1, 3, labels)
        payload = app.export_session(sid, close=True)
        bad = dict(payload, carries=None, rows=tamper_rows_ulp(
            payload["rows"], 2))
        with pytest.raises(ImportRejected, match="replay verification"):
            app.import_session(bad)
        assert not app.store.alive(sid)
        for change, why in ((dict(task="x"), "not registered"),
                            (dict(method="iid"), "config mismatch"),
                            (dict(session="XYZ"), "invalid session id"),
                            (dict(v=7), "v=7")):
            with pytest.raises(ImportRejected, match=why):
                app.import_session(dict(payload, **change))
        assert app.import_session(payload)["restored_via"] == "snapshot"
    finally:
        app.drain()


def test_port_crash_restore_in_process_waves(task, tmp_path):
    """A first app is abandoned without closing its streams; a second app
    on the same record directory restores every session — three of them
    into a two-slot slab, in waves paged to the warm tier — each bitwise
    its pre-"crash" answer and slot digest."""
    labels = task.labels.numpy()
    rec = str(tmp_path / "rec")
    app = _app(task, recorder=SessionRecorder(out_dir=rec), capacity=4)
    before = {}
    for seed in range(3):
        sid, _ = _drive(app, seed, 2 + seed, labels)
        before[sid] = (app.best(sid), _digest(app, sid))
    app.quiesce()           # the "crash": no close marker is written
    app2 = _app(task, recorder=SessionRecorder(out_dir=rec), capacity=2)
    try:
        report = app2.restore_sessions()
        assert sorted(report["restored"]) == sorted(before)
        assert report["failed"] == {} and report["skipped_closed"] == 0
        assert app2.tiers.counts() == {"hot": 1, "warm": 2, "cold": 0}
        for sid, (best, dig) in before.items():
            got = app2.best(sid)          # wakes the warm one
            assert got == best
            assert _digest(app2, sid) == dig
    finally:
        app2.drain()


def _http(port, method, path, body=None):
    data = None if body is None else json.dumps(body).encode()
    req = urllib.request.Request(f"http://127.0.0.1:{port}{path}",
                                 data=data, method=method)
    try:
        with urllib.request.urlopen(req, timeout=60) as resp:
            return resp.status, json.loads(resp.read().decode())
    except urllib.error.HTTPError as e:
        return e.code, json.loads(e.read().decode())


def _serve(argv):
    proc = subprocess.Popen(
        [sys.executable, "-m", "coda_tpu_torch.cli", "serve", *argv],
        cwd=ROOT, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
        text=True)
    port = None
    for line in proc.stdout:
        if "http://127.0.0.1:" in line:
            port = int(line.split("http://127.0.0.1:")[1].split("/")[0])
            break
    assert port is not None, "no serving line"
    for _ in range(600):
        if _http(port, "GET", "/healthz")[0] == 200:
            break
        threading.Event().wait(0.05)
    return proc, port


def test_port_cli_crash_after_tick_restores_bitwise(task, tmp_path):
    """``cli serve --device cpu`` with its defaults (tiering and quality
    on) under ``crash_after_tick``: the process exits 17 right after the
    fifth tick commits; a restart with ``--restore`` answers ``/best``
    bitwise an uninterrupted in-process session with the same labels, and
    ``replay-serve`` verifies the streams (exit 0) and refuses a copy
    tampered by one ulp (exit 2)."""
    from coda_tpu_torch import cli
    from coda_tpu_torch.telemetry.quality import tamper_rows_ulp

    labels = task.labels.numpy()
    rec = tmp_path / "rec"
    base = ["--synthetic", f"{H},{N},{C}", "--capacity", "4", "--device",
            "cpu", "--port", "0", "--record-dir", str(rec), "--max-wait-ms",
            "0.5"]
    proc, port = _serve(base + ["--fault-spec", "crash_after_tick:after=4"])
    try:
        code, out = _http(port, "POST", "/session", {"seed": 3})
        sid, sent = out["session"], []
        for _ in range(3):
            sent.append(int(labels[out["idx"]]))
            code, out = _http(port, "POST", f"/session/{sid}/label",
                              {"label": sent[-1]})
            assert code == 200
        sent.append(int(labels[out["idx"]]))
        try:   # the fifth tick commits, then kills the process (its
            #        answer may or may not leave before the exit)
            _http(port, "POST", f"/session/{sid}/label",
                  {"label": sent[-1]})
        except (urllib.error.URLError, ConnectionError):
            pass
        proc.wait(timeout=60)
    finally:
        if proc.poll() is None:
            proc.kill()
        proc.communicate()
    assert proc.returncode == 17
    proc, port = _serve(base + ["--restore"])
    try:
        code, best = _http(port, "GET", f"/session/{sid}/best")
        assert code == 200 and best["n_labeled"] == 4
    finally:
        proc.send_signal(signal.SIGTERM)
        proc.communicate(timeout=120)
    ctl = _app(task)
    try:
        out = ctl.open_session(seed=3)
        for lab in sent:
            out = ctl.label(out["session"], lab)
        want = ctl.best(out["session"])
    finally:
        ctl.drain()
    assert best["pbest"] == want["pbest"]
    assert {k: best[k] for k in ("idx", "prob", "best")} == \
        {k: want[k] for k in ("idx", "prob", "best")}
    argv = ["replay-serve", str(rec), "--synthetic", f"{H},{N},{C}",
            "--device", "cpu"]
    assert cli.main(argv) == 0
    path = rec / f"session_{sid}.jsonl"
    rows = [json.loads(line) for line in path.read_text().splitlines()]
    data = [i for i, r in enumerate(rows) if not r.get("kind")]
    bad = tamper_rows_ulp([rows[i] for i in data], 2)
    for i, r in zip(data, bad):
        rows[i] = r
    tam = tmp_path / "tampered"
    tam.mkdir()
    (tam / path.name).write_text("".join(json.dumps(r) + "\n"
                                         for r in rows))
    argv[1] = str(tam)
    assert cli.main(argv) == 2


def _hold_rows(ours: list, theirs: list, ref_scores=None) -> None:
    """The port's rows against the reference's: integers equal and floats
    within 2.34e-4 up to the first divergence, which must be a tie-break
    flip (the reference's own scores of the two picks within 2.34e-4)."""
    assert len(ours) == len(theirs)
    for k, (a, b) in enumerate(zip(ours, theirs)):
        if a["next_idx"] != b["next_idx"]:
            assert ref_scores is not None, f"round {k}: picks differ"
            s = ref_scores(k)
            gap = abs(float(s[a["next_idx"]]) - float(s[b["next_idx"]]))
            assert gap <= TOL, f"round {k}: not a near tie ({gap})"
            return
        assert a["best"] == b["best"], k
        for q in ("next_prob", "pbest_max", "pbest_entropy"):
            assert abs(a[q] - b[q]) <= TOL, (k, q, a[q], b[q])


def _ref_app(task, capacity=4, **kw):
    from coda_tpu.serve import SelectorSpec as RefSpec
    from coda_tpu.serve.server import ServeApp as RefApp

    app = RefApp(capacity=capacity, max_wait=0.001, quality=False,
                 spec=RefSpec.create("coda", n_parallel=capacity,
                                     eig_mode="incremental"), **kw)
    app.add_task("t", task.preds.numpy())
    app.start(warm=True)
    return app


def _trajectory(app, labels, how, tmp):
    """One session of seed 2: 3 labels, then ``how`` (an export, close and
    import; or an abandoned app restored by a second one), then 3 more
    labels. Returns its rows and the serving app."""
    out = app.open_session(seed=2)
    sid, rows = out["session"], []
    for _ in range(3):
        out = app.label(sid, int(labels[out["idx"]]))
        rows.append(dict(app.store.get(sid).last))
    if how == "export":
        payload = app.export_session(sid, close=True)
        assert app.import_session(payload)["restored_via"] == "snapshot"
    else:
        app.quiesce()
        app = how(tmp)
        assert app.restore_sessions()["restored"] == [sid]
    out = app._payload(app.store.get(sid), app.store.get(sid).last)
    for _ in range(3):
        out = app.label(sid, int(labels[out["idx"]]))
        rows.append(dict(app.store.get(sid).last))
    return rows, app


@needs_jax
@pytest.mark.parametrize("how", ["export", "restore"])
def test_reference_restored_trajectory_matches_the_reference(task, tmp_path,
                                                             how):
    """Export/import and crash restore of the same session in the port and
    in the reference: the trajectories agree within the cross-backend
    contract (or first diverge as a tie-break flip)."""
    from coda_tpu.telemetry import SessionRecorder as RefRecorder

    labels = task.labels.numpy()
    apps = []
    try:
        if how == "export":
            ours, a = _trajectory(_app(task), labels, "export", None)
            apps.append(a)
            theirs, b = _trajectory(_ref_app(task), labels, "export", None)
            apps.append(b)
        else:
            pr, rr = str(tmp_path / "p"), str(tmp_path / "r")
            ours, a = _trajectory(
                _app(task, recorder=SessionRecorder(out_dir=pr)), labels,
                lambda _: _app(task, recorder=SessionRecorder(out_dir=pr)),
                None)
            apps.append(a)
            theirs, b = _trajectory(
                _ref_app(task, recorder=RefRecorder(out_dir=rr)), labels,
                lambda _: _ref_app(task, recorder=RefRecorder(out_dir=rr)),
                None)
            apps.append(b)
        _hold_rows(ours, theirs)
    finally:
        for x in apps:
            x.drain()
