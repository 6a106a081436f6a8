"""The port's HTTP front door and ``cli serve`` (``coda_tpu_torch/serve/
server.py``) on the CPU.

Each test runs its own server on an ephemeral port and waits on its
answers only (no wall-clock bound beyond the request timeout). Held: the
reference's JSON shapes and status codes; ``request_id`` dedupe;
admission 503 and draining; the ``/healthz`` warm gate; ``/metrics``
clean under the port's ``prometheus.lint``; ``parse_args([])``'s defaults
equal to the reference's (``--platform`` is the port's ``--device``);
the fleet's verbs of one server (the migration hold, the fence, the
epoch probe) over HTTP, the N axis (slice 5) refused naming its slice;
export/import over HTTP; the crowd's ``answer`` verb committing, in any
order, the rows of the in-order ``labels`` verb bitwise; and the answers
over HTTP equal to the in-process slab's on the same seed, bitwise.
"""

from __future__ import annotations

import contextlib
import io
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
import torch

from coda_tpu_torch.data import make_synthetic_task
from coda_tpu_torch.serve import SelectorSpec, ServeApp, make_server
from coda_tpu_torch.serve import server as tserver
from coda_tpu_torch.telemetry import lint_prometheus

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
DEV = "cpu"


@pytest.fixture(scope="module")
def task():
    return make_synthetic_task(0, H=6, N=96, C=4, device=DEV)


def _spec():
    return SelectorSpec.create("coda", n_parallel=4, eig_mode="incremental")


class _Server:
    """A ServeApp behind its own AsyncHTTPServer on an ephemeral port."""

    def __init__(self, task, capacity=4, warm=True, acq_batch=1, **kw):
        kw.setdefault("spec", _spec())
        if acq_batch > 1:
            sp = kw["spec"]
            kw["spec"] = SelectorSpec.create(sp.method, acq_batch=acq_batch,
                                             **dict(sp.kwargs))
        kw.setdefault("tiering", False)
        kw.setdefault("quality", False)
        self.app = ServeApp(capacity=capacity, device=DEV, **kw)
        self.app.add_task("t", task.preds)
        self.srv = make_server(self.app, 0)
        self.port = self.srv.server_address[1]
        self.thread = threading.Thread(target=self.srv.serve_forever,
                                       daemon=True)
        self.thread.start()
        self.srv._started.wait(30)
        if warm:
            self.app.start(warm=True)

    def __call__(self, method, path, body=None):
        data = None if body is None else json.dumps(body).encode()
        req = urllib.request.Request(f"http://127.0.0.1:{self.port}{path}",
                                     data=data, method=method)
        try:
            with urllib.request.urlopen(req, timeout=60) as resp:
                text = resp.read().decode()
                return resp.status, (text if path == "/metrics"
                                     else json.loads(text))
        except urllib.error.HTTPError as e:
            return e.code, json.loads(e.read().decode())

    def close(self):
        self.srv.shutdown()
        self.app.drain()
        self.srv.server_close()


@pytest.fixture
def server(task):
    s = _Server(task)
    yield s
    s.close()


def test_port_http_end_to_end_matches_slab(task, server):
    """open -> labels -> best -> trace -> close over HTTP: the reference's
    JSON shapes, and every answer bitwise the in-process slab's on the
    same seed; a retried request_id is answered without re-applying."""
    from coda_tpu_torch.serve import SessionStore

    labels = task.labels.numpy()
    code, out = server("POST", "/session", {"seed": 7})
    assert code == 200
    assert set(out) == {"session", "task", "n_labeled", "idx", "prob",
                        "best", "stochastic"}
    sid, got = out["session"], [out]
    for k in range(4):
        code, out = server("POST", f"/session/{sid}/label",
                           {"label": int(labels[out["idx"]]),
                            "idx": out["idx"], "request_id": f"r{k}"})
        assert code == 200 and out["n_labeled"] == k + 1
        got.append(out)
    code, dup = server("POST", f"/session/{sid}/label",
                       {"label": 0, "request_id": "r3"})
    assert code == 200 and dup == got[-1]
    code, stale = server("POST", f"/session/{sid}/label",
                         {"label": 0, "idx": got[-1]["idx"] + 1})
    assert code == 409
    code, best = server("GET", f"/session/{sid}/best")
    assert code == 200 and len(best["pbest"]) == 6
    assert best["n_labeled"] == 4
    code, trace = server("GET", f"/session/{sid}/trace")
    assert code == 200 and len(trace["rounds"]) == 5
    assert set(trace) == {"session", "task", "n_labeled", "rounds"}
    assert server("DELETE", f"/session/{sid}") == (200, {"closed": sid})
    assert server("GET", f"/session/{sid}/best")[0] == 404
    assert server("POST", f"/session/{sid}/label", {"label": 0})[0] == 404

    store = SessionStore(capacity=1, step_impl="map", device=DEV)
    store.register_task("t", task.preds)
    sess = store.open("t", _spec(), seed=7)
    bucket = sess.bucket
    res = bucket.dispatch({sess.slot: {"do_update": False}})[sess.slot]
    for j, g in enumerate(got):
        if j:
            res = bucket.dispatch({sess.slot: {
                "do_update": True, "idx": res["next_idx"],
                "label": int(labels[res["next_idx"]]),
                "prob": res["next_prob"]}})[sess.slot]
        assert g["idx"] == res["next_idx"] and g["best"] == res["best"]
        assert (np.float32(g["prob"]).tobytes()
                == np.float32(res["next_prob"]).tobytes())
        tr = trace["rounds"][j]
        assert (np.float32(tr["pbest_max"]).tobytes()
                == np.float32(res["pbest_max"]).tobytes())


def test_port_http_admission_and_draining(task):
    """A full slab answers 503 busy; a draining server 503 draining; bad
    bodies 400; unknown routes 404; the 17th (here 3rd) open refused."""
    s = _Server(task, capacity=2)
    try:
        sids = [s("POST", "/session", {"seed": i})[1]["session"]
                for i in range(2)]
        code, err = s("POST", "/session", {"seed": 9})
        assert code == 503 and "busy" in err["error"]
        assert s("POST", f"/session/{sids[0]}/label", {})[0] == 400
        assert s("POST", f"/session/{sids[0]}/label",
                 {"label": 99})[0] == 400
        assert s("GET", "/nowhere")[0] == 404
        assert s("GET", "/sessions")[1]["sessions"] == sids
        stats = s("GET", "/stats")[1]
        assert stats["open_sessions"] == 2 and stats["sessions_rejected"] \
            == 1
        assert stats["buckets"][0]["step_impl"] == "batched"
        s.app.quiesce()
        code, err = s("POST", "/session", {"seed": 3})
        assert code == 503 and "draining" in err["error"]
        assert s("GET", "/healthz")[0] == 200   # live while draining
    finally:
        s.close()


def test_port_http_healthz_gate_and_metrics(task):
    """/healthz answers 503 until the warm pool is ready, then 200;
    /metrics is clean under lint and carries the serve families."""
    s = _Server(task, warm=False)
    try:
        code, h = s("GET", "/healthz")
        assert code == 503 and h["status"] == "unready"
        s.app.start(warm=True)
        code, h = s("GET", "/healthz")
        assert code == 200 and h["status"] == "ok"
        sid = s("POST", "/session", {"seed": 0})[1]["session"]
        s("POST", f"/session/{sid}/label", {"label": 1})
        code, text = s("GET", "/metrics")
        assert code == 200 and lint_prometheus(text) == []
        for fam in ("coda_serve_dispatches_total",
                    "coda_serve_request_latency_seconds",
                    "coda_serve_warm_pool_size",
                    "coda_serve_record_rows_total"):
            assert f"# TYPE {fam} " in text, fam
    finally:
        s.close()


def test_port_parse_args_defaults_are_the_reference():
    """Every flag of the reference's ``serve`` parses to its default here,
    ``--platform`` (a JAX platform) becoming ``--device`` (cuda); the
    port's one added flag, ``--eig-mode``, defaults to the reference's
    rule (``auto``)."""
    ours = vars(tserver.parse_args([]))
    assert ours.pop("device") == "cuda"
    assert ours.pop("eig_mode") == "auto"
    try:
        from coda_tpu.serve.server import parse_args as ref_parse
    except ImportError:
        pytest.skip("needs the JAX reference")
    theirs = vars(ref_parse([]))
    assert theirs.pop("platform") is None
    assert ours == theirs
    assert tserver.parse_args(["--step-impl", "vmap"]).step_impl == "vmap"


def test_port_cli_serve_eig_mode_flag():
    """``--eig-mode`` pins the EIG tier of every session's bucket; ``auto``
    leaves the spec to the reference's rule, and an unknown tier is
    refused at parse time."""
    def spec_kwargs(argv):
        app = tserver.build_app(tserver.parse_args(
            ["--synthetic", "4,32,3", "--capacity", "2", "--no-tiering",
             "--no-quality", "--device", "cpu", *argv]))
        return dict(app.spec.kwargs)

    assert spec_kwargs(["--eig-mode", "incremental"])["eig_mode"] == \
        "incremental"
    assert "eig_mode" not in spec_kwargs([])
    with pytest.raises(SystemExit):
        tserver.parse_args(["--eig-mode", "cached"])


def test_port_refusals_name_their_slice(task):
    """The mesh's model axis runs (slice 5 ported both axes): without its
    ranks it raises the reference's "needs" error, and ``--acq-batch 2``
    and ``--eig-scorer surrogate:8`` run on a one-rank model axis (slice
    5d). Tiering,
    the quality plane, export/import, restore, the answer verb, the prior
    pool, ``replay-serve``, ``quality``, ``trace``, ``render_fleet`` and
    the server's half of a migration run: ``export`` with ``hold`` holds
    the session (its verbs answer a retryable 503), ``fence`` without
    ``drop`` lifts the hold, with ``drop`` closes the copy."""
    from coda_tpu_torch import cli
    from coda_tpu_torch.telemetry.prometheus import lint, render_fleet

    for kw in ({}, {"quality": False}, {"tiering": False}):
        app = ServeApp(device=DEV, **kw)
        assert (app.tiers is None) == ("tiering" in kw)
        assert (app.quality is None) == ("quality" in kw)
        app.drain()
    ServeApp(device=DEV, spec=SelectorSpec.create(
        "coda", eig_scorer="surrogate:8", surrogate_prior="pool")).drain()
    assert lint(render_fleet({})) == []
    with pytest.raises(SystemExit) as e:
        cli.main(["trace", "--help"])
    assert e.value.code == 0
    argv = ["--synthetic", "4,32,3", "--device", "cpu", "--method", "coda",
            "--iters", "2", "--no-mlflow", "--mesh"]
    with pytest.raises(ValueError, match="mesh 1x2 needs 2 ranks"):
        cli.main(argv + ["model=2"])
    with contextlib.redirect_stdout(io.StringIO()):    # run since 5d
        assert cli.main(argv + ["model=1", "--eig-scorer",
                                "surrogate:8"]) == 0
        assert cli.main(argv + ["model=1", "--acq-batch", "2"]) == 0
    with pytest.raises(SystemExit) as e:
        cli.main(["replay-serve", "--help"])
    assert e.value.code == 0
    s = _Server(task)
    try:
        app = s.app
        sid = s("POST", "/session", {"seed": 0})[1]["session"]
        code, payload = s("POST", f"/session/{sid}/export", {"hold": True})
        assert code == 200 and payload["session"] == sid and app.held(sid)
        code, err = s("GET", f"/session/{sid}/best")
        assert code == 503 and "migrating" in err["error"]
        assert s("POST", f"/session/{sid}/fence", {}) == (
            200, {"session": sid, "held": True, "dropped": False})
        assert s("GET", f"/session/{sid}/epoch") == (
            200, {"session": sid, "epoch": 0})
        assert s("GET", f"/session/{sid}/best")[0] == 200
        assert app.begin_migration(sid, raw=True)["session"] == sid
        assert s("POST", f"/session/{sid}/fence", {"drop": True}) == (
            200, {"session": sid, "held": True, "dropped": True})
        assert s("GET", f"/session/{sid}/best")[0] == 404
        assert s("GET", "/sessions") == (200, {"sessions": []})
        assert s("POST", "/prior/sync", {}) == (200, {"delta": {}})
    finally:
        s.close()


def test_port_http_export_import_round_trip(task):
    """``POST /session/{id}/export`` with ``close`` then ``POST
    /session/import`` on a second server: the session keeps its id, its
    answers and its next item; a wrong payload answers 409."""
    a, b = _Server(task), _Server(task)
    try:
        out = a("POST", "/session", {"seed": 2})[1]
        sid = out["session"]
        labels = task.labels.numpy()
        for _ in range(3):
            out = a("POST", f"/session/{sid}/label",
                    {"label": int(labels[out["idx"]])})[1]
        code, payload = a("POST", f"/session/{sid}/export", {"close": True})
        assert code == 200 and payload["kind"] == "session_export"
        assert a("GET", f"/session/{sid}/best")[0] == 404
        code, got = b("POST", "/session/import", payload)
        assert code == 200 and got["restored_via"] == "snapshot"
        assert {k: got[k] for k in ("session", "n_labeled", "idx", "best")} \
            == {k: out[k] for k in ("session", "n_labeled", "idx", "best")}
        code, err = b("POST", "/session/import", dict(payload, task="nope"))
        assert code == 409 and "import rejected" in err["error"]
    finally:
        a.close()
        b.close()


def _small_pieces(monkeypatch):
    """The HTTP edge's codec at a few bytes a piece, so a small payload
    takes every path a headline one does."""
    from coda_tpu_torch.serve import recovery

    monkeypatch.setattr(recovery, "_BLOB_MIN", 64)
    monkeypatch.setattr(recovery, "_PIECE", 3 * 7)
    monkeypatch.setattr(recovery, "_SCAN", 50)
    monkeypatch.setattr(tserver, "_READ_PIECE", 1000)


@pytest.mark.parametrize("form", ["raw", "base64", "bytes"])
def test_port_payload_json_codec_in_pieces(form, monkeypatch):
    """``payload_to_json`` writes the bytes of ``json.dumps(materialize(
    payload)).encode()`` exactly, and ``payload_from_json`` reads them back
    to the same arrays and the same other fields (long strings with and
    without escapes, unicode, nested rows), for a payload whose arrays are
    host arrays, base64 text or raw bytes."""
    from coda_tpu_torch.serve.recovery import (_pack, _unpack,
                                               payload_from_json,
                                               payload_to_json)
    from coda_tpu_torch.serve.spill import materialize

    _small_pieces(monkeypatch)
    rng = np.random.default_rng(0)
    arrays = [rng.standard_normal((3, 5, 7)).astype(np.float32),
              rng.integers(0, 9, (40,)).astype(np.int64),
              np.zeros((0,), np.float32),
              rng.standard_normal((2,)).astype(np.float32)]

    def packed(a):
        d = _pack(a, raw=form != "base64")
        if form == "bytes":
            d["data"] = a.tobytes()
        return d

    payload = {"v": 1, "kind": "session_export",
               "carries": [packed(a) for a in arrays[:3]],
               "key": packed(arrays[3]),
               "note": "x" * 200, "quoted": 'a"b\\c\u00e9' * 30,
               "rows": [{"n_labeled": i, "name": "é✓" * 40,
                         "tags": ["y" * 90, {"z": "w" * 70}]}
                        for i in range(5)]}
    body = bytes(payload_to_json(payload))
    assert body == json.dumps(materialize(payload)).encode()
    got = payload_from_json(body)
    want = json.loads(body)
    for k in ("carries", "key"):
        for g, w in zip(got[k] if k == "carries" else [got[k]],
                        want[k] if k == "carries" else [want[k]]):
            assert {x: g[x] for x in ("dtype", "shape")} == \
                {x: w[x] for x in ("dtype", "shape")}
            assert _unpack(g).tobytes() == _unpack(w).tobytes()
    assert {k: v for k, v in got.items() if k not in ("carries", "key")} \
        == {k: v for k, v in want.items() if k not in ("carries", "key")}
    # a non-canonical base64 text decodes as the reference's b64decode
    for gap in (b" ", b"    "):
        odd = body.replace(b'"data": "', b'"data": "' + gap, 1)
        assert _unpack(payload_from_json(odd)["carries"][0]).tobytes() \
            == arrays[0].tobytes()


def test_port_http_export_import_in_pieces(task, monkeypatch):
    """The export and import routes with the codec at a few bytes a piece
    (the body read in pieces too): the session comes back through the
    snapshot, and an import body past ``import_body_cap`` (1 MiB plus the
    base64 of one slot's carries) is refused 400 before it is read."""
    import http.client

    _small_pieces(monkeypatch)
    a, b = _Server(task), _Server(task)
    try:
        out = a("POST", "/session", {"seed": 3})[1]
        sid = out["session"]
        for _ in range(2):
            out = a("POST", f"/session/{sid}/label",
                    {"label": int(task.labels.numpy()[out["idx"]])})[1]
        code, payload = a("POST", f"/session/{sid}/export", {"close": True})
        assert code == 200
        code, got = b("POST", "/session/import", payload)
        assert code == 200 and got["restored_via"] == "snapshot"
        assert (got["idx"], got["best"]) == (out["idx"], out["best"])
        bucket = b.app.store.buckets()[0]
        cap = b.app.import_body_cap()
        assert cap == (1 << 20) + 4 * -(-bucket.carry_nbytes() // 3)
        conn = http.client.HTTPConnection("127.0.0.1", b.port, timeout=60)
        conn.putrequest("POST", "/session/import")
        conn.putheader("Content-Length", str(cap + 1))
        conn.endheaders()
        resp = conn.getresponse()
        assert resp.status == 400 and "oversized" in json.loads(
            resp.read())["error"]
        conn.close()
    finally:
        a.close()
        b.close()


def test_port_http_answer_verb_any_order(task):
    """The crowd's ``answer`` verb on a q = 2 bucket: each answer parks
    until the round is complete, then the round commits through one
    batch-label dispatch. Answers out of order (an abstain and a
    redelivery among them) commit rows bitwise those of the in-order
    ``labels`` verb, and the counters show the abstain; ``oracle_poison``
    applies ``(label + 1) % C`` and ``oracle_abstain`` turns an answer
    into an abstention, each counted."""
    spec = SelectorSpec.create("coda", n_parallel=4, eig_mode="incremental")
    labels = task.labels.numpy()
    servers = [_Server(task, spec=spec, acq_batch=2)]

    def run(s, how):
        out = s("POST", "/session", {"seed": 5})[1]
        sid, rows = out["session"], []
        for r in range(3):
            ans = [int(labels[i]) for i in out["idx"]]
            if how == "labels":
                code, out = s("POST", f"/session/{sid}/labels",
                              {"labels": ans})
            else:
                code, park = s("POST", f"/session/{sid}/answer",
                               {"slot": 1, "abstain": True})
                assert code == 200 and park["verb"] == "abstain"
                code, park = s("POST", f"/session/{sid}/answer",
                               {"slot": 1, "label": ans[1],
                                "request_id": f"a{r}"})
                assert park["verb"] == "parked" and park["missing"] == [0]
                code, dup = s("POST", f"/session/{sid}/answer",
                              {"slot": 1, "label": ans[1],
                               "request_id": f"a{r}"})
                assert dup["duplicate"] is True
                code, out = s("POST", f"/session/{sid}/answer",
                              {"slot": 0, "label": ans[0]})
                assert out["verb"] == "dispatched"
            assert code == 200 and out["n_labeled"] == 2 * (r + 1)
            rows.append(dict(s.app.store.get(sid).last))
        return rows

    try:
        servers.append(_Server(task, spec=spec, acq_batch=2))
        a = run(servers[0], "labels")
        b = run(servers[1], "answer")
        assert a == b
        oracle = servers[1].app.metrics.snapshot()["oracle"]
        assert oracle["abstentions"] == 3
        assert oracle["deferred_rounds_completed"] == 3
        servers.append(_Server(task, spec=spec, acq_batch=2,
                               fault_spec="oracle_poison:after=0"))
        s = servers[-1]
        out = s("POST", "/session", {"seed": 5})[1]
        sid = out["session"]
        s("POST", f"/session/{sid}/answer", {"slot": 0, "label": 1})
        code, out = s("POST", f"/session/{sid}/answer",
                      {"slot": 1, "label": 1})
        assert code == 200 and out["applied"] == [2, 1]
        assert s.app.metrics.snapshot()["oracle"]["poisoned"] == 1
        servers.append(_Server(task, spec=spec, acq_batch=2,
                               fault_spec="oracle_abstain:after=0"))
        s = servers[-1]
        sid = s("POST", "/session", {"seed": 5})[1]["session"]
        code, out = s("POST", f"/session/{sid}/answer",
                      {"slot": 0, "label": 1})
        assert code == 200 and out["verb"] == "abstain"
        assert s.app.metrics.snapshot()["oracle"]["abstentions"] == 1
    finally:
        for x in servers:
            x.close()


def test_port_serve_needs_a_card_unless_cpu():
    """Without a card, ServeApp and ``cli serve`` raise unless the CPU is
    asked for."""
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        ServeApp(tiering=False, quality=False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        tserver.build_app(tserver.parse_args(
            ["--synthetic", "4,32,3", "--no-tiering", "--no-quality"]))


def test_port_cli_serve_subprocess_drains_on_sigterm(tmp_path):
    """``python -m coda_tpu_torch.cli serve ... --device cpu``: ready, a
    session labelled over HTTP, its stream recorded, SIGTERM drains and
    exits 0."""
    cmd = [sys.executable, "-m", "coda_tpu_torch.cli", "serve",
           "--synthetic", "4,48,3", "--capacity", "2", "--no-tiering",
           "--no-quality", "--device", "cpu", "--port", "0",
           "--record-dir", str(tmp_path)]
    proc = subprocess.Popen(cmd, cwd=ROOT, stdout=subprocess.PIPE,
                            stderr=subprocess.STDOUT, text=True)
    try:
        port = None
        for line in proc.stdout:
            if "http://127.0.0.1:" in line:
                port = int(line.split("http://127.0.0.1:")[1].split("/")[0])
                break
        assert port is not None, "no serving line"

        def call(method, path, body=None):
            data = None if body is None else json.dumps(body).encode()
            req = urllib.request.Request(f"http://127.0.0.1:{port}{path}",
                                         data=data, method=method)
            try:
                with urllib.request.urlopen(req, timeout=60) as resp:
                    return resp.status, json.loads(resp.read().decode())
            except urllib.error.HTTPError as e:
                return e.code, json.loads(e.read().decode())

        for _ in range(600):
            if call("GET", "/healthz")[0] == 200:
                break
            threading.Event().wait(0.05)
        code, out = call("POST", "/session", {"seed": 1})
        assert code == 200
        code, out = call("POST", f"/session/{out['session']}/label",
                         {"label": 0})
        assert code == 200 and out["n_labeled"] == 1
        proc.send_signal(signal.SIGTERM)
        rest, _ = proc.communicate(timeout=120)
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.communicate()
    assert proc.returncode == 0 and "drained" in rest
    streams = os.listdir(tmp_path)
    assert len(streams) == 1
    with open(tmp_path / streams[0]) as f:
        rows = [json.loads(line) for line in f]
    assert rows[0]["kind"] == "session_meta"
    assert rows[-1]["kind"] == "session_close"     # drain closed it
    assert len([r for r in rows if not r.get("kind")]) == 2
