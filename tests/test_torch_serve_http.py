"""The port's HTTP front door and ``cli serve`` (``coda_tpu_torch/serve/
server.py``) on the CPU.

Each test runs its own server on an ephemeral port and waits on its
answers only (no wall-clock bound beyond the request timeout). Held: the
reference's JSON shapes and status codes; ``request_id`` dedupe;
admission 503 and draining; the ``/healthz`` warm gate; ``/metrics``
clean under the port's ``prometheus.lint``; ``parse_args([])``'s defaults
equal to the reference's (``--platform`` is the port's ``--device``);
every verb of slice 8b or 9 refused naming its slice (HTTP 501); and the
answers over HTTP equal to the in-process slab's on the same seed,
bitwise.
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

    def __init__(self, task, capacity=4, warm=True, **kw):
        kw.setdefault("spec", _spec())
        self.app = ServeApp(capacity=capacity, tiering=False, quality=False,
                            device=DEV, **kw)
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
    ``--platform`` (a JAX platform) becoming ``--device`` (cuda)."""
    ours = vars(tserver.parse_args([]))
    assert ours.pop("device") == "cuda"
    try:
        from coda_tpu.serve.server import parse_args as ref_parse
    except ImportError:
        pytest.skip("needs the JAX reference")
    theirs = vars(ref_parse([]))
    assert theirs.pop("platform") is None
    assert ours == theirs
    assert tserver.parse_args(["--step-impl", "vmap"]).step_impl == "vmap"


def test_port_refusals_name_their_slice(task):
    """Everything of slice 8b or 9 raises NotImplementedError naming its
    slice in process and answers 501 over HTTP."""
    from coda_tpu_torch import cli
    from coda_tpu_torch.telemetry.prometheus import render_fleet

    with pytest.raises(NotImplementedError, match="8b"):
        ServeApp(device=DEV, quality=False)          # tiering on
    with pytest.raises(NotImplementedError, match="8b"):
        ServeApp(device=DEV, tiering=False)          # quality on
    with pytest.raises(NotImplementedError, match="8b"):
        ServeApp(device=DEV, tiering=False, quality=False,
                 spec=SelectorSpec.create("coda", eig_scorer="surrogate:8",
                                          surrogate_prior="pool"))
    with pytest.raises(NotImplementedError, match="slice 9"):
        render_fleet({})
    for sub, where in (("replay-serve", "8b"), ("quality", "8b"),
                       ("trace", "9")):
        with pytest.raises(NotImplementedError, match=where):
            cli.main([sub, "x"])
    s = _Server(task)
    try:
        app = s.app
        sid = s("POST", "/session", {"seed": 0})[1]["session"]
        for fn, where in ((lambda: app.export_session(sid), "8b"),
                          (lambda: app.import_session({}), "8b"),
                          (lambda: app.restore_sessions(), "8b"),
                          (lambda: app.answer(sid, 0, 1), "8b"),
                          (lambda: app.sync_prior(), "8b"),
                          (lambda: app.begin_migration(sid), "slice 9"),
                          (lambda: app.end_migration(sid, True),
                           "slice 9")):
            with pytest.raises(NotImplementedError, match=where):
                fn()
        for method, path in (("POST", f"/session/{sid}/export"),
                             ("POST", "/session/import"),
                             ("POST", f"/session/{sid}/answer"),
                             ("POST", f"/session/{sid}/fence"),
                             ("POST", "/prior/sync")):
            code, err = s(method, path, {})
            assert code == 501 and "slice" in err["error"], path
    finally:
        s.close()


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
