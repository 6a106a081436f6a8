"""The port's human-in-the-loop demo (``coda_tpu_torch/demo/app.py``) on
the CPU: every demo-server case of ``tests/test_demo.py`` at its sizes
and with its assertions, over real HTTP on an ephemeral port, plus

* a lock-step run of the port's ``DemoSession`` against the reference's
  ``demo.app.DemoSession`` (JAX on the CPU, as ``tests/test_demo.py``
  runs it) on the same synthetic pool and seed: 6 honest answers and 2
  skips, the same proposed item at every step, the selection
  probability and P(best) within ``ATOL`` absolute, every other field of
  the page's state equal;
* the default factory serving the committed real pool
  ``data/digits_clip.npz`` with ``demo/digit_images``;
* the entry point refusing to start without a card unless ``--device
  cpu``, and two threads' first kernel loads building once.
"""

from __future__ import annotations

import argparse
import http.client
import json
import os
import threading

import numpy as np
import pytest
import torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CLIP_POOL = os.path.join(REPO, "data", "digits_clip.npz")
DIGIT_IMAGES = os.path.join(REPO, "demo", "digit_images")
ATOL = 1e-6     # P(best) and selection probability, fp32 sums of order 1


@pytest.fixture(autouse=True)
def _one_torch_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _serve(factory):
    from coda_tpu_torch.demo.app import make_server

    srv = make_server(factory, port=0)
    threading.Thread(target=srv.serve_forever, daemon=True).start()
    return srv


@pytest.fixture(scope="module")
def demo_server():
    from coda_tpu_torch.data import make_synthetic_task
    from coda_tpu_torch.demo.app import DemoSession

    task = make_synthetic_task(seed=0, H=3, N=30, C=4, device="cpu")
    srv = _serve(lambda: DemoSession(task.preds, task.labels, seed=0,
                                     device="cpu"))
    yield srv.server_address[1]
    srv.shutdown()
    srv.server_close()


def _req(port, method, path, body=None):
    conn = http.client.HTTPConnection("127.0.0.1", port, timeout=30)
    conn.request(method, path, body=json.dumps(body) if body else None,
                 headers={"Content-Type": "application/json"})
    resp = conn.getresponse()
    data = resp.read()
    conn.close()
    return resp.status, data


def test_port_demo_page_served(demo_server):
    status, body = _req(demo_server, "GET", "/")
    assert status == 200
    assert b"CODA" in body


def test_port_demo_full_loop(demo_server):
    status, body = _req(demo_server, "POST", "/api/start", {})
    assert status == 200
    out = json.loads(body)
    token, state = out["token"], out["state"]
    assert state["idx"] is not None
    assert len(state["pbest"]) == 3
    np.testing.assert_allclose(sum(state["pbest"]), 1.0, atol=1e-5)

    # honest oracle for 3 rounds: answer with the true label
    for _ in range(3):
        status, body = _req(demo_server, "POST", "/api/answer",
                            {"token": token, "label": state["true_label"]})
        assert status == 200
        state = json.loads(body)
    assert state["n_labeled"] == 3

    # "I don't know" removes the point without a belief update
    idx_before = state["idx"]
    status, body = _req(demo_server, "POST", "/api/answer",
                        {"token": token, "label": "skip"})
    state = json.loads(body)
    assert state["n_skipped"] == 1
    assert state["n_labeled"] == 3
    assert state["idx"] != idx_before  # the skipped point left the pool

    # the state route reads the same session without moving it
    status, body = _req(demo_server, "POST", "/api/state", {"token": token})
    assert status == 200
    assert json.loads(body) == state


def test_port_demo_unknown_session(demo_server):
    status, _ = _req(demo_server, "POST", "/api/answer",
                     {"token": "nope", "label": 0})
    assert status == 400
    status, _ = _req(demo_server, "POST", "/api/state", {"token": "nope"})
    assert status == 400


def test_port_demo_bad_requests(demo_server):
    """A non-integer or out-of-range label, or an unknown route, is a 4xx
    answer, never a dropped connection."""
    status, body = _req(demo_server, "POST", "/api/start", {})
    token = json.loads(body)["token"]
    for label in ("abc", 99, None):
        status, _ = _req(demo_server, "POST", "/api/answer",
                         {"token": token, "label": label})
        assert status == 400
    assert _req(demo_server, "POST", "/api/nope", {})[0] == 404
    assert _req(demo_server, "GET", "/nope")[0] == 404


def test_port_demo_no_images_fallback(demo_server):
    """Tensor-only sessions report has_images=False and 404 the image
    route (the prediction-table fallback)."""
    status, body = _req(demo_server, "POST", "/api/start", {})
    out = json.loads(body)
    assert out["state"]["has_images"] is False
    status, _ = _req(demo_server, "GET",
                     f"/api/image?token={out['token']}&idx=0")
    assert status == 404


# 1x1 red PNG (valid image bytes for the content-type contract)
_PNG = bytes.fromhex(
    "89504e470d0a1a0a0000000d49484452000000010000000108020000009077"
    "53de0000000c4944415408d763f8cfc000000301010018dd8db00000000049"
    "454e44ae426082"
)


@pytest.fixture(scope="module")
def image_demo_server(tmp_path_factory):
    from coda_tpu_torch.data import make_synthetic_task
    from coda_tpu_torch.demo.app import DemoSession

    d = tmp_path_factory.mktemp("demo_imgs")
    N = 20
    paths = []
    for i in range(N):
        p = d / f"img_{i:02d}.png"
        p.write_bytes(_PNG)
        paths.append(str(p))
    task = make_synthetic_task(seed=1, H=3, N=N, C=4, device="cpu")
    srv = _serve(lambda: DemoSession(task.preds, task.labels, seed=0,
                                     image_paths=paths, device="cpu"))
    yield srv.server_address[1]
    srv.shutdown()
    srv.server_close()


def test_port_demo_serves_item_image(image_demo_server):
    status, body = _req(image_demo_server, "POST", "/api/start", {})
    assert status == 200
    out = json.loads(body)
    token, state = out["token"], out["state"]
    assert state["has_images"] is True
    assert state["idx"] is not None

    conn = http.client.HTTPConnection("127.0.0.1", image_demo_server,
                                      timeout=30)
    conn.request("GET", f"/api/image?token={token}&idx={state['idx']}")
    resp = conn.getresponse()
    data = resp.read()
    conn.close()
    assert resp.status == 200
    assert resp.getheader("Content-Type") == "image/png"
    assert data == _PNG

    # label it; the next item's image is also servable
    status, body = _req(image_demo_server, "POST", "/api/answer",
                        {"token": token, "label": state["true_label"]})
    state = json.loads(body)
    assert state["n_labeled"] == 1
    status, _ = _req(image_demo_server, "GET",
                     f"/api/image?token={token}&idx={state['idx']}")
    assert status == 200


def test_port_demo_image_route_validates(image_demo_server):
    status, body = _req(image_demo_server, "POST", "/api/start", {})
    token = json.loads(body)["token"]
    status, _ = _req(image_demo_server, "GET",
                     f"/api/image?token={token}&idx=9999")
    assert status == 400
    status, _ = _req(image_demo_server, "GET",
                     f"/api/image?token={token}&idx=abc")
    assert status == 400
    status, _ = _req(image_demo_server, "GET", "/api/image?token=nope&idx=0")
    assert status == 404


def test_port_demo_session_rejects_mismatched_paths():
    from coda_tpu_torch.data import make_synthetic_task
    from coda_tpu_torch.demo.app import DemoSession

    task = make_synthetic_task(seed=2, H=3, N=10, C=3, device="cpu")
    with pytest.raises(ValueError, match="image paths"):
        DemoSession(task.preds, task.labels, image_paths=["only_one.png"],
                    device="cpu")


def test_port_demo_sessions_are_bounded(demo_server):
    from coda_tpu_torch.demo import app

    for _ in range(app.MAX_SESSIONS + 2):
        assert _req(demo_server, "POST", "/api/start", {})[0] == 200
    assert len(app._SESSIONS) == app.MAX_SESSIONS


def test_port_resolve_image_paths(tmp_path):
    from coda_tpu_torch.data import make_synthetic_task
    from coda_tpu_torch.demo.app import resolve_image_paths

    d = tmp_path / "imgs"
    d.mkdir()
    for i in (2, 0, 1):
        (d / f"img_{i:02d}.png").write_bytes(_PNG)
    (d / "notes.txt").write_text("not an image")
    ds = make_synthetic_task(seed=0, H=2, N=3, C=2, device="cpu")
    assert resolve_image_paths(ds, None) is None
    # no recorded filenames: the sorted listing, one image an item
    assert resolve_image_paths(ds, str(d)) == [
        str(d / f"img_{i:02d}.png") for i in range(3)]
    ds.filenames = ["img_01.png", "img_00.png", "img_02.png"]
    assert resolve_image_paths(ds, str(d)) == [
        os.path.join(str(d), f) for f in ds.filenames]
    ds.filenames = None
    ds.preds = ds.preds[:, :2]
    with pytest.raises(SystemExit, match="2 items"):
        resolve_image_paths(ds, str(d))


def test_port_demo_lockstep_with_reference():
    """The port's session and the reference's on the same pool and seed,
    6 honest answers and 2 skips: the same item proposed at every step,
    the selection probability and P(best) within ATOL, the rest of the
    page's state equal."""
    from coda_tpu.data import make_synthetic_task
    from demo.app import DemoSession as RefSession

    from coda_tpu_torch.demo.app import DemoSession

    task = make_synthetic_task(seed=0, H=3, N=30, C=4)
    ref = RefSession(task.preds, task.labels, seed=0)
    port = DemoSession(np.asarray(task.preds), np.asarray(task.labels),
                       seed=0, device="cpu")
    a, b = ref.next_item(), port.next_item()
    moves = ["label", "label", "skip", "label", "label", "skip", "label",
             "label"]
    for step, move in enumerate([None] + moves):
        if move is not None:
            label = "skip" if move == "skip" else a["true_label"]
            a, b = ref.answer(label), port.answer(label)
        assert b["idx"] == a["idx"], f"step {step}"
        assert abs(port.current_prob - ref.current_prob) <= ATOL
        np.testing.assert_allclose(b["pbest"], a["pbest"], rtol=0,
                                   atol=ATOL, err_msg=f"step {step}")
        np.testing.assert_allclose(b["true_accs"], a["true_accs"], rtol=0,
                                   atol=ATOL)
        for k in a:
            if k not in ("pbest", "true_accs"):
                assert b[k] == a[k], f"step {step}: {k}"
    assert b["n_labeled"] == 6 and b["n_skipped"] == 2
    assert port.selector.labeled_idxs == ref.selector.labeled_idxs


@pytest.mark.skipif(
    not (os.path.exists(CLIP_POOL) and os.path.isdir(DIGIT_IMAGES)),
    reason="committed CLIP pool or digit images not present")
def test_port_demo_default_factory_serves_real_clip_pool():
    """The out-of-the-box demo: the default factory (no task) serves the
    committed CLIP pool with its digit scans; the served image is the
    item's committed PNG, and honest answers put P(best) on the strongest
    checkpoint (tiny-clip-a, model 0)."""
    from coda_tpu_torch.demo.app import default_factory

    args = argparse.Namespace(task=None, synthetic=None, data_dir="data",
                              images_dir=None, device="cpu")
    srv = _serve(default_factory(args))
    try:
        port = srv.server_address[1]
        status, body = _req(port, "POST", "/api/start", {})
        assert status == 200
        out = json.loads(body)
        token, state = out["token"], out["state"]
        assert state["has_images"]
        assert len(state["pbest"]) == 3
        assert state["model_names"][0] == "tiny-clip-a"
        assert state["class_names"][3] == "digit 3"
        status, img = _req(
            port, "GET", f"/api/image?token={token}&idx={state['idx']}")
        assert status == 200
        with open(os.path.join(
                DIGIT_IMAGES, f"digit_{state['idx']:04d}.png"), "rb") as f:
            assert img == f.read()
        for _ in range(5):
            status, body = _req(port, "POST", "/api/answer",
                                {"token": token,
                                 "label": state["true_label"]})
            assert status == 200
            state = json.loads(body)
        assert state["n_labeled"] == 5
        assert int(np.argmax(state["pbest"])) == 0
    finally:
        srv.shutdown()
        srv.server_close()


def test_port_demo_default_factory_task_and_fallback(monkeypatch):
    from coda_tpu_torch.demo import app

    args = argparse.Namespace(task=None, synthetic="3,40,4", data_dir="data",
                              images_dir=None, device="cpu")
    sess = app.default_factory(args)()
    assert sess.preds.shape == (3, 40, 4) and sess.image_paths is None
    assert sess.device.type == "cpu"
    # no committed pool: the seeded offline pool, 3 models x 5 classes
    monkeypatch.setattr(app, "REAL_POOL", os.path.join(REPO, "no_such.npz"))
    args.synthetic = None
    sess = app.default_factory(args)()
    assert sess.preds.shape == (3, 200, 5)
    assert sess.model_names == ["clip-vit-l", "siglip2", "bioclip"]
    assert sess.next_item()["idx"] is not None


def test_port_demo_main_needs_a_card_or_cpu(monkeypatch):
    from coda_tpu_torch.demo import app

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        app.main(["--port", "0"])
    served = []

    class _Srv:
        server_address = ("127.0.0.1", 0)

        def serve_forever(self):
            served.append(True)

        def server_close(self):
            pass

    monkeypatch.setattr(app, "make_server", lambda factory, port: _Srv())
    app.main(["--port", "0", "--device", "cpu"])
    assert served == [True]
    # a session of the default factory on the card raises too
    with pytest.raises(RuntimeError, match="device='cpu'"):
        app.DemoSession(np.ones((2, 3, 2), np.float32) / 2,
                        np.zeros(3, np.int64))


def test_port_kernel_library_loads_once_across_threads(monkeypatch):
    """Two requests' first kernel calls on two threads build a library
    once (``ops/build.load`` is locked): the second waits for the first's
    build and loads the same library."""
    import time

    from coda_tpu_torch.ops import build

    builds = []

    def fake_build_all(names, defines=()):
        builds.append(names)
        time.sleep(0.2)
        return {"seconds": 0.2, "logs": {}}

    monkeypatch.setattr(build, "build_all", fake_build_all)
    monkeypatch.setattr(build.ctypes, "CDLL", lambda path: object())
    monkeypatch.setattr(build, "_loaded", {})
    got = []
    threads = [threading.Thread(target=lambda: got.append(
        build.load("row_gather"))) for _ in range(4)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    assert builds == [("row_gather",)]
    assert len(got) == 4 and all(g is got[0] for g in got)
