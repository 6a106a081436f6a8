"""Human-in-the-loop CODA demo on the card: the user is the oracle
(counterpart of the reference package's ``demo/app.py``).

The selector proposes the most informative item, a person answers with a
class or skips it ("I don't know": the item leaves the pool and nothing
is learned), and the page shows P(best) per model beside the models' true
accuracies. Deliberately wrong answers are allowed; they may mislead the
selection, as in the paper's app.

The same JSON API and page as the reference app, over a dependency-free
``http.server``: ``GET /`` (the page), ``POST /api/start`` (a new session:
``{"token", "state"}``), ``POST /api/answer`` (``{"token", "label"}``, a
class index or ``"skip"``), ``POST /api/state`` and ``GET
/api/image?token=T&idx=I``. Each session is one CODA selector behind an
:class:`~coda_tpu_torch.selectors.protocol.InteractiveSelector`, its state
on ``--device`` (the card by default): a session's start builds the
P(best) cache and scores every item (kernel 1), and each answer refreshes
the labelled class row and re-scores (kernel 2) after adding the label's
pi-hat column (kernel 3). A request reads back its session's P(best) and
the proposed item's predictions in one copy.

Run:  python -m coda_tpu_torch.demo.app [--task T --data-dir data]
      [--synthetic H,N,C] [--images-dir D] [--port 7860] [--device cpu]

With no task it serves the committed real pool ``data/digits_clip.npz``
(three small CLIP checkpoints scored over the digit scans) with its
images, ``demo/digit_images/``; without those files, a seeded synthetic
pool. Without a CUDA device it raises unless ``--device cpu`` is passed.

One selector session a user, one device round trip a click; many
sessions multiplexed on one card are the serving layer's (``python -m
coda_tpu_torch.cli serve``).
"""

from __future__ import annotations

import argparse
import json
import os
import secrets
import threading
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

import numpy as np
import torch

from coda_tpu_torch.utils.platform import DeviceLike, resolve_device

_REPO_ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
# the committed real pool and its images (read-only data files)
REAL_POOL = os.path.join(_REPO_ROOT, "data", "digits_clip.npz")
REAL_IMAGES = os.path.join(_REPO_ROOT, "demo", "digit_images")
IMAGE_EXTS = (".jpg", ".jpeg", ".png", ".webp", ".bmp")


# ----------------------------------------------------------------------------
# session: one human-in-the-loop experiment
# ----------------------------------------------------------------------------

class DemoSession:
    """One interactive CODA run over an ``(H, N, C)`` prediction pool on
    ``device`` (default: the card), with the default hyperparameters (the
    paper app's)."""

    def __init__(self, preds, labels, class_names=None, model_names=None,
                 seed: int = 0, image_paths=None, device: DeviceLike = None):
        from coda_tpu_torch.oracle import true_losses
        from coda_tpu_torch.selectors import CODAHyperparams, make_coda
        from coda_tpu_torch.selectors.protocol import InteractiveSelector

        self.device = resolve_device(device)
        self.preds = _as_tensor(preds).to(self.device, torch.float32)
        H, N, C = self.preds.shape
        # the labels stay on the host too: a request's true_label is then
        # no device read
        self.labels = (None if labels is None
                       else _as_tensor(labels).cpu().numpy())
        # one path per item (index order = npz order); None for
        # tensor-only tasks, which fall back to the prediction table
        if image_paths is not None and len(image_paths) != N:
            raise ValueError(
                f"got {len(image_paths)} image paths for {N} items")
        self.image_paths = None if image_paths is None else list(image_paths)
        self.class_names = list(class_names or [f"class {c}" for c in range(C)])
        self.model_names = list(model_names or [f"model {h}" for h in range(H)])
        self.selector = InteractiveSelector(
            make_coda(self.preds, CODAHyperparams(), device=self.device),
            seed=seed)
        self.true_accs = (
            None if self.labels is None
            else (1.0 - true_losses(
                self.preds, torch.from_numpy(self.labels).to(self.device))
            ).cpu().tolist())
        self.step = 0
        self.skipped: list[int] = []
        self.current_idx: int | None = None
        self.current_prob = 0.0
        # reentrant: answer() holds it across its next_item()/state() calls
        self.lock = threading.RLock()
        self._get_pbest = self.selector.selector.extras["get_pbest"]

    def next_item(self) -> dict:
        """Propose the next item (the paper app's ``get_next_coda_image``)."""
        with self.lock:
            idx, prob = self.selector.get_next_item_to_label()
            self.current_idx, self.current_prob = idx, prob
            return self.state()

    def answer(self, label) -> dict:
        """Apply an answer to the proposed item (a class index, or
        ``"skip"``) and propose the next one (the paper app's
        ``check_answer``)."""
        with self.lock:
            idx = self.current_idx
            if idx is None:
                return self.state()
            if label == "skip":
                # "I don't know": the item leaves the pool; the posterior,
                # the cache, the scores and the key stream stay as they are
                self.selector.state.unlabeled[idx] = False
                self.skipped.append(idx)
            else:
                label = int(label)  # ValueError/TypeError -> HTTP 400
                if not 0 <= label < len(self.class_names):
                    raise ValueError(f"label {label} out of range")
                self.selector.add_label(idx, label, self.current_prob)
            self.step += 1
            self.current_idx = None
            return self.next_item()

    def state(self) -> dict:
        """The page's view of the session. P(best) and the proposed item's
        ``(H, C)`` predictions come to the host in one copy."""
        with self.lock:
            pbest = self._get_pbest(self.selector.state).to(torch.float32)
            idx = self.current_idx
            if idx is None:
                host = pbest.cpu().numpy()
                item_preds = None
            else:
                both = torch.cat([pbest[:, None], self.preds[:, idx, :]],
                                 dim=1).cpu().numpy()
                host, item_preds = both[:, 0], both[:, 1:].tolist()
            true_label = (None if (self.labels is None or idx is None)
                          else int(self.labels[idx]))
            return {
                "step": self.step,
                "idx": idx,
                "has_images": self.image_paths is not None,
                "item_preds": item_preds,
                "true_label": true_label,
                "class_names": self.class_names,
                "model_names": self.model_names,
                "pbest": host.tolist(),
                "true_accs": self.true_accs,
                "best_model": int(np.argmax(host)),
                "n_labeled": len(self.selector.labeled_idxs),
                "n_skipped": len(self.skipped),
            }


def _as_tensor(x) -> torch.Tensor:
    if isinstance(x, torch.Tensor):
        return x
    # a read-only array (e.g. a memory map) is copied first
    return torch.from_numpy(np.require(x, requirements="W"))


# ----------------------------------------------------------------------------
# HTTP server
# ----------------------------------------------------------------------------

# Bounded session table: each session holds its pool and selector state on
# the device, so one /api/start per page load must not grow it without
# bound; the oldest sessions are evicted past the cap.
MAX_SESSIONS = 8
_SESSIONS: dict[str, DemoSession] = {}  # insertion-ordered
_SESSIONS_LOCK = threading.Lock()  # guards insert/evict/lookup
_FACTORY = None  # () -> DemoSession


PAGE = """<!doctype html>
<html><head><meta charset="utf-8"><title>CODA demo</title>
<style>
 body{font-family:system-ui,sans-serif;margin:2rem;max-width:70rem}
 button{margin:.2rem;padding:.5rem 1rem;font-size:1rem;cursor:pointer}
 .cols{display:flex;gap:2rem;flex-wrap:wrap}
 .card{border:1px solid #ccc;border-radius:8px;padding:1rem;flex:1;min-width:20rem}
 .bar{fill:#4a7dbd}.bar.best{fill:#d97706}.truebar{fill:#999}
 td,th{padding:.15rem .5rem;text-align:right;font-variant-numeric:tabular-nums}
 #status{color:#666}
</style></head><body>
<h2>CODA: consensus-driven active model selection — you are the oracle</h2>
<p id="status">starting…</p>
<div class="cols">
 <div class="card"><h3>Label this item</h3>
  <p>Item <span id="idx">—</span>. Which class is it?
     (the true class is hidden; answer honestly — or don't, and watch CODA cope)</p>
  <img id="itemimg" alt="item being labeled"
       style="display:none;max-width:100%;max-height:320px;border-radius:6px;
              border:1px solid #ccc;margin-bottom:.5rem">
  <div id="buttons"></div>
  <h4>Per-model predictions for this item</h4>
  <div id="preds"></div></div>
 <div class="card"><h3>CODA's belief: P(model is best)</h3>
  <svg id="pbest" width="420" height="240"></svg>
  <h3>True accuracy (hidden from CODA)</h3>
  <svg id="accs" width="420" height="240"></svg></div>
</div>
<script>
let token=null;
async function api(path,body){
 const r=await fetch(path,{method:body?"POST":"GET",
   headers:{"Content-Type":"application/json"},
   body:body?JSON.stringify(body):undefined});
 return r.json();}
function bars(svgId,vals,names,best){
 const svg=document.getElementById(svgId);const W=420,H=240,m=4;
 const bw=(H-20)/vals.length; const mx=Math.max(...vals,1e-9);
 svg.innerHTML=vals.map((v,i)=>{
  const w=(W-150)*v/mx;
  return `<rect class="bar${i===best?' best':''}" x="130" y="${10+i*bw}" width="${w}" height="${bw-m}"></rect>`+
   `<text x="125" y="${10+i*bw+bw/2}" text-anchor="end" font-size="11">${names[i]}</text>`+
   `<text x="${135+w}" y="${10+i*bw+bw/2}" font-size="11">${v.toFixed(3)}</text>`;
 }).join("");}
function render(s){
 document.getElementById("status").textContent=
  `step ${s.step} — ${s.n_labeled} labeled, ${s.n_skipped} skipped — `+
  `CODA's current pick: ${s.model_names[s.best_model]}`;
 document.getElementById("idx").textContent=s.idx;
 const img=document.getElementById("itemimg");
 if(s.has_images&&s.idx!==null){
  img.src=`/api/image?token=${token}&idx=${s.idx}`;img.style.display="block";
 }else{img.style.display="none";}
 const bt=document.getElementById("buttons");
 bt.innerHTML=s.class_names.map((c,i)=>
   `<button onclick="answer(${i})">${c}</button>`).join("")+
   `<button onclick="answer('skip')" style="background:#eee">I don't know</button>`;
 if(s.item_preds){
  const rows=s.model_names.map((m,h)=>`<tr><th>${m}</th>`+
    s.item_preds[h].map(p=>`<td>${p.toFixed(2)}</td>`).join("")+`</tr>`);
  document.getElementById("preds").innerHTML=
   `<table><tr><th></th>${s.class_names.map(c=>`<th>${c}</th>`).join("")}</tr>`+
   rows.join("")+`</table>`;}
 bars("pbest",s.pbest,s.model_names,s.best_model);
 if(s.true_accs) bars("accs",s.true_accs,s.model_names,
   s.true_accs.indexOf(Math.max(...s.true_accs)));}
async function answer(l){render(await api("/api/answer",{token,label:l}));}
(async()=>{const s=await api("/api/start",{});token=s.token;render(s.state);})();
</script></body></html>
"""


class Handler(BaseHTTPRequestHandler):
    def _json(self, obj, code: int = 200):
        body = json.dumps(obj).encode()
        self.send_response(code)
        self.send_header("Content-Type", "application/json")
        self.send_header("Content-Length", str(len(body)))
        self.end_headers()
        self.wfile.write(body)

    def log_message(self, *a):  # quiet
        pass

    def do_GET(self):
        if self.path in ("/", "/index.html"):
            body = PAGE.encode()
            self.send_response(200)
            self.send_header("Content-Type", "text/html; charset=utf-8")
            self.send_header("Content-Length", str(len(body)))
            self.end_headers()
            self.wfile.write(body)
        elif self.path.startswith("/api/image"):
            self._serve_image()
        else:
            self._json({"error": "not found"}, 404)

    def _serve_image(self):
        """GET /api/image?token=T&idx=I -> the item's image bytes. Only
        paths of the session's own ``image_paths`` are opened (idx is
        range-checked), so no request-controlled path reaches the
        filesystem."""
        import mimetypes
        from urllib.parse import parse_qs, urlparse

        q = parse_qs(urlparse(self.path).query)
        with _SESSIONS_LOCK:
            sess = _SESSIONS.get((q.get("token") or [""])[0])
        if sess is None or sess.image_paths is None:
            return self._json({"error": "no images for this session"}, 404)
        try:
            idx = int((q.get("idx") or [""])[0])
        except ValueError:
            return self._json({"error": "bad idx"}, 400)
        if not 0 <= idx < len(sess.image_paths):
            return self._json({"error": "idx out of range"}, 400)
        path = sess.image_paths[idx]
        try:
            with open(path, "rb") as f:
                data = f.read()
        except OSError:
            return self._json({"error": "image unavailable"}, 404)
        ctype = mimetypes.guess_type(path)[0] or "application/octet-stream"
        self.send_response(200)
        self.send_header("Content-Type", ctype)
        self.send_header("Content-Length", str(len(data)))
        self.end_headers()
        self.wfile.write(data)

    def do_POST(self):
        try:
            self._do_post()
        except (ValueError, TypeError, KeyError) as e:
            # malformed JSON / non-integer label / missing field -> 400,
            # never a dropped connection
            self._json({"error": f"bad request: {e}"}, 400)

    def _do_post(self):
        n = int(self.headers.get("Content-Length", 0))
        req = json.loads(self.rfile.read(n) or b"{}")
        if self.path == "/api/start":
            sess = _FACTORY()
            token = secrets.token_hex(8)
            with _SESSIONS_LOCK:
                _SESSIONS[token] = sess
                while len(_SESSIONS) > MAX_SESSIONS:
                    _SESSIONS.pop(next(iter(_SESSIONS)))
            self._json({"token": token, "state": sess.next_item()})
        elif self.path == "/api/answer":
            with _SESSIONS_LOCK:
                sess = _SESSIONS.get(req.get("token", ""))
            if sess is None:
                self._json({"error": "unknown session"}, 400)
            else:
                self._json(sess.answer(req.get("label")))
        elif self.path == "/api/state":
            with _SESSIONS_LOCK:
                sess = _SESSIONS.get(req.get("token", ""))
            if sess is None:
                self._json({"error": "unknown session"}, 400)
            else:
                self._json(sess.state())
        else:
            self._json({"error": "not found"}, 404)


def make_server(factory, port: int = 0) -> ThreadingHTTPServer:
    """Build the HTTP server; ``port=0`` picks a free port (for tests)."""
    global _FACTORY
    _FACTORY = factory
    return ThreadingHTTPServer(("127.0.0.1", port), Handler)


def list_images(images_dir: str) -> list[str]:
    """The image files of ``images_dir``, sorted: the order a pool built
    from that directory has its items in."""
    return sorted(
        os.path.join(images_dir, f)
        for f in os.listdir(images_dir)
        if f.lower().endswith(IMAGE_EXTS)
    )


def resolve_image_paths(ds, images_dir):
    """Per-item image paths for a loaded dataset, or None (the prediction
    table instead). The ``filenames`` the pool recorded in its npz (index
    order) joined onto ``images_dir``; without them the sorted directory
    listing, which must have one image an item."""
    if images_dir is None:
        return None
    N = ds.preds.shape[1]
    if ds.filenames is not None:
        return [os.path.join(images_dir, f) for f in ds.filenames]
    paths = list_images(images_dir)
    if len(paths) != N:
        raise SystemExit(
            f"--images-dir has {len(paths)} images but the task has {N} "
            "items; rebuild the pool or pass the matching directory")
    return paths


def default_factory(args):
    """``() -> DemoSession`` for ``args``: ``--task``/``--synthetic``
    through the CLI's loader; else the committed real pool with its
    images; else a small seeded synthetic pool. Sessions run on
    ``args.device``."""
    device = getattr(args, "device", None)

    def factory() -> DemoSession:
        if args.task or args.synthetic:
            from coda_tpu_torch.cli import load_dataset

            ds = load_dataset(args)
            return DemoSession(
                ds.preds, ds.labels, class_names=ds.class_names,
                image_paths=resolve_image_paths(
                    ds, getattr(args, "images_dir", None)),
                device=device)
        if os.path.exists(REAL_POOL) and os.path.isdir(REAL_IMAGES):
            from coda_tpu_torch.data import Dataset

            ds = Dataset.from_file(REAL_POOL, device=device)
            return DemoSession(
                ds.preds, ds.labels,
                class_names=[f"digit {c}" for c in ds.class_names],
                model_names=["tiny-clip-a", "tiny-clip-b",
                             "tiny-clip-under"],
                image_paths=resolve_image_paths(ds, REAL_IMAGES),
                device=device)
        # offline fallback: a small seeded pool, 3 models x 5 classes
        from coda_tpu_torch.data import make_synthetic_task

        task = make_synthetic_task(seed=0, H=3, N=200, C=5, device=device)
        return DemoSession(
            task.preds, task.labels,
            class_names=[f"species {c}" for c in range(5)],
            model_names=["clip-vit-l", "siglip2", "bioclip"],
            device=device)

    return factory


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--task", default=None)
    p.add_argument("--data-dir", default="data")
    p.add_argument("--synthetic", default=None)
    p.add_argument("--images-dir", default=None,
                   help="directory with the task's source images; the page "
                        "then shows the item being labeled")
    p.add_argument("--port", type=int, default=7860)
    p.add_argument("--device", default="cuda", choices=["cuda", "cpu"],
                   help="where the sessions run: the card (default), or "
                        "the CPU with every kernel's plain version")
    args = p.parse_args(argv)
    resolve_device(args.device)   # no card and no --device cpu: raise now

    srv = make_server(default_factory(args), args.port)
    print(f"CODA demo on http://127.0.0.1:{srv.server_address[1]}/")
    try:
        srv.serve_forever()
    except KeyboardInterrupt:
        pass
    finally:
        srv.server_close()


if __name__ == "__main__":
    main()
