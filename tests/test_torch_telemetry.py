"""The telemetry core of the port (``coda_tpu_torch/telemetry``,
``utils/profiling.py``, ``utils/viz.py``) against the JAX reference's
(``coda_tpu/telemetry``) on the CPU.

Inputs are fixed event lists, registry contents and small synthetic tasks
through both packages. Tolerances: the span recorder's Chrome JSON and
the stitched trace, the Prometheus text and the lint verdicts equal the
reference's exactly; the analytic kernel bounds equal the bounds
``chip_smoke.py`` printed at the headline on the H100 (``PERF.md`` §6) to
the fourth decimal; everything else is exact.
"""

from __future__ import annotations

import json
import os

import numpy as np
import pytest
import torch

from coda_tpu_torch.telemetry import (
    COSTS,
    CostTracked,
    Registry,
    SpanRecorder,
    Telemetry,
    aot_call,
    costs,
    lint_prometheus,
    registry as treg,
    render_prometheus,
    stitch_traces,
)

# (name, lane, t0, t1, attrs) with nesting, several lanes, trace ids,
# links and attrs that need escaping in JSON
EVENTS = [
    ("load_dataset", "host:main", 0.5, 1.25, None),
    ("experiment", "host:main", 1.25, 9.0, {"method": "coda", "iters": 20}),
    ("digits/coda", "device:0", 2.0, 3.5, {"task": "digits", "cold": True}),
    ("round", "device:0", 2.1, 2.2, {"trace": "t1"}),
    ("tick", "host:batcher", 4.0, 4.0, {"trace": "t2", "links": ["t1"]}),
    ('say "hi"', "device:1", 5.0, 4.5, {"path": "a\\b"}),
]


def _recorders():
    from coda_tpu.telemetry.spans import SpanRecorder as JSpans

    a, b = JSpans(), SpanRecorder()
    for r in (a, b):
        r._t0, r._t0_unix = 0.25, 1_700_000_000.0   # an injected clock
        for ev in EVENTS:
            r.record(*ev)
    return a, b


def test_reference_span_chrome_json():
    """The Chrome trace, summary, lanes, busy seconds and per-trace
    payloads equal the reference's for the same events."""
    a, b = _recorders()
    assert b.to_chrome() == a.to_chrome()
    assert json.dumps(b.to_chrome()) == json.dumps(a.to_chrome())
    assert b.summary() == a.summary() and b.lanes() == a.lanes()
    assert b.lane_busy_s("device:0") == a.lane_busy_s("device:0")
    for tid in ("t1", "t2", "missing"):
        assert b.trace_payload(tid, "replica-0") == \
            a.trace_payload(tid, "replica-0")
    assert b.trace_ids() == a.trace_ids()


def test_reference_stitch_traces():
    from coda_tpu.telemetry.spans import stitch_traces as jstitch

    a, b = _recorders()
    jp = [a.trace_payload("t1", "router"), a.trace_payload("t2", "")]
    tp = [b.trace_payload("t1", "router"), b.trace_payload("t2", "")]
    assert stitch_traces(tp) == jstitch(jp)
    assert stitch_traces([]) == jstitch([])


def test_port_span_context_and_bounded_ring(tmp_path):
    rec = SpanRecorder(capacity=4)
    with rec.span("outer", lane="host:x", annotate=True, k=1):
        with rec.span("inner"):
            pass
    for i in range(6):
        rec.instant(f"m{i}")
    s = rec.summary()
    assert (s["events"], s["recorded"], s["dropped"]) == (4, 8, 4)
    path = rec.save(str(tmp_path / "trace.json"))
    names = [e["name"] for e in json.load(open(path))["traceEvents"]]
    assert names[-1] == "m5" and "thread_name" in names


def _fill(reg):
    reg.counter("events_total", 'help with "quotes"\nand newline').inc(2)
    reg.counter("kernel_launches_total", "by flavour").inc(
        3, kernel="eig_score[bfloat16,approx]")
    g = reg.gauge("weird_labels", "label-escape coverage")
    g.set(1.5, path="a\\b", name='say "hi"\nthere')
    reg.gauge("extremes", "non-finite values").set(float("nan"), kind="n")
    reg.gauge("extremes").set(float("inf"), kind="p")
    reg.gauge("extremes").set(float("-inf"), kind="m")
    reg.gauge("device_peak_bytes", "peak").set_max(1e9, device="0")
    reg.gauge("device_peak_bytes").set_max(5e8, device="0")
    reg.gauge("ratio").set(0.1 + 0.2)


def test_reference_render_and_lint():
    """The same registry contents render to the reference's text, which
    both lints accept; the registry snapshots agree."""
    from coda_tpu.telemetry import Registry as JRegistry
    from coda_tpu.telemetry.prometheus import lint as jlint
    from coda_tpu.telemetry.prometheus import render as jrender

    jr, tr = JRegistry(), Registry()
    _fill(jr)
    _fill(tr)
    text = render_prometheus(tr)
    assert text == jrender(jr)
    assert lint_prometheus(text) == [] == jlint(text)
    assert json.dumps(tr.snapshot()) == json.dumps(jr.snapshot())
    assert render_prometheus(tr, prefix="") == jrender(jr, prefix="")
    with pytest.raises(NotImplementedError, match="slice 8"):
        render_prometheus(tr, serve_metrics=object())


BAD_TEXTS = [
    "orphan 1\n",
    "# TYPE a gauge\na 1\n# TYPE b gauge\nb 1\n# TYPE a gauge\na 2\n",
    "# TYPE c gauge\n# HELP c help\nc 1\n",
    '# TYPE d gauge\nd{k="a"b"} 1\n',
    "# TYPE e gauge\ne nope\n",
    "# TYPE f gauge\nf nan\n",
    "# TYPE f gauge\nf NaN\n",
    '# TYPE g gauge\ng{ring="r"} 0.25 # {trace_id="abc"} 0.25\n',
    '# TYPE c counter\nc_total 3 # {trace_id="abc"} 3\n',
    '# TYPE g gauge\ng 0.25 # {trace_id=abc} 0.25\n',
    '# TYPE h gauge\nh{a="1",a="2"} 1\nh{a="1"} 1\nh{a="1"} 2\n',
    "# TYPE 9bad gauge\n# TYPE k wat\nk 1\n# HELP\n# TYPE x\n",
    '# TYPE s summary\ns_count 3\ns_sum 1.5\ns{quantile="0.5"} 0.2\n',
    '# TYPE m gauge\nm{k1="a"k2="b"} 1\n',
]


@pytest.mark.parametrize("text", BAD_TEXTS)
def test_reference_lint_verdicts(text):
    from coda_tpu.telemetry.prometheus import lint as jlint

    assert lint_prometheus(text) == jlint(text)


def test_port_registry_kernel_evidence():
    """The build hook counts builds, seconds and loads for every hooked
    registry; the launch counters fold in by delta, a reset counting from
    0; device memory on the CPU is the RSS fallback."""
    from coda_tpu_torch.ops import build, eig_kernels

    reg, other = Registry(), Registry()
    assert treg.install_build_hooks(reg)
    assert treg.install_build_hooks(reg) and treg.registry_hooked(reg)
    assert not treg.registry_hooked(other)
    build._notify("build", 2.5)
    build._notify("load")
    build._notify("load_built")
    assert reg.counter("kernel_builds_total").value() == 1
    assert reg.counter("kernel_build_seconds_total").value() == 2.5
    assert reg.counter("kernel_library_loads_total").value() == 2
    assert reg.counter("kernel_library_cache_hits_total").value() == 1
    assert other.snapshot() == {}
    saved = dict(eig_kernels.launch_counts)
    try:
        treg.sample_kernel_launches(reg)
        base = reg.counter("kernel_launches_total").value(kernel="eig_score")
        eig_kernels.launch_counts["eig_score"] += 3
        treg.sample_kernel_launches(reg)
        fam = reg.counter("kernel_launches_total")
        assert fam.value(kernel="eig_score") == base + 3
        eig_kernels.launch_counts["eig_score"] = 2     # a caller's reset
        treg.sample_kernel_launches(reg)
        assert fam.value(kernel="eig_score") == base + 5
    finally:
        eig_kernels.launch_counts.update(saved)
    assert treg.sample_device_memory(reg, ["cpu"]) == {}
    assert reg.gauge("process_rss_bytes").value(source="rss") > 0


# -- costs --------------------------------------------------------------------

H100 = "NVIDIA H100 80GB HBM3"


@pytest.mark.parametrize("kernel,size,S,want", [
    ("eig_score", 4, 1, 0.5977), ("eig_score", 2, 1, 0.2992),
    ("eig_refresh_score", 4, 1, 0.6574), ("eig_refresh_score", 2, 1, 0.3589),
    ("eig_score_batched", 4, 5, 2.9884),
    ("eig_refresh_score_batched", 2, 5, 1.7944),
    ("eig_refresh_compute_score", 4, 1, 0.6583),
    ("eig_refresh_compute_score", 2, 1, 0.3598)])
def test_port_kernel_model_is_the_smokes_bound(kernel, size, S, want):
    """The analytic model at the headline (C, N, H) = (10, 50000, 1000)
    gives the bound ms the card run printed (bytes at 3.35 TB/s)."""
    peaks = costs.card_peaks(H100)
    ms, by = costs.bound_ms(*costs.kernel_work(kernel, 10, 50_000, 1000,
                                               size, S)[:2], peaks,
                            costs.kernel_work(kernel, 10, 50_000, 1000,
                                              size, S)[2])
    assert by == "bytes" and round(ms, 4) == want


def test_port_gather_model_and_peaks():
    peaks = costs.card_peaks(H100)
    nbytes, ops, _ = costs.kernel_work("row_gather", 10, 50_000, 1000)
    assert round(costs.bound_ms(nbytes, ops, peaks)[0], 4) == 0.0598
    assert costs.card_peaks("NVIDIA H100 PCIe")[0] == 2.0e12
    assert costs.card_peaks("NVIDIA H100 NVL")[0] == 3.9e12
    assert costs.card_peaks("NVIDIA H200")[0] == 4.8e12
    assert costs.card_peaks("cpu") is None
    assert costs.card_peaks("TPU v5p") is None   # NVIDIA cards only
    with pytest.raises(KeyError):
        costs.kernel_work("eig_plogp_sweep", 1, 1, 1)


def test_reference_roofline_on_table_and_unknown_kinds():
    """A kind the table names classifies against the card's balance
    (``peak_source: table``); an unknown kind against the reference's
    default balance, with its numbers."""
    from coda_tpu.telemetry.costs import roofline as jroofline

    for flops, nbytes in ((1e9, 1e9), (1e9, 1e6), (5.0, 0.0)):
        for kind in (None, "cpu"):
            got, want = (costs.roofline(flops, nbytes, kind),
                         jroofline(flops, nbytes, kind))
            for k in ("arithmetic_intensity", "machine_balance",
                      "roofline_class", "peak_source"):
                assert got[k] == want[k]
    r = costs.roofline(8.0e12, 1.0e12, H100)
    assert r["peak_source"] == "table"
    assert r["machine_balance"] == pytest.approx(67e12 / 3.35e12)
    assert r["roofline_class"] == "memory-bound"
    assert costs.roofline(1e15, 1e12, H100)["roofline_class"] == \
        "compute-bound"
    assert costs.peaks_for("cpu")["peak_source"] == "default_balance"
    assert costs.peaks_for(H100)["peak_tensor_flops_per_sec"] == 495e12


def _launching(counts):
    """An experiment callable that 'launches' ``counts`` (bumps the
    wrappers' counters, as the kernels' wrappers do on the card)."""
    from coda_tpu_torch.ops import eig_kernels, gather_kernels

    def fn(preds, labels, keys):
        for k, n in counts.items():
            d = (gather_kernels.launch_counts if k.startswith("row_")
                 else eig_kernels.launch_counts)
            d[k] = d.get(k, 0) + n
        return preds.sum()

    return fn


def test_port_cost_harvest_aot_and_tracked():
    """``aot_call`` and ``CostTracked`` harvest the analytic cost of the
    launches a call made, once per signature; the gauges render and lint
    clean; the switch turns harvesting off."""
    C, N, H, S = 4, 100, 6, 3
    preds = torch.zeros(H, N, C)
    labels = torch.zeros(N, dtype=torch.int64)
    keys = torch.zeros(S, 2, dtype=torch.int64)
    counts = {"eig_score_batched[bfloat16]": 1,
              "eig_refresh_score_batched[bfloat16]": 5,
              "row_gather_batched": 5}
    reg = Registry()
    COSTS.clear()
    aot_call(_launching(counts), (preds, labels, keys), "engine/x",
             registry=reg)
    e = COSTS.get("engine/x")
    want = sum(n * costs.kernel_work(costs.parse_flavour(k)[0], C, N, H,
                                     costs.parse_flavour(k)[1], S)[0]
               for k, n in counts.items())
    assert e["bytes_accessed"] == want and e["source"] == "analytic"
    assert e["kernels"]["row_gather_batched"]["launches"] == 5
    assert e["device_kind"] == "cpu" and e["peak_source"] == \
        "default_balance"
    tracked = CostTracked(_launching({"eig_score": 2}), "suite/coda/w1",
                          registry=reg)
    for _ in range(3):
        tracked(preds, labels, keys[:1])
    book = COSTS.snapshot(site="suite")
    (name, entry), = book.items()
    assert name.startswith("suite/coda/w1@")
    assert entry["kernels"]["eig_score"]["launches"] == 2   # first call
    assert lint_prometheus(render_prometheus(reg)) == []
    assert reg.gauge("executable_bytes_accessed").value(
        site="engine", name="engine/x") == want
    costs.set_enabled(False)
    try:
        COSTS.clear()
        aot_call(_launching(counts), (preds, labels, keys), "engine/y")
        assert COSTS.snapshot() == {}
    finally:
        costs.set_enabled(True)
        COSTS.clear()


# -- the facade, the CLI, the suite -------------------------------------------

def test_port_telemetry_facade(tmp_path):
    out = tmp_path / "t"
    tele = Telemetry(out_dir=str(out), registry=Registry())
    with tele.span("phase", lane="host:main", annotate=True, n=1):
        pass
    tele.counter("x_total").inc()
    tele.sample_devices(["cpu"])
    snap = tele.snapshot({"run": {"k": 1}})
    assert snap["jit"]["source"] == treg.BUILD_SOURCE
    assert snap["run"] == {"k": 1} and snap["spans"]["recorded"] == 1
    paths = tele.write()
    assert set(paths) == {"trace", "telemetry", "prometheus"}
    assert lint_prometheus(open(paths["prometheus"]).read()) == []
    # an out_dir's atexit fallback retires after the write
    assert not tele._atexit_live
    unhooked = Telemetry(registry=Registry(), install_hooks=False)
    assert unhooked.snapshot()["jit"]["source"] == \
        "cold-attribution-fallback"


def test_port_cli_telemetry_artifacts(tmp_path, capsys):
    """``cli --device cpu --telemetry-dir --profile-dir`` writes the
    reference's three artifacts with the load_dataset and experiment
    spans, the run's cost-book entry (clean and noisy runs), a profiler
    trace, and flushes the scalars into the store."""
    from coda_tpu_torch import cli
    from coda_tpu_torch.tracking import TrackingStore

    tdir, pdir = tmp_path / "tel", tmp_path / "prof"
    db = str(tmp_path / "t.sqlite")
    base = ["--synthetic", "5,48,3", "--method", "coda", "--iters", "4",
            "--seeds", "2", "--device", "cpu", "--tracking-db", db]
    assert cli.main(base + ["--telemetry-dir", str(tdir), "--profile-dir",
                            str(pdir)]) == 0
    out = capsys.readouterr().out
    assert "Telemetry written to" in out and "Profiler trace" in out
    trace = json.load(open(tdir / "trace.json"))
    names = {e["name"] for e in trace["traceEvents"] if e["ph"] == "X"}
    assert {"load_dataset", "experiment"} <= names
    snap = json.load(open(tdir / "telemetry.json"))
    assert snap["run"]["method"] == "coda" and snap["devices"] == {}
    assert any(k.startswith("engine/run_seeds/coda/5x48x3/s2x4")
               for k in snap["costs"])
    assert lint_prometheus(open(tdir / "metrics.prom").read()) == []
    prof = json.load(open(pdir / "trace.pt.trace.json"))
    assert "experiment" in {e.get("name") for e in prof["traceEvents"]}
    store = TrackingStore(db)
    runs = {r[0] for r in store.query("SELECT name FROM runs")}
    assert any(r.endswith("-telemetry") for r in runs)
    store.close()
    # a noisy run's cost lands under /crowd; --no-cost-capture keeps none
    tdir2 = tmp_path / "tel2"
    assert cli.main(base + ["--no-mlflow", "--telemetry-dir", str(tdir2),
                            "--oracle-noise", "annotators=4,votes=3"]) == 0
    snap2 = json.load(open(tdir2 / "telemetry.json"))
    assert any(k.endswith("/crowd") for k in snap2["costs"])
    try:
        COSTS.clear()
        assert cli.main(base + ["--no-mlflow", "--no-cost-capture"]) == 0
        assert COSTS.snapshot() == {}
    finally:
        costs.set_enabled(True)


def test_port_profiling_trace_and_steptimer(tmp_path):
    from coda_tpu_torch.utils.profiling import TRACE_FILE, StepTimer, trace

    with trace(str(tmp_path / "p"), device="cpu"):
        torch.ones(8).sum()
    ev = json.load(open(tmp_path / "p" / TRACE_FILE))["traceEvents"]
    assert any("aten::sum" in e.get("name", "") for e in ev)
    with trace(None):
        pass
    timer = StepTimer()
    for _ in range(3):
        with timer.span("a", steps=2):
            pass
    s = timer.summary()["a"]
    assert s["steps"] == 6 and s["min_s"] <= s["max_s"]
    assert timer.rate("missing") == 0.0


def test_port_viz_png_bytes():
    from coda_tpu_torch.utils.viz import fig_to_png, plot_bar, plot_series

    for fig in (plot_bar(np.array([0.1, 0.7, 0.2]), title="t", highlight=1),
                plot_series([[1.0, 0.5, 0.2], [1.0, 1.5, 1.7]],
                            labels=["r", "c"])):
        png = fig_to_png(fig)
        assert png[:8] == b"\x89PNG\r\n\x1a\n" and len(png) > 1000


def test_port_cli_debug_viz_logs_figures(tmp_path):
    from coda_tpu_torch import cli
    from coda_tpu_torch.tracking import TrackingStore

    db = str(tmp_path / "v.sqlite")
    assert cli.main(["--synthetic", "5,48,3", "--method", "coda", "--iters",
                     "3", "--seeds", "1", "--device", "cpu",
                     "--tracking-db", db, "--debug-viz"]) == 0
    store = TrackingStore(db)
    uris = [r[0] for r in store.query(
        "SELECT artifact_uri FROM runs WHERE artifact_uri IS NOT NULL "
        "AND artifact_uri != ''")]
    store.close()
    pngs = {f for d in uris if os.path.isdir(d) for f in os.listdir(d)}
    assert {"regret_curve.png", "pbest.png"} <= pngs


def test_port_suite_telemetry_flushes_store(tmp_path):
    """The suite's ``--telemetry-dir``: a span a dispatch on ``device:0``,
    cold dispatches counted, cost-book entries of the suite site, and the
    scalars flushed into the store as ``suite-telemetry``."""
    from coda_tpu_torch import cli
    from coda_tpu_torch.data import make_synthetic_arrays
    from coda_tpu_torch.tracking import TrackingStore

    pdir = tmp_path / "preds"
    pdir.mkdir()
    for i, name in enumerate(("ta", "tb")):
        p, y = make_synthetic_arrays(seed=i, H=4, N=40, C=3)[:2]
        np.savez(pdir / f"{name}.npz", preds=p, labels=y)
    db, tdir = str(tmp_path / "s.sqlite"), tmp_path / "tel"
    COSTS.clear()
    assert cli.main(["suite", "--pred-dir", str(pdir), "--db", db,
                     "--methods", "iid,coda", "--seeds", "2", "--iters",
                     "3", "--device", "cpu", "--telemetry-dir",
                     str(tdir)]) == 0
    trace = json.load(open(tdir / "trace.json"))
    spans = [e for e in trace["traceEvents"] if e["ph"] == "X"]
    lanes = {e["args"]["name"] for e in trace["traceEvents"]
             if e["name"] == "thread_name"}
    assert lanes == {"device:0"} and len(spans) == 4
    snap = json.load(open(tdir / "telemetry.json"))
    assert snap["jit"]["cold_dispatches"] >= 2
    assert any(k.startswith("suite/coda/") for k in snap["costs"])
    assert snap["suite"]["total_s"] > 0
    store = TrackingStore(db)
    run = store.find_run("suite", "suite-telemetry")
    assert run is not None
    keys = {r[0] for r in store.query(
        "SELECT key FROM metrics WHERE run_uuid=?", (run[0],))}
    assert {"suite_cold_dispatches_total", "span_events"} <= keys
    store.close()
    COSTS.clear()


def test_port_record_save_feeds_registry(tmp_path):
    from coda_tpu_torch.telemetry.recorder import RunRecord

    meta = {"schema_version": 4, "fingerprint": {}, "run": {},
            "trace_k": 1, "seeds": 2, "rounds": 5, "acq_batch": 1}
    reg = Registry()
    RunRecord(meta, {"x": np.zeros(2)}).save(str(tmp_path / "r"),
                                             registry=reg)
    assert reg.counter("records_written_total").value() == 1
    assert reg.counter("record_rounds_total").value() == 10
    assert reg.gauge("recorder_last_write_seconds").value() >= 0
