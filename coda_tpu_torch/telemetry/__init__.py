"""Telemetry of the port (counterpart of ``coda_tpu/telemetry``): spans,
counters and gauges, the Chrome trace, Prometheus text, the analytic cost
book and the decision flight recorder.

  * :mod:`~coda_tpu_torch.telemetry.spans`: the span recorder (named
    begin/end events on device and host lanes, Chrome ``trace_event``
    JSON);
  * :mod:`~coda_tpu_torch.telemetry.registry`: counters and gauges, with
    the kernel builds and launches and the caching allocator's device
    memory as evidence;
  * :mod:`~coda_tpu_torch.telemetry.prometheus`: the exposition text and
    its lint;
  * :mod:`~coda_tpu_torch.telemetry.costs`: the kernels' analytic bytes
    and operations per program, and the roofline;
  * :mod:`~coda_tpu_torch.telemetry.recorder`: the run records and the
    serving sessions' streams (:class:`SessionRecorder`);
  * :mod:`~coda_tpu_torch.telemetry.trace`: the serve layer's trace
    context (stdlib; the reference's own module, kept as the port's copy);
  * :mod:`~coda_tpu_torch.telemetry.quality`: the serve layer's
    decision-quality plane (calibration, drift detectors, the shadow
    auditor);
  * :mod:`~coda_tpu_torch.telemetry.slo`: declarative objectives and
    burn-rate alerts (stdlib).

:class:`Telemetry` bundles the first four for the plumbing layers: the
CLI's and the suite's ``--telemetry-dir`` write ``trace.json``,
``telemetry.json`` and ``metrics.prom`` there and can flush the scalars
into the tracking store beside the regret curves.
"""

from __future__ import annotations

import atexit
import json
import os
from typing import Optional

from coda_tpu_torch.telemetry.costs import (
    COSTS,
    CostBook,
    CostTracked,
    aot_call,
    card_peaks,
    kernel_work,
    roofline,
)
from coda_tpu_torch.telemetry.prometheus import lint as lint_prometheus
from coda_tpu_torch.telemetry.prometheus import render as render_prometheus
from coda_tpu_torch.telemetry.recorder import (
    CROSS_BACKEND_SCORE_TOL,
    KNOB_FIELDS,
    RECORD_SCHEMA_VERSION,
    REQUIRED_ARRAYS,
    SESSION_SCHEMA_VERSION,
    SUPPORTED_SESSION_VERSIONS,
    RunRecord,
    SessionRecorder,
    dataset_digest,
    environment_fingerprint,
    is_record_dir,
    knobs_from_args,
    optional_arrays,
    required_arrays,
    stream_dir,
)
from coda_tpu_torch.telemetry.registry import (
    BUILD_SOURCE,
    Counter,
    Gauge,
    Registry,
    get_registry,
    install_build_hooks,
    registry_hooked,
    sample_device_memory,
    sample_kernel_launches,
)
from coda_tpu_torch.telemetry.spans import (
    SpanRecorder,
    annotation,
    stitch_traces,
)

__all__ = [
    "BUILD_SOURCE",
    "COSTS",
    "CROSS_BACKEND_SCORE_TOL",
    "CostBook",
    "CostTracked",
    "Counter",
    "Gauge",
    "KNOB_FIELDS",
    "RECORD_SCHEMA_VERSION",
    "REQUIRED_ARRAYS",
    "Registry",
    "RunRecord",
    "SESSION_SCHEMA_VERSION",
    "SUPPORTED_SESSION_VERSIONS",
    "SessionRecorder",
    "SpanRecorder",
    "Telemetry",
    "annotation",
    "aot_call",
    "card_peaks",
    "dataset_digest",
    "environment_fingerprint",
    "get_registry",
    "install_build_hooks",
    "is_record_dir",
    "kernel_work",
    "knobs_from_args",
    "lint_prometheus",
    "optional_arrays",
    "registry_hooked",
    "render_prometheus",
    "required_arrays",
    "roofline",
    "sample_device_memory",
    "sample_kernel_launches",
    "stitch_traces",
    "stream_dir",
]


class Telemetry:
    """Span recorder + registry + artifact writer, bundled for plumbing.

    ``out_dir=None`` keeps everything in memory; with an ``out_dir``,
    :meth:`write` drops the run's artifacts there (and an atexit fallback
    writes them if the run dies before an explicit write). The registry
    defaults to the process-wide one."""

    def __init__(self, out_dir: Optional[str] = None,
                 registry: Optional[Registry] = None,
                 spans: Optional[SpanRecorder] = None,
                 install_hooks: bool = True):
        self.out_dir = out_dir
        self.registry = registry if registry is not None else get_registry()
        self.spans = spans if spans is not None else SpanRecorder()
        # per-registry truth: without install_hooks the claim must not ride
        # on another registry's subscription
        self.hooks_live = install_build_hooks(self.registry) \
            if install_hooks else registry_hooked(self.registry)
        self._flushed = False
        self._atexit_live = False
        if self.out_dir:
            atexit.register(self._atexit_flush)
            self._atexit_live = True

    # -- lifecycle ---------------------------------------------------------
    def __enter__(self) -> "Telemetry":
        return self

    def __exit__(self, exc_type, exc, tb) -> bool:
        # flush on clean and exceptional exits; never swallow the error
        self.write()
        return False

    def _atexit_flush(self) -> None:
        if self._flushed or not self.out_dir:
            return
        try:
            self.write()
        except Exception:
            pass  # the interpreter is going down; never mask the real exit

    def _retire_atexit(self) -> None:
        if self._atexit_live:
            atexit.unregister(self._atexit_flush)
            self._atexit_live = False

    # -- recording passthroughs -------------------------------------------
    def span(self, name: str, lane: str = "host", annotate: bool = False,
             **attrs):
        return self.spans.span(name, lane=lane, annotate=annotate, **attrs)

    def counter(self, name: str, help: str = "") -> Counter:
        return self.registry.counter(name, help)

    def gauge(self, name: str, help: str = "") -> Gauge:
        return self.registry.gauge(name, help)

    def sample_devices(self, devices=None) -> dict:
        """Device memory (:func:`sample_device_memory`) and the kernels'
        launch counters (:func:`sample_kernel_launches`)."""
        sample_kernel_launches(self.registry)
        return sample_device_memory(self.registry, devices)

    # -- reading / artifacts ----------------------------------------------
    def snapshot(self, extra: Optional[dict] = None) -> dict:
        """The ``telemetry.json`` payload: the registry, the kernel-build
        evidence under the reference's ``jit`` keys, the device memory
        watermarks, the span summary and the cost book."""
        reg = self.registry.snapshot()

        def _values(name):
            return (reg.get(name) or {}).get("values", {})

        launches = {k.split("=", 1)[1]: v for k, v in
                    _values("kernel_launches_total").items()}
        snap = {
            "metrics": reg,
            # the port compiles no program at run time: its "recompiles"
            # are the nvcc builds of the kernel libraries, its persistent
            # cache the build directory (ops/build.py)
            "jit": {
                "recompiles": _values("kernel_builds_total").get("", 0.0),
                "compile_seconds": _values(
                    "kernel_build_seconds_total").get("", 0.0),
                "persistent_cache_hits": _values(
                    "kernel_library_cache_hits_total").get("", 0.0),
                "persistent_cache_misses": _values(
                    "kernel_builds_total").get("", 0.0),
                "library_loads": _values(
                    "kernel_library_loads_total").get("", 0.0),
                "source": (BUILD_SOURCE if self.hooks_live
                           else "cold-attribution-fallback"),
                "cold_dispatches": _values(
                    "suite_cold_dispatches_total").get("", 0.0),
                "kernel_launches": launches,
            },
            "devices": {
                dev.split("=", 1)[1]: {"peak_bytes_in_use": v}
                for dev, v in _values("device_peak_bytes").items()
            },
            "spans": self.spans.summary(),
            # the kernels' analytic cost of every harvested program
            # (telemetry/costs.py), keyed by site
            "costs": COSTS.snapshot(),
        }
        if extra:
            snap.update(extra)
        return snap

    def write(self, extra: Optional[dict] = None) -> dict:
        """Write ``trace.json`` / ``telemetry.json`` / ``metrics.prom``
        under ``out_dir``; returns {artifact: path} (empty without a
        dir)."""
        if not self.out_dir:
            return {}
        os.makedirs(self.out_dir, exist_ok=True)
        paths = {
            "trace": os.path.join(self.out_dir, "trace.json"),
            "telemetry": os.path.join(self.out_dir, "telemetry.json"),
            "prometheus": os.path.join(self.out_dir, "metrics.prom"),
        }
        self.spans.save(paths["trace"])
        with open(paths["telemetry"], "w") as f:
            json.dump(self.snapshot(extra), f, indent=2)
        with open(paths["prometheus"], "w") as f:
            f.write(render_prometheus(self.registry))
        self._flushed = True
        self._retire_atexit()
        return paths

    def flush_to_store(self, store, experiment: str = "telemetry",
                       run_name: Optional[str] = None,
                       params: Optional[dict] = None) -> str:
        """Flush the scalar registry into the tracking store (the same
        experiment -> run layout as the regret curves)."""
        name = run_name or f"{experiment}-telemetry"
        with store.run(experiment, name, params=params or {}) as run:
            for m in self.registry.collect():
                for labels, value in m.samples():
                    key = m.name
                    if labels:
                        key += "." + ".".join(
                            f"{k}_{v}" for k, v in sorted(labels.items()))
                    run.log_metric(key, float(value))
            spans = self.spans.summary()
            run.log_metric("span_events", float(spans["recorded"]))
            run.log_metric("span_events_dropped", float(spans["dropped"]))
        return run.run_uuid
