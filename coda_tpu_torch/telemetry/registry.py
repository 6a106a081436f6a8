"""Process-wide counter/gauge registry with kernel-build and device-memory
evidence (counterpart of ``coda_tpu/telemetry/registry.py``).

The reference counts XLA recompiles through ``jax.monitoring`` and reads
HBM watermarks from ``device.memory_stats()``. The port has no compiler at
run time; its counterparts are:

  * **Kernel builds and loads**: :func:`install_build_hooks` subscribes a
    registry to ``ops/build.py``, which tells it of every ``nvcc`` build
    (count and seconds) and every library load (a load of a library built
    earlier is the persistent cache's hit);
  * **Kernel launches**: :func:`sample_kernel_launches` folds the wrappers'
    own counters (``ops/eig_kernels.launch_counts``,
    ``ops/gather_kernels.launch_counts``) into a counter family;
  * **Device memory**: :func:`sample_device_memory` reads
    ``torch.cuda.memory_stats()`` (``allocated_bytes.all.current``/
    ``.peak``) and ``torch.cuda.mem_get_info()``; on the CPU the process
    RSS (:func:`sample_process_rss`) is the fallback, as in the reference.

Metrics live in one process-wide registry, rendered by
:mod:`coda_tpu_torch.telemetry.prometheus` and dumped into
``telemetry.json`` by the :class:`~coda_tpu_torch.telemetry.Telemetry`
facade.
"""

from __future__ import annotations

import threading
import weakref
from typing import Iterable, Optional


def _label_key(labels: dict) -> tuple:
    return tuple(sorted((str(k), str(v)) for k, v in labels.items()))


class _Metric:
    """One named metric family: a value per label set, under one lock."""

    kind = "untyped"

    def __init__(self, name: str, help: str = ""):
        self.name = name
        self.help = help
        self._lock = threading.Lock()
        self._values: dict[tuple, float] = {}

    def value(self, **labels) -> float:
        with self._lock:
            return self._values.get(_label_key(labels), 0.0)

    def samples(self) -> list[tuple[dict, float]]:
        with self._lock:
            return [(dict(k), v) for k, v in self._values.items()]


class Counter(_Metric):
    kind = "counter"

    def inc(self, amount: float = 1.0, **labels) -> None:
        if amount < 0:
            raise ValueError("counters only go up")
        k = _label_key(labels)
        with self._lock:
            self._values[k] = self._values.get(k, 0.0) + amount


class Gauge(_Metric):
    kind = "gauge"

    def set(self, value: float, **labels) -> None:
        with self._lock:
            self._values[_label_key(labels)] = float(value)

    def set_max(self, value: float, **labels) -> None:
        """Watermark semantics: keep the max ever observed."""
        k = _label_key(labels)
        with self._lock:
            self._values[k] = max(self._values.get(k, float("-inf")),
                                  float(value))


class Registry:
    """Create-or-get metric families by name (process-wide by default)."""

    def __init__(self):
        self._lock = threading.Lock()
        self._metrics: dict[str, _Metric] = {}
        # the launch counters' values at the last sample (they may be
        # reset to 0 by a caller between samples)
        self._launches_seen: dict[str, int] = {}

    def _get(self, cls, name: str, help: str):
        with self._lock:
            m = self._metrics.get(name)
            if m is None:
                m = cls(name, help)
                self._metrics[name] = m
            elif not isinstance(m, cls):
                raise TypeError(
                    f"metric {name!r} already registered as {m.kind}")
            return m

    def counter(self, name: str, help: str = "") -> Counter:
        return self._get(Counter, name, help)

    def gauge(self, name: str, help: str = "") -> Gauge:
        return self._get(Gauge, name, help)

    def collect(self) -> Iterable[_Metric]:
        with self._lock:
            return [self._metrics[k] for k in sorted(self._metrics)]

    def snapshot(self) -> dict:
        """JSON-able dump: {name: {kind, help, values: {labelrepr: v}}}."""
        out = {}
        for m in self.collect():
            values = {}
            for labels, v in m.samples():
                key = ",".join(f"{k}={val}" for k, val in
                               sorted(labels.items())) or ""
                values[key] = v
            out[m.name] = {"kind": m.kind, "help": m.help, "values": values}
        return out


REGISTRY = Registry()


def get_registry() -> Registry:
    return REGISTRY


# -- kernel build hooks ------------------------------------------------------

BUILD_SOURCE = "coda_tpu_torch.ops.build"

_hooks_lock = threading.Lock()
_listener_registered = False
# every registry that asked for build evidence; one listener fans out to
# them (weak: a dropped test registry must not leak)
_hooked_registries: "weakref.WeakSet[Registry]" = weakref.WeakSet()


def registry_hooked(registry: Optional[Registry] = None) -> bool:
    """Whether THIS registry receives build events."""
    return (registry or REGISTRY) in _hooked_registries


def _on_build_event(event: str, seconds: float) -> None:
    with _hooks_lock:
        regs = list(_hooked_registries)
    for reg in regs:
        if event == "build":
            reg.counter(
                "kernel_builds_total",
                "CUDA kernel libraries built with nvcc (ops/build.py)").inc()
            reg.counter(
                "kernel_build_seconds_total",
                "Wall seconds of each nvcc build, summed over libraries "
                "(builds of one call run in parallel)").inc(
                    max(0.0, float(seconds)))
        else:
            reg.counter(
                "kernel_library_loads_total",
                "CUDA kernel libraries loaded (ctypes)").inc()
            if event == "load_built":
                reg.counter(
                    "kernel_library_cache_hits_total",
                    "Libraries loaded from an earlier build in the build "
                    "directory (no nvcc run)").inc()


def install_build_hooks(registry: Optional[Registry] = None) -> bool:
    """Subscribe ``registry``'s build counters to ``ops/build.py``.
    Idempotent per registry; returns True (the hook needs no optional
    dependency)."""
    global _listener_registered
    reg = registry or REGISTRY
    with _hooks_lock:
        if reg in _hooked_registries:
            return True
        if not _listener_registered:
            from coda_tpu_torch.ops import build

            build.add_listener(_on_build_event)
            _listener_registered = True
        _hooked_registries.add(reg)
        return True


def kernel_launch_counts() -> dict:
    """``{flavour: launches}`` of every hand-written kernel since the
    process started (or a caller last reset the wrappers' counters)."""
    from coda_tpu_torch.ops import eig_kernels, gather_kernels

    return {**eig_kernels.launch_counts, **gather_kernels.launch_counts}


def sample_kernel_launches(registry: Optional[Registry] = None) -> dict:
    """Fold the wrappers' launch counters into ``kernel_launches_total
    {kernel=flavour}``: the launches since the last sample (a counter reset
    to 0 in between counts from 0). Returns the current counts. Reads host
    dicts only: no device work."""
    reg = registry or REGISTRY
    counts = kernel_launch_counts()
    fam = reg.counter("kernel_launches_total",
                      "Launches of the hand-written CUDA kernels, by "
                      "flavour (the wrappers' launch counters)")
    with reg._lock:
        seen = dict(reg._launches_seen)
        reg._launches_seen = dict(counts)
    for name, n in counts.items():
        last = seen.get(name, 0)
        delta = n - last if n >= last else n
        if delta:
            fam.inc(float(delta), kernel=name)
    return counts


# -- memory sampling ---------------------------------------------------------

def _read_rss_bytes() -> Optional[int]:
    """Current process resident-set size, or None where unreadable."""
    try:
        with open("/proc/self/statm") as f:
            pages = int(f.read().split()[1])
        import os

        return pages * os.sysconf("SC_PAGE_SIZE")
    except Exception:
        pass
    try:
        import resource
        import sys

        # ru_maxrss is the PEAK, not current; units differ by platform
        scale = 1 if sys.platform == "darwin" else 1024
        return resource.getrusage(resource.RUSAGE_SELF).ru_maxrss * scale
    except Exception:
        return None


def sample_process_rss(registry: Optional[Registry] = None) -> Optional[int]:
    """Record the process RSS gauge and watermark (``source="rss"``): the
    CPU's memory evidence. Host RSS is not device memory; the label keeps
    the two families apart."""
    reg = registry or REGISTRY
    rss = _read_rss_bytes()
    if rss is None:
        return None
    reg.gauge("process_rss_bytes",
              "Resident-set size of this process (host memory; the "
              "CPU's fallback for device memory evidence)").set(
                  float(rss), source="rss")
    reg.gauge("process_peak_rss_bytes",
              "High-water process RSS across samples").set_max(
                  float(rss), source="rss")
    return int(rss)


def sample_device_memory(registry: Optional[Registry] = None,
                         devices=None) -> dict:
    """Record per-device memory gauges and watermarks from the caching
    allocator; returns ``{device index: {bytes_in_use, peak_bytes_in_use,
    free_bytes, total_bytes}}``.

    ``devices``: CUDA devices (``torch.device`` or indices), default every
    visible one. Without a CUDA device (the CPU) it records the process
    RSS and returns ``{}``. On a CUDA device whose allocator reports
    nothing it raises: a device sample never quietly records nothing."""
    import torch

    reg = registry or REGISTRY
    if devices is None:
        devices = (range(torch.cuda.device_count())
                   if torch.cuda.is_available() else ())
    devs = [torch.device("cuda", d) if isinstance(d, int)
            else torch.device(d) for d in devices]
    devs = [d for d in devs if d.type == "cuda"]
    if not devs:
        sample_process_rss(reg)
        return {}
    in_use = reg.gauge("device_bytes_in_use",
                       "Device memory allocated by the caching allocator "
                       "(torch.cuda.memory_stats)")
    peak = reg.gauge("device_peak_bytes",
                     "High-water device memory the caching allocator "
                     "allocated (allocated_bytes.all.peak)")
    free = reg.gauge("device_free_bytes",
                     "Free device memory (torch.cuda.mem_get_info)")
    out: dict = {}
    for d in devs:
        stats = torch.cuda.memory_stats(d)
        used = stats.get("allocated_bytes.all.current")
        pk = stats.get("allocated_bytes.all.peak")
        if used is None or pk is None:
            raise RuntimeError(
                f"torch.cuda.memory_stats({d}) reports no allocated bytes: "
                "no device memory evidence")
        free_b, total_b = torch.cuda.mem_get_info(d)
        dev = str(d.index if d.index is not None
                  else torch.cuda.current_device())
        in_use.set(float(used), device=dev)
        peak.set_max(float(pk), device=dev)
        free.set(float(free_b), device=dev)
        out[dev] = {"bytes_in_use": int(used), "peak_bytes_in_use": int(pk),
                    "free_bytes": int(free_b), "total_bytes": int(total_b)}
    return out
