"""Tracing and profiling (counterpart of ``coda_tpu/utils/profiling.py``).

  * :func:`trace` wraps ``torch.profiler.profile`` (CPU and CUDA
    activities) so a region can be captured to a Chrome/Perfetto trace in
    a directory with one flag (the CLI's ``--profile-dir``);
  * :class:`StepTimer` records host wall-clock per labeled region and
    reports steps/sec.
"""

from __future__ import annotations

import contextlib
import os
import threading
import time

TRACE_FILE = "trace.pt.trace.json"


@contextlib.contextmanager
def trace(log_dir: str | None, device=None):
    """Capture a profiler trace of the enclosed block into
    ``log_dir/trace.pt.trace.json`` (Chrome ``trace_event`` JSON: the host
    operations and, on the card, every CUDA kernel with its device time).

    No-op when ``log_dir`` is falsy. On a CUDA ``device`` (default: the
    card when one is visible) the profiler must be able to record CUDA
    activity: if it cannot, or if the capture holds no CUDA kernel, it
    raises instead of leaving a CPU-only trace. On the CPU it records the
    host operations."""
    if not log_dir:
        yield
        return
    import torch
    from torch.profiler import ProfilerActivity, profile

    dev = torch.device(device if device is not None else (
        "cuda" if torch.cuda.is_available() else "cpu"))
    activities = [ProfilerActivity.CPU]
    if dev.type == "cuda":
        if ProfilerActivity.CUDA not in torch.profiler.supported_activities():
            raise RuntimeError(
                "torch.profiler cannot record CUDA activity here; a "
                "--profile-dir trace of a card run would hold no kernel")
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    with profile(activities=activities) as prof:
        yield
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)
    if dev.type == "cuda" and not any(
            getattr(e, "device_type", None) == torch.autograd.DeviceType.CUDA
            for e in prof.events()):
        raise RuntimeError(
            "the profiler recorded no CUDA kernel of a card run")
    prof.export_chrome_trace(os.path.join(log_dir, TRACE_FILE))


class StepTimer:
    """Accumulates named wall-clock spans; reports totals, rates, min/max.
    Thread-safe (accumulation happens under a lock)."""

    def __init__(self):
        self._lock = threading.Lock()
        self.spans: dict[str, float] = {}
        self.counts: dict[str, int] = {}
        self.mins: dict[str, float] = {}
        self.maxs: dict[str, float] = {}

    @contextlib.contextmanager
    def span(self, name: str, steps: int = 1):
        t0 = time.perf_counter()
        try:
            yield
        finally:
            dt = time.perf_counter() - t0
            with self._lock:
                self.spans[name] = self.spans.get(name, 0.0) + dt
                self.counts[name] = self.counts.get(name, 0) + steps
                self.mins[name] = min(self.mins.get(name, dt), dt)
                self.maxs[name] = max(self.maxs.get(name, dt), dt)

    def rate(self, name: str) -> float:
        """Steps/sec for a span (0.0 when never entered)."""
        with self._lock:
            dt = self.spans.get(name, 0.0)
            return self.counts.get(name, 0) / dt if dt > 0 else 0.0

    def summary(self) -> dict[str, dict]:
        with self._lock:
            return {
                k: {"seconds": self.spans[k], "steps": self.counts[k],
                    "steps_per_sec": (self.counts[k] / self.spans[k]
                                      if self.spans[k] > 0 else 0.0),
                    "min_s": self.mins[k], "max_s": self.maxs[k]}
                for k in self.spans
            }
