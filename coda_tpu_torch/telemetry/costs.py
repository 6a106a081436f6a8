"""Per-program cost attribution and roofline classification (counterpart
of ``coda_tpu/telemetry/costs.py``).

The reference reads XLA's ``cost_analysis()`` off each compiled program.
PyTorch has no such counter, so the port's costs are **analytic**: each
hand-written kernel has a model of the bytes it must move (each input
read once, each output written once) and the operations it does
(:func:`kernel_work`), and a program's cost is that model times the
launches its call made (the wrappers' launch counters). The model is the
one ``chip_smoke.py`` holds every kernel's time against (``bound_ms``),
and :func:`card_peaks` is the one table of the card's peak rates both
read. The PyTorch operations around the kernels (the Beta tables, the
fp32 refresh products, the threefry draws) are not in the model: an
entry is the kernels' share of a program.

  * :func:`roofline` classifies a program against the card's machine
    balance (``peak_source`` ``"table"``), or against a generic host
    balance on a device the table does not name (``"default_balance"``,
    the CPU);
  * :class:`CostBook` is the process-wide ledger of harvested programs,
    the ``costs`` section of ``telemetry.json`` and the ``executable_*``
    gauge families of ``metrics.prom``;
  * :class:`CostTracked` (the suite's experiment callables) and
    :func:`aot_call` (the engine's entry) harvest a program at its first
    call per argument signature. Harvesting reads host counters only:
    it launches nothing and waits for nothing.
"""

from __future__ import annotations

import hashlib
import threading
from typing import Optional

# -- the card's peak rates (one table for the costs and chip_smoke.py) ------

# (words of the device name, memory bytes/s, fp32 CUDA-core FLOP/s, dense
# TF32 tensor-core FLOP/s) from NVIDIA's data sheets; the first entry whose
# words all appear in the name wins (an H100 without PCIe or NVL in its
# name is the SXM card: 3.35 TB/s, 67 and 495 TFLOP/s)
CARD_PEAKS = (
    (("H200",), 4.8e12, 67e12, 495e12),
    (("H100", "PCIe"), 2.0e12, 51e12, 378e12),
    (("H100", "NVL"), 3.9e12, 60e12, 417e12),
    (("H100",), 3.35e12, 67e12, 495e12),
)

# machine balance (FLOP/byte) for a device the table does not name (the
# CPU): a generic server-CPU figure, the reference's. ``peak_source`` says
# which was used, so a CPU roofline class is never taken for the card's
DEFAULT_MACHINE_BALANCE = 8.0


def card_peaks(name: Optional[str]) -> Optional[tuple]:
    """``(memory bytes/s, fp32 FLOP/s, TF32 tensor FLOP/s)`` of a card
    named ``name`` (``torch.cuda.get_device_name``), or None for a device
    the table does not name."""
    for words, mem, fp32, tf32 in CARD_PEAKS:
        if name and all(w in name for w in words):
            return mem, fp32, tf32
    return None


def bound_ms(nbytes: float, nops: float, peaks,
             tensor_ops: float = 0.0) -> tuple[float, str]:
    """The least time in ms: bytes at the memory rate, or operations —
    ``nops`` on the fp32 CUDA cores and ``tensor_ops`` on the TF32 tensor
    cores, the two pipes overlapping — whichever is longer."""
    t_bytes = nbytes / peaks[0] * 1e3
    t_ops = max(nops / peaks[1], tensor_ops / peaks[2]) * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


# the grid points of kernel 6's Beta quadrature (CODAHyperparams.num_points)
GRID_POINTS = 256


def kernel_work(kernel: str, C: int, N: int, H: int, size: int = 4,
                S: int = 1, G: int = GRID_POINTS,
                nnz: Optional[float] = None,
                rows: Optional[float] = None) -> tuple[float, float, float]:
    """``(bytes, fp32 operations, TF32 tensor operations)`` of one launch
    of ``kernel`` at the P(best) cache ``(C, N, H)`` of ``size``-byte
    elements, ``S`` replicas a launch (the ``*_batched`` kernels).

    Kernels 1/4 read the cache, the class rows and pi-hat and write N
    scores; kernels 2/5 also write class row c of the cache (read in its
    fp32 form); each scores C*N*H elements at 8 operations an element.
    Kernel 6 adds its Beta tables and its products in 3xTF32 (the base
    product dense, the other where ``eq = hard == c`` is 1; ``nnz`` of
    them, by default ``N*H/C``). Kernel 3 reads the ``rows`` distinct
    (class, model) rows of N floats it sums (default ``S*H``), the
    classes, and writes ``S*N`` sums."""
    if kernel in ("eig_score", "eig_score_batched"):
        nbytes = S * (size * C * N * H
                      + 4 * (C * H + C + N * C + H + 1 + N))
        return float(nbytes), 8.0 * S * C * N * H, 0.0
    if kernel in ("eig_refresh_score", "eig_refresh_score_batched"):
        nbytes = S * (size * ((C - 1) * N * H + N * H)
                      + 4 * (N * H + C * H + C + N * C + H + 1 + N + 1))
        return float(nbytes), 8.0 * S * C * N * H, 0.0
    if kernel == "eig_refresh_compute_score":
        nnz = N * H / C if nnz is None else float(nnz)
        nbytes = (size * ((C - 1) * N * H + N * H)
                  + 4 * (N * H + N * C + C * H + C + H + 1 + N + 1
                         + 3 * H * G + 2 * G + 2 * H))
        tensor_ops = 3.0 * (2.0 * N * H * G + 2.0 * nnz * G)
        return float(nbytes), nnz * G + 8.0 * C * N * H, tensor_ops
    if kernel in ("row_gather", "row_gather_batched"):
        rows = S * H if rows is None else float(rows)
        return (4.0 * (rows * N + S * H + S * N), float(S * H * N), 0.0)
    raise KeyError(f"no cost model for kernel {kernel!r}")


def parse_flavour(flavour: str) -> tuple[str, int]:
    """``"eig_score[bfloat16,approx]"`` -> ``("eig_score", 2)``: the kernel
    and its cache element's bytes."""
    kernel, _, tags = flavour.partition("[")
    return kernel, (2 if "bfloat16" in tags else 4)


def analyze_launches(launches: dict, C: int, N: int, H: int,
                     S: int = 1) -> dict:
    """The analytic cost of a program's kernel launches ``{flavour: n}`` at
    ``(C, N, H)`` (``S`` replicas a launch of the batched kernels):
    ``{"flops", "bytes_accessed", "kernels": {flavour: {"launches",
    "bytes", "flops"}}}``. Tensor-core operations count as FLOPs."""
    kernels = {}
    for flavour, n in sorted(launches.items()):
        kernel, size = parse_flavour(flavour)
        if not n or kernel == "eig_plogp_sweep":
            continue
        reps = S if kernel.endswith("_batched") else 1
        nbytes, ops, tensor_ops = kernel_work(kernel, C, N, H, size, reps)
        kernels[flavour] = {"launches": int(n), "bytes": n * nbytes,
                            "flops": n * (ops + tensor_ops)}
    return {"flops": sum(k["flops"] for k in kernels.values()),
            "bytes_accessed": sum(k["bytes"] for k in kernels.values()),
            "kernels": kernels}


def peaks_for(device_kind: Optional[str]) -> dict:
    """Peak fp32 FLOP/s, TF32 tensor FLOP/s and memory bytes/s of a device
    kind (None values for a kind the table does not name)."""
    peaks = card_peaks(device_kind)
    return {"peak_flops_per_sec": peaks[1] if peaks else None,
            "peak_tensor_flops_per_sec": peaks[2] if peaks else None,
            "peak_hbm_bytes_per_sec": peaks[0] if peaks else None,
            "peak_source": "table" if peaks else "default_balance"}


def roofline(flops: float, bytes_accessed: float,
             device_kind: Optional[str] = None) -> dict:
    """Arithmetic intensity vs machine balance -> bound classification:
    ``compute-bound`` when FLOP/byte clears the balance (fp32 peak over
    memory rate), ``memory-bound`` below it, ``unknown`` without bytes. A
    kind the table does not name takes :data:`DEFAULT_MACHINE_BALANCE`
    (``peak_source: default_balance``)."""
    peaks = peaks_for(device_kind)
    pf, pb = peaks["peak_flops_per_sec"], peaks["peak_hbm_bytes_per_sec"]
    balance = (pf / pb) if (pf and pb) else DEFAULT_MACHINE_BALANCE
    flops = max(0.0, float(flops or 0.0))
    bytes_accessed = max(0.0, float(bytes_accessed or 0.0))
    if bytes_accessed <= 0.0:
        cls, ai = "unknown", 0.0
    else:
        ai = flops / bytes_accessed
        cls = "compute-bound" if ai >= balance else "memory-bound"
    return {"arithmetic_intensity": ai, "machine_balance": balance,
            "roofline_class": cls, **peaks}


def _device_kind(device=None) -> str:
    import torch

    dev = torch.device("cpu" if device is None else device)
    return torch.cuda.get_device_name(dev) if dev.type == "cuda" else "cpu"


# -- the process-wide cost ledger -------------------------------------------

class CostBook:
    """Thread-safe ledger of harvested programs: name -> cost entry."""

    def __init__(self):
        self._lock = threading.Lock()
        self._entries: dict[str, dict] = {}

    def record(self, name: str, entry: dict) -> None:
        with self._lock:
            self._entries[name] = dict(entry)

    def get(self, name: str) -> Optional[dict]:
        with self._lock:
            e = self._entries.get(name)
            return dict(e) if e is not None else None

    def snapshot(self, site: Optional[str] = None) -> dict:
        """JSON-able {name: entry}, optionally one harvest site's
        (``suite`` | ``engine``)."""
        with self._lock:
            return {k: dict(v) for k, v in sorted(self._entries.items())
                    if site is None or v.get("site") == site}

    def clear(self) -> None:
        with self._lock:
            self._entries.clear()


COSTS = CostBook()

_ENABLED = True


def set_enabled(flag: bool) -> None:
    """Process-wide switch (``--no-cost-capture``): no harvest at all."""
    global _ENABLED
    _ENABLED = bool(flag)


def enabled() -> bool:
    return _ENABLED


def _feed_gauges(name: str, entry: dict, registry=None) -> None:
    from coda_tpu_torch.telemetry.registry import get_registry

    reg = registry if registry is not None else get_registry()
    labels = {"site": entry.get("site", ""), "name": name}
    reg.gauge("executable_flops",
              "Analytic FLOPs of a program's hand-written kernel "
              "launches").set(entry["flops"], **labels)
    reg.gauge("executable_bytes_accessed",
              "Analytic bytes the program's hand-written kernel launches "
              "move").set(entry["bytes_accessed"], **labels)
    reg.gauge("executable_arithmetic_intensity",
              "FLOPs per byte of a program's kernel launches").set(
                  entry["arithmetic_intensity"], **labels)
    reg.gauge("executable_roofline",
              "Roofline classification marker (value is always 1; the "
              "class label carries the verdict)").set(
                  1.0, **labels, **{"class": entry["roofline_class"]})


def harvest(launches: dict, shape: tuple, name: str, site: str = "engine",
            device_kind: Optional[str] = None, registry=None,
            extra: Optional[dict] = None, replicas: int = 1
            ) -> Optional[dict]:
    """Model, classify and ledger one program from its kernel launches
    ``{flavour: n}`` at ``shape = (H, N, C)`` (``replicas`` a batched
    launch). Returns the recorded entry, or None while harvesting is off."""
    if not _ENABLED:
        return None
    H, N, C = (int(x) for x in shape)
    model = analyze_launches(launches, C, N, H, replicas)
    entry = {"site": site, "device_kind": device_kind, "source": "analytic",
             "flops": model["flops"],
             "bytes_accessed": model["bytes_accessed"],
             "peak_hbm_bytes": None, "kernels": model["kernels"],
             **roofline(model["flops"], model["bytes_accessed"],
                        device_kind)}
    if extra:
        entry.update(extra)
    COSTS.record(name, entry)
    _feed_gauges(name, entry, registry)
    return entry


def _launches_of(fn, args: tuple):
    """``(fn(*args), {flavour: launches it made})``."""
    from coda_tpu_torch.telemetry.registry import kernel_launch_counts

    before = kernel_launch_counts()
    out = fn(*args)
    after = kernel_launch_counts()
    return out, {k: n - before.get(k, 0) for k, n in after.items()
                 if n - before.get(k, 0) > 0}


def _program_shape(args: tuple) -> tuple:
    """``((H, N, C), replicas, device)`` of an experiment callable's
    ``(preds, labels, keys, ...)`` arguments."""
    preds, keys = args[0], args[2]
    return tuple(preds.shape), int(keys.shape[0]), preds.device


def _signature(args: tuple) -> tuple:
    return tuple((tuple(getattr(a, "shape", ())),
                  str(getattr(a, "dtype", type(a).__name__)),
                  str(getattr(a, "device", ""))) for a in args)


def _sig_tag(sig: tuple) -> str:
    return hashlib.sha256(repr(sig).encode()).hexdigest()[:8]


class CostTracked:
    """Wrap an experiment callable ``(preds, labels, keys, *runtime)`` so
    its first call per argument signature is harvested (the reference's
    AOT-compile-once wrapper; the port compiles nothing at run time, so a
    call is the plain call and its launches are counted around it). Later
    calls of a signature run as they are."""

    def __init__(self, fn, name: str, site: str = "suite", registry=None,
                 extra: Optional[dict] = None):
        self._fn = fn
        self._name = name
        self._site = site
        self._registry = registry
        self._extra = extra
        self._lock = threading.Lock()
        self._seen: set = set()

    def __call__(self, *args):
        if not _ENABLED:
            return self._fn(*args)
        sig = _signature(args)
        with self._lock:
            first = sig not in self._seen
            self._seen.add(sig)
        if not first:
            return self._fn(*args)
        out, launches = _launches_of(self._fn, args)
        shape, replicas, dev = _program_shape(args)
        extra = dict(self._extra or {})
        extra["signature"] = [list(map(str, s)) for s in sig]
        harvest(launches, shape, f"{self._name}@{_sig_tag(sig)}",
                site=self._site, device_kind=_device_kind(dev),
                registry=self._registry, extra=extra, replicas=replicas)
        return out


def aot_call(fn, args: tuple, name: str, site: str = "engine",
             registry=None, extra: Optional[dict] = None):
    """Run the engine entry's ``fn(preds, labels, keys)`` once and harvest
    its launches under ``name`` (the reference's AOT-compile-harvest-run;
    here the call itself, counted)."""
    if not _ENABLED:
        return fn(*args)
    out, launches = _launches_of(fn, args)
    shape, replicas, dev = _program_shape(args)
    harvest(launches, shape, name, site=site,
            device_kind=_device_kind(dev), registry=registry, extra=extra,
            replicas=replicas)
    return out
