"""Builds the hand-written CUDA kernels under ``coda_tpu_torch/csrc/``.

Each ``csrc/<name>.cu`` has a plain C interface and compiles on its own
(with the shared ``csrc/*.cuh`` headers) with ``nvcc`` for ``sm_90a`` into
``coda_tpu_torch/_build/<name>-<hash>.so`` (git-ignored;
:func:`set_build_dir` moves that directory), loaded with ``ctypes``. The
hash covers the source, the headers and the flags, so an edited source
never loads a stale library. A build may add preprocessor
``defines`` (e.g. ``K6_STAGES``, the per-stage clock of kernel 6); such a
library is a separate file, ``<name>-<DEFINE>-<hash>.so``. Nothing is built when a module
is imported: a kernel's wrapper builds its library at first use, and
:func:`build_all` starts one ``nvcc`` per source, all together.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import time
from pathlib import Path

_PKG = Path(__file__).resolve().parent.parent
SRC_DIR = _PKG / "csrc"
BUILD_DIR = _PKG / "_build"
SOURCES = ("eig_score", "eig_refresh_compute", "row_gather")

# -fmad=false keeps a*b+c as two rounded operations, as the plain PyTorch
# versions compute it; the kernels are bandwidth-bound, so FMA
# contraction would buy nothing but a second rounding pattern.
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-fmad=false", "-Xptxas=-v", "-shared", "-Xcompiler", "-fPIC",
)

_loaded: dict[tuple, ctypes.CDLL] = {}
# one build or load at a time in a process: two threads' first calls (the
# demo's HTTP server serves each request on its own thread) would
# otherwise both run nvcc into the same temporary file
_load_lock = threading.Lock()

# callables ``fn(event, seconds)`` told of every library this process
# builds (``"build"``, the nvcc wall seconds) and loads (``"load"``: 0 s;
# ``"load_built"`` when it was built earlier, the persistent cache's hit):
# the telemetry registry's counterpart of a compile hook
_listeners: list = []


def add_listener(fn) -> None:
    """Call ``fn(event, seconds)`` on every build and load from now on."""
    if fn not in _listeners:
        _listeners.append(fn)


def _notify(event: str, seconds: float = 0.0) -> None:
    for fn in list(_listeners):
        fn(event, seconds)


def set_build_dir(path) -> Path:
    """Build into and load from ``path`` instead of ``_build/`` (the
    serve CLI's ``--compilation-cache-dir``: a restarted server loads the
    libraries an earlier one built there, with no ``nvcc``)."""
    global BUILD_DIR
    BUILD_DIR = Path(path).resolve()
    return BUILD_DIR


def nvcc_path() -> str:
    for cand in (os.environ.get("CUDA_HOME"), "/usr/local/cuda"):
        if cand and os.path.exists(os.path.join(cand, "bin", "nvcc")):
            return os.path.join(cand, "bin", "nvcc")
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError("nvcc not found: the CUDA kernels build only on "
                           "a machine with the CUDA toolkit")
    return found


def _flags(defines: tuple[str, ...]) -> list[str]:
    return [*NVCC_FLAGS, *(f"-D{d}" for d in defines)]


def library_path(name: str, defines: tuple[str, ...] = ()) -> Path:
    src = (SRC_DIR / f"{name}.cu").read_bytes()
    # the shared headers count too: an edited header rebuilds every source
    for hdr in sorted(SRC_DIR.glob("*.cuh")):
        src += hdr.read_bytes()
    digest = hashlib.sha1(src + " ".join(_flags(defines)).encode())
    tag = "".join(f"-{d}" for d in defines)
    return BUILD_DIR / f"{name}{tag}-{digest.hexdigest()[:12]}.so"


def _start(name: str, defines: tuple[str, ...] = ()):
    """Start ``nvcc`` for ``name`` unless its library is built; returns
    ``(process, tmp_path, out_path)`` or None."""
    out = library_path(name, defines)
    if out.exists():
        return None
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_suffix(f".{os.getpid()}.tmp")
    cmd = [nvcc_path(), *_flags(defines), "-o", str(tmp),
           str(SRC_DIR / f"{name}.cu")]
    proc = subprocess.Popen(cmd, stdout=subprocess.PIPE,
                            stderr=subprocess.STDOUT, text=True)
    return proc, tmp, out


def _finish(name: str, job, t0: float) -> str:
    proc, tmp, out = job
    log, _ = proc.communicate()
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed for csrc/{name}.cu "
                           f"(exit {proc.returncode}):\n{log}")
    os.replace(tmp, out)          # atomic: a reader never sees half a file
    out.with_suffix(".log").write_text(log)
    _notify("build", time.perf_counter() - t0)
    return log


def build_all(names=SOURCES, defines: tuple[str, ...] = ()) -> dict:
    """Build every library not yet built, one ``nvcc`` per source, all
    started together. Returns ``{"seconds": wall, "logs": {name: ptxas
    output}}`` (empty logs for libraries that were already built)."""
    t0 = time.perf_counter()
    jobs = {n: _start(n, defines) for n in names}
    logs = {}
    try:
        for n, job in jobs.items():
            logs[n] = "" if job is None else _finish(n, job, t0)
    finally:
        for job in jobs.values():
            if job is not None and job[0].poll() is None:
                job[0].kill()
                job[0].wait()
    return {"seconds": time.perf_counter() - t0, "logs": logs}


def load(name: str, defines: tuple[str, ...] = ()) -> ctypes.CDLL:
    """The loaded library of ``csrc/<name>.cu`` (built with ``defines``),
    built on first use."""
    lib = _loaded.get((name, defines))
    if lib is not None:
        return lib
    with _load_lock:
        lib = _loaded.get((name, defines))
        if lib is None:
            built = library_path(name, defines).exists()
            build_all((name,), defines)
            lib = ctypes.CDLL(str(library_path(name, defines)))
            _loaded[(name, defines)] = lib
            _notify("load_built" if built else "load")
    return lib
