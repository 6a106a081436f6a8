"""Numeric sanity checks (counterpart of ``coda_tpu/utils/checks.py``).

Eager checks raise like the reference's NaN/Inf and probability asserts.
:func:`debug_check_finite` is the check wired into the P(best) kernel
(``ops/pbest.py``): a no-op unless ``CODA_TPU_DEBUG_CHECKS=1``, because
every check copies the tensor to the host and synchronises the device.
"""

from __future__ import annotations

import os

import numpy as np
import torch

DEBUG_CHECKS = os.environ.get("CODA_TPU_DEBUG_CHECKS", "0") == "1"


def _host(t) -> np.ndarray:
    if isinstance(t, torch.Tensor):
        return t.detach().cpu().numpy()
    return np.asarray(t)


def check_finite(t, name: str = "tensor", raise_err: bool = True) -> None:
    """Raise (or warn) if ``t`` contains NaN/Inf."""
    arr = _host(t)
    bad = ~np.isfinite(arr)
    if bad.any():
        msg = (
            f"[NUMERIC ERROR] {name} has {int(bad.sum())} bad values "
            f"(NaN/Inf) out of {arr.size} "
            f"min={np.nanmin(arr):.3g}, max={np.nanmax(arr):.3g}"
        )
        if raise_err:
            raise FloatingPointError(msg)
        print(msg)


def check_prob(p, name: str = "prob", eps: float = 1e-12) -> None:
    """Raise if ``p`` is not a valid probability distribution over its last
    axis (warn if rows are not normalised)."""
    check_finite(p, name)
    arr = _host(p)
    if (arr < -eps).any():
        raise FloatingPointError(f"{name} has negatives")
    s = arr.sum(-1)
    if not np.isfinite(s).all():
        raise FloatingPointError(f"{name} sum is nan/inf")
    if (np.abs(s - 1) > 1e-4).any():
        print(
            f"[WARN] {name} rows not normalised: min sum={s.min():.4f}, "
            f"max sum={s.max():.4f}"
        )


def debug_check_finite(t: torch.Tensor, name: str) -> None:
    """The env-gated finite check; free unless ``DEBUG_CHECKS``."""
    if DEBUG_CHECKS:
        check_finite(t, name)
