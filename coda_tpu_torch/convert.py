"""Carrying CODA state between the reference package and the port.

The selector state is this system's "weights": a mid-run posterior and
its caches. :func:`state_from_numpy` turns the reference's ``CODAState``
— taken field by field with ``np.asarray`` — into the port's
:class:`~coda_tpu_torch.selectors.coda.CODAState` on a device, so both
packages can continue from the same mid-run state; :func:`state_to_numpy`
goes back. Fields of later slices (sparse posterior, surrogate fit) must
be absent or None. A seed-batched state — the reference's ``CODAState``
under ``vmap``, every field with a leading replica axis S — crosses the
same way and becomes the state of the port's ``Selector.batched``.

A bfloat16 cache (``eig_cache_dtype='bfloat16'``) arrives from JAX as an
``ml_dtypes`` bfloat16 array, which ``torch.from_numpy`` refuses: its bits
travel through an int16 view both ways, so the values are carried exactly.
"""

from __future__ import annotations

import numpy as np
import torch

from coda_tpu_torch.selectors.coda import CODAState
from coda_tpu_torch.utils.platform import DeviceLike, resolve_device

_DTYPES = {
    "dirichlets": np.float32, "pi_hat_xi": np.float32, "pi_hat": np.float32,
    "unlabeled": np.bool_, "pbest_rows": np.float32, "pbest_hyp": np.float32,
    "pi_xi_unnorm": np.float32, "eig_scores_cached": np.float32,
}
_LATER_SLICES = ("sparse", "surrogate")


def state_from_numpy(fields: dict, device: DeviceLike = None) -> CODAState:
    """``{field: np.ndarray}`` (e.g. ``{k: np.asarray(v) for k, v in
    jax_state._asdict().items()}``) -> the port's state on ``device``."""
    dev = resolve_device(device)
    for name in _LATER_SLICES:
        if fields.get(name) is not None:
            raise NotImplementedError(
                f"state field {name!r} belongs to a later slice of the port")
    missing = [f for f in CODAState._fields if fields.get(f) is None]
    if missing:
        raise ValueError(f"state is missing {missing}: the port carries the "
                         "incremental tier's full state")
    out = {}
    for f in CODAState._fields:
        arr = np.asarray(fields[f])
        if f == "pbest_hyp" and arr.dtype.name == "bfloat16":
            bits = np.ascontiguousarray(arr).view(np.int16)
            out[f] = torch.from_numpy(bits.copy()).view(torch.bfloat16).to(dev)
            continue
        arr = np.ascontiguousarray(np.asarray(arr, dtype=_DTYPES[f]))
        out[f] = torch.from_numpy(arr.copy()).to(dev)
    return CODAState(**out)


def state_to_numpy(state: CODAState) -> dict:
    """The port's state as ``{field: np.ndarray}`` on the host; a bfloat16
    cache comes back as an ``ml_dtypes`` bfloat16 array, as JAX gives it."""
    out = {}
    for f in CODAState._fields:
        t = getattr(state, f).detach().cpu()
        if t.dtype == torch.bfloat16:
            import ml_dtypes  # numpy's bfloat16; only a bf16 cache needs it

            out[f] = t.view(torch.int16).numpy().view(ml_dtypes.bfloat16)
        else:
            out[f] = t.numpy()
    return out
