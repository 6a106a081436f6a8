"""Carrying CODA state between the reference package and the port.

The selector state is this system's "weights": a mid-run posterior and
its caches. :func:`state_from_numpy` turns the reference's ``CODAState``
— taken field by field with ``np.asarray`` — into the port's
:class:`~coda_tpu_torch.selectors.coda.CODAState` on a device, so both
packages can continue from the same mid-run state; :func:`state_to_numpy`
goes back. The cache fields are None off the incremental tier, and a
sparse posterior arrives as the reference's ``SparseRows`` (or any
``(diag, vals, idx, resid)`` 4-tuple of arrays) with ``dirichlets`` None.
The surrogate scorer's fit arrives as the reference's ``SurrogateFit`` (or
any 12-tuple of its leaves in its field order); a cross-session
``PriorStats`` (float64 numpy in both packages) crosses with
:func:`prior_from_numpy`. A seed-batched state — the reference's
``CODAState``
under ``vmap``, every field with a leading replica axis S — crosses the
same way and becomes the state of the port's ``Selector.batched``.

A bfloat16 cache (``eig_cache_dtype='bfloat16'``) arrives from JAX as an
``ml_dtypes`` bfloat16 array, which ``torch.from_numpy`` refuses: its bits
travel through an int16 view both ways, so the values are carried exactly.
"""

from __future__ import annotations

import numpy as np
import torch

from coda_tpu_torch.ops.sparse_rows import SparseRows
from coda_tpu_torch.selectors.coda import CODAState
from coda_tpu_torch.selectors.surrogate import PriorStats, SurrogateFit
from coda_tpu_torch.utils.platform import DeviceLike, resolve_device

_DTYPES = {
    "dirichlets": np.float32, "pi_hat_xi": np.float32, "pi_hat": np.float32,
    "unlabeled": np.bool_, "pbest_rows": np.float32, "pbest_hyp": np.float32,
    "pi_xi_unnorm": np.float32, "eig_scores_cached": np.float32,
}
_SPARSE_DTYPES = {"diag": np.float32, "vals": np.float32, "idx": np.int32,
                  "resid": np.float32}
_FIT_DTYPES = {"A": np.float32, "b": np.float32, "w": np.float32,
               "n": np.float32, "cls_feats": np.float32, "rounds": np.int32,
               "fallbacks": np.int32, "fits": np.int32,
               "last_fallback": np.bool_, "margin": np.float32,
               "prior_rounds": np.int32, "prior_rejects": np.int32}
# fields every tier carries; the rest may be None
_REQUIRED = ("pi_hat_xi", "pi_hat", "unlabeled")


def _to_torch(arr, dtype, dev) -> torch.Tensor:
    arr = np.ascontiguousarray(np.asarray(arr, dtype=dtype))
    return torch.from_numpy(arr.copy()).to(dev)


def state_from_numpy(fields: dict, device: DeviceLike = None) -> CODAState:
    """``{field: np.ndarray}`` (e.g. ``{k: np.asarray(v) for k, v in
    jax_state._asdict().items()}``) -> the port's state on ``device``."""
    dev = resolve_device(device)
    unknown = sorted(set(fields) - set(CODAState._fields))
    if unknown:
        raise ValueError(f"state fields {unknown} are not CODAState's "
                         f"{list(CODAState._fields)}")
    missing = [f for f in _REQUIRED if fields.get(f) is None]
    if fields.get("dirichlets") is None and fields.get("sparse") is None:
        missing.append("dirichlets")
    if missing:
        raise ValueError(f"state is missing {missing}: every tier carries "
                         "pi-hat, the unlabeled mask and a posterior")
    out = {}
    for f in CODAState._fields:
        v = fields.get(f)
        if v is None:
            out[f] = None
        elif f == "sparse":
            out[f] = SparseRows(*(_to_torch(x, _SPARSE_DTYPES[n], dev)
                                  for n, x in zip(SparseRows._fields, v)))
        elif f == "surrogate":
            out[f] = SurrogateFit(*(_to_torch(x, _FIT_DTYPES[n], dev)
                                    for n, x in zip(SurrogateFit._fields,
                                                    v)))
        elif f == "pbest_hyp" and np.asarray(v).dtype.name == "bfloat16":
            bits = np.ascontiguousarray(np.asarray(v)).view(np.int16)
            out[f] = torch.from_numpy(bits.copy()).view(torch.bfloat16).to(dev)
        else:
            out[f] = _to_torch(v, _DTYPES[f], dev)
    return CODAState(**out)


def state_to_numpy(state: CODAState) -> dict:
    """The port's state as ``{field: np.ndarray}`` on the host (None
    fields stay None, a sparse posterior is a ``(diag, vals, idx, resid)``
    tuple of arrays and a surrogate fit the tuple of its 12 leaves); a
    bfloat16 cache comes back as an ``ml_dtypes`` bfloat16 array, as JAX
    gives it."""
    out = {}
    for f in CODAState._fields:
        t = getattr(state, f)
        if t is None:
            out[f] = None
        elif f in ("sparse", "surrogate"):
            out[f] = tuple(x.detach().cpu().numpy() for x in t)
        elif t.dtype == torch.bfloat16:
            import ml_dtypes  # numpy's bfloat16; only a bf16 cache needs it

            out[f] = t.detach().cpu().view(torch.int16).numpy().view(
                ml_dtypes.bfloat16)
        else:
            out[f] = t.detach().cpu().numpy()
    return out


def prior_from_numpy(p) -> PriorStats:
    """The reference's ``PriorStats`` (or any ``(A, b, n, rounds,
    sessions)`` tuple) as the port's, float64 as it is."""
    A, b, n, rounds, sessions = p
    return PriorStats(A=np.asarray(A, np.float64),
                      b=np.asarray(b, np.float64), n=float(n),
                      rounds=float(rounds), sessions=float(sessions))
