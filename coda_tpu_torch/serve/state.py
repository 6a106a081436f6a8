"""Session slabs: many interactive selection sessions in one bucket
(counterpart of ``coda_tpu/serve/state.py``).

A **bucket** is a fixed-capacity slab of selector states for one (task,
selector-config) pair: the state of every slot, a per-slot PRNG key and a
host-side free list. One masked **slab step** (update-if-requested +
select + best, with the P(best) digest) serves every requesting session of
the bucket per dispatch. The **SessionStore** multiplexes sessions onto
buckets: admission takes a free slot (or refuses — the backpressure the
server turns into HTTP 503), close returns the slot for reuse.

Key-stream parity: a session's randomness is bit for bit that of one
``InteractiveSelector(selector, seed)`` driven by hand — init consumes one
``split``, each processed request two (select, best) — so the slab is
testable against the sequential twin.

What the port decides afresh (the reference's choices are TPU-tuned):

  * **The slab's layout.** The port's ``update`` writes a state in place,
    so the slab holds every slot's state as tensors the selector writes
    directly. A state leaf whose per-slot size is a multiple of 512 bytes
    (CODA's ``(C, N, H)`` cache at every shape with ``C·N·H`` divisible by
    128) lives in one ``(capacity, ...)`` tensor, each slot a view starting
    512-byte aligned as a fresh allocation does; every other leaf is a
    tensor of its own per slot. A slot's state therefore sits at the same
    alignment as the sequential twin's, and the library reductions that
    pick a vectorised path by alignment add in the same order.
  * **Two lowerings of the step** (``step_impl``). ``map`` runs the
    requested slots one after another through the single-replica
    functions (kernel 2 or 6, and 3, once a requested slot). ``batched``
    (the reference's ``vmap``, a name it also takes) runs each maximal run
    of consecutive requested slots as one replica batch through
    ``Selector.batched`` (kernel 5 and kernel 3 with a replica axis): the
    cache of a run is a view of the slab, the small leaves are stacked for
    the call and written back, so no idle slot is read or written. The
    batched lowering exists only where the method has a batched form (not
    under ``eig_refresh='fused'``, the surrogate scorer or ``acq_batch >
    1``) and is bitwise the ``map`` lowering. ``step_impl=None`` takes
    :data:`DEFAULT_IMPL` (see its comment for the measurement behind it).
  * **No donation.** The step writes the slab in place (``ServeApp``'s
    ``donate`` is accepted and changes nothing); a snapshot copies a slot
    to the host under the bucket's lock before the next dispatch writes.
  * **The warm pool** (:meth:`Bucket.warm`) runs one untimed dispatch of
    each lowering the bucket uses on a scratch slot — which builds and
    loads the kernels (``ops/build.py``) — and caches the key-independent
    init state, so an admission copies one state instead of rebuilding
    the cache.

Shape buckets: ``bucket_n`` rounds a task's N up to a quantum,
zero-padding the predictions and marking the padded items labeled through
the states' shared ``unlabeled`` mask, so near-shaped tasks share one
bucket. The default quantum of 1 keeps shapes exact.

The restore hooks of export/import, crash restore and the session tiers
(``serve/recovery.py``, ``serve/tiering.py``) are decided for a slot of
2.0 GB (the headline's fp32 ``(C, N, H)`` cache):

  * :meth:`Bucket.snapshot_slots` copies only the named slots (the
    reference copies the whole slab to the host and slices it there). On
    the card each slot goes through pinned staging buffers (one slot's
    worth, pinned once) on a side stream, the dispatch lock held only to
    order the copy after the work already queued, then into pageable
    host memory: a demotion wave does not stall the dispatches behind a
    gigabyte copy, nor pin host pages a session (which stalls every
    launch of the process). A dispatch that writes a slot during its copy
    makes the demotion lose (the tiers' pin and label-count re-check),
    and a heal during the copy voids the whole snapshot.
    :meth:`Bucket.snapshot_slot` (export) holds the lock until its copy
    has landed: its snapshot must be consistent by itself.
  * :meth:`Bucket.restore_slot` writes into the slot's existing tensors
    (``copy_``, through the staging buffers on the card) and never
    allocates a tensor for a slot, so a woken slot keeps the alignment a
    fresh allocation gave it. The caller verifies the written slot's
    P(best) digest against the stream (:meth:`Bucket.digest`).
  * :meth:`Bucket.pbest_rows` reads many slots' P(best) with one stacked
    gather and one device-to-host copy (the quality plane's per-tick read).
"""

from __future__ import annotations

import hashlib
import inspect
import secrets
import threading
import time
import weakref
from dataclasses import dataclass, field
from typing import Any, NamedTuple, Optional

import numpy as np
import torch

from coda_tpu_torch import random as trandom
from coda_tpu_torch.ops.masked import entropy2
from coda_tpu_torch.utils.platform import DeviceLike, resolve_device

#: the slab-step lowerings; ``vmap`` (the reference's name) is ``batched``
STEP_IMPLS = ("map", "batched")
_IMPL_ALIASES = {"vmap": "batched"}
# the lowering ``step_impl=None`` takes where the method has a batched
# form, from the H100's dispatch times at 1, 4 and 16 requested slots
# (PERF.md, PR 11): batched 22.4-27.1 ms at 4 and 86.6-94.5 at 16 against
# map's 31.6-41.3 and 104.3-145.9 over three calls; kernel 5 at one slot
# gained nothing, so a run of one slot takes the single-replica functions
DEFAULT_IMPL = "batched"
# a leaf whose per-slot bytes are a multiple of this lives in the stacked
# slab tensor (each slot a view aligned as a fresh allocation)
_SLAB_ALIGN = 512


class SlabFull(RuntimeError):
    """Admission refused: every slot of the bucket's slab is live."""


class UnknownSession(KeyError):
    """No live session with that id."""


class BucketQuarantined(RuntimeError):
    """The bucket's slab was lost to a step failure and is being rebuilt
    from its sessions' recorder streams (``serve/recovery.py``) — retry
    shortly. Distinct from the terminal ``failed`` state, which only a
    digest mismatch or exhausted heal retries produces."""


class StaleOwner(RuntimeError):
    """The fencing rejection of the fleet's migration protocol: a verb
    stamped with an ownership epoch newer than this copy's proves the
    session migrated away (``serve/router.py`` re-locates on it)."""

    def __init__(self, sid: str, have: int, want: int):
        super().__init__(
            f"session {sid}: this replica's copy is at ownership epoch "
            f"{have} but the verb was fenced at epoch {want} — the "
            "session migrated away; re-locate and retry")
        self.sid = sid
        self.have = int(have)
        self.want = int(want)


def resolve_impl(step_impl: Optional[str]) -> Optional[str]:
    """``map``, ``batched`` or None; ``vmap`` reads as ``batched``."""
    if step_impl is None:
        return None
    impl = _IMPL_ALIASES.get(step_impl, step_impl)
    if impl not in STEP_IMPLS:
        raise ValueError(f"unknown slab-step impl {step_impl!r} "
                         "(use 'map', 'batched' or 'vmap')")
    return impl


# ---------------------------------------------------------------------------
# selector specs: a hashable description of a selector config
# ---------------------------------------------------------------------------

@dataclass(frozen=True)
class SelectorSpec:
    """Method name + hyperparams as a hashable bucket-key component.

    ``kwargs`` is a sorted tuple of (name, value) pairs so equal configs
    compare equal; use :meth:`create` to build one. ``acq_batch`` is the
    labels-per-round width of the bucket's step (the serving face of
    ``--acq-batch``)."""

    method: str = "coda"
    kwargs: tuple = ()
    acq_batch: int = 1

    @classmethod
    def create(cls, method: str = "coda", acq_batch: int = 1,
               **kwargs) -> "SelectorSpec":
        if int(acq_batch) < 1:
            raise ValueError(f"acq_batch must be >= 1, got {acq_batch}")
        return cls(method=method, kwargs=tuple(sorted(kwargs.items())),
                   acq_batch=int(acq_batch))

    def factory(self, device: DeviceLike = None):
        """``preds -> Selector`` on ``device`` (the port's
        ``SELECTOR_FACTORIES`` and ``make_coda``)."""
        from coda_tpu_torch.losses import LOSS_FNS
        from coda_tpu_torch.selectors import (
            CODAHyperparams,
            SELECTOR_FACTORIES,
            make_coda,
        )

        kw = dict(self.kwargs)
        if self.method.startswith("coda"):
            hp = CODAHyperparams(**kw)
            return lambda preds: make_coda(preds, hp, name=self.method,
                                           device=device)
        if self.method not in SELECTOR_FACTORIES:
            raise ValueError(f"unknown serve method {self.method!r}")
        make = SELECTOR_FACTORIES[self.method]
        if "loss" in kw:  # risk-readout methods take a loss_fn callable
            kw["loss_fn"] = LOSS_FNS[kw.pop("loss")]
        if "device" in inspect.signature(make).parameters:
            kw["device"] = device
        return lambda preds: make(preds, **kw)


# ---------------------------------------------------------------------------
# the masked step's host-side inputs and outputs
# ---------------------------------------------------------------------------

class SlotRequest(NamedTuple):
    """One slot's inputs of a dispatch."""

    do_update: bool   # apply the oracle label before selecting?
    idx: Any          # labeled item (a list of q at acq_batch q > 1)
    label: Any        # its oracle class
    prob: Any         # the selection prob the label was drawn at


class SlotResult(NamedTuple):
    """One slot's outputs of a dispatch (device tensors until the
    dispatch's host read)."""

    next_idx: Any    # next most-informative item ((q,) at q > 1)
    next_prob: Any   # its selection probability / q-value
    best: Any        # current best-model estimate
    stochastic: Any  # did RNG affect this slot's step?
    # P(best) digest of the post-update state (NaN when the method has no
    # ``get_pbest``): the flight recorder's (max, entropy-bits) pair, which
    # makes healed sessions verifiable bitwise against their streams
    pbest_max: Any
    pbest_entropy: Any


# ---------------------------------------------------------------------------
# state trees: NamedTuples of tensors, None, scalars and nested NamedTuples
# ---------------------------------------------------------------------------

def _is_node(x) -> bool:
    return isinstance(x, tuple) and hasattr(x, "_fields")


def tree_leaves(x) -> list:
    """The leaves of a state in field order (nested NamedTuples walked)."""
    if _is_node(x):
        return [leaf for v in x for leaf in tree_leaves(v)]
    return [x]


def tree_rebuild(template, leaves):
    """``template``'s structure with ``leaves`` (an iterator or list) in
    field order."""
    it = iter(leaves)

    def build(t):
        if _is_node(t):
            return type(t)(*(build(v) for v in t))
        return next(it)

    return build(template)


def tree_paths(x, prefix=()) -> list:
    """The field-name path of every leaf of a state, in
    :func:`tree_leaves` order."""
    if _is_node(x):
        return [p for name, v in zip(x._fields, x)
                for p in tree_paths(v, prefix + (name,))]
    return [prefix]


def _tensor_positions(template) -> list:
    """Leaf positions of a state that hold tensors: a snapshot's carries
    in order (the None leaves of an unused tier are not carried)."""
    return [i for i, leaf in enumerate(tree_leaves(template))
            if isinstance(leaf, torch.Tensor)]


def _host_tensor(arr) -> torch.Tensor:
    """A CPU tensor over a host array without a copy (a read-only buffer,
    such as a decompressed spill leaf, is only read)."""
    import warnings

    with warnings.catch_warnings():
        warnings.simplefilter("ignore", UserWarning)
        return torch.from_numpy(np.asarray(arr))


# a carry at least this large is copied out of the staging buffers into a
# pooled host array (see _Lease); smaller ones are plain copies
_HOST_POOL_MIN_BYTES = 1 << 20


class _Lease:
    """A pooled host array lent out: the arrays made from it keep it, and
    when the last of them is gone a finalizer gives the array back to its
    pool (:func:`_give_back`), so a pooled array is never written while a
    payload still reads it."""

    __slots__ = ("arr", "__weakref__")

    def __init__(self, arr: np.ndarray):
        self.arr = arr

    def __buffer__(self, flags):
        return memoryview(self.arr)


def _give_back(free: list, arr: np.ndarray, cap: int) -> None:
    if len(free) < cap:
        free.append(arr)


def state_digest(state, key=None) -> str:
    """sha256 over a state's leaves (dtype, shape and bytes) and ``key``:
    the test of an idle slot left bit for bit as it was."""
    h = hashlib.sha256()
    for leaf in tree_leaves(state) + ([] if key is None else [key]):
        if isinstance(leaf, torch.Tensor):
            a = leaf.detach().cpu().contiguous()
            h.update(f"{a.dtype}{tuple(a.shape)}".encode())
            h.update(a.reshape(-1).view(torch.uint8).numpy().tobytes()
                     if a.numel() else b"")
        else:
            h.update(repr(leaf).encode())
    return h.hexdigest()


class _Slab:
    """The states of ``capacity`` slots: a leaf of 512-byte-multiple
    per-slot size in one stacked ``(capacity, ...)`` tensor, every other
    leaf a per-slot object (see the module docstring)."""

    def __init__(self, template, capacity: int):
        self.template = template
        self.capacity = int(capacity)
        self.stacked: list = []       # per leaf: the stacked tensor or None
        self.per_slot: list = []      # per leaf: a list of capacity values
        for leaf in tree_leaves(template):
            if (isinstance(leaf, torch.Tensor) and leaf.numel()
                    and (leaf.numel() * leaf.element_size())
                    % _SLAB_ALIGN == 0):
                self.stacked.append(torch.zeros(
                    (self.capacity, *leaf.shape), dtype=leaf.dtype,
                    device=leaf.device))
                self.per_slot.append(None)
            else:
                self.stacked.append(None)
                self.per_slot.append([_clone(leaf)
                                      for _ in range(self.capacity)])

    def slot(self, s: int):
        """Slot ``s``'s state: views of the stacked tensors, the slot's
        own objects elsewhere (the selector writes both in place)."""
        return tree_rebuild(self.template, (
            st[s] if st is not None else ps[s]
            for st, ps in zip(self.stacked, self.per_slot)))

    def write(self, s: int, state, copy: bool) -> None:
        """Make ``state`` slot ``s``'s: stacked leaves are copied in
        (unless ``state`` already holds the slot's views); other leaves are
        taken as they are, or cloned with ``copy`` (a shared state such as
        the cached init)."""
        for i, leaf in enumerate(tree_leaves(state)):
            st = self.stacked[i]
            if st is not None:
                if leaf.data_ptr() != st[s].data_ptr():
                    st[s].copy_(leaf)
            else:
                self.per_slot[i][s] = _clone(leaf) if copy else leaf

    def run(self, a: int, b: int):
        """Slots ``a..b-1`` as one replica batch: the stacked tensors'
        ``[a:b]`` views, every other tensor leaf stacked into a new
        contiguous tensor (written back by :meth:`write_run`)."""
        leaves = []
        for st, ps in zip(self.stacked, self.per_slot):
            if st is not None:
                leaves.append(st[a:b])
            elif all(v is None for v in ps[a:b]):
                leaves.append(None)
            elif all(isinstance(v, torch.Tensor) for v in ps[a:b]):
                leaves.append(torch.stack(ps[a:b]))
            else:
                raise TypeError("the batched lowering needs tensor state "
                                "leaves")
        return tree_rebuild(self.template, leaves)

    def write_run(self, a: int, b: int, state) -> None:
        for i, leaf in enumerate(tree_leaves(state)):
            st = self.stacked[i]
            if st is not None:
                if leaf.data_ptr() != st[a:b].data_ptr():
                    st[a:b].copy_(leaf)
            elif leaf is not None:
                for j in range(b - a):
                    # a fresh allocation per slot, as the map lowering's
                    self.per_slot[i][a + j] = leaf[j].clone()


def _clone(x):
    return x.clone() if isinstance(x, torch.Tensor) else x


def _runs(slots) -> list:
    """Maximal runs of consecutive slot indices: ``[(a, b), ...]``."""
    out = []
    for s in sorted(slots):
        if out and out[-1][1] == s:
            out[-1][1] = s + 1
        else:
            out.append([s, s + 1])
    return [tuple(r) for r in out]


# ---------------------------------------------------------------------------
# the masked slab step
# ---------------------------------------------------------------------------

def make_slab_step(selector, impl: str, device: DeviceLike = None):
    """The bucket's step: ``step(slab, keys, requests) -> {slot:
    SlotResult}`` with host tensors in the result.

    ``requests`` maps slot -> :class:`SlotRequest`; only those slots are
    read and written (in place), every other slot keeps its state AND key
    bit for bit. Key use per processed request is the
    ``InteractiveSelector``'s: one split for ``select``, one for ``best``.
    ``impl``: ``map`` — slot by slot through the single-replica functions;
    ``batched`` — each maximal run of two or more consecutive requested
    slots as one replica batch through ``selector.batched`` (first the
    runs of the slots with a label, one batched update each, then the runs
    of every requested slot, one batched select and best each), a run of
    one slot as ``map`` does. The two are bitwise equal; the batched
    form's per-replica work is the seed batch the engine holds to its
    seeds run in turn."""
    impl = resolve_impl(impl)
    if impl == "batched" and selector.batched is None:
        raise ValueError("the batched lowering needs the method's batched "
                         "form")
    dev = resolve_device(device)
    get_pbest = selector.extras.get("get_pbest")

    def inputs(r: SlotRequest):
        # the InteractiveSelector's conversions of a label
        return (torch.tensor(r.idx, dtype=torch.int64, device=dev),
                torch.tensor(r.label, dtype=torch.int64, device=dev),
                torch.tensor(r.prob, dtype=torch.float32, device=dev))

    def digest(pb):
        """(max, entropy bits) of one slot's ``(H,)`` P(best), the flight
        recorder's digest; NaN without a posterior."""
        if pb is None:
            nan = torch.tensor(float("nan"), device=dev)
            return nan, nan
        pb = pb.to(torch.float32)
        return pb.max(), entropy2(pb)

    def step_map(slab, keys, requests):
        out = {}
        for slot in sorted(requests):
            r = requests[slot]
            state = slab.slot(slot)
            if r.do_update:
                state = selector.update(state, *inputs(r))
            key1, k_sel = trandom.split(keys[slot])
            key2, k_best = trandom.split(key1)
            res = selector.select(state, k_sel)
            best, b_stoch = selector.best(state, k_best)
            d_max, d_ent = digest(None if get_pbest is None
                                  else get_pbest(state))
            slab.write(slot, state, copy=False)
            keys[slot] = key2
            out[slot] = SlotResult(res.idx, res.prob, best,
                                   res.stochastic | b_stoch, d_max, d_ent)
        return out

    def step_batched(slab, keys, requests):
        bsel = selector.batched
        # a run of one slot takes the single-replica functions (kernel 2,
        # not kernel 5 at S = 1: faster on the card, and bitwise the same)
        singles = {a: requests[a] for a, b in _runs(requests) if b - a == 1}
        out = step_map(slab, keys, singles)
        requests = {s: r for s, r in requests.items() if s not in singles}
        for a, b in _runs(s for s, r in requests.items() if r.do_update):
            state = slab.run(a, b)
            idx, lab, prob = (torch.stack(t) for t in zip(
                *(inputs(requests[s]) for s in range(a, b))))
            slab.write_run(a, b, bsel.update(state, idx, lab, prob))
        for a, b in _runs(requests):
            state = slab.run(a, b)
            pairs = [trandom.split(keys[s]) for s in range(a, b)]
            k_sel = torch.stack([p[1] for p in pairs])
            res = bsel.select(state, bsel.select_keys(k_sel).to(dev))
            best, b_stoch = bsel.best(state)
            pb = None if get_pbest is None else get_pbest(state)
            for j, s in enumerate(range(a, b)):
                keys[s] = trandom.split(pairs[j][0])[0]
                d_max, d_ent = digest(None if pb is None else pb[j])
                out[s] = SlotResult(res.idx[j], res.prob[j], best[j],
                                    res.stochastic[j] | b_stoch[j], d_max,
                                    d_ent)
        return out

    run = step_batched if impl == "batched" else step_map

    def step(slab, keys, requests):
        out = run(slab, keys, requests)
        slots = sorted(out)
        # one host read a field for the whole dispatch
        host = {f: torch.stack([torch.as_tensor(getattr(out[s], f))
                                .to(dev) for s in slots]).cpu()
                for f in SlotResult._fields}
        return {s: SlotResult(*(host[f][j] for f in SlotResult._fields))
                for j, s in enumerate(slots)}

    return step


def _deactivate_padded(state, n_valid: int):
    """Mark a padded task's phantom items as already labeled (every state
    here carries the ``(N,) bool`` ``unlabeled`` mask all ``select``
    candidate sets pass through)."""
    if not hasattr(state, "unlabeled"):
        raise ValueError(
            f"selector state {type(state).__name__} has no 'unlabeled' "
            "mask; shape-padded buckets (bucket_n > 1) need it to disable "
            "the padded items — use bucket_n=1 for this method")
    N = state.unlabeled.shape[0]
    keep = torch.arange(N, device=state.unlabeled.device) < n_valid
    return state._replace(unlabeled=state.unlabeled & keep)


# ---------------------------------------------------------------------------
# bucket: one slab + its step
# ---------------------------------------------------------------------------

class Bucket:
    """Fixed-capacity slab of selector states for one (task, spec) pair.

    The selector is built once from the bucket's (padded) prediction
    tensor on ``device``, so its statics are computed at bucket creation.
    The slab is allocated here for all ``capacity`` slots (at the
    headline an incremental fp32 slot holds a 2.0 GB cache)."""

    def __init__(self, preds, spec: SelectorSpec, capacity: int,
                 n_valid: Optional[int] = None, task: str = "",
                 step_impl: Optional[str] = None, faults=None,
                 device: DeviceLike = None):
        self.task = task
        self.spec = spec
        self.capacity = int(capacity)
        self.step_impl = step_impl   # as requested (None = DEFAULT_IMPL)
        self.device = resolve_device(device)
        # serializes this bucket's slab ACCESS (the batcher's dispatch,
        # posterior reads); allocate/release stage their writes under
        # _host_lock instead and never wait out a dispatch
        self.lock = threading.RLock()
        self.preds = torch.as_tensor(np.asarray(preds, np.float32)).to(
            self.device)
        H, N, C = self.preds.shape
        self.shape = (H, N, C)
        self.n_valid = N if n_valid is None else int(n_valid)
        self.n_classes = C
        self.acq_batch = max(1, int(getattr(spec, "acq_batch", 1)))
        base = spec.factory(self.device)(self.preds)
        if self.acq_batch > 1:
            from coda_tpu_torch.selectors.batch import make_batched_selector

            self.selector = make_batched_selector(base, self.acq_batch)
        else:
            self.selector = base
        impl = resolve_impl(step_impl)
        if impl == "batched" and self.selector.batched is None:
            raise ValueError(
                f"bucket {task}/{spec.method}: step_impl={step_impl!r} "
                "needs the method's batched form, which this spec has not "
                "(eig_refresh='fused', the surrogate scorer and acq_batch "
                "> 1 run their slots one after another); use 'map'")
        self.impl = impl or (DEFAULT_IMPL if self.selector.batched
                             is not None else "map")
        self._step = make_slab_step(self.selector, self.impl, self.device)
        self._get_pbest = self.selector.extras.get("get_pbest")
        # cross-session surrogate prior (serve/priors.py): the applied-
        # prior record {"digest", "credit", <prior_to_dict fields>} new
        # admissions seed from, or None (set_prior); the restore paths
        # re-apply each session's recorded record instead
        self.prior: Optional[dict] = None
        self._copy_stream = None     # the snapshot/restore side stream
        self._staging = None         # pinned buffers for one slot's carries
        self._staging_lock = threading.Lock()
        # per large carry, the pageable host arrays payloads gave back
        self._host_free: dict = {}
        self._faults = faults        # optional FaultInjector
        self._init_state = None      # the cached key-independent init
        self._warm = False
        self.warm_s: Optional[float] = None
        self._n_warm = 0
        self.warm_hits = 0           # dispatches after warm()
        self.warm_misses = 0         # dispatches before it
        # ``quarantined``: the slab was lost to a step failure (the step
        # writes in place, so a failed one leaves its slots torn) and is
        # being rebuilt from the recorder streams; ``failed``: terminal
        self.failed: Optional[str] = None
        self.quarantined: Optional[str] = None
        self.heals = 0
        self.last_timing: dict = {}
        # the slab, every slot filled from one init (real sessions
        # overwrite their slot at admission)
        template = self.selector.init(trandom.PRNGKey(0))
        self._template = template
        self._carry_at = _tensor_positions(template)
        self._carry_paths = [tree_paths(template)[i] for i in self._carry_at]
        self._slab = _Slab(template, self.capacity)
        self.keys = [torch.zeros(2, dtype=torch.int64)
                     for _ in range(self.capacity)]
        self._host_lock = threading.Lock()
        # LIFO free list: a just-closed slot is the next one reused
        self._free = list(range(self.capacity - 1, -1, -1))
        # admission writes staged as (slot, state, key), applied under
        # ``lock`` at the next slab access
        self._staged: list = []

    def free(self) -> None:
        """Drop the bucket's device memory (the slab, the cached init and
        template, the predictions and the selector that closes over
        them) for a replica that is gone: whatever still references its
        objects (a caller's traceback, say) then holds no device memory.
        The bucket serves nothing after it."""
        with self.lock:
            self.failed = "freed"
            self._slab = self._template = self._init_state = None
            self.selector = self._step = self._get_pbest = None
            self.preds = None
            self._staged = []
            self.keys = []

    # -- the warm pool -----------------------------------------------------
    @property
    def is_warm(self) -> bool:
        return self._warm

    def impls(self) -> tuple:
        """The lowerings this bucket's dispatches may take (a batched
        bucket runs a lone slot as ``map`` does)."""
        return ("map", "batched") if self.impl == "batched" else ("map",)

    def warm(self) -> dict:
        """Build and load the kernels, and cache the init state.

        Probes whether ``init`` ignores its key (it does for every selector
        here: the state is a function of the predictions) and caches it, so
        an admission copies one state instead of building the cache; then
        runs one untimed start and label of each lowering on scratch slots
        (free slots, left garbage as a closed one is), which launches the
        update's kernels, and one posterior read. Returns {executables
        (the callables warmed), seconds}."""
        with self.lock:
            if self._warm:
                return {"executables": self._n_warm,
                        "seconds": self.warm_s or 0.0}
            t0 = time.perf_counter()
            other = self.selector.init(
                torch.tensor([0x9e3779b9, 0x85ebca6b], dtype=torch.int64))
            init_state = None
            if _bitwise_equal(self._template, other):
                init_state = self._template
                if self.n_valid < self.shape[1]:
                    init_state = _deactivate_padded(init_state,
                                                    self.n_valid)
            del other
            n = 1
            with self._host_lock:
                free = sorted(self._free)
            # scratch slots: the lowest free one, and a run of two for the
            # batched lowering (whose lone slots take the map functions)
            pair = next(([s, s + 1] for s in free if s + 1 in free), None)
            self._init_state = init_state
            for impl in self.impls():
                slots = pair if impl == "batched" else free[:1]
                if not slots:
                    continue
                step = make_slab_step(self.selector, impl, self.device)
                for s in slots:
                    state, key = self._fresh_slot_state(0)
                    self._slab.write(s, state, copy=True)
                    self.keys[s] = key
                start = step(self._slab, self.keys, {
                    s: SlotRequest(False, 0, 0, 0.0) for s in slots})
                step(self._slab, self.keys, {s: SlotRequest(
                    True, r.next_idx.tolist(),
                    [0] * self.acq_batch if self.acq_batch > 1 else 0,
                    r.next_prob.tolist()) for s, r in start.items()})
                n += 1
            if self._get_pbest is not None and free:
                self.pbest(free[0])
                n += 1
            self._init_state = init_state
            if self.device.type == "cuda":
                torch.cuda.synchronize(self.device)
            self.warm_s = time.perf_counter() - t0
            self._n_warm = n
            self._warm = True
            return {"executables": n, "seconds": self.warm_s}

    def _check_available(self) -> None:
        """Raise attributably when the slab cannot be touched."""
        if self.failed is not None:
            raise RuntimeError(
                f"bucket {self.task}/{self.spec.method} is failed "
                f"(restart to recover): {self.failed}")
        if self.quarantined is not None:
            raise BucketQuarantined(
                f"bucket {self.task}/{self.spec.method} is quarantined "
                f"(slab rebuild in progress, retry shortly): "
                f"{self.quarantined}")

    def _fresh_slot_state(self, seed: int, prior: Optional[dict] = None):
        """Reference-choreography ``(state, key)`` for a new session:
        ``PRNGKey(seed)``, init consumes one split (always — even when the
        cached init state makes its value moot). The state may be the
        shared cached init: writers copy it.

        ``prior`` (an applied-prior record, :meth:`set_prior`) seeds the
        state's surrogate fit from the cross-session pool; the caller owns
        replay consistency (a restore passes the record the session was
        admitted under)."""
        key, sub = trandom.split(trandom.PRNGKey(seed))
        if self._init_state is not None:
            state = self._init_state
        else:
            state = self.selector.init(sub)
            if self.n_valid < self.shape[1]:
                state = _deactivate_padded(state, self.n_valid)
        if prior is not None and getattr(state, "surrogate",
                                         None) is not None:
            from coda_tpu_torch.selectors.surrogate import (prior_from_dict,
                                                            seed_fit)

            state = state._replace(surrogate=seed_fit(
                state.surrogate, prior_from_dict(prior)))
        return state, key

    def set_prior(self, stats) -> Optional[dict]:
        """Install (or clear, with None) the pool prior new admissions
        seed from; returns the applied-prior record now in force."""
        from coda_tpu_torch.selectors.surrogate import (prior_digest,
                                                        prior_to_dict,
                                                        prior_warmup_credit)

        if stats is None or getattr(stats, "n", 0) <= 0:
            self.prior = None
        else:
            rec = prior_to_dict(stats)
            rec["digest"] = prior_digest(stats)
            rec["credit"] = prior_warmup_credit(stats)
            self.prior = rec
        return self.prior

    # -- slot lifecycle (no bucket lock: slab writes are staged) ------------
    def allocate(self, seed: int, prior: Optional[dict] = None) -> int:
        """Take a free slot and stage its fresh state (no dispatch lock:
        admission never waits out an in-flight slab step); ``prior`` as
        in :meth:`_fresh_slot_state`."""
        self._check_available()
        with self._host_lock:
            if not self._free:
                raise SlabFull(
                    f"bucket {self.task}/{self.spec.method}: all "
                    f"{self.capacity} slots live")
            slot = self._free.pop()
        state, key = self._fresh_slot_state(seed, prior=prior)
        with self._host_lock:
            self._staged.append((slot, state, key))
        return slot

    def release(self, slot: int) -> None:
        """Return a slot to the free list; drops any still-staged write for
        it. The slot's state stays garbage until reallocation."""
        with self._host_lock:
            self._staged = [(s, st, k) for s, st, k in self._staged
                            if s != slot]
            self._free.append(slot)

    def _apply_staged(self) -> None:
        """Write staged admissions into the slab (caller holds ``lock``)."""
        with self._host_lock:
            staged, self._staged = self._staged, []
        for slot, state, key in staged:
            self._slab.write(slot, state, copy=True)
            self.keys[slot] = key

    @property
    def live(self) -> int:
        with self._host_lock:
            return self.capacity - len(self._free)

    def live_slots(self) -> list:
        with self._host_lock:
            free = set(self._free)
        return [s for s in range(self.capacity) if s not in free]

    # -- the dispatch (batcher thread, holding this bucket's lock) ---------
    def dispatch(self, requests: dict, _healing: bool = False) -> dict:
        """Run ONE masked step over the requested slots.

        ``requests``: slot -> dict(do_update, idx, label, prob). Only
        requesting slots advance state and key; no other slot is read or
        written. Returns slot -> result dict (host scalars, q-wide lists at
        ``acq_batch`` q > 1). ``_healing`` is the rebuild path's override
        of the quarantine check. Phase wall times land in ``last_timing``
        (build = host input prep, step = the step through its host
        read)."""
        if _healing:
            if self.failed is not None:
                raise RuntimeError(
                    f"bucket {self.task}/{self.spec.method} is failed "
                    f"(restart to recover): {self.failed}")
        else:
            self._check_available()
        t0 = time.perf_counter()
        self._apply_staged()  # admissions since the last slab access
        reqs = {int(s): _slot_request(r) for s, r in requests.items()}
        t1 = time.perf_counter()
        if self._warm:
            self.warm_hits += 1
        else:
            self.warm_misses += 1
        if self._faults is not None:
            self._faults.fire("step_pre", task=self.task)  # slow_step
        try:
            out = self._step(self._slab, self.keys, reqs)
            if self._faults is not None:
                # step_raise injects HERE: the step has written its slots
                # in place — the production failure quarantine recovers
                self._faults.fire("step_post", task=self.task)
        except BaseException as e:
            # the step writes the slab in place: a failure part way leaves
            # the requested slots torn (and an injected one after the
            # step leaves them ahead of their streams), so the slab is
            # rebuilt from the sessions' recorder streams
            self.quarantined = (f"slab step failed after writing the slab "
                                f"in place: {e!r}")
            raise
        poison = (self._faults is not None and "step_nan" in
                  self._faults.fire("step_out", task=self.task))
        t2 = time.perf_counter()
        self.last_timing = {"build_s": t1 - t0, "step_s": t2 - t1}
        has_digest = self._get_pbest is not None

        results = {}
        for slot, r in out.items():
            row = {
                # q-wide buckets propose (q,) points: plain lists
                "next_idx": r.next_idx.tolist(),
                "next_prob": r.next_prob.tolist(),
                "best": int(r.best),
                "stochastic": bool(r.stochastic),
                "pbest_max": float(r.pbest_max) if has_digest else None,
                "pbest_entropy": (float(r.pbest_entropy) if has_digest
                                  else None),
            }
            if poison:
                # simulated numeric corruption the digest verification
                # must catch (the silent-degradation probe)
                nan = float("nan")
                row["next_prob"] = ([nan] * self.acq_batch
                                    if self.acq_batch > 1 else nan)
                if has_digest:
                    row["pbest_max"] = row["pbest_entropy"] = nan
            results[slot] = row
        return results

    # -- cheap per-session reads ------------------------------------------
    def slot_state(self, slot: int):
        self._apply_staged()  # a pre-first-dispatch read must see its init
        return self._slab.slot(slot)

    def surrogate_stats(self) -> Optional[dict]:
        """Surrogate-scorer counters summed over LIVE slots, or None when
        the bucket runs the exact scorer (an on-demand read under the
        dispatch lock)."""
        if getattr(self._template, "surrogate", None) is None:
            return None
        with self.lock:
            self._apply_staged()
            live = self.live_slots()
            fits = [self._slab.slot(s).surrogate for s in live]

            def _host(name):
                return np.asarray([float(getattr(f, name)) for f in fits])

            rounds, fallbacks, refolds, margins, prounds, prejects = (
                _host(n) for n in ("rounds", "fallbacks", "fits", "margin",
                                   "prior_rounds", "prior_rejects"))
        if not live:
            return {"rounds": 0, "fallbacks": 0, "fit_refreshes": 0,
                    "contract_margin": None, "prior_rounds": 0,
                    "prior_rejects": 0}
        active = margins[rounds > 0]
        finite = active[np.isfinite(active)]
        return {"rounds": int(rounds.sum()),
                "fallbacks": int(fallbacks.sum()),
                "fit_refreshes": int(refolds.sum()),
                "contract_margin": (float(finite.min()) if finite.size
                                    else None),
                # the prior evidence pair: warmup rounds the pool credited
                # to live sessions, gate rejections inside that credit
                "prior_rounds": int(prounds.sum()),
                "prior_rejects": int(prejects.sum())}

    def pbest(self, slot: int):
        """P(model is best) for one slot (the method's ``get_pbest``), as
        a host array — the posterior read behind GET /best. Caller holds
        ``lock``."""
        if self._get_pbest is None:
            return None
        self._check_available()
        return self._get_pbest(self.slot_state(slot)).detach().cpu().numpy()

    def pbest_rows(self, slots) -> Optional[np.ndarray]:
        """The ``(len(slots), H)`` P(best) of many slots with one stacked
        gather and ONE device-to-host copy (the quality plane's per-tick
        read; each row is the same fp32 words :meth:`pbest` reads), or
        None when the method exposes no posterior. Caller holds ``lock``."""
        if self._get_pbest is None:
            return None
        self._check_available()
        self._apply_staged()
        rows = [self._get_pbest(self._slab.slot(int(s))) for s in slots]
        return torch.stack(rows).detach().cpu().numpy()

    def digest(self, slot: int):
        """(pbest_max, pbest_entropy) of one slot's CURRENT state, or None
        when the method exposes no posterior — the two float32 words the
        step emits. Caller holds ``lock``."""
        if self._get_pbest is None:
            return None
        pb = self._get_pbest(self.slot_state(slot)).to(torch.float32)
        return float(pb.max()), float(entropy2(pb))

    def fit_from_leaves(self, leaves) -> Optional[dict]:
        """The surrogate fit's pool-contribution statistics ``{"A", "b",
        "n", "rounds", "fits"}`` from HOST snapshot leaves (the demotion
        snapshot already holds them: no device read), or None when the
        bucket's selector carries no fit."""
        if getattr(self._template, "surrogate", None) is None:
            return None
        where = {p[-1]: i for i, p in enumerate(self._carry_paths)
                 if p[0] == "surrogate"}
        try:
            return {k: np.asarray(leaves[where[k]])
                    for k in ("A", "b", "n", "rounds", "fits")}
        except (KeyError, IndexError):
            return None

    def slot_fit(self, slot: int) -> Optional[dict]:
        """One LIVE slot's fit contribution statistics as host arrays (the
        close-time pool contribution's read), or None."""
        if getattr(self._template, "surrogate", None) is None:
            return None
        with self.lock:
            fit = self.slot_state(slot).surrogate
            return {k: getattr(fit, k).detach().cpu().numpy().copy()
                    for k in ("A", "b", "n", "rounds", "fits")}

    def _carries(self, slot: int) -> list:
        """Slot ``slot``'s tensor leaves (views of the slab, or the slot's
        own tensors), in carry order."""
        leaves = tree_leaves(self._slab.slot(slot))
        return [leaves[i] for i in self._carry_at]

    def carry_nbytes(self) -> int:
        """The bytes of one slot's carries (an export's snapshot)."""
        tmpl = tree_leaves(self._template)
        return sum(tmpl[i].numel() * tmpl[i].element_size()
                   for i in self._carry_at)

    def _side_stream(self):
        if self._copy_stream is None:
            self._copy_stream = torch.cuda.Stream(device=self.device)
        return self._copy_stream

    def _stage(self) -> list:
        """The pinned staging buffers, one per carry of one slot, pinned
        at first use (caller holds ``_staging_lock``)."""
        if self._staging is None:
            tmpl = tree_leaves(self._template)
            self._staging = [torch.empty(tmpl[i].shape, dtype=tmpl[i].dtype,
                                         pin_memory=True)
                             for i in self._carry_at]
        return self._staging

    def _to_stage(self, slot: int, hold: bool):
        """Queue slot ``slot``'s carries into the staging buffers on the
        side stream and wait for them; the key copied. The dispatch lock is
        taken to order the copy after the work queued on the slab, and
        held until the copy has landed only with ``hold`` (caller holds
        ``_staging_lock``)."""
        stream, stage = self._side_stream(), self._stage()
        with self.lock:
            self._check_available()
            self._apply_staged()
            stream.wait_stream(torch.cuda.current_stream(self.device))
            with torch.cuda.stream(stream):
                for h, x in zip(stage, self._carries(slot)):
                    h.copy_(x, non_blocking=True)
                    # a dispatch may replace the slot's own small tensors
                    # meanwhile: keep their memory until the copy read it
                    x.record_stream(stream)
            key = self.keys[slot].clone().numpy()
            if hold:
                stream.synchronize()
        stream.synchronize()
        return key

    def snapshot_slot(self, slot: int):
        """Host copies of one slot's ``(carries, key)``, consistent by
        themselves (the export path's): the copy completes under the
        dispatch lock (the next dispatch writes the slab in place). On the
        card it lands in the pinned staging buffers (the device's copy
        rate, not a pageable copy's) and is copied out after the lock is
        released."""
        if self.device.type != "cuda":
            with self.lock:
                self._check_available()
                self._apply_staged()
                return ([x.detach().clone().numpy()
                         for x in self._carries(slot)],
                        self.keys[slot].clone().numpy())
        with self._staging_lock:
            key = self._to_stage(slot, hold=True)
            return self._from_stage(), key

    def _from_stage(self) -> list:
        """Pageable host copies of the staging buffers (caller holds
        ``_staging_lock``). Fresh memory copies at the rate of its page
        faults (about 2.5 GB/s on the card's host), so a large carry goes
        into a host array a dead payload gave back (:class:`_Lease`; at
        most ``capacity`` kept a carry) when there is one. Pre-faulting
        fresh memory (``MAP_POPULATE``) instead held the process's
        memory-map lock for the whole copy and stalled the dispatches
        (PERF.md §6)."""
        out = []
        for i, h in enumerate(self._stage()):
            src = h.numpy()
            if src.nbytes < _HOST_POOL_MIN_BYTES:
                out.append(src.copy())
                continue
            free = self._host_free.setdefault(i, [])
            try:
                arr = free.pop()
            except IndexError:
                arr = np.empty(src.shape, src.dtype)
            np.copyto(arr, src)
            lease = _Lease(arr)
            weakref.finalize(lease, _give_back, free, arr, self.capacity)
            out.append(np.frombuffer(lease, dtype=arr.dtype)
                       .reshape(arr.shape))
        return out

    def snapshot_slots(self, slots) -> dict:
        """Host copies of MANY slots' ``(carries, key)``, copying only the
        named slots: ``{slot: (leaves, key)}`` (the tiers' demotion).

        On the card the copies go slot by slot through the pinned
        staging buffers on a side stream, the dispatch lock held only to
        order each copy after the work queued, then into pageable host
        memory, reused from dead payloads where it can be (no lock, no
        GIL): dispatches of other slots run during the copies, and host
        memory is pinned once (one slot's worth), never a session at a
        time. On the CPU the copies run under the lock.

        A slot written by a dispatch during its (unlocked) copy is torn:
        the tiers' demotion discards it (that dispatch carried a label, so
        the pin or label-count re-check fails), and a heal during the
        copies (which rewrites every slot) voids the whole snapshot."""
        slots = sorted({int(s) for s in slots})
        if not slots:
            return {}
        if self.device.type != "cuda":
            with self.lock:
                self._check_available()
                self._apply_staged()
                return {s: ([x.detach().clone().numpy()
                             for x in self._carries(s)],
                            self.keys[s].clone().numpy()) for s in slots}
        heals0 = self.heals
        out = {}
        with self._staging_lock:
            for s in slots:
                key = self._to_stage(s, hold=False)
                out[s] = (self._from_stage(), key)
        if self.heals != heals0 or self.quarantined is not None:
            raise BucketQuarantined(
                f"bucket {self.task}/{self.spec.method} was healed during "
                "a snapshot; the snapshot is void")
        return out

    def restore_slot(self, slot: int, leaves, key) -> None:
        """Write imported host ``(leaves, key)`` into an ALLOCATED slot's
        existing tensors (``copy_``; no tensor is allocated for the slot).
        The slot's staged fresh init is dropped; the dispatch lock is
        taken only to order the copy after any slab write already queued
        (no dispatch touches an unrequested slot, and a restoring session
        is gated). On the card the upload runs on a side stream through
        the pinned staging buffers; this returns once it has landed. Raises
        ValueError when the leaves are not this bucket's state structure
        (order, shapes, dtypes)."""
        if len(leaves) != len(self._carry_at):
            raise ValueError(
                f"snapshot carries {len(leaves)} leaves; this bucket's "
                f"state has {len(self._carry_at)}")
        srcs = [_host_tensor(a) for a in leaves]
        tmpl = tree_leaves(self._template)
        for got, want in zip(srcs, (tmpl[i] for i in self._carry_at)):
            if tuple(got.shape) != tuple(want.shape) \
                    or got.dtype != want.dtype:
                raise ValueError(
                    f"snapshot leaf {got.dtype}{tuple(got.shape)} != bucket "
                    f"state leaf {want.dtype}{tuple(want.shape)}")
        with self._host_lock:
            self._staged = [(s, st, k) for s, st, k in self._staged
                            if s != slot]
        cuda = self.device.type == "cuda"
        with self.lock:
            # a dispatch that applied this slot's staged init before the
            # drop above has queued its copy by now
            dsts = self._carries(slot)
            if cuda:
                stream = self._side_stream()
                stream.wait_stream(torch.cuda.current_stream(self.device))
        if not cuda:
            for dst, src in zip(dsts, srcs):
                dst.copy_(src)
        else:
            with self._staging_lock:
                stage = self._stage()
                for h, src in zip(stage, srcs):
                    h.copy_(src)
                with torch.cuda.stream(stream):
                    for dst, h in zip(dsts, stage):
                        dst.copy_(h, non_blocking=True)
                stream.synchronize()
        self.keys[slot] = torch.as_tensor(np.asarray(key).copy(),
                                          dtype=torch.int64)

    def slot_digest(self, slot: int) -> str:
        """:func:`state_digest` of one slot's state and key."""
        with self.lock:
            self._apply_staged()
            return state_digest(self._slab.slot(slot), self.keys[slot])

    # -- heal and restore support (serve/recovery.py drives these) ---------
    def stage_fresh(self, slot: int, seed: int,
                    prior: Optional[dict] = None) -> None:
        """Stage a fresh state for an ALLOCATED slot — the replay entry
        point: replay starts from the reference init (staged rows apply in
        order, last write wins). ``prior`` re-applies the applied-prior
        record the session was ADMITTED under, so a prior-seeded
        session's replay reproduces its init bitwise."""
        state, key = self._fresh_slot_state(seed, prior=prior)
        with self._host_lock:
            self._staged.append((slot, state, key))

    def reset_slab(self) -> None:
        """Forget a slab lost to a failed step (the heal path's first
        move; the caller holds ``lock`` and then restages and replays every
        live slot, which overwrites each slot's state whole)."""
        with self._host_lock:
            self._staged = []
        for s in range(self.capacity):
            self.keys[s] = torch.zeros(2, dtype=torch.int64)


def _slot_request(r: dict) -> SlotRequest:
    """A request dict as a :class:`SlotRequest`."""
    if not r.get("do_update"):
        return SlotRequest(False, 0, 0, 0.0)
    return SlotRequest(True, r["idx"], r["label"], r["prob"])


def _bitwise_equal(a, b) -> bool:
    """Two states leaf for leaf, bit for bit."""
    for x, y in zip(tree_leaves(a), tree_leaves(b)):
        if isinstance(x, torch.Tensor):
            if (not isinstance(y, torch.Tensor) or x.shape != y.shape
                    or x.dtype != y.dtype):
                return False
            if x.numel() and not torch.equal(
                    x.reshape(-1).view(torch.uint8),
                    y.reshape(-1).view(torch.uint8)):
                return False
        elif x != y:
            return False
    return True


# ---------------------------------------------------------------------------
# session store
# ---------------------------------------------------------------------------

@dataclass
class Session:
    """Host-side record of one live interactive session."""

    sid: str
    task: str
    bucket: Bucket
    slot: int
    seed: int
    n_labeled: int = 0
    last: dict = field(default_factory=dict)  # most recent result row
    # idempotent-label bookkeeping: client request_id -> the committed
    # result row (bounded LRU), and -> the in-flight Ticket
    recent: dict = field(default_factory=dict)
    pending: dict = field(default_factory=dict)
    # the crowd's answers of the CURRENT round (POST /session/{id}/
    # answer): slot -> {label, request_id, seq}, and the arrival counter.
    # When all acq_batch slots are filled the park drains through ONE
    # batch-label dispatch in slot order under a synthetic request_id.
    # Mutated under the store lock; park rows in the stream and the
    # export payload's ``parked`` carry them across restore and migration
    parked: dict = field(default_factory=dict)
    park_seq: int = 0
    # set while import/restore is mid-replay: the sid resolves, but label
    # dispatches answer a retryable 503 until the posterior and the dedupe
    # cache are rebuilt
    restoring: bool = False
    # ownership epoch of the fleet's fence: 0 until a migration or a
    # peer page moves the session, carried verbatim by export/import,
    # demote/wake and the streams
    epoch: int = 0
    # in-flight verbs holding the session (a demotion needs exactly its
    # own pin, so it loses every race against live traffic), and its last
    # use (the tiers' LRU axis). Both mutate under the store lock.
    pins: int = 0
    last_used: float = field(default_factory=time.monotonic)
    # the applied-prior record the session's fit was seeded from at
    # admission (None = cold init); rides the stream meta and the export
    # payload so every replay re-applies the same prior
    prior_fit: Optional[dict] = None
    # whether the session's fit was folded into the pool (exactly once:
    # at close or at demotion)
    prior_contributed: bool = False


def _round_up(n: int, quantum: int) -> int:
    return ((n + quantum - 1) // quantum) * quantum


class SessionStore:
    """Multiplexes sessions onto per-(task, spec, shape) slabs.

    ``capacity`` bounds EACH bucket's slab (admission past it raises
    :class:`SlabFull` — the server's 503). ``bucket_n`` is the N-padding
    quantum (1 = exact shapes). Locks in three tiers, as the reference's:
    the store lock guards the host dicts; each bucket's dispatch lock
    serializes slab access (admission and close stage their writes under
    the bucket's host mutex instead); bucket construction runs under a
    build lock with no other lock held."""

    def __init__(self, capacity: int = 64, bucket_n: int = 1,
                 step_impl: Optional[str] = None, faults=None,
                 device: DeviceLike = None):
        if capacity < 1:
            raise ValueError("capacity must be >= 1")
        if bucket_n < 1:
            raise ValueError("bucket_n must be >= 1")
        resolve_impl(step_impl)
        self.capacity = capacity
        self.bucket_n = bucket_n
        self.step_impl = step_impl
        self.faults = faults
        self.device = resolve_device(device)
        # bucket -> PriorStats or None: ServeApp installs the pool lookup
        # so a bucket built after a pool was loaded seeds at once
        self.prior_resolver = None
        self._tasks: dict[str, Any] = {}     # name -> (H, N, C) ndarray
        self._meta: dict[str, dict] = {}
        self._buckets: dict[tuple, Bucket] = {}
        self._sessions: dict[str, Session] = {}
        self.lock = threading.RLock()
        self._build_lock = threading.Lock()

    # -- tasks -------------------------------------------------------------
    def register_task(self, name: str, preds, class_names=None,
                      model_names=None) -> None:
        if isinstance(preds, torch.Tensor):
            preds = preds.detach().cpu().numpy()
        preds = np.asarray(preds, np.float32)
        if preds.ndim != 3:
            raise ValueError(f"preds must be (H, N, C), got {preds.shape}")
        from coda_tpu_torch.telemetry.recorder import dataset_digest

        with self.lock:
            self._tasks[name] = preds
            H, N, C = preds.shape
            self._meta[name] = {
                "class_names": list(class_names
                                    or [f"class {c}" for c in range(C)]),
                "model_names": list(model_names
                                    or [f"model {h}" for h in range(H)]),
                "shape": [H, N, C],
                "digest": dataset_digest(preds),
            }

    def tasks(self) -> list[str]:
        with self.lock:
            return sorted(self._tasks)

    def task_meta(self, name: str) -> dict:
        with self.lock:
            return dict(self._meta[name])

    def task_preds(self, name: str):
        with self.lock:
            return self._tasks.get(name)

    def has_fast_admission(self, task: str, spec: SelectorSpec) -> bool:
        """Whether admission for this (task, spec) is host work only: the
        bucket exists, warm() cached its init state, and a slot is free
        (the front door's inline fast-path test)."""
        with self.lock:
            preds = self._tasks.get(task)
            if preds is None:
                return False
            H, N, C = preds.shape
            key = (task, spec, (H, _round_up(N, self.bucket_n), C))
            b = self._buckets.get(key)
        if b is None or b._init_state is None:
            return False
        with b._host_lock:
            return len(b._free) > 0

    def _bucket_for(self, task: str, spec: SelectorSpec) -> Bucket:
        with self.lock:
            preds = self._tasks[task]
        H, N, C = preds.shape
        n_pad = _round_up(N, self.bucket_n)
        key = (task, spec, (H, n_pad, C))
        with self.lock:
            b = self._buckets.get(key)
        if b is not None:
            return b
        with self._build_lock:
            with self.lock:
                b = self._buckets.get(key)
            if b is not None:
                return b
            if n_pad != N:
                preds = np.pad(preds, ((0, 0), (0, n_pad - N), (0, 0)))
            b = Bucket(preds, spec, self.capacity, n_valid=N, task=task,
                       step_impl=self.step_impl, faults=self.faults,
                       device=self.device)
            if self.prior_resolver is not None:
                try:
                    b.set_prior(self.prior_resolver(b))
                except Exception:
                    pass  # the pool never blocks a bucket build
            with self.lock:
                self._buckets[key] = b
            return b

    # -- sessions ----------------------------------------------------------
    def open(self, task: str, spec: SelectorSpec, seed: int = 0,
             sid: Optional[str] = None, restoring: bool = False,
             prior="pool") -> Session:
        """Admit a session. ``sid`` pins its id (import and restore keep
        the client's handle); ``restoring`` publishes it already gated.
        ``prior``: ``"pool"`` seeds a new session's surrogate fit from the
        bucket's pool prior (none until ``Bucket.set_prior``), an
        applied-prior record re-applies exactly that one (the restore
        paths), None forces a cold init."""
        with self.lock:
            if task not in self._tasks:
                raise KeyError(f"unknown task {task!r}; registered: "
                               f"{self.tasks()}")
            if sid is not None and sid in self._sessions:
                raise ValueError(f"session id {sid!r} already live here")
        bucket = self._bucket_for(task, spec)
        # resolved ONCE: the seeding and the recorded prior_fit agree
        applied = bucket.prior if prior == "pool" else prior
        slot = bucket.allocate(seed, prior=applied)  # raises SlabFull
        sess = Session(sid=sid or secrets.token_hex(8), task=task,
                       bucket=bucket, slot=slot, seed=seed,
                       restoring=restoring, prior_fit=applied)
        with self.lock:
            if sess.sid in self._sessions:
                bucket.release(slot)
                raise ValueError(f"session id {sess.sid!r} already live "
                                 "here")
            self._sessions[sess.sid] = sess
        return sess

    def get(self, sid: str) -> Session:
        with self.lock:
            sess = self._sessions.get(sid)
            if sess is None:
                raise UnknownSession(sid)
            return sess

    def get_pinned(self, sid: str) -> Session:
        """Atomic lookup + pin (every caller unpins on every exit path)."""
        with self.lock:
            sess = self._sessions.get(sid)
            if sess is None:
                raise UnknownSession(sid)
            sess.pins += 1
            sess.last_used = time.monotonic()
            return sess

    def pin(self, sess: Session) -> None:
        with self.lock:
            sess.pins += 1

    def unpin(self, sess: Session) -> None:
        with self.lock:
            sess.pins = max(0, sess.pins - 1)

    def slab_occupancy(self) -> int:
        return sum(b.live for b in self.buckets())

    def alive(self, sid: str) -> bool:
        with self.lock:
            return sid in self._sessions

    def close(self, sid: str) -> None:
        with self.lock:
            sess = self._sessions.pop(sid, None)
        if sess is None:
            raise UnknownSession(sid)
        sess.bucket.release(sess.slot)

    def live_sessions(self) -> int:
        with self.lock:
            return len(self._sessions)

    def buckets(self) -> list[Bucket]:
        with self.lock:
            return list(self._buckets.values())

    def sessions_on(self, bucket: Bucket) -> list[Session]:
        """The live sessions riding one bucket's slab (the heal path's
        worklist)."""
        with self.lock:
            return [s for s in self._sessions.values()
                    if s.bucket is bucket]
