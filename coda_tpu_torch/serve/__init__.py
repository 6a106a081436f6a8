"""Batched multi-session serving of interactive active model selection on
the card (counterpart of ``coda_tpu/serve``, slice 8a of the port).

Many concurrent human-in-the-loop selection sessions share one device: a
fixed-capacity slab of selector states per (task, config) with a masked
step in two lowerings (:mod:`~coda_tpu_torch.serve.state`), a
continuous-batching dispatcher that runs one step per bucket per tick
(:mod:`~coda_tpu_torch.serve.batcher`), a dependency-free asyncio
HTTP/JSON front door with admission control and a warm-pool readiness
gate (:mod:`~coda_tpu_torch.serve.server`), per-dispatch metrics
(:mod:`~coda_tpu_torch.serve.metrics`), bucket self-healing from the
recorder streams (:mod:`~coda_tpu_torch.serve.recovery`) and the
deterministic fault-injection harness that exercises it
(:mod:`~coda_tpu_torch.serve.faults`).

Slice 8b of the port brings export/import and crash restore, the session
tiers, the prior pool and the quality plane; slice 9 the fleet.
"""

from coda_tpu_torch.serve.batcher import Batcher, Ticket
from coda_tpu_torch.serve.faults import FaultInjected, FaultInjector
from coda_tpu_torch.serve.metrics import ServeMetrics
from coda_tpu_torch.serve.recovery import (
    BucketHealer,
    ReplayMismatch,
    check_row,
    heal_bucket,
)
from coda_tpu_torch.serve.server import (
    AsyncHTTPServer,
    ServeApp,
    build_app,
    make_server,
)
from coda_tpu_torch.serve.state import (
    Bucket,
    BucketQuarantined,
    SelectorSpec,
    Session,
    SessionStore,
    SlabFull,
    SlotRequest,
    SlotResult,
    StaleOwner,
    UnknownSession,
    make_slab_step,
)

__all__ = [
    "AsyncHTTPServer",
    "Batcher",
    "Bucket",
    "BucketHealer",
    "BucketQuarantined",
    "FaultInjected",
    "FaultInjector",
    "ReplayMismatch",
    "SelectorSpec",
    "ServeApp",
    "ServeMetrics",
    "Session",
    "SessionStore",
    "SlabFull",
    "SlotRequest",
    "SlotResult",
    "StaleOwner",
    "Ticket",
    "UnknownSession",
    "build_app",
    "check_row",
    "heal_bucket",
    "make_server",
]
