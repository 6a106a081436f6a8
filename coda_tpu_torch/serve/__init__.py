"""Batched multi-session serving of interactive active model selection on
the card (counterpart of ``coda_tpu/serve`` but the fleet).

Many concurrent human-in-the-loop selection sessions share one device: a
fixed-capacity slab of selector states per (task, config) with a masked
step in two lowerings (:mod:`~coda_tpu_torch.serve.state`), a
continuous-batching dispatcher that runs one step per bucket per tick
(:mod:`~coda_tpu_torch.serve.batcher`), a dependency-free asyncio
HTTP/JSON front door with admission control and a warm-pool readiness
gate (:mod:`~coda_tpu_torch.serve.server`), per-dispatch metrics
(:mod:`~coda_tpu_torch.serve.metrics`), export/import, crash restore and
bucket self-healing from the recorder streams
(:mod:`~coda_tpu_torch.serve.recovery`), the hot/warm/cold session tiers
(:mod:`~coda_tpu_torch.serve.tiering`) over the cold tier's spill store
(:mod:`~coda_tpu_torch.serve.spill`), the cross-session surrogate prior
pool (:mod:`~coda_tpu_torch.serve.priors`) and the deterministic
fault-injection harness that exercises them
(:mod:`~coda_tpu_torch.serve.faults`). The fleet (router, replicas,
migration) is slice 9 of the port.
"""

from coda_tpu_torch.serve.batcher import Batcher, Ticket
from coda_tpu_torch.serve.faults import FaultInjected, FaultInjector
from coda_tpu_torch.serve.metrics import ServeMetrics
from coda_tpu_torch.serve.priors import PriorPool
from coda_tpu_torch.serve.recovery import (
    SESSION_EXPORT_VERSION,
    BucketHealer,
    ImportRejected,
    ReplayMismatch,
    check_row,
    export_all,
    export_session,
    heal_bucket,
    import_session,
    restore_app_sessions,
    verify_session_stream,
)
from coda_tpu_torch.serve.server import (
    AsyncHTTPServer,
    ServeApp,
    build_app,
    make_server,
)
from coda_tpu_torch.serve.spill import SpillStore
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
from coda_tpu_torch.serve.tiering import TierManager

__all__ = [
    "SESSION_EXPORT_VERSION",
    "AsyncHTTPServer",
    "Batcher",
    "Bucket",
    "BucketHealer",
    "BucketQuarantined",
    "FaultInjected",
    "FaultInjector",
    "ImportRejected",
    "PriorPool",
    "ReplayMismatch",
    "SelectorSpec",
    "ServeApp",
    "ServeMetrics",
    "Session",
    "SessionStore",
    "SlabFull",
    "SlotRequest",
    "SlotResult",
    "SpillStore",
    "StaleOwner",
    "TierManager",
    "Ticket",
    "UnknownSession",
    "build_app",
    "check_row",
    "export_all",
    "export_session",
    "heal_bucket",
    "import_session",
    "make_server",
    "restore_app_sessions",
    "verify_session_stream",
]
