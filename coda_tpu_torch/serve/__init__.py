"""Batched multi-session serving of interactive active model selection on
the card (counterpart of ``coda_tpu/serve``).

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
(:mod:`~coda_tpu_torch.serve.faults`). The fleet puts N replicas behind
one session router (:mod:`~coda_tpu_torch.serve.router`: rendezvous
placement, health-driven routing, the journaled migration of
:mod:`~coda_tpu_torch.serve.journal`, every verb through the hardened
transport of :mod:`~coda_tpu_torch.serve.transport`) and manages their
lifecycle (:mod:`~coda_tpu_torch.serve.fleet`: rolling restart, peer
paging, kill and revive).
"""

from coda_tpu_torch.serve.batcher import Batcher, Ticket
from coda_tpu_torch.serve.faults import FaultInjected, FaultInjector
from coda_tpu_torch.serve.fleet import Fleet, build_fleet
from coda_tpu_torch.serve.journal import MigrationJournal, payload_digest
from coda_tpu_torch.serve.metrics import ServeMetrics
from coda_tpu_torch.serve.priors import PriorPool
from coda_tpu_torch.serve.router import (
    DeadReplica,
    HttpReplica,
    InprocReplica,
    SessionRouter,
    rendezvous_owner,
    rendezvous_rank,
)
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
from coda_tpu_torch.serve.transport import (
    VERB_DEADLINES,
    CircuitBreaker,
    ReplicaTransport,
    ReplicaUnavailable,
    RetryBudget,
)

__all__ = [
    "SESSION_EXPORT_VERSION",
    "VERB_DEADLINES",
    "AsyncHTTPServer",
    "Batcher",
    "Bucket",
    "BucketHealer",
    "BucketQuarantined",
    "CircuitBreaker",
    "DeadReplica",
    "FaultInjected",
    "FaultInjector",
    "Fleet",
    "HttpReplica",
    "ImportRejected",
    "InprocReplica",
    "MigrationJournal",
    "PriorPool",
    "ReplayMismatch",
    "ReplicaTransport",
    "ReplicaUnavailable",
    "RetryBudget",
    "SelectorSpec",
    "ServeApp",
    "ServeMetrics",
    "Session",
    "SessionRouter",
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
    "build_fleet",
    "check_row",
    "export_all",
    "export_session",
    "heal_bucket",
    "import_session",
    "make_server",
    "payload_digest",
    "rendezvous_owner",
    "rendezvous_rank",
    "restore_app_sessions",
    "verify_session_stream",
]
