"""The serving plane: overload robustness, sessions, placement.

Everything between client traffic and the engines' batched propose path
lives here: per-tenant admission control (token buckets + weighted fair
dequeue), end-to-end backpressure (one saturation score folded from the
WAL barrier, the engine inbox and the request pools), typed overload
errors with retry-after hints, a deadline-honoring client retry helper,
the seeded `overload_storm` scenario with its graceful-degradation
verdict, the vector-scale at-most-once SESSION layer (sessions.py:
batched register/retire, pooled per-tenant sessions, same-series
deadline retries answered from the RSM's replicated dedup cache), and
the load-aware PLACEMENT plane (placement.py: hot groups live-migrate
off saturated hosts over leadership transfer + the streamed snapshot
install path). See README "Serving & overload" and "Sessions &
placement".
"""
from .admission import (
    AdmissionConfig,
    AdmissionController,
    ErrBackpressure,
    ErrOverloaded,
    ErrTenantThrottled,
    KLASS_BULK,
    KLASS_URGENT,
    TenantSpec,
    TokenBucket,
)
from .backpressure import SaturationMonitor, SaturationThresholds
from .front import ServingFront, Ticket
from .placement import (
    MIGRATION_TENANT,
    MigrationPlan,
    MigrationTarget,
    PlacementConfig,
    PlacementPlane,
    host_target,
)
from .retry import call_with_retries
from .sessions import (
    ErrProposalIndeterminate,
    ErrSessionExhausted,
    SessionManager,
)
from .storm import StormReport, run_overload_storm, storm_burst

__all__ = [
    "AdmissionConfig",
    "AdmissionController",
    "ErrBackpressure",
    "ErrOverloaded",
    "ErrTenantThrottled",
    "ErrProposalIndeterminate",
    "ErrSessionExhausted",
    "KLASS_BULK",
    "KLASS_URGENT",
    "MIGRATION_TENANT",
    "MigrationPlan",
    "MigrationTarget",
    "PlacementConfig",
    "PlacementPlane",
    "SaturationMonitor",
    "SaturationThresholds",
    "ServingFront",
    "SessionManager",
    "StormReport",
    "TenantSpec",
    "Ticket",
    "call_with_retries",
    "host_target",
    "run_overload_storm",
    "storm_burst",
]
