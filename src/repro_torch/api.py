"""Public front door of the port: ``from repro_torch.api import SolverConfig,
TridiagSession``.

Thin re-export of :mod:`repro_torch.core.tridiag.api` and the plan layer's
public names, mirroring ``repro.api``.
"""

from repro_torch.core.tridiag.api import (
    AUTOTUNE_MODES,
    BACKEND_NAMES,
    DISPATCH_MODES,
    LAYOUTS,
    AdmissionPolicy,
    QueueFullError,
    RequestCancelledError,
    RequestTimedOutError,
    ServingError,
    SolveEngine,
    SolveFuture,
    SolveRequest,
    SolverConfig,
    TridiagSession,
    WorkerDiedError,
)
from repro_torch.core.tridiag.plan import (
    BACKENDS,
    AutoBackend,
    ChunkPolicy,
    CudaBackend,
    FixedChunkPolicy,
    FusedExecutor,
    HeuristicChunkPolicy,
    ReferenceBackend,
    StageBackend,
    clear_plan_cache,
    plan_cache_stats,
)

__all__ = [
    "AUTOTUNE_MODES",
    "AdmissionPolicy",
    "AutoBackend",
    "BACKEND_NAMES",
    "BACKENDS",
    "ChunkPolicy",
    "CudaBackend",
    "DISPATCH_MODES",
    "FixedChunkPolicy",
    "FusedExecutor",
    "HeuristicChunkPolicy",
    "LAYOUTS",
    "QueueFullError",
    "ReferenceBackend",
    "RequestCancelledError",
    "RequestTimedOutError",
    "ServingError",
    "SolveEngine",
    "SolveFuture",
    "SolveRequest",
    "SolverConfig",
    "StageBackend",
    "TridiagSession",
    "WorkerDiedError",
    "clear_plan_cache",
    "plan_cache_stats",
]
