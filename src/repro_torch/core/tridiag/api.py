"""One front door for the port: config → session → verbs.

The counterpart of ``repro.core.tridiag.api``. A frozen :class:`SolverConfig`
names the whole solve configuration once (sub-system size ``m``, precision,
stage backend, device, chunk policy, admission and plan-cache knobs) and a
:class:`TridiagSession` built from it serves every batch shape:

``solve(dl, d, du, b)``
    one tridiagonal system (1-D diagonals; extra leading dims pass through);
``solve_batched(dl, d, du, b)``
    B same-size systems as ``(B, n)`` operands, fused into one dispatch;
``solve_many(systems)``
    a ragged list of mixed-size systems, fused into one dispatch;
``submit(req) -> SolveFuture``
    asynchronous serving: the request joins the session's admission queue and
    the future resolves when its batch dispatches.

The three synchronous verbs have ``*_timed`` variants (``solve_timed``,
``solve_batched_timed``, ``solve_many_timed``) that also return the
:class:`~.plan.ChunkTiming` phase breakdown.

How a verb *executes* is the config's ``dispatch``: ``"fused"`` runs the
whole solve on the session's device with no host round trip
(:class:`~.plan.FusedExecutor`); ``"staged"`` runs the paper's staged path,
each chunk on its own CUDA stream with the reduced solve on the host
(:class:`~.plan.PlanExecutor`); ``"auto"`` (default) is fused for the plain
verbs and served batches and staged for the ``*_timed`` verbs, whose phase
times only the staged path can observe. The operand ``layout``
(``"system-major"``, ``"interleaved"`` or ``"auto"``, see :mod:`.layout`)
is resolved per batch exactly as in the reference: ``"auto"`` interleaves
fused flat batches of at least 32 systems whose ragged padding stays within
1.5x (with a mesh, per lane shard). Without a mesh, everything runs on the
session's device (``SolverConfig.device``, ``"cuda"`` by default). Verbs take numpy arrays or torch tensors and return
numpy arrays. The caller's operands are never consumed or written to: there
is no buffer donation.

``submit`` is backed by a daemon worker thread driving the admission loop of
:class:`SolveEngine`: a batch leaves the queue at ``max_batch`` requests or
once its oldest request has waited ``max_wait_ms``; ``max_queue`` bounds the
queue (:class:`QueueFullError`); a request may carry ``timeout_ms`` and
``priority``; ``SolveFuture.cancel()`` sheds a still-queued request. Any
dispatch failure fails exactly that batch's futures, and a worker that dies
fails every outstanding future with :class:`WorkerDiedError`.

The closed loop (:mod:`repro_torch.telemetry`): with ``autotune`` other
than ``"off"`` or ``max_predicted_ms`` set, every served batch is recorded as
a :class:`~repro_torch.telemetry.BatchObservation` in ``session.telemetry``;
the worker refits the chunk heuristic and a
:class:`~repro_torch.core.streams.timemodel.LatencyModel` from them on its
idle time (``"live"`` swaps the refit policy in, ``"shadow"`` only counts
agreement), and predicted-latency admission packs batches up to
``max_predicted_ms`` and sheds a request whose predicted solve would end past
its deadline (:class:`PredictedTimeoutError`).

The device mesh (``SolverConfig.mesh``): the plain verbs and served batches
shard over a device list, system-major solves over shard-aligned plans
(each device one span of blocks, one halo block from the next, the reduced
rows gathered and the reduced system solved on each device) and interleaved
batches over their lanes. A device may repeat: ``mesh=("cuda:0",) * 4`` runs
four logical shards on one card.

Usage::

    from repro_torch.api import SolverConfig, TridiagSession, SolveRequest

    cfg = SolverConfig(m=10, policy=HeuristicChunkPolicy(fitted),
                       max_batch=64, max_wait_ms=5.0)
    with TridiagSession(cfg) as session:
        x = session.solve(dl, d, du, b)
        xs = session.solve_batched(DL, D, DU, B)
        ys = session.solve_many(systems)
        x0 = session.submit(SolveRequest(0, dl, d, du, b)).result(timeout=1.0)
"""

from __future__ import annotations

import bisect
import dataclasses
import math
import threading
import time
from dataclasses import dataclass
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple, Union

import numpy as np
import torch

from repro_torch.core.tridiag.batched import fuse_systems, split_systems
from repro_torch.core.tridiag.layout import LAYOUTS
from repro_torch.core.tridiag.plan import (
    BACKENDS,
    BackendLike,
    ChunkPolicy,
    ChunkTiming,
    FusedExecutor,
    PlanExecutor,
    SolvePlan,
    Sizes,
    build_plan,
    effective_size,
    executable_cache_stats,
    plan_cache_stats,
    resolve_backend,
    set_plan_cache_capacity,
)
from repro_torch.core.tridiag.ragged import System, fuse_ragged, split_ragged
from repro_torch.core.streams.timemodel import LatencyModel
from repro_torch.device import resolve_device
from repro_torch.parallel.solver import mesh_signature, resolve_mesh_devices, shard_count
from repro_torch.telemetry.refit import AUTOTUNE_MODES, OnlineRefitter
from repro_torch.telemetry.ring import BatchObservation, TelemetryBuffer

__all__ = [
    "AUTOTUNE_MODES",
    "AdmissionPolicy",
    "DISPATCH_MODES",
    "LAYOUTS",
    "PredictedTimeoutError",
    "QueueFullError",
    "RequestCancelledError",
    "RequestTimedOutError",
    "ServingError",
    "SolveEngine",
    "SolveFuture",
    "SolveRequest",
    "SolverConfig",
    "TridiagSession",
    "WorkerDiedError",
]

#: Valid ``SolverConfig.dispatch`` values (as in the reference).
DISPATCH_MODES = ("staged", "fused", "auto")


# ------------------------------------------------------------- typed errors --
class ServingError(RuntimeError):
    """Base of the serving layer's typed failures: flow-control signals
    that callers under load catch to shed, retry or re-route."""


class QueueFullError(ServingError):
    """``submit`` rejected a request because the admission queue is at
    ``max_queue``; nothing was enqueued."""


class RequestTimedOutError(ServingError):
    """A request's ``timeout_ms`` expired while it was still queued; it was
    shed before admission. Work already admitted is never interrupted."""


class RequestCancelledError(ServingError):
    """The request was removed from the queue by ``SolveFuture.cancel()``
    before its batch was taken."""


class PredictedTimeoutError(RequestTimedOutError):
    """Predicted-latency admission shed the request before dispatch: the
    active :class:`~repro_torch.core.streams.timemodel.LatencyModel`
    predicted that even a solo solve would end past the request's
    ``timeout_ms`` deadline. A :class:`RequestTimedOutError`, so
    deadline-aware callers need no new handler."""


class WorkerDiedError(ServingError):
    """The session's serving worker terminated abnormally. Every future
    outstanding at death resolves with this error, and later ``submit``
    calls raise it: create a new session."""


# ------------------------------------------------------------------ request --
@dataclass
class SolveRequest:
    """One tridiagonal system to solve (the serving unit of work).

    ``timeout_ms`` is the request's own queue deadline; ``priority`` orders
    admission (higher first, FIFO within a priority).
    """

    rid: int
    dl: Any
    d: Any
    du: Any
    b: Any
    timeout_ms: Optional[float] = None
    priority: int = 0

    @property
    def size(self) -> int:
        return int(_shape(self.d)[-1])


@dataclass(frozen=True)
class AdmissionPolicy:
    """When does a batch leave the queue?

    ``max_batch``    dispatch as soon as this many requests are waiting;
    ``max_wait_ms``  dispatch a possibly partial batch once the oldest request
                     has waited this long;
    ``allow_ragged`` fuse a mixed-size prefix of the queue into one ragged
                     plan; when False, a batch only takes requests of the head
                     request's size.
    """

    max_batch: int = 64
    max_wait_ms: float = math.inf
    allow_ragged: bool = True

    def __post_init__(self) -> None:
        if self.max_batch < 1:
            raise ValueError("max_batch must be >= 1")
        if self.max_wait_ms < 0:
            raise ValueError("max_wait_ms must be >= 0")


def _shape(a: Any) -> Tuple[int, ...]:
    """Shape of a numpy array, tensor (on any device) or nested sequence."""
    return tuple(a.shape) if hasattr(a, "shape") else np.shape(a)


# ------------------------------------------------------------------- config --
@dataclass(frozen=True)
class SolverConfig:
    """The whole solve configuration, named once.

    The fields and defaults are the reference's (see
    ``repro.core.tridiag.api.SolverConfig``), plus ``device``:

    ``m``          the paper's sub-system (block) size; every system size must
                   be a multiple of it.
    ``dtype``      operand precision; None keeps the input dtype, a float
                   dtype casts every operand on the way in and the solution
                   on the way out.
    ``backend``    ``"auto"`` (the CUDA kernels on a CUDA device, the plain
                   PyTorch stages on the CPU), ``"cuda"``, ``"reference"``,
                   or a ``StageBackend``.
    ``device``     ``"cuda"`` (default) or ``"cpu"``; a session asking for
                   CUDA where there is none raises ``RuntimeError``. With a
                   mesh, the fused path runs on the mesh's devices instead.
    ``dispatch``   ``"fused"`` (the whole solve on the device), ``"staged"``
                   (per-chunk streams, host reduced solve, phase times) or
                   ``"auto"``: fused for the plain verbs and served batches,
                   staged for the ``*_timed`` verbs.
    ``layout``     operand layout of the device stages: ``"system-major"``,
                   ``"interleaved"`` (systems on the fastest axis; flat
                   fused batches only) or ``"auto"``, which interleaves fused
                   batches of B >= 32 systems with padding waste <= 1.5x.
    ``mesh``       the devices the fused path shards over: None (default,
                   one device, the unsharded path bit for bit), ``"auto"``
                   (every CUDA device when more than one is visible), an
                   int count of CUDA devices, or an explicit sequence of
                   devices, which may repeat one: ``("cuda:0",) * 4`` is
                   four logical shards on one card, ``("cpu",) * 8`` eight
                   on the host (see :func:`repro_torch.parallel.solver.
                   resolve_mesh_devices`). A session with a mesh builds
                   shard-aligned plans and fuses operands on the mesh's
                   first device. It needs a fused dispatch: ``"staged"``
                   is rejected, and under ``"auto"`` the ``*_timed`` verbs
                   stay staged, on ``device``, whose type must be the
                   mesh's.
    ``policy`` / ``num_chunks``
                   a ``ChunkPolicy`` pricing each dispatch, or a fixed chunk
                   count; mutually exclusive. With neither, unchunked.
    ``max_batch`` / ``max_wait_ms`` / ``allow_ragged``
                   admission knobs for :meth:`TridiagSession.submit`.
    ``max_queue``  backpressure bound on the admission queue (None =
                   unbounded).
    ``plan_cache_capacity``
                   resize the process-wide plan LRU at session construction.
    ``autotune``   ``"off"``, ``"shadow"`` (refit and count the refit's
                   would-be picks against the active ones) or ``"live"``
                   (swap the refit chunk policy in).
    ``telemetry_capacity``
                   observations the session keeps (0 disables collection;
                   autotune needs it > 0). Collection is on iff autotune is
                   not ``"off"`` or ``max_predicted_ms`` is set.
    ``refit_min_samples`` / ``refit_interval_s``
                   a refit runs once this many observations are buffered
                   and the last attempt is this old.
    ``max_predicted_ms``
                   predicted-latency admission: pack each batch to this
                   predicted latency and shed requests whose predicted solve
                   would end past their deadline (None disables it).
    """

    m: int = 10
    dtype: Optional[object] = None
    backend: BackendLike = "auto"
    dispatch: str = "auto"
    layout: str = "auto"
    mesh: Any = None
    policy: Optional[ChunkPolicy] = None
    num_chunks: Optional[int] = None
    max_batch: int = 64
    max_wait_ms: float = math.inf
    allow_ragged: bool = True
    max_queue: Optional[int] = None
    plan_cache_capacity: Optional[int] = None
    autotune: str = "off"
    telemetry_capacity: int = 1024
    refit_min_samples: int = 64
    refit_interval_s: float = 30.0
    max_predicted_ms: Optional[float] = None
    device: Union[str, torch.device] = "cuda"

    # -- validation ----------------------------------------------------------
    def validate(self) -> "SolverConfig":
        """Check every field; raise with an actionable message on the first
        problem. Returns self so ``SolverConfig(...).validate()`` chains."""
        if not isinstance(self.m, (int, np.integer)) or self.m < 2:
            raise ValueError(
                f"m={self.m!r}: the sub-system size must be an int >= 2 "
                f"(the paper uses m=10)"
            )
        if self.dtype is not None:
            try:
                kind = np.dtype(self.dtype).kind
            except TypeError:
                raise ValueError(
                    f"dtype={self.dtype!r} is not a NumPy dtype; pass "
                    f"np.float64, np.float32, or None to preserve input dtypes"
                ) from None
            if kind != "f":
                raise ValueError(
                    f"dtype={self.dtype!r}: the solver runs in floating "
                    f"point; pass np.float64, np.float32, or None"
                )
        resolve_backend(self.backend)  # raises naming the known backends
        try:
            dev = torch.device(self.device)
        except (RuntimeError, TypeError):
            raise ValueError(
                f"device={self.device!r}: pass 'cuda', 'cuda:N' or 'cpu'"
            ) from None
        if dev.type not in ("cuda", "cpu"):
            raise ValueError(f"device={self.device!r}: the port runs on 'cuda' or 'cpu'")
        if self.dispatch not in DISPATCH_MODES:
            raise ValueError(
                f"dispatch={self.dispatch!r}: must be one of {sorted(DISPATCH_MODES)}"
            )
        if self.layout not in LAYOUTS:
            raise ValueError(f"layout={self.layout!r}: must be one of {sorted(LAYOUTS)}")
        if self.mesh is not None:
            if self.dispatch == "staged":
                raise ValueError(
                    f"mesh={self.mesh!r} with dispatch='staged': the staged "
                    f"path dispatches chunks from a host loop on one device "
                    f"and cannot shard; use dispatch='fused', or 'auto' "
                    f"(sharded plain verbs, staged single-device *_timed "
                    f"verbs)"
                )
            devices = resolve_mesh_devices(self.mesh)  # raises on a bad spec
            if devices is not None and devices[0].type != dev.type:
                raise ValueError(
                    f"mesh={self.mesh!r} runs on {devices[0].type!r} but "
                    f"device={str(self.device)!r}: pass a device of the mesh's type"
                )
        if self.policy is not None:
            if not isinstance(self.policy, ChunkPolicy):
                raise TypeError(
                    f"policy must be a ChunkPolicy (e.g. FixedChunkPolicy, "
                    f"HeuristicChunkPolicy), got {self.policy!r}"
                )
            if self.num_chunks is not None:
                raise ValueError(
                    "pass policy= or num_chunks=, not both: a policy prices "
                    "every dispatch, a fixed num_chunks overrides it"
                )
        if self.num_chunks is not None and self.num_chunks < 1:
            raise ValueError(
                f"num_chunks={self.num_chunks}: must be >= 1 (or None for a "
                f"policy/unchunked solve)"
            )
        if self.max_batch < 1:
            raise ValueError(f"max_batch={self.max_batch}: must be >= 1")
        if self.max_wait_ms < 0:
            raise ValueError(
                f"max_wait_ms={self.max_wait_ms}: must be >= 0 "
                f"(math.inf disables the deadline)"
            )
        if self.max_queue is not None and self.max_queue < 1:
            raise ValueError(
                f"max_queue={self.max_queue}: must be >= 1 (None disables "
                f"backpressure — the queue grows without bound)"
            )
        if self.plan_cache_capacity is not None and self.plan_cache_capacity < 0:
            raise ValueError(
                f"plan_cache_capacity={self.plan_cache_capacity}: must be "
                f">= 0 (0 disables plan memoisation, None leaves the "
                f"process-wide default)"
            )
        if self.autotune not in AUTOTUNE_MODES:
            raise ValueError(
                f"autotune={self.autotune!r}: must be one of "
                f"{sorted(AUTOTUNE_MODES)} ('shadow' reports would-be refit "
                f"picks, 'live' swaps them in)"
            )
        if self.telemetry_capacity < 0:
            raise ValueError(
                f"telemetry_capacity={self.telemetry_capacity}: must be "
                f">= 0 (0 disables collection)"
            )
        if self.autotune != "off" and self.telemetry_capacity == 0:
            raise ValueError(
                f"autotune={self.autotune!r} needs telemetry to refit from; "
                f"set telemetry_capacity >= refit_min_samples "
                f"(got telemetry_capacity=0)"
            )
        if self.refit_min_samples < 1:
            raise ValueError(f"refit_min_samples={self.refit_min_samples}: must be >= 1")
        if self.refit_interval_s < 0:
            raise ValueError(f"refit_interval_s={self.refit_interval_s}: must be >= 0")
        if self.max_predicted_ms is not None and self.max_predicted_ms <= 0:
            raise ValueError(
                f"max_predicted_ms={self.max_predicted_ms}: must be > 0 "
                f"(None disables predicted-latency admission)"
            )
        return self

    # -- derived views -------------------------------------------------------
    def replace(self, **changes: Any) -> "SolverConfig":
        """A copy with ``changes`` applied (e.g. ``cfg.replace(num_chunks=k)``)."""
        return dataclasses.replace(self, **changes)

    def admission(self) -> AdmissionPolicy:
        """The admission policy the session's serving queue runs under."""
        return AdmissionPolicy(
            max_batch=self.max_batch,
            max_wait_ms=self.max_wait_ms,
            allow_ragged=self.allow_ragged,
        )


# ------------------------------------------------------------------- future --
class SolveFuture:
    """Handle to one submitted request; resolves when its batch dispatches.

    ``result(timeout=)`` blocks until the solution (or re-raises the dispatch
    error); ``done()`` never blocks; ``exception(timeout=)`` returns the
    error instead of raising it. ``cancel()`` sheds the request if its batch
    has not been taken yet.
    """

    def __init__(self, rid: int) -> None:
        self.rid = rid
        self._event = threading.Event()
        self._value: Optional[np.ndarray] = None
        self._error: Optional[BaseException] = None
        # Wired by the session at submit: rid -> bool (de-queued or not).
        self._cancel_hook: Optional[Callable[[int], bool]] = None

    def done(self) -> bool:
        return self._event.is_set()

    def cancel(self) -> bool:
        """True iff the request was still queued and has now been shed."""
        if self._event.is_set() or self._cancel_hook is None:
            return False
        return self._cancel_hook(self.rid)

    def cancelled(self) -> bool:
        return self._event.is_set() and isinstance(self._error, RequestCancelledError)

    def result(self, timeout: Optional[float] = None) -> np.ndarray:
        if not self._event.wait(timeout):
            raise TimeoutError(
                f"request {self.rid} not solved within {timeout}s; is its "
                f"batch still waiting for admission (max_batch/max_wait_ms)?"
            )
        if self._error is not None:
            raise self._error
        assert self._value is not None  # resolved without error => has a value
        return self._value

    def exception(self, timeout: Optional[float] = None) -> Optional[BaseException]:
        if not self._event.wait(timeout):
            raise TimeoutError(f"request {self.rid} not resolved within {timeout}s")
        return self._error

    def _resolve(
        self, value: Optional[np.ndarray] = None, error: Optional[BaseException] = None
    ) -> None:
        self._value = value
        self._error = error
        self._event.set()


@dataclass
class _Pending:
    req: SolveRequest
    t_submit: float
    seq: int = 0
    expiry: Optional[float] = None  # absolute clock time; None = no timeout

    @property
    def sort_key(self) -> Tuple[int, int]:
        # Admission order: highest priority first, FIFO within a priority.
        return (-self.req.priority, self.seq)


def _torch_dtype(dtype: object) -> torch.dtype:
    return torch.from_numpy(np.empty(0, dtype=np.dtype(dtype))).dtype  # type: ignore[arg-type]


def _cast(a: Any, dtype: object) -> Any:
    """``a`` in ``dtype`` (None: unchanged), as a tensor if it was one."""
    if dtype is None:
        return a
    if isinstance(a, torch.Tensor):
        return a.to(_torch_dtype(dtype))
    return np.asarray(a, dtype=dtype)


# ------------------------------------------------------------------- engine --
class SolveEngine:
    """Admission-controlled solving of a request queue.

    The serving engine behind :meth:`TridiagSession.submit`, driven by the
    session's worker thread. The engine is synchronous and not thread-safe;
    the session serialises access to its queue (``_cv``), while dispatches
    record their stats under the engine's own ``_stats_lock``.

    Chunk pricing: ``policy`` prices each dispatch (through
    :func:`~repro_torch.core.tridiag.plan.price_chunks` for a heuristic
    policy), else a fixed ``default_chunks``. When the executor shards
    over a mesh (its ``mesh_devices``), the plans are shard-aligned
    (:meth:`plan_shards`). Every dispatch fuses its requests on the
    executor's device and runs ``executor.execute``.

    Results go to the ``on_result``/``on_error`` callbacks; nothing a
    dispatch does can escape: any failure resolves exactly the affected
    requests. ``clock`` is injectable so deadline tests can drive virtual
    time.

    Closed loop: with a ``telemetry`` buffer, every dispatch records one
    :class:`~repro_torch.telemetry.BatchObservation`. With a latency model
    installed (:meth:`set_latency_model`) each observation carries the
    model's prediction, and with ``max_predicted_ms`` set as well, admission
    sheds requests whose predicted solve would end past their deadline
    (:meth:`shed_unmeetable`) and trims each batch to the budget
    (:meth:`_pack_by_budget`).
    """

    def __init__(
        self,
        *,
        executor: Union[FusedExecutor, PlanExecutor],
        on_result: Callable[[int, np.ndarray], None],
        on_error: Callable[[int, BaseException], None],
        m: int = 10,
        policy: Optional[ChunkPolicy] = None,
        default_chunks: int = 1,
        admission: Optional[AdmissionPolicy] = None,
        clock: Callable[[], float] = time.perf_counter,
        dtype: Any = None,
        max_queue: Optional[int] = None,
        telemetry: Optional[TelemetryBuffer] = None,
        max_predicted_ms: Optional[float] = None,
    ) -> None:
        if max_queue is not None and max_queue < 1:
            raise ValueError(f"max_queue={max_queue}: must be >= 1 (or None)")
        # The staged executor (and a test's stand-in) has no mesh.
        self.mesh_devices = getattr(executor, "mesh_devices", None)
        self.admission = admission if admission is not None else AdmissionPolicy()
        self.max_batch = self.admission.max_batch
        self.max_queue = max_queue
        self.policy = policy
        self.m = m
        self.default_chunks = default_chunks
        self.dtype = dtype
        self._clock = clock
        self._executor = executor
        self._on_result = on_result
        self._on_error = on_error
        # The latency model rides behind _stats_lock: the worker swaps it
        # (refits) while _dispatch and shed_unmeetable read it.
        self.telemetry = telemetry
        self.max_predicted_ms = max_predicted_ms
        self._latency_model: Optional[LatencyModel] = None
        self._queue: List[_Pending] = []
        self._seq = 0
        # The queue is serialised by the owner (the session's lock), but
        # stats are also written by _dispatch, which the session runs outside
        # its lock so submits keep flowing during a solve.
        self._stats_lock = threading.Lock()
        self.stats: Dict[str, Any] = {
            "batches": 0,
            "systems": 0,
            "wall_s": 0.0,
            "per_batch": [],
            "rejected": 0,
            "timed_out": 0,
            "cancelled": 0,
            "failed": 0,
            "shed_predicted": 0,
            "queue_high_water": 0,
        }

    # -- predicted-latency admission -----------------------------------------
    def set_latency_model(self, model: Optional[LatencyModel]) -> None:
        """Install (or clear) the latency model admission prices batches
        with: the session calls it when a refit lands."""
        with self._stats_lock:
            self._latency_model = model

    def latency_model(self) -> Optional[LatencyModel]:
        with self._stats_lock:
            return self._latency_model

    def predicted_batch_ms(self, sizes: Sequence[int]) -> Optional[float]:
        """Predicted dispatch latency of a batch of ``sizes`` under the
        current chunk pricing; None while no model is installed."""
        model = self.latency_model()
        if model is None or not sizes:
            return None
        sizes = tuple(sizes)
        return model.predict_ms(effective_size(sizes), self.pick_chunks_ragged(sizes))

    def shed_unmeetable(self, now: Optional[float] = None) -> int:
        """Shed every queued request whose deadline is predicted blown: if
        ``now`` plus the predicted latency of the request alone passes its
        expiry, even an immediate solo dispatch would end late, so it fails
        now with :class:`PredictedTimeoutError`. Needs ``max_predicted_ms``
        and a latency model; returns how many were shed."""
        if self.max_predicted_ms is None or not self._queue or self.latency_model() is None:
            return 0
        now = self._clock() if now is None else now
        live: List[_Pending] = []
        doomed: List[_Pending] = []
        for p in self._queue:
            if p.expiry is None:
                live.append(p)
                continue
            pred = self.predicted_batch_ms((p.req.size,))
            if pred is not None and now + pred / 1e3 > p.expiry:
                doomed.append(p)
            else:
                live.append(p)
        if not doomed:
            return 0
        self._queue = live
        with self._stats_lock:
            self.stats["shed_predicted"] += len(doomed)
            self.stats["timed_out"] += len(doomed)
        for p in doomed:
            err = PredictedTimeoutError(
                f"request {p.req.rid} shed before dispatch: predicted solve "
                f"latency would end past its timeout_ms={p.req.timeout_ms} "
                f"deadline (predicted-latency admission, max_predicted_ms="
                f"{self.max_predicted_ms})"
            )
            try:
                self._on_error(p.req.rid, err)
            except Exception:
                pass  # an error channel that raises must not kill serving
        return len(doomed)

    def _pack_by_budget(self, take: List[_Pending]) -> Tuple[List[_Pending], List[_Pending]]:
        """Trim an admitted group to the ``max_predicted_ms`` budget: the
        longest prefix whose predicted latency fits, and never fewer than
        one request (a solo request over budget must still run, or it would
        starve). Returns ``(take, deferred)``, both in admission order."""
        if self.max_predicted_ms is None or len(take) <= 1 or self.latency_model() is None:
            return take, []
        kept = len(take)
        while kept > 1:
            pred = self.predicted_batch_ms(tuple(p.req.size for p in take[:kept]))
            if pred is None or pred <= self.max_predicted_ms:
                break
            kept -= 1
        return take[:kept], take[kept:]

    # -- scheduling ----------------------------------------------------------
    def submit(self, req: SolveRequest) -> None:
        """Validate and enqueue a request. Raises :class:`QueueFullError`
        when ``max_queue`` requests are already waiting."""
        shape = _shape(req.d)
        if len(shape) != 1:
            raise ValueError(
                f"request {req.rid}: d must be 1-D, got shape {shape} "
                f"(use solve_batched for (B, n) operands)"
            )
        # Name a mismatched diagonal here, not inside a fused batch of
        # innocent neighbours.
        for name in ("dl", "du", "b"):
            a_shape = _shape(getattr(req, name))
            if a_shape != shape:
                raise ValueError(
                    f"request {req.rid}: {name} has shape {a_shape} but the "
                    f"request's size is {req.size} (d has shape {shape}); "
                    f"all four diagonals must be equally long"
                )
        if req.size % self.m:
            raise ValueError(f"request {req.rid}: size {req.size} not divisible by m={self.m}")
        if req.timeout_ms is not None and req.timeout_ms < 0:
            raise ValueError(
                f"request {req.rid}: timeout_ms={req.timeout_ms} must be "
                f">= 0 (or None for no queue deadline)"
            )
        if self.max_queue is not None and len(self._queue) >= self.max_queue:
            with self._stats_lock:
                self.stats["rejected"] += 1
            raise QueueFullError(
                f"request {req.rid} rejected: admission queue is full "
                f"({len(self._queue)}/{self.max_queue} waiting); retry later "
                f"or shed (try_submit returns None instead of raising)"
            )
        if self.dtype is not None:
            req = dataclasses.replace(
                req, **{name: _cast(getattr(req, name), self.dtype) for name in ("dl", "d", "du", "b")}
            )
        now = self._clock()
        self._seq += 1
        pending = _Pending(
            req,
            now,
            seq=self._seq,
            expiry=None if req.timeout_ms is None else now + req.timeout_ms / 1e3,
        )
        # Sorted by (-priority, seq), so _take_group's prefix IS the admission order.
        bisect.insort(self._queue, pending, key=lambda p: p.sort_key)
        with self._stats_lock:
            self.stats["queue_high_water"] = max(self.stats["queue_high_water"], len(self._queue))

    def pending(self) -> int:
        return len(self._queue)

    def cancel(self, rid: int) -> Optional[SolveRequest]:
        """Remove a still-queued request; returns it, or None if no request
        with ``rid`` is waiting. The caller resolves its future."""
        for i, p in enumerate(self._queue):
            if p.req.rid == rid:
                del self._queue[i]
                with self._stats_lock:
                    self.stats["cancelled"] += 1
                return p.req
        return None

    def shed_expired(self, now: Optional[float] = None) -> int:
        """Drop every queued request whose ``timeout_ms`` has expired,
        failing each via ``on_error`` with :class:`RequestTimedOutError`;
        returns how many were shed."""
        if not self._queue:
            return 0
        now = self._clock() if now is None else now
        live = [p for p in self._queue if p.expiry is None or now < p.expiry]
        expired = [p for p in self._queue if not (p.expiry is None or now < p.expiry)]
        if not expired:
            return 0
        self._queue = live
        with self._stats_lock:
            self.stats["timed_out"] += len(expired)
        for p in expired:
            err = RequestTimedOutError(
                f"request {p.req.rid} spent more than its timeout_ms="
                f"{p.req.timeout_ms} in the admission queue and was shed "
                f"before dispatch"
            )
            try:
                self._on_error(p.req.rid, err)
            except Exception:
                pass  # an error channel that raises must not kill serving
        return len(expired)

    def plan_shards(self, sizes: Sizes) -> int:
        """Shard count for a batch's plan: the largest divisor of the fused
        block axis within the mesh's device budget, or 1 without a mesh."""
        if self.mesh_devices is None:
            return 1
        return shard_count(effective_size(sizes) // self.m, len(self.mesh_devices))

    def pick_chunks_ragged(self, sizes: Sequence[int]) -> int:
        """Chunk count for any dispatch: the policy's pick for the batch,
        else the fixed ``default_chunks``."""
        if self.policy is not None:
            return max(1, int(self.policy.num_chunks(tuple(sizes), self.m)))
        return self.default_chunks

    # -- admission -----------------------------------------------------------
    def _oldest_submit(self) -> float:
        # queue[0] is the highest-priority entry; the deadline is the oldest's.
        return min(p.t_submit for p in self._queue)

    def seconds_to_next_event(self, now: Optional[float] = None) -> Optional[float]:
        """Seconds until the admission deadline or the earliest request
        timeout, whichever is first; None when neither is pending. This is
        how long the session's worker may sleep."""
        if not self._queue:
            return None
        now = self._clock() if now is None else now
        ticks: List[float] = []
        if not math.isinf(self.admission.max_wait_ms):
            ticks.append(self._oldest_submit() + self.admission.max_wait_ms / 1e3)
        ticks.extend(p.expiry for p in self._queue if p.expiry is not None)
        if not ticks:
            return None
        return max(0.0, min(ticks) - now)

    def _deadline_expired(self, now: float) -> bool:
        return (
            bool(self._queue)
            and (now - self._oldest_submit()) * 1e3 >= self.admission.max_wait_ms
        )

    def take_due_group(self, now: float) -> Optional[List[_Pending]]:
        """Pop the next admissible batch (max_batch reached or deadline
        expired), or None. Expired requests are shed first, then those
        whose deadline is predicted blown."""
        self.shed_expired(now)
        self.shed_unmeetable(now)
        if self._queue and (
            len(self._queue) >= self.admission.max_batch or self._deadline_expired(now)
        ):
            return self._take_group()
        return None

    def _take_group(self) -> List[_Pending]:
        q = self._queue
        if self.admission.allow_ragged:
            take, rest = q[: self.max_batch], q[self.max_batch :]
            # The deferred suffix is a contiguous run of the sorted queue,
            # so putting it back in front keeps the admission order.
            take, deferred = self._pack_by_budget(take)
            self._queue = deferred + rest
            return take
        # Size-segregated: only the head request's size-mates ride.
        size0 = q[0].req.size
        take, rest = [], []
        for p in q:
            if p.req.size == size0 and len(take) < self.max_batch:
                take.append(p)
            else:
                rest.append(p)
        take, deferred = self._pack_by_budget(take)
        for p in deferred:
            bisect.insort(rest, p, key=lambda p: p.sort_key)
        self._queue = rest
        return take

    def poll(self, now: Optional[float] = None) -> int:
        """Dispatch every batch an admission trigger lets go (max_batch or
        the deadline); returns how many were dispatched. Results go to the
        callbacks. The session's worker does this itself; ``poll`` drives
        an engine without one."""
        now = self._clock() if now is None else now
        dispatched = 0
        while (group := self.take_due_group(now)) is not None:
            self._dispatch(group, now)
            dispatched += 1
        return dispatched

    def flush(self) -> int:
        """Dispatch everything pending (expired requests are shed first);
        returns how many batches were dispatched."""
        now = self._clock()
        self.shed_expired(now)
        dispatched = 0
        while self._queue:
            self._dispatch(self._take_group(), now)
            dispatched += 1
        return dispatched

    def _fail_group(self, reqs: Sequence[SolveRequest], e: BaseException) -> None:
        """Fail every request in ``reqs`` via ``on_error``."""
        with self._stats_lock:
            self.stats["failed"] += len(reqs)
        for r in reqs:
            try:
                self._on_error(r.rid, e)
            except Exception:
                pass

    def _dispatch(self, group: List[_Pending], now: float) -> None:
        """Solve one admitted batch and deliver its results. Everything in
        here is guarded: a failure fails exactly the affected requests via
        ``on_error`` and returns normally, so the worker keeps serving.

        The latency spans the fuse, the solve and the copy of the solution
        to the host; that copy (``.cpu()`` inside ``executor.execute``)
        waits for the device, so the latency a batch records and its
        telemetry observation include the device's work."""
        reqs = [p.req for p in group]
        t0 = time.perf_counter()
        try:
            sizes = tuple(r.size for r in reqs)
            dl, d, du, b, sizes = fuse_ragged(
                [(r.dl, r.d, r.du, r.b) for r in reqs], device=self._executor.operand_device
            )
            # One read of the policy: a live refit swaps it between
            # dispatches, and this batch is priced and recorded by one.
            policy = self.policy
            shards = self.plan_shards(sizes)
            if policy is not None:
                plan = build_plan(sizes, self.m, policy=policy, shards=shards)
            else:
                plan = build_plan(
                    sizes, self.m, num_chunks=self.pick_chunks_ragged(sizes), shards=shards
                )
            layout = self._executor.resolved_layout(plan)
            model = self.latency_model()
            predicted_ms = (
                None if model is None else model.predict_ms(effective_size(sizes), plan.num_chunks)
            )
            x, _ = self._executor.execute(plan, dl, d, du, b)
            # copy: split_ragged returns views, which would pin the whole
            # fused solution for as long as any one result is retained
            solutions = [np.array(xi, dtype=self.dtype, copy=True) for xi in split_ragged(x, sizes)]
            dt = time.perf_counter() - t0
            waits_ms = [(now - p.t_submit) * 1e3 for p in group]
            # Recorded BEFORE futures resolve: a caller unblocked by
            # fut.result() may read session.stats at once.
            with self._stats_lock:
                self.stats["batches"] += 1
                self.stats["systems"] += len(reqs)
                self.stats["wall_s"] += dt
                self.stats["per_batch"].append(
                    {
                        "systems": len(reqs),
                        "sizes": sizes,
                        "effective_size": effective_size(sizes),
                        "ragged": len(set(sizes)) > 1,
                        "num_chunks": plan.num_chunks,
                        "layout": layout,
                        "latency_ms": dt * 1e3,
                        "mean_wait_ms": float(np.mean(waits_ms)),
                        "max_wait_ms": float(np.max(waits_ms)),
                    }
                )
            if self.telemetry is not None and self.telemetry.enabled:
                # Guarded on its own: a recording failure must not fail a
                # solved batch.
                try:
                    self.telemetry.record(
                        BatchObservation(
                            t=now,
                            sizes=sizes,
                            num_chunks=plan.num_chunks,
                            backend=self._executor.backend.name,
                            layout=layout,
                            dispatch="staged" if isinstance(self._executor, PlanExecutor) else "fused",
                            latency_ms=dt * 1e3,
                            mean_wait_ms=float(np.mean(waits_ms)),
                            max_wait_ms=float(np.max(waits_ms)),
                            predicted_ms=predicted_ms,
                        )
                    )
                except Exception:
                    pass
        except Exception as e:
            self._fail_group(reqs, e)
            return
        for r, xi in zip(reqs, solutions):
            try:
                self._on_result(r.rid, xi)
            except Exception as e:
                # A result channel that raises fails only ITS request.
                self._fail_group([r], e)

    def stats_snapshot(self) -> Dict[str, Any]:
        """A consistent copy of :attr:`stats` plus the instantaneous
        ``queue_depth``."""
        with self._stats_lock:
            snap = {
                k: (v if not isinstance(v, list) else [dict(pb) for pb in v])
                for k, v in self.stats.items()
            }
        snap["queue_depth"] = len(self._queue)
        return snap


# ------------------------------------------------------------------ session --
class TridiagSession:
    """The facade: one configured object serving every batch shape.

    Synchronous verbs (:meth:`solve`, :meth:`solve_batched`,
    :meth:`solve_many` and their ``*_timed`` variants) run on the caller's
    thread. :meth:`submit` is
    asynchronous: a daemon worker thread, started by the first submit,
    drives the admission loop. :meth:`close` drains the queue (every
    outstanding future completes) and stops the worker; the session is a
    context manager.

    Constructing a session for ``device="cuda"`` where torch sees no CUDA
    device raises ``RuntimeError``.

    The closed loop: :attr:`telemetry` records every served batch when
    ``autotune`` is not ``"off"`` or ``max_predicted_ms`` is set. The worker
    refits on its idle time, outside the lock (:meth:`_maybe_refit`): the
    latency model always, the chunk policy in ``"live"`` mode, swapped
    under the lock so :meth:`plan_for` and the engine see the old policy or
    the new one. ``refitter=`` injects a refitter (a fake clock for tests).
    """

    def __init__(
        self,
        config: Optional[SolverConfig] = None,
        *,
        refitter: Optional[OnlineRefitter] = None,
    ) -> None:
        self.config = (SolverConfig() if config is None else config).validate()
        self.device = resolve_device(self.config.device)
        self.backend = resolve_backend(self.config.backend, self.device)
        # Resolved once: every executor, plan and stats report sees one list.
        self._mesh_devices = resolve_mesh_devices(self.config.mesh)
        self._fused = FusedExecutor(
            self.backend, device=self.device, layout=self.config.layout, mesh=self._mesh_devices
        )
        self._staged = PlanExecutor(self.backend, device=self.device, layout=self.config.layout)
        if self.config.plan_cache_capacity is not None:
            set_plan_cache_capacity(self.config.plan_cache_capacity)
        # RLock-backed so _resolve_future can take it from paths that
        # already hold it (the serve loop's failure drain).
        self._cv = threading.Condition(threading.RLock())
        self._futures: Dict[int, SolveFuture] = {}
        self._worker: Optional[threading.Thread] = None
        self._closed = False
        self._worker_error: Optional[BaseException] = None
        # Telemetry is on iff something reads it (a refitter, or predicted
        # admission); otherwise the ring has capacity 0 and records nothing.
        telemetry_on = self.config.autotune != "off" or self.config.max_predicted_ms is not None
        self._telemetry = TelemetryBuffer(
            capacity=self.config.telemetry_capacity if telemetry_on else 0
        )
        if refitter is not None:
            self._refitter: Optional[OnlineRefitter] = refitter
        elif self.config.autotune != "off":
            self._refitter = OnlineRefitter(
                mode=self.config.autotune,
                min_samples=self.config.refit_min_samples,
                interval_s=self.config.refit_interval_s,
            )
        else:
            self._refitter = None
        # The chunk policy pricing dispatches: the config's until a live
        # refit swaps it (under _cv). plan_for and the engine read this.
        self._active_policy = self.config.policy
        self._engine = SolveEngine(
            executor=self._staged if self.config.dispatch == "staged" else self._fused,
            on_result=lambda rid, x: self._resolve_future(rid, value=x),
            on_error=lambda rid, e: self._resolve_future(rid, error=e),
            m=self.config.m,
            policy=self.config.policy,
            default_chunks=self.config.num_chunks or 1,
            admission=self.config.admission(),
            dtype=self.config.dtype,
            max_queue=self.config.max_queue,
            telemetry=self._telemetry,
            max_predicted_ms=self.config.max_predicted_ms,
        )

    # -- planning ------------------------------------------------------------
    def plan_for(self, sizes: Sizes) -> SolvePlan:
        """The plan this session executes for ``sizes`` (int or sequence),
        priced by the active chunk policy: the config's, until a live refit
        swaps in the one fitted from telemetry. With a mesh, plans are
        shard-aligned; the staged ``*_timed`` path runs the same plan on one
        device."""
        with self._cv:
            policy = self._active_policy
        shards = self._engine.plan_shards(sizes)
        if policy is not None:
            return build_plan(sizes, self.config.m, policy=policy, shards=shards)
        return build_plan(
            sizes, self.config.m, num_chunks=self.config.num_chunks or 1, shards=shards
        )

    def _cast(self, *arrays: Any) -> Tuple[Any, ...]:
        return tuple(_cast(a, self.config.dtype) for a in arrays)

    def _cast_out(self, x: np.ndarray) -> np.ndarray:
        if self.config.dtype is None:
            return x
        return np.asarray(x, dtype=self.config.dtype)

    def _pick_executor(self, timed: bool) -> Union[FusedExecutor, PlanExecutor]:
        """``dispatch`` routing: "staged" and "fused" hold for every verb;
        "auto" is fused for the plain verbs and staged for the ``*_timed``
        verbs, whose per-phase times only the staged path can observe."""
        mode = self.config.dispatch
        if mode == "fused" or (mode == "auto" and not timed):
            return self._fused
        return self._staged

    # -- synchronous verbs ---------------------------------------------------
    def solve(self, dl: Any, d: Any, du: Any, b: Any) -> np.ndarray:
        """Solve one system (1-D diagonals; leading batch dims pass through).
        The operands are left as they were (no donation)."""
        return self._solve(dl, d, du, b, timed=False)[0]

    def solve_timed(self, dl: Any, d: Any, du: Any, b: Any) -> Tuple[np.ndarray, ChunkTiming]:
        """:meth:`solve` with its :class:`~.plan.ChunkTiming`."""
        return self._solve(dl, d, du, b, timed=True)

    def _solve(self, dl: Any, d: Any, du: Any, b: Any, *, timed: bool) -> Tuple[np.ndarray, ChunkTiming]:
        dl, d, du, b = self._cast(dl, d, du, b)
        n = int(_shape(d)[-1])
        x, timing = self._pick_executor(timed).execute(self.plan_for(n), dl, d, du, b)
        return self._cast_out(x), timing

    def solve_batched(self, dl: Any, d: Any, du: Any, b: Any) -> np.ndarray:
        """Solve B same-size systems given as (B, n) operands."""
        return self._solve_batched(dl, d, du, b, timed=False)[0]

    def solve_batched_timed(
        self, dl: Any, d: Any, du: Any, b: Any
    ) -> Tuple[np.ndarray, ChunkTiming]:
        """:meth:`solve_batched` with its :class:`~.plan.ChunkTiming`."""
        return self._solve_batched(dl, d, du, b, timed=True)

    def _solve_batched(
        self, dl: Any, d: Any, du: Any, b: Any, *, timed: bool
    ) -> Tuple[np.ndarray, ChunkTiming]:
        dl, d, du, b = self._cast(dl, d, du, b)
        shape = _shape(d)
        if len(shape) != 2:
            raise ValueError(
                f"solve_batched takes (batch, n) operands, got shape {shape}; "
                f"use solve() for one system or solve_many() for mixed sizes"
            )
        batch, n = shape
        executor = self._pick_executor(timed)
        fused = fuse_systems(dl, d, du, b, device=executor.operand_device)
        x, timing = executor.execute(self.plan_for((n,) * batch), *fused)
        return split_systems(self._cast_out(x), batch), timing

    def solve_many(self, systems: Sequence[System]) -> List[np.ndarray]:
        """Solve a ragged list of ``(dl, d, du, b)`` systems in one dispatch."""
        return self._solve_many(systems, timed=False)[0]

    def solve_many_timed(self, systems: Sequence[System]) -> Tuple[List[np.ndarray], ChunkTiming]:
        """:meth:`solve_many` with its :class:`~.plan.ChunkTiming`."""
        return self._solve_many(systems, timed=True)

    def _solve_many(
        self, systems: Sequence[System], *, timed: bool
    ) -> Tuple[List[np.ndarray], ChunkTiming]:
        if self.config.dtype is not None:
            systems = [self._cast(*s) for s in systems]  # type: ignore[misc]
        executor = self._pick_executor(timed)
        dl, d, du, b, sizes = fuse_ragged(systems, device=executor.operand_device)
        x, timing = executor.execute(self.plan_for(sizes), dl, d, du, b)
        return split_ragged(self._cast_out(x), sizes), timing

    # -- asynchronous serving ------------------------------------------------
    def submit(self, req: SolveRequest) -> SolveFuture:
        """Enqueue a request; the future resolves when its batch dispatches.
        Raises :class:`QueueFullError` when ``max_queue`` requests are
        waiting and :class:`WorkerDiedError` if the worker has died."""
        fut = self._submit(req, raise_on_full=True)
        assert fut is not None
        return fut

    def try_submit(self, req: SolveRequest) -> Optional[SolveFuture]:
        """Like :meth:`submit`, but returns None (nothing enqueued) instead
        of raising :class:`QueueFullError` when the queue is full."""
        return self._submit(req, raise_on_full=False)

    def _submit(self, req: SolveRequest, *, raise_on_full: bool) -> Optional[SolveFuture]:
        fut = SolveFuture(req.rid)
        with self._cv:
            if self._closed:
                raise RuntimeError(
                    "session is closed; create a new TridiagSession (close() "
                    "drains the queue, it cannot be reopened)"
                )
            if self._worker_error is not None or (
                self._worker is not None and not self._worker.is_alive()
            ):
                raise WorkerDiedError(
                    f"the serving worker of this session died "
                    f"({self._worker_error!r}); its futures were failed — "
                    f"create a new TridiagSession"
                ) from self._worker_error
            if req.rid in self._futures:
                raise ValueError(
                    f"request id {req.rid} is already in flight in this "
                    f"session; rids must be unique among pending requests"
                )
            self._futures[req.rid] = fut
            try:
                self._engine.submit(req)
            except QueueFullError:
                del self._futures[req.rid]
                if raise_on_full:
                    raise
                return None
            except Exception:
                del self._futures[req.rid]
                raise
            fut._cancel_hook = self._cancel
            if self._worker is None:
                self._worker = threading.Thread(
                    target=self._serve_loop, name="tridiag-session-worker", daemon=True
                )
                self._worker.start()
            self._cv.notify_all()
        return fut

    def _cancel(self, rid: int) -> bool:
        """``SolveFuture.cancel`` hook: shed a still-queued request."""
        with self._cv:
            req = self._engine.cancel(rid)
            if req is None:
                return False  # already admitted (in flight) or resolved
        self._resolve_future(
            rid,
            error=RequestCancelledError(
                f"request {rid} was cancelled while queued (its batch had not been taken)"
            ),
        )
        return True

    def _resolve_future(
        self,
        rid: int,
        value: Optional[np.ndarray] = None,
        error: Optional[BaseException] = None,
    ) -> None:
        with self._cv:
            fut = self._futures.pop(rid, None)
        if fut is not None:
            fut._resolve(value, error)

    # -- closed loop ---------------------------------------------------------
    @property
    def telemetry(self) -> TelemetryBuffer:
        """The session's per-batch observation ring (capacity 0, recording
        nothing, unless ``autotune`` or ``max_predicted_ms`` turned it on)."""
        return self._telemetry

    def _refit_wait_s(self) -> Optional[float]:
        """How long the idle worker may sleep before a refit could be due;
        None without a refitter or below its sample threshold (a dispatch
        wakes the worker anyway)."""
        if self._refitter is None:
            return None
        return self._refitter.seconds_until_due(len(self._telemetry))

    def _maybe_refit(self) -> None:
        """One idle-time refit step, on the worker thread outside the lock:
        refit if due, then install the latency model (every mode) and, when
        the refitter made one (live mode), swap the chunk policy under the
        lock."""
        if self._refitter is None:
            return
        result = self._refitter.maybe_refit(
            self._telemetry, pick_active=self._engine.pick_chunks_ragged
        )
        if result is None:
            return
        if result.latency_model is not None:
            self._engine.set_latency_model(result.latency_model)
        if result.policy is not None:
            with self._cv:
                self._active_policy = result.policy
                self._engine.policy = result.policy

    def _serve_loop(self) -> None:
        """Worker: refit when due, dispatch due batches, sleep exactly until
        the next trigger.

        The lock is held only for queue surgery; each solve and each refit
        runs outside it, so submits keep enqueuing meanwhile. An escape the
        engine could not attribute to one batch fails every outstanding
        future with :class:`WorkerDiedError` before the thread exits.
        """
        try:
            while True:
                self._maybe_refit()
                with self._cv:
                    now = self._engine._clock()
                    group = self._engine.take_due_group(now)
                    if group is None:
                        if self._closed:
                            self._engine.shed_expired(now)
                            if self._engine.pending() == 0:
                                return
                            group = self._engine._take_group()  # drain mode
                        else:
                            ticks = [
                                t
                                for t in (self._engine.seconds_to_next_event(now), self._refit_wait_s())
                                if t is not None
                            ]
                            self._cv.wait(timeout=min(ticks) if ticks else None)
                            continue
                try:
                    self._engine._dispatch(group, now)  # futures resolve in here
                except BaseException as e:
                    for p in group:
                        self._resolve_future(p.req.rid, error=e)
                    if not isinstance(e, Exception):
                        raise  # fatal (MemoryError & co) → outer supervisor
        except BaseException as e:
            with self._cv:
                self._worker_error = e
                died = WorkerDiedError(
                    f"serving worker died: {e!r}; this session can no longer serve submits"
                )
                died.__cause__ = e
                self._engine._queue.clear()  # their futures fail right here
                for rid in list(self._futures):
                    self._resolve_future(rid, error=died)
                self._cv.notify_all()

    # -- lifecycle -----------------------------------------------------------
    def pending(self) -> int:
        """Unresolved requests: queued or in an in-flight batch."""
        with self._cv:
            return len(self._futures)

    @property
    def stats(self) -> Dict[str, Any]:
        """A consistent snapshot: the engine's dispatch aggregates and
        load-shedding counters (``shed_predicted`` among them), queue
        occupancy (``queue_depth``, ``queue_high_water``, ``unresolved``),
        the process-wide ``plan_cache`` and ``executable_cache`` counters,
        the session's ``device`` and ``backend``, its ``mesh`` (None on the
        single-device path, else the shard count as ``devices``, the torch
        device type as ``platform`` and the :func:`mesh_signature`), and the
        closed loop's ``autotune`` block: the refitter's counters (attempts,
        refits, errors, last refit's age and samples, pick agreement) and
        the telemetry ring's ``observations`` counts."""
        with self._cv:
            snap = self._engine.stats_snapshot()
            snap["unresolved"] = len(self._futures)
        snap["plan_cache"] = plan_cache_stats()
        snap["executable_cache"] = executable_cache_stats()
        snap["device"] = str(self.device)
        snap["backend"] = self.backend.name
        snap["mesh"] = (
            None
            if self._mesh_devices is None
            else {
                "devices": len(self._mesh_devices),
                "platform": self._mesh_devices[0].type,
                "signature": mesh_signature(self._mesh_devices),
            }
        )
        autotune: Dict[str, Any] = (
            self._refitter.stats_snapshot() if self._refitter is not None else {"mode": "off"}
        )
        autotune["observations"] = self._telemetry.counters()
        snap["autotune"] = autotune
        return snap

    def close(self) -> None:
        """Drain the queue (outstanding futures complete), stop the worker.
        Idempotent; ``submit`` after it raises. Synchronous verbs stay usable."""
        with self._cv:
            self._closed = True
            worker = self._worker
            self._cv.notify_all()
        if worker is not None:
            worker.join()

    def __enter__(self) -> "TridiagSession":
        return self

    def __exit__(self, exc_type: object, exc: object, tb: object) -> None:
        self.close()

    def __repr__(self) -> str:
        with self._cv:
            state = "closed" if self._closed else "open"
            pending = self._engine.pending()
        return (
            f"TridiagSession(m={self.config.m}, backend={self.backend.name!r}, "
            f"device={str(self.device)!r}, {state}, pending={pending})"
        )


# Convenience: the registry names a config's backend may take.
BACKEND_NAMES = tuple(sorted(BACKENDS))
