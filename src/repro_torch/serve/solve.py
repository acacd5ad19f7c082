"""The solver's legacy serving entry point, deprecated: the counterpart of
``repro.serve.solve``.

Serving lives in :mod:`repro_torch.core.tridiag.api` (re-exported as
``repro_torch.api``): a :class:`~repro_torch.api.SolverConfig` names the
admission knobs once and :meth:`~repro_torch.api.TridiagSession.submit`
returns a :class:`~repro_torch.api.SolveFuture` resolved by the session's
worker thread, so the deadline fires without anyone calling ``poll()``.

:class:`BatchedSolveService` keeps its original ``submit/poll/flush``
contract for existing callers: a thin subclass of the port's
:class:`~repro_torch.core.tridiag.api.SolveEngine` that warns with a
``DeprecationWarning`` at construction. Migration::

    # before                                   # after
    svc = BatchedSolveService(                 cfg = SolverConfig(
        heuristic=h,                               m=10,
        admission=AdmissionPolicy(                 policy=HeuristicChunkPolicy(h),
            max_batch=64, max_wait_ms=5.0))        max_batch=64, max_wait_ms=5.0)
    svc.submit(SolveRequest(...))              with TridiagSession(cfg) as s:
    done.update(svc.poll())      # polling!        fut = s.submit(SolveRequest(...))
    done.update(svc.flush())                       x = fut.result(timeout=1.0)

``SolveRequest`` and ``AdmissionPolicy`` live in the api module; they are
re-exported here unchanged.
"""

from __future__ import annotations

import time
import warnings
from functools import partial
from typing import Any, Callable, Dict, List, Optional, Sequence

import numpy as np

from repro_torch.core.tridiag.api import (  # noqa: F401  (compat re-exports)
    DISPATCH_MODES,
    AdmissionPolicy,
    SolveEngine,
    SolveRequest,
)
from repro_torch.core.tridiag.batched import solve_batched
from repro_torch.core.tridiag.plan import (
    BackendLike,
    FusedExecutor,
    HeuristicChunkPolicy,
    PlanExecutor,
)


def make_batched_solve_step(m: int = 10) -> Callable[..., Any]:
    """The (B, n) solve step, mirror of ``serve.steps``' step builders:
    ``solve_batched`` at ``m`` (on the card one batched Stage 1, one
    reduced solve and one batched Stage 3 launch)."""
    return partial(solve_batched, m=m)


class BatchedSolveService(SolveEngine):
    """Deprecated: use ``repro_torch.api.TridiagSession`` (``submit`` →
    future).

    The original contract:

    - constructed without ``admission=``, ``submit`` only enqueues and
      ``flush`` dispatches everything in ``max_batch`` groups (mixed sizes
      fuse through ragged plans);
    - constructed with ``admission=``, full batches dispatch inside
      ``submit`` and batches past their deadline on ``poll()``, which is
      the polling burden ``TridiagSession`` removes.

    ``poll`` and ``flush`` return ``{rid: solution}`` of the batches
    solved since the last call. This contract has no error channel: a
    dispatch error raises from the ``submit``, ``poll`` or ``flush`` that
    ran it, and ``timeout_ms`` is inert. ``heuristic`` (a fitted
    ``BatchedStreamHeuristic``) prices each batch by its effective size.
    ``dispatch`` defaults to ``"staged"``, the deprecated frontends' staged
    numerics; ``"auto"`` and ``"fused"`` serve each batch fused. ``backend``
    defaults to the plain PyTorch stages (``"reference"``); ``"cuda"``
    launches the kernels. It runs on ``device``, the CUDA device unless
    ``"cpu"`` is given.
    """

    def __init__(
        self,
        heuristic: Optional[Any] = None,
        *,
        m: int = 10,
        max_batch: Optional[int] = None,
        default_chunks: int = 1,
        admission: Optional[AdmissionPolicy] = None,
        clock: Callable[[], float] = time.perf_counter,
        backend: BackendLike = None,
        dispatch: str = "staged",
        max_queue: Optional[int] = None,
        device: str = "cuda",
    ) -> None:
        warnings.warn(
            "BatchedSolveService is deprecated: build a repro_torch.api.SolverConfig "
            "and serve through TridiagSession.submit(), whose worker thread "
            "fires deadlines without poll()",
            DeprecationWarning,
            stacklevel=2,
        )
        if admission is None:
            # submit only enqueues; batches form when flush() (or poll()) runs
            admission = AdmissionPolicy(max_batch=64 if max_batch is None else max_batch)
            self._eager = False
        else:
            if max_batch is not None:
                raise ValueError(
                    "pass max_batch inside AdmissionPolicy when admission= is given"
                )
            self._eager = True
        if dispatch not in DISPATCH_MODES:
            raise ValueError(f"dispatch={dispatch!r}: must be one of {sorted(DISPATCH_MODES)}")
        stages = backend if backend is not None else "reference"
        executor = (PlanExecutor(stages, device=device) if dispatch == "staged"
                    else FusedExecutor(stages, device=device))
        self.heuristic = heuristic
        self._results: Dict[int, np.ndarray] = {}
        super().__init__(
            executor=executor,
            on_result=self._results.__setitem__,
            on_error=self._raise,
            m=m,
            policy=HeuristicChunkPolicy(heuristic) if heuristic is not None else None,
            default_chunks=default_chunks,
            admission=admission,
            clock=clock,
            max_queue=max_queue,
        )

    @staticmethod
    def _raise(rid: int, e: BaseException) -> None:
        raise e

    def _fail_group(self, reqs: Sequence[SolveRequest], e: BaseException) -> None:
        """No error channel: count the batch as failed and raise to the
        caller of ``submit``/``poll``/``flush``."""
        with self._stats_lock:
            self.stats["failed"] += len(reqs)
        raise e

    def shed_expired(self, now: Optional[float] = None) -> int:
        """Inert: this contract has nowhere to report a shed request."""
        return 0

    def submit(self, req: SolveRequest) -> None:
        """Validate and enqueue; with ``admission=``, a full batch
        dispatches here."""
        super().submit(req)
        if self._eager:
            super().poll(self._clock())

    def poll(self, now: Optional[float] = None) -> Dict[int, np.ndarray]:  # type: ignore[override]
        """Run deadline admission and drain the finished results."""
        super().poll(now)
        return self._drain()

    def flush(self) -> Dict[int, np.ndarray]:  # type: ignore[override]
        """Dispatch everything pending; returns every undrained result."""
        super().flush()
        return self._drain()

    def _drain(self) -> Dict[int, np.ndarray]:
        out = dict(self._results)
        self._results.clear()
        return out


__all__: List[str] = ["AdmissionPolicy", "BatchedSolveService", "SolveEngine", "SolveRequest",
                      "make_batched_solve_step"]
