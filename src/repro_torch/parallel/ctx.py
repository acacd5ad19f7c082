"""Parallel execution context threaded through the model code.

The counterpart of ``repro.parallel.ctx.ParallelCtx`` for one device: the
model code calls ``shard`` and ``shard_residual`` where the reference places
its sharding constraints, and here both return their input. A device mesh
(data, FSDP, tensor and expert parallelism) is not ported yet: ``mesh``
other than ``None`` raises ``NotImplementedError`` (ROADMAP, Queue 1).

There is no ``pallas_ssd`` switch. The SSD intra-chunk stage always goes
through its autograd Function, which launches the CUDA kernels (forward and
backward) on CUDA tensors and runs the plain PyTorch versions on CPU
tensors; training and serving take the same path.

``remat`` is the reference's rematerialisation policy for training:
``"none"`` keeps every activation, ``"full"`` keeps only each layer's input
and recomputes its body in the backward pass, ``"dots"`` keeps the matrix
products' outputs and recomputes the rest (:func:`remat_wrap`).
"""

from __future__ import annotations

import functools
from dataclasses import dataclass
from typing import Any, Callable, Optional, Tuple, TypeVar

import torch
import torch.utils.checkpoint as ckpt

REMAT_POLICIES = ("none", "full", "dots")
#: The matrix products whose outputs ``remat="dots"`` keeps.
_DOTS = (torch.ops.aten.mm.default, torch.ops.aten.bmm.default,
         torch.ops.aten.addmm.default)

F = TypeVar("F", bound=Callable[..., Any])


@dataclass(frozen=True)
class ParallelCtx:
    mesh: Optional[Any] = None
    data_axes: Tuple[str, ...] = ("data",)
    remat: str = "none"  # none | full | dots

    def __post_init__(self) -> None:
        if self.mesh is not None:
            raise NotImplementedError(
                "ParallelCtx(mesh=...): the port runs on one device; the "
                "sharded LM path is still to be ported (ROADMAP, Queue 1)"
            )
        if self.remat not in REMAT_POLICIES:
            raise ValueError(f"remat={self.remat!r}: one of {REMAT_POLICIES}")

    @property
    def batch_axes(self) -> Tuple[str, ...]:
        return self.data_axes

    def shard(self, x: torch.Tensor, *axes: Any) -> torch.Tensor:
        """The reference's sharding constraint; the identity on one device."""
        return x

    def shard_residual(self, x: torch.Tensor) -> torch.Tensor:
        """The reference's residual-stream constraint; the identity here."""
        return x


def _save_dots(ctx: Any, op: Any, *args: Any, **kwargs: Any) -> ckpt.CheckpointPolicy:
    return (ckpt.CheckpointPolicy.MUST_SAVE if op in _DOTS
            else ckpt.CheckpointPolicy.PREFER_RECOMPUTE)


def remat_wrap(fn: F, pctx: ParallelCtx) -> F:
    """``fn`` (one layer's body) under ``pctx.remat``, the counterpart of the
    reference's ``_remat_wrap``: non-reentrant ``torch.utils.checkpoint``
    for ``"full"``, the same with a selective policy that saves the matrix
    products' outputs for ``"dots"``, ``fn`` itself for ``"none"`` or where
    no gradient is being recorded."""
    if pctx.remat == "none":
        return fn
    context_fn: Callable[[], Any] = ckpt.noop_context_fn
    if pctx.remat == "dots":
        context_fn = functools.partial(ckpt.create_selective_checkpoint_contexts, _save_dots)

    @functools.wraps(fn)
    def wrapped(*args: Any, **kwargs: Any) -> Any:
        if not torch.is_grad_enabled():
            return fn(*args, **kwargs)
        return ckpt.checkpoint(fn, *args, use_reentrant=False, context_fn=context_fn, **kwargs)

    return wrapped  # type: ignore[return-value]
