"""Batch fusion of B same-size systems into one partition solve.

The counterpart of ``thomas_batched`` / ``solve_batched`` (the functional
batched solvers) and ``fuse_systems`` / ``split_systems`` in
``repro.core.tridiag.batched``. With the solver convention ``dl[0] =
du[n-1] = 0``, the partition method applied to the concatenation of B
systems of size n is *exactly* the B independent solves: Stage 1 is per
block, the reduced system decouples at every system boundary (zero left
spike in each first block, zero right coupling in each last block), and
Stage 3's cross-block term there is ``v·s_{p-1}`` with ``v = 0``. So the
batched solve runs the single-system pipeline on the fused ``(B·n,)``
operands, and chunks may span system boundaries.

``BatchedPartitionSolver`` survives as a deprecated wrapper over
``repro_torch.api.TridiagSession(...).solve_batched(...)``.
"""

from __future__ import annotations

import warnings
from typing import TYPE_CHECKING, Any, List, Optional, Tuple, TypeVar

import numpy as np
import torch

from repro_torch.core.tridiag import partition
from repro_torch.device import DeviceLike, resolve_device

if TYPE_CHECKING:  # the plan module imports this one
    from repro_torch.core.tridiag.plan import BackendLike, ChunkTiming

Tensor = torch.Tensor
ArrayT = TypeVar("ArrayT", np.ndarray, Tensor)


def as_tensor(a: Any, device: Optional[torch.device] = None) -> Tensor:
    """A numpy array, torch tensor or nested sequence as a tensor on
    ``device`` (default: where it already is; the CPU for host data).

    Host memory may be shared with the caller's array; the solver never
    writes into its operands, so the caller's data stays as it was.
    """
    if isinstance(a, Tensor):
        return a if device is None else a.to(device)
    return torch.as_tensor(np.ascontiguousarray(a), device=device)


def _batched_operands(dl: Any, d: Any, du: Any, b: Any, device: DeviceLike) -> List[Tensor]:
    """The four (B, n) operands on ``device`` in one dtype (torch's
    promotion rules); anything but one batch axis raises."""
    dev = resolve_device(device)
    ops = [as_tensor(a, dev) for a in (dl, d, du, b)]
    if ops[1].ndim != 2:
        raise ValueError(f"expected (batch, n) operands, got shape {tuple(ops[1].shape)}")
    for name, a in zip(("dl", "du", "b"), (ops[0], ops[2], ops[3])):
        if a.shape != ops[1].shape:
            raise ValueError(f"{name} has shape {tuple(a.shape)}, d has {tuple(ops[1].shape)}")
    dtype = ops[0].dtype
    for a in ops[1:]:
        dtype = torch.promote_types(dtype, a.dtype)
    return [a.to(dtype).contiguous() for a in ops]


def thomas_batched(dl: Any, d: Any, du: Any, b: Any, *, device: DeviceLike = "cuda") -> Tensor:
    """Shape-checked Thomas solve of a (B, n) batch: (B, n) → (B, n), a
    tensor on ``device``. On the card it is one ``thomas`` launch; on the
    CPU the plain Thomas solve."""
    from repro_torch.kernels.thomas.ops import thomas_cuda

    return thomas_cuda(*_batched_operands(dl, d, du, b, device))


def solve_batched(
    dl: Any, d: Any, du: Any, b: Any, *, m: int = 10, device: DeviceLike = "cuda"
) -> Tensor:
    """Solve B independent systems by the partition method.

    Operands are (B, n) with the usual convention (``dl[:, 0]`` and
    ``du[:, n-1]`` ignored); returns the (B, n) solutions, a tensor on
    ``device``. On the card: one batched Stage 1, one reduced solve of the
    (B, P) rows and one batched Stage 3 launch. On the CPU: the plain
    partition solve of each system.
    """
    ops = _batched_operands(dl, d, du, b, device)
    n = ops[1].shape[-1]
    if n % m:
        raise ValueError(f"system size {n} not divisible by m={m}")
    if ops[1].device.type != "cuda":
        return partition.partition_solve(*ops, m=m)
    from repro_torch.kernels.partition_stage1.ops import partition_stage1_cuda_batched
    from repro_torch.kernels.partition_stage3.ops import partition_stage3_cuda_batched
    from repro_torch.kernels.thomas.ops import thomas_cuda

    coeffs = partition_stage1_cuda_batched(*ops, m=m)
    s = thomas_cuda(coeffs.red_dl, coeffs.red_d, coeffs.red_du, coeffs.red_b)
    return partition_stage3_cuda_batched(coeffs, s)


def fuse_systems(
    dl: Any, d: Any, du: Any, b: Any, device: Optional[torch.device] = None
) -> Tuple[Tensor, Tensor, Tensor, Tensor]:
    """(B, n) batch → one fused (B·n,) system with boundary couplings zeroed.

    Zeroing ``dl[:, 0]`` / ``du[:, n-1]`` is what makes the fused partition
    solve decouple exactly; those entries are ignored by convention in the
    unfused solve, so this loses nothing. ``dl`` and ``du`` are copied
    before zeroing, so the caller's operands are left as they were.
    """
    dl = as_tensor(dl, device).clone()
    du = as_tensor(du, device).clone()
    dl[..., :, 0] = 0.0
    du[..., :, -1] = 0.0

    def flat(a: Tensor) -> Tensor:
        return a.reshape(*a.shape[:-2], -1).contiguous()

    return flat(dl), flat(as_tensor(d, device)), flat(du), flat(as_tensor(b, device))


def split_systems(x: ArrayT, batch: int) -> ArrayT:
    """Inverse of :func:`fuse_systems` for the solution vector."""
    return x.reshape(*x.shape[:-1], batch, x.shape[-1] // batch)


class BatchedPartitionSolver:
    """Deprecated: use ``repro_torch.api.TridiagSession(...).solve_batched(...)``.

    ``num_chunks`` slices the *fused* block axis (B·n/m blocks), so chunks
    span system boundaries. Every call delegates to a session with
    ``dispatch="staged"`` and ``backend`` (``"reference"``, the plain
    PyTorch stages, by default; ``"cuda"``, the kernels; or a
    :class:`~repro_torch.core.tridiag.plan.StageBackend`), on ``device``
    (:func:`~repro_torch.core.tridiag.ragged._session_for`).
    """

    def __init__(self, m: int = 10, num_chunks: int = 1, *, backend: BackendLike = None,
                 device: str = "cuda") -> None:
        warnings.warn(
            "BatchedPartitionSolver is deprecated: use repro_torch.api."
            "TridiagSession(SolverConfig(m=..., num_chunks=..., backend=...))"
            ".solve_batched(...)",
            DeprecationWarning,
            stacklevel=2,
        )
        from repro_torch.core.tridiag.ragged import _session_for  # imports this module

        self.m = m
        self.num_chunks = num_chunks
        self._session = _session_for(m, num_chunks, None, backend, device)

    def solve(self, dl: Any, d: Any, du: Any, b: Any) -> np.ndarray:
        x, _ = self.solve_timed(dl, d, du, b)
        return x

    def solve_timed(self, dl: Any, d: Any, du: Any, b: Any) -> Tuple[np.ndarray, ChunkTiming]:
        shape = np.shape(d)
        if len(shape) != 2:
            raise ValueError(f"expected (batch, n) operands, got shape {tuple(shape)}")
        if shape[1] % self.m:
            raise ValueError(f"system size {shape[1]} not divisible by m={self.m}")
        return self._session.solve_batched_timed(dl, d, du, b)
