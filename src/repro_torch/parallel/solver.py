"""Device lists for the sharded tridiagonal solve.

The counterpart of ``repro.parallel.solver``. The partition method is
parallel across chunks by construction: Stage 1 and Stage 3 touch only a
chunk's own blocks plus one halo block, and only the small reduced system
couples them. So the paper's "streams" map onto devices as well as onto the
streams of one device. This module owns the host-side bookkeeping that
:class:`repro_torch.core.tridiag.plan.FusedExecutor` shards over:

``resolve_mesh_devices``
    normalises ``SolverConfig.mesh`` (``None`` | ``"auto"`` | a CUDA device
    count | an explicit device sequence) to a tuple of ``torch.device``, one
    per shard, or ``None`` for the single-device path. A sequence may repeat
    a device: ``("cuda:0",) * 4`` is four logical shards on one card, and
    ``("cpu",) * 8`` eight on the host, which is how the CPU tests run the
    sharded path;
``shard_count``
    the divisibility rule: the largest shard count ``<= limit`` that divides
    the axis being sharded (every shard gets an equal span, and the solver
    never pads the block axis);
``mesh_signature``
    a hashable signature of a device list, one ``(type, index)`` per shard,
    for the executable-cache key and ``session.stats``.

The reference's ``mesh_for`` and ``clear_mesh_cache`` have no counterpart:
torch has no mesh object, and the sharded path moves each shard's span to
its device with ``Tensor.to`` (the reference's ``ppermute`` halo exchange and
``all_gather`` of the reduced rows are copies in ``plan._fused_sharded``).
"""

from __future__ import annotations

from typing import Any, Optional, Sequence, Tuple

import numpy as np
import torch

__all__ = [
    "MESH_AXIS_BATCH",
    "MESH_AXIS_CHUNKS",
    "MeshSpec",
    "mesh_signature",
    "resolve_mesh_devices",
    "shard_count",
]

#: The axis the system-major fused block axis shards over: each shard owns a
#: contiguous run of partition blocks.
MESH_AXIS_CHUNKS = "chunks"

#: The axis the interleaved batch (lane) axis shards over: each shard owns a
#: contiguous run of systems, and the wide pipeline needs no exchange at all.
MESH_AXIS_BATCH = "batch"

#: What ``SolverConfig.mesh`` accepts: ``None`` (one device), ``"auto"``
#: (shard iff more than one CUDA device is visible), an ``int`` count of
#: CUDA devices, or an explicit sequence of devices or device strings.
MeshSpec = Any


def _cuda_devices(count: int) -> Tuple[torch.device, ...]:
    return tuple(torch.device("cuda", i) for i in range(count))


def _device(entry: Any) -> torch.device:
    """One entry of an explicit device sequence as a ``torch.device``; a
    CUDA device without an index is the current one, as in
    :func:`repro_torch.device.resolve_device`."""
    try:
        dev = torch.device(entry)
    except (RuntimeError, TypeError):
        raise ValueError(
            f"mesh entry {entry!r} is not a device: pass 'cuda:N', 'cpu' or a torch.device"
        ) from None
    if dev.type == "cpu":
        return torch.device("cpu")
    if dev.type != "cuda":
        raise ValueError(f"mesh entry {entry!r}: the port shards over 'cuda' or 'cpu' devices")
    if dev.index is None and torch.cuda.is_available():
        return torch.device("cuda", torch.cuda.current_device())
    return dev


def resolve_mesh_devices(spec: MeshSpec) -> Optional[Tuple[torch.device, ...]]:
    """Normalise a mesh spec to the devices sharded solves run on, one per
    shard.

    Returns ``None`` for every single-device outcome (``spec=None``, at most
    one visible CUDA device under ``"auto"``, a count of 1, a one-entry
    sequence), so callers can treat ``None`` as today's unsharded path, bit
    for bit. Raises ``ValueError`` for a count above the visible CUDA
    devices, a count below 1, a string other than ``"auto"`` and a sequence
    that mixes device types; ``TypeError`` for any other kind of spec.
    """
    if spec is None:
        return None
    if isinstance(spec, str):
        if spec != "auto":
            raise ValueError(
                f"mesh={spec!r}: the only string spec is 'auto' (shard when more "
                f"than one CUDA device is visible); pass None, an int CUDA device "
                f"count, or a device sequence such as ('cuda:0',) * 4"
            )
        count = torch.cuda.device_count()
        return _cuda_devices(count) if count > 1 else None
    if isinstance(spec, (int, np.integer)):
        count = int(spec)
        if count < 1:
            raise ValueError(f"mesh={count}: device count must be >= 1")
        if count == 1:
            return None
        visible = torch.cuda.device_count()
        if count > visible:
            raise ValueError(
                f"mesh={count}: only {visible} CUDA device(s) visible; for "
                f"logical shards on one device pass a sequence such as "
                f"('cuda:0',) * {count} or ('cpu',) * {count}"
            )
        return _cuda_devices(count)
    if isinstance(spec, Sequence):
        devices = tuple(_device(e) for e in spec)
        types = sorted({d.type for d in devices})
        if len(types) > 1:
            raise ValueError(f"mesh={spec!r}: the devices mix types {types}; use one type")
        return devices if len(devices) > 1 else None
    raise TypeError(
        f"mesh must be None, 'auto', an int CUDA device count or a device "
        f"sequence, got {spec!r}"
    )


def mesh_signature(
    devices: Optional[Sequence[torch.device]],
) -> Optional[Tuple[Tuple[str, Optional[int]], ...]]:
    """Hashable identity of a device list (``None`` for the unsharded path):
    one ``(type, index)`` per shard, so four logical shards of one card and
    two differ. Keys the fused-executable cache: two executors sharding over
    different device lists (or one sharded and one not) never share an
    entry."""
    if devices is None:
        return None
    return tuple((d.type, d.index) for d in devices)


def shard_count(total: int, limit: int) -> int:
    """Largest shard count ``<= limit`` that divides ``total`` (>= 1).

    Every shard takes an equal slice of the axis, and the solver never pads
    the fused block axis, so an axis of ``total`` elements shards over the
    largest divisor within the device budget, falling back to 1 (unsharded)
    when ``total`` is prime w.r.t. every usable count.
    """
    if total < 1 or limit < 2:
        return 1
    for k in range(min(limit, total), 0, -1):
        if total % k == 0:
            return k
    return 1
