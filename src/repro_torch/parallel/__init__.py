"""Parallel execution of the port: the LM's context (one device, or a
``DeviceMesh`` in explicit SPMD: ``ctx``, ``sharding``, ``collectives``)
and the device lists the sharded tridiagonal solve runs on."""

from repro_torch.parallel.ctx import ParallelCtx
from repro_torch.parallel.solver import (
    MESH_AXIS_BATCH,
    MESH_AXIS_CHUNKS,
    MeshSpec,
    mesh_signature,
    resolve_mesh_devices,
    shard_count,
)

__all__ = [
    "MESH_AXIS_BATCH",
    "MESH_AXIS_CHUNKS",
    "MeshSpec",
    "ParallelCtx",
    "mesh_signature",
    "resolve_mesh_devices",
    "shard_count",
]
