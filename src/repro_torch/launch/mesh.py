"""Mesh builders, the counterpart of ``repro.launch.mesh``.

Single pod: (16, 16) = 256 ranks, dims (data, model).
Multi-pod:  (2, 16, 16) = 512 ranks, dims (pod, data, model); the pod axis
is pure data parallelism.

A mesh is a ``torch.distributed.device_mesh.DeviceMesh`` over the ranks of
the default process group, which the caller initialises (its address,
world size and rank given, as nothing on the machine announces a
cluster). Each rank is one process; ranks may share a card (with the
``gloo`` backend: ``init_process_group("cpu:gloo,cuda:gloo", ...)``), as
NCCL refuses two ranks on one GPU. Defined as functions, so importing this
module touches no process group.
"""

from __future__ import annotations

from typing import Any, Tuple

import torch.distributed as dist
from torch.distributed.device_mesh import init_device_mesh

from repro_torch.parallel.ctx import ParallelCtx

STRATEGIES = ("tp", "sp_tp", "dp_only")


def _mesh(shape: Tuple[int, ...], axes: Tuple[str, ...], device_type: str) -> Any:
    need = 1
    for n in shape:
        need *= n
    have = dist.get_world_size() if dist.is_initialized() else 1
    if have != need:
        raise RuntimeError(f"a {shape} mesh {axes} needs {need} ranks; the process group "
                           f"has {have} (world size {have})")
    return init_device_mesh(device_type, shape, mesh_dim_names=axes)


def make_production_mesh(*, device_type: str, multi_pod: bool = False) -> Any:
    """The reference's production mesh over ``device_type`` ("cuda" or
    "cpu"): (16, 16) over (data, model), or (2, 16, 16) over (pod, data,
    model). Raises, naming the world size, unless the process group has
    exactly that many ranks."""
    shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    return _mesh(shape, axes, device_type)


def make_ctx(mesh: Any, *, seq_shard: bool = False, remat: str = "full",
             strategy: str = "tp") -> ParallelCtx:
    """strategy:
      "tp"      — model axis = tensor/expert parallelism (default)
      "sp_tp"   — TP + Megatron sequence parallelism: the residual stream is
                  seq-sharded over ``model``
      "dp_only" — the model axis joins data parallelism; parameters
                  FSDP-shard over (data, model)"""
    if strategy not in STRATEGIES:
        raise ValueError(f"strategy={strategy!r}: one of {STRATEGIES}")
    data_axes: Tuple[str, ...] = tuple(a for a in ("pod", "data") if a in mesh.mesh_dim_names)
    if strategy == "sp_tp":
        return ParallelCtx(mesh=mesh, data_axes=data_axes, model_axis="model",
                           fsdp_axis="data", seq_shard=seq_shard, seq_tp=True, remat=remat)
    if strategy == "dp_only":
        return ParallelCtx(mesh=mesh, data_axes=data_axes + ("model",), model_axis=None,
                           fsdp_axis=("data", "model"), seq_shard=seq_shard, remat=remat)
    return ParallelCtx(mesh=mesh, data_axes=data_axes, model_axis="model",
                       fsdp_axis="data", seq_shard=seq_shard, remat=remat)


def make_debug_mesh(n_data: int = 2, n_model: int = 2, *, device_type: str) -> Any:
    """A small (data, model) mesh over ``device_type``, for tests and the
    card's logical ranks."""
    return _mesh((n_data, n_model), ("data", "model"), device_type)
