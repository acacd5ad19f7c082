"""Parallel execution context threaded through the model code, the
counterpart of ``repro.parallel.ctx.ParallelCtx``.

Axis conventions, as in the reference:

  pod    — outermost data parallelism across pods (multi-pod mesh only)
  data   — data parallelism; FSDP (ZeRO-3) shards parameters over it
  model  — tensor parallelism (attention heads, MLP hidden, SSM heads,
           vocab) and expert parallelism for the MoE layers

Without a mesh (``mesh=None``) nothing changes: ``shard`` and
``shard_residual`` return their input and every collective helper is the
identity, so the same model code serves and trains on one device.

With a mesh (a ``torch.distributed.device_mesh.DeviceMesh`` whose dims are
named, ``("data", "model")`` or ``("pod", "data", "model")``) the port runs
explicit SPMD: each rank is one process holding its local shard of every
parameter (``repro_torch.parallel.sharding.shard_params``), and the layers
call the collectives of :mod:`repro_torch.parallel.collectives` where the
reference's GSPMD would place them. ``shard`` stays the identity there too:
a local tensor carries its layout. A process group is made for every axis
and every tuple of axes of the mesh when the context is built (all ranks
build it alike, in the same order), and cached per mesh.

The reference's ``pallas_ssd``, ``unroll_layers`` and ``unroll_attn`` have
no counterpart. The SSD intra-chunk stage always goes through its autograd
Function, which launches the CUDA kernels (forward and backward) on CUDA
tensors and runs the plain PyTorch versions on CPU tensors, so there is no
Pallas switch; the layer and KV-chunk loops are Python loops, so there is
no ``lax.scan`` to unroll.

``remat`` is the reference's rematerialisation policy for training:
``"none"`` keeps every activation, ``"full"`` keeps only each layer's input
and recomputes its body in the backward pass, ``"dots"`` keeps the matrix
products' outputs and recomputes the rest (:func:`remat_wrap`).
"""

from __future__ import annotations

import functools
import itertools
import threading
from dataclasses import dataclass
from typing import Any, Callable, Dict, Optional, Tuple, TypeVar, Union

import torch
import torch.distributed as dist
import torch.utils.checkpoint as ckpt

from repro_torch.parallel import collectives as C

REMAT_POLICIES = ("none", "full", "dots")
#: The matrix products whose outputs ``remat="dots"`` keeps.
_DOTS = (torch.ops.aten.mm.default, torch.ops.aten.bmm.default,
         torch.ops.aten.addmm.default)

F = TypeVar("F", bound=Callable[..., Any])
Axes = Union[None, str, Tuple[str, ...]]
Tensor = torch.Tensor

#: Process groups per (mesh, axes tuple): new groups are collective calls, so
#: every rank makes them once, in the same order, when its first context on
#: a mesh is built.
_GROUPS: Dict[Tuple[int, Tuple[str, ...]], Any] = {}
_MESHES: Dict[int, Any] = {}  # keeps each cached mesh alive, so its id is not reused
_GROUPS_LOCK = threading.Lock()


def _axes_tuple(axes: Axes) -> Tuple[str, ...]:
    if axes is None:
        return ()
    return (axes,) if isinstance(axes, str) else tuple(axes)


def _make_groups(mesh: Any) -> None:
    """A process group for every tuple of the mesh's axes in the mesh's
    order (single axes from the mesh itself). ``new_group`` orders a group
    by global rank, which is the row-major order of such a tuple's
    coordinates on a mesh made by ``init_device_mesh``."""
    names = tuple(mesh.mesh_dim_names)
    key = id(mesh)
    with _GROUPS_LOCK:
        if key in _MESHES:
            return
        ranks = mesh.mesh  # tensor of global ranks, dims in ``names`` order
        me = dist.get_rank()
        for r in range(1, len(names) + 1):
            for axes in itertools.combinations(names, r):
                if r == 1:
                    _GROUPS[(key, axes)] = mesh.get_group(axes[0])
                    continue
                dims = [names.index(a) for a in axes]
                rest = [i for i in range(len(names)) if i not in dims]
                grid = ranks.permute(*rest, *dims).reshape(-1, *(ranks.shape[i] for i in dims))
                mine = None
                for block in grid.reshape(grid.shape[0], -1).tolist():
                    g = dist.new_group(ranks=block)
                    if me in block:
                        mine = g
                _GROUPS[(key, axes)] = mine
        _MESHES[key] = mesh


@dataclass(frozen=True)
class ParallelCtx:
    mesh: Optional[Any] = None
    data_axes: Tuple[str, ...] = ("data",)   # ("pod", "data") on the multi-pod mesh
    model_axis: Optional[str] = "model"
    fsdp_axis: Axes = "data"                 # parameter sharding axis (ZeRO-3)
    seq_shard: bool = False                  # sequence parallelism of the decode cache
    seq_tp: bool = False                     # Megatron-SP: residual seq-sharded over model
    remat: str = "none"                      # none | full | dots
    int8_moe_gather: bool = False            # gather FSDP expert weights as int8
    #: Whether the batch's rows are split over the data axes (the port's
    #: own field: the rules keep a batch whole that the data axes do not
    #: divide, and a layer that reduces over tokens must know).
    batch_split: bool = True

    def __post_init__(self) -> None:
        if self.remat not in REMAT_POLICIES:
            raise ValueError(f"remat={self.remat!r}: one of {REMAT_POLICIES}")
        if self.mesh is None:
            return
        names = getattr(self.mesh, "mesh_dim_names", None)
        if not names or not hasattr(self.mesh, "get_group"):
            raise TypeError(f"ParallelCtx(mesh=...) takes a torch.distributed DeviceMesh with "
                            f"named dims, not {type(self.mesh).__name__}")
        _make_groups(self.mesh)

    # ------------------------------------------------------------ sizes ----
    @property
    def batch_axes(self) -> Tuple[str, ...]:
        return self.data_axes

    def _present(self, axes: Axes) -> Tuple[str, ...]:
        if self.mesh is None:
            return ()
        names = tuple(self.mesh.mesh_dim_names)
        present = tuple(a for a in _axes_tuple(axes) if a in names)
        if list(present) != sorted(present, key=names.index):
            raise ValueError(f"axes {present} are not in the mesh's order {names}")
        return present

    def axis_size(self, name: Axes) -> int:
        n = 1
        for a in self._present(name):
            n *= self.mesh.size(self.mesh.mesh_dim_names.index(a))
        return n

    @property
    def tp(self) -> int:
        return self.axis_size(self.model_axis)

    @property
    def dp(self) -> int:
        return self.axis_size(self.data_axes)

    def divisible_by_tp(self, n: int) -> bool:
        return self.tp > 1 and n % self.tp == 0

    def spec(self, *axes: Any) -> Tuple[Any, ...]:
        """The reference's ``spec``: the axes of each dim, dropping axes
        absent from the mesh; the literal ``"model"`` names ``model_axis``
        (``None`` under dp_only). A tuple stands for a PartitionSpec."""
        if self.mesh is None:
            return ()

        def resolve(a: Any) -> Any:
            return self.model_axis if a == "model" else a

        out = []
        for a in axes:
            if a is None:
                out.append(None)
            elif isinstance(a, tuple):
                kept = tuple(r for r in (resolve(x) for x in a)
                             if r is not None and r in self.mesh.mesh_dim_names)
                out.append(kept if kept else None)
            else:
                r = resolve(a)
                out.append(r if r is not None and r in self.mesh.mesh_dim_names else None)
        return tuple(out)

    # ----------------------------------------------------------- groups ----
    def group(self, axes: Axes) -> Optional[dist.ProcessGroup]:
        """The process group over ``axes`` (an axis or a tuple, ranks in
        row-major order of the tuple); ``None`` where it has one rank."""
        present = self._present(axes)
        if not present or self.axis_size(present) == 1:
            return None
        with _GROUPS_LOCK:
            return _GROUPS[(id(self.mesh), present)]

    def index(self, axes: Axes) -> int:
        """This rank's index along ``axes`` (row-major over a tuple)."""
        idx = 0
        if self.mesh is None:
            return 0
        names = tuple(self.mesh.mesh_dim_names)
        for a in self._present(axes):
            i = names.index(a)
            idx = idx * self.mesh.size(i) + self.mesh.get_local_rank(i)
        return idx

    @property
    def model_group(self) -> Optional[dist.ProcessGroup]:
        return self.group(self.model_axis)

    @property
    def model_rank(self) -> int:
        return self.index(self.model_axis)

    # ------------------------------------------------ the reference's api ---
    def shard(self, x: Tensor, *axes: Any) -> Tensor:
        """The reference's sharding constraint; the identity (a local tensor
        carries its layout)."""
        return x

    def shard_residual(self, x: Tensor) -> Tensor:
        """The reference's residual-stream constraint; the identity (under
        ``seq_tp`` the layers gather and scatter the sequence themselves:
        :meth:`seq_gather`, :meth:`tp_exit`)."""
        return x

    # ---------------------------------------------- tensor parallelism -----
    def tp_enter(self, x: Tensor) -> Tensor:
        """Megatron's "f" over ``model``: a value every model rank holds
        alike entering work split over ``model``."""
        return C.copy_to(x, self.model_group)

    def tp_exit(self, y: Tensor, *, partial: bool = True) -> Tensor:
        """A sub-layer's output to the residual stream: the model ranks'
        partial sums added ("g"), or under ``seq_tp`` reduce-scattered along
        the sequence (dim 1). ``partial=False``: every rank holds the whole
        output already, so under ``seq_tp`` it only takes its slice."""
        g = self.model_group
        if self.seq_tp:
            return C.reduce_scatter(y, g, 1) if partial else C.split(y, g, 1)
        return C.reduce_from(y, g) if partial else y

    def seq_gather(self, x: Tensor) -> Tensor:
        """A sub-layer's input from the residual stream: under ``seq_tp`` the
        sequence (dim 1) all-gathered over ``model`` as a value every rank
        then holds alike (backward: this rank's slice); else ``x``."""
        if not self.seq_tp:
            return x
        return C.all_gather(x, self.model_group, 1, scatter_back=False)

    def seq_split(self, x: Tensor) -> Tensor:
        """The residual stream's entry under ``seq_tp``: this rank's slice of
        the sequence; else ``x``."""
        return C.split(x, self.model_group, 1) if self.seq_tp else x


def split_over_model(module: Any, name: str, dim: int, pctx: ParallelCtx) -> bool:
    """Whether ``module``'s parameter ``name`` is split over ``model`` at
    ``dim`` on this rank (``shard_params`` records each module's specs)."""
    specs = getattr(module, "_specs", None)
    if not specs or pctx.model_axis is None or pctx.tp == 1:
        return False
    spec = specs.get(name)
    return bool(spec) and spec[dim] == pctx.model_axis


def _save_dots(ctx: Any, op: Any, *args: Any, **kwargs: Any) -> ckpt.CheckpointPolicy:
    return (ckpt.CheckpointPolicy.MUST_SAVE if op in _DOTS
            else ckpt.CheckpointPolicy.PREFER_RECOMPUTE)


def remat_wrap(fn: F, pctx: ParallelCtx) -> F:
    """``fn`` (one layer's body) under ``pctx.remat``, the counterpart of the
    reference's ``_remat_wrap``: non-reentrant ``torch.utils.checkpoint``
    for ``"full"``, the same with a selective policy that saves the matrix
    products' outputs for ``"dots"``, ``fn`` itself for ``"none"`` or where
    no gradient is being recorded. Collectives in ``fn`` run again in the
    recomputation, on every rank alike."""
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
