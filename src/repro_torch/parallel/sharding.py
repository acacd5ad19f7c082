"""Parameter, batch and cache sharding rules (DP/TP/EP/FSDP), the
counterpart of ``repro.parallel.sharding``, and the moves between the full
tree and a rank's local tree.

The rules are the reference's table, keyed by a parameter's NAME (the last
component of its path) with family context, giving the axes of the
TRAILING dims of the leaf; leading dims get ``None``. A spec here is a
tuple with one entry per dim: ``None`` (replicated), an axis name, or a
tuple of axis names (the dim split over their product, row-major), which
is what the reference's ``PartitionSpec`` names.

Conventions, as in the reference:
  model  — TP: attention heads, MLP hidden, vocab; EP: the expert dim
  data   — FSDP (ZeRO-3): the "other" dim of every big matrix
  pod    — pure data parallelism

Each rank holds its slice of every leaf (:func:`shard_params`, or
:func:`init_local`, which cuts each leaf to its slice as it is drawn, so
that the full tree is never held); the model
gathers the FSDP-split dims before use (:func:`gather_fsdp`, whose backward
reduce-scatters the gradients over the FSDP axes), and
:func:`gather_params` gives back the full tree, the unsharded format of
checkpoints and of ``params_from_reference``.
"""

from __future__ import annotations

import copy
from typing import Any, Callable, Dict, Mapping, Optional, Sequence, Tuple, Union

import torch
from torch import nn

from repro_torch.configs.base import ArchConfig
from repro_torch.parallel import collectives as C
from repro_torch.parallel.ctx import ParallelCtx

Tensor = torch.Tensor
AxisEntry = Union[None, str, Tuple[str, ...]]
Spec = Tuple[AxisEntry, ...]
Path = Union[str, Sequence[Any]]

# name -> trailing-dims spec template; F = fsdp axis, M = model axis.
_F, _M = "__fsdp__", "__model__"

_RULES: Dict[str, Tuple] = {
    # embeddings
    "embed": (_M, _F),        # [V, D]
    "unembed": (_F, _M),      # [D, V]
    "dec_pos": (_F, None),    # [T, D]
    "connector": (_F, _M),    # [D, D]
    # attention
    "wq": (_F, _M),
    "wk": (_F, _M),           # demoted to (_F, None) when kv % tp != 0
    "wv": (_F, _M),
    "wo": (_M, _F),
    # dense mlp
    "w1": (_F, _M),
    "w2": (_M, _F),
    "w3": (_F, _M),
    # moe (rank-3 leaves; detected by parent, see _spec_for)
    "router": (None, None),
    # ssm
    "w_z": (_F, _M),
    "w_x": (_F, _M),
    "w_b": (_F, None),
    "w_c": (_F, None),
    "w_dt": (_F, _M),
    "conv_x_w": (None, _M),
    "conv_x_b": (_M,),
    "conv_b_w": (None, None),
    "conv_b_b": (None,),
    "conv_c_w": (None, None),
    "conv_c_b": (None,),
    "dt_bias": (_M,),
    "a_log": (_M,),
    "d_skip": (_M,),
    "out_proj": (_M, _F),
    # hybrid shared block
    "w_in": (_F, _M),
}

_MOE_RULES: Dict[str, Tuple] = {
    "w1": (_M, _F, None),     # [E, D, F]
    "w3": (_M, _F, None),
    "w2": (_M, None, _F),     # [E, F, D]
}

# vector-ish leaves (norm scales over a TP-sharded feature dim)
_MODEL_DIM_VECTORS = {"out_norm"}


def _keys(path: Path) -> list:
    parts = path.split(".") if isinstance(path, str) else list(path)
    return [k for k in parts if isinstance(k, str) and not k.isdigit()]


def _guard(shape: Sequence[int], axes: Sequence[AxisEntry], pctx: ParallelCtx) -> Spec:
    """Drop the axes of a dim they do not divide."""
    out = []
    for dim, ax in zip(shape, axes):
        size = pctx.axis_size(ax) if ax is not None else 0
        out.append(ax if ax is not None and size and dim % size == 0 else None)
    return tuple(out)


def _spec_for(path: Path, shape: Sequence[int], cfg: ArchConfig, pctx: ParallelCtx) -> Spec:
    keys = _keys(path)
    name = keys[-1] if keys else ""
    parents = set(keys[:-1])

    tmpl: Optional[Tuple] = None
    if pctx.model_axis is None and name in ("embed", "unembed", "dec_pos"):
        # dp_only: never shard d_model of the embedding family over the
        # whole fsdp group (the reference's rule, kept as it is).
        tmpl = {"embed": (_F, None), "unembed": (None, _F), "dec_pos": (_F, None)}[name]
    elif name in ("w1", "w2", "w3") and "moe" in parents and "shared" not in parents:
        tmpl = _MOE_RULES[name]
    elif name == "scale" and any(p in _MODEL_DIM_VECTORS for p in parents):
        tmpl = (_M,)
    elif name in _RULES:
        tmpl = _RULES[name]
    if name in ("wk", "wv") and not pctx.divisible_by_tp(cfg.num_kv_heads):
        tmpl = (_F, None)

    ndim = len(shape)
    if tmpl is None:
        tmpl = (None,) * min(ndim, 1)  # norms etc: replicate

    pad = (None,) * max(0, ndim - len(tmpl))
    axes = []
    for t in pad + tuple(tmpl[-ndim:] if ndim < len(tmpl) else tmpl):
        axes.append(pctx.fsdp_axis if t == _F else pctx.model_axis if t == _M else None)
    return _guard(shape, axes, pctx)


def _named_shapes(params: Any) -> Dict[str, Tuple[int, ...]]:
    if isinstance(params, nn.Module):
        return {k: tuple(p.shape) for k, p in params.named_parameters()}
    return {k: tuple(getattr(v, "shape", v)) for k, v in params.items()}


def param_specs(params: Any, cfg: ArchConfig, pctx: ParallelCtx) -> Dict[str, Spec]:
    """The spec of every parameter of ``params`` (a module, or a mapping of
    names to tensors or shapes), by name."""
    return {k: _spec_for(k, s, cfg, pctx) for k, s in _named_shapes(params).items()}


def batch_spec(cfg: ArchConfig, pctx: ParallelCtx, *,
               seq_sharded: bool = False) -> Callable[[Path, Sequence[int]], Spec]:
    """Spec factory for batch leaves (data inputs AND caches), called with a
    leaf's path and shape.

    Cache leaves are recognized by name; their batch dim sits before a known
    trailing layout: k/v [..., B, T, KV, hd], conv_* [..., B, K-1, C],
    ssd [..., B, H, P, N], enc_out [B, T, D]. ``seq_sharded`` (long-context
    decode, batch 1) shards the KV length dim over the data axes instead of
    the batch dim (SP). With kv_heads < tp the KV length splits over
    ``model`` instead of replicating the cache over it."""
    tp = pctx.tp

    def spec_of(path: Path, shape: Sequence[int]) -> Spec:
        keys = _keys(path)
        name = keys[-1] if keys else ""
        shape = tuple(shape)
        ndim = len(shape)
        ba = pctx.batch_axes
        kv_ax = pctx.model_axis if pctx.divisible_by_tp(cfg.num_kv_heads) else None
        di_ax = (pctx.model_axis
                 if cfg.ssm_d_inner and cfg.ssm_d_inner % max(tp, 1) == 0 else None)
        h_ax = (pctx.model_axis
                if cfg.ssm_heads and cfg.ssm_heads % max(tp, 1) == 0 else None)

        if name in ("k", "v") and ndim >= 4:
            lead = (None,) * (ndim - 4)
            if seq_sharded:
                return _guard(shape, lead + (None, ba, kv_ax, None), pctx)
            if kv_ax is None and tp > 1 and pctx.model_axis is not None:
                return _guard(shape, lead + (ba, pctx.model_axis, None, None), pctx)
            return _guard(shape, lead + (ba, None, kv_ax, None), pctx)
        if name == "conv_x" and ndim >= 3:
            lead = (None,) * (ndim - 3)
            return _guard(shape, lead + (None if seq_sharded else ba, None, di_ax), pctx)
        if name in ("conv_b", "conv_c") and ndim >= 3:
            lead = (None,) * (ndim - 3)
            return _guard(shape, lead + (None if seq_sharded else ba, None, None), pctx)
        if name == "ssd" and ndim >= 4:
            lead = (None,) * (ndim - 4)
            return _guard(shape, lead + (None if seq_sharded else ba, h_ax, None, None), pctx)
        if name == "enc_out" and ndim == 3:
            return _guard(shape, (ba, None, None), pctx)
        if ndim == 0:
            return ()
        return _guard(shape, (ba,) + (None,) * (ndim - 1), pctx)

    return spec_of


def _leaves(tree: Any, prefix: Tuple[Any, ...] = ()) -> Dict[Tuple[Any, ...], Any]:
    """Tensors of a dict / list / NamedTuple tree by path."""
    if isinstance(tree, Mapping):
        items = list(tree.items())
    elif isinstance(tree, tuple) and hasattr(tree, "_fields"):
        items = list(zip(tree._fields, tree))
    elif isinstance(tree, (list, tuple)):
        items = list(enumerate(tree))
    else:
        return {prefix: tree}
    out: Dict[Tuple[Any, ...], Any] = {}
    for k, v in items:
        out.update(_leaves(v, prefix + (k,)))
    return out


def _map_tree(tree: Any, fn: Callable[[Tuple[Any, ...], Any], Any],
              prefix: Tuple[Any, ...] = ()) -> Any:
    if isinstance(tree, Mapping):
        return {k: _map_tree(v, fn, prefix + (k,)) for k, v in tree.items()}
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        return type(tree)(*(_map_tree(v, fn, prefix + (f,)) for f, v in zip(tree._fields, tree)))
    if isinstance(tree, (list, tuple)):
        return type(tree)(_map_tree(v, fn, prefix + (i,)) for i, v in enumerate(tree))
    return fn(prefix, tree)


def make_train_shardings(params: Any, batch: Any, cfg: ArchConfig, pctx: ParallelCtx, *,
                         seq_sharded: bool = False) -> Tuple[Dict[str, Spec], Any]:
    """(param specs by name, the batch tree's specs leaf for leaf)."""
    if pctx.mesh is None:
        raise ValueError("make_train_shardings needs a ParallelCtx with a mesh")
    bs = batch_spec(cfg, pctx, seq_sharded=seq_sharded)
    return (param_specs(params, cfg, pctx),
            _map_tree(batch, lambda path, leaf: bs(path, tuple(leaf.shape))))


# --------------------------------------------------------- local slices -----
#: ``keep(name, leaf) -> leaf``: what becomes of each leaf as the model's
#: init functions draw it (``name`` is its path in the whole tree).
Keep = Callable[[str, Tensor], Tensor]


def keep_all(name: str, leaf: Tensor) -> Tensor:
    """The :data:`Keep` of a full draw: every leaf as it is."""
    return leaf


def within(keep: Keep, prefix: str) -> Keep:
    """``keep`` for the leaves of a part whose path is ``prefix``."""
    return lambda name, leaf: keep(prefix + name, leaf)


def local_shape(shape: Sequence[int], spec: Spec, pctx: ParallelCtx) -> Tuple[int, ...]:
    return tuple(d // (pctx.axis_size(ax) if ax is not None else 1)
                 for d, ax in zip(shape, tuple(spec) + (None,) * len(shape)))


def shard_tensor(t: Tensor, spec: Spec, pctx: ParallelCtx) -> Tensor:
    """This rank's slice of the full tensor ``t`` under ``spec``."""
    for dim, ax in enumerate(spec):
        if ax is not None:
            n = pctx.axis_size(ax)
            if n > 1:
                t = t.chunk(n, dim=dim)[pctx.index(ax)]
    return t


def gather_tensor(t: Tensor, spec: Spec, pctx: ParallelCtx) -> Tensor:
    """The full tensor from every rank's slice ``t`` under ``spec`` (no
    autograd)."""
    for dim, ax in reversed(list(enumerate(spec))):
        if ax is not None:
            t = C.gather_tensor(t, pctx.group(ax), dim)
    return t


def _module_with(module: nn.Module, tensors: Mapping[str, Tensor], prefix: str = "") -> nn.Module:
    """A shallow copy of ``module`` whose parameters named in ``tensors``
    (full names) are those tensors; sub-modules are copied the same way,
    the rest is shared."""
    new = copy.copy(module)
    new._parameters = dict(module._parameters)
    new._modules = dict(module._modules)
    for k in list(new._parameters):
        if prefix + k in tensors:
            new._parameters[k] = tensors[prefix + k]  # type: ignore[assignment]
    for k, m in module._modules.items():
        if m is not None:
            new._modules[k] = _module_with(m, tensors, f"{prefix}{k}.")
    return new


def layout_of(params: nn.Module) -> Optional[Dict[str, Spec]]:
    """The specs a local tree was sharded with (``None`` for a full tree)."""
    return getattr(params, "shard_specs", None)


def shard_params(full: nn.Module, cfg: ArchConfig, pctx: ParallelCtx, *,
                 sliced: Optional[Mapping[str, Spec]] = None) -> nn.Module:
    """The full tree (the same on every rank: ``Model.init`` from one seed,
    or ``params_from_reference``) → this rank's local tree: a module of the
    same classes whose parameters are this rank's slices (copies), and whose
    ``shard_specs`` names each one's spec. The parameters named in
    ``sliced`` are this rank's slices already, under the specs given."""
    if pctx.mesh is None:
        return full
    sliced = dict(sliced or {})
    shapes = _named_shapes(full)
    unknown = set(sliced) - set(shapes)
    if unknown:
        raise ValueError(f"sliced names no parameter of the tree: {sorted(unknown)}")
    specs = {k: sliced[k] if k in sliced else _spec_for(k, s, cfg, pctx)
             for k, s in shapes.items()}
    local = {k: nn.Parameter(p.detach() if k in sliced else
                             shard_tensor(p.detach(), specs[k], pctx).clone(),
                             requires_grad=p.requires_grad)
             for k, p in full.named_parameters()}
    out = _module_with(full, local)
    for prefix, mod in out.named_modules():
        at = f"{prefix}." if prefix else ""
        mod._specs = {k: specs[at + k] for k, p in mod._parameters.items() if p is not None}
    out.shard_specs = specs
    return out


def init_local(model: Any, seed: int, cfg: ArchConfig, pctx: ParallelCtx, *,
               device: Any, max_dec_len: int = 4096) -> nn.Module:
    """``shard_params(model.init(seed, ...), cfg, pctx)`` without the full
    tree: each leaf is cut to this rank's slice as soon as it is drawn, so
    the device holds one full leaf at a time beside the slices. The draws
    are the full draw's, in its order, so the slices are the same bits."""
    if pctx.mesh is None:
        return model.init(seed, device=device, max_dec_len=max_dec_len)
    sliced: Dict[str, Spec] = {}

    def keep(name: str, leaf: Tensor) -> Tensor:
        sliced[name] = _spec_for(name, tuple(leaf.shape), cfg, pctx)
        return shard_tensor(leaf, sliced[name], pctx).clone()

    part = model.init(seed, device=device, max_dec_len=max_dec_len, keep=keep)
    return shard_params(part, cfg, pctx, sliced=sliced)


def gather_params(local: nn.Module, cfg: ArchConfig, pctx: ParallelCtx) -> nn.Module:
    """The inverse of :func:`shard_params`: the full tree on every rank
    (new tensors, no ``shard_specs``)."""
    specs = layout_of(local)
    if pctx.mesh is None or specs is None:
        return local
    full = {k: nn.Parameter(gather_tensor(p.detach(), specs[k], pctx),
                            requires_grad=p.requires_grad)
            for k, p in local.named_parameters()}
    out = _module_with(local, full)
    for mod in out.modules():
        mod._specs = None
    out.shard_specs = None
    return out


def _fsdp_dim(spec: Spec, pctx: ParallelCtx) -> Optional[int]:
    if pctx.fsdp_axis is None:
        return None
    for dim, ax in enumerate(spec):
        if ax is not None and ax == pctx.fsdp_axis and ax != pctx.model_axis:
            return dim
    return None


def gather_fsdp(local: nn.Module, pctx: ParallelCtx) -> nn.Module:
    """The ZeRO-3 gather: a view of ``local`` whose FSDP-split dims are
    all-gathered over the FSDP axes (backward: the gradient reduce-scattered
    back to this rank's slice, summed over the data ranks). The MoE's
    expert stacks go through the int8 gather under ``int8_moe_gather``.
    The view's specs name no FSDP axis, so gathering it again is a no-op."""
    specs = layout_of(local)
    if pctx.mesh is None or specs is None:
        return local
    group = pctx.group(pctx.fsdp_axis)
    gathered: Dict[str, Tensor] = {}
    new_specs = dict(specs)
    for k, p in local.named_parameters():
        dim = _fsdp_dim(specs[k], pctx)
        if dim is None:
            continue
        expert = ".moe." in f".{k}" and ".shared." not in f".{k}" and p.ndim == 3
        if expert and pctx.int8_moe_gather:
            gathered[k] = C.int8_all_gather(p, group, dim)
        else:
            gathered[k] = C.all_gather(p, group, dim, scatter_back=True)
        new_specs[k] = tuple(None if i == dim else ax for i, ax in enumerate(specs[k]))
    out = _module_with(local, gathered)
    out.shard_specs = new_specs
    return out


def grad_reduce_axes(spec: Spec, pctx: ParallelCtx) -> Tuple[str, ...]:
    """The data axes a parameter's gradient is still to be summed over: all
    of them but those its FSDP gather already reduce-scattered over."""
    split = set()
    for ax in spec:
        if ax is not None:
            split.update((ax,) if isinstance(ax, str) else ax)
    return tuple(a for a in pctx.data_axes if a not in split)


def split_axes(spec: Spec) -> Tuple[str, ...]:
    """Every axis a leaf is split over (its local sums add up over them)."""
    out: list = []
    for ax in spec:
        if ax is not None:
            out.extend((ax,) if isinstance(ax, str) else ax)
    return tuple(out)


# ---------------------------------------------------------------- batches ---
def batch_is_sharded(batch_size: int, pctx: ParallelCtx) -> bool:
    """Whether a batch of ``batch_size`` rows splits over the data axes (the
    guard of the rules; under ``seq_shard`` the batch stays whole)."""
    dp = pctx.dp
    return pctx.mesh is not None and dp > 1 and not pctx.seq_shard and batch_size % dp == 0


def shard_batch(batch: Mapping[str, Tensor], cfg: ArchConfig,
                pctx: ParallelCtx) -> Dict[str, Tensor]:
    """The global batch (the same on every rank) → this rank's rows: each
    leaf's batch dim split over the data axes where it divides, as
    :func:`batch_spec` says; under ``seq_shard`` every rank keeps the whole
    batch, as the caches then split their length, not their batch."""
    if pctx.mesh is None:
        return dict(batch)
    out = {}
    for k, v in batch.items():
        if v.ndim and batch_is_sharded(v.shape[0], pctx):
            out[k] = shard_tensor(v, (pctx.batch_axes,), pctx)
        else:
            out[k] = v
    return out


def cache_seq_axes(cfg: ArchConfig, pctx: ParallelCtx) -> AxisEntry:
    """The axes the KV caches' length is split over by :func:`batch_spec`:
    the data axes under ``seq_shard``, ``model`` where the KV heads do not
    divide ``tp``, else none."""
    if pctx.mesh is None:
        return None
    if pctx.seq_shard:
        return pctx.batch_axes if pctx.dp > 1 else None
    if not pctx.divisible_by_tp(cfg.num_kv_heads) and pctx.tp > 1 and pctx.model_axis:
        return pctx.model_axis
    return None


def local_caches(full: Any, cfg: ArchConfig, pctx: ParallelCtx,
                 device: torch.device) -> Any:
    """Full caches (zeros; on the ``meta`` device they take no memory) →
    this rank's zero caches on ``device``, each leaf sized by
    :func:`batch_spec`. Raises where the rule would split the caches'
    length over axes that do not divide it: the rule then keeps the length
    whole, and the attention, which reads the split from the rule, would
    not know."""
    bs = batch_spec(cfg, pctx, seq_sharded=pctx.seq_shard)
    seq_axes = cache_seq_axes(cfg, pctx)

    def make(path: Tuple[Any, ...], leaf: Tensor) -> Tensor:
        spec = bs(path, tuple(leaf.shape))
        if _keys(path)[-1] in ("k", "v") and seq_axes is not None and spec[-3] is None:
            raise ValueError(f"a KV cache of {leaf.shape[-3]} positions does not split over "
                             f"{seq_axes} ({pctx.axis_size(seq_axes)} ranks)")
        return torch.zeros(local_shape(leaf.shape, spec, pctx), dtype=leaf.dtype, device=device)

    return _map_tree(full, make)


def gather_rows(x: Tensor, batch_size: int, pctx: ParallelCtx) -> Tensor:
    """Every rank's rows of a batch-sharded output → the global batch (no
    autograd); a batch kept whole is returned as it is."""
    if not batch_is_sharded(batch_size, pctx):
        return x
    return C.gather_tensor(x, pctx.group(pctx.batch_axes), 0)
