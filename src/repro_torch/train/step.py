"""Training step, the counterpart of ``repro.train.step``: loss, gradient
accumulation over micro-batches, optional error-feedback gradient
compression, the optimizer's update.

The model is an ``nn.Module`` (``Model.init``); the optimizer works on
dicts of tensors keyed by parameter name (:mod:`repro_torch.optim`). The
reference returns new parameter arrays; the port adds each update to its
parameter in place, in the parameter's dtype, so the weights are held once.
The remat policy rides on ``pctx.remat`` (applied around each layer).

Under a mesh every rank runs the step on its local parameters
(``shard_params``) and the global batch, of which it keeps its rows: the
cross-entropy takes its max and sum-exp over the vocab-split logits summed
over ``model``, the loss is the mean over the global batch's tokens (their
count summed over the data ranks), the FSDP gather's backward has summed
the split parameters' gradients over the FSDP axes, and the rest are
summed over the data axes by the bucketed all-reduce
(``repro_torch.parallel.collectives.BucketedAllReduce``): a hook on each
parameter hands its gradient over as the backward makes it, and a bucket
is all-reduced as soon as it is whole, while the backward goes on. The
bucket count is the paper's heuristic (Eq. 6) fed with the previous
step's backward, timed on the device (CUDA events; the host clock on the
CPU, whose work is synchronous), and the link's rate and latency, measured
by timed all-reduces on the step's first call. The first step has no
backward time yet, and takes one bucket. The reported ``loss`` and
``nll`` are the global batch's. With ``compress_grads`` the error-feedback
int8 round trip is applied to the reduced gradients: each rank quantizes
its slices with the scale of the whole leaf, and its error buffers are
its slices (:mod:`repro_torch.optim.grad_compress`).
"""

from __future__ import annotations

import functools
import time
from typing import Any, Callable, Dict, List, NamedTuple, Optional, Tuple, Union

import torch
import torch.distributed as dist
from torch import nn

from repro_torch.configs.base import ArchConfig
from repro_torch.device import DeviceLike
from repro_torch.models.layers.embedding import vocab_split
from repro_torch.models.registry import Model
from repro_torch.optim.adamw import Optimizer
from repro_torch.optim.grad_compress import ef_int8_compressor
from repro_torch.parallel import collectives as C
from repro_torch.parallel.collectives import tuned_bucket_count
from repro_torch.parallel.ctx import ParallelCtx
from repro_torch.parallel.sharding import (
    Spec,
    batch_is_sharded,
    grad_reduce_axes,
    layout_of,
    shard_batch,
    split_axes,
)

Tensor = torch.Tensor
Batch = Dict[str, Tensor]
Metrics = Dict[str, Tensor]


class TrainState(NamedTuple):
    params: nn.Module
    opt_state: Any
    step: int
    ef_state: Any = None  # error-feedback buffers (optional)


def token_nll(logits: Tensor, labels: Tensor, pctx: Optional[ParallelCtx] = None, *,
              split: bool = False) -> Tuple[Tensor, Tensor]:
    """(the summed NLL of the tokens with labels ≥ 0, their count), in fp32.
    ``split``: the logits hold this rank's vocab range; the max, the
    sum-exp and the label's logit are then reduced over ``model``."""
    mask = (labels >= 0).float()
    if not split:
        logp = torch.log_softmax(logits.float(), dim=-1)
        ll = torch.gather(logp, -1, labels.clamp(min=0).long()[..., None])[..., 0]
        return -(ll * mask).sum(), mask.sum()
    assert pctx is not None
    group = pctx.model_group
    lf = logits.float()
    m = C.all_reduce_(lf.detach().amax(dim=-1, keepdim=True), group, dist.ReduceOp.MAX)
    lse = torch.log(C.reduce_from(torch.exp(lf - m).sum(dim=-1), group)) + m[..., 0]
    v_loc = lf.shape[-1]
    local = labels.long() - pctx.model_rank * v_loc
    inside = (local >= 0) & (local < v_loc)
    picked = torch.gather(lf, -1, local.clamp(0, v_loc - 1)[..., None])[..., 0]
    ll = C.reduce_from(picked * inside.float(), group) - lse
    return -(ll * mask).sum(), mask.sum()


def cross_entropy(logits: Tensor, labels: Tensor) -> Tensor:
    """Mean token NLL in fp32. labels < 0 are masked out."""
    total, count = token_nll(logits, labels)
    return total / torch.clamp(count, min=1.0)


def make_loss_fn(model: Model, cfg: ArchConfig, pctx: ParallelCtx,
                 aux_coef: float = 0.01) -> Callable[[nn.Module, Batch], Tuple[Tensor, Metrics]]:
    """``loss_fn(params, batch) -> (loss, metrics)`` on this rank's rows.
    Under a mesh the loss is this rank's share of the global batch's loss
    (its tokens' NLL over the global token count, plus the aux term), whose
    gradients the data ranks sum; ``metrics`` hold the global ``nll`` and
    ``loss``."""
    def loss_fn(params: nn.Module, batch: Batch) -> Tuple[Tensor, Metrics]:
        logits, aux = model.train_logits(params, batch, pctx)
        if pctx.mesh is None:
            nll = cross_entropy(logits, batch["labels"])
            loss = nll + aux_coef * aux
            return loss, {"nll": nll, "aux": aux}
        total, count = token_nll(logits, batch["labels"], pctx,
                                 split=vocab_split(params.emb, cfg))
        data = pctx.group(pctx.batch_axes)
        nll = total / torch.clamp(C.all_reduce_(count.detach().clone(), data), min=1.0)
        loss = nll + aux_coef * aux
        nll_all = C.all_reduce_(nll.detach().clone(), data)
        return loss, {"nll": nll_all, "aux": aux, "loss": nll_all + aux_coef * aux.detach()}

    return loss_fn


def gradient_reducers(params: nn.Module, specs: Dict[str, Spec], pctx: ParallelCtx,
                      bucket_count: Callable[[Tuple[str, ...], List[Tensor]], int],
                      ) -> Dict[str, C.BucketedAllReduce]:
    """One :class:`~repro_torch.parallel.collectives.BucketedAllReduce` per
    set of data axes a gradient is still to be summed over (those its FSDP
    gather has not summed it over), by parameter name; its bucket count
    from ``bucket_count(axes, leaves)``."""
    named = dict(params.named_parameters())
    by_axes: Dict[Tuple[str, ...], List[str]] = {}
    for k in named:
        axes = grad_reduce_axes(specs[k], pctx)
        if axes and pctx.axis_size(axes) > 1:
            by_axes.setdefault(axes, []).append(k)
    out: Dict[str, C.BucketedAllReduce] = {}
    for axes, names in by_axes.items():
        leaves = {k: named[k] for k in names}
        reduce = C.BucketedAllReduce(leaves, pctx.group(axes),
                                     bucket_count(axes, list(leaves.values())))
        out.update((k, reduce) for k in names)
    return out


def global_sq_norm(grads: Dict[str, Tensor], specs: Optional[Dict[str, Spec]],
                   pctx: ParallelCtx) -> Tensor:
    """The sum of squares of the whole gradients: each local sum added over
    the axes its tensor is split over (every tensor counted once)."""
    names = tuple(pctx.mesh.mesh_dim_names) if pctx.mesh is not None else ()
    by_axes: Dict[Tuple[str, ...], Tensor] = {}
    for k, g in grads.items():
        axes = () if specs is None else tuple(sorted(set(split_axes(specs[k])), key=names.index))
        sq = torch.sum(torch.square(g.float()))
        by_axes[axes] = by_axes[axes] + sq if axes in by_axes else sq
    total = None
    for axes, sq in by_axes.items():
        sq = C.all_reduce_(sq.clone(), pctx.group(axes)) if axes else sq
        total = sq if total is None else total + sq
    assert total is not None
    return total


def _feed_hook(feed: Callable[[str, Tensor], None], name: str, grad: Tensor) -> None:
    feed(name, grad)


def make_grad_fn(
    model: Model,
    cfg: ArchConfig,
    pctx: ParallelCtx,
    *,
    microbatches: int = 1,
    aux_coef: float = 0.01,
) -> Callable[[nn.Module, Batch], Tuple[Tensor, Metrics, Dict[str, Tensor]]]:
    """``grads(params, batch) -> (loss, metrics, grads by parameter name)``.
    With ``microbatches > 1`` the batch is cut into that many slices along
    dim 0; the gradients are fp32 sums over them divided by their count,
    and ``aux`` is reported as zero, as the reference's scan does. Under a
    mesh ``batch`` is the global batch and the gradients are this rank's
    slices of the whole ones."""
    loss_fn = make_loss_fn(model, cfg, pctx, aux_coef)
    last_backward: List[Any] = [None]  # the previous backward: CUDA events, or host seconds
    links: Dict[Tuple[str, ...], Tuple[float, float]] = {}  # measured once per axes

    def backward_s() -> float:
        """The previous step's backward, timed on the device (0 before the
        first: one bucket)."""
        b = last_backward[0]
        if b is None or isinstance(b, float):
            return b or 0.0
        b[1].synchronize()
        return b[0].elapsed_time(b[1]) / 1e3

    def bucket_count(axes: Tuple[str, ...], leaves: List[Tensor]) -> int:
        if axes not in links:
            links[axes] = C.measure_link(pctx.group(axes), leaves[0].device)
        bandwidth, latency = links[axes]
        n, _ = tuned_bucket_count(leaves, link_bandwidth_Bps=bandwidth,
                                  backward_compute_s=backward_s(),
                                  per_collective_latency_s=latency)
        return n

    def grads_of(params: nn.Module, batch: Batch,
                 feed: Optional[Callable[[str, Tensor], None]] = None,
                 ) -> Tuple[Tensor, Metrics, Dict[str, Tensor]]:
        """``feed(name, gradient)`` is called from a hook on each parameter
        as the backward produces its gradient."""
        named = dict(params.named_parameters())
        loss, metrics = loss_fn(params, batch)
        hooks = [] if feed is None else [
            p.register_hook(functools.partial(_feed_hook, feed, k)) for k, p in named.items()]
        cuda = loss.device.type == "cuda"
        if cuda:
            events = (torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True))
            events[0].record()
        t0 = time.perf_counter()
        try:
            gs = torch.autograd.grad(loss, list(named.values()), allow_unused=True)
        finally:
            for h in hooks:
                h.remove()
        if cuda:
            events[1].record()
            last_backward[0] = events
        else:  # the CPU's work is done when the call returns
            last_backward[0] = time.perf_counter() - t0
        # An unused parameter's gradient is zero, as jax.grad gives it.
        grads = {k: torch.zeros_like(p) if g is None else g
                 for (k, p), g in zip(named.items(), gs)}
        loss = metrics.pop("loss", loss)
        return loss.detach(), {k: v.detach() for k, v in metrics.items()}, grads

    def compute_grads(params: nn.Module, batch: Batch) -> Tuple[Tensor, Metrics, Dict[str, Tensor]]:
        if pctx.mesh is None:
            return accumulate(params, batch)
        b = next(iter(batch.values())).shape[0]
        if not batch_is_sharded(b, pctx):
            raise ValueError(f"a global batch of {b} rows does not split over the "
                             f"{pctx.dp} data ranks")
        specs = layout_of(params)
        if specs is None:
            raise ValueError("under a mesh the step takes shard_params' local parameters")
        reducers = gradient_reducers(params, specs, pctx, bucket_count)
        loss, metrics, grads = accumulate(params, shard_batch(batch, cfg, pctx), reducers)
        for reduce in {id(r): r for r in reducers.values()}.values():
            grads.update(reduce.result())
        return loss, metrics, grads

    def accumulate(params: nn.Module, batch: Batch,
                   reducers: Optional[Dict[str, C.BucketedAllReduce]] = None,
                   ) -> Tuple[Tensor, Metrics, Dict[str, Tensor]]:
        """The gradients, the last backward feeding ``reducers`` (their
        sums replace these gradients)."""
        def feed_from(base: Dict[str, Tensor], m: int) -> Optional[Callable[[str, Tensor], None]]:
            if not reducers:
                return None

            def feed(k: str, g: Tensor) -> None:
                if k in reducers:
                    reducers[k].add(k, g if m == 1 else (base[k] + g.float()) / m)
            return feed

        if microbatches <= 1:
            return grads_of(params, batch, feed_from({}, 1))
        b = next(iter(batch.values())).shape[0]
        mb = b // microbatches
        gsum: Dict[str, Tensor] = {}
        loss_sum: Union[float, Tensor] = 0.0
        for i in range(microbatches):
            last = i == microbatches - 1
            loss, _, grads = grads_of(params, {k: v[i * mb:(i + 1) * mb] for k, v in batch.items()},
                                      feed_from(gsum, microbatches) if last else None)
            gsum = {k: (gsum[k] + g) if k in gsum else g.float() for k, g in grads.items()}
            loss_sum = loss_sum + loss
        grads = {k: g / microbatches for k, g in gsum.items()}
        loss = loss_sum / microbatches
        assert isinstance(loss, Tensor)
        aux = torch.zeros((), dtype=torch.float32, device=loss.device)
        return loss, {"nll": loss, "aux": aux}, grads

    return compute_grads


def apply_gradients(state: TrainState, grads: Dict[str, Tensor], optimizer: Optimizer,
                    ef_apply: Optional[Callable] = None,
                    pctx: ParallelCtx = ParallelCtx()) -> Tuple[TrainState, Tensor]:
    """The optimizer's update of ``state`` by ``grads`` (first through the
    error-feedback compressor ``ef_apply`` where given): each update is
    cast to its parameter's dtype and added to the parameter in place.
    Returns the new state and the fp32 norm of the gradients applied (of
    the whole gradients under a mesh)."""
    ef_state = state.ef_state
    if ef_apply is not None:
        grads, ef_state = ef_apply(grads, state.ef_state)
    named = dict(state.params.named_parameters())
    values = {k: p.detach() for k, p in named.items()}
    updates, new_opt = optimizer.update(grads, state.opt_state, values, state.step)
    with torch.no_grad():
        torch._foreach_add_(list(named.values()), [updates[k].to(p.dtype) for k, p in named.items()])
    gnorm = torch.sqrt(global_sq_norm(grads, layout_of(state.params), pctx))
    return TrainState(state.params, new_opt, state.step + 1, ef_state), gnorm


def make_train_step(
    model: Model,
    cfg: ArchConfig,
    pctx: ParallelCtx,
    optimizer: Optimizer,
    *,
    microbatches: int = 1,
    compress_grads: bool = False,
    aux_coef: float = 0.01,
) -> Callable[[TrainState, Batch], Tuple[TrainState, Metrics]]:
    """``train_step(state, batch) -> (new state, metrics)``: ``loss``,
    ``grad_norm``, ``nll`` and ``aux``, as the reference names them."""
    compute_grads = make_grad_fn(model, cfg, pctx, microbatches=microbatches,
                                 aux_coef=aux_coef)

    def train_step(state: TrainState, batch: Batch) -> Tuple[TrainState, Metrics]:
        loss, metrics, grads = compute_grads(state.params, batch)
        # Under a mesh the scale of each leaf is taken over its whole
        # logical gradient (the specs of this state's local parameters).
        ef_apply = (ef_int8_compressor(pctx=pctx, specs=layout_of(state.params))[1]
                    if compress_grads else None)
        new_state, gnorm = apply_gradients(state, grads, optimizer, ef_apply, pctx)
        return new_state, {"loss": loss, "grad_norm": gnorm, **metrics}

    return train_step


def init_train_state(model: Model, cfg: ArchConfig, optimizer: Optimizer,
                     seed: Union[int, torch.Generator], *, device: DeviceLike = "cuda",
                     max_dec_len: int = 4096, compress_grads: bool = False,
                     params: nn.Module | None = None) -> TrainState:
    """Random weights from ``seed`` (or ``params`` as given), made
    trainable: every parameter takes gradients. Serving is unchanged, as
    ``Model.prefill`` and ``decode_step`` run under ``torch.inference_mode``."""
    if params is None:
        params = model.init(seed, device=device, max_dec_len=max_dec_len)
    params.requires_grad_(True)
    values = {k: p.detach() for k, p in params.named_parameters()}
    opt_state = optimizer.init(values)
    ef_state = None
    if compress_grads:
        ef_init, _ = ef_int8_compressor()
        ef_state = ef_init(values)
    return TrainState(params, opt_state, 0, ef_state)
