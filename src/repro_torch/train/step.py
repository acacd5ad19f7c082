"""Training step, the counterpart of ``repro.train.step``: loss, gradient
accumulation over micro-batches, optional error-feedback gradient
compression, the optimizer's update.

The model is an ``nn.Module`` (``Model.init``); the optimizer works on
dicts of tensors keyed by parameter name (:mod:`repro_torch.optim`). The
reference returns new parameter arrays; the port adds each update to its
parameter in place, in the parameter's dtype, so the weights are held once.
The remat policy rides on ``pctx.remat`` (applied around each layer).
"""

from __future__ import annotations

from typing import Any, Callable, Dict, NamedTuple, Optional, Tuple, Union

import torch
from torch import nn

from repro_torch.configs.base import ArchConfig
from repro_torch.device import DeviceLike
from repro_torch.models.registry import Model
from repro_torch.optim.adamw import Optimizer
from repro_torch.optim.grad_compress import ef_int8_compressor
from repro_torch.parallel.ctx import ParallelCtx

Tensor = torch.Tensor
Batch = Dict[str, Tensor]
Metrics = Dict[str, Tensor]


class TrainState(NamedTuple):
    params: nn.Module
    opt_state: Any
    step: int
    ef_state: Any = None  # error-feedback buffers (optional)


def cross_entropy(logits: Tensor, labels: Tensor) -> Tensor:
    """Mean token NLL in fp32. labels < 0 are masked out."""
    logp = torch.log_softmax(logits.float(), dim=-1)
    ll = torch.gather(logp, -1, labels.clamp(min=0).long()[..., None])[..., 0]
    mask = (labels >= 0).float()
    return -(ll * mask).sum() / torch.clamp(mask.sum(), min=1.0)


def make_loss_fn(model: Model, cfg: ArchConfig, pctx: ParallelCtx,
                 aux_coef: float = 0.01) -> Callable[[nn.Module, Batch], Tuple[Tensor, Metrics]]:
    def loss_fn(params: nn.Module, batch: Batch) -> Tuple[Tensor, Metrics]:
        logits, aux = model.train_logits(params, batch, pctx)
        nll = cross_entropy(logits, batch["labels"])
        loss = nll + aux_coef * aux
        return loss, {"nll": nll, "aux": aux}

    return loss_fn


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
    and ``aux`` is reported as zero, as the reference's scan does."""
    loss_fn = make_loss_fn(model, cfg, pctx, aux_coef)

    def grads_of(params: nn.Module, batch: Batch) -> Tuple[Tensor, Metrics, Dict[str, Tensor]]:
        named = dict(params.named_parameters())
        loss, metrics = loss_fn(params, batch)
        gs = torch.autograd.grad(loss, list(named.values()), allow_unused=True)
        # An unused parameter's gradient is zero, as jax.grad gives it.
        grads = {k: torch.zeros_like(p) if g is None else g
                 for (k, p), g in zip(named.items(), gs)}
        return loss.detach(), {k: v.detach() for k, v in metrics.items()}, grads

    def compute_grads(params: nn.Module, batch: Batch) -> Tuple[Tensor, Metrics, Dict[str, Tensor]]:
        if microbatches <= 1:
            return grads_of(params, batch)
        b = next(iter(batch.values())).shape[0]
        mb = b // microbatches
        gsum: Dict[str, Tensor] = {}
        loss_sum: Union[float, Tensor] = 0.0
        for i in range(microbatches):
            loss, _, grads = grads_of(params, {k: v[i * mb:(i + 1) * mb] for k, v in batch.items()})
            gsum = {k: (gsum[k] + g) if k in gsum else g.float() for k, g in grads.items()}
            loss_sum = loss_sum + loss
        grads = {k: g / microbatches for k, g in gsum.items()}
        loss = loss_sum / microbatches
        assert isinstance(loss, Tensor)
        aux = torch.zeros((), dtype=torch.float32, device=loss.device)
        return loss, {"nll": loss, "aux": aux}, grads

    return compute_grads


def apply_gradients(state: TrainState, grads: Dict[str, Tensor], optimizer: Optimizer,
                    ef_apply: Optional[Callable] = None) -> Tuple[TrainState, Tensor]:
    """The optimizer's update of ``state`` by ``grads`` (first through the
    error-feedback compressor ``ef_apply`` where given): each update is
    cast to its parameter's dtype and added to the parameter in place.
    Returns the new state and the fp32 norm of the gradients applied."""
    ef_state = state.ef_state
    if ef_apply is not None:
        grads, ef_state = ef_apply(grads, state.ef_state)
    named = dict(state.params.named_parameters())
    values = {k: p.detach() for k, p in named.items()}
    updates, new_opt = optimizer.update(grads, state.opt_state, values, state.step)
    with torch.no_grad():
        torch._foreach_add_(list(named.values()), [updates[k].to(p.dtype) for k, p in named.items()])
    gnorm = torch.sqrt(sum(torch.sum(torch.square(g.float())) for g in grads.values()))
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
    ef_apply = ef_int8_compressor()[1] if compress_grads else None

    def train_step(state: TrainState, batch: Batch) -> Tuple[TrainState, Metrics]:
        loss, metrics, grads = compute_grads(state.params, batch)
        new_state, gnorm = apply_gradients(state, grads, optimizer, ef_apply)
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
