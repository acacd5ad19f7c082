"""Serving step builders, the counterparts of ``repro.serve.steps``: prefill
(prompt → primed caches) and decode (one token against the KV caches and
SSM states). Under a mesh each rank builds and keeps its own slice of the
caches, as ``repro_torch.parallel.sharding.batch_spec`` says
(``Model.make_caches``), and the steps take and return the global batch."""

from __future__ import annotations

from typing import Callable, Dict, Tuple

import torch
from torch import nn

from repro_torch.configs.base import ArchConfig
from repro_torch.models.registry import Model
from repro_torch.models.transformer import Caches
from repro_torch.parallel.ctx import ParallelCtx

Tensor = torch.Tensor


def make_prefill_step(model: Model, cfg: ArchConfig, pctx: ParallelCtx,
                      *, max_len: int) -> Callable[[nn.Module, Dict[str, Tensor]],
                                                   Tuple[Tensor, Caches]]:
    def prefill_step(params: nn.Module, batch: Dict[str, Tensor]) -> Tuple[Tensor, Caches]:
        return model.prefill(params, batch, pctx, max_len=max_len)

    return prefill_step


def make_decode_step(model: Model, cfg: ArchConfig, pctx: ParallelCtx
                     ) -> Callable[[nn.Module, Caches, Tensor, Tensor], Tuple[Tensor, Caches]]:
    def serve_step(params: nn.Module, caches: Caches, token: Tensor,
                   pos: Tensor) -> Tuple[Tensor, Caches]:
        """One new token with the given cache; returns (logits, new caches)."""
        return model.decode_step(params, caches, {"token": token, "pos": pos}, pctx)

    return serve_step
