"""Dense MLPs: gated SiLU/GeLU (llama/qwen/gemma), GeLU and squared-ReLU
(nemotron), the counterparts of ``repro.models.layers.mlp``.

The reference's ``jax.nn.gelu(approximate=True)`` is
``F.gelu(approximate="tanh")``. Its sharding constraints are the identity
on one device (``ParallelCtx.shard``).
"""

from __future__ import annotations

import math
from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn

from repro_torch.parallel.ctx import ParallelCtx

Tensor = torch.Tensor
ACTIVATIONS = ("silu_gated", "gelu_gated", "gelu", "sq_relu")


class MLP(nn.Module):
    """``w1`` [d, ff], ``w2`` [ff, d] and, for the gated activations,
    ``w3`` [d, ff]."""

    w3: Optional[nn.Parameter]

    def __init__(self, w1: Tensor, w2: Tensor, w3: Optional[Tensor] = None) -> None:
        super().__init__()
        self.w1 = nn.Parameter(w1, requires_grad=False)
        self.w2 = nn.Parameter(w2, requires_grad=False)
        self.w3 = None if w3 is None else nn.Parameter(w3, requires_grad=False)


def init_mlp(gen: torch.Generator, d: int, ff: int, activation: str,
             dtype: torch.dtype) -> MLP:
    """Random weights drawn from ``gen``, on ``gen``'s device."""
    if activation not in ACTIVATIONS:
        raise ValueError(activation)
    dev = gen.device

    def normal(rows: int, cols: int) -> Tensor:
        return (torch.randn(rows, cols, generator=gen, device=dev) / math.sqrt(rows)).to(dtype)

    w1, w2 = normal(d, ff), normal(ff, d)
    return MLP(w1, w2, normal(d, ff) if activation.endswith("_gated") else None)


def mlp_apply(params: MLP, x: Tensor, activation: str, pctx: ParallelCtx) -> Tensor:
    ba = pctx.batch_axes
    h = pctx.shard(x @ params.w1, ba, None, "model")
    if activation == "silu_gated":
        h = F.silu(h) * (x @ params.w3)
    elif activation == "gelu_gated":
        h = F.gelu(h, approximate="tanh") * (x @ params.w3)
    elif activation == "gelu":
        h = F.gelu(h, approximate="tanh")
    elif activation == "sq_relu":
        r = F.relu(h)
        h = r * r
    else:
        raise ValueError(activation)
    h = pctx.shard(h, ba, None, "model")
    return pctx.shard_residual(h @ params.w2)
