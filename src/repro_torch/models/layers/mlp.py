"""Dense MLPs: gated SiLU/GeLU (llama/qwen/gemma), GeLU and squared-ReLU
(nemotron), the counterparts of ``repro.models.layers.mlp``.

The reference's ``jax.nn.gelu(approximate=True)`` is
``F.gelu(approximate="tanh")``.

Under a mesh ``w1``/``w3`` are column-parallel (the hidden dim split over
``model``) and ``w2`` row-parallel: the input enters through Megatron's "f"
and the partial outputs are summed over ``model`` ("g"), or
reduce-scattered along the sequence under ``seq_tp``
(``ParallelCtx.tp_enter`` / ``tp_exit``).
"""

from __future__ import annotations

import math
from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn

from repro_torch.parallel.ctx import ParallelCtx, split_over_model
from repro_torch.parallel.sharding import Keep, keep_all

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
             dtype: torch.dtype, keep: Keep = keep_all) -> MLP:
    """Random weights drawn from ``gen``, on ``gen``'s device, each matrix
    passed through ``keep`` as it is drawn."""
    if activation not in ACTIVATIONS:
        raise ValueError(activation)
    dev = gen.device

    def normal(rows: int, cols: int) -> Tensor:
        return (torch.randn(rows, cols, generator=gen, device=dev) / math.sqrt(rows)).to(dtype)

    w1 = keep("w1", normal(d, ff))
    w2 = keep("w2", normal(ff, d))
    return MLP(w1, w2, keep("w3", normal(d, ff)) if activation.endswith("_gated") else None)


def mlp_apply(params: MLP, x: Tensor, activation: str, pctx: ParallelCtx) -> Tensor:
    ba = pctx.batch_axes
    x = pctx.seq_gather(x)
    split = split_over_model(params, "w1", -1, pctx)
    if split:
        x = pctx.tp_enter(x)
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
    return pctx.tp_exit(h @ params.w2, partial=split)
