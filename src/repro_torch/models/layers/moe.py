"""Mixture-of-Experts on one device, the counterpart of
``repro.models.layers.moe``.

Each token's router picks its top-k experts; the (token, k) assignments are
sorted by expert into a fixed-capacity ``[E, C, D]`` dispatch buffer, the
expert FFN (gated SiLU) runs as one batched product over E, and the gated
outputs are summed back per token. Tokens that overflow an expert's capacity
are dropped (their residual passes through), the capacity-factor trade, and
shared experts run as a dense gated-SiLU MLP beside the routed ones.

The reference's mesh branch (expert parallelism under ``shard_map``, with the
ZeRO-3 gather of the expert weights and its int8 variant
``_int8_allgather``) is not ported: the port runs on one device, and
``ParallelCtx(mesh=...)`` raises (ROADMAP, Queue 1, Sharding).

Two choices keep the reference's answers and the card's determinism:

- the top-k is the first k of a stable descending sort, so ties go to the
  lower expert id, as ``jax.lax.top_k`` gives them (``torch.topk`` promises
  no order);
- the combine gathers each token's k contributions through the inverse of
  the slot order and sums them over k (``[T, K, D]``), where the reference
  scatter-adds them (``.at[token_of].add``, expert order); ``index_add_``
  would use atomics on the card and give other bits from run to run. Only
  the order of the k additions differs from the reference.

Nothing on the path reads a device value on the host: dropped slots go to
an extra overflow row, as in the reference, and no boolean-mask indexing or
``nonzero`` is used, so a decode step runs without a host sync.
"""

from __future__ import annotations

import math
from typing import Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from repro_torch.configs.base import ArchConfig
from repro_torch.models.layers.mlp import MLP, init_mlp, mlp_apply
from repro_torch.parallel.ctx import ParallelCtx

Tensor = torch.Tensor


class MoE(nn.Module):
    """``router`` [d, E] (fp32), the expert stacks ``w1``/``w3`` [E, d, f]
    and ``w2`` [E, f, d], and the shared experts' gated-SiLU MLP
    (``None`` where the config has none)."""

    shared: Optional[MLP]

    def __init__(self, router: Tensor, w1: Tensor, w3: Tensor, w2: Tensor,
                 shared: Optional[MLP] = None) -> None:
        super().__init__()
        for name, t in (("router", router), ("w1", w1), ("w3", w3), ("w2", w2)):
            setattr(self, name, nn.Parameter(t, requires_grad=False))
        self.shared = shared


def init_moe(gen: torch.Generator, cfg: ArchConfig, dtype: torch.dtype) -> MoE:
    """Random weights drawn from ``gen``, on ``gen``'s device. The expert
    stacks are drawn one expert at a time in fp32 and cast into place, so
    the fp32 transient is one expert's matrix, not the stack's (kimi-k2's
    ``w1`` drawn whole in fp32 would take 22.5 GB)."""
    d, e, f = cfg.d_model, cfg.num_experts, cfg.moe_d_ff
    dev = gen.device

    def stack(rows: int, cols: int) -> Tensor:
        out = torch.empty(e, rows, cols, dtype=dtype, device=dev)
        for i in range(e):
            out[i] = torch.randn(rows, cols, generator=gen, device=dev) / math.sqrt(rows)
        return out

    router = torch.randn(d, e, generator=gen, device=dev) / math.sqrt(d)
    w1, w3, w2 = stack(d, f), stack(d, f), stack(f, d)
    shared = (init_mlp(gen, d, f * cfg.num_shared_experts, "silu_gated", dtype)
              if cfg.num_shared_experts else None)
    return MoE(router, w1, w3, w2, shared)


def _capacity(tokens: int, cfg: ArchConfig) -> int:
    c = int(
        math.ceil(tokens * cfg.experts_per_token * cfg.capacity_factor / cfg.num_experts)
    )
    return max(8, -(-c // 8) * 8)


def _expert_shard(w1: Tensor, w3: Tensor, w2: Tensor, x_flat: Tensor, gates: Tensor,
                  ids: Tensor, *, cfg: ArchConfig, e_start: int, capacity: int) -> Tensor:
    """Dispatch, compute and combine for the experts ``e_start ...
    e_start + E_loc``. x_flat: [T, D]; gates/ids: [T, K]; w*: [E_loc, ...].
    Returns y [T, D] in the experts' dtype."""
    t, d = x_flat.shape
    k = ids.shape[-1]
    e_loc = w1.shape[0]
    dev = x_flat.device

    flat_ids = ids.reshape(t * k)
    flat_gates = gates.reshape(t * k)
    # Slot assignment: stable sort by expert, then rank within expert; the
    # earliest (token, k) pairs of an expert keep its slots.
    order = torch.argsort(flat_ids, stable=True)
    sorted_ids = flat_ids[order]
    seg_start = torch.searchsorted(sorted_ids, torch.arange(cfg.num_experts, device=dev))
    pos = torch.arange(t * k, device=dev) - seg_start[sorted_ids]
    local = (sorted_ids >= e_start) & (sorted_ids < e_start + e_loc)
    keep = local & (pos < capacity)
    overflow = torch.full((), e_loc * capacity, dtype=torch.long, device=dev)
    dest = torch.where(keep, (sorted_ids - e_start) * capacity + pos, overflow)
    token_of = order // k

    # Gather tokens into the [E_loc * C (+1 overflow), D] buffer. Kept
    # slots are distinct; only the overflow row is written more than once.
    disp = torch.zeros(e_loc * capacity + 1, d, dtype=x_flat.dtype, device=dev)
    disp[dest] = x_flat[token_of]
    xe = disp[: e_loc * capacity].reshape(e_loc, capacity, d)

    # Batched expert FFN (gated SiLU).
    h = torch.bmm(xe, w1)
    g = torch.bmm(xe, w3)
    ye = torch.bmm(F.silu(h) * g, w2)

    # Combine: each kept slot's output, gated, back to its (token, k) pair
    # through the inverse of the slot order, then summed over k.
    vals = torch.cat([ye.reshape(e_loc * capacity, d), ye.new_zeros(1, d)], dim=0)
    contrib = vals[dest] * (flat_gates[order] * keep).to(ye.dtype)[:, None]
    inverse = torch.empty_like(order)
    inverse[order] = torch.arange(t * k, device=dev)
    return contrib[inverse].reshape(t, k, d).sum(dim=1)


def route(router: Tensor, x: Tensor, k: int) -> Tuple[Tensor, Tensor, Tensor]:
    """The router in fp32: (probs [..., E], gates [..., k] renormalised to
    sum to one, ids [..., k]). The top k are the first k of a stable
    descending sort, so ties go to the lower expert id."""
    probs = torch.softmax(x.float() @ router, dim=-1)
    ranked, ranks = torch.sort(probs, dim=-1, descending=True, stable=True)
    gates, ids = ranked[..., :k], ranks[..., :k]
    return probs, gates / torch.clamp(gates.sum(-1, keepdim=True), min=1e-9), ids


def moe_apply(params: MoE, x: Tensor, cfg: ArchConfig,
              pctx: ParallelCtx) -> Tuple[Tensor, Tensor]:
    """Returns (y, aux_loss). x: [B, S, D]."""
    b, s, d = x.shape
    dtype = x.dtype
    e = cfg.num_experts
    probs, gates, ids = route(params.router, x, cfg.experts_per_token)

    # Load-balancing aux loss (Switch-style): E · Σ_i mean_prob_i · frac_assigned_i.
    # The counts are integers, exact in fp32 whatever the order of the adds.
    me = probs.reshape(-1, e).mean(dim=0)
    flat = ids.reshape(-1)
    counts = torch.zeros(e, dtype=torch.float32, device=x.device).scatter_add_(
        0, flat, torch.ones(flat.shape, dtype=torch.float32, device=x.device))
    ce = counts / torch.clamp(counts.sum(), min=1.0)
    aux_loss = e * torch.sum(me * ce)

    y = _expert_shard(
        params.w1, params.w3, params.w2,
        x.reshape(b * s, d), gates.to(dtype).reshape(b * s, -1), ids.reshape(b * s, -1),
        cfg=cfg, e_start=0, capacity=_capacity(b * s, cfg),
    ).reshape(b, s, d)

    if cfg.num_shared_experts:
        y = y + mlp_apply(params.shared, x, "silu_gated", pctx)
    return y.to(dtype), aux_loss
