"""Decoder-only LM assembly, the counterpart of ``repro.models.transformer``
for the ``ssm`` family (Mamba-2).

The reference scans its layers (``jax.lax.scan`` over stacked parameters);
here the layers are an ``nn.ModuleList`` and the layer loop is a Python loop.
Caches are ``{"ssm": [SSMState, ...]}``, one state per layer (the
reference stacks them as ``[n_groups, 1, ...]`` leaves; see
:mod:`repro_torch.models.convert`). The attention, MLP and MoE families are
still to be ported and raise ``NotImplementedError``.
"""

from __future__ import annotations

from typing import Any, Dict, List, Optional, Tuple

import torch
from torch import nn

from repro_torch.configs.base import ArchConfig
from repro_torch.models.layers.embedding import (
    Embedding,
    embed_tokens,
    init_embedding,
    logits_out,
)
from repro_torch.models.layers.norms import RMSNorm, rms_norm
from repro_torch.models.layers.ssm import SSM, SSMState, init_ssm, make_ssm_state, ssm_apply
from repro_torch.parallel.ctx import ParallelCtx

Tensor = torch.Tensor
Caches = Dict[str, Any]


def not_ported(what: str) -> NotImplementedError:
    return NotImplementedError(
        f"{what}: the port serves the 'ssm' family so far; attention, MLP, MoE, "
        f"hybrid and encdec are still to be ported (ROADMAP, Queue 1)"
    )


def _dtype_of(cfg: ArchConfig) -> torch.dtype:
    return getattr(torch, cfg.dtype)


class Block(nn.Module):
    """One block of the ``ssm`` family: RMSNorm then the Mamba-2 layer."""

    def __init__(self, ln1: RMSNorm, ssm: SSM) -> None:
        super().__init__()
        self.ln1 = ln1
        self.ssm = ssm


class LM(nn.Module):
    """Embedding, the blocks in order, and the final norm."""

    def __init__(self, emb: Embedding, layers: List[Block], final_ln: RMSNorm) -> None:
        super().__init__()
        self.emb = emb
        self.layers = nn.ModuleList(layers)
        self.final_ln = final_ln


# --------------------------------------------------------------- blocks -----
def init_block(gen: torch.Generator, cfg: ArchConfig, dtype: torch.dtype) -> Block:
    if cfg.family != "ssm":
        raise not_ported(f"init_block for family {cfg.family!r}")
    return Block(RMSNorm(cfg.d_model, device=gen.device), init_ssm(gen, cfg, dtype))


def block_apply(
    params: Block,
    x: Tensor,
    cfg: ArchConfig,
    pctx: ParallelCtx,
    *,
    ssm_state: Optional[SSMState],
    want_state: bool,
) -> Tuple[Tensor, Optional[SSMState]]:
    """One ``ssm`` block (the reference's positions, window, KV cache and
    cache index serve attention only, so they are not taken here)."""
    if cfg.family != "ssm":
        raise not_ported(f"block_apply for family {cfg.family!r}")
    h, new_state = ssm_apply(
        params.ssm, rms_norm(x, params.ln1, cfg.norm_eps), cfg, pctx,
        state=ssm_state, return_state=want_state,
    )
    return x + h, new_state


# ----------------------------------------------------------------- model ----
def init_lm(gen: torch.Generator, cfg: ArchConfig) -> LM:
    """Random weights drawn from ``gen`` on ``gen``'s device, in the
    config's dtype (norm scales and the SSM's dt_bias/a_log/d_skip in fp32,
    as in the reference)."""
    if cfg.family != "ssm":
        raise not_ported(f"init_lm for family {cfg.family!r}")
    dtype = _dtype_of(cfg)
    layers = [init_block(gen, cfg, dtype) for _ in range(cfg.num_layers)]
    return LM(init_embedding(gen, cfg, dtype), layers, RMSNorm(cfg.d_model, device=gen.device))


def _stack_layers_apply(
    params: LM,
    x: Tensor,
    cfg: ArchConfig,
    pctx: ParallelCtx,
    *,
    caches: Optional[Caches] = None,
    want_state: bool = False,
) -> Tuple[Tensor, Optional[Caches]]:
    states_in = caches["ssm"] if caches is not None else None
    new_states: List[SSMState] = []
    for i, layer in enumerate(params.layers):
        x, new_state = block_apply(
            layer, x, cfg, pctx,
            ssm_state=states_in[i] if states_in is not None else None,
            want_state=want_state,
        )
        if new_state is not None:
            new_states.append(new_state)
    return x, ({"ssm": new_states} if new_states else None)


def lm_forward(
    params: LM,
    tokens: Tensor,
    cfg: ArchConfig,
    pctx: ParallelCtx,
    *,
    caches: Optional[Caches] = None,
    want_state: bool = False,
) -> Tuple[Tensor, Optional[Caches], Tensor]:
    """Shared forward: returns (logits, new_caches, aux_loss). The ``ssm``
    family has no auxiliary loss (zero, as in the reference); the
    reference's positions and cache index serve attention only."""
    x = embed_tokens(params.emb, tokens, cfg, pctx)
    x, new_caches = _stack_layers_apply(params, x, cfg, pctx, caches=caches,
                                        want_state=want_state)
    x = rms_norm(x, params.final_ln, cfg.norm_eps)
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    return logits_out(params.emb, x, cfg, pctx), new_caches, aux


# ------------------------------------------------------------------ caches --
def make_decoder_caches(cfg: ArchConfig, batch: int, max_len: int,
                        *, device: torch.device | str = "cpu") -> Caches:
    """Zero SSM states, one per layer (``max_len`` does not size them)."""
    if cfg.family != "ssm":
        raise not_ported(f"make_decoder_caches for family {cfg.family!r}")
    return {"ssm": [make_ssm_state(cfg, batch, device=device)
                    for _ in range(cfg.num_layers)]}
