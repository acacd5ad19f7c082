"""Decoder-only LM assembly, the counterpart of ``repro.models.transformer``
for the ``ssm``, ``dense``, ``moe`` and ``vlm`` families (Mamba-2, dense
attention with an MLP or a Mixture-of-Experts, and the VLM's text stack
behind a patch connector).

The reference scans its layers (``jax.lax.scan`` over stacked parameters,
gemma2's local/global alternation over pairs); here the layers are an
``nn.ModuleList`` and the layer loop is a Python loop, layer ``i`` taking
the window ``_windows(cfg)[i % len(_windows(cfg))]``. Caches are
``{"ssm": [SSMState, ...]}`` or ``{"kv": [KVCache, ...]}``, one entry per
layer (the reference stacks them as ``[n_groups, g, ...]`` leaves; see
:mod:`repro_torch.models.convert`). The ``hybrid`` and ``encdec`` families
have their own assemblies (:mod:`~repro_torch.models.hybrid`,
:mod:`~repro_torch.models.encdec`).
"""

from __future__ import annotations

import math
from typing import Any, Dict, List, Optional, Tuple

import torch
from torch import nn

from repro_torch.configs.base import ArchConfig
from repro_torch.models.layers.attention import (
    Attention,
    KVCache,
    attention_apply,
    init_attention,
    make_kv_cache,
)
from repro_torch.models.layers.embedding import (
    Embedding,
    embed_tokens,
    init_embedding,
    logits_out,
)
from repro_torch.models.layers.mlp import MLP, init_mlp, mlp_apply
from repro_torch.models.layers.moe import MoE, init_moe, moe_apply
from repro_torch.models.layers.norms import RMSNorm, rms_norm
from repro_torch.models.layers.ssm import SSM, SSMState, init_ssm, make_ssm_state, ssm_apply
from repro_torch.parallel.ctx import ParallelCtx

Tensor = torch.Tensor
Caches = Dict[str, Any]
#: The LM families the port serves: every family of ``ArchConfig``.
PORTED_FAMILIES = ("ssm", "dense", "moe", "vlm", "hybrid", "encdec")
#: The families this module assembles.
DECODER_FAMILIES = ("ssm", "dense", "moe", "vlm")


def not_ported(what: str) -> NotImplementedError:
    return NotImplementedError(
        f"{what}: the port serves the {', '.join(PORTED_FAMILIES)} families"
    )


def _dtype_of(cfg: ArchConfig) -> torch.dtype:
    return getattr(torch, cfg.dtype)


def _check_family(cfg: ArchConfig, what: str) -> None:
    if cfg.family not in DECODER_FAMILIES:
        raise not_ported(f"{what} for family {cfg.family!r}")


class Block(nn.Module):
    """One block: RMSNorm then the Mamba-2 layer (``ssm`` family), or
    RMSNorm, attention, RMSNorm and the MLP (the MoE for the ``moe``
    family), with gemma2's post-norms (``post_ln1``/``post_ln2``) where the
    config has them. Sub-modules a family does not use are ``None``."""

    ssm: Optional[SSM]
    attn: Optional[Attention]
    ln2: Optional[RMSNorm]
    mlp: Optional[MLP]
    moe: Optional[MoE]
    post_ln1: Optional[RMSNorm]
    post_ln2: Optional[RMSNorm]

    def __init__(self, ln1: RMSNorm, ssm: Optional[SSM] = None, *,
                 attn: Optional[Attention] = None, ln2: Optional[RMSNorm] = None,
                 mlp: Optional[MLP] = None, moe: Optional[MoE] = None,
                 post_ln1: Optional[RMSNorm] = None,
                 post_ln2: Optional[RMSNorm] = None) -> None:
        super().__init__()
        self.ln1 = ln1
        self.ssm = ssm
        self.attn = attn
        self.ln2 = ln2
        self.mlp = mlp
        self.moe = moe
        self.post_ln1 = post_ln1
        self.post_ln2 = post_ln2


class LM(nn.Module):
    """Embedding, the blocks in order, the final norm, and the VLM's
    ``connector`` [d, d] (``None`` for the other families)."""

    connector: Optional[nn.Parameter]

    def __init__(self, emb: Embedding, layers: List[Block], final_ln: RMSNorm,
                 connector: Optional[Tensor] = None) -> None:
        super().__init__()
        self.emb = emb
        self.layers = nn.ModuleList(layers)
        self.final_ln = final_ln
        self.connector = None if connector is None else nn.Parameter(connector,
                                                                     requires_grad=False)


# --------------------------------------------------------------- blocks -----
def init_block(gen: torch.Generator, cfg: ArchConfig, dtype: torch.dtype) -> Block:
    """One block of the arch's family (attention + MLP or MoE, or SSM)."""
    _check_family(cfg, "init_block")
    dev = gen.device
    d = cfg.d_model
    if cfg.family == "ssm":
        return Block(RMSNorm(d, device=dev), init_ssm(gen, cfg, dtype))
    attn = init_attention(gen, cfg, dtype)
    ffn = ({"moe": init_moe(gen, cfg, dtype)} if cfg.family == "moe"
           else {"mlp": init_mlp(gen, d, cfg.d_ff, cfg.activation, dtype)})
    post = ({"post_ln1": RMSNorm(d, device=dev), "post_ln2": RMSNorm(d, device=dev)}
            if cfg.post_block_norm else {})
    return Block(RMSNorm(d, device=dev), attn=attn, ln2=RMSNorm(d, device=dev), **ffn, **post)


def block_apply(
    params: Block,
    x: Tensor,
    positions: Optional[Tensor],
    cfg: ArchConfig,
    pctx: ParallelCtx,
    *,
    window: Optional[int],
    kv_cache: Optional[KVCache],
    ssm_state: Optional[SSMState],
    cache_index: Optional[Tensor],
    want_state: bool,
) -> Tuple[Tensor, Optional[KVCache], Optional[SSMState], Tensor]:
    """One block; returns (x, new KV cache, new SSM state, the MoE
    auxiliary loss), the loss zero outside the ``moe`` family."""
    _check_family(cfg, "block_apply")
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    if cfg.family == "ssm":
        h, new_state = ssm_apply(
            params.ssm, rms_norm(x, params.ln1, cfg.norm_eps), cfg, pctx,
            state=ssm_state, return_state=want_state,
        )
        return x + h, None, new_state, aux

    h = rms_norm(x, params.ln1, cfg.norm_eps)
    h, new_kv = attention_apply(
        params.attn, h, positions, cfg, pctx,
        window=window, cache=kv_cache, cache_index=cache_index,
    )
    if cfg.post_block_norm:
        h = rms_norm(h, params.post_ln1, cfg.norm_eps)
    x = x + h

    h = rms_norm(x, params.ln2, cfg.norm_eps)
    if cfg.family == "moe":
        h, aux = moe_apply(params.moe, h, cfg, pctx)
    else:
        h = mlp_apply(params.mlp, h, cfg.activation, pctx)
    if cfg.post_block_norm:
        h = rms_norm(h, params.post_ln2, cfg.norm_eps)
    return x + h, new_kv, None, aux


# ----------------------------------------------------------------- model ----
def _group_size(cfg: ArchConfig) -> int:
    return 2 if cfg.alternate_local_global else 1


def _windows(cfg: ArchConfig) -> Tuple[Optional[int], ...]:
    if cfg.alternate_local_global:
        return (cfg.local_window, None)  # local layer first, then global
    return (None,) if cfg.local_window is None else (cfg.local_window,)


def init_lm(gen: torch.Generator, cfg: ArchConfig) -> LM:
    """Random weights drawn from ``gen`` on ``gen``'s device, in the
    config's dtype (norm scales, the SSM's dt_bias/a_log/d_skip and the MoE
    router in fp32, as in the reference)."""
    _check_family(cfg, "init_lm")
    if cfg.num_layers % _group_size(cfg):
        raise ValueError(f"{cfg.num_layers} layers do not split into groups of "
                         f"{_group_size(cfg)}")
    dtype = _dtype_of(cfg)
    dev = gen.device
    d = cfg.d_model
    layers = [init_block(gen, cfg, dtype) for _ in range(cfg.num_layers)]
    emb = init_embedding(gen, cfg, dtype)
    connector = None
    if cfg.frontend_tokens and cfg.family == "vlm":
        connector = (torch.randn(d, d, generator=gen, device=dev) / math.sqrt(d)).to(dtype)
    return LM(emb, layers, RMSNorm(d, device=dev), connector)


def _stack_layers_apply(
    params: LM,
    x: Tensor,
    positions: Tensor,
    cfg: ArchConfig,
    pctx: ParallelCtx,
    *,
    caches: Optional[Caches] = None,
    cache_index: Optional[Tensor] = None,
    want_state: bool = False,
) -> Tuple[Tensor, Optional[Caches], Tensor]:
    windows = _windows(cfg)
    kv_in = caches.get("kv") if caches is not None else None
    ssm_in = caches.get("ssm") if caches is not None else None
    new_kvs: List[KVCache] = []
    new_states: List[SSMState] = []
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    for i, layer in enumerate(params.layers):
        x, new_kv, new_state, a = block_apply(
            layer, x, positions, cfg, pctx,
            window=windows[i % len(windows)],
            kv_cache=kv_in[i] if kv_in is not None else None,
            ssm_state=ssm_in[i] if ssm_in is not None else None,
            cache_index=cache_index,
            want_state=want_state,
        )
        aux = aux + a
        if new_kv is not None:
            new_kvs.append(new_kv)
        if new_state is not None:
            new_states.append(new_state)
    out: Caches = {}
    if new_kvs:
        out["kv"] = new_kvs
    if new_states:
        out["ssm"] = new_states
    return x, (out or None), aux


def lm_forward(
    params: LM,
    tokens: Tensor,
    cfg: ArchConfig,
    pctx: ParallelCtx,
    *,
    patch_embeds: Optional[Tensor] = None,
    positions: Optional[Tensor] = None,
    caches: Optional[Caches] = None,
    cache_index: Optional[Tensor] = None,
    want_state: bool = False,
) -> Tuple[Tensor, Optional[Caches], Tensor]:
    """Shared forward: returns (logits, new_caches, aux_loss), the MoE
    auxiliary loss summed over the layers (zero outside the ``moe``
    family, as in the reference). The VLM's
    ``patch_embeds`` [B, P, d] go through the connector in front of the
    text; positions default to ``arange(S)`` over the whole sequence."""
    b = tokens.shape[0]
    x = embed_tokens(params.emb, tokens, cfg, pctx)
    if patch_embeds is not None:
        proj = patch_embeds.to(x.dtype) @ params.connector
        x = torch.cat([proj, x], dim=1)
    s = x.shape[1]
    if positions is None:
        positions = torch.arange(s, device=x.device).expand(b, s)
    x, new_caches, aux = _stack_layers_apply(params, x, positions, cfg, pctx, caches=caches,
                                             cache_index=cache_index, want_state=want_state)
    x = rms_norm(x, params.final_ln, cfg.norm_eps)
    return logits_out(params.emb, x, cfg, pctx), new_caches, aux


# ------------------------------------------------------------------ caches --
def make_decoder_caches(cfg: ArchConfig, batch: int, max_len: int,
                        *, device: torch.device | str = "cpu") -> Caches:
    """Zero caches, one per layer: SSM states (``max_len`` does not size
    them) or KV caches of ``max_len`` positions."""
    _check_family(cfg, "make_decoder_caches")
    if cfg.family == "ssm":
        return {"ssm": [make_ssm_state(cfg, batch, device=device)
                        for _ in range(cfg.num_layers)]}
    dtype = _dtype_of(cfg)
    return {"kv": [make_kv_cache(cfg, batch, max_len, dtype, device=device)
                   for _ in range(cfg.num_layers)]}
