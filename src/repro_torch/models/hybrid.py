"""Hybrid assembly (zamba2-7b), the counterpart of ``repro.models.hybrid``:
a Mamba-2 trunk and one weight-SHARED attention block applied every
``shared_attn_every`` SSM layers on [hidden; embedding] (a 2d → d
in-projection), the Zamba design (per-invocation LoRA omitted, as in the
reference).

Layout: ``n_super`` super-blocks of [the shared block, then e SSM layers],
then a tail of the leftover SSM layers. The reference scans the
super-blocks over stacked parameters; here the SSM layers are one
``nn.ModuleList`` in order (layer ``i·e + j`` is the j-th of super-block
i), and the shared block is one module called ``n_super`` times. Caches are
``{"kv": [KVCache] * n_super, "ssm": [SSMState] * (n_super·e),
"tail_ssm": [SSMState] * tail}`` (no ``tail_ssm`` without a tail).

Under a mesh the shared block's ``w_in`` is column-parallel: its output is
gathered over ``model`` before the attention. Under ``seq_tp`` the residual
stream and the embedding ``x0`` hold this rank's slice of the sequence, as
in :func:`~repro_torch.models.transformer.lm_forward`; the shared block
normalises ``[x; x0]`` on the slice and takes the sequence whole before
``w_in`` (the "f" in front of a column-parallel product must see the same
positions on every rank), then hands the attention its slice again.
"""

from __future__ import annotations

import math
from typing import List, Optional, Tuple

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
from repro_torch.models.layers.norms import RMSNorm, rms_norm
from repro_torch.models.layers.ssm import SSM, SSMState, init_ssm, make_ssm_state, ssm_apply
from repro_torch.models.transformer import Caches, _dtype_of, _res_norm, seq_tp_ctx
from repro_torch.parallel import collectives as C
from repro_torch.parallel.ctx import ParallelCtx, remat_wrap, split_over_model
from repro_torch.parallel.sharding import Keep, keep_all, within

Tensor = torch.Tensor
#: The shared block's MLP activation (the reference's, whatever the config says).
SHARED_ACTIVATION = "gelu_gated"


def _split(cfg: ArchConfig) -> Tuple[int, int, int]:
    e = cfg.shared_attn_every
    n_super = cfg.num_layers // e
    tail = cfg.num_layers - n_super * e
    return n_super, e, tail


class SSMLayer(nn.Module):
    """One trunk layer: RMSNorm (``ln``) then the Mamba-2 layer."""

    def __init__(self, ln: RMSNorm, ssm: SSM) -> None:
        super().__init__()
        self.ln = ln
        self.ssm = ssm


class SharedBlock(nn.Module):
    """RMSNorm over 2d (``ln_in``), ``w_in`` [2d, d], attention, RMSNorm
    (``ln_mlp``) and the gated-GeLU MLP."""

    def __init__(self, ln_in: RMSNorm, w_in: Tensor, attn: Attention, ln_mlp: RMSNorm,
                 mlp: MLP) -> None:
        super().__init__()
        self.ln_in = ln_in
        self.w_in = nn.Parameter(w_in, requires_grad=False)
        self.attn = attn
        self.ln_mlp = ln_mlp
        self.mlp = mlp


class HybridLM(nn.Module):
    """Embedding, the trunk's super-block layers, the shared block, the
    tail layers and the final norm."""

    def __init__(self, emb: Embedding, ssm_layers: List[SSMLayer], shared: SharedBlock,
                 tail_layers: List[SSMLayer], final_ln: RMSNorm) -> None:
        super().__init__()
        self.emb = emb
        self.ssm_layers = nn.ModuleList(ssm_layers)
        self.shared = shared
        self.tail_layers = nn.ModuleList(tail_layers)
        self.final_ln = final_ln


def _init_ssm_layer(gen: torch.Generator, cfg: ArchConfig, dtype: torch.dtype,
                    keep: Keep) -> SSMLayer:
    return SSMLayer(RMSNorm(cfg.d_model, device=gen.device),
                    init_ssm(gen, cfg, dtype, within(keep, "ssm.")))


def init_hybrid(gen: torch.Generator, cfg: ArchConfig, keep: Keep = keep_all) -> HybridLM:
    """Random weights drawn from ``gen`` on ``gen``'s device, in the
    config's dtype (norm scales in fp32, as in the reference); each drawn
    leaf is passed through ``keep`` with its path in the tree."""
    dtype = _dtype_of(cfg)
    n_super, e, tail = _split(cfg)
    d = cfg.d_model
    dev = gen.device
    ssm_layers = [_init_ssm_layer(gen, cfg, dtype, within(keep, f"ssm_layers.{i}."))
                  for i in range(n_super * e)]
    emb = init_embedding(gen, cfg, dtype, within(keep, "emb."))
    shared = SharedBlock(
        RMSNorm(2 * d, device=dev),
        keep("shared.w_in",
             (torch.randn(2 * d, d, generator=gen, device=dev) / math.sqrt(2 * d)).to(dtype)),
        init_attention(gen, cfg, dtype, within(keep, "shared.attn.")),
        RMSNorm(d, device=dev),
        init_mlp(gen, d, cfg.d_ff, SHARED_ACTIVATION, dtype, within(keep, "shared.mlp.")),
    )
    tail_layers = [_init_ssm_layer(gen, cfg, dtype, within(keep, f"tail_layers.{i}."))
                   for i in range(tail)]
    return HybridLM(emb, ssm_layers, shared, tail_layers, RMSNorm(d, device=dev))


def _shared_block(shared: SharedBlock, x: Tensor, x0: Tensor, positions: Tensor,
                  cfg: ArchConfig, pctx: ParallelCtx, kv: Optional[KVCache],
                  cache_index: Optional[Tensor]) -> Tuple[Tensor, Optional[KVCache]]:
    h = pctx.seq_gather(_res_norm(torch.cat([x, x0], dim=-1), shared.ln_in, cfg, pctx))
    if split_over_model(shared, "w_in", -1, pctx):  # column-parallel
        h = C.all_gather(pctx.tp_enter(h) @ shared.w_in, pctx.model_group, -1,
                         scatter_back=False)
    else:
        h = h @ shared.w_in
    h, new_kv = attention_apply(shared.attn, pctx.seq_split(h), positions, cfg, pctx,
                                cache=kv, cache_index=cache_index)
    x = x + h
    h = _res_norm(x, shared.ln_mlp, cfg, pctx)
    return x + mlp_apply(shared.mlp, h, SHARED_ACTIVATION, pctx), new_kv


def _ssm_layer(layer: SSMLayer, x: Tensor, cfg: ArchConfig, pctx: ParallelCtx,
               state: Optional[SSMState], want_state: bool) -> Tuple[Tensor, Optional[SSMState]]:
    h, new_state = ssm_apply(layer.ssm, _res_norm(x, layer.ln, cfg, pctx), cfg, pctx,
                             state=state, return_state=want_state)
    return x + h, new_state


def hybrid_forward(
    params: HybridLM,
    tokens: Tensor,
    cfg: ArchConfig,
    pctx: ParallelCtx,
    *,
    positions: Optional[Tensor] = None,
    caches: Optional[Caches] = None,
    cache_index: Optional[Tensor] = None,
    want_state: bool = False,
) -> Tuple[Tensor, Optional[Caches], Tensor]:
    """Returns (logits, new_caches, aux_loss); the aux loss is zero."""
    n_super, e, tail = _split(cfg)
    b = tokens.shape[0]
    x0 = embed_tokens(params.emb, tokens, cfg, pctx)
    s = x0.shape[1]
    if positions is None:
        positions = torch.arange(s, device=x0.device).expand(b, s)
    pctx = seq_tp_ctx(pctx, s)
    x0 = pctx.seq_split(x0)

    kv_in = caches["kv"] if caches is not None else None
    ssm_in = caches["ssm"] if caches is not None else None
    new_kvs: List[KVCache] = []
    new_states: List[SSMState] = []

    def super_block(x: Tensor, si: int) -> Tuple[Tensor, Optional[KVCache], List[SSMState]]:
        x, new_kv = _shared_block(params.shared, x, x0, positions, cfg, pctx,
                                  kv_in[si] if kv_in is not None else None, cache_index)
        states: List[SSMState] = []
        for j in range(si * e, (si + 1) * e):
            x, new_state = _ssm_layer(params.ssm_layers[j], x, cfg, pctx,
                                      ssm_in[j] if ssm_in is not None else None, want_state)
            if new_state is not None:
                states.append(new_state)
        return x, new_kv, states

    # Each super-block rematerialised as pctx.remat says; the tail is not,
    # as in the reference.
    step = remat_wrap(super_block, pctx)
    x = x0
    for si in range(n_super):
        x, new_kv, states = step(x, si)
        if new_kv is not None:
            new_kvs.append(new_kv)
        new_states.extend(states)
    new_caches: Caches = {}
    if new_kvs:
        new_caches["kv"] = new_kvs
    if new_states:
        new_caches["ssm"] = new_states

    tail_in = caches["tail_ssm"] if caches is not None and tail else None
    tail_states: List[SSMState] = []
    for j, layer in enumerate(params.tail_layers):
        x, new_state = _ssm_layer(layer, x, cfg, pctx,
                                  tail_in[j] if tail_in is not None else None, want_state)
        if new_state is not None:
            tail_states.append(new_state)
    if tail_states:
        new_caches["tail_ssm"] = tail_states

    x = rms_norm(pctx.seq_gather(x), params.final_ln, cfg.norm_eps)
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    return logits_out(params.emb, x, cfg, pctx), (new_caches or None), aux


def make_hybrid_caches(cfg: ArchConfig, batch: int, max_len: int,
                       *, device: torch.device | str = "cpu") -> Caches:
    """Zero caches: a KV cache of ``max_len`` positions a super-block and an
    SSM state a trunk layer and a tail layer."""
    dtype = _dtype_of(cfg)
    n_super, e, tail = _split(cfg)
    caches: Caches = {
        "kv": [make_kv_cache(cfg, batch, max_len, dtype, device=device) for _ in range(n_super)],
        "ssm": [make_ssm_state(cfg, batch, device=device) for _ in range(n_super * e)],
    }
    if tail:
        caches["tail_ssm"] = [make_ssm_state(cfg, batch, device=device) for _ in range(tail)]
    return caches
