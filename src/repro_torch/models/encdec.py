"""Encoder-decoder assembly (whisper-medium backbone), the counterpart of
``repro.models.encdec``.

The conv audio frontend is a stub, as in the reference: the encoder takes
precomputed frame embeddings ``[B, T_enc, D]``. Positions are absolute (a
sinusoidal table for the encoder, a learned ``dec_pos`` table for the
decoder) and no RoPE is applied (``attention_apply`` skips it when
``cfg.is_encdec``). The reference scans its stacked layers; here each
encoder and decoder layer is a module and the layers run in a Python loop.

Decode caches are ``{"kv": [KVCache] * dec_layers, "enc_out": [B, T_enc,
D]}``. The reference's docstring says the cross-attention K/V are "computed
once at prefill", but its code projects them from ``enc_out`` again at
every decode step; the port follows the code.

Under ``seq_tp`` the encoder and the decoder each split their own length
over ``model`` (:func:`~repro_torch.models.transformer.seq_tp_ctx`: whisper's
1500 frames split over 2 ranks and not over 16): the residual stream holds
this rank's slice, each LayerNorm of it takes its scale and bias through
"f", and the encoder's output is gathered whole before ``enc_ln``, so the
cross-attention reads K/V of the whole encoder sequence on every rank.
"""

from __future__ import annotations

from typing import List, NamedTuple, Optional, Tuple

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
from repro_torch.models.layers.embedding import Embedding, init_embedding, logits_out, lookup
from repro_torch.models.layers.mlp import MLP, init_mlp, mlp_apply
from repro_torch.models.layers.norms import LayerNorm, layer_norm
from repro_torch.models.transformer import Caches, _dtype_of, seq_tp_ctx
from repro_torch.parallel.ctx import ParallelCtx
from repro_torch.parallel.sharding import Keep, keep_all, within

Tensor = torch.Tensor


class EncoderLayer(nn.Module):
    """LayerNorm, non-causal self-attention, LayerNorm and the MLP."""

    def __init__(self, ln1: LayerNorm, attn: Attention, ln2: LayerNorm, mlp: MLP) -> None:
        super().__init__()
        self.ln1 = ln1
        self.attn = attn
        self.ln2 = ln2
        self.mlp = mlp


class DecoderLayer(nn.Module):
    """LayerNorm and causal self-attention (``self_attn``), LayerNorm
    (``ln_x``) and cross-attention to the encoder (``xattn``), LayerNorm
    and the MLP."""

    def __init__(self, ln1: LayerNorm, self_attn: Attention, ln_x: LayerNorm,
                 xattn: Attention, ln2: LayerNorm, mlp: MLP) -> None:
        super().__init__()
        self.ln1 = ln1
        self.self_attn = self_attn
        self.ln_x = ln_x
        self.xattn = xattn
        self.ln2 = ln2
        self.mlp = mlp


class EncDec(nn.Module):
    """The tied embedding, the decoder's position table ``dec_pos``
    [max_dec_len, d], the encoder and decoder layers and their final
    LayerNorms."""

    def __init__(self, emb: Embedding, dec_pos: Tensor, enc_layers: List[EncoderLayer],
                 dec_layers: List[DecoderLayer], enc_ln: LayerNorm, dec_ln: LayerNorm) -> None:
        super().__init__()
        self.emb = emb
        self.dec_pos = nn.Parameter(dec_pos, requires_grad=False)
        self.enc_layers = nn.ModuleList(enc_layers)
        self.dec_layers = nn.ModuleList(dec_layers)
        self.enc_ln = enc_ln
        self.dec_ln = dec_ln


def _sinusoidal(length: int, d: int, *, device: torch.device | str = "cpu") -> Tensor:
    """[length, d] fp32: the sines of every angle, then their cosines
    (concatenated, not interleaved)."""
    pos = torch.arange(length, dtype=torch.float32, device=device)[:, None]
    dim = torch.arange(0, d, 2, dtype=torch.float32, device=device)[None, :]
    angle = pos / torch.pow(torch.tensor(10000.0, device=device), dim / d)
    return torch.cat([torch.sin(angle), torch.cos(angle)], dim=-1)


def _init_enc_layer(gen: torch.Generator, cfg: ArchConfig, dtype: torch.dtype,
                    keep: Keep) -> EncoderLayer:
    d, dev = cfg.d_model, gen.device
    attn = init_attention(gen, cfg, dtype, within(keep, "attn."))
    mlp = init_mlp(gen, d, cfg.d_ff, cfg.activation, dtype, within(keep, "mlp."))
    return EncoderLayer(LayerNorm(d, device=dev), attn, LayerNorm(d, device=dev), mlp)


def _init_dec_layer(gen: torch.Generator, cfg: ArchConfig, dtype: torch.dtype,
                    keep: Keep) -> DecoderLayer:
    d, dev = cfg.d_model, gen.device
    self_attn = init_attention(gen, cfg, dtype, within(keep, "self_attn."))
    xattn = init_attention(gen, cfg, dtype, within(keep, "xattn."))
    mlp = init_mlp(gen, d, cfg.d_ff, cfg.activation, dtype, within(keep, "mlp."))
    return DecoderLayer(LayerNorm(d, device=dev), self_attn, LayerNorm(d, device=dev), xattn,
                        LayerNorm(d, device=dev), mlp)


def init_encdec(gen: torch.Generator, cfg: ArchConfig, *, max_dec_len: int = 4096,
                keep: Keep = keep_all) -> EncDec:
    """Random weights drawn from ``gen`` on ``gen``'s device, in the
    config's dtype (LayerNorms in fp32, as in the reference); ``dec_pos``
    holds ``max_dec_len`` positions. Each drawn leaf is passed through
    ``keep`` with its path in the tree."""
    dtype = _dtype_of(cfg)
    dev = gen.device
    d = cfg.d_model
    enc_layers = [_init_enc_layer(gen, cfg, dtype, within(keep, f"enc_layers.{i}."))
                  for i in range(cfg.enc_layers)]
    dec_layers = [_init_dec_layer(gen, cfg, dtype, within(keep, f"dec_layers.{i}."))
                  for i in range(cfg.dec_layers)]
    emb = init_embedding(gen, cfg, dtype, within(keep, "emb."))
    dec_pos = keep("dec_pos",
                   (torch.randn(max_dec_len, d, generator=gen, device=dev) * 0.01).to(dtype))
    return EncDec(emb, dec_pos, enc_layers, dec_layers, LayerNorm(d, device=dev),
                  LayerNorm(d, device=dev))


def _take_rows(table: Tensor, index: Tensor) -> Tensor:
    """``table[index]`` with JAX's out-of-range rule: a negative index
    counts from the end, then every index is clamped into the table (torch
    would raise)."""
    n = table.shape[0]
    index = index.long()
    return table[torch.where(index < 0, index + n, index).clamp(0, n - 1)]


class _ScaleBias(NamedTuple):
    scale: Tensor
    bias: Tensor


def _res_norm(x: Tensor, norm: LayerNorm, cfg: ArchConfig, pctx: ParallelCtx) -> Tensor:
    """A LayerNorm of the residual stream. Under ``seq_tp`` each model rank
    normalises its slice of the sequence, so the scale and the bias (whole
    on every rank) enter through "f" and their gradients sum over the
    slices."""
    params = (_ScaleBias(pctx.tp_enter(norm.scale), pctx.tp_enter(norm.bias)) if pctx.seq_tp
              else norm)
    return layer_norm(x, params, cfg.norm_eps)  # type: ignore[arg-type]


def encode(params: EncDec, frames: Tensor, cfg: ArchConfig, pctx: ParallelCtx) -> Tensor:
    """frames: [B, T_enc, D] precomputed frame embeddings (frontend stub).
    Returns the whole encoder sequence on every model rank."""
    b, t, d = frames.shape
    pctx = seq_tp_ctx(pctx, t)
    x = frames + _sinusoidal(t, d, device=frames.device).to(frames.dtype)
    x = pctx.seq_split(pctx.shard(x, pctx.batch_axes, None, None))
    positions = torch.arange(t, device=frames.device).expand(b, t)
    for layer in params.enc_layers:
        h = _res_norm(x, layer.ln1, cfg, pctx)
        h, _ = attention_apply(layer.attn, h, positions, cfg, pctx, causal=False)
        x = x + h
        h = _res_norm(x, layer.ln2, cfg, pctx)
        x = x + mlp_apply(layer.mlp, h, cfg.activation, pctx)
    return layer_norm(pctx.seq_gather(x), params.enc_ln, cfg.norm_eps)


def decode(
    params: EncDec,
    tokens: Tensor,                 # [B, S]
    enc_out: Tensor,                # [B, T_enc, D]
    cfg: ArchConfig,
    pctx: ParallelCtx,
    *,
    positions: Optional[Tensor] = None,
    caches: Optional[Caches] = None,
    cache_index: Optional[Tensor] = None,
) -> Tuple[Tensor, Optional[Caches]]:
    """Returns (logits, new caches ``{"kv": [...]}`` or ``None``). The
    tokens are embedded without the sqrt(d) scale, plus their rows of
    ``dec_pos`` (positions clamped into the table, as the reference's
    gather clamps them); the head is the tied embedding."""
    b, s = tokens.shape
    if positions is None:
        positions = torch.arange(s, device=tokens.device).expand(b, s)
    pctx = seq_tp_ctx(pctx, s)
    x = lookup(params.emb, tokens, cfg, pctx) + _take_rows(params.dec_pos, positions)
    x = pctx.seq_split(pctx.shard(x, pctx.batch_axes, None, None))

    kv_in = caches["kv"] if caches is not None else None
    new_kvs: List[KVCache] = []
    for i, layer in enumerate(params.dec_layers):
        h = _res_norm(x, layer.ln1, cfg, pctx)
        h, new_kv = attention_apply(
            layer.self_attn, h, positions, cfg, pctx,
            cache=kv_in[i] if kv_in is not None else None, cache_index=cache_index,
        )
        x = x + h
        h = _res_norm(x, layer.ln_x, cfg, pctx)
        h, _ = attention_apply(layer.xattn, h, positions, cfg, pctx,
                               causal=False, xattn_kv=(enc_out, enc_out))
        x = x + h
        h = _res_norm(x, layer.ln2, cfg, pctx)
        x = x + mlp_apply(layer.mlp, h, cfg.activation, pctx)
        if new_kv is not None:
            new_kvs.append(new_kv)
    x = layer_norm(pctx.seq_gather(x), params.dec_ln, cfg.norm_eps)
    logits = logits_out(params.emb, x, cfg, pctx)
    return logits, ({"kv": new_kvs} if new_kvs else None)


def make_encdec_caches(cfg: ArchConfig, batch: int, max_len: int,
                       *, device: torch.device | str = "cpu") -> Caches:
    """Zero self-attention KV caches of ``max_len`` positions, one per
    decoder layer (``enc_out`` is added by the prefill)."""
    dtype = _dtype_of(cfg)
    return {"kv": [make_kv_cache(cfg, batch, max_len, dtype, device=device)
                   for _ in range(cfg.dec_layers)]}
