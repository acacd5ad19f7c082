"""Attention: GQA/MHA with RoPE, qk-norm, logit softcap, local windows,
cross-attention and KV caches, the counterpart of
``repro.models.layers.attention``.

The core is the reference's chunked online softmax ("flash-style") over KV
chunks of ``kv_chunk`` keys, in fp32: the T × T score matrix is never
materialized. It is plain tensor code that follows the reference's
arithmetic (the same masks, the same ``NEG_INF`` and the same order of the
running max, denominator and accumulator updates); the chunks are a Python
loop where the reference scans. The projections are ``@``, as the reference
computes them.

The reference's ``_sp_cache_attention`` (decode with the cache sharded
along T over a mesh) is not ported: the port runs on one device, and
``ParallelCtx(mesh=...)`` raises (ROADMAP, Queue 1).
"""

from __future__ import annotations

import math
from typing import NamedTuple, Optional, Tuple

import torch
from torch import nn

from repro_torch.configs.base import ArchConfig
from repro_torch.models.layers.norms import RMSNorm, rms_norm
from repro_torch.models.layers.rotary import apply_rope
from repro_torch.parallel.ctx import ParallelCtx

Tensor = torch.Tensor
NEG_INF = -2.0e38
#: The key position of padding past the last KV chunk (``jnp.iinfo(int32).max``).
INT32_MAX = 2**31 - 1


class KVCache(NamedTuple):
    k: Tensor  # [B, T, KV, hd]
    v: Tensor  # [B, T, KV, hd]


class Attention(nn.Module):
    """``wq`` [d, H·hd], ``wk``/``wv`` [d, KV·hd], ``wo`` [H·hd, d], and the
    qk-norms (``None`` where the config has none)."""

    q_norm: Optional[RMSNorm]
    k_norm: Optional[RMSNorm]

    def __init__(self, wq: Tensor, wk: Tensor, wv: Tensor, wo: Tensor,
                 q_norm: Optional[RMSNorm] = None, k_norm: Optional[RMSNorm] = None) -> None:
        super().__init__()
        for name, t in (("wq", wq), ("wk", wk), ("wv", wv), ("wo", wo)):
            setattr(self, name, nn.Parameter(t, requires_grad=False))
        self.q_norm = q_norm
        self.k_norm = k_norm


def init_attention(gen: torch.Generator, cfg: ArchConfig, dtype: torch.dtype) -> Attention:
    """Random weights drawn from ``gen``, on ``gen``'s device."""
    d, h, kv, hd = cfg.d_model, cfg.num_heads, cfg.num_kv_heads, cfg.resolved_head_dim
    dev = gen.device
    scale_in = 1.0 / math.sqrt(d)
    scale_out = 1.0 / math.sqrt(h * hd)

    def normal(rows: int, cols: int, scale: float) -> Tensor:
        return (torch.randn(rows, cols, generator=gen, device=dev) * scale).to(dtype)

    wq, wk, wv = normal(d, h * hd, scale_in), normal(d, kv * hd, scale_in), normal(d, kv * hd, scale_in)
    wo = normal(h * hd, d, scale_out)
    if cfg.qk_norm:
        return Attention(wq, wk, wv, wo, RMSNorm(hd, device=dev), RMSNorm(hd, device=dev))
    return Attention(wq, wk, wv, wo)


def _flash_stats(
    q: Tensor,      # [B, Sq, KV, G, hd]  (already scaled)
    k: Tensor,      # [B, T, KV, hd]
    v: Tensor,      # [B, T, KV, hd]
    q_pos: Tensor,  # [B, Sq] integer
    k_pos: Tensor,  # [B, T] integer (padding past the keys: INT32_MAX)
    *,
    causal: bool,
    window: Optional[int],
    softcap: Optional[float],
    kv_chunk: int,
) -> Tuple[Tensor, Tensor, Tensor]:
    """The running max, denominator and accumulator ([B, KV, G, Sq] and
    [B, KV, G, Sq, hd], fp32) after every KV chunk."""
    b, sq, kvh, g, hd = q.shape
    t = k.shape[1]
    kv_chunk = min(kv_chunk, t)
    n_chunks = -(-t // kv_chunk)
    pad = n_chunks * kv_chunk - t
    q_pos, k_pos = q_pos.long(), k_pos.long()
    if pad:
        k = torch.nn.functional.pad(k, (0, 0, 0, 0, 0, pad))
        v = torch.nn.functional.pad(v, (0, 0, 0, 0, 0, pad))
        k_pos = torch.nn.functional.pad(k_pos, (0, pad), value=INT32_MAX)

    q32 = q.float()
    dev = q.device
    m = torch.full((b, kvh, g, sq), NEG_INF, dtype=torch.float32, device=dev)
    den = torch.zeros((b, kvh, g, sq), dtype=torch.float32, device=dev)
    acc = torch.zeros((b, kvh, g, sq, hd), dtype=torch.float32, device=dev)
    neg_inf = torch.full((), NEG_INF, dtype=torch.float32, device=dev)
    for i in range(n_chunks):
        lo, hi = i * kv_chunk, (i + 1) * kv_chunk
        k_i, v_i, kp_i = k[:, lo:hi].float(), v[:, lo:hi].float(), k_pos[:, lo:hi]
        s = torch.einsum("bqkgh,bckh->bkgqc", q32, k_i)  # [B, KV, G, Sq, c]
        if softcap is not None:
            s = torch.tanh(s / softcap) * softcap
        valid = (kp_i < INT32_MAX)[:, None, :].expand(b, sq, kv_chunk)  # padding
        if causal:
            valid = valid & (kp_i[:, None, :] <= q_pos[:, :, None])
        if window is not None:
            valid = valid & (q_pos[:, :, None] - kp_i[:, None, :] < window)
        s = torch.where(valid[:, None, None], s, neg_inf)
        m_new = torch.maximum(m, s.amax(dim=-1))
        p = torch.exp(s - m_new[..., None])
        corr = torch.exp(m - m_new)
        den = den * corr + p.sum(dim=-1)
        acc = acc * corr[..., None] + torch.einsum("bkgqc,bckh->bkgqh", p, v_i)
        m = m_new
    return m, den, acc


def _finalize(m: Tensor, den: Tensor, acc: Tensor, dtype: torch.dtype) -> Tensor:
    out = acc / torch.clamp(den, min=1e-30)[..., None]
    # [B, KV, G, Sq, hd] -> [B, Sq, KV, G, hd]
    return out.movedim(3, 1).to(dtype)


def _online_attention(q: Tensor, k: Tensor, v: Tensor, q_pos: Tensor, k_pos: Tensor, *,
                      causal: bool, window: Optional[int], softcap: Optional[float],
                      kv_chunk: int) -> Tensor:
    m, den, acc = _flash_stats(q, k, v, q_pos, k_pos, causal=causal, window=window,
                               softcap=softcap, kv_chunk=kv_chunk)
    return _finalize(m, den, acc, q.dtype)


def _splice(cache: Tensor, new: Tensor, cache_index: Tensor) -> Tensor:
    """``cache`` [B, T, ...] with ``new`` [B, S, ...] written at row
    ``cache_index[b]`` of each batch row, as the reference's
    ``lax.dynamic_update_slice_in_dim`` does: the start is clamped to
    [0, T − S], so a write past the end lands on the last S slots."""
    b, t = cache.shape[:2]
    s = new.shape[1]
    if s > t:
        raise ValueError(f"cache splice: {s} new positions do not fit a cache of {t}")
    start = cache_index.long().clamp(0, t - s)
    rows = start[:, None] + torch.arange(s, device=cache.device)  # [B, S]
    out = cache.clone()
    out[torch.arange(b, device=cache.device)[:, None], rows] = new.to(cache.dtype)
    return out


def attention_apply(
    params: Attention,
    x: Tensor,                      # [B, S, D]
    positions: Tensor,              # [B, S]
    cfg: ArchConfig,
    pctx: ParallelCtx,
    *,
    causal: bool = True,
    window: Optional[int] = None,
    cache: Optional[KVCache] = None,
    cache_index: Optional[Tensor] = None,    # [B] write offset into the cache
    xattn_kv: Optional[Tuple[Tensor, ...]] = None,  # cross-attention K/V source
    kv_chunk: int = 1024,
) -> Tuple[Tensor, Optional[KVCache]]:
    b, s, d = x.shape
    h, kvh, hd = cfg.num_heads, cfg.num_kv_heads, cfg.resolved_head_dim
    ba = pctx.batch_axes

    q = (x @ params.wq).reshape(b, s, h, hd)
    kv_src = xattn_kv[0] if xattn_kv is not None else x
    k = (kv_src @ params.wk).reshape(b, -1, kvh, hd)
    v = (kv_src @ params.wv).reshape(b, -1, kvh, hd)

    if cfg.qk_norm:
        q = rms_norm(q, params.q_norm, cfg.norm_eps)
        k = rms_norm(k, params.k_norm, cfg.norm_eps)

    if xattn_kv is None and cfg.num_heads and not cfg.is_encdec:
        # Self-attention: RoPE (whisper uses absolute embeddings, no RoPE).
        q = apply_rope(q, positions, cfg.rope_theta)
        k = apply_rope(k, positions, cfg.rope_theta)

    q = pctx.shard(q, ba, None, "model", None)
    k = pctx.shard(k, ba, None, None, None)
    v = pctx.shard(v, ba, None, None, None)

    new_cache = None
    if cache is not None:
        # Decode or continued prefill: splice the new K/V in at cache_index.
        if cache_index is None:
            raise ValueError("cache without cache_index")
        t_cache = cache.k.shape[1]
        new_cache = KVCache(k=_splice(cache.k, k, cache_index),
                            v=_splice(cache.v, v, cache_index))
        k, v = new_cache.k, new_cache.v
        k_pos = torch.arange(t_cache, device=x.device).expand(b, t_cache)
    elif cache_index is not None:
        raise ValueError("cache_index without cache")
    elif xattn_kv is not None:
        t = k.shape[1]
        k_pos = torch.arange(t, device=x.device).expand(b, t)
    else:
        k_pos = positions

    # Group the q heads per KV head: [B, S, KV, G, hd]; q head h reads KV
    # head h // G. The scale is applied in q's dtype, as in the reference.
    scale = torch.tensor(1.0 / math.sqrt(hd), dtype=q.dtype, device=q.device)
    qg = q.reshape(b, s, kvh, h // kvh, hd) * scale
    out = _online_attention(
        qg, k, v, positions, k_pos,
        causal=causal and xattn_kv is None,
        window=window,
        softcap=cfg.attn_softcap,
        kv_chunk=kv_chunk,
    )
    out = pctx.shard(out.reshape(b, s, h * hd), ba, None, "model")
    return pctx.shard_residual(out @ params.wo), new_cache


def make_kv_cache(cfg: ArchConfig, batch: int, max_len: int, dtype: torch.dtype,
                  *, device: torch.device | str = "cpu") -> KVCache:
    shape = (batch, max_len, cfg.num_kv_heads, cfg.resolved_head_dim)
    return KVCache(k=torch.zeros(shape, dtype=dtype, device=device),
                   v=torch.zeros(shape, dtype=dtype, device=device))
