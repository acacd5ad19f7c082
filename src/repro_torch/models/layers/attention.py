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

Under a mesh the q heads split over ``model`` (``wq`` column-parallel,
``wo`` row-parallel), and so do the KV heads where they divide ``tp``;
otherwise ``wk``/``wv`` are whole on every rank and each q head reads its
KV head by index. A KV cache keeps this rank's rows as
``repro_torch.parallel.sharding.batch_spec`` says: its length is split
over the data axes under ``seq_shard`` (long-context decode at batch 1),
or over ``model`` where the KV heads do not divide ``tp``. A decode step
against such a cache runs :func:`_sp_cache_attention` (the reference's:
partial online-softmax statistics per length slice, combined by a max and
two sums over the slices' group); a prefill gathers the cache's length
first.
"""

from __future__ import annotations

import math
from typing import NamedTuple, Optional, Tuple

import torch
from torch import nn

import torch.distributed as dist

from repro_torch.configs.base import ArchConfig
from repro_torch.models.layers.norms import RMSNorm, rms_norm
from repro_torch.models.layers.rotary import apply_rope
from repro_torch.parallel import collectives as C
from repro_torch.parallel.ctx import ParallelCtx, split_over_model
from repro_torch.parallel.sharding import Keep, cache_seq_axes, keep_all

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


def init_attention(gen: torch.Generator, cfg: ArchConfig, dtype: torch.dtype,
                   keep: Keep = keep_all) -> Attention:
    """Random weights drawn from ``gen``, on ``gen``'s device, each matrix
    passed through ``keep`` as it is drawn."""
    d, h, kv, hd = cfg.d_model, cfg.num_heads, cfg.num_kv_heads, cfg.resolved_head_dim
    dev = gen.device
    scale_in = 1.0 / math.sqrt(d)
    scale_out = 1.0 / math.sqrt(h * hd)

    def normal(rows: int, cols: int, scale: float) -> Tensor:
        return (torch.randn(rows, cols, generator=gen, device=dev) * scale).to(dtype)

    wq = keep("wq", normal(d, h * hd, scale_in))
    wk = keep("wk", normal(d, kv * hd, scale_in))
    wv = keep("wv", normal(d, kv * hd, scale_in))
    wo = keep("wo", normal(h * hd, d, scale_out))
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


def _sp_cache_attention(q: Tensor, k: Tensor, v: Tensor, q_pos: Tensor, k_pos: Tensor,
                        group: Optional[dist.ProcessGroup], *, softcap: Optional[float],
                        kv_chunk: int) -> Tensor:
    """Decode attention over a cache whose length is split over ``group``:
    each rank's partial online-softmax statistics over its slice (causal,
    no window, as in the reference), combined by a max and two sums over
    the group. No autograd (decode runs under inference mode)."""
    m, den, acc = _flash_stats(q, k, v, q_pos, k_pos, causal=True, window=None,
                               softcap=softcap, kv_chunk=min(kv_chunk, k.shape[1]))
    m_g = C.all_reduce_(m.clone(), group, dist.ReduceOp.MAX)
    scale = torch.exp(m - m_g)
    den_g = C.all_reduce_(den * scale, group)
    acc_g = C.all_reduce_(acc * scale[..., None], group)
    return _finalize(m_g, den_g, acc_g, q.dtype)


def _splice(cache: Tensor, new: Tensor, cache_index: Tensor, *, offset: int = 0,
            total: Optional[int] = None) -> Tensor:
    """``cache`` [B, T, ...] with ``new`` [B, S, ...] written at row
    ``cache_index[b]`` of each batch row, as the reference's
    ``lax.dynamic_update_slice_in_dim`` does: the start is clamped to
    [0, T − S], so a write past the end lands on the last S slots. A cache
    holding the rows ``offset ... offset + T_local`` of ``total`` writes
    only the new rows that fall there."""
    b, t = cache.shape[:2]
    total = t if total is None else total
    s = new.shape[1]
    if s > total:
        raise ValueError(f"cache splice: {s} new positions do not fit a cache of {total}")
    start = cache_index.long().clamp(0, total - s)
    rows = start[:, None] + torch.arange(s, device=cache.device) - offset  # [B, S]
    bidx = torch.arange(b, device=cache.device)[:, None]
    if offset == 0 and total == t:
        out = cache.clone()
        out[bidx, rows] = new.to(cache.dtype)
        return out
    # Rows outside this slice go to one spare row, dropped after.
    inside = (rows >= 0) & (rows < t)
    out = torch.cat([cache, cache.new_zeros((b, 1) + tuple(cache.shape[2:]))], dim=1)
    out[bidx, torch.where(inside, rows, torch.full_like(rows, t))] = new.to(cache.dtype)
    return out[:, :t].contiguous()


class _Scale(NamedTuple):
    scale: Tensor


def _norm(x: Tensor, norm: Optional[RMSNorm], split: bool, cfg: ArchConfig,
          pctx: ParallelCtx) -> Tensor:
    """A qk-norm; over heads split across ``model`` its scale (whole on
    every rank) enters through "f", so its gradient sums over the heads."""
    assert norm is not None
    params = _Scale(pctx.tp_enter(norm.scale)) if split else norm
    return rms_norm(x, params, cfg.norm_eps)  # type: ignore[arg-type]


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
    x = pctx.seq_gather(x)
    b, s, d = x.shape
    h, kvh, hd = cfg.num_heads, cfg.num_kv_heads, cfg.resolved_head_dim
    ba = pctx.batch_axes
    heads_split = split_over_model(params, "wq", -1, pctx)
    kv_split = split_over_model(params, "wk", -1, pctx)
    h_loc, kv_loc = params.wq.shape[1] // hd, params.wk.shape[1] // hd

    xt = pctx.tp_enter(x) if heads_split else x
    q = (xt @ params.wq).reshape(b, s, h_loc, hd)
    kv_src = xattn_kv[0] if xattn_kv is not None else x
    if kv_split:
        kv_src = xt if xattn_kv is None else pctx.tp_enter(kv_src)
    k = (kv_src @ params.wk).reshape(b, -1, kv_loc, hd)
    v = (kv_src @ params.wv).reshape(b, -1, kv_loc, hd)

    if cfg.qk_norm:
        q = _norm(q, params.q_norm, heads_split, cfg, pctx)
        k = _norm(k, params.k_norm, kv_split, cfg, pctx)

    if xattn_kv is None and cfg.num_heads and not cfg.is_encdec:
        # Self-attention: RoPE (whisper uses absolute embeddings, no RoPE).
        q = apply_rope(q, positions, cfg.rope_theta)
        k = apply_rope(k, positions, cfg.rope_theta)
    if heads_split and not kv_split:  # whole K/V entering the per-head work
        k, v = pctx.tp_enter(k), pctx.tp_enter(v)

    q = pctx.shard(q, ba, None, "model", None)
    k = pctx.shard(k, ba, None, None, None)
    v = pctx.shard(v, ba, None, None, None)

    new_cache = None
    sp_group: Optional[dist.ProcessGroup] = None
    if cache is not None:
        # Decode or continued prefill: splice the new K/V in at cache_index.
        if cache_index is None:
            raise ValueError("cache without cache_index")
        seq_axes = cache_seq_axes(cfg, pctx)
        t_loc = cache.k.shape[1]
        n_seq = pctx.axis_size(seq_axes) if seq_axes is not None else 1
        off = pctx.index(seq_axes) * t_loc if n_seq > 1 else 0
        t_cache = t_loc * n_seq
        new_cache = KVCache(k=_splice(cache.k, k, cache_index, offset=off, total=t_cache),
                            v=_splice(cache.v, v, cache_index, offset=off, total=t_cache))
        k, v = new_cache.k, new_cache.v
        if n_seq > 1 and s == 1:
            sp_group = pctx.group(seq_axes)
            k_pos = torch.arange(off, off + t_loc, device=x.device).expand(b, t_loc)
        else:
            if n_seq > 1:  # a prefill reads the whole length
                k = C.gather_tensor(k, pctx.group(seq_axes), 1)
                v = C.gather_tensor(v, pctx.group(seq_axes), 1)
            k_pos = torch.arange(t_cache, device=x.device).expand(b, t_cache)
    elif cache_index is not None:
        raise ValueError("cache_index without cache")
    elif xattn_kv is not None:
        t = k.shape[1]
        k_pos = torch.arange(t, device=x.device).expand(b, t)
    else:
        k_pos = positions

    # The q heads per KV head: [B, S, KV, G, hd]; q head h reads KV head
    # h // G. The scale is applied in q's dtype, as in the reference.
    scale = torch.tensor(1.0 / math.sqrt(hd), dtype=q.dtype, device=q.device)
    all_heads = sp_group is not None and not pctx.seq_shard
    if all_heads:
        # The length split over ``model``: every model rank attends with
        # all heads over its slice, as in the reference.
        q = C.gather_tensor(q, pctx.model_group, 2) if heads_split else q
        qg = q.reshape(b, s, kvh, h // kvh, hd) * scale
    elif heads_split and not kv_split:
        first = pctx.model_rank * h_loc
        idx = torch.div(torch.arange(first, first + h_loc, device=x.device), h // kvh,
                        rounding_mode="floor")
        k, v = k.index_select(2, idx), v.index_select(2, idx)
        qg = q.reshape(b, s, h_loc, 1, hd) * scale
    else:
        qg = q.reshape(b, s, kv_loc, h_loc // kv_loc, hd) * scale
    if sp_group is not None:
        out = _sp_cache_attention(qg, k, v, positions, k_pos, sp_group,
                                  softcap=cfg.attn_softcap, kv_chunk=kv_chunk)
    else:
        out = _online_attention(
            qg, k, v, positions, k_pos,
            causal=causal and xattn_kv is None,
            window=window,
            softcap=cfg.attn_softcap,
            kv_chunk=kv_chunk,
        )
    out = out.reshape(b, s, -1)
    if all_heads and heads_split:  # this rank's heads
        out = out[..., pctx.model_rank * h_loc * hd:(pctx.model_rank + 1) * h_loc * hd]
    out = pctx.shard(out, ba, None, "model")
    return pctx.tp_exit(out @ params.wo, partial=heads_split), new_cache


def make_kv_cache(cfg: ArchConfig, batch: int, max_len: int, dtype: torch.dtype,
                  *, device: torch.device | str = "cpu") -> KVCache:
    shape = (batch, max_len, cfg.num_kv_heads, cfg.resolved_head_dim)
    return KVCache(k=torch.zeros(shape, dtype=dtype, device=device),
                   v=torch.zeros(shape, dtype=dtype, device=device))
