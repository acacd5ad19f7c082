"""Parity of the port's attention-family layers (RoPE, the MLPs, attention
with its KV-cache splice and cross-attention) with the JAX reference, at
small widths on the CPU.

Inputs are drawn from a seeded numpy generator and the reference's
weights are carried across as numpy arrays; fp32 is held at 1e-4 relative
and absolute (``tests/test_torch_lm.py``'s ``FP32_TOL``), bf16 at the bf16
ladder (rtol 2e-2, atol 2e-1).
"""

import dataclasses

import numpy as np
import pytest
import torch

from repro.core.tridiag import ensure_x64

ensure_x64()

import repro.api  # noqa: E402,F401  (before repro.telemetry: import-order cycle)
import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs.base import get_config as ref_get_config  # noqa: E402
from repro.models.layers import attention as ref_attn  # noqa: E402
from repro.models.layers.mlp import init_mlp as ref_init_mlp  # noqa: E402
from repro.models.layers.mlp import mlp_apply as ref_mlp_apply  # noqa: E402
from repro.models.layers.rotary import apply_rope as ref_apply_rope  # noqa: E402
from repro.parallel.ctx import ParallelCtx as RefCtx  # noqa: E402
from repro_torch.configs.base import get_config  # noqa: E402
from repro_torch.kernels.common import assert_allclose_by_dtype  # noqa: E402
from repro_torch.models.layers.attention import (  # noqa: E402
    INT32_MAX,
    NEG_INF,
    Attention,
    KVCache,
    attention_apply,
    init_attention,
    make_kv_cache,
)
from repro_torch.models.layers.mlp import MLP, init_mlp, mlp_apply  # noqa: E402
from repro_torch.models.layers.norms import RMSNorm  # noqa: E402
from repro_torch.models.layers.rotary import apply_rope, rope_freqs  # noqa: E402
from repro_torch.parallel.ctx import ParallelCtx  # noqa: E402

FP32_TOL = dict(rtol=1e-4, atol=1e-4)
DTYPES = {"float32": (jnp.float32, torch.float32), "bfloat16": (jnp.bfloat16, torch.bfloat16)}


def _t(a):
    a = np.asarray(a)
    if a.dtype.name == "bfloat16":
        return torch.from_numpy(a.astype(np.float32)).to(torch.bfloat16)
    return torch.from_numpy(np.array(a))


def _np(x):
    if isinstance(x, torch.Tensor):
        return (x.float() if x.dtype == torch.bfloat16 else x).numpy()
    return np.asarray(x.astype(jnp.float32) if x.dtype == jnp.bfloat16 else x)


def _close(got, want, dtype):
    if dtype == "float32":
        np.testing.assert_allclose(_np(got), _np(want), **FP32_TOL)
    else:
        assert_allclose_by_dtype(_np(got), _np(want), jnp.bfloat16)


def _cfg(heads=4, kv_heads=4, qk_norm=False, softcap=None, dtype="float32", **kw):
    base = dict(d_model=64, num_heads=heads, num_kv_heads=kv_heads, head_dim=16,
                qk_norm=qk_norm, attn_softcap=softcap, dtype=dtype, rope_theta=10_000.0, **kw)
    return (dataclasses.replace(ref_get_config("qwen3-4b"), **base),
            dataclasses.replace(get_config("qwen3-4b"), **base))


def _attention_from_reference(p):
    norm = {}
    for key in ("q_norm", "k_norm"):
        if key in p:
            n = RMSNorm(np.asarray(p[key]["scale"]).shape[-1])
            n.scale.copy_(_t(p[key]["scale"]))
            norm[key] = n
    return Attention(*(_t(p[n]) for n in ("wq", "wk", "wv", "wo")), **norm)


def _draw(shape, seed, dtype="float32", scale=1.0):
    a = np.random.default_rng(seed).standard_normal(shape).astype(np.float32) * scale
    return jnp.asarray(a, DTYPES[dtype][0]), _t(a).to(DTYPES[dtype][1])


# ------------------------------------------------------------------- RoPE ---
@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("theta", [10_000.0, 1_000_000.0])
def test_apply_rope_matches_reference(dtype, theta):
    jx, tx = _draw((2, 37, 3, 32), 1, dtype)
    pos = np.random.default_rng(2).integers(0, 5000, size=(2, 37))
    got = apply_rope(tx, torch.from_numpy(pos), theta)
    want = ref_apply_rope(jx, jnp.asarray(pos, jnp.int32), theta)
    assert got.dtype == tx.dtype and got.shape == tx.shape
    _close(got, want, dtype)


def test_rope_freqs_and_zero_position_is_the_identity():
    f = rope_freqs(8, 10_000.0)
    np.testing.assert_allclose(f.numpy(), 1.0 / 10_000.0 ** (np.arange(0, 8, 2) / 8), rtol=1e-6)
    x = torch.randn(1, 3, 2, 8, generator=torch.Generator().manual_seed(0))
    assert torch.equal(apply_rope(x, torch.zeros(1, 3, dtype=torch.long), 10_000.0), x)


# -------------------------------------------------------------------- MLP ---
@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("activation", ["silu_gated", "gelu_gated", "gelu", "sq_relu"])
def test_mlp_apply_matches_reference(activation, dtype):
    jdt, _ = DTYPES[dtype]
    p = ref_init_mlp(jax.random.PRNGKey(3), 64, 96, activation, jdt)
    port = MLP(_t(p["w1"]), _t(p["w2"]), _t(p["w3"]) if "w3" in p else None)
    jx, tx = _draw((2, 9, 64), 4, dtype)
    _close(mlp_apply(port, tx, activation, ParallelCtx()),
           ref_mlp_apply(p, jx, activation, RefCtx()), dtype)


@pytest.mark.parametrize("activation", ["silu_gated", "gelu", "sq_relu"])
def test_init_mlp_shapes_and_seed(activation):
    a, b = (init_mlp(torch.Generator().manual_seed(5), 8, 12, activation, torch.float32)
            for _ in range(2))
    assert a.w1.shape == (8, 12) and a.w2.shape == (12, 8)
    assert (a.w3 is None) == (not activation.endswith("_gated"))
    assert torch.equal(a.w1, b.w1) and torch.equal(a.w2, b.w2)
    with pytest.raises(ValueError):
        init_mlp(torch.Generator(), 8, 12, "relu", torch.float32)


# -------------------------------------------------------------- attention ---
VARIANTS = {
    "mha": dict(heads=4, kv_heads=4),
    "gqa": dict(heads=4, kv_heads=2),
    "mha-qknorm": dict(heads=4, kv_heads=4, qk_norm=True),
    "gqa-qknorm": dict(heads=4, kv_heads=2, qk_norm=True),
}
MASKS = {"plain": (None, None), "softcap": (30.0, None), "window": (None, 24),
         "softcap-window": (30.0, 24)}


@pytest.mark.parametrize("kv_chunk", [16, 64, 100])
@pytest.mark.parametrize("mask", list(MASKS))
@pytest.mark.parametrize("variant", list(VARIANTS))
def test_attention_apply_matches_reference(variant, mask, kv_chunk):
    softcap, window = MASKS[mask]
    ref_cfg, cfg = _cfg(softcap=softcap, **VARIANTS[variant])
    p = ref_attn.init_attention(jax.random.PRNGKey(6), ref_cfg, jnp.float32)
    if cfg.qk_norm:  # nonzero norm scales, so the norms' weights count
        for key in ("q_norm", "k_norm"):
            p[key]["scale"] = _draw((16,), 7 + len(key), scale=0.3)[0]
    jx, tx = _draw((2, 130, 64), 8)
    pos = np.broadcast_to(np.arange(130), (2, 130))
    want, _ = ref_attn.attention_apply(p, jx, jnp.asarray(pos, jnp.int32), ref_cfg, RefCtx(),
                                       window=window, kv_chunk=kv_chunk)
    got, cache = attention_apply(_attention_from_reference(p), tx, torch.from_numpy(pos.copy()),
                                 cfg, ParallelCtx(), window=window, kv_chunk=kv_chunk)
    assert cache is None
    _close(got, want, "float32")


@pytest.mark.parametrize("dtype", list(DTYPES))
def test_attention_cache_splice_matches_reference(dtype):
    """Prefill into a cache at per-row offsets, then decode steps, the last
    ones past the cache's end (the write clamps to the last slot)."""
    ref_cfg, cfg = _cfg(heads=4, kv_heads=2, qk_norm=True, softcap=50.0, dtype=dtype)
    jdt, tdt = DTYPES[dtype]
    p = ref_attn.init_attention(jax.random.PRNGKey(9), ref_cfg, jdt)
    port = _attention_from_reference(p)
    t, s = 24, 16
    jc = ref_attn.make_kv_cache(ref_cfg, 2, t, jdt)
    tc = make_kv_cache(cfg, 2, t, tdt)
    ref_step = jax.jit(lambda p, x, pos, c, start: ref_attn.attention_apply(
        p, x, pos, ref_cfg, RefCtx(), cache=c, cache_index=start, kv_chunk=16))
    steps = [(s, np.array([0, 3]))] + [(1, np.array([s + i, s + 3 + i])) for i in range(7)]
    for i, (n, start) in enumerate(steps):
        jx, tx = _draw((2, n, 64), 20 + i, dtype)
        pos = start[:, None] + np.arange(n)
        want, jc = ref_step(p, jx, jnp.asarray(pos, jnp.int32), jc, jnp.asarray(start, jnp.int32))
        got, tc = attention_apply(port, tx, torch.from_numpy(pos), cfg, ParallelCtx(),
                                  cache=tc, cache_index=torch.from_numpy(start), kv_chunk=16)
        assert tc.k.dtype == tdt and tc.k.shape == (2, t, 2, 16)
        _close(got, want, dtype)
        _close(tc.k, jc.k, dtype)
        _close(tc.v, jc.v, dtype)
    assert int(steps[-1][1].max()) >= t  # the clamp was exercised


def test_cache_splice_clamps_and_raises():
    _, cfg = _cfg(heads=2, kv_heads=1)
    port = init_attention(torch.Generator().manual_seed(10), cfg, torch.float32)
    cache = make_kv_cache(cfg, 2, 8, torch.float32)
    x = torch.randn(2, 3, 64, generator=torch.Generator().manual_seed(11))
    pos = torch.arange(3).expand(2, 3)
    _, new = attention_apply(port, x, pos + 20, cfg, ParallelCtx(), cache=cache,
                             cache_index=torch.tensor([20, -4]))
    written = new.k.abs().sum(dim=(2, 3)) > 0  # [B, T]
    assert written[0].tolist() == [False] * 5 + [True] * 3  # clamped to T - S = 5
    assert written[1].tolist() == [True] * 3 + [False] * 5  # clamped to 0
    assert cache.k.abs().sum() == 0  # the input cache is left as it was
    with pytest.raises(ValueError, match="do not fit a cache of 2"):
        attention_apply(port, x, pos, cfg, ParallelCtx(), cache=make_kv_cache(cfg, 2, 2, torch.float32),
                        cache_index=torch.zeros(2, dtype=torch.int32))
    with pytest.raises(ValueError, match="cache_index without cache"):
        attention_apply(port, x, pos, cfg, ParallelCtx(), cache_index=torch.zeros(2))


@pytest.mark.parametrize("kv_chunk", [16, 1024])
def test_cross_attention_matches_reference(kv_chunk):
    ref_cfg, cfg = _cfg(heads=4, kv_heads=2)
    p = ref_attn.init_attention(jax.random.PRNGKey(12), ref_cfg, jnp.float32)
    jx, tx = _draw((2, 11, 64), 13)
    jsrc, tsrc = _draw((2, 37, 64), 14)
    pos = np.broadcast_to(np.arange(11), (2, 11))
    want, _ = ref_attn.attention_apply(p, jx, jnp.asarray(pos, jnp.int32), ref_cfg, RefCtx(),
                                       xattn_kv=(jsrc, jsrc), kv_chunk=kv_chunk)
    got, _ = attention_apply(_attention_from_reference(p), tx, torch.from_numpy(pos.copy()), cfg,
                             ParallelCtx(), xattn_kv=(tsrc, tsrc), kv_chunk=kv_chunk)
    _close(got, want, "float32")


def test_masking_constants_are_the_references():
    assert NEG_INF == ref_attn.NEG_INF
    assert INT32_MAX == int(jnp.iinfo(jnp.int32).max)


def test_init_attention_matches_the_reference_layout():
    ref_cfg, cfg = _cfg(heads=4, kv_heads=2, qk_norm=True)
    ref = ref_attn.init_attention(jax.random.PRNGKey(0), ref_cfg, jnp.float32)
    port = init_attention(torch.Generator().manual_seed(0), cfg, torch.float32)
    assert port.wq.shape == ref["wq"].shape and port.wk.shape == ref["wk"].shape
    assert port.wv.shape == ref["wv"].shape and port.wo.shape == ref["wo"].shape
    assert port.q_norm.scale.shape == ref["q_norm"]["scale"].shape
