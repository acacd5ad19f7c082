"""Parity of the port's encoder-decoder (whisper-medium) serving path with
the JAX reference, at smoke size on the CPU.

The reference's ``Model(cfg).init(PRNGKey(0))`` weights are carried across
with ``params_from_reference``; frames are drawn with numpy from a seed.
LayerNorm, the sinusoidal table, the encoder's output, prefill logits, the
KV caches with ``enc_out`` and four decode steps are compared in fp32 at
1e-4 (relative and absolute), where each side feeds its own greedy token
and the tokens must be identical, and in bf16 at the bf16 ladder (rtol
2e-2, atol 2e-1), where both sides are fed the reference's token. Decoder
positions past ``max_dec_len`` are clamped into the table on both sides.
The port's ``serve`` is held to ``repro.launch.serve.serve``.
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
from repro.launch import serve as ref_serve  # noqa: E402
from repro.models import encdec as ref_encdec  # noqa: E402
from repro.models.layers import norms as ref_norms  # noqa: E402
from repro.models.registry import Model as RefModel  # noqa: E402
from repro.parallel.ctx import ParallelCtx as RefCtx  # noqa: E402
from repro_torch.configs.base import get_config  # noqa: E402
from repro_torch.kernels.common import assert_allclose_by_dtype  # noqa: E402
from repro_torch.launch import serve as port_serve  # noqa: E402
from repro_torch.models import encdec  # noqa: E402
from repro_torch.models import transformer as T  # noqa: E402
from repro_torch.models.convert import (  # noqa: E402
    caches_from_reference,
    caches_to_reference,
    params_from_reference,
)
from repro_torch.models.layers import norms  # noqa: E402
from repro_torch.models.layers.embedding import padded_vocab  # noqa: E402
from repro_torch.models.registry import Model, build_model  # noqa: E402
from repro_torch.parallel.ctx import ParallelCtx  # noqa: E402

ARCH = "whisper-medium"
FP32_TOL = dict(rtol=1e-4, atol=1e-4)
FRAMES = 24
PROMPT = 20


def _cfgs(dtype="float32"):
    return (dataclasses.replace(ref_get_config(ARCH).smoke(), dtype=dtype),
            dataclasses.replace(get_config(ARCH).smoke(), dtype=dtype))


def _host(x):
    return np.asarray(x.astype(jnp.float32) if x.dtype == jnp.bfloat16 else x)


def _np(t):
    return (t.float() if t.dtype == torch.bfloat16 else t).detach().numpy()


def _both(a, dtype):
    return jnp.asarray(a, jnp.dtype(dtype)), torch.from_numpy(a).to(getattr(torch, dtype))


def _frames(cfg, b, t, seed):
    return np.random.default_rng(seed).standard_normal((b, t, cfg.d_model)).astype(np.float32)


def _params(max_dec_len=4096, dtype="float32"):
    ref_cfg, cfg = _cfgs(dtype)
    jp = RefModel(ref_cfg).init(jax.random.PRNGKey(0), max_dec_len=max_dec_len)
    return ref_cfg, cfg, jp, params_from_reference(jax.tree.map(np.asarray, jp), cfg,
                                                   device="cpu")


def _close(got, want, dtype):
    if dtype == "float32":
        np.testing.assert_allclose(got, want, **FP32_TOL)
    else:
        assert_allclose_by_dtype(got, want, jnp.bfloat16)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_layer_norm_matches_reference_at_a_large_mean(dtype):
    """A mean of 100 against a spread of 1 (fp32's cancellation in x - mean
    stays under 1e-5 there): an unbiased variance (torch's default) would
    miss by a factor (d-1)/d."""
    d = 24
    rng = np.random.default_rng(0)
    x = (100.0 + rng.standard_normal((3, 5, d))).astype(np.float32)
    scale, bias = (1.0 + 0.1 * rng.standard_normal(d)).astype(np.float32), \
        (0.1 * rng.standard_normal(d)).astype(np.float32)
    jx, tx = _both(x, dtype)
    ln = norms.LayerNorm(d)
    ln.scale.copy_(torch.from_numpy(scale))
    ln.bias.copy_(torch.from_numpy(bias))
    want = ref_norms.layer_norm(jx, {"scale": jnp.asarray(scale), "bias": jnp.asarray(bias)})
    got = norms.layer_norm(tx, ln)
    assert got.dtype == tx.dtype
    _close(_np(got), _host(want), dtype)
    if dtype == "float32":
        biased = (tx - tx.mean(-1, keepdim=True)) * torch.rsqrt(tx.var(-1, keepdim=True) + 1e-5)
        assert not np.allclose(_np(biased * ln.scale + ln.bias), _host(want), **FP32_TOL)


def test_layer_norm_starts_at_ones_and_zeros():
    ln = norms.LayerNorm(6)
    want = ref_norms.init_layernorm(6)
    np.testing.assert_array_equal(ln.scale.numpy(), np.asarray(want["scale"]))
    np.testing.assert_array_equal(ln.bias.numpy(), np.asarray(want["bias"]))
    assert ln.scale.dtype == ln.bias.dtype == torch.float32


@pytest.mark.parametrize("length,d", [(16, 128), (1500, 1024)])
def test_sinusoidal_matches_reference(length, d):
    """Sines then cosines, concatenated; at 1500 positions the angles reach
    1499 rad, where one fp32 ulp of the angle is 1.2e-4."""
    got = encdec._sinusoidal(length, d).numpy()
    want = np.asarray(ref_encdec._sinusoidal(length, d))
    assert got.shape == want.shape == (length, d)
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-4 if length <= 16 else 3e-4)
    np.testing.assert_array_equal(got[0, : d // 2], 0.0)
    np.testing.assert_array_equal(got[0, d // 2:], 1.0)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_encode_matches_reference(dtype):
    ref_cfg, cfg, jp, tp = _params(dtype=dtype)
    jf, tf = _both(_frames(cfg, 2, FRAMES, seed=1), dtype)
    want = ref_encdec.encode(jp, jf, ref_cfg, RefCtx())
    with torch.inference_mode():
        got = encdec.encode(tp, tf, cfg, ParallelCtx())
    assert got.shape == tf.shape and got.dtype == tf.dtype
    _close(_np(got), _host(want), dtype)


def _ref_caches(jc):
    out = {"kv": {f: _host(getattr(jc["kv"], f)) for f in jc["kv"]._fields}}
    out["enc_out"] = _host(jc["enc_out"])
    return out


def _run_both(dtype, tokens, frames, steps, *, max_dec_len=4096, pos0=None):
    """Prefill ``tokens`` against ``frames`` and decode ``steps`` tokens on
    both sides, decode positions from ``pos0`` (default: after the prompt).
    In fp32 each side feeds its own argmax; in bf16 both are fed the
    reference's."""
    ref_cfg, cfg, jp, tp = _params(max_dec_len, dtype)
    ref_model, model = RefModel(ref_cfg), Model(cfg)
    b, s = tokens.shape
    max_len = s + steps
    pos0 = s if pos0 is None else pos0
    jf, tf = _both(frames, dtype)
    ref_prefill = jax.jit(lambda p, batch: ref_model.prefill(p, batch, RefCtx(), max_len=max_len))
    ref_decode = jax.jit(lambda p, c, batch: ref_model.decode_step(p, c, batch, RefCtx()))
    jl, jc = ref_prefill(jp, {"tokens": jnp.asarray(tokens, jnp.int32), "frames": jf})
    tl, tc = model.prefill(tp, {"tokens": torch.from_numpy(tokens), "frames": tf}, ParallelCtx(),
                           max_len=max_len)
    out = [((_host(jl), _np(tl)), (_ref_caches(jc), caches_to_reference(tc, cfg)))]
    jt = jnp.argmax(jl[:, -1:], axis=-1).astype(jnp.int32)
    tt = torch.argmax(tl[:, -1:], dim=-1)
    toks = ([np.asarray(jt)[:, 0].tolist()], [tt[:, 0].tolist()])
    for i in range(steps):
        if dtype != "float32":
            tt = torch.from_numpy(np.asarray(jt, np.int64))
        pos = pos0 + i
        jl, jc = ref_decode(jp, jc, {"token": jt, "pos": jnp.full((b,), pos, jnp.int32)})
        tl, tc = model.decode_step(
            tp, tc, {"token": tt, "pos": torch.full((b,), pos, dtype=torch.int32)}, ParallelCtx())
        out.append(((_host(jl), _np(tl)), (_ref_caches(jc), caches_to_reference(tc, cfg))))
        jt = jnp.argmax(jl[:, -1:], axis=-1).astype(jnp.int32)
        tt = torch.argmax(tl[:, -1:], dim=-1)
        toks[0].append(np.asarray(jt)[:, 0].tolist())
        toks[1].append(tt[:, 0].tolist())
    return out, toks


def _check(out, dtype):
    for (jl, tl), (jc, tc) in out:
        assert tl.shape == jl.shape and tl.shape[-1] == padded_vocab(512)
        _close(tl, jl, dtype)
        assert set(tc) == set(jc) == {"kv", "enc_out"}
        for f, want in jc["kv"].items():
            assert tc["kv"][f].shape == want.shape, f
            _close(tc["kv"][f], want, dtype)
        assert tc["enc_out"].shape == jc["enc_out"].shape
        _close(tc["enc_out"], jc["enc_out"], dtype)


def test_prefill_and_decode_match_reference_fp32():
    cfg = _cfgs()[1]
    tokens = np.random.default_rng(2).integers(0, 512, size=(2, PROMPT))
    out, (ref_toks, port_toks) = _run_both("float32", tokens, _frames(cfg, 2, FRAMES, 3), steps=4)
    _check(out, "float32")
    assert port_toks == ref_toks


def test_prefill_and_decode_match_reference_bf16():
    cfg = _cfgs()[1]
    tokens = np.random.default_rng(4).integers(0, 512, size=(2, PROMPT))
    out, _ = _run_both("bfloat16", tokens, _frames(cfg, 2, FRAMES, 5), steps=4)
    _check(out, "bfloat16")


def test_decoder_positions_past_the_table_are_clamped():
    """A table of 24 positions, a prompt of 20 and decode positions 22 ...
    27: both sides read the last row for every position past 23."""
    cfg = _cfgs()[1]
    tokens = np.random.default_rng(6).integers(0, 512, size=(2, PROMPT))
    out, (ref_toks, port_toks) = _run_both("float32", tokens, _frames(cfg, 2, FRAMES, 7), steps=6,
                                           max_dec_len=24, pos0=22)
    _check(out, "float32")
    assert port_toks == ref_toks


def test_take_rows_follows_jax_indexing():
    table = torch.arange(4.0)[:, None]
    idx = torch.tensor([5, -7, -1, 2])
    want = np.asarray(jnp.arange(4.0)[:, None][jnp.asarray([5, -7, -1, 2])])
    np.testing.assert_array_equal(encdec._take_rows(table, idx).numpy(), want)
    assert encdec._take_rows(table, idx)[:, 0].tolist() == [3.0, 0.0, 3.0, 2.0]


def test_decode_matches_full_forward():
    """Teacher-forced decode reproduces the decoder's full forward."""
    cfg = _cfgs()[1]
    model = Model(cfg)
    params = model.init(3, device="cpu")
    tokens = torch.from_numpy(np.random.default_rng(8).integers(0, 512, size=(2, 16)))
    frames = torch.from_numpy(_frames(cfg, 2, FRAMES, 9))
    with torch.inference_mode():
        enc_out = encdec.encode(params, frames, cfg, ParallelCtx())
        full, caches = encdec.decode(params, tokens, enc_out, cfg, ParallelCtx())
    assert caches is None
    logits, caches = model.prefill(params, {"tokens": tokens[:, :12], "frames": frames},
                                   ParallelCtx(), max_len=16)
    outs = [logits[:, -1]]
    for t in range(12, 16):
        pos = torch.full((2,), t, dtype=torch.int32)
        lg, caches = model.decode_step(params, caches, {"token": tokens[:, t:t + 1], "pos": pos},
                                       ParallelCtx())
        outs.append(lg[:, 0])
    np.testing.assert_allclose(torch.stack(outs, 1).numpy(), full[:, 11:].numpy(), **FP32_TOL)


def _requests(cls, lengths, seed):
    rng = np.random.default_rng(seed)
    return [cls(rid=i, prompt=rng.integers(0, 512, size=n), max_new=3 + i % 3)
            for i, n in enumerate(lengths)]


def test_serve_matches_reference_serve():
    lengths = [5, 16, 9, 12, 23, 20, 7, 4]
    ref_reqs, ref_stats = ref_serve.serve(
        arch=ARCH, requests=_requests(ref_serve.Request, lengths, 2), batch_slots=4, seed=0)
    _, cfg, _, tp = _params(max_dec_len=256)
    reqs, stats = port_serve.serve(
        arch=ARCH, requests=_requests(port_serve.Request, lengths, 2), batch_slots=4, seed=0,
        device="cpu", params=tp)
    assert [r.out for r in reqs] == [r.out for r in ref_reqs]
    assert all(r.done for r in reqs)
    for key in ("prefills", "decode_steps", "tokens"):
        assert stats[key] == ref_stats[key], key


def test_serve_sizes_the_position_table_by_max_len():
    captured = {}
    init = Model.init

    def spy(self, seed, **kw):
        captured.update(kw)
        return init(self, seed, **kw)

    Model.init = spy
    try:
        _, stats = port_serve.serve(arch=ARCH, requests=_requests(port_serve.Request, [6], 1),
                                    max_len=40, seed=1, device="cpu")
    finally:
        Model.init = init
    assert captured["max_dec_len"] == 40 and stats["tokens"] == 3


def test_init_is_seeded_and_matches_the_reference_layout():
    ref_cfg, cfg = _cfgs()
    a, b = (Model(cfg).init(7, device="cpu", max_dec_len=64) for _ in range(2))
    for (name, pa), (_, pb) in zip(a.named_parameters(), b.named_parameters()):
        assert torch.equal(pa, pb), name
    assert a.dec_pos.shape == (64, cfg.d_model) and len(a.dec_layers) == cfg.dec_layers
    ref_init = RefModel(ref_cfg).init(jax.random.PRNGKey(0), max_dec_len=64)
    n_ref = sum(int(np.prod(leaf.shape)) for leaf in jax.tree.leaves(ref_init))
    assert sum(p.numel() for p in a.parameters()) == n_ref
    ported = params_from_reference(jax.tree.map(np.asarray, ref_init), cfg, device="cpu")
    assert [n for n, _ in ported.named_parameters()] == [n for n, _ in a.named_parameters()]


def test_caches_round_trip_through_the_reference_layout():
    ref_cfg, cfg = _cfgs()
    caches = RefModel(ref_cfg).make_caches(2, 16)
    rng = np.random.default_rng(10)
    tree = {"kv": {f: rng.standard_normal(np.shape(getattr(caches["kv"], f))).astype(np.float32)
                   for f in ("k", "v")},
            "enc_out": rng.standard_normal((2, FRAMES, cfg.d_model)).astype(np.float32)}
    port = caches_from_reference(tree, cfg, device="cpu")
    assert len(port["kv"]) == cfg.dec_layers
    back = caches_to_reference(port, cfg)
    for f, a in tree["kv"].items():
        np.testing.assert_array_equal(back["kv"][f], a)
    np.testing.assert_array_equal(back["enc_out"], tree["enc_out"])


def test_build_model_serves_the_family():
    cfg = get_config(ARCH)
    assert build_model(cfg).cfg is cfg
    assert cfg.family == "encdec" and cfg.family in T.PORTED_FAMILIES
