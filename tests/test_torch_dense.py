"""Parity of the port's LM serving path for the ``dense`` and ``vlm``
families with the JAX reference, at smoke size on the CPU.

The reference's ``Model(cfg).init(PRNGKey(0))`` weights are carried across
with ``params_from_reference``. Prefill logits and KV caches and four
decode steps are compared in fp32 at 1e-4 (relative and absolute), where
each side feeds its own greedy token and the tokens must be identical, and
in bf16 at the bf16 ladder (rtol 2e-2, atol 2e-1), where both sides are fed
the reference's token. gemma2-27b's smoke window is 64 keys, so prompts of
72 tokens make it bind; internvl2-2b's 16 patch embeddings are drawn from
the seed. The port's ``serve`` is held to ``repro.launch.serve.serve``.
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
from repro.models.registry import Model as RefModel  # noqa: E402
from repro.parallel.ctx import ParallelCtx as RefCtx  # noqa: E402
from repro_torch.configs.base import get_config  # noqa: E402
from repro_torch.kernels.common import assert_allclose_by_dtype  # noqa: E402
from repro_torch.launch import serve as port_serve  # noqa: E402
from repro_torch.models import transformer as T  # noqa: E402
from repro_torch.models.convert import (  # noqa: E402
    caches_from_reference,
    caches_to_reference,
    params_from_reference,
)
from repro_torch.models.layers.embedding import padded_vocab  # noqa: E402
from repro_torch.models.registry import Model, build_model  # noqa: E402
from repro_torch.parallel.ctx import ParallelCtx  # noqa: E402

FP32_TOL = dict(rtol=1e-4, atol=1e-4)
ARCHS = ["qwen3-4b", "gemma2-27b", "codeqwen1.5-7b", "nemotron-4-340b", "internvl2-2b"]
PROMPT = 72


def _cfgs(arch, dtype="float32"):
    return (dataclasses.replace(ref_get_config(arch).smoke(), dtype=dtype),
            dataclasses.replace(get_config(arch).smoke(), dtype=dtype))


def _host(x):
    return np.asarray(x.astype(jnp.float32) if x.dtype == jnp.bfloat16 else x)


def _np(t):
    return (t.float() if t.dtype == torch.bfloat16 else t).detach().numpy()


def _ref_caches(jc):
    return {key: {f: _host(getattr(c, f)) for f in c._fields} for key, c in jc.items()}


def _patches(cfg, b, seed):
    if cfg.family != "vlm":
        return {}, {}
    a = np.random.default_rng(seed).standard_normal((b, cfg.frontend_tokens, cfg.d_model))
    a = a.astype(np.float32)
    return ({"patches": jnp.asarray(a, jnp.dtype(cfg.dtype))},
            {"patches": torch.from_numpy(a).to(getattr(torch, cfg.dtype))})


def _run_both(arch, dtype, tokens, steps):
    """Prefill ``tokens`` and decode ``steps`` tokens on both sides. In fp32
    each side feeds its own argmax; in bf16 both are fed the reference's.
    Returns per-step ((ref logits, port logits), (ref caches, port caches))
    as host arrays in the reference's cache layout, and both token lists."""
    ref_cfg, cfg = _cfgs(arch, dtype)
    ref_model, model = RefModel(ref_cfg), Model(cfg)
    jp = ref_model.init(jax.random.PRNGKey(0))
    tp = params_from_reference(jax.tree.map(np.asarray, jp), cfg, device="cpu")
    b, s = tokens.shape
    jpatch, tpatch = _patches(cfg, b, seed=s)
    offset = s + (cfg.frontend_tokens if cfg.family == "vlm" else 0)
    max_len = offset + steps
    ref_prefill = jax.jit(lambda p, batch: ref_model.prefill(p, batch, RefCtx(), max_len=max_len))
    ref_decode = jax.jit(lambda p, c, batch: ref_model.decode_step(p, c, batch, RefCtx()))
    jl, jc = ref_prefill(jp, {"tokens": jnp.asarray(tokens, jnp.int32), **jpatch})
    tl, tc = model.prefill(tp, {"tokens": torch.from_numpy(tokens), **tpatch}, ParallelCtx(),
                           max_len=max_len)
    out = [((_host(jl), _np(tl)), (_ref_caches(jc), caches_to_reference(tc, cfg)))]
    jt = jnp.argmax(jl[:, -1:], axis=-1).astype(jnp.int32)
    tt = torch.argmax(tl[:, -1:], dim=-1)
    toks = ([np.asarray(jt)[:, 0].tolist()], [tt[:, 0].tolist()])
    for i in range(steps):
        if dtype != "float32":
            tt = torch.from_numpy(np.asarray(jt, np.int64))
        pos = offset + i
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
        if dtype == "float32":
            np.testing.assert_allclose(tl, jl, **FP32_TOL)
        else:
            assert_allclose_by_dtype(tl, jl, jnp.bfloat16)
        assert set(tc) == set(jc)
        for key in jc:
            for f, want in jc[key].items():
                assert tc[key][f].shape == want.shape, (key, f)
                if dtype == "float32":
                    np.testing.assert_allclose(tc[key][f], want, **FP32_TOL)
                else:
                    assert_allclose_by_dtype(tc[key][f], want, jnp.bfloat16)


@pytest.mark.parametrize("arch", ARCHS)
def test_prefill_and_decode_match_reference_fp32(arch):
    tokens = np.random.default_rng(1).integers(0, 512, size=(2, PROMPT))
    out, (ref_toks, port_toks) = _run_both(arch, "float32", tokens, steps=4)
    _check(out, "float32")
    assert port_toks == ref_toks


@pytest.mark.parametrize("arch", ARCHS)
def test_prefill_and_decode_match_reference_bf16(arch):
    tokens = np.random.default_rng(2).integers(0, 512, size=(2, PROMPT))
    out, _ = _run_both(arch, "bfloat16", tokens, steps=4)
    _check(out, "bfloat16")


@pytest.mark.parametrize("arch", ARCHS)
def test_decode_matches_full_forward(arch):
    """Teacher-forced decode reproduces the full forward's logits (the
    reference's tests/test_archs_smoke.py check, here at fp32's 1e-4)."""
    cfg = get_config(arch).smoke()
    model = Model(cfg)
    params = model.init(3, device="cpu")
    tokens = torch.from_numpy(np.random.default_rng(4).integers(0, 512, size=(2, 70)))
    _, tpatch = _patches(cfg, 2, seed=5)
    p = cfg.frontend_tokens if cfg.family == "vlm" else 0
    with torch.inference_mode():
        full, _, _ = T.lm_forward(params, tokens, cfg, ParallelCtx(),
                                  patch_embeds=tpatch.get("patches"))
    logits, caches = model.prefill(params, {"tokens": tokens[:, :66], **tpatch}, ParallelCtx(),
                                   max_len=p + 70)
    outs = [logits[:, -1]]
    for t in range(66, 70):
        pos = torch.full((2,), p + t, dtype=torch.int32)
        lg, caches = model.decode_step(params, caches, {"token": tokens[:, t:t + 1], "pos": pos},
                                       ParallelCtx())
        outs.append(lg[:, 0])
    np.testing.assert_allclose(torch.stack(outs, 1).numpy(), full[:, p + 65:].numpy(), **FP32_TOL)


def _requests(cls, lengths, seed):
    rng = np.random.default_rng(seed)
    return [cls(rid=i, prompt=rng.integers(0, 512, size=n), max_new=3 + i % 3)
            for i, n in enumerate(lengths)]


@pytest.mark.parametrize("arch", ["qwen3-4b", "internvl2-2b"])
def test_serve_matches_reference_serve(arch):
    lengths = [5, 16, 9, 12, 30, 20, 7, 31]
    ref_reqs, ref_stats = ref_serve.serve(
        arch=arch, requests=_requests(ref_serve.Request, lengths, 2), batch_slots=4, seed=0)
    ref_cfg, cfg = _cfgs(arch)
    tp = params_from_reference(jax.tree.map(np.asarray, RefModel(ref_cfg).init(
        jax.random.PRNGKey(0))), cfg, device="cpu")
    reqs, stats = port_serve.serve(
        arch=arch, requests=_requests(port_serve.Request, lengths, 2), batch_slots=4, seed=0,
        device="cpu", params=tp)
    assert [r.out for r in reqs] == [r.out for r in ref_reqs]
    assert all(r.done for r in reqs)
    for key in ("prefills", "decode_steps", "tokens"):
        assert stats[key] == ref_stats[key], key


def test_serve_with_random_weights_is_deterministic_and_in_vocab():
    runs = [port_serve.serve(arch="gemma2-27b",
                             requests=_requests(port_serve.Request, [4, 70], 3),
                             batch_slots=2, seed=3, device="cpu") for _ in range(2)]
    assert [r.out for r in runs[0][0]] == [r.out for r in runs[1][0]]
    assert all(0 <= t < 512 for r in runs[0][0] for t in r.out)


@pytest.mark.parametrize("arch", ["gemma2-27b", "internvl2-2b"])
def test_caches_round_trip_through_the_reference_layout(arch):
    ref_cfg, cfg = _cfgs(arch)
    caches = RefModel(ref_cfg).make_caches(2, 16)
    rng = np.random.default_rng(6)
    tree = {"kv": {f: rng.standard_normal(np.shape(getattr(caches["kv"], f))).astype(np.float32)
                   for f in ("k", "v")}}
    port = caches_from_reference(tree, cfg, device="cpu")
    assert len(port["kv"]) == cfg.num_layers
    back = caches_to_reference(port, cfg)
    for f, a in tree["kv"].items():
        np.testing.assert_array_equal(back["kv"][f], a)


@pytest.mark.parametrize("arch", ARCHS)
def test_init_is_seeded_and_matches_the_reference_layout(arch):
    ref_cfg, cfg = _cfgs(arch)
    a, b = (Model(cfg).init(7, device="cpu") for _ in range(2))
    for (name, pa), (_, pb) in zip(a.named_parameters(), b.named_parameters()):
        assert torch.equal(pa, pb), name
    ref_leaves = jax.tree_util.tree_flatten_with_path(
        jax.eval_shape(lambda: RefModel(ref_cfg).init(jax.random.PRNGKey(0))))[0]
    n_ref = sum(int(np.prod(leaf.shape)) for _, leaf in ref_leaves)
    assert sum(p.numel() for p in a.parameters()) == n_ref
    ported = params_from_reference(
        jax.tree.map(np.asarray, RefModel(ref_cfg).init(jax.random.PRNGKey(0))), cfg, device="cpu")
    assert [n for n, _ in ported.named_parameters()] == [n for n, _ in a.named_parameters()]


@pytest.mark.parametrize("arch", ARCHS)
def test_build_model_serves_the_family(arch):
    cfg = get_config(arch)
    assert build_model(cfg).cfg is cfg
    assert cfg.family in T.PORTED_FAMILIES


def test_windows_alternate_local_then_global():
    _, cfg = _cfgs("gemma2-27b")
    assert T._windows(cfg) == (64, None) and T._group_size(cfg) == 2
    _, cfg = _cfgs("qwen3-4b")
    assert T._windows(cfg) == (None,) and T._group_size(cfg) == 1
