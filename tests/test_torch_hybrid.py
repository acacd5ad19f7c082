"""Parity of the port's LM serving path for the ``hybrid`` family
(zamba2-7b: a Mamba-2 trunk and one weight-shared attention block) with the
JAX reference, at smoke size on the CPU.

The smoke config has 6 SSM layers and the shared block every 3 (two
super-blocks, no tail); ``num_layers = 7`` adds a tail layer, so the
reference's ``tail_layers`` and ``tail_ssm`` run. Prompts are multiples of
the smoke chunk of 16. Weights are carried across with
``params_from_reference``; prefill logits, KV caches, SSM states and four
decode steps are compared in fp32 at 1e-4 (each side feeding its own
greedy token, the tokens identical) and in bf16 at the bf16 ladder (rtol
2e-2, atol 2e-1; both sides fed the reference's token).
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
from repro_torch.kernels import LAUNCH_COUNTERS  # noqa: E402
from repro_torch.kernels.common import assert_allclose_by_dtype  # noqa: E402
from repro_torch.launch import serve as port_serve  # noqa: E402
from repro_torch.models import hybrid as H  # noqa: E402
from repro_torch.models.convert import (  # noqa: E402
    caches_from_reference,
    caches_to_reference,
    params_from_reference,
)
from repro_torch.models.registry import Model, build_model  # noqa: E402
from repro_torch.parallel.ctx import ParallelCtx  # noqa: E402

ARCH = "zamba2-7b"
FP32_TOL = dict(rtol=1e-4, atol=1e-4)
LAYERS = {"no-tail": 6, "tail": 7}


def _cfgs(layers, dtype="float32"):
    return (dataclasses.replace(ref_get_config(ARCH).smoke(), dtype=dtype, num_layers=layers),
            dataclasses.replace(get_config(ARCH).smoke(), dtype=dtype, num_layers=layers))


def _host(x):
    return np.asarray(x.astype(jnp.float32) if x.dtype == jnp.bfloat16 else x)


def _np(t):
    return (t.float() if t.dtype == torch.bfloat16 else t).detach().numpy()


def _ref_caches(jc):
    return {key: {f: _host(getattr(c, f)) for f in c._fields} for key, c in jc.items()}


def _run_both(layers, dtype, tokens, steps):
    """As tests/test_torch_dense.py's: prefill, then ``steps`` decode steps
    on both sides; host arrays in the reference's cache layout."""
    ref_cfg, cfg = _cfgs(layers, dtype)
    ref_model, model = RefModel(ref_cfg), Model(cfg)
    jp = ref_model.init(jax.random.PRNGKey(0))
    tp = params_from_reference(jax.tree.map(np.asarray, jp), cfg, device="cpu")
    b, s = tokens.shape
    max_len = s + steps
    ref_prefill = jax.jit(lambda p, batch: ref_model.prefill(p, batch, RefCtx(), max_len=max_len))
    ref_decode = jax.jit(lambda p, c, batch: ref_model.decode_step(p, c, batch, RefCtx()))
    jl, jc = ref_prefill(jp, {"tokens": jnp.asarray(tokens, jnp.int32)})
    tl, tc = model.prefill(tp, {"tokens": torch.from_numpy(tokens)}, ParallelCtx(),
                           max_len=max_len)
    out = [((_host(jl), _np(tl)), (_ref_caches(jc), caches_to_reference(tc, cfg)))]
    jt = jnp.argmax(jl[:, -1:], axis=-1).astype(jnp.int32)
    tt = torch.argmax(tl[:, -1:], dim=-1)
    toks = ([np.asarray(jt)[:, 0].tolist()], [tt[:, 0].tolist()])
    for i in range(steps):
        if dtype != "float32":
            tt = torch.from_numpy(np.asarray(jt, np.int64))
        pos = s + i
        jl, jc = ref_decode(jp, jc, {"token": jt, "pos": jnp.full((b,), pos, jnp.int32)})
        tl, tc = model.decode_step(
            tp, tc, {"token": tt, "pos": torch.full((b,), pos, dtype=torch.int32)}, ParallelCtx())
        out.append(((_host(jl), _np(tl)), (_ref_caches(jc), caches_to_reference(tc, cfg))))
        jt = jnp.argmax(jl[:, -1:], axis=-1).astype(jnp.int32)
        tt = torch.argmax(tl[:, -1:], dim=-1)
        toks[0].append(np.asarray(jt)[:, 0].tolist())
        toks[1].append(tt[:, 0].tolist())
    return out, toks


def _check(out, dtype, keys):
    for (jl, tl), (jc, tc) in out:
        assert tl.shape == jl.shape
        if dtype == "float32":
            np.testing.assert_allclose(tl, jl, **FP32_TOL)
        else:
            assert_allclose_by_dtype(tl, jl, jnp.bfloat16)
        assert set(tc) == set(jc) == keys
        for key in jc:
            for f, want in jc[key].items():
                assert tc[key][f].shape == want.shape, (key, f)
                if dtype == "float32":
                    np.testing.assert_allclose(tc[key][f], want, **FP32_TOL)
                else:
                    assert_allclose_by_dtype(tc[key][f], want, jnp.bfloat16)


def _keys(layers):
    return {"kv", "ssm", "tail_ssm"} if LAYERS[layers] % 3 else {"kv", "ssm"}


@pytest.mark.parametrize("seq", [16, 32], ids=["one-chunk", "two-chunks"])
@pytest.mark.parametrize("layers", list(LAYERS))
def test_prefill_and_decode_match_reference_fp32(layers, seq):
    tokens = np.random.default_rng(seq).integers(0, 512, size=(2, seq))
    out, (ref_toks, port_toks) = _run_both(LAYERS[layers], "float32", tokens, steps=4)
    _check(out, "float32", _keys(layers))
    assert port_toks == ref_toks


@pytest.mark.parametrize("layers", list(LAYERS))
def test_prefill_and_decode_match_reference_bf16(layers):
    tokens = np.random.default_rng(1).integers(0, 512, size=(2, 32))
    out, _ = _run_both(LAYERS[layers], "bfloat16", tokens, steps=4)
    _check(out, "bfloat16", _keys(layers))


@pytest.mark.parametrize("layers", list(LAYERS))
def test_decode_matches_full_forward(layers):
    """Teacher-forced decode reproduces the full forward's logits (the
    reference's tests/test_archs_smoke.py check, here at fp32's 1e-4)."""
    _, cfg = _cfgs(LAYERS[layers])
    model = Model(cfg)
    params = model.init(3, device="cpu")
    tokens = torch.from_numpy(np.random.default_rng(4).integers(0, 512, size=(2, 32)))
    with torch.inference_mode():
        full, _, _ = H.hybrid_forward(params, tokens, cfg, ParallelCtx())
    logits, caches = model.prefill(params, {"tokens": tokens[:, :16]}, ParallelCtx(), max_len=32)
    outs = [logits[:, -1]]
    for t in range(16, 31):
        pos = torch.full((2,), t, dtype=torch.int32)
        lg, caches = model.decode_step(params, caches, {"token": tokens[:, t:t + 1], "pos": pos},
                                       ParallelCtx())
        outs.append(lg[:, 0])
    np.testing.assert_allclose(torch.stack(outs, 1).numpy(), full[:, 15:31].numpy(), **FP32_TOL)


def _requests(cls, lengths, seed):
    rng = np.random.default_rng(seed)
    return [cls(rid=i, prompt=rng.integers(0, 512, size=n), max_new=3 + i % 3)
            for i, n in enumerate(lengths)]


def test_serve_matches_reference_serve():
    # The second batch pads to 32 = two chunks of the smoke config's 16.
    lengths = [5, 16, 9, 12, 32, 20, 7, 31]
    ref_reqs, ref_stats = ref_serve.serve(
        arch=ARCH, requests=_requests(ref_serve.Request, lengths, 2), batch_slots=4, seed=0)
    ref_cfg = ref_get_config(ARCH).smoke()
    cfg = get_config(ARCH).smoke()
    tp = params_from_reference(jax.tree.map(np.asarray, RefModel(ref_cfg).init(
        jax.random.PRNGKey(0))), cfg, device="cpu")
    before = LAUNCH_COUNTERS["ssd_stage1"].count
    reqs, stats = port_serve.serve(
        arch=ARCH, requests=_requests(port_serve.Request, lengths, 2), batch_slots=4, seed=0,
        device="cpu", params=tp)
    assert [r.out for r in reqs] == [r.out for r in ref_reqs]
    for key in ("prefills", "decode_steps", "tokens"):
        assert stats[key] == ref_stats[key], key
    assert LAUNCH_COUNTERS["ssd_stage1"].count == before  # the CPU runs the plain Stage 1


def test_serve_raises_where_the_reference_raises():
    bad = [23]  # pads to 23 > chunk 16 and not a multiple of it
    with pytest.raises(ValueError, match="seq 23 % chunk 16"):
        port_serve.serve(arch=ARCH, requests=_requests(port_serve.Request, bad, 0), seed=0,
                         device="cpu")


@pytest.mark.parametrize("layers", list(LAYERS))
def test_caches_round_trip_through_the_reference_layout(layers):
    ref_cfg, cfg = _cfgs(LAYERS[layers])
    caches = RefModel(ref_cfg).make_caches(2, 16)
    rng = np.random.default_rng(6)
    tree = {key: {f: rng.standard_normal(np.shape(getattr(c, f))).astype(np.float32)
                  for f in c._fields} for key, c in caches.items()}
    assert set(tree) == _keys(layers)
    port = caches_from_reference(tree, cfg, device="cpu")
    n_super, e, tail = H._split(cfg)
    assert (len(port["kv"]), len(port["ssm"]), len(port.get("tail_ssm", []))) == (n_super,
                                                                                 n_super * e, tail)
    back = caches_to_reference(port, cfg)
    for key, fields in tree.items():
        for f, a in fields.items():
            np.testing.assert_array_equal(back[key][f], a)


@pytest.mark.parametrize("layers", list(LAYERS))
def test_init_is_seeded_and_matches_the_reference_layout(layers):
    ref_cfg, cfg = _cfgs(LAYERS[layers])
    a, b = (Model(cfg).init(7, device="cpu") for _ in range(2))
    for (name, pa), (_, pb) in zip(a.named_parameters(), b.named_parameters()):
        assert torch.equal(pa, pb), name
    ref_leaves = jax.tree_util.tree_flatten_with_path(
        jax.eval_shape(lambda: RefModel(ref_cfg).init(jax.random.PRNGKey(0))))[0]
    n_ref = sum(int(np.prod(leaf.shape)) for _, leaf in ref_leaves)
    assert sum(p.numel() for p in a.parameters()) == n_ref


def test_shared_block_is_one_module_at_full_size():
    cfg = get_config(ARCH)
    assert H._split(cfg) == (13, 6, 3)
    _, cfg = _cfgs(7)
    params = Model(cfg).init(0, device="cpu")
    assert isinstance(params.shared, H.SharedBlock)
    assert len(params.ssm_layers) == 6 and len(params.tail_layers) == 1
    assert build_model(cfg).cfg is cfg
