"""Parity of the port's Mixture-of-Experts layer and of the ``moe`` family's
serving path with the JAX reference, at smoke size on the CPU.

Layer: the same inputs, made with numpy from a seed, and the same weights
go through ``repro.models.layers.moe`` and the port's; ``moe_apply``'s output
and ``aux_loss`` are compared in fp32 at 1e-4 (relative and absolute) and in
bf16 at the bf16 ladder (rtol 2e-2, atol 2e-1). The port sums each token's
k contributions where the reference scatter-adds them in expert order: only
the order of k additions differs, far inside both tolerances. The capacity
is compared over a sweep of token counts, the dropped slots where a low
capacity factor drops them, and the router's choices where a zero router
ties every expert.

Model: moonshot-v1-16b-a3b and kimi-k2-1t-a32b at smoke size, the
reference's ``Model(cfg).init(PRNGKey(0))`` weights carried across with
``params_from_reference``; prefill logits, KV caches and four decode steps
in fp32 at 1e-4 (each side feeds its own greedy token, which must agree)
and in bf16 at the ladder (both fed the reference's), the summed auxiliary
loss, and the port's ``serve`` against ``repro.launch.serve.serve``.
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
from repro.models import transformer as ref_transformer  # noqa: E402
from repro.models.layers import moe as ref_moe  # noqa: E402
from repro.models.registry import Model as RefModel  # noqa: E402
from repro.parallel.ctx import ParallelCtx as RefCtx  # noqa: E402
from repro_torch.configs.base import get_config  # noqa: E402
from repro_torch.kernels.common import assert_allclose_by_dtype  # noqa: E402
from repro_torch.launch import serve as port_serve  # noqa: E402
from repro_torch.models import transformer as T  # noqa: E402
from repro_torch.models.convert import (  # noqa: E402
    _Reader,
    caches_from_reference,
    caches_to_reference,
    params_from_reference,
)
from repro_torch.models.layers import moe  # noqa: E402
from repro_torch.models.layers.embedding import padded_vocab  # noqa: E402
from repro_torch.models.registry import Model, build_model  # noqa: E402
from repro_torch.parallel.ctx import ParallelCtx  # noqa: E402

FP32_TOL = dict(rtol=1e-4, atol=1e-4)
ARCHS = ["moonshot-v1-16b-a3b", "kimi-k2-1t-a32b"]
PROMPT = 40


def _cfgs(arch, dtype="float32", **changes):
    return (dataclasses.replace(ref_get_config(arch).smoke(), dtype=dtype, **changes),
            dataclasses.replace(get_config(arch).smoke(), dtype=dtype, **changes))


def _host(x):
    return np.asarray(x.astype(jnp.float32) if x.dtype == jnp.bfloat16 else x)


def _np(t):
    return (t.float() if t.dtype == torch.bfloat16 else t).detach().numpy()


def _tree(jp):
    return jax.tree.map(np.asarray, jp)


def _layer(arch, dtype, seed, **changes):
    """The reference's MoE weights (seeded) and the port's copy of them."""
    ref_cfg, cfg = _cfgs(arch, dtype, **changes)
    jp = ref_moe.init_moe(jax.random.PRNGKey(seed), ref_cfg, jnp.dtype(dtype))
    return ref_cfg, cfg, jp, _Reader(torch.device("cpu")).moe(_tree(jp))


def _x(cfg, shape, seed, dtype):
    a = np.random.default_rng(seed).standard_normal(shape + (cfg.d_model,)).astype(np.float32)
    return jnp.asarray(a, jnp.dtype(dtype)), torch.from_numpy(a).to(getattr(torch, dtype))


# ------------------------------------------------------------------ layer --
@pytest.mark.parametrize("arch", ["moonshot-v1-16b-a3b", "kimi-k2-1t-a32b"])
@pytest.mark.parametrize("smoke", [False, True], ids=["full", "smoke"])
def test_capacity_matches_reference(arch, smoke):
    ref_cfg, cfg = ref_get_config(arch), get_config(arch)
    if smoke:
        ref_cfg, cfg = ref_cfg.smoke(), cfg.smoke()
    for tokens in list(range(1, 70)) + [197, 394, 512, 788, 1024, 1025, 2048, 4096, 8191]:
        assert moe._capacity(tokens, cfg) == ref_moe._capacity(tokens, ref_cfg), tokens


def test_capacity_at_the_served_shapes():
    """The capacities the card runs: 8 slots at a 4-token decode step."""
    moonshot, kimi = get_config("moonshot-v1-16b-a3b"), get_config("kimi-k2-1t-a32b")
    assert [moe._capacity(t, moonshot) for t in (4, 4 * 1024, 4 * 197, 2 * 512)] == [8, 480, 96, 120]
    assert moe._capacity(4 * 1024, kimi) == 112


@pytest.mark.parametrize("ties", [False, True], ids=["random", "ties"])
def test_route_matches_top_k(ties):
    """The router's gates and ids are ``jax.lax.top_k``'s, ties to the
    lower expert id."""
    rng = np.random.default_rng(3)
    x = rng.standard_normal((5, 7, 16)).astype(np.float32)
    router = rng.standard_normal((16, 12)).astype(np.float32)
    if ties:
        router[:, 4:9] = router[:, 4:5]  # five experts with equal logits
        router[:, 0] = router[:, 4]
    probs = jax.nn.softmax(jnp.asarray(x) @ jnp.asarray(router), axis=-1)
    want_g, want_i = jax.lax.top_k(probs, 6)
    want_g = want_g / jnp.maximum(want_g.sum(-1, keepdims=True), 1e-9)
    p, g, i = moe.route(torch.from_numpy(router), torch.from_numpy(x), 6)
    np.testing.assert_array_equal(i.numpy(), np.asarray(want_i))
    np.testing.assert_allclose(g.numpy(), np.asarray(want_g), rtol=1e-6, atol=1e-7)
    np.testing.assert_allclose(p.numpy(), np.asarray(probs), rtol=1e-6, atol=1e-7)


@pytest.mark.parametrize("shared", [0, 1, 2])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_moe_apply_matches_reference(shared, dtype):
    ref_cfg, cfg, jp, tp = _layer("moonshot-v1-16b-a3b", dtype, seed=shared,
                                  num_shared_experts=shared)
    assert (tp.shared is None) == (shared == 0)
    jx, tx = _x(cfg, (3, 11), seed=10 + shared, dtype=dtype)
    jy, jaux = ref_moe.moe_apply(jp, jx, ref_cfg, RefCtx())
    ty, taux = moe.moe_apply(tp, tx, cfg, ParallelCtx())
    assert ty.dtype == tx.dtype and ty.shape == tx.shape
    if dtype == "float32":
        np.testing.assert_allclose(_np(ty), _host(jy), **FP32_TOL)
    else:
        assert_allclose_by_dtype(_np(ty), _host(jy), jnp.bfloat16)
    assert taux.dtype == torch.float32
    np.testing.assert_allclose(float(taux), float(jaux), rtol=1e-6)


def _kept(ids, e, capacity):
    """The (token, k) pairs that keep a slot: per expert, the first
    ``capacity`` in flat order."""
    flat = ids.reshape(-1)
    seen = np.zeros(e, np.int64)
    keep = np.zeros(flat.shape, bool)
    for j, i in enumerate(flat):
        keep[j] = seen[i] < capacity
        seen[i] += 1
    return keep.reshape(ids.shape)


def test_moe_drops_the_reference_slots():
    """With capacity factor 0.25, 48 tokens a call leave each of the 8
    experts 8 slots for ~12 (token, k) pairs: the same pairs are dropped."""
    ref_cfg, cfg, jp, tp = _layer("moonshot-v1-16b-a3b", "float32", seed=4,
                                  capacity_factor=0.25, num_shared_experts=0)
    jx, tx = _x(cfg, (4, 12), seed=5, dtype="float32")
    _, _, ids = moe.route(tp.router, tx, cfg.experts_per_token)
    capacity = moe._capacity(48, cfg)
    keep = _kept(ids.numpy(), cfg.num_experts, capacity)
    assert capacity == 8 and 0 < (~keep).sum() < keep.size
    jy, _ = ref_moe.moe_apply(jp, jx, ref_cfg, RefCtx())
    ty, _ = moe.moe_apply(tp, tx, cfg, ParallelCtx())
    np.testing.assert_allclose(_np(ty), _host(jy), **FP32_TOL)
    # A token whose every pair was dropped passes nothing through.
    gone = ~keep.any(-1)
    assert gone.any()
    np.testing.assert_array_equal(_np(ty)[gone], 0.0)
    np.testing.assert_array_equal(_host(jy)[gone], 0.0)
    # One pair more or less kept changes that token's output.
    kept_both = keep.all(-1)
    assert not np.allclose(_np(ty)[kept_both], 0.0)


def test_zero_router_ties_pick_the_lowest_experts():
    """A zero router gives every expert the same probability: both sides
    route every token to experts 0 ... k-1, which then overflow their
    capacity in the same (flat) order."""
    ref_cfg, cfg, jp, tp = _layer("kimi-k2-1t-a32b", "float32", seed=6)
    jp = dict(jp, router=jnp.zeros_like(jp["router"]))
    tp.router.zero_()
    jx, tx = _x(cfg, (2, 20), seed=7, dtype="float32")
    _, gates, ids = moe.route(tp.router, tx, cfg.experts_per_token)
    assert (ids == torch.arange(cfg.experts_per_token)).all()
    assert torch.allclose(gates, torch.full_like(gates, 1.0 / cfg.experts_per_token))
    jy, jaux = ref_moe.moe_apply(jp, jx, ref_cfg, RefCtx())
    ty, taux = moe.moe_apply(tp, tx, cfg, ParallelCtx())
    np.testing.assert_allclose(_np(ty), _host(jy), **FP32_TOL)
    np.testing.assert_allclose(float(taux), float(jaux), rtol=1e-6)
    # 40 tokens x 2 pairs on experts 0 and 1; the capacity keeps 16 each.
    assert moe._capacity(40, cfg) == 16


def test_init_draws_each_expert_from_the_generator():
    _, cfg = _cfgs("kimi-k2-1t-a32b", "bfloat16")
    a, b = (moe.init_moe(torch.Generator().manual_seed(2), cfg, torch.bfloat16)
            for _ in range(2))
    e, d, f = cfg.num_experts, cfg.d_model, cfg.moe_d_ff
    assert a.w1.shape == a.w3.shape == (e, d, f) and a.w2.shape == (e, f, d)
    assert a.w1.dtype == torch.bfloat16 and a.router.dtype == torch.float32
    assert a.shared.w1.shape == (d, f * cfg.num_shared_experts)
    for (name, pa), (_, pb) in zip(a.named_parameters(), b.named_parameters()):
        assert torch.equal(pa, pb), name
    assert not torch.equal(a.w1[0], a.w1[1])
    # Unit-variance rows over sqrt(fan-in), as the reference draws them.
    assert abs(float(a.w1.float().std()) * d ** 0.5 - 1.0) < 0.05


# ------------------------------------------------------------------ model --
def _ref_caches(jc):
    return {key: {f: _host(getattr(c, f)) for f in c._fields} for key, c in jc.items()}


def _run_both(arch, dtype, tokens, steps, **changes):
    """Prefill ``tokens`` and decode ``steps`` tokens on both sides. In fp32
    each side feeds its own argmax; in bf16 both are fed the reference's.
    Returns per-step ((ref logits, port logits), (ref caches, port caches))
    and both token lists."""
    ref_cfg, cfg = _cfgs(arch, dtype, **changes)
    ref_model, model = RefModel(ref_cfg), Model(cfg)
    jp = ref_model.init(jax.random.PRNGKey(0))
    tp = params_from_reference(_tree(jp), cfg, device="cpu")
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


def _check(out, dtype):
    for (jl, tl), (jc, tc) in out:
        assert tl.shape == jl.shape and tl.shape[-1] == padded_vocab(512)
        if dtype == "float32":
            np.testing.assert_allclose(tl, jl, **FP32_TOL)
        else:
            assert_allclose_by_dtype(tl, jl, jnp.bfloat16)
        assert set(tc) == set(jc) == {"kv"}
        for f, want in jc["kv"].items():
            assert tc["kv"][f].shape == want.shape, f
            if dtype == "float32":
                np.testing.assert_allclose(tc["kv"][f], want, **FP32_TOL)
            else:
                assert_allclose_by_dtype(tc["kv"][f], want, jnp.bfloat16)


@pytest.mark.parametrize("arch", ARCHS)
def test_prefill_and_decode_match_reference_fp32(arch):
    tokens = np.random.default_rng(1).integers(0, 512, size=(2, PROMPT))
    out, (ref_toks, port_toks) = _run_both(arch, "float32", tokens, steps=4)
    _check(out, "float32")
    assert port_toks == ref_toks


@pytest.mark.parametrize("arch", ARCHS)
def test_prefill_and_decode_match_reference_bf16(arch):
    """Every token routed to every expert (k = E): the routes hold no near
    tie, so the bf16 ladder applies to the whole model. At the config's k,
    a 1-ulp bf16 difference in a router's input (the two sides round their
    products in other orders) flips near ties between the k-th and the
    next expert, 2 of 80 tokens at the second layer here, and that token's
    output then differs by O(1): the layer is held at the config's k on the
    same input (``test_moe_apply_matches_reference``)."""
    tokens = np.random.default_rng(2).integers(0, 512, size=(2, PROMPT))
    out, _ = _run_both(arch, "bfloat16", tokens, steps=4, experts_per_token=8)
    _check(out, "bfloat16")


@pytest.mark.parametrize("arch", ARCHS)
def test_aux_loss_is_summed_over_the_layers(arch):
    ref_cfg, cfg = _cfgs(arch)
    jp = RefModel(ref_cfg).init(jax.random.PRNGKey(1))
    tp = params_from_reference(_tree(jp), cfg, device="cpu")
    tokens = np.random.default_rng(3).integers(0, 512, size=(2, 24))
    _, _, jaux = ref_transformer.lm_forward(jp, jnp.asarray(tokens, jnp.int32), ref_cfg, RefCtx())
    with torch.inference_mode():
        _, _, taux = T.lm_forward(tp, torch.from_numpy(tokens), cfg, ParallelCtx())
    # Each layer's loss is near 1 (E · Σ mean_prob · frac ≈ 1 when balanced).
    assert cfg.num_layers * 0.5 < float(taux) < cfg.num_layers * 2.0
    np.testing.assert_allclose(float(taux), float(jaux), rtol=1e-5)


def _requests(cls, lengths, seed):
    rng = np.random.default_rng(seed)
    return [cls(rid=i, prompt=rng.integers(0, 512, size=n), max_new=3 + i % 3)
            for i, n in enumerate(lengths)]


@pytest.mark.parametrize("arch", ARCHS)
def test_serve_matches_reference_serve(arch):
    lengths = [5, 16, 9, 12, 30, 20, 7, 23]
    ref_reqs, ref_stats = ref_serve.serve(
        arch=arch, requests=_requests(ref_serve.Request, lengths, 2), batch_slots=4, seed=0)
    ref_cfg, cfg = _cfgs(arch)
    tp = params_from_reference(_tree(RefModel(ref_cfg).init(jax.random.PRNGKey(0))), cfg,
                               device="cpu")
    reqs, stats = port_serve.serve(
        arch=arch, requests=_requests(port_serve.Request, lengths, 2), batch_slots=4, seed=0,
        device="cpu", params=tp)
    assert [r.out for r in reqs] == [r.out for r in ref_reqs]
    assert all(r.done for r in reqs)
    for key in ("prefills", "decode_steps", "tokens"):
        assert stats[key] == ref_stats[key], key


@pytest.mark.parametrize("arch", ARCHS)
def test_init_is_seeded_and_matches_the_reference_layout(arch):
    ref_cfg, cfg = _cfgs(arch)
    a, b = (Model(cfg).init(7, device="cpu") for _ in range(2))
    for (name, pa), (_, pb) in zip(a.named_parameters(), b.named_parameters()):
        assert torch.equal(pa, pb), name
    ref_init = RefModel(ref_cfg).init(jax.random.PRNGKey(0))
    n_ref = sum(int(np.prod(leaf.shape)) for leaf in jax.tree.leaves(ref_init))
    assert sum(p.numel() for p in a.parameters()) == n_ref
    ported = params_from_reference(_tree(ref_init), cfg, device="cpu")
    assert [n for n, _ in ported.named_parameters()] == [n for n, _ in a.named_parameters()]
    assert a.layers[0].mlp is None and a.layers[0].moe is not None


def test_caches_round_trip_through_the_reference_layout():
    ref_cfg, cfg = _cfgs("moonshot-v1-16b-a3b")
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
def test_build_model_serves_the_family(arch):
    cfg = get_config(arch)
    assert build_model(cfg).cfg is cfg
    assert cfg.family == "moe" and cfg.family in T.PORTED_FAMILIES
