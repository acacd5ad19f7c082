"""Parity of the port's LM serving path (``ssm`` family) with the JAX
reference, at smoke size on the CPU.

The reference's ``Model(cfg).init(PRNGKey(0))`` weights are carried across
with ``params_from_reference``; prefill logits and caches and four decode
steps are compared in fp32 at 1e-4 (relative and absolute: the chunked scan's
tolerance in ``tests/test_kernel_ssd.py``) and in bf16 at the bf16 ladder
(rtol 2e-2, atol 2e-1); greedy tokens must be identical in fp32. The port's
``serve`` is held to ``repro.launch.serve.serve`` on the same prompts.
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
from repro.configs.base import list_archs as ref_list_archs  # noqa: E402
from repro.launch import serve as ref_serve  # noqa: E402
from repro.models.registry import Model as RefModel  # noqa: E402
from repro.parallel.ctx import ParallelCtx as RefCtx  # noqa: E402
from repro_torch.configs.base import get_config, list_archs  # noqa: E402
from repro_torch.kernels import LAUNCH_COUNTERS  # noqa: E402
from repro_torch.kernels.common import assert_allclose_by_dtype  # noqa: E402
from repro_torch.launch import serve as port_serve  # noqa: E402
from repro_torch.models.convert import (  # noqa: E402
    caches_from_reference,
    caches_to_reference,
    params_from_reference,
)
from repro_torch.models.registry import Model, build_model  # noqa: E402
from repro_torch.models.layers.embedding import padded_vocab  # noqa: E402
from repro_torch.parallel.ctx import ParallelCtx  # noqa: E402

ARCH = "mamba2-1.3b"
FP32_TOL = dict(rtol=1e-4, atol=1e-4)


def _cfgs(dtype="float32"):
    ref = dataclasses.replace(ref_get_config(ARCH).smoke(), dtype=dtype)
    port = dataclasses.replace(get_config(ARCH).smoke(), dtype=dtype)
    return ref, port


def _host(tree):
    return jax.tree.map(lambda a: np.asarray(a.astype(jnp.float32))
                        if a.dtype == jnp.bfloat16 else np.asarray(a), tree)


def _np(t):
    return (t.float() if t.dtype == torch.bfloat16 else t).detach().numpy()


def _run_both(dtype, tokens, steps):
    """Prefill ``tokens`` and decode ``steps`` greedy tokens on both sides
    (each side feeding its own argmax). Returns per-step (logits, caches)
    pairs, host arrays in the reference's cache layout, and both token lists."""
    ref_cfg, cfg = _cfgs(dtype)
    ref_model, model = RefModel(ref_cfg), Model(cfg)
    jp = ref_model.init(jax.random.PRNGKey(0))
    tp = params_from_reference(jax.tree.map(np.asarray, jp), cfg, device="cpu")
    b, s = tokens.shape
    jl, jc = ref_model.prefill(jp, {"tokens": jnp.asarray(tokens, jnp.int32)}, RefCtx())
    tl, tc = model.prefill(tp, {"tokens": torch.from_numpy(tokens)}, ParallelCtx())
    out = [((_host(jl), _np(tl)), (_host(jc)["ssm"], caches_to_reference(tc, cfg)["ssm"]))]
    jt = jnp.argmax(jl[:, -1:], axis=-1).astype(jnp.int32)
    tt = torch.argmax(tl[:, -1:], dim=-1)
    toks = ([np.asarray(jt)[:, 0].tolist()], [tt[:, 0].tolist()])
    for i in range(steps):
        pos = s + i
        jl, jc = ref_model.decode_step(
            jp, jc, {"token": jt, "pos": jnp.full((b,), pos, jnp.int32)}, RefCtx())
        tl, tc = model.decode_step(
            tp, tc, {"token": tt, "pos": torch.full((b,), pos, dtype=torch.int32)}, ParallelCtx())
        out.append(((_host(jl), _np(tl)), (_host(jc)["ssm"], caches_to_reference(tc, cfg)["ssm"])))
        jt = jnp.argmax(jl[:, -1:], axis=-1).astype(jnp.int32)
        tt = torch.argmax(tl[:, -1:], dim=-1)
        toks[0].append(np.asarray(jt)[:, 0].tolist())
        toks[1].append(tt[:, 0].tolist())
    return out, toks


@pytest.mark.parametrize("seq", [16, 32], ids=["one-chunk", "two-chunks"])
def test_prefill_and_decode_match_reference_fp32(seq):
    tokens = np.random.default_rng(seq).integers(0, 512, size=(2, seq))
    out, (ref_toks, port_toks) = _run_both("float32", tokens, steps=4)
    for (jl, tl), (jc, tc) in out:
        assert tl.shape == jl.shape == (2, jl.shape[1], padded_vocab(512))
        np.testing.assert_allclose(tl, jl, **FP32_TOL)
        for f in ("conv_x", "conv_b", "conv_c", "ssd"):
            np.testing.assert_allclose(tc[f], getattr(jc, f), **FP32_TOL)
    assert port_toks == ref_toks


def test_prefill_and_decode_match_reference_bf16():
    tokens = np.random.default_rng(1).integers(0, 512, size=(2, 16))
    out, _ = _run_both("bfloat16", tokens, steps=4)
    for (jl, tl), (jc, tc) in out:
        assert_allclose_by_dtype(tl, jl, jnp.bfloat16)
        for f in ("conv_x", "conv_b", "conv_c", "ssd"):
            assert_allclose_by_dtype(tc[f], getattr(jc, f), jnp.bfloat16)


def _requests(cls, lengths, seed):
    rng = np.random.default_rng(seed)
    return [cls(rid=i, prompt=rng.integers(0, 512, size=n), max_new=3 + i % 3)
            for i, n in enumerate(lengths)]


def test_serve_matches_reference_serve():
    # The second batch pads to 32 = two chunks of the smoke config's 16.
    lengths = [5, 16, 9, 12, 32, 20, 7, 31]
    ref_reqs, ref_stats = ref_serve.serve(
        arch=ARCH, requests=_requests(ref_serve.Request, lengths, 2), batch_slots=4, seed=0)
    _, cfg = _cfgs()
    tp = params_from_reference(jax.tree.map(np.asarray, RefModel(_cfgs()[0]).init(
        jax.random.PRNGKey(0))), cfg, device="cpu")
    before = LAUNCH_COUNTERS["ssd_stage1"].count
    reqs, stats = port_serve.serve(
        arch=ARCH, requests=_requests(port_serve.Request, lengths, 2), batch_slots=4, seed=0,
        device="cpu", params=tp)
    assert [r.out for r in reqs] == [r.out for r in ref_reqs]
    assert all(r.done for r in reqs)
    assert set(stats) == set(ref_stats)
    for key in ("prefills", "decode_steps", "tokens"):
        assert stats[key] == ref_stats[key], key
    assert LAUNCH_COUNTERS["ssd_stage1"].count == before  # the CPU runs the plain Stage 1


def test_serve_with_random_weights_is_deterministic_and_in_vocab():
    runs = [port_serve.serve(arch=ARCH, requests=_requests(port_serve.Request, [4, 16], 3),
                             batch_slots=2, seed=3, device="cpu") for _ in range(2)]
    assert [r.out for r in runs[0][0]] == [r.out for r in runs[1][0]]
    assert all(0 <= t < 512 for r in runs[0][0] for t in r.out)


def test_serve_raises_where_the_reference_raises():
    bad = [23]  # pads to 23 > chunk 16 and not a multiple of it
    with pytest.raises(AssertionError, match="seq 23 % chunk 16"):
        ref_serve.serve(arch=ARCH, requests=_requests(ref_serve.Request, bad, 0), seed=0)
    with pytest.raises(ValueError, match="seq 23 % chunk 16"):
        port_serve.serve(arch=ARCH, requests=_requests(port_serve.Request, bad, 0), seed=0,
                         device="cpu")
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        port_serve.serve(arch=ARCH, requests=[], use_mesh="single", device="cpu")


def test_serve_asks_for_the_card_by_default():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present; the missing-card error cannot occur")
    with pytest.raises(RuntimeError, match="CUDA"):
        port_serve.serve(arch=ARCH, requests=_requests(port_serve.Request, [4], 0))


def test_caches_round_trip_through_the_reference_layout():
    ref_cfg, cfg = _cfgs()
    caches = RefModel(ref_cfg).make_caches(2, 16)
    rng = np.random.default_rng(4)
    tree = {"ssm": {f: rng.standard_normal(np.shape(getattr(caches["ssm"], f))).astype(np.float32)
                    for f in ("conv_x", "conv_b", "conv_c", "ssd")}}
    back = caches_to_reference(caches_from_reference(tree, cfg, device="cpu"), cfg)
    for f, a in tree["ssm"].items():
        np.testing.assert_array_equal(back["ssm"][f], a)


def test_list_archs_is_the_references():
    assert list_archs() == ref_list_archs()


@pytest.mark.parametrize("arch", ["moonshot-v1-16b-a3b", "kimi-k2-1t-a32b", "whisper-medium"],
                         ids=["moe-moonshot", "moe-kimi", "encdec"])
def test_build_model_raises_for_families_not_ported(arch):
    """The moe and encdec families build, draw their weights and serve at
    smoke size; only a family outside the port's list is refused."""
    cfg = get_config(arch)
    assert build_model(cfg).cfg is cfg and cfg.family in ("moe", "encdec")
    reqs, stats = port_serve.serve(arch=arch, requests=_requests(port_serve.Request, [4, 9], 5),
                                   batch_slots=2, seed=0, device="cpu")
    assert stats["prefills"] == 1 and all(r.done for r in reqs)
    assert all(0 <= t < 512 for r in reqs for t in r.out)
    with pytest.raises(NotImplementedError, match="families"):
        build_model(dataclasses.replace(cfg, family="rnn"))


def test_init_is_seeded_and_matches_the_reference_layout():
    ref_cfg, cfg = _cfgs()
    a, b = (Model(cfg).init(7, device="cpu") for _ in range(2))
    for (name, pa), (_, pb) in zip(a.named_parameters(), b.named_parameters()):
        assert torch.equal(pa, pb), name
    ref_leaves = jax.tree_util.tree_flatten_with_path(
        jax.eval_shape(lambda: RefModel(ref_cfg).init(jax.random.PRNGKey(0))))[0]
    n_ref = sum(int(np.prod(leaf.shape)) for _, leaf in ref_leaves)
    assert sum(p.numel() for p in a.parameters()) == n_ref
