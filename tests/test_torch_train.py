"""Parity of the port's training path with the JAX reference, at smoke size
on the CPU, for every one of the ten configs.

The reference's ``Model(cfg).init(PRNGKey(0))`` weights are carried across
with ``params_from_reference``; the batch is ``synthesize_batch`` of a
``train`` shape from the same seed on both sides (equal element for
element). Each side's gradient tree is compared through the port's own
parameter names (the reference's tree goes through ``params_from_reference``
too). Tolerances, all fp32:

- ``train_logits``: logits at 1e-4 (relative and absolute, as the LM
  serving tests); the MoE's auxiliary loss at 1e-5 relative;
- the loss and ``grad_norm`` at 1e-5 relative;
- every gradient within 1e-4 of its tensor's largest magnitude (a gradient
  sums many terms, so its error follows the largest, not its own size);
- every parameter after one AdamW step within 1e-4 of its tensor's largest
  magnitude, except where the reference's gradient is within that same
  tolerance of zero or within 1000·eps (1e-5) of it: there AdamW's first
  step, lr·g/(|g|+eps), turns a gradient's rounding error into a large
  change of the update (lr·eps·δg/g²), or of its sign.

``remat="full"`` and ``"dots"`` must give the bits of ``"none"``; a run of
``run_training`` must learn, and a run preempted (SIGTERM) and resumed from
its checkpoint must give the unbroken run's losses exactly.
"""

import dataclasses
import functools
import os
import signal

import numpy as np
import pytest
import torch

from repro.core.tridiag import ensure_x64

ensure_x64()

import repro.api  # noqa: E402,F401  (before repro.telemetry: import-order cycle)
import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs.base import get_config as ref_get_config  # noqa: E402
from repro.configs.shapes import ShapeSpec as RefShapeSpec  # noqa: E402
from repro.configs.shapes import synthesize_batch as ref_synthesize_batch  # noqa: E402
from repro.models.registry import Model as RefModel  # noqa: E402
from repro.optim import adamw as ref_adamw  # noqa: E402
from repro.parallel.ctx import ParallelCtx as RefCtx  # noqa: E402
from repro.train.step import init_train_state as ref_init_train_state  # noqa: E402
from repro.train.step import make_loss_fn as ref_make_loss_fn  # noqa: E402
from repro.train.step import make_train_step as ref_make_train_step  # noqa: E402
import repro_torch.launch.train as train_mod  # noqa: E402
from repro_torch.configs.base import get_config  # noqa: E402
from repro_torch.configs.shapes import ShapeSpec, synthesize_batch  # noqa: E402
from repro_torch.kernels.ssd_stage1 import ops as ssd_ops  # noqa: E402
from repro_torch.models.convert import params_from_reference  # noqa: E402
from repro_torch.models.registry import Model  # noqa: E402
from repro_torch.optim import adamw  # noqa: E402
from repro_torch.optim.groups import grouped  # noqa: E402
from repro_torch.parallel.ctx import ParallelCtx  # noqa: E402
from repro_torch.train.step import (  # noqa: E402
    init_train_state,
    make_grad_fn,
    make_train_step,
)

ARCHS = ["mamba2-1.3b", "zamba2-7b", "qwen3-4b", "gemma2-27b", "codeqwen1.5-7b",
         "nemotron-4-340b", "internvl2-2b", "moonshot-v1-16b-a3b", "kimi-k2-1t-a32b",
         "whisper-medium"]
SHAPE = dict(name="train_smoke", seq_len=32, global_batch=2, kind="train")
LR = 1e-3
TOL = 1e-4
ADAMW_EPS = 1e-8  # adamw's default eps


def _cfgs(arch):
    ref = dataclasses.replace(ref_get_config(arch).smoke(), dtype="float32")
    port = dataclasses.replace(get_config(arch).smoke(), dtype="float32")
    return ref, port


def _host(tree):
    return jax.tree.map(np.asarray, tree)


@functools.lru_cache(maxsize=None)
def _reference(arch):
    """The reference's weights, batch, logits, loss, gradients and
    parameters after one AdamW step, as numpy."""
    ref_cfg, _ = _cfgs(arch)
    model = RefModel(ref_cfg)
    params = model.init(jax.random.PRNGKey(0), max_dec_len=64)
    batch = ref_synthesize_batch(ref_cfg, RefShapeSpec(**SHAPE), seed=3)
    logits, aux = model.train_logits(params, batch, RefCtx())
    (loss, metrics), grads = jax.value_and_grad(
        ref_make_loss_fn(model, ref_cfg, RefCtx()), has_aux=True)(params, batch)
    opt = ref_adamw(LR)
    updates, _ = opt.update(grads, opt.init(params), params, jnp.asarray(0, jnp.int32))
    after = jax.tree.map(lambda p, u: p + u.astype(p.dtype), params, updates)
    gnorm = jnp.sqrt(sum(jnp.sum(jnp.square(g.astype(jnp.float32)))
                         for g in jax.tree.leaves(grads)))
    return dict(params=_host(params), batch=_host(batch), logits=np.asarray(logits),
                aux=float(aux), loss=float(loss), nll=float(metrics["nll"]),
                grads=_host(grads), after=_host(after), gnorm=float(gnorm))


def _port(arch, ref):
    _, cfg = _cfgs(arch)
    return cfg, Model(cfg), params_from_reference(ref["params"], cfg, device="cpu")


def _named(tree, cfg):
    """A reference tree in the port's layout, by parameter name."""
    return {k: p.detach() for k, p in params_from_reference(tree, cfg, device="cpu").named_parameters()}


def _close_to_max(got, want, tol=TOL, what=""):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    assert got.shape == want.shape, what
    scale = np.abs(want).max()
    assert np.abs(got - want).max() <= tol * scale, (what, np.abs(got - want).max(), scale)


def _check_params_after(got, want, ref_grads, cfg):
    flipped = 0
    for k, g in _named(ref_grads, cfg).items():
        g = g.numpy()
        resolved = (np.abs(g) > TOL * np.abs(g).max()) & (np.abs(g) > 1e3 * ADAMW_EPS)
        w = want[k].numpy().astype(np.float64)
        diff = np.abs(got[k].detach().numpy().astype(np.float64) - w)
        assert (diff[resolved] <= TOL * np.abs(w).max()).all(), k
        flipped += int((diff[~resolved] > TOL * np.abs(w).max()).sum())
    return flipped


def test_synthesized_train_batches_are_the_references():
    for arch in ARCHS:
        ref_cfg, cfg = _cfgs(arch)
        want = _host(ref_synthesize_batch(ref_cfg, RefShapeSpec(**SHAPE), seed=3))
        got = synthesize_batch(cfg, ShapeSpec(**SHAPE), seed=3, device="cpu")
        assert set(got) == set(want)
        for k, v in got.items():
            assert np.array_equal(v.numpy(), want[k]), (arch, k)


@pytest.mark.parametrize("arch", ARCHS)
def test_train_logits_match_reference(arch):
    ref = _reference(arch)
    cfg, model, params = _port(arch, ref)
    batch = {k: torch.from_numpy(np.array(v)) for k, v in ref["batch"].items()}
    logits, aux = model.train_logits(params, batch, ParallelCtx())
    assert logits.shape == ref["logits"].shape
    if cfg.family == "vlm":  # cut to the text positions
        assert logits.shape[1] == batch["tokens"].shape[1]
    np.testing.assert_allclose(logits.detach().numpy(), ref["logits"], rtol=TOL, atol=TOL)
    assert aux.dtype == torch.float32 and aux.shape == ()
    assert abs(float(aux) - ref["aux"]) <= 1e-5 * max(abs(ref["aux"]), 1e-30)


@pytest.mark.parametrize("arch", ARCHS)
def test_train_step_matches_reference(arch):
    ref = _reference(arch)
    cfg, model, params = _port(arch, ref)
    batch = {k: torch.from_numpy(np.array(v)) for k, v in ref["batch"].items()}
    opt = adamw(LR)
    # The gradients, by parameter name, against the reference's tree.
    state = init_train_state(model, cfg, opt, 0, params=params)
    loss, metrics, grads = make_grad_fn(model, cfg, ParallelCtx())(state.params, batch)
    want_g = _named(ref["grads"], cfg)
    assert set(grads) == set(want_g)
    for k, g in grads.items():
        assert g.dtype == torch.float32
        _close_to_max(g.numpy(), want_g[k].numpy(), what=k)
    # One step of make_train_step.
    state, out = make_train_step(model, cfg, ParallelCtx(), opt)(state, batch)
    assert state.step == 1
    assert set(out) == {"loss", "grad_norm", "nll", "aux"}
    for name, want in (("loss", ref["loss"]), ("nll", ref["nll"]), ("grad_norm", ref["gnorm"])):
        assert abs(float(out[name]) - want) <= 1e-5 * abs(want), (name, float(out[name]), want)
    assert abs(float(loss) - ref["loss"]) <= 1e-5 * abs(ref["loss"])
    got_p = dict(state.params.named_parameters())
    _check_params_after(got_p, _named(ref["after"], cfg), ref["grads"], cfg)


def _ref_microbatch_grads(arch, n):
    """The gradient the reference's step applies with ``n`` micro-batches:
    the mean of each slice's gradient (each slice routes its own MoE
    capacity)."""
    ref = _reference(arch)
    ref_cfg, _ = _cfgs(arch)
    model = RefModel(ref_cfg)
    grad = jax.grad(lambda p, b: ref_make_loss_fn(model, ref_cfg, RefCtx())(p, b)[0])
    b = ref["batch"]["tokens"].shape[0] // n
    parts = [grad(jax.tree.map(jnp.asarray, ref["params"]),
                  {k: jnp.asarray(v[i * b:(i + 1) * b]) for k, v in ref["batch"].items()})
             for i in range(n)]
    return _host(jax.tree.map(lambda *g: sum(g) / n, *parts))


def _stable_levels(grads, cfg, margin=1e-2):
    """Where the EF-int8 compressor's first step (zero error buffers) puts
    each gradient element at least ``margin`` of a level away from a
    rounding boundary (|g| / scale mid-way between two integers), so a
    rounding error of the gradient cannot move it to another level."""
    named = {k: g.numpy().astype(np.float64) for k, g in _named(grads, cfg).items()}
    out = {}
    for names in grouped(named).values():  # one scale a reference leaf
        scale = max(max(np.abs(named[k]).max() for k in names), 1e-12) / 127.0
        for k in names:
            level = np.abs(named[k]) / scale
            out[k] = np.abs(level - np.floor(level) - 0.5) > margin
    return out


@pytest.mark.parametrize("arch", ["mamba2-1.3b", "qwen3-4b", "moonshot-v1-16b-a3b"])
@pytest.mark.parametrize("variant", ["microbatches=2", "compress_grads"])
def test_train_step_variants_match_reference(arch, variant):
    """Micro-batches (fp32 gradient sums, aux reported as 0) and the EF-int8
    compressor, through each side's own ``make_train_step``. With the
    compressor, an element whose |g|/scale sits within 1e-2 of a level's
    rounding boundary may quantize one level apart on the two sides (a
    change of max|g|/127): the error buffers (g minus its quantized value:
    within 1e-4 of the gradient's largest magnitude) and parameters are
    held only where an element is 1e-2 of a level away from such a
    boundary."""
    ref = _reference(arch)
    ref_cfg, _ = _cfgs(arch)
    kw = {"microbatches": 2} if variant == "microbatches=2" else {"compress_grads": True}
    ref_model = RefModel(ref_cfg)
    opt_r = ref_adamw(LR)
    ref_state = ref_init_train_state(ref_model, ref_cfg, opt_r, jax.random.PRNGKey(0),
                                     max_dec_len=64, compress_grads="compress_grads" in kw)
    ref_state = ref_state._replace(params=jax.tree.map(jnp.asarray, ref["params"]))
    step_r = jax.jit(ref_make_train_step(ref_model, ref_cfg, RefCtx(), opt_r, **kw))
    ref_state, ref_out = step_r(ref_state, jax.tree.map(jnp.asarray, ref["batch"]))

    cfg, model, params = _port(arch, ref)
    opt = adamw(LR)
    state = init_train_state(model, cfg, opt, 0, params=params,
                             compress_grads="compress_grads" in kw)
    batch = {k: torch.from_numpy(np.array(v)) for k, v in ref["batch"].items()}
    state, out = make_train_step(model, cfg, ParallelCtx(), opt, **kw)(state, batch)
    for name in ("loss", "grad_norm", "nll", "aux"):
        want = float(ref_out[name])
        assert abs(float(out[name]) - want) <= 1e-5 * max(abs(want), 1e-30), (name, float(out[name]), want)
    got = dict(state.params.named_parameters())
    want_p = _named(_host(ref_state.params), cfg)
    if "microbatches" in kw:
        assert float(out["aux"]) == 0.0
        _check_params_after(got, want_p, _ref_microbatch_grads(arch, 2), cfg)
        return
    stable = _stable_levels(ref["grads"], cfg)
    errors = _named(_host(ref_state.ef_state.error), cfg)
    ref_grads = _named(ref["grads"], cfg)
    for k, e in state.ef_state.error.items():
        w, gmax = errors[k].numpy(), float(ref_grads[k].abs().max())
        assert (np.abs(e.numpy() - w)[stable[k]] <= TOL * gmax).all(), k
        # the quantized step moves each stable element as the reference's
        w = want_p[k].numpy()
        assert (np.abs(got[k].detach().numpy() - w)[stable[k]] <= TOL * np.abs(w).max()).all(), k


def _port_grads(arch, remat, counter=None):
    ref = _reference(arch)
    cfg, model, params = _port(arch, ref)
    params.requires_grad_(True)
    batch = {k: torch.from_numpy(np.array(v)) for k, v in ref["batch"].items()}
    _, _, grads = make_grad_fn(model, cfg, ParallelCtx(remat=remat))(params, batch)
    return grads


@pytest.mark.parametrize("arch", ["mamba2-1.3b", "zamba2-7b", "qwen3-4b", "moonshot-v1-16b-a3b"])
@pytest.mark.parametrize("remat", ["full", "dots"])
def test_remat_gives_the_same_gradients(arch, remat, monkeypatch):
    """Recomputation runs the same ops on the same inputs: the same bits.
    With ``"full"`` every SSM layer's forward runs again in the backward."""
    calls = []
    inner = ssd_ops.ssd_stage1_cuda
    monkeypatch.setattr(ssd_ops, "ssd_stage1_cuda", lambda *a: calls.append(1) or inner(*a))
    base = _port_grads(arch, "none")
    n_plain = len(calls)
    got = _port_grads(arch, remat)
    for k, g in base.items():
        assert torch.equal(got[k], g), k
    if remat == "full":
        assert len(calls) - n_plain == 2 * n_plain


def test_remat_policy_is_checked():
    with pytest.raises(ValueError, match="remat"):
        ParallelCtx(remat="some")


def test_serving_is_unchanged_by_training():
    """``init_train_state`` makes every parameter trainable; prefill and
    decode still run under inference mode and return the same logits."""
    ref = _reference("mamba2-1.3b")
    cfg, model, params = _port("mamba2-1.3b", ref)
    tokens = torch.from_numpy(np.array(ref["batch"]["tokens"]))
    before, _ = model.prefill(params, {"tokens": tokens}, ParallelCtx())
    init_train_state(model, cfg, adamw(LR), 0, params=params)
    assert all(p.requires_grad for p in params.parameters())
    after, _ = model.prefill(params, {"tokens": tokens}, ParallelCtx())
    assert not after.requires_grad and torch.equal(before, after)


# ------------------------------------------------------------- launcher --
RUN = dict(arch="qwen3-4b", steps=12, smoke=True, global_batch=4, seq_len=32,
           log_every=100, device="cpu")


def _preempting(step):
    base = train_mod.SyntheticLMDataset

    @dataclasses.dataclass(frozen=True)
    class Preempting(base):
        def batch_at(self, s):
            if s == step:
                os.kill(os.getpid(), signal.SIGTERM)
            return base.batch_at(self, s)

    return Preempting


@pytest.fixture
def deterministic():
    """Deterministic kernels for the block: on the CPU two unbroken runs can
    otherwise differ in a loss's last bit (a multithreaded accumulation of
    the embedding's gradient)."""
    before = torch.are_deterministic_algorithms_enabled()
    torch.use_deterministic_algorithms(True)
    yield
    torch.use_deterministic_algorithms(before)


@pytest.mark.parametrize("arch", ["qwen3-4b", "mamba2-1.3b"])
def test_run_training_learns_and_resumes_step_for_step(arch, tmp_path, monkeypatch, deterministic):
    kw = dict(RUN, arch=arch)
    full = train_mod.run_training(**kw)
    assert len(full) == kw["steps"] and all(np.isfinite(full))
    assert np.mean(full[-3:]) < np.mean(full[:3]) - 0.2
    with monkeypatch.context() as m:
        m.setattr(train_mod, "SyntheticLMDataset", _preempting(7))
        first = train_mod.run_training(**kw, ckpt_dir=str(tmp_path), save_every=10**6)
    second = train_mod.run_training(**kw, ckpt_dir=str(tmp_path), save_every=10**6)
    assert 0 < len(first) < kw["steps"] and len(first) + len(second) == kw["steps"]
    assert first + second == full


def test_run_training_refuses_what_it_cannot_do():
    with pytest.raises(RuntimeError, match="needs 256 ranks.*world size 1"):
        train_mod.run_training(**dict(RUN, steps=1), use_mesh="single")
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA"):
            train_mod.run_training(**dict(RUN, steps=1, device="cuda"))
