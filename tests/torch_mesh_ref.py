"""The parent's side of the port's sharded LM tests (this module imports
jax; the ranks of ``torch_mesh_rig`` never do): the reference's unsharded
train step and greedy decode, the port's unsharded ones on the same
weights, and the comparisons the sharded ranks are held to.

Tolerances, fp32:

- sharded against the port's unsharded path: the loss within 1e-5
  relative; every gradient (gathered) within 1e-4 of its tensor's largest
  magnitude; every parameter after one AdamW step within 1e-4 of its
  tensor's largest magnitude where the gradient is resolved (as in
  ``test_torch_train``: above 1e-4 of its largest magnitude and above
  1000·eps); decode logits within 1e-4 of their largest magnitude and the
  same greedy tokens;
- sharded against the reference's unsharded functions
  (``ParallelCtx(mesh=None)``): the training gate (loss within 1e-4
  relative, gradients within 1e-3 of their largest magnitude) and the LM
  gate (logits within 1e-3, the same greedy tokens).
"""

from __future__ import annotations

import dataclasses
import functools
from typing import Any, Dict, Tuple

import numpy as np
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
from repro.parallel.ctx import ParallelCtx as RefCtx  # noqa: E402
from repro.train.step import make_loss_fn as ref_make_loss_fn  # noqa: E402
from repro_torch.configs.base import get_config  # noqa: E402
from repro_torch.models.convert import params_from_reference  # noqa: E402
from repro_torch.models.registry import Model  # noqa: E402
from repro_torch.optim import adamw  # noqa: E402
from repro_torch.parallel.ctx import ParallelCtx  # noqa: E402
from repro_torch.train.step import init_train_state, make_grad_fn, make_train_step  # noqa: E402

import torch_mesh_rig as rig  # noqa: E402

LR = 1e-3
TOL = 1e-4          # sharded against the port's unsharded path
LOSS_TOL = 1e-5
REF_TRAIN_TOL = 1e-3  # against the reference's unsharded functions
REF_LOSS_TOL = 1e-4
REF_LM_TOL = 1e-3
ADAMW_EPS = 1e-8
SHAPE = dict(name="train_smoke", seq_len=32, global_batch=2, kind="train")
DECODE = dict(batch=2, prompt=16, steps=4, max_len=32)
#: moonshot at capacity_factor = E / k: no expert can overflow, so the
#: sharded MoE (capacity from the local token count) and the unsharded one
#: (the global count) drop nothing and agree; the capacity rule itself is
#: held per data shard in ``test_torch_mesh_moe.py``.
NO_DROP = {"moonshot-v1-16b-a3b": {"capacity_factor": 4.0}}


def cfgs(arch: str, changes: Dict[str, Any]) -> Tuple[Any, Any]:
    ref = dataclasses.replace(ref_get_config(arch).smoke(), dtype="float32", **changes)
    port = dataclasses.replace(get_config(arch).smoke(), dtype="float32", **changes)
    return ref, port


def _host(tree: Any) -> Any:
    return jax.tree.map(np.asarray, tree)


def _key(changes: Dict[str, Any]) -> Tuple:
    return tuple(sorted(changes.items()))


@functools.lru_cache(maxsize=None)
def reference(arch: str, changes: Tuple = (), global_batch: int = 2) -> Dict[str, Any]:
    """The reference's weights, batch, loss and gradients (unsharded)."""
    ref_cfg, _ = cfgs(arch, dict(changes))
    model = RefModel(ref_cfg)
    params = model.init(jax.random.PRNGKey(0), max_dec_len=64)
    batch = ref_synthesize_batch(ref_cfg, RefShapeSpec(**dict(SHAPE, global_batch=global_batch)),
                                 seed=3)
    loss_fn = jax.jit(jax.value_and_grad(ref_make_loss_fn(model, ref_cfg, RefCtx()), has_aux=True))
    (loss, _), grads = loss_fn(params, batch)
    return dict(params=_host(params), batch=_host(batch), loss=float(loss), grads=_host(grads))


def port_unsharded(arch: str, changes: Dict[str, Any], ref: Dict[str, Any]) -> Dict[str, Any]:
    """The port's full weights by name, the global batch, and its
    unsharded loss, gradients and parameters after one AdamW step."""
    _, cfg = cfgs(arch, changes)
    model, opt = Model(cfg), adamw(LR)
    batch = {k: torch.from_numpy(np.array(v)) for k, v in ref["batch"].items()}
    params = params_from_reference(ref["params"], cfg, device="cpu")
    named = {k: p.detach().clone() for k, p in params.named_parameters()}
    state = init_train_state(model, cfg, opt, 0, params=params)
    loss, metrics, grads = make_grad_fn(model, cfg, ParallelCtx())(state.params, batch)
    state, out = make_train_step(model, cfg, ParallelCtx(), opt)(state, batch)
    after = {k: p.detach() for k, p in state.params.named_parameters()}
    return dict(cfg=cfg, model=model, named=named, batch=batch, loss=float(loss),
                grads={k: g.detach() for k, g in grads.items()}, after=after,
                gnorm=float(out["grad_norm"]))


def named_reference(tree: Any, cfg: Any) -> Dict[str, torch.Tensor]:
    return {k: p.detach() for k, p in params_from_reference(tree, cfg, device="cpu")
            .named_parameters()}


def close_to_max(got: Any, want: Any, tol: float, what: str = "") -> float:
    got = np.asarray(got, np.float64)
    want = np.asarray(want, np.float64)
    assert got.shape == want.shape, (what, got.shape, want.shape)
    scale = np.abs(want).max()
    err = np.abs(got - want).max()
    assert err <= tol * scale or scale == 0.0, (what, err, scale)
    return float(err / scale) if scale else 0.0


def check_train(sharded: Dict[str, Any], port: Dict[str, Any], ref: Dict[str, Any]) -> None:
    """A sharded train step against the port's unsharded one and the
    reference's unsharded gradients."""
    assert abs(sharded["loss"] - port["loss"]) <= LOSS_TOL * abs(port["loss"]), \
        (sharded["loss"], port["loss"])
    assert abs(sharded["step_loss"] - port["loss"]) <= LOSS_TOL * abs(port["loss"])
    assert abs(sharded["gnorm"] - port["gnorm"]) <= LOSS_TOL * abs(port["gnorm"])
    assert set(sharded["grads"]) == set(port["grads"])
    for k, g in port["grads"].items():
        close_to_max(sharded["grads"][k].numpy(), g.numpy(), TOL, k)
    for k, w in port["after"].items():
        g = port["grads"][k].numpy()
        resolved = (np.abs(g) > TOL * np.abs(g).max()) & (np.abs(g) > 1e3 * ADAMW_EPS)
        w = w.numpy().astype(np.float64)
        diff = np.abs(sharded["after"][k].numpy().astype(np.float64) - w)
        assert (diff[resolved] <= TOL * np.abs(w).max()).all(), k
    if ref is None:
        return
    assert abs(sharded["loss"] - ref["loss"]) <= REF_LOSS_TOL * abs(ref["loss"])
    for k, g in named_reference(ref["grads"], port["cfg"]).items():
        close_to_max(sharded["grads"][k].numpy(), g.numpy(), REF_TRAIN_TOL, k)


def decode_tokens(cfg: Any, seed: int = 5) -> torch.Tensor:
    rng = np.random.default_rng(seed)
    return torch.from_numpy(rng.integers(0, cfg.vocab_size, (DECODE["batch"], DECODE["prompt"])))


def decode_frames(cfg: Any, seed: int = 6) -> Any:
    """The encoder-decoder's prefill frames ([B, frontend_tokens, d], fp32);
    ``None`` for the other families."""
    if cfg.family != "encdec":
        return None
    rng = np.random.default_rng(seed)
    return torch.from_numpy(rng.standard_normal(
        (DECODE["batch"], cfg.frontend_tokens, cfg.d_model)).astype(np.float32))


def reference_greedy(arch: str, changes: Dict[str, Any], ref_params: Any,
                     tokens: torch.Tensor, frames: Any = None) -> Dict[str, np.ndarray]:
    """The reference's unsharded prefill (with ``frames`` for the
    encoder-decoder) and greedy decode steps."""
    ref_cfg, _ = cfgs(arch, changes)
    model = RefModel(ref_cfg)
    b, s = tokens.shape
    max_len, steps = DECODE["max_len"], DECODE["steps"]
    prefill = jax.jit(lambda p, batch: model.prefill(p, batch, RefCtx(), max_len=max_len))
    decode = jax.jit(lambda p, c, batch: model.decode_step(p, c, batch, RefCtx()))
    jp = jax.tree.map(jnp.asarray, ref_params)
    batch = {"tokens": jnp.asarray(tokens.numpy(), jnp.int32)}
    if frames is not None:
        batch["frames"] = jnp.asarray(frames.numpy())
    logits, caches = prefill(jp, batch)
    out, toks = [np.asarray(logits[:, -1])], []
    nxt = jnp.argmax(logits[:, -1:], axis=-1).astype(jnp.int32)
    for i in range(steps):
        toks.append(np.asarray(nxt))
        logits, caches = decode(jp, caches, {"token": nxt, "pos": jnp.full((b,), s + i, jnp.int32)})
        out.append(np.asarray(logits[:, -1]))
        nxt = jnp.argmax(logits[:, -1:], axis=-1).astype(jnp.int32)
    return dict(logits=np.stack(out), tokens=np.concatenate(toks, axis=1))


def check_decode(sharded: Dict[str, Any], port: Dict[str, Any],
                 ref: Dict[str, np.ndarray] | None) -> None:
    assert torch.equal(sharded["tokens"], port["tokens"])
    close_to_max(sharded["logits"].numpy(), port["logits"].numpy(), TOL, "logits")
    if ref is not None:
        assert np.array_equal(sharded["tokens"].numpy(), ref["tokens"])
        np.testing.assert_allclose(sharded["logits"].numpy(), ref["logits"],
                                   rtol=REF_LM_TOL, atol=REF_LM_TOL)


def run_family(tmp_path: Any, arch: str, *, decode: bool, strategy: str = "tp",
               changes: Dict[str, Any] | None = None) -> None:
    """One spawn: the sharded train step (and decode) of ``arch`` under
    ``strategy`` against the port's unsharded path and the reference's
    unsharded functions; ``changes`` to the smoke config (default: the
    capacity that drops nothing, for the MoE)."""
    changes = NO_DROP.get(arch, {}) if changes is None else changes
    ref = reference(arch, _key(changes))
    port = port_unsharded(arch, changes, ref)
    tokens = decode_tokens(port["cfg"]) if decode else None
    frames = decode_frames(port["cfg"]) if decode else None
    results = rig.run_ranks(tmp_path, rig.family_rank, arch, changes, port["named"],
                            port["batch"], LR, tokens, DECODE["steps"], DECODE["max_len"],
                            strategy, frames)
    # The lengths the residual stream was split from: under sp_tp the train
    # sequence, the prompt and the encoder's frames, each halved; else none.
    split_from = {a for r in results for a, b in r["seq_splits"] if 2 * b == a}
    want_split: set = set()
    if strategy == "sp_tp":
        want_split = {SHAPE["seq_len"]} | ({DECODE["prompt"]} if decode else set())
        if "frames" in port["batch"]:
            want_split |= {port["batch"]["frames"].shape[1]}
    assert split_from == want_split, (split_from, want_split)
    for r in results:  # every rank returns the same global numbers
        assert r["loss"] == results[0]["loss"]
        check_train(r, port, ref)
    if decode:
        want = rig.greedy(port["model"], params_from_reference(ref["params"], port["cfg"],
                                                                device="cpu"),
                          tokens, ParallelCtx(), DECODE["steps"], DECODE["max_len"], frames)
        ref_dec = reference_greedy(arch, changes, ref["params"], tokens, frames)
        for r in results:
            check_decode(r["decode"], want, ref_dec)
