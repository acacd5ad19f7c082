"""The port's sharded MoE (moonshot-v1-16b-a3b smoke) on four ranks of a
(data = 2, model = 2) mesh on the CPU, in one spawn:

- the family's train step against the port's unsharded step and the
  reference's unsharded gradients, at ``capacity_factor = E / k``, where
  no expert can overflow (the sharded MoE takes its capacity from the
  LOCAL token count, the reference's rule, so at the config's capacity it
  is not the unsharded MoE and is not meant to be);
- the expert-parallel layer at the config's capacity against the
  reference's ``_expert_shard`` composed per data shard (its local
  capacity) and per expert range, summed, plus the shared experts, within
  1e-5 of the output's largest magnitude; its aux loss against the
  reference's global one, 1e-5 relative;
- the int8 gather: the dequantized weights equal the reference's formula
  per source shard in numpy, exactly in fp32; its backward is the
  reduce-scatter of the cotangent; the train step with ``int8_moe_gather``
  within 0.05 relative of the unsharded loss (the reference's own
  tolerance, ``tests/test_perf_variants.py``).
"""

import numpy as np
import torch

import torch_mesh_ref as mr
import torch_mesh_rig as rig

import jax  # noqa: E402  (torch_mesh_ref set the reference up)
import jax.numpy as jnp  # noqa: E402

from repro.models.layers import mlp as ref_mlp  # noqa: E402
from repro.models.layers import moe as ref_moe  # noqa: E402
from repro.parallel.ctx import ParallelCtx as RefCtx  # noqa: E402

ARCH = "moonshot-v1-16b-a3b"
TP, DP = rig.MESH[1], rig.MESH[0]


def _int8_reference(w_full, n):
    """The reference's quantize / gather / dequantize, per source shard."""
    out = []
    for w in np.split(w_full, n, axis=1):
        scale = np.maximum(np.abs(w).max(axis=(1, 2)), np.float32(1e-8)) / np.float32(127.0)
        q = np.clip(np.round(w / scale[:, None, None]), -127, 127).astype(np.int8)
        out.append(q.astype(np.float32) * scale[:, None, None])
    return np.concatenate(out, axis=1)


def _composition(ref_cfg, p, x):
    """The reference's ``_expert_shard`` per data shard and expert range."""
    b, s, d = x.shape
    probs = jax.nn.softmax(jnp.asarray(x) @ p["router"], axis=-1)
    gates, ids = jax.lax.top_k(probs, ref_cfg.experts_per_token)
    gates = gates / jnp.maximum(gates.sum(-1, keepdims=True), 1e-9)
    e_loc = ref_cfg.num_experts // TP
    rows = b // DP
    cap = ref_moe._capacity(rows * s, ref_cfg)
    ys = []
    for i in range(DP):
        sl = slice(i * rows, (i + 1) * rows)
        xs = jnp.asarray(x[sl]).reshape(rows * s, d)
        y = sum(ref_moe._expert_shard(
            p["w1"][r * e_loc:(r + 1) * e_loc], p["w3"][r * e_loc:(r + 1) * e_loc],
            p["w2"][r * e_loc:(r + 1) * e_loc], xs, gates[sl].reshape(rows * s, -1),
            ids[sl].reshape(rows * s, -1), cfg=ref_cfg, e_start=r * e_loc, capacity=cap)
            for r in range(TP))
        ys.append(np.asarray(y).reshape(rows, s, d))
    y = np.concatenate(ys) + np.asarray(ref_mlp.mlp_apply(p["shared"], jnp.asarray(x),
                                                          "silu_gated", RefCtx()))
    _, aux = ref_moe.moe_apply(p, jnp.asarray(x), ref_cfg, RefCtx())
    return y, float(aux)


def test_sharded_moe(tmp_path):
    nodrop = mr.NO_DROP[ARCH]
    ref = mr.reference(ARCH, mr._key(nodrop))
    port = mr.port_unsharded(ARCH, nodrop, ref)
    # The config's capacity: reference weights, activations at layer 0's width.
    ref_cfg, cfg = mr.cfgs(ARCH, {})
    base = mr.reference(ARCH)
    named = mr.named_reference(base["params"], cfg)
    rng = np.random.default_rng(11)
    x = rng.standard_normal((4, 32, cfg.d_model)).astype(np.float32)
    w_full = rng.standard_normal((4, 8, 6)).astype(np.float32)
    cot = rng.standard_normal((4, 8, 6)).astype(np.float32)
    results = rig.run_ranks(tmp_path, rig.moe_checks_rank, ARCH, nodrop, port["named"],
                            port["batch"], mr.LR, named, torch.from_numpy(x),
                            torch.from_numpy(w_full), torch.from_numpy(cot))

    layer0 = jax.tree.map(lambda a: a[0], base["params"]["layers"]["moe"])
    if np.ndim(base["params"]["layers"]["moe"]["router"]) == 4:  # [groups, g, ...]
        layer0 = jax.tree.map(lambda a: a[0], layer0)
    want_y, want_aux = _composition(ref_cfg, layer0, x)
    want_deq = _int8_reference(w_full, DP)
    for r, res in enumerate(results):
        mr.check_train(res["train"], port, ref)
        loss8 = res["train_int8"]["loss"]
        assert abs(loss8 - port["loss"]) <= 0.05 * abs(port["loss"]), (loss8, port["loss"])
        mr.close_to_max(res["moe"]["y"].numpy(), want_y, 1e-5, "moe y")
        assert abs(res["moe"]["aux"] - want_aux) <= 1e-5 * abs(want_aux)
        assert np.array_equal(res["int8"]["deq"].numpy(), want_deq)
        data_rank = r // TP
        half = w_full.shape[1] // DP
        want_grad = DP * cot[:, data_rank * half:(data_rank + 1) * half]
        np.testing.assert_allclose(res["int8"]["grad"].numpy(), want_grad, rtol=1e-6)
