"""The pieces of the port's sharded LM path beside the families' steps:

- the sharding rules: ``param_specs`` and ``batch_spec`` give, leaf for
  leaf, the axes the reference's ``PartitionSpec`` s name under an
  equivalent context (the reference's spec functions run without devices;
  the port's run on a stand-in mesh that makes no process group), for the
  seven reference families under the three strategies and on the
  multi-pod mesh;
- ``plan_buckets`` and ``tuned_bucket_count`` equal the reference's; the
  bucketed all-reduce equals one all-reduce a tensor; fed by gradient
  hooks it puts a bucket on the wire before the backward ends, and sums
  bf16 gradients in bf16;
- ``init_local`` (each leaf cut to this rank's slice as it is drawn) gives
  ``shard_params`` of the full draw, slice for slice and spec for spec,
  for the seven families;
- ``make_production_mesh`` raises, naming the world size, with fewer
  ranks than its shape; ``ParallelCtx`` takes only a ``DeviceMesh``;
- on four ranks of a (data = 2, model = 2) mesh on the CPU, in one spawn:
  the ``sp_tp`` and ``dp_only`` strategies' train step of qwen3-4b against
  the port's unsharded step (``torch_mesh_ref`` states the tolerances),
  the decode of both users of ``_sp_cache_attention`` (``seq_shard`` at
  batch 1, and a config with one KV head, fewer than ``tp``) against the
  unsharded decode within 1e-5 of the logits' largest magnitude; an
  Adafactor step under ``tp`` and ``dp_only`` (its row and column
  statistics and its RMS clip summed over the axes each parameter is
  split on) against the unsharded step, every parameter's step within
  1e-4 of its tensor's largest step;
- the launchers: ``serve(use_mesh="single")`` and
  ``run_training(use_mesh="single")`` with the production mesh replaced
  by the 2 x 2 mesh serve the unsharded tokens and take two steps.
"""

import dataclasses

import numpy as np
import pytest
import torch

import torch_mesh_ref as mr
import torch_mesh_rig as rig

import jax  # noqa: E402  (torch_mesh_ref set the reference up)

from repro.launch import mesh as ref_mesh  # noqa: E402
from repro.models.registry import Model as RefModel  # noqa: E402
from repro.parallel import collectives as ref_collectives  # noqa: E402
from repro.parallel import sharding as ref_sharding  # noqa: E402
import repro_torch.launch.serve as serve_mod  # noqa: E402
import repro_torch.launch.train as train_mod  # noqa: E402
from repro_torch.launch import mesh as port_mesh  # noqa: E402
from repro_torch.models.registry import Model  # noqa: E402
from repro_torch.parallel import collectives, ctx as port_ctx, sharding  # noqa: E402
from repro_torch.optim import adafactor  # noqa: E402
from repro_torch.parallel.ctx import ParallelCtx  # noqa: E402
from repro_torch.train.step import init_train_state, make_train_step  # noqa: E402

FAMILIES = ["qwen3-4b", "gemma2-27b", "moonshot-v1-16b-a3b", "mamba2-1.3b", "zamba2-7b",
            "whisper-medium", "internvl2-2b"]
MESHES = {"single": ((16, 16), ("data", "model")),
          "multi": ((2, 16, 16), ("pod", "data", "model")),
          "debug": ((2, 2), ("data", "model"))}


class _ShapeMesh:
    """A mesh's names and sizes, no process group (for the rules)."""

    def __init__(self, shape, names):
        self.mesh_dim_names = names
        self.shape = dict(zip(names, shape))  # the reference reads these two
        self.axis_names = names
        self._sizes = shape

    def size(self, i):
        return self._sizes[i]

    def get_group(self, name):  # pragma: no cover - never called by the rules
        raise AssertionError("the rules make no collective")


def _norm(entry):
    if isinstance(entry, tuple):
        entry = tuple(entry)
        return entry[0] if len(entry) == 1 else entry
    return entry


def _strip(path):
    return ".".join(k for k in path.split(".") if not k.isdigit())


def _ctxs(monkeypatch, mesh_name, strategy, **changes):
    monkeypatch.setattr(port_ctx, "_make_groups", lambda mesh: None)
    shape, names = MESHES[mesh_name]
    m = _ShapeMesh(shape, names)
    return (dataclasses.replace(ref_mesh.make_ctx(m, strategy=strategy), **changes),
            dataclasses.replace(port_mesh.make_ctx(m, strategy=strategy), **changes))


def _ref_specs(ref_cfg, ref_ctx):
    """The reference's param specs by stripped path, with each leaf's shape."""
    shapes = jax.eval_shape(lambda: RefModel(ref_cfg).init(jax.random.PRNGKey(0),
                                                          max_dec_len=64))
    specs = ref_sharding.param_specs(shapes, ref_cfg, ref_ctx)
    leaves = dict(jax.tree_util.tree_flatten_with_path(shapes)[0])
    flat = jax.tree_util.tree_flatten_with_path(
        specs, is_leaf=lambda x: isinstance(x, jax.sharding.PartitionSpec))[0]
    out = {}
    for path, spec in flat:
        name = ".".join(str(getattr(k, "key", getattr(k, "name", k))) for k in path)
        shape = leaves[path].shape
        out[name] = (tuple(_norm(e) for e in tuple(spec) + (None,) * len(shape))[:len(shape)])
    return out


@pytest.mark.parametrize("mesh_name,strategy", [("single", "tp"), ("single", "sp_tp"),
                                                ("single", "dp_only"), ("multi", "tp"),
                                                ("debug", "tp"), ("debug", "dp_only")])
def test_param_specs_match_reference(monkeypatch, mesh_name, strategy):
    ref_ctx, pctx = _ctxs(monkeypatch, mesh_name, strategy)
    checked = 0
    for arch in FAMILIES:
        ref_cfg, cfg = mr.cfgs(arch, {})
        want = _ref_specs(ref_cfg, ref_ctx)
        shapes = {k: tuple(p.shape) for k, p in
                  Model(cfg).init(0, device="cpu", max_dec_len=64).named_parameters()}
        for k, spec in sharding.param_specs(shapes, cfg, pctx).items():
            trail = want[_strip(k)][-len(shapes[k]):] if shapes[k] else ()
            assert tuple(_norm(e) for e in spec) == trail, (arch, k, spec, trail)
            checked += 1
    assert checked > 300


@pytest.mark.parametrize("strategy", ["tp", "dp_only"])
def test_make_train_shardings_match_reference(monkeypatch, multi_device_count, strategy):
    """On a real (2, 2) jax mesh of the forced host devices, the
    reference's NamedShardings name the axes the port's specs name."""
    mesh = ref_mesh.make_debug_mesh(2, 2)
    ref_ctx = ref_mesh.make_ctx(mesh, strategy=strategy)
    _, pctx = _ctxs(monkeypatch, "debug", strategy)
    for arch in ("qwen3-4b", "mamba2-1.3b"):
        ref_cfg, cfg = mr.cfgs(arch, {})
        ref = mr.reference(arch)
        jbatch = jax.tree.map(lambda a: jax.ShapeDtypeStruct(a.shape, a.dtype), ref["batch"])
        jparams = jax.eval_shape(lambda: RefModel(ref_cfg).init(jax.random.PRNGKey(0),
                                                               max_dec_len=64))
        p_sh, b_sh = ref_sharding.make_train_shardings(jparams, jbatch, ref_cfg, ref_ctx)
        port = Model(cfg).init(0, device="cpu", max_dec_len=64)
        batch = {k: torch.empty(v.shape, device="meta") for k, v in ref["batch"].items()}
        p_specs, b_specs = sharding.make_train_shardings(port, batch, cfg, pctx)
        for k, spec in b_specs.items():
            want = tuple(_norm(e) for e in tuple(b_sh[k].spec) + (None,) * 3)[:len(spec)]
            assert tuple(_norm(e) for e in spec) == want, (arch, k)
        flat = jax.tree_util.tree_flatten_with_path(p_sh)[0]
        want = {".".join(str(getattr(q, "key", getattr(q, "name", q))) for q in path): sh.spec
                for path, sh in flat}
        for k, spec in p_specs.items():
            ref_spec = tuple(_norm(e) for e in want[_strip(k)])  # one entry a stacked dim
            assert tuple(_norm(e) for e in spec) == ref_spec[len(ref_spec) - len(spec):], \
                (arch, k, spec, ref_spec)


def _ref_key(name):
    return (jax.tree_util.DictKey("caches"), jax.tree_util.GetAttrKey(name))


@pytest.mark.parametrize("mesh_name,strategy", [("single", "tp"), ("single", "dp_only"),
                                                ("multi", "tp"), ("debug", "tp")])
@pytest.mark.parametrize("seq_sharded", [False, True])
def test_batch_specs_match_reference(monkeypatch, mesh_name, strategy, seq_sharded):
    ref_ctx, pctx = _ctxs(monkeypatch, mesh_name, strategy)
    leaves = {"k": (64, 256, None, 128), "v": (32, 512, None, 64), "conv_x": (64, 3, None),
              "conv_b": (64, 3, 128), "conv_c": (48, 3, 128), "ssd": (64, None, 64, 128),
              "enc_out": (64, 1500, 1024), "tokens": (64, 1024), "labels": (48, 512),
              "pos": (64,), "token": (32, 1), "frames": (3, 1500, 1024)}
    for arch in FAMILIES:
        ref_cfg, cfg = mr.cfgs(arch, {})
        for kv in (cfg.num_kv_heads or 1, 1, 3, 16, 32):
            ref_c = dataclasses.replace(ref_cfg, num_kv_heads=kv)
            port_c = dataclasses.replace(cfg, num_kv_heads=kv)
            want = ref_sharding.batch_spec(ref_c, ref_ctx, seq_sharded=seq_sharded)
            got = sharding.batch_spec(port_c, pctx, seq_sharded=seq_sharded)
            for name, shape in leaves.items():
                fill = {"k": kv, "v": kv, "conv_x": cfg.ssm_d_inner or 64,
                        "ssd": cfg.ssm_heads or 16}.get(name)
                shape = tuple(fill if d is None else d for d in shape)
                w = want(_ref_key(name), jax.ShapeDtypeStruct(shape, np.float32))
                w = tuple(_norm(e) for e in tuple(w) + (None,) * len(shape))[:len(shape)]
                g = got(("caches", name), shape)
                assert tuple(_norm(e) for e in g) == w, (arch, kv, name, g, w)


def test_buckets_match_reference():
    rng = np.random.default_rng(0)
    shapes = [tuple(int(d) for d in rng.integers(1, 300, size=rng.integers(1, 4)))
              for _ in range(40)]
    dtypes = [np.float32, np.float32, jax.numpy.bfloat16]
    ref_leaves = [jax.ShapeDtypeStruct(s, dtypes[i % 3]) for i, s in enumerate(shapes)]
    port_leaves = [torch.empty(s, dtype=(torch.bfloat16 if i % 3 == 2 else torch.float32))
                   for i, s in enumerate(shapes)]
    for n in (1, 2, 3, 4, 8, 64):
        assert collectives.plan_buckets(port_leaves, n_buckets=n) == \
            ref_collectives.plan_buckets(ref_leaves, n_buckets=n)
    for bw, back in ((50e9, 1e-3), (1e9, 0.05), (400e9, 1e-6), (5e9, 0.0)):
        assert collectives.tuned_bucket_count(port_leaves, link_bandwidth_Bps=bw,
                                              backward_compute_s=back) == \
            ref_collectives.tuned_bucket_count(ref_leaves, link_bandwidth_Bps=bw,
                                               backward_compute_s=back)


def test_bucketed_all_reduce_equals_one_all_reduce(tmp_path):
    sizes = [(7, 5), (300,), (2, 3, 4), (1,), (64, 64), (9,)]
    for r in rig.run_ranks(tmp_path, rig.collectives_rank, sizes, 3):
        for key, err in r.items():
            assert err <= 1e-6, (key, err)


def test_bucketed_all_reduce_issues_buckets_during_the_backward(tmp_path):
    for r in rig.run_ranks(tmp_path, rig.overlap_rank, 5):
        # w3's gradient comes first, w1's last: two buckets are on the wire
        # before the backward ends
        assert r["in_flight"] == {"w3": 0, "w2": 1, "w1": 2}, r["in_flight"]
        assert r["err"] <= 1e-6, r["err"]
        assert r["bf16_exact"]
        assert 0.0 < r["latency"] < 1.0 and r["bandwidth"] > 0.0, r


def test_init_local_is_the_full_draw_sharded(tmp_path):
    archs = ("qwen3-4b", "gemma2-27b", "moonshot-v1-16b-a3b", "mamba2-1.3b", "zamba2-7b",
             "whisper-medium", "internvl2-2b")
    for r in rig.run_ranks(tmp_path, rig.init_local_rank, archs):
        assert set(r) == {(a, s) for a in archs for s in ("tp", "dp_only")}
        assert all(not bad for bad in r.values()), r


def test_production_mesh_needs_its_ranks():
    with pytest.raises(RuntimeError, match="needs 256 ranks.*world size 1"):
        port_mesh.make_production_mesh(device_type="cpu")
    with pytest.raises(RuntimeError, match="needs 512 ranks.*world size 1"):
        port_mesh.make_production_mesh(device_type="cpu", multi_pod=True)
    with pytest.raises(RuntimeError, match="world size 1"):
        serve_mod.serve(arch="qwen3-4b", requests=[], use_mesh="single", device="cpu")
    with pytest.raises(RuntimeError, match="world size 1"):
        train_mod.run_training(arch="qwen3-4b", steps=1, use_mesh="single", device="cpu")
    with pytest.raises(TypeError, match="DeviceMesh"):
        ParallelCtx(mesh=object())
    with pytest.raises(ValueError, match="strategy"):
        port_mesh.make_ctx(_ShapeMesh((2, 2), ("data", "model")), strategy="pp")


def test_strategies_and_sp_cache_attention(tmp_path):
    arch = "qwen3-4b"
    ref = mr.reference(arch, (), 4)  # dp_only splits the batch over all four ranks
    port = mr.port_unsharded(arch, {}, ref)
    cfg = port["cfg"]
    kv1 = dataclasses.replace(cfg, num_kv_heads=1)
    m1 = Model(kv1)
    p1 = m1.init(7, device="cpu", max_dec_len=64)
    named1 = {k: p.detach().clone() for k, p in p1.named_parameters()}
    tokens1 = mr.decode_tokens(cfg, seed=6)[:1]
    tokens2 = mr.decode_tokens(cfg, seed=7)
    steps, max_len = mr.DECODE["steps"], mr.DECODE["max_len"]
    want1 = rig.greedy(port["model"], port_full(port), tokens1, ParallelCtx(), steps, max_len)
    want2 = rig.greedy(m1, p1, tokens2, ParallelCtx(), steps, max_len)
    results = rig.run_ranks(tmp_path, rig.variants_rank, arch, port["named"], port["batch"],
                            mr.LR, named1, tokens1, tokens2, steps, max_len)
    # The unsharded Adafactor step on the same weights and batch.
    af = adafactor(mr.LR)
    state = init_train_state(port["model"], cfg, af, 0, params=port_full(port))
    state, _ = make_train_step(port["model"], cfg, ParallelCtx(), af)(state, port["batch"])
    af_after = {k: p.detach() for k, p in state.params.named_parameters()}
    for r in results:
        mr.check_train(r["sp_tp"], port, None)
        mr.check_train(r["dp_only"], port, None)
        # the residual stream between the layers held half the sequence
        assert set(r["sp_tp_lengths"]) == {mr.SHAPE["seq_len"] // rig.MESH[1]}
        for got, want, calls in ((r["seq_shard"], want1, r["seq_shard_calls"]),
                                 (r["kv1"], want2, r["kv1_calls"])):
            assert calls == steps * cfg.num_layers  # every decode step, every layer
            assert torch.equal(got["tokens"], want["tokens"])
            mr.close_to_max(got["logits"].numpy(), want["logits"].numpy(), 1e-5, "logits")
        for strategy, after in r["adafactor"].items():
            for k, w in af_after.items():
                before = port["named"][k].numpy()
                mr.close_to_max(after[k].numpy() - before, w.numpy() - before, 1e-4,
                                f"adafactor {strategy} {k}")


def port_full(port):
    return rig._full_params(port["cfg"], port["named"])


def test_launchers_serve_and_train_on_the_mesh(tmp_path):
    arch = "qwen3-4b"
    rng = np.random.default_rng(4)
    prompts = [rng.integers(0, 512, size=n).tolist() for n in (5, 9, 12, 7)]
    reqs = [serve_mod.Request(rid=i, prompt=np.asarray(p), max_new=4)
            for i, p in enumerate(prompts)]
    want, _ = serve_mod.serve(arch=arch, requests=reqs, batch_slots=4, device="cpu", seed=0)
    results = rig.run_ranks(tmp_path, rig.serve_rank, arch, prompts, 4)
    for r in results:
        assert r["out"] == [q.out for q in want]
        assert r["stats"]["tokens"] == 16 and r["stats"]["decode_steps"] == 3
        assert len(r["losses"]) == 2 and all(np.isfinite(r["losses"]))
        assert r["losses"] == results[0]["losses"]
