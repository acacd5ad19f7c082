"""Ranks for the port's sharded LM tests: ``run_ranks`` spawns one process a
rank (``torch.multiprocessing``, spawn), joins them on a ``gloo`` process
group through a file under the test's ``tmp_path`` (no TCP port two xdist
workers could both take), builds the (data, model) debug mesh on the CPU
and calls a function of this module on every rank.

Every process group has a 60 s timeout, and the parent joins the ranks
with a deadline: a rank that dies or hangs fails its test (the others are
killed), it never hangs the suite. Each rank writes what its function
returns with ``torch.save``; a rank's traceback is raised in the parent.

This module imports torch and the port only (the children never import
jax); the tests compute the reference's side in the parent.
"""

from __future__ import annotations

import dataclasses
import datetime
import time
import traceback
from pathlib import Path
from typing import Any, Callable, Dict, List, Sequence, Tuple

import torch
import torch.distributed as dist
import torch.multiprocessing as mp

WORLD = 4
MESH = (2, 2)  # (data, model)
PG_TIMEOUT_S = 60
JOIN_TIMEOUT_S = 240


def _entry(rank: int, world: int, root: str, fn_name: str, args: Tuple[Any, ...]) -> None:
    err = Path(root) / f"rank{rank}.err"
    try:
        torch.set_num_threads(1)
        dist.init_process_group("gloo", init_method=f"file://{root}/pg", rank=rank,
                                world_size=world,
                                timeout=datetime.timedelta(seconds=PG_TIMEOUT_S))
        from repro_torch.launch.mesh import make_debug_mesh

        mesh = make_debug_mesh(*MESH, device_type="cpu")
        out = globals()[fn_name](mesh, *args)
        torch.save(out, Path(root) / f"rank{rank}.pt")
        dist.barrier()
        dist.destroy_process_group()
    except BaseException:
        err.write_text(traceback.format_exc())
        raise


def run_ranks(tmp_path: Path, fn: Callable[..., Any], *args: Any,
              timeout_s: float = JOIN_TIMEOUT_S) -> List[Any]:
    """``fn(mesh, *args)`` on every rank; returns each rank's result in rank
    order. ``fn`` must be a function of this module (the children import it
    by name)."""
    root = Path(tmp_path) / f"ranks-{fn.__name__}-{time.monotonic_ns()}"
    root.mkdir(parents=True)
    ctx = mp.get_context("spawn")
    procs = [ctx.Process(target=_entry, args=(r, WORLD, str(root), fn.__name__, args),
                         daemon=True) for r in range(WORLD)]
    for p in procs:
        p.start()
    deadline = time.monotonic() + timeout_s
    try:
        for p in procs:
            p.join(max(0.0, deadline - time.monotonic()))
            if p.exitcode not in (None, 0):
                break
    finally:
        hung = [r for r, p in enumerate(procs) if p.is_alive()]
        for p in procs:
            if p.is_alive():
                p.kill()
                p.join(10)
    errors = [(r, (root / f"rank{r}.err").read_text()) for r in range(WORLD)
              if (root / f"rank{r}.err").exists()]
    if errors:
        raise AssertionError("rank {} failed:\n{}".format(*errors[0]))
    if hung or any(p.exitcode != 0 for p in procs):
        raise AssertionError(f"ranks {hung} killed at the deadline ({timeout_s} s) or after "
                             f"another rank failed; exit codes {[p.exitcode for p in procs]}")
    return [torch.load(root / f"rank{r}.pt", weights_only=False) for r in range(WORLD)]


# ----------------------------------------------------------- rank bodies ----
def _cfg(arch: str, **changes: Any) -> Any:
    from repro_torch.configs.base import get_config

    return dataclasses.replace(get_config(arch).smoke(), dtype="float32", **changes)


def _full_params(cfg: Any, named: Dict[str, torch.Tensor]) -> Any:
    """The port's module holding ``named`` (the full weights)."""
    from repro_torch.models.registry import Model

    params = Model(cfg).init(0, device="cpu", max_dec_len=64)
    with torch.no_grad():
        for k, p in params.named_parameters():
            p.copy_(named[k])
    return params


def _ctx(mesh: Any, strategy: str = "tp", **changes: Any) -> Any:
    from repro_torch.launch.mesh import make_ctx

    return dataclasses.replace(make_ctx(mesh, remat="none", strategy=strategy), **changes)


def train_rank(mesh: Any, arch: str, cfg_changes: Dict[str, Any], named: Dict[str, torch.Tensor],
               batch: Dict[str, torch.Tensor], lr: float, strategy: str = "tp",
               ctx_changes: Dict[str, Any] = {}) -> Dict[str, Any]:
    """One sharded train step: the global loss, the gathered gradients and
    the gathered parameters after one AdamW step."""
    from repro_torch.models.registry import Model
    from repro_torch.optim import adamw
    from repro_torch.parallel.sharding import gather_params, gather_tensor, shard_params
    from repro_torch.train.step import init_train_state, make_grad_fn, make_train_step

    cfg = _cfg(arch, **cfg_changes)
    pctx = _ctx(mesh, strategy, **ctx_changes)
    model, opt = Model(cfg), adamw(lr)
    local = shard_params(_full_params(cfg, named), cfg, pctx)
    state = init_train_state(model, cfg, opt, 0, params=local)
    loss, metrics, grads = make_grad_fn(model, cfg, pctx)(state.params, batch)
    specs = local.shard_specs
    full_grads = {k: gather_tensor(g, specs[k], pctx) for k, g in grads.items()}
    state, out = make_train_step(model, cfg, pctx, opt)(state, batch)
    after = {k: p.detach() for k, p in gather_params(state.params, cfg, pctx).named_parameters()}
    return dict(loss=float(loss), nll=float(metrics["nll"]), aux=float(metrics["aux"]),
                step_loss=float(out["loss"]), gnorm=float(out["grad_norm"]),
                grads=full_grads, after=after)


def family_rank(mesh: Any, arch: str, cfg_changes: Dict[str, Any],
                named: Dict[str, torch.Tensor], batch: Dict[str, torch.Tensor], lr: float,
                tokens: Any, steps: int, max_len: int, strategy: str = "tp",
                frames: Any = None) -> Dict[str, Any]:
    """The sharded train step and, with ``tokens``, the sharded decode
    (prefilled with ``frames`` for the encoder-decoder); also every
    ``seq_split`` seen, as (length in, length out)."""
    from repro_torch.parallel.ctx import ParallelCtx

    splits: List[Tuple[int, int]] = []
    seq_split = ParallelCtx.seq_split

    def probe(self: Any, x: torch.Tensor) -> torch.Tensor:
        y = seq_split(self, x)
        splits.append((int(x.shape[1]), int(y.shape[1])))
        return y

    ParallelCtx.seq_split = probe  # type: ignore[method-assign]
    try:
        out = train_rank(mesh, arch, cfg_changes, named, batch, lr, strategy)
        if tokens is not None:
            out["decode"] = decode_rank(mesh, arch, cfg_changes, named, tokens, steps, max_len,
                                        strategy=strategy, frames=frames)
    finally:
        ParallelCtx.seq_split = seq_split  # type: ignore[method-assign]
    out["seq_splits"] = splits
    return out


def decode_rank(mesh: Any, arch: str, cfg_changes: Dict[str, Any],
                named: Dict[str, torch.Tensor], tokens: torch.Tensor, steps: int,
                max_len: int, ctx_changes: Dict[str, Any] = {},
                strategy: str = "tp", frames: Any = None) -> Dict[str, Any]:
    """A sharded prefill and ``steps`` greedy decode steps: every step's
    global logits and tokens."""
    from repro_torch.models.registry import Model
    from repro_torch.parallel.sharding import shard_params

    cfg = _cfg(arch, **cfg_changes)
    pctx = _ctx(mesh, strategy, **ctx_changes)
    model = Model(cfg)
    local = shard_params(_full_params(cfg, named), cfg, pctx)
    return greedy(model, local, tokens, pctx, steps, max_len, frames)


def greedy(model: Any, params: Any, tokens: torch.Tensor, pctx: Any, steps: int,
           max_len: int, frames: Any = None) -> Dict[str, Any]:
    """Prefill (with the encoder-decoder's ``frames``) then ``steps`` greedy
    decode steps (logits and tokens)."""
    b, s = tokens.shape
    batch = {"tokens": tokens} if frames is None else {"tokens": tokens, "frames": frames}
    logits, caches = model.prefill(params, batch, pctx, max_len=max_len)
    all_logits, toks = [logits[:, -1].clone()], []
    nxt = torch.argmax(logits[:, -1:], dim=-1)
    for i in range(steps):
        toks.append(nxt)
        pos = torch.full((b,), s + i, dtype=torch.int32)
        logits, caches = model.decode_step(params, caches, {"token": nxt, "pos": pos}, pctx)
        all_logits.append(logits[:, -1].clone())
        nxt = torch.argmax(logits[:, -1:], dim=-1)
    return dict(logits=torch.stack(all_logits), tokens=torch.cat(toks, dim=1))


def _all_at_once(grads: Dict[str, torch.Tensor], group: Any, n: int) -> Dict[str, torch.Tensor]:
    """A ``BucketedAllReduce`` of ``n`` buckets fed every gradient at once."""
    from repro_torch.parallel import collectives as C

    reduce = C.BucketedAllReduce(grads, group, n)
    for k, g in grads.items():
        reduce.add(k, g)
    return reduce.result()


def collectives_rank(mesh: Any, sizes: Sequence[Tuple[int, ...]], seed: int) -> Dict[str, Any]:
    """The bucketed all-reduce against one all-reduce per tensor, over the
    data axis and over the whole mesh, at 1, 2 and 4 buckets."""
    from repro_torch.parallel import collectives as C

    pctx = _ctx(mesh)
    rank = dist.get_rank()
    gen = torch.Generator().manual_seed(seed + rank)
    grads = {f"g{i}": torch.randn(*s, generator=gen) for i, s in enumerate(sizes)}
    out: Dict[str, Any] = {}
    for axes in (("data",), ("data", "model")):
        group = pctx.group(axes)
        want = {k: C.all_reduce_(g.clone(), group) for k, g in grads.items()}
        for n in (1, 2, 4):
            got = _all_at_once(grads, group, n)
            out[(axes, n)] = max(float((got[k] - want[k]).abs().max()) for k in grads)
    return out


def overlap_rank(mesh: Any, seed: int) -> Dict[str, Any]:
    """Three parameters in a chain, their gradients fed to a
    ``BucketedAllReduce`` of three buckets by hooks during the backward:
    the calls in flight as each gradient arrives, the sums against one
    all-reduce of each gradient, and bf16 gradients summed in bf16 (small
    integers, whose sums are exact in any order). Also the link's measured
    rate and latency."""
    from repro_torch.parallel import collectives as C

    pctx = _ctx(mesh)
    group = pctx.group("data")
    gen = torch.Generator().manual_seed(seed + dist.get_rank())
    w = {k: torch.randn(*s, generator=gen, requires_grad=True)
         for k, s in (("w1", (8, 16)), ("w2", (16, 12)), ("w3", (12, 4)))}
    x = torch.randn(5, 8, generator=gen)
    loss = (torch.tanh(torch.tanh(x @ w["w1"]) @ w["w2"]) @ w["w3"]).square().sum()
    reduce = C.BucketedAllReduce(w, group, 3)
    in_flight: Dict[str, int] = {}

    def hook(k: str, g: torch.Tensor) -> None:
        in_flight[k] = len(reduce.pending)
        reduce.add(k, g)

    handles = [p.register_hook(lambda g, k=k: hook(k, g)) for k, p in w.items()]
    grads = dict(zip(w, torch.autograd.grad(loss, list(w.values()))))
    for h in handles:
        h.remove()
    got = reduce.result()
    err = max(float((got[k] - C.all_reduce_(g.clone(), group)).abs().max())
              for k, g in grads.items())
    ints = {k: torch.randint(-8, 9, s, generator=gen).to(torch.bfloat16)
            for k, s in (("a", (7, 5)), ("b", (300,)), ("c", (1,)))}
    bf16 = _all_at_once(ints, group, 2)
    bf16_exact = all(bf16[k].dtype == torch.bfloat16
                     and torch.equal(bf16[k], C.all_reduce_(t.float(), group).to(torch.bfloat16))
                     for k, t in ints.items())
    bandwidth, latency = C.measure_link(group, torch.device("cpu"))
    return dict(in_flight=in_flight, err=err, bf16_exact=bf16_exact,
                bandwidth=bandwidth, latency=latency)


def init_local_rank(mesh: Any, archs: Sequence[str]) -> Dict[str, Any]:
    """``init_local`` against ``shard_params`` of the full draw, for each
    arch under ``tp`` and ``dp_only``: the names whose slice or spec
    differ."""
    from repro_torch.models.registry import Model
    from repro_torch.parallel.sharding import init_local, shard_params

    out: Dict[str, Any] = {}
    for arch in archs:
        cfg = _cfg(arch)
        for strategy in ("tp", "dp_only"):
            pctx = _ctx(mesh, strategy)
            model = Model(cfg)
            want = shard_params(model.init(0, device="cpu", max_dec_len=64), cfg, pctx)
            got = init_local(model, 0, cfg, pctx, device="cpu", max_dec_len=64)
            w, g = dict(want.named_parameters()), dict(got.named_parameters())
            out[(arch, strategy)] = sorted(
                k for k in set(w) | set(g)
                if k not in w or k not in g or not torch.equal(w[k], g[k])
                or want.shard_specs[k] != got.shard_specs[k])
    return out


def int8_rank(mesh: Any, w_full: torch.Tensor, cot: torch.Tensor) -> Dict[str, Any]:
    """The int8 gather of this rank's slice (dim 1 split over data) and its
    backward with the cotangent ``cot`` (the same on every rank)."""
    from repro_torch.parallel import collectives as C
    from repro_torch.parallel.sharding import shard_tensor

    pctx = _ctx(mesh)
    w = shard_tensor(w_full, (None, "data", None), pctx).clone().requires_grad_(True)
    deq = C.int8_all_gather(w, pctx.group("data"), 1)
    (deq * cot).sum().backward()
    return dict(deq=deq.detach(), grad=w.grad, local=w.detach())


def moe_rank(mesh: Any, arch: str, named: Dict[str, torch.Tensor], x: torch.Tensor,
             int8: bool) -> Dict[str, Any]:
    """The sharded MoE layer of block 0 on the global activations ``x``:
    the global output and aux loss."""
    from repro_torch.models.layers.moe import moe_apply
    from repro_torch.parallel import collectives as C
    from repro_torch.parallel.sharding import gather_fsdp, shard_params, shard_tensor

    cfg = _cfg(arch)
    pctx = _ctx(mesh, int8_moe_gather=int8)
    local = gather_fsdp(shard_params(_full_params(cfg, named), cfg, pctx), pctx)
    xs = shard_tensor(x, (pctx.batch_axes,), pctx)
    with torch.no_grad():
        y, aux = moe_apply(local.layers[0].moe, xs, cfg, pctx)
    return dict(y=C.gather_tensor(y, pctx.group(pctx.batch_axes), 0), aux=float(aux))


def moe_checks_rank(mesh: Any, arch: str, nodrop: Dict[str, Any], named_nodrop: Dict[str, Any],
                    batch: Dict[str, torch.Tensor], lr: float, named: Dict[str, torch.Tensor],
                    x: torch.Tensor, w_full: torch.Tensor, cot: torch.Tensor) -> Dict[str, Any]:
    """Every MoE check in one spawn: the family's train step (at a capacity
    that drops nothing) plain and with the int8 gather, the MoE layer at
    the config's capacity, and the int8 gather alone."""
    return dict(train=train_rank(mesh, arch, nodrop, named_nodrop, batch, lr),
                train_int8=train_rank(mesh, arch, nodrop, named_nodrop, batch, lr,
                                      ctx_changes={"int8_moe_gather": True}),
                moe=moe_rank(mesh, arch, named, x, False),
                int8=int8_rank(mesh, w_full, cot))


def variants_rank(mesh: Any, arch: str, named: Dict[str, torch.Tensor],
                  batch: Dict[str, torch.Tensor], lr: float, named_kv1: Dict[str, torch.Tensor],
                  tokens1: torch.Tensor, tokens2: torch.Tensor, steps: int,
                  max_len: int) -> Dict[str, Any]:
    """The strategies and both users of ``_sp_cache_attention``, in one
    spawn: the train step under ``sp_tp`` (with the residual's length seen
    by each block) and ``dp_only``; decode under ``seq_shard`` at batch 1
    and with one KV head (fewer than ``tp``), with the calls of
    ``_sp_cache_attention`` counted."""
    from repro_torch.models import transformer
    from repro_torch.models.layers import attention

    seen: List[int] = []
    block = transformer.block_apply

    def probe(params: Any, x: torch.Tensor, *args: Any, **kwargs: Any) -> Any:
        seen.append(int(x.shape[1]))
        return block(params, x, *args, **kwargs)

    transformer.block_apply = probe  # type: ignore[assignment]
    sp_tp = train_rank(mesh, arch, {}, named, batch, lr, "sp_tp")
    transformer.block_apply = block  # type: ignore[assignment]
    dp_only = train_rank(mesh, arch, {}, named, batch, lr, "dp_only")
    steps_af = {strategy: adafactor_rank(mesh, arch, named, batch, lr, strategy)
                for strategy in ("tp", "dp_only")}

    calls = [0]
    sp = attention._sp_cache_attention

    def counted(*args: Any, **kwargs: Any) -> Any:
        calls[0] += 1
        return sp(*args, **kwargs)

    attention._sp_cache_attention = counted  # type: ignore[assignment]
    seq = decode_rank(mesh, arch, {}, named, tokens1, steps, max_len, {"seq_shard": True})
    seq_calls, calls[0] = calls[0], 0
    kv1 = decode_rank(mesh, arch, {"num_kv_heads": 1}, named_kv1, tokens2, steps, max_len)
    return dict(sp_tp=sp_tp, sp_tp_lengths=seen, dp_only=dp_only, seq_shard=seq,
                seq_shard_calls=seq_calls, kv1=kv1, kv1_calls=calls[0], adafactor=steps_af)


def adafactor_rank(mesh: Any, arch: str, named: Dict[str, torch.Tensor],
                   batch: Dict[str, torch.Tensor], lr: float, strategy: str) -> Dict[str, Any]:
    """One sharded train step with Adafactor (its statistics reduced over
    the axes each parameter is split on): the gathered parameters after."""
    from repro_torch.models.registry import Model
    from repro_torch.optim import adafactor
    from repro_torch.parallel.sharding import gather_params, shard_params
    from repro_torch.train.step import init_train_state, make_train_step

    cfg = _cfg(arch)
    pctx = _ctx(mesh, strategy)
    model = Model(cfg)
    local = shard_params(_full_params(cfg, named), cfg, pctx)
    opt = adafactor(lr, pctx=pctx, specs=local.shard_specs)
    state = init_train_state(model, cfg, opt, 0, params=local)
    state, _ = make_train_step(model, cfg, pctx, opt)(state, batch)
    return {k: p.detach() for k, p in gather_params(state.params, cfg, pctx).named_parameters()}


def serve_rank(mesh: Any, arch: str, prompts: List[List[int]], max_new: int) -> Dict[str, Any]:
    """``serve(use_mesh="single")`` and ``run_training(use_mesh="single")``
    with the production mesh replaced by this 2 x 2 mesh."""
    import numpy as np

    import repro_torch.launch.serve as serve_mod
    import repro_torch.launch.train as train_mod

    def debug_mesh(**_: Any) -> Any:
        return mesh

    serve_mod.make_production_mesh = debug_mesh  # type: ignore[assignment]
    train_mod.make_production_mesh = debug_mesh  # type: ignore[assignment]
    reqs = [serve_mod.Request(rid=i, prompt=np.asarray(p), max_new=max_new)
            for i, p in enumerate(prompts)]
    done, stats = serve_mod.serve(arch=arch, requests=reqs, batch_slots=len(prompts),
                                  use_mesh="single", device="cpu", seed=0)
    losses = train_mod.run_training(arch=arch, steps=2, global_batch=4, seq_len=32,
                                    use_mesh="single", device="cpu", log_every=1)
    return dict(out=[r.out for r in done], stats=stats, losses=losses)


def ef_rank(mesh: Any, arch: str, named: Dict[str, torch.Tensor],
            batch: Dict[str, torch.Tensor], lr: float, grads_seq: List[Dict[str, torch.Tensor]],
            e0: Dict[str, torch.Tensor]) -> Dict[str, Any]:
    """EF-int8 under the mesh. (a) The compressor alone on this rank's slices
    of the full gradients ``grads_seq`` (one call each, the error carried)
    from the full error buffers ``e0``: the gathered dequantized gradients
    and errors, and the first call's dequantized gradients with each rank's
    own scale (no MAX over the ranks). (b) One ``make_train_step`` with
    ``compress_grads`` from ``e0``: the global loss, the gathered error
    buffers and parameters after."""
    from repro_torch.models.registry import Model
    from repro_torch.optim import adamw, ef_int8_compressor
    from repro_torch.optim.grad_compress import EFState
    from repro_torch.parallel.sharding import gather_params, gather_tensor, shard_params
    from repro_torch.parallel.sharding import shard_tensor
    from repro_torch.train.step import init_train_state, make_train_step

    cfg = _cfg(arch)
    pctx = _ctx(mesh)
    model, opt = Model(cfg), adamw(lr)
    local = shard_params(_full_params(cfg, named), cfg, pctx)
    specs = local.shard_specs

    def cut(tree: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
        return {k: shard_tensor(v, specs[k], pctx).clone() for k, v in tree.items()}

    def whole(tree: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
        return {k: gather_tensor(v, specs[k], pctx) for k, v in tree.items()}

    _, apply = ef_int8_compressor(pctx=pctx, specs=specs)
    state = EFState(error=cut(e0))
    calls = []
    for g in grads_seq:
        deq, state = apply(cut(g), state)
        calls.append((whole(deq), whole(state.error)))
    own, _ = ef_int8_compressor()[1](cut(grads_seq[0]), EFState(error=cut(e0)))

    st = init_train_state(model, cfg, opt, 0, params=local, compress_grads=True)
    assert all(st.ef_state.error[k].shape == p.shape for k, p in local.named_parameters())
    st = st._replace(ef_state=EFState(error=cut(e0)))
    st, out = make_train_step(model, cfg, pctx, opt, compress_grads=True)(st, batch)
    after = {k: p.detach() for k, p in gather_params(st.params, cfg, pctx).named_parameters()}
    return dict(calls=calls, own=whole(own), loss=float(out["loss"]),
                error=whole(st.ef_state.error), after=after)


def ckpt_rank(mesh: Any, arch: str, named: Dict[str, torch.Tensor],
              batch: Dict[str, torch.Tensor], lr: float, root: str) -> Dict[str, Any]:
    """Checkpoints on the mesh, every case in one spawn: (a) a state after
    one AdamW step with EF-int8, saved by ``CheckpointManager(pctx=...)``;
    (b) ``root/plain`` (written unsharded by the parent) restored on this
    mesh; (c) (a)'s checkpoint restored on a (4, 1) mesh; (d) Adafactor's
    state after one step saved and restored on this mesh; (e) a save whose
    write fails on the writing rank (``root/blocked`` is a file). Each
    restored state comes back gathered (``logical_leaves``); (e) the
    exception each rank raised at ``wait``."""
    from repro_torch.ckpt.checkpoint import logical_leaves
    from repro_torch.ckpt.manager import CheckpointManager
    from repro_torch.launch.mesh import make_debug_mesh
    from repro_torch.models.registry import Model
    from repro_torch.optim import adafactor, adamw
    from repro_torch.parallel.sharding import shard_params
    from repro_torch.train.step import init_train_state, make_train_step

    cfg = _cfg(arch)
    pctx = _ctx(mesh)
    model, opt = Model(cfg), adamw(lr)
    out: Dict[str, Any] = {}

    def fresh(p: Any, optimizer: Any = opt) -> Any:
        local = shard_params(_full_params(cfg, named), cfg, p)
        return init_train_state(model, cfg, optimizer, 0, params=local, compress_grads=True)

    st = fresh(pctx)
    st, _ = make_train_step(model, cfg, pctx, opt, compress_grads=True)(st, batch)
    mgr = CheckpointManager(Path(root) / "mesh", pctx=pctx)
    assert mgr.maybe_save(st.step, st, force=True)
    mgr.wait()
    out["saved"] = logical_leaves(st, pctx)
    out["writer"] = mgr.writer

    restored, out["plain_step"] = CheckpointManager(Path(root) / "plain", pctx=pctx).restore(
        fresh(pctx))
    out["from_plain"] = logical_leaves(restored, pctx)

    p41 = _ctx(make_debug_mesh(4, 1, device_type="cpu"))
    mgr41 = CheckpointManager(Path(root) / "mesh", pctx=p41)
    restored, out["mesh_step"] = mgr41.restore(fresh(p41))
    out["on_4x1"] = logical_leaves(restored, p41)
    out["latest_4x1"] = mgr41.latest_step()

    local = shard_params(_full_params(cfg, named), cfg, pctx)
    af = adafactor(lr, pctx=pctx, specs=local.shard_specs)
    st = init_train_state(model, cfg, af, 0, params=local)
    st, _ = make_train_step(model, cfg, pctx, af)(st, batch)
    mgr_af = CheckpointManager(Path(root) / "adafactor", pctx=pctx, async_save=False)
    mgr_af.maybe_save(st.step, st, force=True)
    out["af_saved"] = logical_leaves(st, pctx)
    local = shard_params(_full_params(cfg, named), cfg, pctx)
    restored, _ = mgr_af.restore(init_train_state(model, cfg, af, 0, params=local))
    out["af_local_equal"] = all(
        torch.equal(a, b) for a, b in zip(_tensor_leaves(restored), _tensor_leaves(st)))

    blocked = CheckpointManager(Path(root) / "blocked", pctx=pctx)
    blocked.maybe_save(1, st, force=True)
    try:
        blocked.wait()
        out["write_error"] = None
    except Exception as e:  # every rank must raise here
        out["write_error"] = type(e).__name__
    dist.barrier()  # and then still meet the others
    return out


def _tensor_leaves(tree: Any) -> List[torch.Tensor]:
    from repro_torch.ckpt.checkpoint import flatten_with_names

    return [v for v in flatten_with_names(tree).values() if isinstance(v, torch.Tensor)]


def resume_rank(mesh: Any, arch: str, root: str, steps: int, preempt_at: int,
                preempt_rank: int) -> Dict[str, Any]:
    """``run_training(use_mesh="single")`` on this mesh: ``steps`` steps
    unbroken; then with checkpoints under ``root``, SIGTERM sent to rank
    ``preempt_rank`` alone when its data reaches step ``preempt_at``, and
    resumed by a second call. The three runs' losses."""
    import os
    import signal

    import repro_torch.launch.train as train_mod

    train_mod.make_production_mesh = lambda **_: mesh  # type: ignore[assignment]
    base = train_mod.SyntheticLMDataset
    rank = dist.get_rank()

    @dataclasses.dataclass(frozen=True)
    class Preempting(base):  # type: ignore[misc, valid-type]
        def batch_at(self, s: int) -> Any:
            if s == preempt_at and rank == preempt_rank:
                os.kill(os.getpid(), signal.SIGTERM)
            return base.batch_at(self, s)

    kw = dict(arch=arch, steps=steps, global_batch=4, seq_len=32, use_mesh="single",
              device="cpu", log_every=steps, save_every=10**6)
    torch.use_deterministic_algorithms(True)
    unbroken = train_mod.run_training(**kw)
    train_mod.SyntheticLMDataset = Preempting  # type: ignore[misc]
    first = train_mod.run_training(**kw, ckpt_dir=root)
    train_mod.SyntheticLMDataset = base  # type: ignore[misc]
    second = train_mod.run_training(**kw, ckpt_dir=root)
    return dict(unbroken=unbroken, first=first, second=second,
                saved=sorted(p.name for p in Path(root).iterdir()))
