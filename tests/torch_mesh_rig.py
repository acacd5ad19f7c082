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
                tokens: Any, steps: int, max_len: int) -> Dict[str, Any]:
    """The sharded train step and, with ``tokens``, the sharded decode."""
    out = train_rank(mesh, arch, cfg_changes, named, batch, lr)
    if tokens is not None:
        out["decode"] = decode_rank(mesh, arch, cfg_changes, named, tokens, steps, max_len)
    return out


def decode_rank(mesh: Any, arch: str, cfg_changes: Dict[str, Any],
                named: Dict[str, torch.Tensor], tokens: torch.Tensor, steps: int,
                max_len: int, ctx_changes: Dict[str, Any] = {},
                strategy: str = "tp") -> Dict[str, Any]:
    """A sharded prefill and ``steps`` greedy decode steps: every step's
    global logits and tokens."""
    from repro_torch.models.registry import Model
    from repro_torch.parallel.sharding import shard_params

    cfg = _cfg(arch, **cfg_changes)
    pctx = _ctx(mesh, strategy, **ctx_changes)
    model = Model(cfg)
    local = shard_params(_full_params(cfg, named), cfg, pctx)
    return greedy(model, local, tokens, pctx, steps, max_len)


def greedy(model: Any, params: Any, tokens: torch.Tensor, pctx: Any, steps: int,
           max_len: int) -> Dict[str, Any]:
    """Prefill then ``steps`` greedy decode steps (logits and tokens)."""
    b, s = tokens.shape
    logits, caches = model.prefill(params, {"tokens": tokens}, pctx, max_len=max_len)
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
