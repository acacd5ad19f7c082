"""Serving launcher, the counterpart of ``repro.launch.serve``: batched
prefill and a greedy decode loop over a simple request queue (static
batching; each batch of ``batch_slots`` requests is left-padded to its
longest prompt, prefilled once and decoded until its longest request is
done).

    python -m repro_torch.launch.serve --arch mamba2-1.3b           # smoke size
    python -m repro_torch.launch.serve --arch zamba2-7b --full      # real model
    python -m repro_torch.launch.serve --arch qwen3-4b --full
    python -m repro_torch.launch.serve --arch moonshot-v1-16b-a3b --full
    python -m repro_torch.launch.serve --arch whisper-medium --full

It serves every family (``ssm``, ``dense``, ``moe``, ``vlm``, ``hybrid``
and ``encdec``), on the CUDA device unless ``--device cpu`` is given. The
encoder-decoder's batches carry 64 zero frames, as in the reference, and
its ``dec_pos`` table holds ``max_len`` positions. For the ``ssm`` and
``hybrid`` families a padded prompt longer than the config's ``ssm_chunk``
must be a multiple of it, as in the reference (``ValueError`` otherwise). KV caches
hold ``max_len`` positions: a batch's padded prompt (with the VLM's
``frontend_tokens``) plus its new tokens should fit, as the cache's write
position is clamped to its last slot, as in the reference.

``use_mesh="single"`` (or ``"multi"``) serves on the reference's production
mesh (``launch.mesh.make_production_mesh``, ``make_ctx(remat="none")``):
every rank of the initialised process group calls ``serve`` alike, holds
its shard of the weights (cut from each leaf as it is drawn, so the full
tree is never held; gathered over the FSDP axes once, as they do not
change while serving) and its rows of the batch and caches, and gets every
request's tokens back.
"""

from __future__ import annotations

import argparse
import time
from dataclasses import dataclass, field
from typing import Any, Dict, List, Optional, Tuple

import numpy as np
import torch
from torch import nn

from repro_torch.configs.base import get_config
from repro_torch.device import DeviceLike, resolve_device
from repro_torch.models.registry import build_model
from repro_torch.launch.mesh import make_ctx, make_production_mesh
from repro_torch.parallel.ctx import ParallelCtx
from repro_torch.parallel.sharding import gather_fsdp, init_local, shard_params
from repro_torch.serve.steps import make_decode_step, make_prefill_step


#: The encoder-decoder's frames a batch, as the reference's launcher gives it.
ENCDEC_FRAMES = 64


@dataclass
class Request:
    rid: int
    prompt: np.ndarray
    max_new: int
    out: List[int] = field(default_factory=list)
    done: bool = False


def serve(
    *,
    arch: str,
    requests: List[Request],
    batch_slots: int = 4,
    max_len: int = 256,
    smoke: bool = True,
    use_mesh: Optional[str] = None,
    greedy: bool = True,
    seed: int = 0,
    device: DeviceLike = "cuda",
    params: Optional[nn.Module] = None,
) -> Tuple[List[Request], Dict[str, Any]]:
    """Serve ``requests``; returns them with ``out`` filled, and ``stats``
    (``prefills``, ``decode_steps``, ``tokens``, ``wall_s``). Weights are
    random from ``seed`` unless ``params`` (already on ``device``) is given.
    The VLM's batches carry zero patches of ``[B, frontend_tokens, d]``, the
    encoder-decoder's zero frames of ``[B, ENCDEC_FRAMES, d]``. Under
    ``use_mesh`` the given ``params`` are the full tree, sharded here."""
    dev = resolve_device(device)
    cfg = get_config(arch)
    if smoke:
        cfg = cfg.smoke()
    model = build_model(cfg)
    if use_mesh:
        mesh = make_production_mesh(multi_pod=use_mesh == "multi", device_type=dev.type)
        pctx = make_ctx(mesh, remat="none")
    else:
        pctx = ParallelCtx(mesh=None)
    if params is None:  # under a mesh, this rank's slices, cut as each leaf is drawn
        params = init_local(model, seed, cfg, pctx, device=dev, max_dec_len=max_len)
    else:
        where = {p.device for p in params.parameters()}
        if where != {dev}:
            raise ValueError(f"params live on {sorted(map(str, where))}, serving on {dev}")
        params = shard_params(params, cfg, pctx)
    if pctx.mesh is not None:
        params = gather_fsdp(params, pctx)
    prefill = make_prefill_step(model, cfg, pctx, max_len=max_len)
    decode = make_decode_step(model, cfg, pctx)

    queue = list(requests)
    stats: Dict[str, Any] = {"prefills": 0, "decode_steps": 0, "tokens": 0}
    t0 = time.perf_counter()
    while queue:
        active = queue[:batch_slots]
        queue = queue[batch_slots:]
        plen = max(len(r.prompt) for r in active)
        toks = np.zeros((len(active), plen), np.int64)
        for i, r in enumerate(active):
            toks[i, plen - len(r.prompt):] = r.prompt  # left-pad
        batch = {"tokens": torch.from_numpy(toks).to(dev)}
        if cfg.family == "vlm":
            batch["patches"] = torch.zeros(len(active), cfg.frontend_tokens, cfg.d_model,
                                           dtype=getattr(torch, cfg.dtype), device=dev)
        if cfg.family == "encdec":
            batch["frames"] = torch.zeros(len(active), ENCDEC_FRAMES, cfg.d_model,
                                          dtype=getattr(torch, cfg.dtype), device=dev)
        logits, caches = prefill(params, batch)
        stats["prefills"] += 1
        next_tok = torch.argmax(logits[:, -1:, :], dim=-1)
        offset = plen + (cfg.frontend_tokens if cfg.family == "vlm" else 0)
        max_new = max(r.max_new for r in active)
        for step in range(max_new):
            host_tok = next_tok[:, 0].tolist()
            for i, r in enumerate(active):
                if len(r.out) < r.max_new:
                    r.out.append(int(host_tok[i]))
                    stats["tokens"] += 1
                else:
                    r.done = True
            if all(len(r.out) >= r.max_new for r in active):
                break
            pos = torch.full((len(active),), offset + step, dtype=torch.int32, device=dev)
            logits, caches = decode(params, caches, next_tok, pos)
            stats["decode_steps"] += 1
            next_tok = torch.argmax(logits[:, -1:], dim=-1)
        for r in active:
            r.done = True
    stats["wall_s"] = time.perf_counter() - t0
    return requests, stats


def main() -> None:
    ap = argparse.ArgumentParser(description="Serve random prompts through the port's LM.")
    ap.add_argument("--arch", default="mamba2-1.3b")
    ap.add_argument("--full", action="store_true",
                    help="the published config at full size (default: its smoke config)")
    ap.add_argument("--requests", type=int, default=8)
    ap.add_argument("--slots", type=int, default=4)
    ap.add_argument("--max-new", type=int, default=16)
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args()
    rng = np.random.default_rng(args.seed)
    cfg = get_config(args.arch)
    if not args.full:
        cfg = cfg.smoke()
    # The reference's 4 ... 23 tokens (every family but the SSM ones); for
    # the SSM families at most one chunk, so any padded batch length is
    # allowed.
    lo, hi = (1, cfg.ssm_chunk + 1) if cfg.family in ("ssm", "hybrid") else (4, 24)
    reqs = [
        Request(rid=i, prompt=rng.integers(0, cfg.vocab_size, size=int(rng.integers(lo, hi))),
                max_new=args.max_new)
        for i in range(args.requests)
    ]
    # KV caches long enough for the longest prompt (behind the VLM's
    # patches) and its new tokens.
    patches = cfg.frontend_tokens if cfg.family == "vlm" else 0
    max_len = max(256, max((len(r.prompt) for r in reqs), default=0) + patches + args.max_new)
    done, stats = serve(arch=args.arch, requests=reqs, batch_slots=args.slots, max_len=max_len,
                        smoke=not args.full, seed=args.seed, device=args.device)
    dev = resolve_device(args.device)
    where = torch.cuda.get_device_name(dev) if dev.type == "cuda" else "cpu"
    print(f"served {len(done)} requests on {where}: {stats}")
    for r in done[:3]:
        print(f"  req {r.rid}: prompt[{len(r.prompt)}] -> {r.out[:10]}...")


if __name__ == "__main__":
    main()
