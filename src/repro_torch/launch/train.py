"""Training launcher, the counterpart of ``repro.launch.train``: config →
model → optimizer → state (restored from the newest checkpoint if there is
one) → data pipeline → train loop with periodic and final checkpoints,
preemption handling and a straggler watchdog.

    python -m repro_torch.launch.train --arch qwen3-4b --steps 200 \\
        --batch 8 --seq 128 --ckpt-dir /tmp/ckpt          # smoke size, on the card
    python -m repro_torch.launch.train --arch mamba2-1.3b --full --batch 4 --seq 1024 \\
        --steps 20                                         # the real model, bf16
    python -m repro_torch.launch.train --arch mamba2-1.3b --device cpu

It trains every family on one device, the CUDA device unless ``--device
cpu`` is given. The smoke config trains in fp32, the full one in its
config's dtype, as in the reference.

``use_mesh="single"`` (or ``"multi"``) trains on the reference's production
mesh (``launch.mesh.make_production_mesh``, ``make_ctx(remat="full")``):
every rank of the initialised process group calls ``run_training`` alike,
holds its shard of the weights (cut from each leaf as it is drawn, so the
full tree is never held) and of the optimizer state, and takes the global
batch's rows it owns. Its checkpoints hold the logical (unsharded) state,
written by the mesh's first rank (``CheckpointManager(pctx=...)``), so a
run resumes on any mesh or on none, and an unsharded checkpoint resumes on
a mesh. A SIGTERM on any rank stops every rank at the same step boundary:
the ranks agree on the flag (a MAX all-reduce) before each step.
"""

from __future__ import annotations

import argparse
import dataclasses
import time
from typing import List, Optional

import numpy as np

from repro_torch.ckpt.manager import CheckpointManager
from repro_torch.configs.base import get_config
from repro_torch.data.pipeline import PrefetchPipeline
from repro_torch.data.synthetic import SyntheticLMDataset
from repro_torch.device import DeviceLike, resolve_device
from repro_torch.ft.preemption import PreemptionHandler
from repro_torch.ft.watchdog import StepWatchdog
from repro_torch.launch.mesh import make_ctx, make_production_mesh
from repro_torch.models.registry import build_model
from repro_torch.optim import adamw, cosine_warmup
from repro_torch.parallel import collectives as C
from repro_torch.parallel.ctx import ParallelCtx
from repro_torch.parallel.sharding import init_local
from repro_torch.train.step import init_train_state, make_train_step


def run_training(
    *,
    arch: str,
    steps: int,
    smoke: bool = True,
    global_batch: int = 8,
    seq_len: int = 128,
    ckpt_dir: Optional[str] = None,
    save_every: int = 50,
    microbatches: int = 1,
    compress_grads: bool = False,
    use_mesh: Optional[str] = None,
    log_every: int = 10,
    peak_lr: float = 3e-3,
    device: DeviceLike = "cuda",
) -> List[float]:
    """Train ``arch`` for ``steps`` steps (from the newest checkpoint under
    ``ckpt_dir`` where there is one) on random weights from seed 0 and the
    synthetic data; returns the losses of the steps taken."""
    dev = resolve_device(device)
    cfg = get_config(arch)
    if smoke:
        cfg = cfg.smoke()
    cfg = dataclasses.replace(cfg, dtype="float32" if smoke else cfg.dtype)
    if use_mesh:
        pctx = make_ctx(make_production_mesh(multi_pod=use_mesh == "multi",
                                             device_type=dev.type), remat="full")
    else:
        pctx = ParallelCtx(mesh=None, remat="none")

    model = build_model(cfg)
    optimizer = adamw(cosine_warmup(peak_lr, steps // 20 + 1, steps))
    train_step = make_train_step(
        model, cfg, pctx, optimizer,
        microbatches=microbatches, compress_grads=compress_grads,
    )
    params = None
    if pctx.mesh is not None:  # this rank's slices, cut as each leaf is drawn
        params = init_local(model, 0, cfg, pctx, device=dev, max_dec_len=seq_len)
    state = init_train_state(
        model, cfg, optimizer, 0, device=dev,
        max_dec_len=seq_len, compress_grads=compress_grads, params=params,
    )

    mgr = CheckpointManager(ckpt_dir, save_every=save_every, pctx=pctx) if ckpt_dir else None
    start_step = 0
    if mgr and mgr.latest_step() is not None:
        state, start_step = mgr.restore(state)
        print(f"[resume] restored step {start_step}", flush=True)

    data = SyntheticLMDataset(
        vocab_size=cfg.vocab_size, seq_len=seq_len, global_batch=global_batch
    )
    pipe = PrefetchPipeline(data.batch_at, start_step=start_step, depth=2, device=dev)
    preempt = PreemptionHandler()
    watchdog = StepWatchdog(hang_timeout_s=600.0)
    # every rank of the mesh (one process without one)
    group = pctx.group(tuple(pctx.mesh.mesh_dim_names)) if pctx.mesh is not None else None

    losses: List[float] = []
    try:
        for step, batch in pipe:
            if step >= steps or C.any_rank(preempt.requested, group):
                break
            t0 = time.perf_counter()
            state, metrics = train_step(state, batch)
            loss = float(metrics["loss"])
            dt = time.perf_counter() - t0
            watchdog.beat(step, dt)
            losses.append(loss)
            if step % log_every == 0:
                print(
                    f"step {step:5d} loss {loss:.4f} "
                    f"gnorm {float(metrics['grad_norm']):.3f} {dt*1e3:.0f} ms",
                    flush=True,
                )
            if mgr:
                mgr.maybe_save(step + 1, state)
        if mgr:
            mgr.maybe_save(int(state.step), state, force=True)
            mgr.wait()
    finally:
        pipe.close()
        watchdog.close()
        preempt.restore()
    return losses


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--steps", type=int, default=200)
    ap.add_argument("--smoke", action="store_true", default=True)
    ap.add_argument("--full", dest="smoke", action="store_false")
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--ckpt-dir", default=None)
    ap.add_argument("--save-every", type=int, default=50)
    ap.add_argument("--microbatches", type=int, default=1)
    ap.add_argument("--compress-grads", action="store_true")
    ap.add_argument("--mesh", default=None, choices=[None, "single", "multi"])
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args()
    losses = run_training(
        arch=args.arch, steps=args.steps, smoke=args.smoke,
        global_batch=args.batch, seq_len=args.seq,
        ckpt_dir=args.ckpt_dir, save_every=args.save_every,
        microbatches=args.microbatches, compress_grads=args.compress_grads,
        use_mesh=args.mesh, device=args.device,
    )
    if losses:
        k = max(len(losses) // 10, 1)
        print(f"first-{k} mean loss {np.mean(losses[:k]):.4f} -> "
              f"last-{k} mean loss {np.mean(losses[-k:]):.4f}")


if __name__ == "__main__":
    main()
