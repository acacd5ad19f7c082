"""Driver of the language-model training cells: the port's ``train_step``
(``repro_torch.train.step.make_train_step``) fed by its ``PrefetchPipeline``.

Configuration keys (``configs/<config>.json``): the model's published keys
(``d_model``, ``n_layer``, ``vocab_size``, ``ssm_cfg``, ``norm_epsilon``,
``tie_embeddings``), ``dtype`` (the parameters' dtype as trained),
``optimizer`` (AdamW's ``lr``, ``b1``, ``b2``, ``eps``, ``weight_decay``),
``reference`` and ``limits``.

Traffic keys (``traffic/<traffic>.json``): ``batch`` sequences of
``seq_len`` tokens a step from the benchmark's copy of the synthetic
generator (``zipf_a``), seeded by ``--seed``, batch ``i`` for step ``i``;
``check_steps``, the first steps the reference follows.

Set-up makes the weights on the card from the seed (the reference's
``make_weights``), builds the port's model from them, and drives the one
train state through the first ``check_steps`` steps with the window's own
call and feed; those steps warm every shape up. It reads each step's loss,
the first gradient's norm per leaf from AdamW's first moment after one step
(``m = (1 - b1)·g``), and the parameters' change per leaf after the last of
them. The window then goes on training the same state. After it, with the
program's state freed, the reference follows the same steps from the same
weights and batches, and each number is compared with its limit.
"""

from __future__ import annotations

import gc
import json
import statistics
import sys
import time
from typing import Any, Dict, List, Tuple

import torch

from cudabench import formulas, harness
from cudabench.synthetic import SyntheticLMDataset
from cudabench.trace import Tracer

#: The CUDA sources the training path launches.
SOURCES = ("ssd_stage1", "ssd_stage1_bwd")
#: A leaf's reference gradient under this share of the median leaf's is
#: nought to rounding: Adam moves it by round-off, so its change is not compared.
STILL_LEAF = 1e-3


def arch_config(config: Dict[str, Any], name: str) -> Any:
    """The port's ``ArchConfig`` of a Mamba-2 configuration file."""
    from repro_torch.configs.base import ArchConfig

    ssm = config["ssm_cfg"]
    if ssm["layer"] != "Mamba2" or ssm["ngroups"] != 1 or config["attn_layer_idx"]:
        raise ValueError(f"{name}: the port's ssm family is Mamba-2 with one B/C group "
                         f"and no attention layers")
    return ArchConfig(
        arch_id=name, family="ssm", num_layers=config["n_layer"], d_model=config["d_model"],
        num_heads=0, num_kv_heads=0, d_ff=0, vocab_size=config["vocab_size"],
        ssm_state=ssm["d_state"], ssm_conv=ssm["d_conv"], ssm_expand=ssm["expand"],
        ssm_head_dim=ssm["headdim"], ssm_chunk=ssm["chunk_size"],
        norm_eps=config["norm_epsilon"], tie_embeddings=config["tie_embeddings"],
        dtype=config["dtype"])


def build_model(w: Dict[str, torch.Tensor], cfg: Any, device: torch.device) -> torch.nn.Module:
    """The port's ``LM`` holding the tensors of ``w`` (not copies)."""
    from repro_torch.models.layers.embedding import Embedding
    from repro_torch.models.layers.norms import RMSNorm
    from repro_torch.models.layers.ssm import SSM, SSM_PARAMS
    from repro_torch.models.transformer import LM, Block

    def norm(name: str) -> RMSNorm:
        n = RMSNorm(w[name].shape[0], device=device)
        n.scale.data = w[name]
        return n

    layers = [Block(norm(f"layers.{i}.ln1.scale"),
                    SSM(norm(f"layers.{i}.ssm.out_norm.scale"),
                        **{k: w[f"layers.{i}.ssm.{k}"] for k in SSM_PARAMS}))
              for i in range(cfg.num_layers)]
    return LM(Embedding(w["emb.embed"]), layers, norm("final_ln.scale"))


def gaps(prog: Dict[str, Any], ref: Dict[str, Any]) -> Dict[str, Any]:
    """Every number the comparison can hold, by name; the configuration's
    ``limits`` name those compared. Losses: each step's gap relative to the
    reference's loss (``loss1_gap`` the first step's, ``loss_gap`` the
    worst step's). Gradients at the first step and changes after the last:
    each leaf's gap of norms relative to the reference's norm of that leaf
    or of the median leaf, whichever is larger; ``*_gap`` the worst leaf's,
    ``*_median_gap`` the median leaf's, ``*_matrix_gap`` the worst leaf of
    two dimensions. Leaves whose reference gradient is under
    ``STILL_LEAF`` of the median leaf's are left out of the change."""
    names = ref["names"]
    steps = [abs(a - b) / abs(b) for a, b in zip(prog["loss"], ref["loss"])]
    out: Dict[str, Any] = {"loss1_gap": steps[0], "loss_gap": max(steps)}
    g_med = statistics.median(ref["grad_norm"])
    moving = [i for i, g in enumerate(ref["grad_norm"]) if g >= STILL_LEAF * g_med]
    for what, keep in (("grad_norm", range(len(names))), ("change_norm", moving)):
        med = statistics.median(ref[what][i] for i in keep)
        gap = {i: abs(prog[what][i] - ref[what][i]) / max(ref[what][i], med) for i in keep}
        worst = max(gap, key=gap.__getitem__)
        out[f"{what}_gap"] = gap[worst]
        out[f"{what}_median_gap"] = statistics.median(gap.values())
        out[f"{what}_matrix_gap"] = max(gap[i] for i in keep if ref["ndim"][i] == 2)
        out[f"{what}_worst_leaf"] = names[worst]
    out["still_leaves"] = len(names) - len(moving)
    return out


def leaf_norms(tensors: Dict[str, torch.Tensor], names: List[str], scale: float = 1.0,
               minus: Dict[str, torch.Tensor] = None) -> List[float]:
    out = []
    for k in names:
        t = tensors[k].detach().float()
        if minus is not None:
            t = t - minus[k].float()
        out.append(float(t.norm()) * scale)
    return out


def run(cell: harness.Cell, seed: int, seconds: float, trace: bool, device: torch.device,
        variant: str, t0: float) -> harness.Record:
    from repro_torch.data.pipeline import PrefetchPipeline
    from repro_torch.kernels import build
    from repro_torch.models.registry import Model
    from repro_torch.optim.adamw import adamw
    from repro_torch.parallel.ctx import ParallelCtx
    from repro_torch.train.step import (apply_gradients, init_train_state, make_grad_fn,
                                        make_train_step)

    config, traffic = cell.config, cell.traffic
    ref = harness.reference(cell)
    cuda = device.type == "cuda"
    if variant not in ("program", "control"):
        raise ValueError(f"variant {variant!r}: the training cells take 'program' or 'control'")
    opt_cfg = config["optimizer"]
    batch, seq = traffic["batch"], traffic["seq_len"]
    data = SyntheticLMDataset(vocab_size=config["vocab_size"], seq_len=seq, global_batch=batch,
                              seed=seed, zipf_a=traffic["zipf_a"])
    checked = [data.batch_at(i) for i in range(traffic["check_steps"])]
    rec = harness.Record(device_kind=torch.cuda.get_device_name(device) if cuda else "cpu")

    if variant == "control":  # the reference in fp8 in the program's place: no window
        prog = ref.train(config, opt_cfg, ref.make_weights(config, seed, device), checked,
                         device, precision="fp8")
        rec.setup_s = time.perf_counter() - t0
    else:
        if cuda:
            build.build(SOURCES)
        cfg = arch_config(config, cell.config_name)
        model = Model(cfg)
        optimizer = adamw(opt_cfg["lr"], b1=opt_cfg["b1"], b2=opt_cfg["b2"],
                          eps=opt_cfg["eps"], weight_decay=opt_cfg["weight_decay"])
        state = init_train_state(model, cfg, optimizer, seed, device=device,
                                 params=build_model(ref.make_weights(config, seed, device),
                                                    cfg, device))
        pctx = ParallelCtx()
        train_step = make_train_step(model, cfg, pctx, optimizer)
        compute_grads = make_grad_fn(model, cfg, pctx)
        pipe = PrefetchPipeline(data.batch_at, device=device)
        names = [k for k, _ in state.params.named_parameters()]
        prog: Dict[str, Any] = {"names": names, "loss": []}
        for step in range(traffic["check_steps"]):
            _, b = next(pipe)
            state, metrics = train_step(state, b)
            prog["loss"].append(float(metrics["loss"]))
            if step == 0:  # m = (1 - b1)·g after the first step
                prog["grad_norm"] = leaf_norms(state.opt_state["m"], names,
                                               1.0 / (1.0 - opt_cfg["b1"]))
        start_w = ref.make_weights(config, seed, device)
        prog["change_norm"] = leaf_norms(dict(state.params.named_parameters()), names,
                                         minus=start_w)
        del start_w, metrics, b

        tracer = Tracer(trace, device)
        tokens = float(batch * seq)
        losses: List[torch.Tensor] = []
        events: List[Tuple[Any, Any]] = []
        if cuda:
            torch.cuda.synchronize(device)
            rec.memory_peak_bytes = torch.cuda.max_memory_allocated(device)
            torch.cuda.reset_peak_memory_stats(device)
        with tracer.window():
            start = time.perf_counter()
            rec.setup_s = start - t0
            while True:
                c0 = time.perf_counter()
                with tracer.span("next_batch"):
                    _, b = next(pipe)
                if trace:  # make_train_step's composition, the optimizer timed
                    with tracer.span("compute_grads"):
                        loss, _, grads = compute_grads(state.params, b)
                    with tracer.span("apply_gradients"):
                        if cuda:
                            ev = (torch.cuda.Event(enable_timing=True),
                                  torch.cuda.Event(enable_timing=True))
                            ev[0].record()
                        state, _ = apply_gradients(state, grads, optimizer, None, pctx)
                        if cuda:
                            ev[1].record()
                            events.append(ev)
                    del grads
                else:
                    with tracer.span("train_step"):
                        state, metrics = train_step(state, b)
                    loss = metrics["loss"]
                if losses:  # the last step's loss, read one step late
                    float(losses[-1])
                losses.append(loss)
                rec.calls.append((c0, time.perf_counter(), tokens))
                if time.perf_counter() - start >= seconds:
                    break
            if cuda:
                torch.cuda.synchronize(device)
            rec.window_s = time.perf_counter() - start
        rec.timeline = tracer.timeline
        steps = len(rec.calls)
        rec.attempted = steps
        rec.failed = sum(not torch.isfinite(v).item() for v in losses)
        rec.counters = {"steps": float(steps),
                        "model_flops": steps * formulas.mamba2_step_flops(config, batch, seq),
                        "ssd_bound_s": steps * formulas.ssd_bound_s(config, batch, seq)}
        if events:
            rec.counters["optimizer_ms"] = statistics.fmean(
                a.elapsed_time(e) for a, e in events)
        if cuda:
            rec.counters["window_peak_bytes"] = float(torch.cuda.max_memory_allocated(device))
            rec.memory_peak_bytes = max(rec.memory_peak_bytes,
                                        torch.cuda.max_memory_allocated(device))
        pipe.close()
        del state, train_step, compute_grads, losses, loss, b, events, pipe
        gc.collect()
        if cuda:
            torch.cuda.empty_cache()

    want = ref.train(config, opt_cfg, ref.make_weights(config, seed, device), checked, device)
    if prog["names"] != want["names"]:
        raise RuntimeError("the program's leaves are not the reference's: "
                           f"{sorted(set(prog['names']) ^ set(want['names']))[:8]}")
    found = gaps(prog, want)
    rec.checks = {k: (found[k], limit) for k, limit in config["limits"].items()}
    rec.details = found
    print(f"cudabench: losses {prog['loss']} against the reference's {want['loss']}; "
          f"{json.dumps(found)}", file=sys.stderr)
    return rec
