"""Three-term roofline of one step on the H100, the counterpart of
``repro.roofline.analysis``.

    compute    = FLOPs_per_device / peak bf16 FLOP/s
    memory     = bytes_per_device / HBM bandwidth
    collective = Σ over collectives of payload / rate of the slowest link
                 its group crosses

The reference reads these counts off a compiled XLA module
(``analyze_compiled``); the port has no compiled module, so the counts come
from what the step dispatches, tallied by
:mod:`repro_torch.roofline.counting` while the step runs (on real tensors, or
on fake ones, as one rank of a world that does not exist), and
:func:`analyze_step` turns them into the three terms. MODEL_FLOPS uses the
6·N·D convention (N = params, active params for MoE; D = tokens per step)
to expose recomputation and masking waste.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Any, Dict, Iterable, Optional

# One NVIDIA H100 SXM5 (per GPU).
HW_H100 = {
    # bf16 dense tensor-core peak, without sparsity (H100 SXM5 data sheet).
    "peak_flops": 989.4e12,
    # HBM3 bandwidth (H100 SXM5 data sheet).
    "hbm_bw": 3.35e12,
    # HBM capacity of the 80 GB part (H100 SXM5 data sheet).
    "hbm_bytes": 80e9,
    # NVLink 4: 900 GB/s total a GPU, 450 GB/s each way (data sheet).
    "nvlink_bw": 450e9,
    # Between nodes: one 400 Gb/s NDR InfiniBand port a GPU, as in DGX H100
    # (eight ConnectX-7 ports for eight GPUs), 50 GB/s each way.
    "network_bw": 50e9,
    # GPUs a node, joined all to all by NVLink (DGX H100).
    "gpus_per_node": 8,
}


@dataclass
class RooflineTerms:
    flops_per_device: float
    bytes_per_device: float
    collective_bytes_per_device: float
    collective_by_op: Dict[str, int] = field(default_factory=dict)
    collective_counts: Dict[str, int] = field(default_factory=dict)
    t_compute_s: float = 0.0
    t_memory_s: float = 0.0
    t_collective_s: float = 0.0
    dominant: str = ""
    model_flops_per_device: float = 0.0
    useful_ratio: float = 0.0
    memory_analysis: Optional[str] = None
    argument_bytes: Optional[int] = None
    output_bytes: Optional[int] = None
    temp_bytes: Optional[int] = None
    collective_by_link: Dict[str, int] = field(default_factory=dict)
    collective_by_group_size: Dict[int, int] = field(default_factory=dict)

    def to_dict(self) -> dict:
        return {
            "flops_per_device": self.flops_per_device,
            "bytes_per_device": self.bytes_per_device,
            "collective_bytes_per_device": self.collective_bytes_per_device,
            "collective_by_op": self.collective_by_op,
            "collective_counts": self.collective_counts,
            "t_compute_s": self.t_compute_s,
            "t_memory_s": self.t_memory_s,
            "t_collective_s": self.t_collective_s,
            "dominant": self.dominant,
            "model_flops_per_device": self.model_flops_per_device,
            "useful_ratio": self.useful_ratio,
            "argument_bytes": self.argument_bytes,
            "output_bytes": self.output_bytes,
            "temp_bytes": self.temp_bytes,
            "collective_by_link": self.collective_by_link,
            "collective_by_group_size": self.collective_by_group_size,
        }


def link_of(ranks: Iterable[int], hw: Dict[str, float] = HW_H100) -> str:
    """The slowest link a group of global ranks crosses: ``"nvlink"`` when
    every rank sits in one node, else ``"network"``. Ranks sit
    ``hw["gpus_per_node"]`` to a node in rank order."""
    per_node = int(hw["gpus_per_node"])
    return "nvlink" if len({int(r) // per_node for r in ranks}) <= 1 else "network"


def link_rate(link: str, hw: Dict[str, float] = HW_H100) -> float:
    return hw["nvlink_bw"] if link == "nvlink" else hw["network_bw"]


def analyze_step(
    counts: Any,
    *,
    model_flops_total: float,
    n_devices: int,
    hw: Dict[str, float] = HW_H100,
) -> RooflineTerms:
    """The roofline of one rank's step from its counts
    (:class:`repro_torch.roofline.counting.StepCounts`).

    The collective term charges each collective to the slowest link its
    group crosses (:func:`link_of`): ranks sit 8 to a node in rank order, so
    on the (16, 16) mesh a 16-rank ``model`` group (16 consecutive ranks)
    spans two nodes and a ``data`` group (ranks 16 apart) sixteen, and both
    go at the network's 50 GB/s; only a group within 8 consecutive ranks
    goes at NVLink's 450 GB/s."""
    flops = float(counts.flops)
    nbytes = float(counts.bytes)
    tally = counts.collectives
    cbytes, by_op, n_by_op = tally.collective_bytes()
    by_link = tally.bytes_by_link(hw)
    t_c = flops / hw["peak_flops"]
    t_m = nbytes / hw["hbm_bw"]
    t_x = sum(b / link_rate(link, hw) for link, b in by_link.items())
    dominant = max(
        [("compute", t_c), ("memory", t_m), ("collective", t_x)],
        key=lambda kv: kv[1],
    )[0]
    model_dev = model_flops_total / n_devices
    return RooflineTerms(
        flops_per_device=flops,
        bytes_per_device=nbytes,
        collective_bytes_per_device=cbytes,
        collective_by_op=by_op,
        collective_counts=n_by_op,
        t_compute_s=t_c,
        t_memory_s=t_m,
        t_collective_s=t_x,
        dominant=dominant,
        model_flops_per_device=model_dev,
        useful_ratio=(model_dev / flops) if flops else 0.0,
        memory_analysis=(f"arguments {counts.argument_bytes} B, peak {counts.peak_bytes} B, "
                         f"outputs {counts.output_bytes} B"),
        argument_bytes=counts.argument_bytes,
        output_bytes=counts.output_bytes,
        temp_bytes=counts.peak_bytes - counts.argument_bytes,
        collective_by_link=by_link,
        collective_by_group_size=tally.bytes_by_group_size(),
    )


def analytic_hbm_bytes(cfg, shape, *, n_dev: int = 256, tp: int = 16,
                       remat: bool = True) -> float:
    """Principled per-device HBM traffic estimate (the reference's model,
    copied as arithmetic):

      weights : every device streams its TP shard of the (active) weights
                once per fwd, once per bwd, +1 fwd under full remat
      acts    : tokens_dev × d_model × bf16 × layers × c  (c≈8 reads+writes
                across norm/attn/mlp per layer, ×1.5 with remat writes)
      opt     : AdamW m/v fp32 read+write + fp32 grads + param update on the
                FSDP shard (θ/n_dev); decode/prefill skip this
      caches  : decode reads the full KV/state cache shard once per token
    """
    act_bytes = 2  # bf16
    n_active = cfg.active_param_count()
    w_dev = n_active * act_bytes / tp
    if shape.kind == "train":
        tokens_dev = shape.global_batch * shape.seq_len / (n_dev / tp)
        passes = 3.0 if remat else 2.0
        weights = passes * w_dev
        acts = tokens_dev * cfg.d_model * act_bytes * cfg.num_layers * (12 if remat else 8)
        opt = cfg.param_count() / n_dev * (4 + 4 + 4 + 4 + 2) * 2
        return weights + acts + opt
    if shape.kind == "prefill":
        tokens_dev = shape.global_batch * shape.seq_len / (n_dev / tp)
        return w_dev + tokens_dev * cfg.d_model * act_bytes * cfg.num_layers * 8
    # decode: weights + cache traffic dominate
    kvh, hd = cfg.num_kv_heads, cfg.resolved_head_dim
    cache_bytes = 0.0
    if cfg.family in ("dense", "moe", "vlm", "encdec", "hybrid"):
        n_attn = (
            cfg.num_layers if cfg.family != "hybrid"
            else cfg.num_layers // max(cfg.shared_attn_every, 1)
        )
        if cfg.family == "encdec":
            n_attn = cfg.dec_layers
        cache_bytes = (
            shape.global_batch * shape.seq_len * kvh * hd * 2 * act_bytes * n_attn
        )
    if cfg.family in ("ssm", "hybrid"):
        di, ns = cfg.ssm_d_inner, cfg.ssm_state
        nh = cfg.ssm_heads
        cache_bytes += (
            shape.global_batch * nh * cfg.ssm_head_dim * ns * 4 * cfg.num_layers
        )
    return w_dev + cache_bytes / n_dev


def model_flops_for(cfg, shape, *, backward: bool) -> float:
    """6·N·D convention (N active params; D tokens this step, global)."""
    n = cfg.active_param_count()
    if shape.kind == "train":
        tokens = shape.global_batch * shape.seq_len
        return 6.0 * n * tokens  # 2 fwd + 4 bwd
    if shape.kind == "prefill":
        tokens = shape.global_batch * shape.seq_len
        return 2.0 * n * tokens
    # decode: one token per sequence
    return 2.0 * n * shape.global_batch
