"""The assigned input-shape sets and their stand-ins per cell, the
counterpart of ``repro.configs.shapes`` on torch.

``input_specs`` describes a step function's data arguments with tensors on
the ``meta`` device (shape and dtype, no memory); decode caches come from
the port's ``make_caches`` on the ``meta`` device. ``synthesize_batch``
draws a concrete batch with the reference's ``np.random.default_rng(seed)``
calls in the reference's order, so its batch equals the reference's element
for element.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Dict, Tuple

import numpy as np
import torch

from repro_torch.configs.base import ArchConfig
from repro_torch.device import DeviceLike, resolve_device


@dataclass(frozen=True)
class ShapeSpec:
    name: str
    seq_len: int
    global_batch: int
    kind: str  # train | prefill | decode


SHAPES: Dict[str, ShapeSpec] = {
    "train_4k": ShapeSpec("train_4k", 4_096, 256, "train"),
    "prefill_32k": ShapeSpec("prefill_32k", 32_768, 32, "prefill"),
    "decode_32k": ShapeSpec("decode_32k", 32_768, 128, "decode"),
    "long_500k": ShapeSpec("long_500k", 524_288, 1, "decode"),
}

# Whisper's encoder length is fixed by the 30 s audio window (frontend stub).
WHISPER_ENC_FRAMES = 1500


def applicable(cfg: ArchConfig, shape: ShapeSpec) -> Tuple[bool, str]:
    """(runnable, reason-if-skipped) per the assignment's skip rules."""
    if shape.name == "long_500k" and not cfg.supports_long_context:
        return False, (
            "long_500k needs sub-quadratic attention; "
            f"{cfg.arch_id} is full-attention (family={cfg.family})"
        )
    return True, ""


def _meta(shape: Tuple[int, ...], dtype: torch.dtype) -> torch.Tensor:
    return torch.empty(shape, dtype=dtype, device="meta")


def input_specs(cfg: ArchConfig, shape: ShapeSpec) -> Dict[str, Any]:
    """Meta-tensor stand-ins for the step function's data arguments."""
    b, s = shape.global_batch, shape.seq_len
    act = getattr(torch, cfg.dtype)
    i32 = torch.int32

    if shape.kind == "train":
        if cfg.family == "encdec":
            return {
                "frames": _meta((b, WHISPER_ENC_FRAMES, cfg.d_model), act),
                "tokens": _meta((b, s), i32),
                "labels": _meta((b, s), i32),
            }
        if cfg.family == "vlm":
            p = cfg.frontend_tokens
            return {
                "patches": _meta((b, p, cfg.d_model), act),
                "tokens": _meta((b, s - p), i32),
                "labels": _meta((b, s - p), i32),
            }
        return {"tokens": _meta((b, s), i32), "labels": _meta((b, s), i32)}

    if shape.kind == "prefill":
        if cfg.family == "encdec":
            return {
                "frames": _meta((b, WHISPER_ENC_FRAMES, cfg.d_model), act),
                "tokens": _meta((b, s), i32),
            }
        if cfg.family == "vlm":
            p = cfg.frontend_tokens
            return {
                "patches": _meta((b, p, cfg.d_model), act),
                "tokens": _meta((b, s - p), i32),
            }
        return {"tokens": _meta((b, s), i32)}

    # decode: one new token against a seq_len-deep cache.
    from repro_torch.models.registry import build_model

    caches = build_model(cfg).make_caches(b, s, device="meta")
    specs: Dict[str, Any] = {
        "token": _meta((b, 1), i32),
        "pos": _meta((b,), i32),
        "caches": caches,
    }
    if cfg.family == "encdec":
        specs["caches"] = dict(specs["caches"])
        specs["caches"]["enc_out"] = _meta((b, WHISPER_ENC_FRAMES, cfg.d_model), act)
    return specs


def _zeros_like_tree(tree: Any, dev: torch.device) -> Any:
    if isinstance(tree, torch.Tensor):
        return torch.zeros(tree.shape, dtype=tree.dtype, device=dev)
    if isinstance(tree, dict):
        return {k: _zeros_like_tree(v, dev) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_zeros_like_tree(v, dev) for v in tree]
    return type(tree)(*(_zeros_like_tree(v, dev) for v in tree))  # a cache NamedTuple


def synthesize_batch(cfg: ArchConfig, shape: ShapeSpec, seed: int = 0, *,
                     device: DeviceLike = "cuda") -> Dict[str, Any]:
    """Concrete random batch matching ``input_specs``, on ``device``."""
    dev = resolve_device(device)
    specs = input_specs(cfg, shape)
    rng = np.random.default_rng(seed)
    out: Dict[str, Any] = {}
    for name, spec in specs.items():
        if name == "caches":
            out[name] = _zeros_like_tree(spec, dev)
        elif name in ("tokens", "token", "labels"):
            a = rng.integers(0, cfg.vocab_size, size=tuple(spec.shape))
            out[name] = torch.from_numpy(a).to(dev, torch.int32)
        elif name == "pos":
            out[name] = torch.full(tuple(spec.shape), shape.seq_len // 2, dtype=torch.int32,
                                   device=dev)
        else:  # frames / patches
            a = rng.standard_normal(tuple(spec.shape)) * 0.02
            out[name] = torch.from_numpy(a).to(dev, spec.dtype)
    return out
