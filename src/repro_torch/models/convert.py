"""Carry the JAX reference's LM parameters and caches across to the port.

The reference stacks every per-layer leaf as ``[n_groups, g, ...]`` (g = 1
for the ``ssm`` family) so its layers can be scanned; the port keeps one
module per layer. The functions here take the reference's trees as nested
dicts of numpy arrays (``jax.tree.map(np.asarray, tree)``; an ``SSMState``
of arrays is read by field name too) and hand back the port's objects, so
tests can run both models on the same weights and compare their states.
"""

from __future__ import annotations

from typing import Any, Dict, List, Mapping

import numpy as np
import torch

from repro_torch.configs.base import ArchConfig
from repro_torch.device import DeviceLike, resolve_device
from repro_torch.models.layers.embedding import Embedding
from repro_torch.models.layers.norms import RMSNorm
from repro_torch.models.layers.ssm import SSM, SSM_PARAMS, SSMState
from repro_torch.models.transformer import LM, Block, Caches, not_ported


def _field(tree: Any, name: str) -> Any:
    return tree[name] if isinstance(tree, Mapping) else getattr(tree, name)


def _to_torch(a: Any, dev: torch.device) -> torch.Tensor:
    a = np.asarray(a)
    if a.dtype.name == "bfloat16":  # ml_dtypes' bfloat16: exact through fp32
        return torch.from_numpy(a.astype(np.float32)).to(dev, torch.bfloat16)
    return torch.from_numpy(np.array(a)).to(dev)


def _to_numpy(t: torch.Tensor) -> np.ndarray:
    t = t.detach().cpu()
    return (t.float() if t.dtype == torch.bfloat16 else t).numpy()


def _layer(leaf: Any, i: int, cfg: ArchConfig) -> np.ndarray:
    a = np.asarray(leaf)
    if a.shape[:2] != (cfg.num_layers, 1):
        raise ValueError(
            f"expected a [{cfg.num_layers}, 1, ...] stacked leaf, got {a.shape}"
        )
    return a[i, 0]


def params_from_reference(tree: Mapping[str, Any], cfg: ArchConfig, *,
                          device: DeviceLike = "cuda") -> LM:
    """The reference's ``Model(cfg).init(key)`` tree → the port's :class:`LM`
    (same values, same dtypes)."""
    if cfg.family != "ssm":
        raise not_ported(f"params_from_reference for family {cfg.family!r}")
    dev = resolve_device(device)

    def t(a: Any) -> torch.Tensor:
        return _to_torch(a, dev)

    def norm(scale: Any) -> RMSNorm:
        n = RMSNorm(np.asarray(scale).shape[-1], device=dev)
        n.scale.copy_(t(scale))
        return n

    layers_tree = tree["layers"]
    ssm_tree = layers_tree["ssm"]
    layers: List[Block] = []
    for i in range(cfg.num_layers):
        ssm = SSM(
            norm(_layer(ssm_tree["out_norm"]["scale"], i, cfg)),
            **{name: t(_layer(ssm_tree[name], i, cfg)) for name in SSM_PARAMS},
        )
        layers.append(Block(norm(_layer(layers_tree["ln1"]["scale"], i, cfg)), ssm))
    return LM(Embedding(t(tree["emb"]["embed"])), layers, norm(tree["final_ln"]["scale"]))


def caches_from_reference(tree: Mapping[str, Any], cfg: ArchConfig, *,
                          device: DeviceLike = "cuda") -> Caches:
    """The reference's ``{"ssm": SSMState}`` caches with ``[n_groups, 1, B,
    ...]`` leaves → the port's ``{"ssm": [SSMState, ...]}``."""
    dev = resolve_device(device)
    st = tree["ssm"]
    return {"ssm": [
        SSMState(*(_to_torch(_layer(_field(st, f), i, cfg), dev) for f in SSMState._fields))
        for i in range(cfg.num_layers)
    ]}


def caches_to_reference(caches: Caches, cfg: ArchConfig) -> Dict[str, Dict[str, np.ndarray]]:
    """The port's caches → the reference's layout, as numpy arrays:
    ``{"ssm": {field: [n_groups, 1, B, ...]}}`` (bf16 states as fp32)."""
    states = caches["ssm"]
    if len(states) != cfg.num_layers:
        raise ValueError(f"{len(states)} layer states for {cfg.num_layers} layers")
    return {"ssm": {
        f: np.stack([_to_numpy(getattr(s, f)) for s in states])[:, None]
        for f in SSMState._fields
    }}
