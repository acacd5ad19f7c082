"""Carry the JAX reference's LM parameters and caches across to the port.

The reference stacks every per-layer leaf so its layers can be scanned:
``[n_groups, g, ...]`` for the ``ssm``, ``dense`` and ``vlm`` families (g = 2
for gemma2's local/global pairs, else 1), and for the hybrid
``[n_super, e, ...]`` trunk layers, ``[tail, ...]`` tail layers and an
unstacked shared block. The port keeps one module per layer. The functions
here take the reference's trees as nested dicts of numpy arrays
(``jax.tree.map(np.asarray, tree)``; a ``KVCache`` or ``SSMState`` of arrays
is read by field name too) and hand back the port's objects, so tests can
run both models on the same weights and compare their caches.
"""

from __future__ import annotations

from typing import Any, Dict, List, Mapping, NamedTuple, Sequence, Tuple, Type

import numpy as np
import torch
from torch import nn

from repro_torch.configs.base import ArchConfig
from repro_torch.device import DeviceLike, resolve_device
from repro_torch.models import hybrid as H
from repro_torch.models.layers.attention import Attention, KVCache
from repro_torch.models.layers.embedding import Embedding
from repro_torch.models.layers.mlp import MLP
from repro_torch.models.layers.norms import RMSNorm
from repro_torch.models.layers.ssm import SSM, SSM_PARAMS, SSMState
from repro_torch.models.transformer import (
    LM,
    PORTED_FAMILIES,
    Block,
    Caches,
    _group_size,
    not_ported,
)


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


def _check_family(cfg: ArchConfig, what: str) -> None:
    if cfg.family not in PORTED_FAMILIES:
        raise not_ported(f"{what} for family {cfg.family!r}")


def _stacks(cfg: ArchConfig) -> Dict[str, Tuple[int, ...]]:
    """The leading shape of each stacked group of layers, by tree key."""
    if cfg.family == "hybrid":
        n_super, e, tail = H._split(cfg)
        return {"ssm": (n_super, e), "kv": (n_super,), "tail_ssm": (tail,)}
    g = _group_size(cfg)
    lead = (cfg.num_layers // g, g)
    return {"ssm": lead, "kv": lead}


def _unstack(leaf: Any, lead: Tuple[int, ...]) -> List[np.ndarray]:
    """A stacked leaf ``[*lead, ...]`` → its per-layer arrays, in order."""
    a = np.asarray(leaf)
    if a.shape[:len(lead)] != lead:
        raise ValueError(f"expected a {list(lead)} + [...] stacked leaf, got {a.shape}")
    return list(a.reshape((-1,) + a.shape[len(lead):]))


class _Reader:
    """Builds the port's modules from one subtree of reference arrays."""

    def __init__(self, dev: torch.device) -> None:
        self.dev = dev

    def t(self, a: Any) -> torch.Tensor:
        return _to_torch(a, self.dev)

    def norm(self, tree: Any) -> RMSNorm:
        scale = np.asarray(tree["scale"])
        n = RMSNorm(scale.shape[-1], device=self.dev)
        n.scale.copy_(self.t(scale))
        return n

    def maybe_norm(self, tree: Mapping[str, Any], key: str) -> Any:
        return self.norm(tree[key]) if key in tree else None

    def ssm(self, tree: Mapping[str, Any]) -> SSM:
        return SSM(self.norm(tree["out_norm"]), **{n: self.t(tree[n]) for n in SSM_PARAMS})

    def attn(self, tree: Mapping[str, Any]) -> Attention:
        return Attention(*(self.t(tree[n]) for n in ("wq", "wk", "wv", "wo")),
                         self.maybe_norm(tree, "q_norm"), self.maybe_norm(tree, "k_norm"))

    def mlp(self, tree: Mapping[str, Any]) -> MLP:
        return MLP(self.t(tree["w1"]), self.t(tree["w2"]),
                   self.t(tree["w3"]) if "w3" in tree else None)

    def emb(self, tree: Mapping[str, Any]) -> Embedding:
        return Embedding(self.t(tree["embed"]),
                         self.t(tree["unembed"]) if "unembed" in tree else None)


def _layers(tree: Any, lead: Tuple[int, ...]) -> List[Any]:
    """A stacked subtree (nested dicts whose leaves are ``[*lead, ...]``) →
    one subtree per layer."""
    if isinstance(tree, Mapping):
        per_key = {k: _layers(v, lead) for k, v in tree.items()}
        n = len(next(iter(per_key.values())))
        return [{k: v[i] for k, v in per_key.items()} for i in range(n)]
    return _unstack(tree, lead)


def params_from_reference(tree: Mapping[str, Any], cfg: ArchConfig, *,
                          device: DeviceLike = "cuda") -> nn.Module:
    """The reference's ``Model(cfg).init(key)`` tree → the port's model
    (same values, same dtypes): an :class:`LM`, or a
    :class:`~repro_torch.models.hybrid.HybridLM` for the hybrid family."""
    _check_family(cfg, "params_from_reference")
    r = _Reader(resolve_device(device))
    if cfg.family == "hybrid":
        n_super, e, tail = H._split(cfg)

        def ssm_layer(lt: Mapping[str, Any]) -> H.SSMLayer:
            return H.SSMLayer(r.norm(lt["ln"]), r.ssm(lt["ssm"]))

        sh = tree["shared"]
        shared = H.SharedBlock(r.norm(sh["ln_in"]), r.t(sh["w_in"]), r.attn(sh["attn"]),
                               r.norm(sh["ln_mlp"]), r.mlp(sh["mlp"]))
        tail_layers = ([ssm_layer(lt) for lt in _layers(tree["tail_layers"], (tail,))]
                       if tail else [])
        return H.HybridLM(r.emb(tree["emb"]),
                          [ssm_layer(lt) for lt in _layers(tree["ssm_layers"], (n_super, e))],
                          shared, tail_layers, r.norm(tree["final_ln"]))

    layers: List[Block] = []
    for lt in _layers(tree["layers"], _stacks(cfg)["kv"]):
        if cfg.family == "ssm":
            layers.append(Block(r.norm(lt["ln1"]), r.ssm(lt["ssm"])))
            continue
        layers.append(Block(r.norm(lt["ln1"]), attn=r.attn(lt["attn"]), ln2=r.norm(lt["ln2"]),
                            mlp=r.mlp(lt["mlp"]), post_ln1=r.maybe_norm(lt, "post_ln1"),
                            post_ln2=r.maybe_norm(lt, "post_ln2")))
    connector = r.t(tree["connector"]) if "connector" in tree else None
    return LM(r.emb(tree["emb"]), layers, r.norm(tree["final_ln"]), connector)


def _kinds(cfg: ArchConfig) -> Dict[str, Type[NamedTuple]]:
    """The cache kinds of a family, by tree key."""
    if cfg.family == "hybrid":
        kinds: Dict[str, Type[NamedTuple]] = {"kv": KVCache, "ssm": SSMState}
        if H._split(cfg)[2]:
            kinds["tail_ssm"] = SSMState
        return kinds
    return {"ssm": SSMState} if cfg.family == "ssm" else {"kv": KVCache}


def caches_from_reference(tree: Mapping[str, Any], cfg: ArchConfig, *,
                          device: DeviceLike = "cuda") -> Caches:
    """The reference's caches (``KVCache`` / ``SSMState`` with stacked
    leaves) → the port's lists, one entry per layer (or per super-block for
    the hybrid's ``kv``)."""
    _check_family(cfg, "caches_from_reference")
    dev = resolve_device(device)
    stacks = _stacks(cfg)
    out: Caches = {}
    for key, kind in _kinds(cfg).items():
        fields = [_unstack(_field(tree[key], f), stacks[key]) for f in kind._fields]
        out[key] = [kind(*(_to_torch(a[i], dev) for a in fields))
                    for i in range(len(fields[0]))]
    return out


def caches_to_reference(caches: Caches, cfg: ArchConfig) -> Dict[str, Dict[str, np.ndarray]]:
    """The port's caches → the reference's layout, as numpy arrays:
    ``{key: {field: [*stack, B, ...]}}`` (bf16 as fp32)."""
    _check_family(cfg, "caches_to_reference")
    stacks = _stacks(cfg)
    out: Dict[str, Dict[str, np.ndarray]] = {}
    for key, kind in _kinds(cfg).items():
        entries: Sequence[Any] = caches[key]
        lead = stacks[key]
        if len(entries) != int(np.prod(lead)):
            raise ValueError(f"{len(entries)} {key} entries for a stack of {list(lead)}")
        out[key] = {f: _stack([getattr(c, f) for c in entries], lead) for f in kind._fields}
    return out


def _stack(tensors: Sequence[torch.Tensor], lead: Tuple[int, ...]) -> np.ndarray:
    a = np.stack([_to_numpy(t) for t in tensors])
    return a.reshape(lead + a.shape[1:])


