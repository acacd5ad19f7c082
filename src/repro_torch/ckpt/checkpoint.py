"""Atomic checkpointing, the counterpart of ``repro.ckpt.checkpoint``.

Format: one ``arrays.npz`` of logical tensors keyed by their path in the
tree ("params/layers.0.ssm.w_x", "opt_state/m/...", "step"), plus a JSON
``manifest.json`` with the step, the keys and each tensor's dtype. numpy
has no bfloat16: a bf16 tensor is stored as its 16-bit pattern
(``uint16``) and the manifest names it ``bfloat16``. Writes go to
``<dir>/.tmp-<name>-<pid>-<ns>`` then an atomic rename, so a preempted job
never sees a torn checkpoint, and :func:`latest_step` skips a directory
without its manifest.

A tree is any nesting of dicts, tuples (``NamedTuple`` states included),
``nn.Module``\\ s (their named parameters), tensors, Python ints and
``None``. :func:`restore_checkpoint` rebuilds the structure of a target
tree: each tensor goes to ``device`` (default: the device of the target's
tensor at that path) in the target's dtype, a module's parameters are
copied into the target module in place, and ints come back as ints.

Under a mesh (``pctx``) the file is the same: every tensor is stored whole
(logical), so a checkpoint written on a mesh is the one an unsharded run
writes, and either restores on any mesh ("a 512-chip job resumes on 256
chips"). The tree's module carries its layout (``shard_params``'
``shard_specs``), and every other leaf takes the spec of the parameter its
path names (:func:`leaf_spec`). :func:`logical_leaves` gathers each leaf
by its spec, a collective every rank joins; :func:`restore_checkpoint`
reads the whole tensors on every rank and keeps each rank's slice.
"""

from __future__ import annotations

import json
import os
import shutil
import time
from pathlib import Path
from typing import Any, Callable, Dict, Mapping, Optional, Tuple

import numpy as np
import torch
from torch import nn

from repro_torch.device import DeviceLike, resolve_device
from repro_torch.parallel import collectives as C
from repro_torch.parallel.ctx import ParallelCtx
from repro_torch.parallel.sharding import Spec, gather_tensor, layout_of, shard_tensor


def flatten_with_names(tree: Any, prefix: str = "") -> Dict[str, Any]:
    """The leaves of ``tree`` (tensors and ints) by their path."""
    def join(k: object) -> str:
        return f"{prefix}/{k}" if prefix else str(k)

    if tree is None:
        return {}
    if isinstance(tree, nn.Module):
        return {join(k): p for k, p in tree.named_parameters()}
    if isinstance(tree, dict):
        out: Dict[str, Any] = {}
        for k, v in tree.items():
            out.update(flatten_with_names(v, join(k)))
        return out
    if isinstance(tree, tuple):
        names = getattr(tree, "_fields", None) or range(len(tree))
        out = {}
        for k, v in zip(names, tree):
            out.update(flatten_with_names(v, join(k)))
        return out
    if isinstance(tree, (torch.Tensor, int, np.integer)):
        return {prefix: tree}
    raise TypeError(f"checkpoint: cannot store a {type(tree).__name__} at {prefix!r}")


def host_copy(leaf: Any) -> Any:
    """A host copy of a leaf that later steps cannot change."""
    if isinstance(leaf, torch.Tensor):
        return leaf.detach().to("cpu", copy=True)
    return int(leaf)


def tree_layout(tree: Any) -> Optional[Dict[str, Spec]]:
    """The specs of the sharded module in ``tree`` (``shard_params``' local
    parameters), or ``None`` where it holds none."""
    if isinstance(tree, nn.Module):
        return layout_of(tree)
    children = tree.values() if isinstance(tree, dict) else tree if isinstance(tree, tuple) else ()
    for child in children:
        found = tree_layout(child)
        if found is not None:
            return found
    return None


def leaf_spec(path: str, specs: Mapping[str, Spec]) -> Optional[Spec]:
    """The spec of the state leaf at ``path``: that of the parameter its path
    names (``params/<name>``, AdamW's ``opt_state/m/<name>``, the EF
    buffers' ``ef_state/error/<name>``, Adafactor's ``opt_state/<name>/v``),
    less the dim a factored statistic reduces (Adafactor's ``vr``, the
    last; ``vc``, the one before); ``None`` for a leaf of no parameter."""
    parts = path.split("/")
    for i, part in enumerate(parts):
        if part in specs:
            spec, rest = tuple(specs[part]), parts[i + 1:]
            if rest == ["vr"]:
                return spec[:-1]
            if rest == ["vc"]:
                return spec[:-2] + spec[-1:]
            return spec
    return None


def logical_leaves(tree: Any, pctx: Optional[ParallelCtx] = None, *,
                   keep: bool = True) -> Dict[str, Any]:
    """Host copies of the leaves of ``tree`` by path, every tensor whole:
    under a mesh each sharded leaf is gathered by its spec first, a
    collective that every rank joins, leaf by leaf in the same order (on
    host copies of the slices where the backend takes host tensors, so the
    whole leaf never goes back to the device). ``keep=False``: join the
    gathers and keep nothing (a rank that does not write)."""
    specs = tree_layout(tree) if pctx is not None and pctx.mesh is not None else None
    on_host = specs is not None and all(
        C.takes_host_tensors(pctx.group(ax)) for ax in pctx.mesh.mesh_dim_names)  # type: ignore[union-attr]
    out: Dict[str, Any] = {}
    for k, v in flatten_with_names(tree).items():
        spec = leaf_spec(k, specs) if specs is not None and isinstance(v, torch.Tensor) else None
        if spec is not None:
            v = gather_tensor(host_copy(v) if on_host else v.detach(), spec, pctx)
        if keep:  # a host gather's result is a new host tensor already
            out[k] = v if spec is not None and on_host else host_copy(v)
    return out


def _to_numpy(leaf: Any) -> Tuple[np.ndarray, str]:
    if isinstance(leaf, torch.Tensor):
        t = leaf.detach().cpu()
        if t.dtype == torch.bfloat16:  # npz has no native bf16: store the bits
            return t.view(torch.int16).numpy().view(np.uint16), "bfloat16"
        return t.numpy(), str(t.dtype).removeprefix("torch.")
    a = np.asarray(leaf, dtype=np.int64)
    return a, "int"


def save_checkpoint(ckpt_dir: str | Path, step: int, tree: Any,
                    *, keep_tmp_on_error: bool = False) -> Path:
    """Write ``<ckpt_dir>/step_<step>`` atomically. Returns the final path."""
    ckpt_dir = Path(ckpt_dir)
    ckpt_dir.mkdir(parents=True, exist_ok=True)
    final = ckpt_dir / f"step_{step:08d}"
    tmp = ckpt_dir / f".tmp-{final.name}-{os.getpid()}-{time.time_ns()}"
    tmp.mkdir(parents=True)
    try:
        arrays, dtypes = {}, {}
        for k, v in flatten_with_names(tree).items():
            arrays[k], dtypes[k] = _to_numpy(v)
        np.savez(tmp / "arrays.npz", **arrays)
        (tmp / "manifest.json").write_text(json.dumps({
            "step": step,
            "keys": sorted(arrays),
            "dtypes": dtypes,
            "time": time.time(),
        }))
        if final.exists():
            shutil.rmtree(final)
        os.replace(tmp, final)  # atomic on POSIX
        return final
    except BaseException:
        if not keep_tmp_on_error and tmp.exists():
            shutil.rmtree(tmp, ignore_errors=True)
        raise


def latest_step(ckpt_dir: str | Path) -> Optional[int]:
    ckpt_dir = Path(ckpt_dir)
    if not ckpt_dir.exists():
        return None
    steps = [
        int(p.name.split("_")[1])
        for p in ckpt_dir.iterdir()
        if p.name.startswith("step_") and (p / "manifest.json").exists()
    ]
    return max(steps) if steps else None


def _from_numpy(a: np.ndarray, dtype: str) -> Any:
    if dtype == "int":
        return int(a)
    if dtype == "bfloat16":
        return torch.from_numpy(a.view(np.int16)).view(torch.bfloat16)
    return torch.from_numpy(a)


def restore_checkpoint(
    ckpt_dir: str | Path,
    target_tree: Any,
    *,
    step: Optional[int] = None,
    device: Optional[DeviceLike] = None,
    pctx: Optional[ParallelCtx] = None,
) -> Tuple[Any, int]:
    """Restore into the structure of ``target_tree``; returns ``(tree,
    step)``. Under a mesh (``pctx``) each tensor is cut to this rank's
    slice by the spec of its leaf in the target (any mesh: the file holds
    whole tensors). Raises ``FileNotFoundError`` without a checkpoint,
    ``KeyError`` when the checkpoint lacks a path of the target and
    ``ValueError`` when a slice's shape is not the target's."""
    ckpt_dir = Path(ckpt_dir)
    if step is None:
        step = latest_step(ckpt_dir)
        if step is None:
            raise FileNotFoundError(f"no checkpoints under {ckpt_dir}")
    path = ckpt_dir / f"step_{step:08d}"
    manifest = json.loads((path / "manifest.json").read_text())
    dtypes = manifest["dtypes"]
    with np.load(path / "arrays.npz") as zf:
        # read leaf by leaf as the target is rebuilt: one whole tensor held
        # at a time beside the target
        missing = set(flatten_with_names(target_tree)) - set(zf.files)
        if missing:
            raise KeyError(f"checkpoint missing keys: {sorted(missing)[:5]} ...")
        return _rebuild(target_tree, lambda key: _from_numpy(zf[key], dtypes[key]), device,
                        pctx), step


def _rebuild(target_tree: Any, read: Callable[[str], Any], device: Optional[DeviceLike],
             pctx: Optional[ParallelCtx]) -> Any:
    """``target_tree`` rebuilt from ``read(key)``, the saved leaf at each
    path (see :func:`restore_checkpoint`)."""
    dev = None if device is None else resolve_device(device)
    specs = tree_layout(target_tree) if pctx is not None and pctx.mesh is not None else None

    def mine(key: str, like: torch.Tensor) -> torch.Tensor:
        """The saved tensor at ``key``, or this rank's slice of it."""
        saved = read(key)
        spec = leaf_spec(key, specs) if specs is not None else None
        if spec is not None:
            # a copy: a view would keep the whole tensor alive
            saved = shard_tensor(saved, spec, pctx).clone()  # type: ignore[arg-type]
        if tuple(saved.shape) != tuple(like.shape):
            raise ValueError(f"checkpoint {key}: shape {tuple(saved.shape)} where the target "
                             f"holds {tuple(like.shape)}")
        return saved

    def place(key: str, like: Any) -> Any:
        if not isinstance(like, torch.Tensor):
            return int(read(key))
        return mine(key, like).to(like.device if dev is None else dev, like.dtype)

    def rebuild(tree: Any, prefix: str) -> Any:
        def join(k: object) -> str:
            return f"{prefix}/{k}" if prefix else str(k)

        if tree is None:
            return None
        if isinstance(tree, nn.Module):
            with torch.no_grad():
                for k, p in tree.named_parameters():
                    p.copy_(mine(join(k), p))
            if dev is not None:
                tree.to(dev)
            return tree
        if isinstance(tree, dict):
            return {k: rebuild(v, join(k)) for k, v in tree.items()}
        if isinstance(tree, tuple):
            names = getattr(tree, "_fields", None)
            items = [rebuild(v, join(k)) for k, v in zip(names or range(len(tree)), tree)]
            return type(tree)(*items) if names else tuple(items)
        return place(prefix, tree)

    return rebuild(target_tree, "")
