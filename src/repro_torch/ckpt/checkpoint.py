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
"""

from __future__ import annotations

import json
import os
import shutil
import time
from pathlib import Path
from typing import Any, Dict, Optional, Tuple

import numpy as np
import torch
from torch import nn

from repro_torch.device import DeviceLike, resolve_device


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
) -> Tuple[Any, int]:
    """Restore into the structure of ``target_tree``; returns ``(tree,
    step)``. Raises ``FileNotFoundError`` without a checkpoint and
    ``KeyError`` when the checkpoint lacks a path of the target."""
    ckpt_dir = Path(ckpt_dir)
    if step is None:
        step = latest_step(ckpt_dir)
        if step is None:
            raise FileNotFoundError(f"no checkpoints under {ckpt_dir}")
    path = ckpt_dir / f"step_{step:08d}"
    manifest = json.loads((path / "manifest.json").read_text())
    dtypes = manifest["dtypes"]
    with np.load(path / "arrays.npz") as zf:
        arrays = {k: _from_numpy(zf[k], dtypes[k]) for k in zf.files}
    missing = set(flatten_with_names(target_tree)) - set(arrays)
    if missing:
        raise KeyError(f"checkpoint missing keys: {sorted(missing)[:5]} ...")
    dev = None if device is None else resolve_device(device)

    def place(saved: Any, like: Any) -> Any:
        if not isinstance(like, torch.Tensor):
            return int(saved)
        return saved.to(like.device if dev is None else dev, like.dtype)

    def rebuild(tree: Any, prefix: str) -> Any:
        def join(k: object) -> str:
            return f"{prefix}/{k}" if prefix else str(k)

        if tree is None:
            return None
        if isinstance(tree, nn.Module):
            with torch.no_grad():
                for k, p in tree.named_parameters():
                    p.copy_(arrays[join(k)])
            if dev is not None:
                tree.to(dev)
            return tree
        if isinstance(tree, dict):
            return {k: rebuild(v, join(k)) for k, v in tree.items()}
        if isinstance(tree, tuple):
            names = getattr(tree, "_fields", None)
            items = [rebuild(v, join(k)) for k, v in zip(names or range(len(tree)), tree)]
            return type(tree)(*items) if names else tuple(items)
        return place(arrays[prefix], tree)

    return rebuild(target_tree, ""), step
