"""One family's dry-run checks, run in a process of its own (a process has
one default process group): ``python tests/torch_dryrun_family.py <arch>``
prints one JSON object that ``tests/test_torch_dryrun.py`` reads.

1. One rank without a mesh (a fake world of 1): the counts of a train step,
   a prefill and a decode step on real CPU tensors and on fake tensors.
2. One rank of a fake 16 x 16 world: the probe's extrapolation of a train
   step against the count at full depth (for qwen3-4b also with Adafactor,
   the optimizer of configs above ``ADAFACTOR_THRESHOLD``, which the
   probe's reduced variants must keep), and the records of a
   decode cell and a ``long_500k`` cell.

Imports the port only.
"""

from __future__ import annotations

import dataclasses
import json
import sys
from typing import Any, Dict

import torch

from repro_torch.configs.base import get_config
from repro_torch.configs.shapes import ShapeSpec
from repro_torch.launch import dryrun as D
from repro_torch.roofline import count_step
from repro_torch.roofline.probe import probe_cell

# Tiny shapes: the global batch splits over 16 data ranks.
SHAPES = {
    "train_4k": ShapeSpec("train_4k", 32, 32, "train"),
    "prefill_32k": ShapeSpec("prefill_32k", 32, 32, "prefill"),
    "decode_32k": ShapeSpec("decode_32k", 64, 32, "decode"),
    "long_500k": ShapeSpec("long_500k", 64, 1, "decode"),
}


def family_cfg(arch: str, layers: int) -> Any:
    """The smoke config, widened so heads, SSM heads and experts split over
    16 model ranks, at ``layers`` layers (or layer groups)."""
    cfg = get_config(arch).smoke()
    changes: Dict[str, Any] = dict(num_heads=16, num_kv_heads=16 if cfg.num_kv_heads else 0,
                                   head_dim=8)
    if cfg.family == "moe":
        changes["num_experts"] = 16
    if cfg.family == "hybrid":
        changes.update(shared_attn_every=2, num_layers=2 * layers + 1)  # a tail layer
    elif cfg.family == "encdec":
        changes.update(enc_layers=layers, dec_layers=layers, num_layers=2 * layers)
    else:
        changes["num_layers"] = layers * (2 if cfg.alternate_local_global else 1)
    return dataclasses.replace(cfg, **changes)


def summary(counts: Any) -> Dict[str, Any]:
    total, by_op, calls = counts.collectives.collective_bytes()
    return {"flops": counts.flops, "bytes": counts.bytes, "peak_bytes": counts.peak_bytes,
            "argument_bytes": counts.argument_bytes, "cbytes": total, "cbytes_by_op": by_op,
            "collective_calls": calls, "flops_by_op": counts.flops_by_op}


def main(arch: str) -> Dict[str, Any]:
    out: Dict[str, Any] = {"real_vs_fake": {}, "records": {}}
    small = family_cfg(arch, 1)
    with D.fake_world(1):
        for name in ("train_4k", "prefill_32k", "decode_32k"):
            shape = dataclasses.replace(SHAPES[name], global_batch=2)
            _, fake = D.lower_cell(arch, name, None, cfg_override=small, shape_override=shape,
                                   remat="none", device="cpu")
            cell = D.prepare_cell(small, shape, D.make_pctx(shape, None, remat="none"),
                                  torch.device("cpu"), fake=False)
            with count_step(cell.arguments) as real:
                result = cell.run()
            del result, cell
            out["real_vs_fake"][name] = {"real": summary(real), "fake": summary(fake)}
    deep = family_cfg(arch, 4)
    with D.fake_world(256):
        record, full = D.lower_cell(arch, "train_4k", False, cfg_override=deep,
                                    shape_override=SHAPES["train_4k"], device="cpu")
        out["records"]["train_4k"] = record
        out["full"] = summary(full)
        out["probe"] = probe_cell(arch, "train_4k", cfg_override=deep,
                                  shape_override=SHAPES["train_4k"], device="cpu")
        if arch == "qwen3-4b":
            # Full depth above the threshold, every variant at or below it.
            D.ADAFACTOR_THRESHOLD = family_cfg(arch, 3).param_count()
            _, full = D.lower_cell(arch, "train_4k", False, cfg_override=deep,
                                   shape_override=SHAPES["train_4k"], device="cpu")
            out["full_adafactor"] = summary(full)
            out["probe_adafactor"] = probe_cell(arch, "train_4k", cfg_override=deep,
                                                shape_override=SHAPES["train_4k"], device="cpu")
        for name in ("decode_32k", "long_500k"):
            record, _ = D.lower_cell(arch, name, False, cfg_override=small,
                                     shape_override=SHAPES[name], device="cpu")
            out["records"][name] = record
    return out


if __name__ == "__main__":
    print(json.dumps(main(sys.argv[1])))
