"""Merge dryrun.json + probe.json into the roofline table, the counterpart
of ``repro.roofline.report``, with the H100's constants.

The times are computed bounds for one H100 (``HW_H100``), not measured
times: compute from the counted FLOPs at the bf16 peak, memory from the
reference's analytic HBM model (the counted eager bytes beside it), the
collectives at the rate of the slowest link each group crosses.

Usage:
  PYTHONPATH=src python -m repro_torch.roofline.report \\
      --dryrun results/dryrun.json --probe results/probe.json
"""

from __future__ import annotations

import argparse
import json
from pathlib import Path
from typing import Any, Dict, List

from repro_torch.configs.base import get_config
from repro_torch.configs.shapes import SHAPES
from repro_torch.roofline.analysis import HW_H100, analytic_hbm_bytes, model_flops_for


def build_rows(dryrun: dict, probe: dict) -> List[Dict[str, Any]]:
    rows: List[Dict[str, Any]] = []
    for key, rec in sorted(dryrun.items()):
        arch, shape_name, mesh = key.split("|")
        if mesh != "16x16":
            continue  # the roofline table is single-pod, as the reference's
        if rec.get("status") == "skipped":
            rows.append({
                "arch": arch, "shape": shape_name, "status": "skipped",
                "reason": rec.get("reason", ""),
            })
            continue
        if rec.get("status") != "ok":
            rows.append({"arch": arch, "shape": shape_name, "status": "error"})
            continue
        cfg = get_config(arch)
        shape = SHAPES[shape_name]
        r = rec["roofline"]
        p = probe.get(f"{arch}|{shape_name}", {})
        corrected = p.get("status") == "ok"
        flops = p["flops"] if corrected else r["flops_per_device"]
        cbytes = p["cbytes"] if corrected else r["collective_bytes_per_device"]
        bytes_counted = p["bytes"] if corrected else r["bytes_per_device"]
        by_link = ({"nvlink": p["cbytes_nvlink"], "network": p["cbytes_network"]} if corrected
                   else r.get("collective_by_link", {}))
        bytes_analytic = analytic_hbm_bytes(cfg, shape)

        t_c = flops / HW_H100["peak_flops"]
        t_m_counted = bytes_counted / HW_H100["hbm_bw"]
        t_m = bytes_analytic / HW_H100["hbm_bw"]
        t_x = (by_link.get("nvlink", 0) / HW_H100["nvlink_bw"]
               + by_link.get("network", 0) / HW_H100["network_bw"])
        dominant = max(
            [("compute", t_c), ("memory", t_m), ("collective", t_x)],
            key=lambda kv: kv[1],
        )[0]
        model_total = model_flops_for(cfg, shape, backward=shape.kind == "train")
        model_dev = model_total / 256
        step_bound = max(t_c, t_m, t_x)
        rows.append({
            "arch": arch, "shape": shape_name, "status": "ok",
            "corrected": corrected,
            "flops_dev": flops, "bytes_counted_dev": bytes_counted,
            "bytes_analytic_dev": bytes_analytic, "cbytes_dev": cbytes,
            "t_compute_s": t_c, "t_memory_s": t_m, "t_memory_counted_s": t_m_counted,
            "t_collective_s": t_x, "dominant": dominant,
            "model_flops_dev": model_dev,
            "useful_ratio": model_dev / flops if flops else 0.0,
            "mfu_bound": (model_dev / HW_H100["peak_flops"]) / step_bound
            if step_bound else 0.0,
            "arg_bytes": rec.get("argument_bytes"),
            "peak_bytes": rec.get("peak_bytes"),
            "fits_h100_80gb": rec.get("fits_h100_80gb"),
            "collective_by_op": r.get("collective_by_op", {}),
        })
    return rows


def to_markdown(rows: List[Dict[str, Any]]) -> str:
    lines = [
        "| arch | shape | t_compute | t_memory(analytic) | t_memory(counted) | t_collective "
        "| dominant | useful(6ND/counted) | roofline-frac (MFU bound) | peak GB | probe |",
        "|---|---|---|---|---|---|---|---|---|---|---|",
    ]
    for r in rows:
        if r["status"] != "ok":
            lines.append(
                f"| {r['arch']} | {r['shape']} | — | — | — | — | {r['status']} "
                f"| — | — | — | — |"
            )
            continue
        peak = r["peak_bytes"]
        lines.append(
            f"| {r['arch']} | {r['shape']} | {r['t_compute_s']:.4f}s "
            f"| {r['t_memory_s']:.4f}s | {r['t_memory_counted_s']:.4f}s "
            f"| {r['t_collective_s']:.4f}s "
            f"| {r['dominant']} | {r['useful_ratio']:.2f} "
            f"| {r['mfu_bound']*100:.1f}% | {peak / 1e9:.2f} "
            f"| {'yes' if r['corrected'] else 'no'} |"
        )
    return "\n".join(lines)


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--dryrun", default="results/dryrun.json")
    ap.add_argument("--probe", default="results/probe.json")
    ap.add_argument("--json-out", default="results/roofline.json")
    args = ap.parse_args()
    dryrun = json.loads(Path(args.dryrun).read_text())
    probe = json.loads(Path(args.probe).read_text()) if Path(args.probe).exists() else {}
    rows = build_rows(dryrun, probe)
    Path(args.json_out).parent.mkdir(parents=True, exist_ok=True)
    Path(args.json_out).write_text(json.dumps(rows, indent=1))
    print(to_markdown(rows))


if __name__ == "__main__":
    main()
