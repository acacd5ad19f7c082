"""The port's dry run (``repro_torch.launch.dryrun``) on the CPU.

One process per family (``tests/torch_dryrun_family.py``: a process has one
default process group), started together, at tiny widths:

- the counts of a train step, a prefill and a decode step on real CPU
  tensors equal those on fake tensors (FLOPs, the SSD kernels' formulas
  included, bytes, peak live bytes, collectives), one rank without a mesh.
  Fake CUDA tensors need a CUDA build of torch: on the card
  ``chip_smoke.py``'s ``roofline`` phase holds real CUDA tensors against
  fake CUDA ones;
- on a fake 16 x 16 world, the probe's extrapolation equals the count at
  full depth, for FLOPs, bytes and collective bytes (by link too), with
  AdamW and with Adafactor;
- the records carry the reference's keys, ``skipped`` exactly where the
  reference's ``applicable`` says so.

And the dry run's entry point refuses a process group it did not make.
"""

import json
import os
import subprocess
import sys
from pathlib import Path

import pytest

from repro.configs.base import get_config as ref_get_config
from repro.configs.shapes import SHAPES as REF_SHAPES
from repro.configs.shapes import applicable as ref_applicable
from repro.roofline.analysis import RooflineTerms

ROOT = Path(__file__).resolve().parent.parent
FAMILIES = ("qwen3-4b", "gemma2-27b", "mamba2-1.3b", "zamba2-7b", "moonshot-v1-16b-a3b",
            "whisper-medium", "internvl2-2b")
SSD_FAMILIES = ("mamba2-1.3b", "zamba2-7b")
# The reference's record keys (launch/dryrun.py: lower_cell).
OK_KEYS = {"arch", "shape", "mesh", "kind", "status", "params", "active_params", "lower_s",
           "compile_s", "roofline"}
SKIPPED_KEYS = {"arch", "shape", "mesh", "status", "reason"}
ROOFLINE_KEYS = set(RooflineTerms(0.0, 0.0, 0.0).to_dict())
# Processes at once (each ~0.5 GB), and the time one may take.
AT_ONCE = 4
TIMEOUT_S = 300


def _env():
    return dict(os.environ, PYTHONPATH=str(ROOT / "src"))


@pytest.fixture(scope="module")
def families():
    """Each family's checks, run AT_ONCE processes at a time."""
    out, pending = {}, list(FAMILIES)
    running = {}
    try:
        while pending or running:
            while pending and len(running) < AT_ONCE:
                arch = pending.pop(0)
                running[arch] = subprocess.Popen(
                    [sys.executable, str(ROOT / "tests" / "torch_dryrun_family.py"), arch],
                    env=_env(), stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
            arch = next(iter(running))
            stdout, stderr = running.pop(arch).communicate(timeout=TIMEOUT_S)
            out[arch] = json.loads(stdout) if stdout.strip() else {"error": stderr[-3000:]}
    finally:
        for proc in running.values():
            proc.kill()
            proc.wait()
    return out


def _family(families, arch):
    result = families[arch]
    assert "error" not in result, result.get("error")
    return result


@pytest.mark.parametrize("arch", FAMILIES)
def test_real_and_fake_tensors_count_the_same(families, arch):
    for name, pair in _family(families, arch)["real_vs_fake"].items():
        real, fake = pair["real"], pair["fake"]
        for key in ("flops", "flops_by_op", "bytes", "peak_bytes", "argument_bytes", "cbytes"):
            assert real[key] == fake[key], (name, key)
        assert real["flops"] > 0 and real["cbytes"] == 0  # one rank: no collective
        if arch in SSD_FAMILIES and name != "decode_32k":
            assert real["flops_by_op"]["repro_torch.ssd_stage1"] > 0, name
            assert ("repro_torch.ssd_stage1_bwd" in real["flops_by_op"]) == (name == "train_4k")


@pytest.mark.parametrize("arch", FAMILIES)
def test_probe_extrapolates_to_the_full_depth_count(families, arch):
    result = _family(families, arch)
    probe, full = result["probe"], result["full"]
    assert probe["status"] == "ok"
    for key in ("flops", "bytes", "cbytes"):
        assert probe[key] == full[key], key
    assert full["cbytes"] > 0  # a sharded step moves something
    assert probe["cbytes_nvlink"] + probe["cbytes_network"] == full["cbytes"]
    # A 16-rank model group spans two nodes: nothing rides NVLink alone.
    assert probe["cbytes_nvlink"] == 0


def test_probe_keeps_the_full_configs_optimizer(families):
    """Above ``ADAFACTOR_THRESHOLD`` a cell trains with Adafactor; the
    probe's reduced variants (far below it) must too, or the fit mixes
    two optimizers."""
    result = _family(families, "qwen3-4b")
    probe, full = result["probe_adafactor"], result["full_adafactor"]
    for key in ("flops", "bytes", "cbytes"):
        assert probe[key] == full[key], key
    assert full["bytes"] != result["full"]["bytes"]  # Adafactor moves other bytes than AdamW


@pytest.mark.parametrize("arch", FAMILIES)
def test_records_carry_the_references_keys(families, arch):
    records = _family(families, arch)["records"]
    for shape, rec in records.items():
        want_ok, _ = ref_applicable(ref_get_config(arch), REF_SHAPES[shape])
        assert rec["status"] == ("ok" if want_ok else "skipped"), shape
        assert rec["mesh"] == "16x16" and rec["arch"] == arch and rec["shape"] == shape
        if want_ok:
            assert OK_KEYS | {"argument_bytes", "peak_bytes", "fits_h100_80gb"} <= set(rec)
            assert ROOFLINE_KEYS <= set(rec["roofline"])
            assert rec["peak_bytes"] >= rec["argument_bytes"] > 0
            assert rec["fits_h100_80gb"] is True
        else:
            assert set(rec) == SKIPPED_KEYS
    assert records["train_4k"]["optimizer"] == "adamw"


def test_dryrun_refuses_a_group_it_did_not_make():
    code = ("import torch.distributed as dist; "
            "dist.init_process_group('gloo', store=dist.HashStore(), rank=0, world_size=1); "
            "from repro_torch.launch.dryrun import main; "
            "main(['--arch', 'qwen3-4b', '--shape', 'decode_32k', '--out', ''])")
    proc = subprocess.run([sys.executable, "-c", code], env=_env(), capture_output=True,
                          text=True, timeout=TIMEOUT_S)
    assert proc.returncode == 2
    assert "backend 'gloo'" in proc.stderr and "'repro_fake'" in proc.stderr
