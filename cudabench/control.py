"""Readings for the limits of ``correct``: the program, its control and its
planted faults over many seeds in one process. The benchmark's runs never
run this.

    python3 cudabench/control.py --workload <cell> --seeds 1,2,3 \\
        [--variant program|control|fault:<name>] [--seconds 5]

``program`` reads the sound program (the lower readings); ``control`` puts
the cell's control in the program's place (the configuration's own lower
precision: the solver's float32 path, or the reference in float8 for a
training cell), whose readings must fail; ``fault:<name>`` plants one of
``faults.FAULTS``. Each seed prints one JSON line: the variant, the seed,
``correct`` and each number compared with its limit. It runs on the card
when there is one, else on the CPU.
"""

from __future__ import annotations

import argparse
import contextlib
import json
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
for _p in (ROOT / "src", ROOT):
    if str(_p) not in sys.path:
        sys.path.insert(0, str(_p))


def main(argv: list) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True, help="comma-separated")
    ap.add_argument("--variant", default="program")
    ap.add_argument("--seconds", type=float, default=5.0)
    args = ap.parse_args(argv)
    import torch

    from cudabench import faults, harness

    device = torch.device("cuda", 0) if torch.cuda.is_available() else torch.device("cpu")
    kind = harness.load_cell(ROOT, args.workload).config["kind"]
    fault = args.variant.split(":", 1)[1] if args.variant.startswith("fault:") else None
    variant = "program" if fault else args.variant
    for seed in (int(s) for s in args.seeds.split(",")):
        plant = faults.planted(kind, fault) if fault else contextlib.nullcontext()
        with plant:
            _, rec = harness.execute(ROOT, args.workload, seed, args.seconds, False, device,
                                     variant=variant)
        print(json.dumps({"workload": args.workload, "variant": args.variant, "seed": seed,
                          "correct": rec.correct, "attempted": rec.attempted,
                          "failed": rec.failed, "device": rec.device_kind,
                          "checks": {k: {"value": v, "limit": lim}
                                     for k, (v, lim) in rec.checks.items()},
                          "details": rec.details}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
