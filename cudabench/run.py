"""Run one cell of the port's benchmark once and print its result line.

    python3 cudabench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

from the root of a checkout on a machine with the card(s) the cell asks
for. The run makes its inputs and weights from ``--seed``, warms up the
cell's own shapes (set-up), measures for ``--seconds``, checks the answers
of the window against the plain reference, and prints one JSON object as
the last line of standard output (see ``harness.result_line``); each number
compared is printed beside its limit as the last lines of standard error.
It exits non-zero and prints no result when CUDA is missing or offers fewer
cards than the cell asks for, or when the process holds ``jax``,
``jaxlib``, ``flax`` or the JAX package ``repro`` after the window.
"""

from __future__ import annotations

import time

T0 = time.perf_counter()  # set-up is timed from here

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
for _p in (ROOT / "src", ROOT):
    if str(_p) not in sys.path:
        sys.path.insert(0, str(_p))

#: Host threads of the run's own process: one caller, few threads.
HOST_THREADS = 4


def parse(argv: list) -> argparse.Namespace:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return ap.parse_args(argv)


def main(argv: list) -> int:
    args = parse(argv)
    import torch

    from cudabench import harness

    cell = harness.load_cell(ROOT, args.workload)
    if not torch.cuda.is_available():
        print("cudabench: torch.cuda.is_available() is False: no result", file=sys.stderr)
        return 3
    if torch.cuda.device_count() < cell.chips:
        print(f"cudabench: {args.workload} needs {cell.chips} cards, "
              f"{torch.cuda.device_count()} visible: no result", file=sys.stderr)
        return 3
    torch.set_num_threads(min(HOST_THREADS, os.cpu_count() or 1))
    cell, rec = harness.execute(ROOT, args.workload, args.seed, args.seconds,
                                bool(args.trace), torch.device("cuda", 0), t0=T0)
    bad = harness.foreign_modules()
    if bad:
        print(f"cudabench: the process holds {bad} after the window: no result",
              file=sys.stderr)
        return 4
    line = harness.result_line(cell, rec, bool(args.trace))
    for text in harness.check_lines(rec):
        print(text, file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(line), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
