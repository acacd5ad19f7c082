"""Driver of the tridiagonal solver cells: ``TridiagSession`` verbs called
by one client in a closed loop.

Configuration keys (``configs/<config>.json``): ``m``, ``dtype``,
``dispatch``, ``layout`` and ``policy`` of the session's ``SolverConfig``;
``system``, the ranges the systems are drawn from; ``control_dtype``, the
program's own lower precision, which ``control.py`` switches on; ``limits``.

Traffic keys (``traffic/<traffic>.json``):

- ``verb``: ``"solve"`` (1-D operands) or ``"solve_batched"`` ((B, n));
- ``sizes``: the system sizes n; ``batch``: B for ``solve_batched``;
- ``systems_per_shape``: distinct systems held per shape, called in turn,
  so that no call of a shape repeats its predecessor's operands;
- ``sample_per_shape``: answers per shape kept for the check, drawn from
  the seed over the window's calls (a reservoir).

The calls come in cycles: each cycle calls every shape once, in an order
drawn from the seed, so every seed sends the same mix. Operands are NumPy
arrays on the host, made on the device from the seed and copied back in
set-up; every shape is called three times in set-up (a miss, the CUDA
graph's capture, a replay). A call is timed on the host clock from the
verb's call to its return with the NumPy solution in hand.
"""

from __future__ import annotations

import sys
import time
from typing import Any, Dict, Iterator, List, Tuple

import numpy as np
import torch

from cudabench import harness
from cudabench.trace import Tracer

#: The CUDA sources the solver's path launches.
SOURCES = ("partition_stage1", "thomas", "partition_stage3",
           "partition_stage1_wide", "partition_stage3_wide")


def schedule(n_shapes: int, seed: int) -> Iterator[int]:
    """Shape indices in cycles, each cycle a permutation drawn from ``seed``."""
    rng = np.random.default_rng([seed, 0])
    while True:
        yield from rng.permutation(n_shapes).tolist()


def shapes_of(traffic: Dict[str, Any]) -> List[Tuple[int, ...]]:
    batch = traffic.get("batch")
    return [((batch, n) if batch else (n,)) for n in traffic["sizes"]]


def make_session(config: Dict[str, Any], device: torch.device, dtype: str) -> Any:
    from repro_torch.api import HeuristicChunkPolicy, SolverConfig, TridiagSession
    from repro_torch.core.autotune import fit_stream_heuristic
    from repro_torch.core.streams import StreamSimulator

    pol = config["policy"]
    heuristic = fit_stream_heuristic(
        StreamSimulator(seed=pol["simulator_seed"]).dataset(reps=pol["reps"]))
    return TridiagSession(SolverConfig(
        m=config["m"], dtype=np.dtype(dtype), dispatch=config["dispatch"],
        layout=config["layout"], device=str(device),
        policy=HeuristicChunkPolicy(heuristic)))


def run(cell: harness.Cell, seed: int, seconds: float, trace: bool, device: torch.device,
        variant: str, t0: float) -> harness.Record:
    from repro_torch.kernels import LAUNCH_COUNTERS, build

    config, traffic = cell.config, cell.traffic
    ref = harness.reference(cell)
    cuda = device.type == "cuda"
    if cuda:
        build.build(SOURCES)
    if variant not in ("program", "control"):
        raise ValueError(f"variant {variant!r}: the solver cells take 'program' or 'control'")
    dtype = config["control_dtype"] if variant == "control" else config["dtype"]
    session = make_session(config, device, dtype)
    verb = getattr(session, traffic["verb"])

    shapes = shapes_of(traffic)
    per = traffic["systems_per_shape"]
    gen = torch.Generator(device=device).manual_seed(seed)
    systems: Dict[Tuple[int, int], Tuple[List[np.ndarray], np.ndarray]] = {}
    for i, shape in enumerate(shapes):
        for k in range(per):
            dl, d, du, x = ref.make_system(gen, shape, config["system"], device)
            b = ref.matvec(dl, d, du, x)
            systems[i, k] = ([t.cpu().numpy() for t in (dl, d, du, b)], x.cpu().numpy())
    del dl, d, du, x, b
    for i in range(len(shapes)):  # a miss, the graph's capture, a replay
        for k in (0, 1 % per, 0):
            verb(*systems[i, k][0])
    if cuda:
        torch.cuda.synchronize(device)

    def total() -> int:
        return sum(c.total for c in LAUNCH_COUNTERS.values())

    def replayed() -> int:
        return sum(c.replayed for c in LAUNCH_COUNTERS.values())

    rec = harness.Record(device_kind=torch.cuda.get_device_name(device) if cuda else "cpu")
    order = schedule(len(shapes), seed)
    turn = [0] * len(shapes)
    keep = traffic["sample_per_shape"]
    pick = np.random.default_rng([seed, 1])
    kept: List[List[Tuple[np.ndarray, int]]] = [[] for _ in shapes]
    seen = [0] * len(shapes)
    replays = 0
    tracer = Tracer(trace, device)
    launches0 = total()
    with tracer.window():
        start = time.perf_counter()
        rec.setup_s = start - t0
        while True:
            i = next(order)
            k = turn[i] % per
            turn[i] += 1
            ops = systems[i, k][0]
            r0 = replayed()
            with tracer.span(f"{traffic['verb']} {'x'.join(map(str, shapes[i]))}"):
                c0 = time.perf_counter()
                try:
                    x = verb(*ops)
                except Exception as e:  # counted against the attempts
                    print(f"cudabench: a call of {shapes[i]} failed: {e!r}", file=sys.stderr)
                    rec.failed += 1
                    x = None
                c1 = time.perf_counter()
            replays += replayed() > r0
            rec.attempted += 1
            rec.calls.append((c0, c1, float(np.prod(shapes[i]))))
            if x is not None:  # the answers kept for the check, a reservoir
                seen[i] += 1
                if len(kept[i]) < keep:
                    kept[i].append((x, k))
                else:
                    j = int(pick.integers(seen[i]))
                    if j < keep:
                        kept[i][j] = (x, k)
            if c1 - start >= seconds:
                break
        rec.window_s = c1 - start
    rec.timeline = tracer.timeline
    rec.counters = {
        "calls": float(rec.attempted),
        "launches": float(total() - launches0),
        "replayed_calls": float(replays),
        "unknowns": float(sum(u for _, _, u in rec.calls)),
        "itemsize": float(np.dtype(dtype).itemsize),
    }
    if cuda:
        rec.memory_peak_bytes = torch.cuda.max_memory_allocated(device)
    session.close()

    worst = 0.0
    for i, answers in enumerate(kept):
        for x, k in answers:
            worst = max(worst, ref.rel_err(x, systems[i, k][1]))
    rec.checks = {"max_rel_err": (worst, config["limits"]["max_rel_err"])}
    return rec
