"""The harness: finds a cell's files by name, runs its driver, reads its
metrics and prints the result line.

Every piece that belongs to one configuration, traffic mix or metric is a
file of its own under ``cudabench/``, found by the name ``BENCHMARK.json``
gives it:

- ``configs/<config>.json``: the configuration; its ``kind`` names the
  driver, ``drivers/<kind>.py``, which runs that kind of system, and its
  ``reference`` the plain reference under ``references/``;
- ``traffic/<traffic>.json``: the parameters the driver's one generator
  reads;
- ``metrics/<metric>.py``: a reader, ``read(record) -> float or None``,
  of one metric from the run's :class:`Record`. A reader that finds
  nothing to read returns None, and the metric is left out of the line.

So a later cell, configuration or per-layer metric is added as files and
an entry in ``BENCHMARK.json``, without an edit here.
"""

from __future__ import annotations

import importlib
import importlib.util
import json
import math
import sys
import time
from dataclasses import dataclass, field
from pathlib import Path
from types import ModuleType
from typing import Any, Callable, Dict, List, Optional, Tuple

#: Top-level module names a run may not hold once its window has closed.
FOREIGN = ("jax", "jaxlib", "flax", "repro")


@dataclass(frozen=True)
class Cell:
    """One entry of ``workloads`` with its files loaded."""

    name: str
    config_name: str
    traffic_name: str
    chips: int
    config: Dict[str, Any]
    traffic: Dict[str, Any]
    end_to_end: Tuple[Dict[str, Any], ...]
    per_layer: Tuple[Dict[str, Any], ...]
    root: Path

    @property
    def bench_dir(self) -> Path:
        return self.root / "cudabench"


@dataclass
class Record:
    """What a driver hands the metric readers.

    Times are host-clock seconds from :func:`time.perf_counter`. ``calls``
    holds each call of the window as (start, end, units of work), where a
    unit is what the cell's rate counts (an unknown, a token). ``counters``
    holds the driver's counts and computed quantities by name.
    ``checks`` holds each number the correctness comparison compared, as
    (value, limit): a run is correct when each value is at most its limit
    and no attempt failed."""

    setup_s: float = 0.0
    window_s: float = 0.0
    calls: List[Tuple[float, float, float]] = field(default_factory=list)
    attempted: int = 0
    failed: int = 0
    counters: Dict[str, float] = field(default_factory=dict)
    checks: Dict[str, Tuple[float, float]] = field(default_factory=dict)
    details: Dict[str, Any] = field(default_factory=dict)  # the comparison's other readings
    timeline: Optional[Any] = None  # trace.Timeline of a traced run
    device_kind: str = ""
    device_count: int = 1
    memory_peak_bytes: int = 0

    @property
    def correct(self) -> bool:
        return (bool(self.checks) and self.failed == 0
                and all(v <= lim for v, lim in self.checks.values()))  # NaN fails


def load_benchmark(root: Path) -> Dict[str, Any]:
    return json.loads((root / "BENCHMARK.json").read_text())


def _applies(metric: Dict[str, Any], cell: str) -> bool:
    return "workloads" not in metric or cell in metric["workloads"]


def load_cell(root: Path, workload: str) -> Cell:
    """The cell named ``workload`` with its configuration and traffic files;
    an unknown name raises ``KeyError`` naming the cells there are."""
    bench = load_benchmark(root)
    cells = {w["name"]: w for w in bench["workloads"]}
    if workload not in cells:
        raise KeyError(f"no workload {workload!r}; BENCHMARK.json has {sorted(cells)}")
    w = cells[workload]
    configs = {c["name"]: c for c in bench["configs"]}
    config = json.loads((root / configs[w["config"]]["file"]).read_text())
    traffic = json.loads((root / "cudabench" / "traffic" / f"{w['traffic']}.json").read_text())
    return Cell(
        name=workload, config_name=w["config"], traffic_name=w["traffic"], chips=w["chips"],
        config=config, traffic=traffic,
        end_to_end=tuple(m for m in bench["end_to_end"] if _applies(m, workload)),
        per_layer=tuple(m for m in bench["per_layer"] if _applies(m, workload)),
        root=root,
    )


def load_file_module(path: Path, name: str) -> ModuleType:
    """The Python file at ``path`` as a module (its name may hold dots)."""
    spec = importlib.util.spec_from_file_location(name, path)
    if spec is None or spec.loader is None:
        raise ImportError(f"cannot load {path}")
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def reader(cell: Cell, metric: str) -> Callable[[Record], Optional[float]]:
    path = cell.bench_dir / "metrics" / f"{metric}.py"
    return load_file_module(path, "cudabench_metric_" + metric.replace(".", "_")).read


def driver(cell: Cell) -> ModuleType:
    return importlib.import_module(f"cudabench.drivers.{cell.config['kind']}")


def reference(cell: Cell) -> ModuleType:
    """The configuration's plain reference, ``references/<name>.py``."""
    return importlib.import_module(f"cudabench.references.{cell.config['reference']}")


def execute(root: Path, workload: str, seed: int, seconds: float, trace: bool,
            device: Any, variant: str = "program",
            overrides: Optional[Dict[str, Dict[str, Any]]] = None,
            t0: Optional[float] = None) -> Tuple[Cell, Record]:
    """Run ``workload`` once on ``device`` and return its record. The chip
    is not looked for here (see ``run.py``). ``overrides`` replaces keys of
    the cell's ``config`` and ``traffic`` (the CPU tests' small sizes);
    ``variant`` is ``"program"``, or what ``control.py`` puts in the
    program's place. Set-up is timed from ``t0`` (``time.perf_counter``;
    by default from this call)."""
    t0 = time.perf_counter() if t0 is None else t0
    cell = load_cell(root, workload)
    if overrides:
        cell = Cell(**{**cell.__dict__,
                       "config": {**cell.config, **overrides.get("config", {})},
                       "traffic": {**cell.traffic, **overrides.get("traffic", {})}})
    return cell, driver(cell).run(cell, seed, seconds, trace, device, variant, t0)


def result_line(cell: Cell, rec: Record, trace: bool, platform: str = "gpu") -> Dict[str, Any]:
    """The last line of a run: ``correct``, ``attempted``, ``failed``,
    ``metrics`` (the end-to-end metrics, or with ``trace`` the per-layer
    ones), ``device``, with ``trace`` the ``breakdown``, and ``checks``
    last: each number compared, with its limit."""
    metrics: Dict[str, Dict[str, Any]] = {}
    for m in (cell.per_layer if trace else cell.end_to_end):
        value = reader(cell, m["name"])(rec)
        if value is not None:
            if not math.isfinite(value):
                raise ValueError(f"metric {m['name']} read {value}")
            metrics[m["name"]] = {"value": float(value), "unit": m["unit"]}
    device: Dict[str, Any] = {"platform": platform, "kind": rec.device_kind,
                              "count": rec.device_count,
                              "memory_peak_bytes": int(rec.memory_peak_bytes)}
    line: Dict[str, Any] = {"correct": rec.correct, "attempted": rec.attempted,
                            "failed": rec.failed, "metrics": metrics, "device": device}
    if trace and rec.timeline is not None:
        device["busy_s"] = rec.timeline.busy_s()
        device["window_s"] = rec.timeline.window_s
        line["breakdown"] = rec.timeline.breakdown()
    line["checks"] = {k: {"value": _finite(v), "limit": lim} for k, (v, lim) in rec.checks.items()}
    return line


def _finite(v: float) -> float:
    """``v``, or the largest float where it is not finite (JSON has no NaN)."""
    return v if math.isfinite(v) else sys.float_info.max


def check_lines(rec: Record) -> List[str]:
    """Each number compared beside its limit, one line each."""
    lines = [f"check {k}: {v!r} (limit {lim!r}) {'ok' if v <= lim else 'FAILED'}"
             for k, (v, lim) in rec.checks.items()]
    lines.append(f"check attempts failed: {rec.failed} of {rec.attempted}; "
                 f"correct: {str(rec.correct).lower()}")
    return lines


def foreign_modules() -> List[str]:
    """The modules of :data:`FOREIGN` this process holds, by whole
    top-level name (``repro_torch`` is not ``repro``)."""
    return sorted({m.split(".")[0] for m in sys.modules} & set(FOREIGN))
