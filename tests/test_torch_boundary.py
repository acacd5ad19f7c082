"""The port's boundary: it imports torch and numpy, never jax or the JAX
package, and its entry points refuse to run on a missing card.

Also holds the port's lock-guarded state to the repository's TRD001 rule,
through a registry aimed at the port's own modules.
"""

import ast
import os
import subprocess
import sys
from pathlib import Path

import pytest

from repro.analysis.core import check_paths, check_source
from repro.analysis.registry import GuardedAttrs, GuardedGlobals, Registry

REPO = Path(__file__).resolve().parents[1]
PORT = REPO / "src" / "repro_torch"
PORT_SOURCES = sorted(PORT.rglob("*.py")) + [REPO / "chip_smoke.py"]

REFITTER_STATE = (
    "_last_attempt_t",
    "_last_refit_t",
    "_attempts",
    "_refits",
    "_errors",
    "_agree",
    "_disagree",
    "_last_samples",
    "_last_heuristic",
    "_last_latency_model",
)

PORT_REGISTRY = Registry(
    guarded_globals=(
        GuardedGlobals(
            module="repro_torch/core/tridiag/plan.py",
            names=("_PLAN_CACHE", "_PLAN_STATS", "_PLAN_CACHE_CAPACITY"),
            guards=("_CACHE_LOCK",),
        ),
        GuardedGlobals(
            module="repro_torch/core/tridiag/plan.py",
            names=("_EXEC_CACHE", "_EXEC_STATS", "_EXEC_CACHE_CAPACITY", "_EXEC_BYTES",
                   "_EXEC_DROPPED"),
            guards=("_CACHE_LOCK",),
        ),
        GuardedGlobals(
            module="repro_torch/core/tridiag/plan.py",
            names=("_CAPTURE_STREAMS",),
            guards=("_CAPTURE_LOCK",),
        ),
        GuardedGlobals(
            module="repro_torch/kernels/build.py",
            names=("_LIBS",),
            guards=("_LOCK",),
        ),
        # The LM mesh's process groups, made once per mesh on every rank.
        GuardedGlobals(
            module="repro_torch/parallel/ctx.py",
            names=("_GROUPS", "_MESHES"),
            guards=("_GROUPS_LOCK",),
        ),
    ),
    guarded_attrs=(
        GuardedAttrs(
            module="repro_torch/core/tridiag/api.py",
            owner="SolveEngine",
            attrs=("stats", "_latency_model"),
            guards=("_stats_lock",),
            allow_in=("SolveEngine.__init__",),
        ),
        GuardedAttrs(
            module="repro_torch/core/tridiag/api.py",
            owner="TridiagSession",
            attrs=("_futures", "_worker", "_closed", "_worker_error", "_active_policy"),
            guards=("_cv",),
            allow_in=("TridiagSession.__init__",),
        ),
        # The ring is written from the serving hot path and read by the
        # refitter and exporters on other threads.
        GuardedAttrs(
            module="repro_torch/telemetry/ring.py",
            owner="TelemetryBuffer",
            attrs=("_ring", "_recorded", "_dropped"),
            guards=("_lock",),
            allow_in=("TelemetryBuffer.__init__",),
        ),
        # Read by stats_snapshot()/last_heuristic() from any thread while
        # the serve worker refits; the fits run outside the lock.
        GuardedAttrs(
            module="repro_torch/telemetry/refit.py",
            owner="OnlineRefitter",
            attrs=REFITTER_STATE,
            guards=("_lock",),
            allow_in=("OnlineRefitter.__init__",),
        ),
    ),
)


def _imported_modules(path):
    tree = ast.parse(path.read_text(encoding="utf-8"), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for alias in node.names:
                yield alias.name
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            yield node.module


def test_import_loads_neither_jax_nor_the_jax_package():
    code = (
        "import sys, repro_torch, repro_torch.api, repro_torch.kernels, "
        "repro_torch.core.autotune.convert, repro_torch.core.streams, "
        "repro_torch.launch.serve, repro_torch.models.registry, "
        "repro_torch.models.convert, repro_torch.kernels.ssd_stage1, repro_torch.serve, "
        "repro_torch.telemetry, repro_torch.core.streams.measure, repro_torch.parallel, "
        "repro_torch.launch.train, repro_torch.train, repro_torch.optim, repro_torch.ckpt, "
        "repro_torch.data, repro_torch.ft, repro_torch.configs.shapes, "
        "repro_torch.core.autotune.overlap, repro_torch.launch.mesh, "
        "repro_torch.parallel.sharding, repro_torch.parallel.collectives\n"
        "bad = [m for m in sys.modules if m.split('.')[0] in ('jax', 'jaxlib', 'repro')]\n"
        "assert not bad, bad\n"
        "print('clean')\n"
    )
    env = {**os.environ, "PYTHONPATH": str(REPO / "src")}
    out = subprocess.run(
        [sys.executable, "-c", code], env=env, capture_output=True, text=True, timeout=120
    )
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "clean"


@pytest.mark.parametrize("path", PORT_SOURCES, ids=lambda p: str(p.relative_to(REPO)))
def test_port_sources_import_no_jax_and_no_jax_package(path):
    for mod in _imported_modules(path):
        root = mod.split(".")[0]
        assert root not in ("jax", "jaxlib", "repro"), f"{path} imports {mod}"


def test_telemetry_imports_first_in_a_fresh_interpreter():
    """The telemetry package imports the plan layer and never the session,
    so it works as the first import (no import-order cycle)."""
    code = (
        "import repro_torch.telemetry as t, sys\n"
        "assert 'repro_torch.core.tridiag.api' not in sys.modules\n"
        "from repro_torch.api import TridiagSession\n"
        "assert t.OnlineRefitter and TridiagSession\n"
        "print('ok')\n"
    )
    env = {**os.environ, "PYTHONPATH": str(REPO / "src")}
    out = subprocess.run(
        [sys.executable, "-c", code], env=env, capture_output=True, text=True, timeout=120
    )
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "ok"


@pytest.mark.parametrize(
    "module,owner,attr",
    [("repro_torch/core/tridiag/api.py", "SolveEngine", "_latency_model"),
     ("repro_torch/core/tridiag/api.py", "TridiagSession", "_active_policy"),
     ("repro_torch/telemetry/ring.py", "TelemetryBuffer", "_ring"),
     ("repro_torch/telemetry/refit.py", "OnlineRefitter", "_last_heuristic")],
)
def test_port_registry_covers_the_closed_loop(module, owner, attr):
    found = check_source(
        f"class {owner}:\n    def peek(self):\n        return self.{attr}\n",
        f"src/{module}",
        registry=PORT_REGISTRY,
        select=["TRD001"],
    )
    assert [v.code for v in found] == ["TRD001"]


def test_session_asks_for_the_card_by_default_and_names_cuda():
    import torch

    from repro_torch.api import SolverConfig, TridiagSession

    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present; the missing-card error cannot occur")
    with pytest.raises(RuntimeError, match="CUDA"):
        TridiagSession(SolverConfig())


def test_port_lock_guarded_state_is_clean():
    found = check_paths([str(PORT)], registry=PORT_REGISTRY, select=["TRD001"])
    assert found == [], "\n".join(v.format() for v in found)


def test_port_registry_fires_on_an_unguarded_touch():
    found = check_source(
        "def peek():\n    return len(_PLAN_CACHE)\n",
        "src/repro_torch/core/tridiag/plan.py",
        registry=PORT_REGISTRY,
        select=["TRD001"],
    )
    assert [v.code for v in found] == ["TRD001"]
    for entry in PORT_REGISTRY.guarded_globals + PORT_REGISTRY.guarded_attrs:
        assert (REPO / "src" / entry.module).exists(), entry.module


@pytest.mark.parametrize("name", ["_GROUPS", "_MESHES"])
def test_port_registry_covers_the_mesh_groups(name):
    found = check_source(
        f"def peek():\n    return {name}\n",
        "src/repro_torch/parallel/ctx.py",
        registry=PORT_REGISTRY,
        select=["TRD001"],
    )
    assert [v.code for v in found] == ["TRD001"]


@pytest.mark.parametrize("name", ["_EXEC_CACHE", "_EXEC_STATS", "_EXEC_CACHE_CAPACITY",
                                  "_EXEC_BYTES", "_EXEC_DROPPED", "_CAPTURE_STREAMS"])
def test_port_registry_covers_the_executable_cache(name):
    found = check_source(
        f"def peek():\n    return {name}\n",
        "src/repro_torch/core/tridiag/plan.py",
        registry=PORT_REGISTRY,
        select=["TRD001"],
    )
    assert [v.code for v in found] == ["TRD001"]


def test_chip_smoke_refuses_to_run_without_a_card(tmp_path):
    import torch

    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    out = subprocess.run(
        [sys.executable, str(REPO / "chip_smoke.py")],
        capture_output=True, text=True, timeout=120, cwd=tmp_path,
    )
    assert out.returncode != 0
    assert '"ok"' not in out.stdout
