"""The port's deprecated solver frontends against the reference's: the
chunked, batched and ragged solvers, ``solve_ragged``, the legacy serving
service and ``make_batched_solve_step`` on the same numpy inputs (fp64,
the tolerance ladder's 1e-12), the same plans' chunk bounds, the same
``DeprecationWarning`` texts (the port names ``repro_torch.api`` where the
reference names ``repro.api``) and the same ``ValueError`` s. The port runs
on the CPU here (``device="cpu"``), with the plain PyTorch stages."""

import re
import warnings

import numpy as np
import pytest

from repro.core.tridiag import ensure_x64

ensure_x64()

import repro.api  # noqa: E402,F401  (before repro.telemetry: import-order cycle)
import repro.core.tridiag as jtri  # noqa: E402
import repro.serve as jserve  # noqa: E402
from repro.core.tridiag.chunked import measure_chunk_sweep as ref_sweep  # noqa: E402
from repro.core.tridiag.plan import FixedChunkPolicy as RefFixed  # noqa: E402
from repro.core.tridiag.reference import make_diag_dominant_system  # noqa: E402
import repro_torch.core.tridiag as ttri  # noqa: E402
import repro_torch.serve as tserve  # noqa: E402
from repro_torch.core.tridiag.plan import FixedChunkPolicy  # noqa: E402
from repro_torch.kernels.common import assert_allclose_by_dtype  # noqa: E402

CPU = {"device": "cpu"}
SIZES = (50, 200, 130)


def _system(n, seed, batch=()):
    return make_diag_dominant_system(n, seed=seed, batch=batch)[:4]


def _systems():
    return [_system(n, seed=20 + i) for i, n in enumerate(SIZES)]


def _quiet(make):
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", DeprecationWarning)
        return make()


def _close(got, want):
    assert_allclose_by_dtype(got, np.asarray(want), np.float64)


@pytest.mark.parametrize("k", [1, 4])
def test_chunked_solver_matches_reference(k):
    ops = _system(1000, seed=1)
    ref = _quiet(lambda: jtri.ChunkedPartitionSolver(m=10, num_chunks=k))
    port = _quiet(lambda: ttri.ChunkedPartitionSolver(m=10, num_chunks=k, **CPU))
    x, timing = port.solve_timed(*ops)
    assert timing.num_chunks == k and x.dtype == np.float64
    _close(x, ref.solve(*ops))
    _close(port.solve(*ops), ref.solve(*ops))


@pytest.mark.parametrize("n,k", [(1000, 1), (1000, 3), (990, 7), (40, 8)])
def test_plan_for_chunk_bounds_match_reference(n, k):
    ref = _quiet(lambda: jtri.ChunkedPartitionSolver(m=10, num_chunks=k)).plan_for(n)
    port = _quiet(lambda: ttri.ChunkedPartitionSolver(m=10, num_chunks=k, **CPU)).plan_for(n)
    assert port.chunk_bounds == ref.chunk_bounds
    assert port.halo_bounds == ref.halo_bounds
    assert port.num_chunks == ref.num_chunks


def test_batched_solver_matches_reference():
    ops = _system(200, seed=2, batch=(8,))
    ref = _quiet(lambda: jtri.BatchedPartitionSolver(m=10, num_chunks=3))
    port = _quiet(lambda: ttri.BatchedPartitionSolver(m=10, num_chunks=3, **CPU))
    x, timing = port.solve_timed(*ops)
    assert x.shape == (8, 200) and timing.num_chunks == 3
    _close(x, ref.solve(*ops))


@pytest.mark.parametrize("chunks", [{"num_chunks": 2}, {"policy": 3}])
def test_ragged_solver_matches_reference(chunks):
    def kw(fixed):
        return {"policy": fixed(3)} if "policy" in chunks else dict(chunks)

    systems = _systems()
    ref = _quiet(lambda: jtri.RaggedPartitionSolver(m=10, **kw(RefFixed)))
    port = _quiet(lambda: ttri.RaggedPartitionSolver(m=10, **kw(FixedChunkPolicy), **CPU))
    assert port.plan_for(SIZES).chunk_bounds == ref.plan_for(SIZES).chunk_bounds
    assert port.plan_for(SIZES).offsets == ref.plan_for(SIZES).offsets
    xs, timing = port.solve_timed(systems)
    assert timing.num_chunks == ref.plan_for(SIZES).num_chunks
    for got, want in zip(xs, ref.solve(systems)):
        _close(got, want)


def test_solve_ragged_matches_reference():
    systems = _systems()
    want = _quiet(lambda: jtri.solve_ragged(systems, m=10, num_chunks=2))
    got = _quiet(lambda: ttri.solve_ragged(systems, m=10, num_chunks=2, **CPU))
    assert [x.shape for x in got] == [(n,) for n in SIZES]
    for g, w in zip(got, want):
        _close(g, w)


def _requests(module):
    return [module.SolveRequest(i, *ops) for i, ops in enumerate(_systems())]


@pytest.mark.parametrize("dispatch", ["staged", "fused"])
def test_solve_service_flush_matches_reference(dispatch):
    ref = _quiet(lambda: jserve.BatchedSolveService(m=10, max_batch=2, dispatch=dispatch))
    port = _quiet(lambda: tserve.BatchedSolveService(m=10, max_batch=2, dispatch=dispatch,
                                                     **CPU))
    want, got = {}, {}
    for r, t in zip(_requests(jserve), _requests(tserve)):
        ref.submit(r)
        port.submit(t)
        assert port.stats["batches"] == ref.stats["batches"] == len(got) // 2  # enqueued only
        want.update(ref.poll())  # a full batch of 2 leaves on poll
        got.update(port.poll())
        assert sorted(got) == sorted(want)
    assert sorted(got) == [0, 1]
    want.update(ref.flush())
    got.update(port.flush())
    assert sorted(got) == sorted(want) == [0, 1, 2]
    for rid in want:
        _close(got[rid], want[rid])
    assert port.stats["batches"] == ref.stats["batches"] == 2
    assert port.flush() == {}


def test_solve_service_admits_inside_submit():
    port = _quiet(lambda: tserve.BatchedSolveService(
        m=10, admission=tserve.AdmissionPolicy(max_batch=2), **CPU))
    ref = _quiet(lambda: jserve.BatchedSolveService(
        m=10, admission=jserve.AdmissionPolicy(max_batch=2)))
    reqs, ref_reqs = _requests(tserve), _requests(jserve)
    for i in range(2):
        port.submit(reqs[i])
        ref.submit(ref_reqs[i])
    assert port.stats["batches"] == ref.stats["batches"] == 1  # full: dispatched in submit
    port.submit(reqs[2])
    ref.submit(ref_reqs[2])
    got, want = port.poll(), ref.poll()
    assert sorted(got) == sorted(want) == [0, 1]
    got.update(port.flush())
    want.update(ref.flush())
    for rid in want:
        _close(got[rid], want[rid])


def test_solve_service_raises_a_dispatch_error_to_its_caller():
    port = _quiet(lambda: tserve.BatchedSolveService(m=10, **CPU))

    class Broken:
        operand_device = None
        backend = None

        def resolved_layout(self, plan):
            return "system-major"

        def execute(self, *args):
            raise RuntimeError("device lost")

    port._executor = Broken()
    port.submit(_requests(tserve)[0])
    with pytest.raises(RuntimeError, match="device lost"):
        port.flush()
    assert port.stats["failed"] == 1


def test_make_batched_solve_step_matches_reference():
    ops = _system(100, seed=4, batch=(5,))
    want = jserve.make_batched_solve_step(m=10)(*ops)
    got = tserve.make_batched_solve_step(m=10)(*ops, **CPU)
    _close(got.numpy(), np.asarray(want))


def test_measure_chunk_sweep_times_each_count():
    got = ttri.measure_chunk_sweep(400, (1, 2, 4), repeats=1, **CPU)
    want = ref_sweep(400, (1, 2, 4), repeats=1)
    assert [t.num_chunks for t in got] == [t.num_chunks for t in want] == [1, 2, 4]
    assert all(t.t_total_ms > 0 and t.n == 400 for t in got)


_SYS = _systems()
FRONTENDS = {
    "ChunkedPartitionSolver": (lambda mod, kw: mod.ChunkedPartitionSolver(**kw)),
    "BatchedPartitionSolver": (lambda mod, kw: mod.BatchedPartitionSolver(**kw)),
    "RaggedPartitionSolver": (lambda mod, kw: mod.RaggedPartitionSolver(**kw)),
    "solve_ragged": (lambda mod, kw: mod.solve_ragged(_SYS, **kw)),
    "BatchedSolveService": (lambda mod, kw: (jserve if mod is jtri else tserve)
                            .BatchedSolveService(**kw)),
}


def _warning(make):
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        make()
    msgs = [str(w.message) for w in caught if issubclass(w.category, DeprecationWarning)]
    assert len(msgs) == 1, msgs
    return msgs[0]


@pytest.mark.parametrize("name", sorted(FRONTENDS))
def test_deprecation_warning_matches_reference(name):
    make = FRONTENDS[name]
    want = _warning(lambda: make(jtri, {}))
    got = _warning(lambda: make(ttri, dict(CPU)))
    assert "repro_torch.api" in got
    assert got.replace("repro_torch.", "repro.") == want


def _error(call):
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", DeprecationWarning)
        with pytest.raises(ValueError) as info:
            call()
    return str(info.value)


ERRORS = {
    "chunked size": lambda mod: _quiet(lambda: mod.ChunkedPartitionSolver(m=7, **_kw(mod)))
    .solve(*_system(1000, seed=0)),
    "batched rank": lambda mod: _quiet(lambda: mod.BatchedPartitionSolver(**_kw(mod)))
    .solve(*_system(100, seed=0)),
    "batched size": lambda mod: _quiet(lambda: mod.BatchedPartitionSolver(m=7, **_kw(mod)))
    .solve(*_system(100, seed=0, batch=(2,))),
    "ragged both": lambda mod: _quiet(lambda: mod.RaggedPartitionSolver(
        num_chunks=2, policy=_fixed(mod)(2), **_kw(mod))),
    "solve_ragged both": lambda mod: _quiet(lambda: mod.solve_ragged(
        _SYS, num_chunks=2, policy=_fixed(mod)(2), **_kw(mod))),
    "service max_batch": lambda mod: _quiet(lambda: _serve(mod).BatchedSolveService(
        max_batch=4, admission=_serve(mod).AdmissionPolicy(max_batch=2), **_kw(mod))),
}


def _kw(mod):
    return {} if mod is jtri else dict(CPU)


def _fixed(mod):
    return RefFixed if mod is jtri else FixedChunkPolicy


def _serve(mod):
    return jserve if mod is jtri else tserve


@pytest.mark.parametrize("case", sorted(ERRORS))
def test_value_errors_match_reference(case):
    want = _error(lambda: ERRORS[case](jtri))
    got = _error(lambda: ERRORS[case](ttri))
    # shapes print as tuples in both; the reference's numpy ints do too
    assert re.sub(r"\s+", " ", got) == re.sub(r"\s+", " ", want)
