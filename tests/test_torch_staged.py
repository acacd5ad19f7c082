"""The port's staged executor and ``*_timed`` verbs against the JAX
package's, on the CPU.

``PlanExecutor`` on ``device="cpu"`` runs the same code as on the card,
without streams or pinned memory: per-chunk Stage 1, the fp64 reduced solve
on the host, per-chunk Stage 3. The same seeded numpy inputs go through the
reference ``PlanExecutor`` and sessions, and the answers are compared at the
tolerance ladder.
"""

import dataclasses
import threading

import numpy as np
import pytest
import torch

from repro.core.tridiag import ensure_x64

ensure_x64()

import repro.api as japi  # noqa: E402  (before repro.telemetry: import-order cycle)
from repro.core.tridiag import plan as jplan  # noqa: E402
from repro.core.tridiag.ragged import fuse_ragged as jax_fuse_ragged  # noqa: E402
from repro.core.tridiag.reference import make_diag_dominant_system  # noqa: E402
from repro_torch.api import (  # noqa: E402
    ChunkTiming,
    PlanExecutor,
    SolveRequest,
    SolverConfig,
    TridiagSession,
)
from repro_torch.core.tridiag import plan as tplan  # noqa: E402
from repro_torch.core.tridiag.ragged import split_ragged  # noqa: E402
from repro_torch.kernels.common import assert_allclose_by_dtype  # noqa: E402

DTYPES = [np.float32, np.float64]
KS = [1, 3, 8]
SIZES = (40, 300, 120, 10, 70)


def _systems(sizes, dtype, seed=0):
    return [make_diag_dominant_system(n, seed=seed + i, dtype=dtype) for i, n in enumerate(sizes)]


def _session(dispatch="auto", **kw):
    cfg = dict(m=10, num_chunks=3, max_batch=len(SIZES), device="cpu", dispatch=dispatch)
    return TridiagSession(SolverConfig(**{**cfg, **kw}))


def _check(got, want, dtype):
    if isinstance(want, list):
        assert len(got) == len(want)
        for g, w in zip(got, want):
            _check(g, w, dtype)
        return
    assert isinstance(got, np.ndarray) and got.dtype == np.dtype(dtype)
    assert got.shape == np.shape(want)
    assert_allclose_by_dtype(got, np.asarray(want), dtype)


# --------------------------------------------------------------- executor --
@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("backend", ["reference", "cuda"])
@pytest.mark.parametrize("layout", ["system-major", "interleaved"])
@pytest.mark.parametrize("k", KS)
def test_plan_executor_matches_reference(k, layout, backend, dtype):
    fused = jax_fuse_ragged([s[:4] for s in _systems(SIZES, dtype, seed=k)])
    want, jt = jplan.PlanExecutor(layout=layout).execute(jplan.build_plan(SIZES, 10, num_chunks=k), *fused[:4])
    ex = PlanExecutor(backend, device="cpu", layout=layout)
    plan = tplan.build_plan(SIZES, 10, num_chunks=k)
    assert ex.resolved_layout(plan) == layout
    got, timing = ex.execute(plan, *fused[:4])
    assert timing.num_chunks == jt.num_chunks == plan.num_chunks
    assert timing.n == jt.n == sum(SIZES)
    _check(got, want, dtype)


@pytest.mark.parametrize("k", KS)
def test_plan_executor_matches_oracle_and_its_phases_add_up(k):
    systems = _systems(SIZES, np.float64, seed=20)
    fused = jax_fuse_ragged([s[:4] for s in systems])
    x, t = PlanExecutor("cuda", device="cpu").execute(tplan.build_plan(SIZES, 10, num_chunks=k), *fused[:4])
    for xi, s in zip(split_ragged(x, SIZES), systems):
        assert_allclose_by_dtype(xi, s[4], np.float64)
    assert min(t.phases) > 0 and t.t_total_ms == pytest.approx(sum(t.phases), rel=1e-6)


@pytest.mark.parametrize("k", KS)
@pytest.mark.parametrize("dtype", DTYPES)
def test_plan_executor_takes_stacked_operands_as_reference(dtype, k):
    ops = make_diag_dominant_system(120, seed=k, batch=(2, 3), dtype=dtype)
    want, _ = jplan.PlanExecutor().execute(jplan.build_plan(120, 10, num_chunks=k), *ops[:4])
    got, _ = PlanExecutor("cuda", device="cpu").execute(tplan.build_plan(120, 10, num_chunks=k), *ops[:4])
    _check(got, want, dtype)
    _check(got, ops[4], dtype)


def test_staged_chunk_count_does_not_change_the_answer_bitwise():
    """Each chunk gets its left neighbour's interface value exactly, and the
    reduced solve sees the same rows whatever the chunking: 1, 2 and 8
    chunks agree bit for bit."""
    dl, d, du, b, _ = make_diag_dominant_system(400, seed=9)
    ex = PlanExecutor("cuda", device="cpu")
    one, _ = ex.execute(tplan.build_plan(400, 10, num_chunks=1), dl, d, du, b)
    for k in (2, 8):
        np.testing.assert_array_equal(ex.execute(tplan.build_plan(400, 10, num_chunks=k), dl, d, du, b)[0], one)


def test_plan_executor_rejects_bad_operands():
    dl, d, du, b, _ = make_diag_dominant_system(40, seed=1)
    ex = PlanExecutor(device="cpu")
    with pytest.raises(ValueError, match="rows"):
        ex.execute(tplan.build_plan(50, 10), dl, d, du, b)
    with pytest.raises(ValueError, match="shapes"):
        ex.execute(tplan.build_plan(40, 10), dl[:30], d[:30], du, b)
    with pytest.raises(TypeError, match="floating"):
        ex.execute(tplan.build_plan(40, 10), *(np.ones(40, np.int64) for _ in range(4)))
    with pytest.raises(ValueError, match="layout"):
        PlanExecutor(device="cpu", layout="lane-major")
    with pytest.raises(ValueError, match="interleaved"):
        PlanExecutor(device="cpu", layout="interleaved").execute(
            tplan.build_plan(40, 10), *make_diag_dominant_system(40, seed=2, batch=(2,))[:4]
        )


def test_chunk_timing_has_the_reference_fields():
    assert [f.name for f in dataclasses.fields(ChunkTiming)] == [
        f.name for f in dataclasses.fields(jplan.ChunkTiming)
    ]


# ----------------------------------------------------------- timed verbs --
def _inputs(verb, dtype):
    if verb == "solve":
        return make_diag_dominant_system(600, seed=1, dtype=dtype)[:4]
    if verb == "batched":
        return make_diag_dominant_system(150, seed=2, batch=(4,), dtype=dtype)[:4]
    return [make_diag_dominant_system(n, seed=n, dtype=dtype)[:4] for n in SIZES]


def _timed(session, verb, ops):
    if verb == "solve":
        return session.solve_timed(*ops)
    if verb == "batched":
        return session.solve_batched_timed(*ops)
    return session.solve_many_timed(ops)


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("dispatch", ["auto", "staged", "fused"])
@pytest.mark.parametrize("verb", ["solve", "batched", "many"])
def test_timed_verbs_match_jax_session(verb, dispatch, dtype):
    ops = _inputs(verb, dtype)
    with japi.TridiagSession(japi.SolverConfig(m=10, num_chunks=3, dispatch=dispatch)) as js:
        want, jt = _timed(js, verb, ops)
    with _session(dispatch) as s:
        got, timing = _timed(s, verb, ops)
    assert isinstance(timing, ChunkTiming) and timing.num_chunks == jt.num_chunks == 3
    assert timing.t_total_ms > 0
    if dispatch == "fused":
        assert timing.phases == (0.0, 0.0, 0.0) == jt.phases
    else:
        assert min(timing.phases) > 0 and min(jt.phases) > 0
    _check(got, want, dtype)


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("verb", ["solve", "batched", "many", "submit"])
def test_staged_dispatch_serves_every_verb(verb, dtype):
    ops = _inputs(verb, dtype)
    jcfg = japi.SolverConfig(m=10, num_chunks=3, dispatch="staged", max_batch=len(SIZES))
    with japi.TridiagSession(jcfg) as js, _session("staged") as s:
        assert s._pick_executor(timed=False) is s._staged
        if verb == "solve":
            got, want = s.solve(*ops), js.solve(*ops)
        elif verb == "batched":
            got, want = s.solve_batched(*ops), js.solve_batched(*ops)
        elif verb == "many":
            got, want = s.solve_many(ops), js.solve_many(ops)
        else:
            futs = [s.submit(SolveRequest(i, *o)) for i, o in enumerate(ops)]
            got = [f.result(timeout=60) for f in futs]
            jfuts = [js.submit(japi.SolveRequest(i, *o)) for i, o in enumerate(ops)]
            want = [f.result(timeout=60) for f in jfuts]
            assert s.stats["per_batch"][0]["layout"] == "system-major"
    _check(got, want, dtype)


def test_timed_verbs_leave_torch_operands_untouched():
    ops = _inputs("batched", np.float64)
    tensors = [torch.from_numpy(a.copy()) for a in ops]
    before = [t.clone() for t in tensors]
    with _session() as s:
        x, _ = s.solve_batched_timed(*tensors)
        y, _ = s.solve_timed(*tensors)
    x_true = make_diag_dominant_system(150, seed=2, batch=(4,))[4]
    _check(x, x_true, np.float64)
    _check(y, x_true, np.float64)
    for t, b in zip(tensors, before):
        assert torch.equal(t, b)


def test_timed_verbs_in_the_interleaved_layout_match_jax():
    ops = make_diag_dominant_system(100, seed=5, batch=(33,))[:4]
    jcfg = japi.SolverConfig(m=10, num_chunks=2, layout="interleaved")
    with japi.TridiagSession(jcfg) as js, _session(num_chunks=2, layout="interleaved") as s:
        want, _ = js.solve_batched_timed(*ops)
        got, timing = s.solve_batched_timed(*ops)
        assert s._staged.resolved_layout(s.plan_for((100,) * 33)) == "interleaved"
    assert min(timing.phases) > 0
    _check(got, want, np.float64)


# -------------------------------------------------------------- threading --
def test_staged_session_hammered_from_threads():
    """Six threads share one staged session (its executor and the plan
    cache) with timed, plain and served calls at once; every answer stays
    right."""
    ops = _inputs("solve", np.float64)
    x_true = make_diag_dominant_system(600, seed=1)[4]
    many = _inputs("many", np.float64)
    errors = []
    n_threads = 6
    barrier = threading.Barrier(n_threads)
    with _session("staged", max_batch=4, max_wait_ms=2.0) as s:

        def worker(tid):
            try:
                barrier.wait()
                for i in range(4):
                    if tid % 3 == 0:
                        x, t = s.solve_timed(*ops)
                        assert t.num_chunks == 3
                    elif tid % 3 == 1:
                        x = s.submit(SolveRequest(1000 * tid + i, *ops)).result(timeout=60)
                    else:
                        xs, _ = s.solve_many_timed(many)
                        for xi, o in zip(xs, many):
                            assert xi.shape == o[1].shape
                        x = s.solve(*ops)
                    assert_allclose_by_dtype(x, x_true, np.float64)
            except Exception as e:  # pragma: no cover - surfaced by the assert
                errors.append(e)

        threads = [threading.Thread(target=worker, args=(t,)) for t in range(n_threads)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=120)
        assert not any(t.is_alive() for t in threads)
    assert not errors, errors
