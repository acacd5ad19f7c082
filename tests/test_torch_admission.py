"""Predicted-latency admission in the port, against the JAX package's, on
the CPU (the port of the predicted-admission tests of
``tests/test_serving_faults.py``).

A planted ``LatencyModel`` makes every prediction known in advance: a
request whose predicted solve ends past its deadline is shed before any
dispatch, batches are packed to the ``max_predicted_ms`` budget (never below
one request), and every observation carries the prediction it was priced
with. Where the engine packs, the reference engine runs the same queue and
its batches and answers are the port's.
"""

import numpy as np
import pytest

from repro.core.tridiag import ensure_x64

ensure_x64()

import repro.api as japi  # noqa: E402  (before repro.telemetry: import-order cycle)
from repro.core.tridiag.reference import make_diag_dominant_system, thomas_numpy  # noqa: E402
from repro_torch.api import (  # noqa: E402
    AdmissionPolicy,
    FusedExecutor,
    LatencyModel,
    PredictedTimeoutError,
    RequestTimedOutError,
    SolveEngine,
    SolveRequest,
    SolverConfig,
    TridiagSession,
)
from repro_torch.kernels.common import assert_allclose_by_dtype  # noqa: E402


def _sys(n, seed):
    return make_diag_dominant_system(n, seed=seed)[:4]


class CountingExecutor:
    """Counts the dispatches that reach the session's executor."""

    def __init__(self, inner):
        self.inner = inner
        self.calls = 0

    def __getattr__(self, name):
        return getattr(self.inner, name)

    def execute(self, plan, *operands):
        self.calls += 1
        return self.inner.execute(plan, *operands)


def _planted_model(pred_ms):
    """A latency model predicting a constant ``pred_ms`` for every batch."""
    return LatencyModel(coef=(float(pred_ms), 0.0, 0.0), samples=1)


def _cpu_session(**kw):
    return TridiagSession(SolverConfig(m=10, device="cpu", **kw))


def test_predicted_shed_fires_before_dispatch():
    """A queued request whose predicted completion passes its own deadline
    is shed with PredictedTimeoutError before any dispatch touches it."""
    session = _cpu_session(max_batch=64, max_wait_ms=50.0, max_predicted_ms=50.0)
    try:
        counting = CountingExecutor(session._engine._executor)
        session._engine._executor = counting
        # Every solve is predicted to take 1000 ms; a 100 ms deadline is
        # structurally unmeetable.
        session._engine.set_latency_model(_planted_model(1000.0))
        fut = session.submit(SolveRequest(0, *_sys(60, 0), timeout_ms=100.0))
        err = fut.exception(timeout=10.0)
        assert isinstance(err, PredictedTimeoutError)
        assert isinstance(err, RequestTimedOutError)  # deadline-aware callers
        assert counting.calls == 0  # shed before dispatch, never executed
        st = session.stats
        assert st["shed_predicted"] == 1
        assert st["timed_out"] == 1
        assert st["batches"] == 0
        # A deadline-free request on the same session still serves.
        dl, d, du, b = _sys(60, 1)
        f2 = session.submit(SolveRequest(1, dl, d, du, b))
        assert_allclose_by_dtype(f2.result(timeout=10.0), thomas_numpy(dl, d, du, b), np.float64)
        assert counting.calls == 1
    finally:
        session.close()


def test_predicted_shed_needs_the_budget_knob():
    """Without max_predicted_ms the model is advisory only: nothing is shed."""
    session = _cpu_session(max_batch=1)
    try:
        session._engine.set_latency_model(_planted_model(1000.0))
        dl, d, du, b = _sys(60, 0)
        fut = session.submit(SolveRequest(0, dl, d, du, b, timeout_ms=60_000.0))
        assert_allclose_by_dtype(fut.result(timeout=10.0), thomas_numpy(dl, d, du, b), np.float64)
        assert session.stats["shed_predicted"] == 0
        assert not session.telemetry.enabled  # nothing reads it: collection off
    finally:
        session.close()


def _engines(max_batch, max_predicted_ms, model_coef):
    """The port's engine and the reference's, on the same admission policy
    and planted latency model, each delivering into its own dicts."""
    port_done, port_failed, ref_done, ref_failed = {}, {}, {}, {}
    port = SolveEngine(
        executor=FusedExecutor("reference", device="cpu"),
        m=10,
        admission=AdmissionPolicy(max_batch=max_batch, max_wait_ms=0.0),
        max_predicted_ms=max_predicted_ms,
        on_result=port_done.__setitem__,
        on_error=port_failed.__setitem__,
    )
    port.set_latency_model(LatencyModel(coef=model_coef, samples=1))
    ref = japi.SolveEngine(
        m=10,
        admission=japi.AdmissionPolicy(max_batch=max_batch, max_wait_ms=0.0),
        max_predicted_ms=max_predicted_ms,
        on_result=ref_done.__setitem__,
        on_error=ref_failed.__setitem__,
    )
    ref.set_latency_model(japi.LatencyModel(coef=model_coef, samples=1))
    return (port, port_done, port_failed), (ref, ref_done, ref_failed)


@pytest.mark.parametrize("drive", ["poll", "flush"])
def test_budget_packs_batches_and_defers_the_rest(drive):
    """Predicted latency eff/3 ms and a 50 ms budget: a 6-deep queue of
    60-element systems (one 20 ms, two 40, three 60) packs 2 per dispatch,
    in admission order, and everything is served, as in the reference."""
    systems = {rid: _sys(60, rid) for rid in range(6)}
    runs = _engines(64, 50.0, (0.0, 1.0 / 3.0, 0.0))
    for (eng, _, _), request in zip(runs, (SolveRequest, japi.SolveRequest)):
        for rid, s in systems.items():
            eng.submit(request(rid, *s))
        if drive == "poll":
            while eng.pending():
                eng.poll()
        else:
            eng.flush()
    (port, done, failed), (ref, ref_done, ref_failed) = runs
    assert failed == {} and ref_failed == {}
    assert sorted(done) == list(range(6))
    for rid, (dl, d, du, b) in systems.items():
        assert_allclose_by_dtype(done[rid], thomas_numpy(dl, d, du, b), np.float64)
        assert_allclose_by_dtype(done[rid], ref_done[rid], np.float64)
    st = port.stats_snapshot()
    assert [pb["systems"] for pb in st["per_batch"]] == [2, 2, 2]
    assert [pb["sizes"] for pb in st["per_batch"]] == [
        tuple(pb["sizes"]) for pb in ref.stats_snapshot()["per_batch"]
    ]
    # Packing defers, it never sheds: every request was served.
    assert st["shed_predicted"] == 0 and st["timed_out"] == 0


def test_solo_over_budget_request_still_dispatches():
    """_pack_by_budget always keeps one request, or an over-budget request
    would starve the queue."""
    (port, done, failed), (ref, ref_done, _) = _engines(8, 1.0, (100.0, 0.0, 0.0))
    for rid in (0, 1):
        port.submit(SolveRequest(rid, *_sys(60, rid)))
        ref.submit(japi.SolveRequest(rid, *_sys(60, rid)))
    while port.pending():
        port.poll()
    while ref.pending():
        ref.poll()
    assert sorted(done) == [0, 1] and failed == {}
    # Each rode alone: the budget trimmed every batch to the floor of one.
    assert [pb["systems"] for pb in port.stats_snapshot()["per_batch"]] == [1, 1]
    assert [pb["systems"] for pb in ref.stats_snapshot()["per_batch"]] == [1, 1]
    for rid in (0, 1):
        assert_allclose_by_dtype(done[rid], ref_done[rid], np.float64)


def test_dispatch_records_predicted_and_residual():
    """With a model installed and telemetry on, every observation carries
    the pre-dispatch prediction, so residuals are observable."""
    session = _cpu_session(max_batch=2, max_wait_ms=5.0, max_predicted_ms=500.0)
    try:
        session._engine.set_latency_model(_planted_model(7.5))
        futs = [session.submit(SolveRequest(rid, *_sys(60, rid))) for rid in (0, 1)]
        for f in futs:
            f.result(timeout=10.0)
        snap = session.telemetry.snapshot()
        assert len(snap) >= 1
        for o in snap:
            assert o.predicted_ms == 7.5
            assert o.residual_ms == pytest.approx(o.latency_ms - 7.5)
            assert (o.backend, o.dispatch) == ("reference", "fused")
    finally:
        session.close()
