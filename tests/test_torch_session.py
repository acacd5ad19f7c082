"""The port's session front door against the JAX package's, on the CPU.

Every verb runs in both packages on the same numpy inputs (made from a
seed) and is compared at the tolerance ladder; the serving layer's
admission errors are checked on the port alone.
"""

import functools
import math
import threading

import numpy as np
import pytest
import torch

from repro.core.tridiag import ensure_x64

ensure_x64()

import repro.api as japi  # noqa: E402  (before repro.telemetry: import-order cycle)
from repro.core.tridiag.reference import make_diag_dominant_system  # noqa: E402
from repro_torch.api import (  # noqa: E402
    AdmissionPolicy,
    FixedChunkPolicy,
    FusedExecutor,
    QueueFullError,
    RequestCancelledError,
    RequestTimedOutError,
    SolveEngine,
    SolveRequest,
    SolverConfig,
    TridiagSession,
)
from repro_torch.kernels.common import assert_allclose_by_dtype  # noqa: E402

DTYPES = [np.float32, np.float64]
KS = [1, 3, 8]
RAGGED = (40, 300, 120, 10, 70)


def _inputs(verb, dtype):
    if verb == "solve":
        return make_diag_dominant_system(600, seed=1, dtype=dtype)[:4]
    if verb in ("stacked", "batched"):
        return make_diag_dominant_system(150, seed=2, batch=(4,), dtype=dtype)[:4]
    return [make_diag_dominant_system(n, seed=n, dtype=dtype)[:4] for n in RAGGED]


@functools.lru_cache(maxsize=None)
def _jax_result(verb, dtype):
    with japi.TridiagSession(japi.SolverConfig(m=10, max_batch=len(RAGGED))) as s:
        ops = _inputs(verb, dtype)
        if verb in ("solve", "stacked"):
            return s.solve(*ops)
        if verb == "batched":
            return s.solve_batched(*ops)
        if verb == "many":
            return s.solve_many(ops)
        futs = [s.submit(japi.SolveRequest(i, *o)) for i, o in enumerate(ops)]
        return [f.result(timeout=60) for f in futs]


def _session(k, **kw):
    return TridiagSession(SolverConfig(m=10, num_chunks=k, device="cpu", **kw))


def _check(got, want, dtype):
    if isinstance(want, list):
        assert len(got) == len(want)
        for g, w in zip(got, want):
            _check(g, w, dtype)
        return
    assert isinstance(got, np.ndarray) and got.dtype == np.dtype(dtype)
    assert got.shape == np.asarray(want).shape
    assert_allclose_by_dtype(got, np.asarray(want), dtype)


# ------------------------------------------------------------ verb parity --
@pytest.mark.parametrize("k", KS)
@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("verb", ["solve", "stacked", "batched", "many", "submit"])
def test_verbs_match_jax_session(verb, dtype, k):
    ops = _inputs(verb, dtype)
    with _session(k, max_batch=len(RAGGED)) as s:
        assert s.backend.name == "reference"  # "auto" on the CPU
        if verb in ("solve", "stacked"):
            got = s.solve(*ops)
        elif verb == "batched":
            got = s.solve_batched(*ops)
        elif verb == "many":
            got = s.solve_many(ops)
        else:
            futs = [s.submit(SolveRequest(i, *o)) for i, o in enumerate(ops)]
            got = [f.result(timeout=60) for f in futs]
            assert s.stats["per_batch"][0]["systems"] == len(RAGGED)
    _check(got, _jax_result(verb, dtype), dtype)


@pytest.mark.parametrize("dtype", DTYPES)
def test_kernel_backend_on_cpu_matches_jax_session(dtype):
    """backend="cuda" on CPU tensors runs each wrapper's plain version."""
    with _session(3, backend="cuda") as s:
        assert s.backend.name == "cuda"
        _check(s.solve_many(_inputs("many", dtype)), _jax_result("many", dtype), dtype)


@pytest.mark.parametrize("k", KS)
@pytest.mark.parametrize("dtype", DTYPES)
def test_kernel_backend_takes_several_leading_dims(dtype, k):
    """(K1, K2, n) operands solve alike on both backends: the executor
    flattens the leading dims to one batch axis for the kernel wrappers."""
    ops = make_diag_dominant_system(120, seed=k, batch=(2, 3), dtype=dtype)
    with _session(k, backend="cuda") as kern, _session(k, backend="reference") as ref:
        got = kern.solve(*ops[:4])
        _check(got, ref.solve(*ops[:4]), dtype)
    _check(got, ops[4], dtype)


def test_config_dtype_casts_in_and_out():
    ops = _inputs("solve", np.float64)
    with _session(2, dtype=np.float32, max_batch=1) as s:
        x = s.solve(*ops)
        assert x.dtype == np.float32
        futs = s.submit(SolveRequest(0, *ops))
        assert futs.result(timeout=30).dtype == np.float32
    assert_allclose_by_dtype(x, _jax_result("solve", np.float32), np.float32)


def test_torch_operands_are_accepted_and_left_untouched():
    ops = _inputs("batched", np.float64)
    tensors = [torch.from_numpy(a.copy()) for a in ops]
    before = [t.clone() for t in tensors]
    with _session(3) as s:
        x = s.solve_batched(*tensors)
        y = s.solve(*tensors)
    _check(x, _jax_result("batched", np.float64), np.float64)
    _check(y, _jax_result("stacked", np.float64), np.float64)
    for t, b in zip(tensors, before):
        assert torch.equal(t, b)


def test_policy_session_matches_fixed_pick():
    ops = _inputs("solve", np.float64)
    with _session(None, policy=FixedChunkPolicy(4)) as s:
        assert s.plan_for(600).num_chunks == 4
        _check(s.solve(*ops), _jax_result("solve", np.float64), np.float64)


# --------------------------------------------------------------- config --
@pytest.mark.parametrize("field,value", [("mesh", 2)])
def test_unported_fields_raise_naming_the_roadmap(field, value):
    """The field the port once refused (``mesh``) is ported: a count of 2
    validates like the reference's, raising ``ValueError`` naming the
    visible devices where fewer than 2 CUDA devices are visible."""
    if torch.cuda.device_count() >= 2:
        pytest.skip("2 CUDA devices are visible; mesh=2 is a valid spec here")
    with pytest.raises(ValueError, match="visible"):
        SolverConfig(device="cpu", **{field: value}).validate()


@pytest.mark.parametrize(
    "kw,error",
    [
        ({"autotune": "on"}, "autotune"),
        ({"autotune": "live", "telemetry_capacity": 0}, "telemetry"),
        ({"refit_min_samples": 0}, "refit_min_samples"),
        ({"refit_interval_s": -1.0}, "refit_interval_s"),
        ({"max_predicted_ms": 0.0}, "max_predicted_ms"),
        ({"autotune": "shadow", "max_predicted_ms": 5.0}, None),
        ({"autotune": "live", "telemetry_capacity": 16, "refit_min_samples": 8,
          "refit_interval_s": 1.0}, None),
        ({"telemetry_capacity": 0, "max_predicted_ms": 5.0}, None),
    ],
)
def test_closed_loop_fields_validate_as_the_reference(kw, error):
    """The closed loop's knobs validate as in the reference: the same field
    is named on the same bad value, and a good config builds a session."""
    if error is None:
        japi.SolverConfig(**kw).validate()
        with TridiagSession(SolverConfig(device="cpu", **kw)) as s:
            assert s.telemetry.enabled == (kw.get("telemetry_capacity", 1) > 0)
        return
    with pytest.raises(ValueError, match=error):
        japi.SolverConfig(**kw).validate()
    with pytest.raises(ValueError, match=error):
        SolverConfig(device="cpu", **kw).validate()


@pytest.mark.parametrize(
    "kw",
    [
        {"m": 1},
        {"dtype": np.int32},
        {"backend": "pallas"},
        {"device": "tpu"},
        {"num_chunks": 0},
        {"num_chunks": 2, "policy": FixedChunkPolicy(2)},
        {"max_batch": 0},
        {"max_queue": 0},
        {"dispatch": "bogus"},
    ],
)
def test_invalid_config_is_rejected(kw):
    with pytest.raises((ValueError, TypeError)):
        SolverConfig(**{"device": "cpu", **kw}).validate()


def test_config_defaults_and_replace():
    cfg = SolverConfig()
    assert (cfg.m, cfg.backend, cfg.dispatch, cfg.layout, cfg.device) == (10, "auto", "auto", "auto", "cuda")
    jcfg = japi.SolverConfig()
    for f in ("m", "dtype", "backend", "dispatch", "layout", "max_batch", "max_wait_ms", "max_queue"):
        assert getattr(cfg, f) == getattr(jcfg, f), f
    assert cfg.replace(num_chunks=4).num_chunks == 4 and cfg.num_chunks is None


# -------------------------------------------------------------- serving --
def test_queue_full_raises_and_try_submit_sheds():
    ops = _inputs("solve", np.float64)
    with _session(1, max_batch=8, max_queue=2) as s:
        f0 = s.submit(SolveRequest(0, *ops))
        s.submit(SolveRequest(1, *ops))
        with pytest.raises(QueueFullError):
            s.submit(SolveRequest(2, *ops))
        assert s.try_submit(SolveRequest(3, *ops)) is None
        assert s.stats["rejected"] == 2
    assert f0.result(timeout=30).shape == (600,)


def test_request_timeout_sheds_before_dispatch():
    ops = _inputs("solve", np.float64)
    with _session(1, max_batch=8) as s:
        fut = s.submit(SolveRequest(0, *ops, timeout_ms=1.0))
        with pytest.raises(RequestTimedOutError):
            fut.result(timeout=30)
        assert s.stats["timed_out"] == 1


def test_cancel_removes_a_queued_request():
    ops = _inputs("solve", np.float64)
    with _session(1, max_batch=8) as s:
        keep = s.submit(SolveRequest(0, *ops))
        gone = s.submit(SolveRequest(1, *ops))
        assert gone.cancel() and gone.cancelled()
        with pytest.raises(RequestCancelledError):
            gone.result(timeout=5)
    assert keep.result(timeout=30).shape == (600,)
    assert not keep.cancel()


def test_priority_orders_admission():
    engine = SolveEngine(
        executor=FusedExecutor(device="cpu"),
        on_result=lambda rid, x: None,
        on_error=lambda rid, e: None,
        m=10,
        admission=AdmissionPolicy(max_batch=1),
    )
    ops = _inputs("solve", np.float64)
    for rid, prio in ((0, 0), (1, 5), (2, 1), (3, 5)):
        engine.submit(SolveRequest(rid, *ops, priority=prio))
    order = []
    while (group := engine.take_due_group(0.0)) is not None:
        order += [p.req.rid for p in group]
    assert order == [1, 3, 2, 0]


def test_dispatch_failure_fails_only_that_batch():
    ops = _inputs("solve", np.float64)
    with _session(1, max_batch=1) as s:
        real = s._fused.execute
        calls = {"n": 0}

        def flaky(*args):
            calls["n"] += 1
            if calls["n"] == 1:
                raise RuntimeError("injected")
            return real(*args)

        s._fused.execute = flaky
        bad = s.submit(SolveRequest(0, *ops))
        with pytest.raises(RuntimeError, match="injected"):
            bad.result(timeout=30)
        good = s.submit(SolveRequest(1, *ops))
        assert good.result(timeout=30).shape == (600,)
        assert s.stats["failed"] == 1


def test_deadline_dispatches_a_partial_batch_without_polling():
    ops = _inputs("solve", np.float64)
    with _session(1, max_batch=64, max_wait_ms=5.0) as s:
        futs = [s.submit(SolveRequest(i, *ops)) for i in range(3)]
        for f in futs:
            assert f.result(timeout=30).shape == (600,)
        assert s.stats["per_batch"][0]["systems"] <= 3


def test_submit_validation_and_lifecycle():
    ops = _inputs("solve", np.float64)
    s = _session(1, max_batch=8)
    with pytest.raises(ValueError, match="divisible"):
        s.submit(SolveRequest(0, *(a[:-5] for a in ops)))
    with pytest.raises(ValueError, match="du"):
        s.submit(SolveRequest(0, ops[0], ops[1], ops[2][:-1], ops[3]))
    s.submit(SolveRequest(7, *ops))
    with pytest.raises(ValueError, match="already in flight"):
        s.submit(SolveRequest(7, *ops))
    s.close()
    s.close()  # idempotent
    assert s.pending() == 0
    with pytest.raises(RuntimeError, match="closed"):
        s.submit(SolveRequest(8, *ops))
    assert "closed" in repr(s)


def test_concurrent_submitters_all_resolve():
    ops = _inputs("solve", np.float64)
    want = _jax_result("solve", np.float64)
    results, errors = {}, []
    with _session(3, max_batch=4, max_wait_ms=2.0) as s:

        def client(base):
            try:
                futs = [(base + i, s.submit(SolveRequest(base + i, *ops))) for i in range(5)]
                for rid, f in futs:
                    results[rid] = f.result(timeout=60)
            except Exception as e:  # pragma: no cover - surfaced by the assert
                errors.append(e)

        threads = [threading.Thread(target=client, args=(100 * t,)) for t in range(4)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=60)
        assert not any(t.is_alive() for t in threads)
    assert not errors and len(results) == 20
    for x in results.values():
        assert_allclose_by_dtype(x, want, np.float64)
    assert math.isclose(sum(b["systems"] for b in s.stats["per_batch"]), 20)


@pytest.mark.parametrize("dtype", DTYPES)
def test_auto_layout_matches_jax_interleaved(dtype):
    """At B >= the interleave threshold the port's layout="auto" resolves to
    interleaved for solve_batched, as the reference's does, and agrees with
    an explicitly interleaved JAX session at the tolerance ladder."""
    from repro.core.tridiag.layout import AUTO_INTERLEAVE_MIN_BATCH
    from repro.core.tridiag.layout import resolve_layout as jax_resolve_layout

    ops = make_diag_dominant_system(100, seed=21, batch=(AUTO_INTERLEAVE_MIN_BATCH,), dtype=dtype)[:4]
    jcfg = japi.SolverConfig(m=10, num_chunks=2, layout="interleaved")
    want = japi.TridiagSession(jcfg).solve_batched(*ops)
    with _session(2) as s:
        plan = s.plan_for((100,) * AUTO_INTERLEAVE_MIN_BATCH)
        want_layout = jax_resolve_layout("auto", plan.sizes, 10, fused=True)
        assert s._fused.resolved_layout(plan) == want_layout == "interleaved"
        _check(s.solve_batched(*ops), want, dtype)
