"""The port's closed loop (`repro_torch.telemetry`) against the JAX package's
(`repro.telemetry`), on the CPU.

The port of ``tests/test_telemetry.py``: the observation ring, the Eq. 5
dataset rebuilt from totals-only telemetry, the Eq.-2-shaped
``LatencyModel``, the gated refitter and the session's wiring. Wherever a fit
is asserted on, the observations are synthetic and fed to both packages, so
the port's rows, refit picks and latency coefficients are held to the
reference's on the same inputs.
"""

import json
import math
import time

import numpy as np
import pytest

from repro.core.tridiag import ensure_x64

ensure_x64()

import repro.api as japi  # noqa: E402  (before repro.telemetry: import-order cycle)
from repro.core.streams.simulator import StreamSimulator as JaxSimulator  # noqa: E402
from repro.core.tridiag.plan import price_chunks as jax_price_chunks  # noqa: E402
from repro.core.tridiag.reference import make_diag_dominant_system  # noqa: E402
from repro.telemetry.refit import dataset_from_observations as jax_dataset  # noqa: E402
from repro_torch.api import (  # noqa: E402
    AUTOTUNE_MODES,
    BatchObservation,
    LatencyModel,
    OnlineRefitter,
    SolveRequest,
    SolverConfig,
    TelemetryBuffer,
    TridiagSession,
)
from repro_torch.core.autotune.heuristic import fit_stream_heuristic  # noqa: E402
from repro_torch.core.streams.simulator import StreamSimulator  # noqa: E402
from repro_torch.core.streams.timemodel import overhead_from_measurement  # noqa: E402
from repro_torch.core.tridiag.plan import price_chunks  # noqa: E402
from repro_torch.telemetry.refit import (  # noqa: E402
    DEFAULT_OVERLAP_FRACTION,
    dataset_from_observations,
)

TOL = 1e-12
PROBE_SIZES = [(1000,), (2000,), (2000, 2000), (4000,), (8000, 8000), (16000,), (50_000,), (1_000_000,)]


def obs(size, k, latency_ms, *, t=0.0, batch=1, predicted=None):
    """One synthetic same-size observation (batch systems of ``size``)."""
    return BatchObservation(
        t=t,
        sizes=(size,) * batch,
        num_chunks=k,
        backend="reference",
        layout="system-major",
        dispatch="fused",
        latency_ms=latency_ms,
        mean_wait_ms=0.1,
        max_wait_ms=0.2,
        predicted_ms=predicted,
    )


def streams_help_observations(sizes=(2000, 4000, 8000, 16000), ks=(1, 2, 4, 8), reps=3):
    """A synthetic machine where chunking clearly pays.

    Serial latency ``t_non = 1e-3·n`` ms, half of it overlappable; k chunks
    recover ``(k-1)/k`` of the overlappable half less a small log-in-k
    overhead, so the Eq. 6 gain grows with k at every size and a refit
    heuristic must pick k > 1.
    """
    out = []
    t = 0.0
    for n in sizes:
        t_non = 1e-3 * n
        s = 0.5 * t_non
        for k in ks:
            if k == 1:
                lat = t_non
            else:
                L = math.log2(k)
                lat = t_non - (k - 1) / k * s + 0.02 * L + 0.005 * L * L
            for _ in range(reps):
                out.append(obs(n, k, lat, t=t))
                t += 0.01
    return out


def _jax_twin(observations):
    """The same observations as the reference package's records."""
    return [japi.BatchObservation(**o.__dict__) for o in observations]


def _assert_rows_equal(port, ref):
    assert len(port) == len(ref)
    for a, b in zip(port.rows, ref.rows):
        assert a.keys() == b.keys()
        for key in a:
            if isinstance(a[key], float):
                assert a[key] == pytest.approx(b[key], rel=TOL, abs=TOL), key
            else:
                assert a[key] == b[key], key


def _noisy_observations(seed):
    """A noisier synthetic window (ragged and batched compositions too)."""
    rng = np.random.default_rng(seed)
    out = []
    for n in (1000, 3000, 9000, 27_000):
        for k in (1, 2, 4, 8, 16):
            for batch in (1, 2):
                lat = 1e-3 * n * batch * (0.5 + 0.5 / k) + 0.03 * math.log2(k)
                out.append(obs(n, k, lat * (1 + 0.05 * rng.standard_normal()), batch=batch))
    return out


class FakeClock:
    def __init__(self, t=0.0):
        self.t = t

    def __call__(self):
        return self.t


# ------------------------------------------------------------------- ring --
def test_ring_bounds_window_and_counts_drops():
    buf = TelemetryBuffer(capacity=4)
    for i in range(6):
        assert buf.record(obs(100, 1, 1.0, t=float(i)))
    assert len(buf) == 4
    snap = buf.snapshot()
    # Oldest two fell off the far end, newest four remain in order.
    assert [o.t for o in snap] == [2.0, 3.0, 4.0, 5.0]
    assert buf.counters() == {"recorded": 6, "dropped": 2, "buffered": 4}


def test_ring_capacity_zero_disables_collection():
    buf = TelemetryBuffer(capacity=0)
    assert not buf.enabled
    assert buf.record(obs(100, 1, 1.0)) is False
    assert buf.counters() == {"recorded": 0, "dropped": 0, "buffered": 0}
    with pytest.raises(ValueError, match="capacity"):
        TelemetryBuffer(capacity=-1)


def test_ring_clear_keeps_lifetime_counters():
    buf = TelemetryBuffer(capacity=8)
    for _ in range(3):
        buf.record(obs(100, 1, 1.0))
    assert buf.clear() == 3
    assert len(buf) == 0
    assert buf.counters()["recorded"] == 3


def test_ring_jsonl_roundtrip_matches_reference(tmp_path):
    buf, ref = TelemetryBuffer(capacity=8), japi.TelemetryBuffer(capacity=8)
    window = [obs(200, 4, 2.5, t=1.0, batch=2, predicted=2.0), obs(100, 1, 1.25, t=2.0)]
    for o, r in zip(window, _jax_twin(window)):
        buf.record(o)
        ref.record(r)
    path = tmp_path / "observations.jsonl"
    assert buf.export_jsonl(str(path)) == 2
    rows = [json.loads(line) for line in path.read_text().splitlines()]
    assert rows[0]["sizes"] == [200, 200]
    assert rows[0]["batch"] == 2
    assert rows[0]["effective_size"] == 400
    assert rows[0]["num_chunks"] == 4
    assert rows[0]["predicted_ms"] == 2.0
    assert rows[0]["residual_ms"] == pytest.approx(0.5)
    assert rows[1]["predicted_ms"] is None
    assert rows[1]["residual_ms"] is None
    assert buf.to_jsonl().splitlines() == path.read_text().splitlines()
    assert buf.to_jsonl() == ref.to_jsonl()


# ---------------------------------------------------------- latency model --
def test_latency_model_recovers_planted_coefficients():
    rng = np.random.default_rng(0)
    n = rng.integers(100, 10_000, size=64).astype(float)
    k = rng.choice([1, 2, 4, 8], size=64).astype(float)
    y = 0.5 + 1e-3 * n + 0.2 * n / k
    model = LatencyModel.fit(n, k, y)
    assert model.samples == 64
    assert model.coef == pytest.approx((0.5, 1e-3, 0.2), abs=1e-9)
    assert model.predict_ms(1000, 4) == pytest.approx(0.5 + 1.0 + 50.0)
    assert LatencyModel.fit(n, k, y).coef == model.coef  # bit-identical refit
    assert model.coef == pytest.approx(japi.LatencyModel.fit(n, k, y).coef, rel=TOL, abs=TOL)
    assert LatencyModel(coef=(-5.0, 0.0, 0.0)).predict_ms(10, 1) == 0.0  # clamped


def test_latency_model_needs_observations():
    with pytest.raises(ValueError, match="at least one observation"):
        LatencyModel.fit([], [], [])


# -------------------------------------------------- dataset reconstruction --
def test_dataset_reconstruction_matches_eq5_and_the_reference():
    observations = streams_help_observations()
    data = dataset_from_observations(observations)
    assert data is not None
    assert len(data) == 4 * 3  # one row per (size, k > 1) cell with a baseline
    by_cell = {(r["size"], r["num_str"]): r for r in data.rows}
    t_non = 1e-3 * 2000
    row = by_cell[(2000, 4)]
    assert row["t_non_str"] == pytest.approx(t_non)
    assert row["sum"] == pytest.approx(DEFAULT_OVERLAP_FRACTION * t_non)
    assert row["t_overhead"] == pytest.approx(
        overhead_from_measurement(row["t_str"], row["t_non_str"], row["sum"], 4)
    )
    _assert_rows_equal(data, jax_dataset(_jax_twin(observations)))
    noisy = _noisy_observations(3)
    _assert_rows_equal(dataset_from_observations(noisy), jax_dataset(_jax_twin(noisy)))


def test_dataset_skips_sizes_without_serial_baseline():
    observations = streams_help_observations(sizes=(2000, 4000))
    # A size observed only at k > 1 contributes no rows (no Eq. 5 baseline).
    observations += [obs(64_000, 2, 30.0), obs(64_000, 4, 20.0)]
    data = dataset_from_observations(observations)
    assert data is not None
    assert {r["size"] for r in data.rows} == {2000, 4000}
    _assert_rows_equal(data, jax_dataset(_jax_twin(observations)))


def test_dataset_none_when_structurally_thin():
    assert dataset_from_observations(streams_help_observations(sizes=(2000,))) is None
    assert dataset_from_observations(streams_help_observations(ks=(1, 2))) is None
    assert dataset_from_observations([]) is None


# ---------------------------------------------------------------- refitter --
def test_refitter_gates_on_samples_and_staleness():
    clock = FakeClock()
    r = OnlineRefitter("shadow", min_samples=8, interval_s=10.0, clock=clock)
    buf = TelemetryBuffer(capacity=64)
    for o in streams_help_observations(reps=1)[:4]:
        buf.record(o)
    # Below min_samples: not due, and no sleep hint either.
    assert not r.due(len(buf))
    assert r.seconds_until_due(len(buf)) is None
    assert r.maybe_refit(buf) is None
    for o in streams_help_observations(reps=1):
        buf.record(o)
    # Enough samples, never attempted: due at once.
    assert r.due(len(buf))
    assert r.seconds_until_due(len(buf)) == 0.0
    assert r.maybe_refit(buf) is not None
    # Freshly attempted: not due again until interval_s passes.
    assert not r.due(len(buf))
    assert r.seconds_until_due(len(buf)) == pytest.approx(10.0)
    clock.t = 9.9
    assert not r.due(len(buf))
    clock.t = 10.0
    assert r.due(len(buf))


def test_refitter_failed_attempt_resets_staleness():
    # A thin window (one size) refits to nothing, but the attempt still
    # uses up the staleness budget, so the idle worker cannot busy-loop it.
    clock = FakeClock()
    r = OnlineRefitter("shadow", min_samples=2, interval_s=5.0, clock=clock)
    buf = TelemetryBuffer(capacity=64)
    for o in streams_help_observations(sizes=(2000,), reps=1):
        buf.record(o)
    result = r.maybe_refit(buf)
    assert result is not None and result.heuristic is None
    assert not r.due(len(buf))
    stats = r.stats_snapshot()
    assert stats["refit_attempts"] == 1 and stats["refits"] == 0


@pytest.mark.parametrize("window", ["streams_help", "noisy"])
def test_refit_is_deterministic_and_matches_the_reference(window):
    observations = (
        streams_help_observations() if window == "streams_help" else _noisy_observations(5)
    )
    r = OnlineRefitter("live", min_samples=1)
    a = r.refit_from(observations)
    b = r.refit_from(list(observations))
    assert a.heuristic is not None and b.heuristic is not None
    assert a.heuristic.base.sum_model.coef == b.heuristic.base.sum_model.coef
    assert np.array_equal(a.heuristic.base.popt_small, b.heuristic.base.popt_small)
    assert a.latency_model.coef == b.latency_model.coef
    assert a.heuristic.provenance["source"] == "refit"
    assert a.heuristic.provenance["samples"] == len(observations)
    assert a.policy is not None  # live mode ships a ready-to-swap policy
    shadow = OnlineRefitter("shadow", min_samples=1).refit_from(observations)
    assert shadow.heuristic is not None and shadow.policy is None
    # The reference's refit on the same observations: same picks, same
    # latency coefficients.
    ref = japi.OnlineRefitter("live", min_samples=1).refit_from(_jax_twin(observations))
    for sizes in PROBE_SIZES:
        assert price_chunks(a.heuristic, sizes) == jax_price_chunks(ref.heuristic, sizes), sizes
    assert a.latency_model.coef == pytest.approx(ref.latency_model.coef, rel=TOL, abs=TOL)
    assert a.latency_model.samples == ref.latency_model.samples


def test_refit_off_mode_fits_only_the_latency_model():
    result = OnlineRefitter("off", min_samples=1).refit_from(streams_help_observations())
    assert result.heuristic is None and result.policy is None
    assert result.latency_model is not None


def test_offline_fit_provenance_and_picks_match_the_reference():
    data = StreamSimulator().dataset(sizes=(200_000, 400_000), reps=1)
    fitted = fit_stream_heuristic(data)
    assert fitted.provenance == {"source": "offline-fit", "samples": len(data)}
    from repro.core.autotune.heuristic import fit_stream_heuristic as jax_fit

    ref = jax_fit(JaxSimulator().dataset(sizes=(200_000, 400_000), reps=1))
    for sizes in PROBE_SIZES:
        assert price_chunks(fitted, sizes) == jax_price_chunks(ref, sizes), sizes


def test_refitter_rejects_bad_mode():
    assert AUTOTUNE_MODES == ("off", "shadow", "live") == tuple(japi.AUTOTUNE_MODES)
    with pytest.raises(ValueError, match="mode"):
        OnlineRefitter("eager")


def test_refitter_agreement_counters():
    clock = FakeClock()
    r = OnlineRefitter("shadow", min_samples=1, interval_s=0.0, clock=clock)
    buf = TelemetryBuffer(capacity=256)
    for o in streams_help_observations():
        buf.record(o)
    # An active policy that always picks 1 disagrees with the refit on
    # every composition (streams clearly pay here).
    result = r.maybe_refit(buf, pick_active=lambda sizes: 1)
    assert result is not None and result.heuristic is not None
    assert result.agreement == 0.0
    stats = r.stats_snapshot()
    assert stats["pick_disagree"] > 0 and stats["pick_agree"] == 0
    assert stats["agreement_rate"] == 0.0
    # Agreeing with the refit's own picks scores 1.0.
    clock.t += 1.0
    heur = r.last_heuristic()
    result = r.maybe_refit(buf, pick_active=lambda sizes: price_chunks(heur, sizes))
    assert result is not None and result.agreement == 1.0


# -------------------------------------------------- config + session wiring --
def test_config_validates_autotune_fields():
    with pytest.raises(ValueError, match="autotune"):
        SolverConfig(autotune="on", device="cpu").validate()
    with pytest.raises(ValueError, match="telemetry"):
        SolverConfig(autotune="live", telemetry_capacity=0, device="cpu").validate()
    with pytest.raises(ValueError, match="refit_min_samples"):
        SolverConfig(refit_min_samples=0, device="cpu").validate()
    with pytest.raises(ValueError, match="refit_interval_s"):
        SolverConfig(refit_interval_s=-1.0, device="cpu").validate()
    with pytest.raises(ValueError, match="max_predicted_ms"):
        SolverConfig(max_predicted_ms=0.0, device="cpu").validate()
    cfg = SolverConfig(m=10, autotune="shadow", max_predicted_ms=5.0, telemetry_capacity=16,
                       refit_min_samples=8, refit_interval_s=1.0, max_wait_ms=1.0, device="cpu")
    with TridiagSession(cfg) as session:  # validates, and serves
        assert len(_serve_some(session, n_requests=2)) == 2
        assert session.telemetry.capacity == 16


def _serve_some(session, n_requests=3, size=200):
    futs = []
    for i in range(n_requests):
        dl, d, du, b = make_diag_dominant_system(size, seed=i)[:4]
        futs.append(session.submit(SolveRequest(i, dl, d, du, b)))
    return [f.result(timeout=30) for f in futs]


def test_session_off_records_nothing():
    with TridiagSession(SolverConfig(m=10, max_wait_ms=1.0, device="cpu")) as session:
        _serve_some(session)
        assert not session.telemetry.enabled
        assert len(session.telemetry) == 0
        stats = session.stats
    assert stats["autotune"]["mode"] == "off"
    assert stats["autotune"]["observations"] == {"recorded": 0, "dropped": 0, "buffered": 0}


def test_session_records_observations_while_serving():
    cfg = SolverConfig(m=10, max_wait_ms=1.0, autotune="shadow", device="cpu")
    with TridiagSession(cfg) as session:
        _serve_some(session, n_requests=4)
        assert session.telemetry.enabled
        snap = session.telemetry.snapshot()
        assert len(snap) >= 1
        assert all(o.sizes and o.num_chunks >= 1 for o in snap)
        assert all(o.latency_ms > 0 for o in snap)
        assert {o.dispatch for o in snap} == {"fused"}
        assert {o.backend for o in snap} == {"reference"}
        assert {o.layout for o in snap} == {"system-major"}
        assert session.stats["autotune"]["mode"] == "shadow"


def _seeded_session(mode, clock):
    """A session whose refitter runs on a fake clock that never advances,
    with an interval it never reaches: the test's own ``_maybe_refit`` is
    the only refit that fires (the first attempt is always due). The worker
    also calls ``_maybe_refit`` on its idle time; on a real clock at
    interval 0 it would refit again on the batches the test serves, and a
    batch dispatched after such a refit is priced by a heuristic the test
    never saw."""
    cfg = SolverConfig(m=10, max_wait_ms=1.0, autotune=mode, device="cpu")
    refitter = OnlineRefitter(mode, min_samples=1, interval_s=3600.0, clock=clock)
    session = TridiagSession(cfg, refitter=refitter)
    for o in streams_help_observations():
        session.telemetry.record(o)
    return session, refitter


def test_session_live_refit_swaps_chunk_policy():
    """The acceptance loop: seeded observations accumulate, the refit fires
    once due, and the session's picks become the refit heuristic's."""
    clock = FakeClock()
    session, refitter = _seeded_session("live", clock)
    with session:
        sizes = (2000, 2000)
        assert session.plan_for(sizes).num_chunks == 1  # config default
        session._maybe_refit()
        heur = refitter.last_heuristic()
        assert heur is not None
        expected = price_chunks(heur, sizes)
        assert expected > 1  # streams clearly pay on the synthetic machine
        assert session.plan_for(sizes).num_chunks == expected
        # ... and served batches are priced by the swapped policy too.
        _serve_some(session, n_requests=2, size=2000)
        stats = session.stats
        assert stats["per_batch"], "serving recorded no batches"
        for entry in stats["per_batch"]:
            assert entry["num_chunks"] == price_chunks(heur, tuple(entry["sizes"]))
        assert stats["autotune"]["refits"] == 1
        assert stats["autotune"]["last_refit_age_s"] is not None
        # The reference's live refit on the same observations picks alike.
        ref = japi.OnlineRefitter("live", min_samples=1).refit_from(
            _jax_twin(streams_help_observations())
        )
        assert expected == jax_price_chunks(ref.heuristic, sizes)


def test_session_shadow_refit_leaves_picks_untouched():
    clock = FakeClock()
    session, refitter = _seeded_session("shadow", clock)
    with session:
        sizes = (2000, 2000)
        session._maybe_refit()
        assert refitter.last_heuristic() is not None
        # The shadow fit exists, and changed nothing.
        assert session.plan_for(sizes).num_chunks == 1
        _serve_some(session, n_requests=2, size=2000)
        stats = session.stats
        assert all(e["num_chunks"] == 1 for e in stats["per_batch"])
        assert stats["autotune"]["refits"] >= 1
        # The would-be picks disagree with the active (default) pricing.
        assert stats["autotune"]["pick_disagree"] > 0


def test_worker_fires_refit_on_its_own():
    """Driven through serving alone: real observations accumulate and the
    worker's idle loop runs the refit with no help from the test."""
    cfg = SolverConfig(m=10, max_wait_ms=1.0, autotune="shadow", refit_min_samples=1,
                       refit_interval_s=0.0, device="cpu")
    with TridiagSession(cfg) as session:
        _serve_some(session, n_requests=4)
        t0 = time.monotonic()
        while time.monotonic() - t0 < 5.0:
            if session.stats["autotune"]["refit_attempts"] >= 1:
                break
            time.sleep(0.01)
        assert session.stats["autotune"]["refit_attempts"] >= 1


def test_refit_errors_are_counted_not_fatal(monkeypatch):
    clock = FakeClock()
    r = OnlineRefitter("live", min_samples=1, interval_s=0.0, clock=clock)
    buf = TelemetryBuffer(capacity=64)
    for o in streams_help_observations():
        buf.record(o)
    monkeypatch.setattr(r, "refit_from", lambda obs_: (_ for _ in ()).throw(RuntimeError("boom")))
    assert r.maybe_refit(buf) is None
    stats = r.stats_snapshot()
    assert stats["refit_errors"] == 1 and stats["refits"] == 0
