"""The port's fused-executable cache against the JAX package's, on the CPU.

The reference's cache tests (``tests/test_dispatch.py``: hits, misses,
evictions, capacity, churn, layout keys, a two-thread hammer) run here on
both packages' ``FusedExecutor`` with the same seeded inputs: the stats must
be equal step by step and the solutions agree within the tolerance ladder.
On the CPU an entry holds the eager stages, so keys, counters and eviction
behave as on the card, where an entry is a CUDA graph (``chip_smoke.py``
holds replays to the eager calls there). Also: the entry a miss keeps, which
backends capture, the per-device byte budget of the graphs, the session's
``executable_cache`` stats key, the three exported names, and the launch
counters' capture tally.
"""

import threading

import numpy as np
import pytest
import torch

from repro.core.tridiag import ensure_x64

ensure_x64()

import repro.api as japi  # noqa: E402  (before repro.telemetry: import-order cycle)
from repro.core.tridiag import plan as jplan  # noqa: E402
from repro.core.tridiag.layout import AUTO_INTERLEAVE_MIN_BATCH  # noqa: E402
from repro.core.tridiag.reference import make_diag_dominant_system, thomas_numpy  # noqa: E402
from repro_torch import api as tapi  # noqa: E402
from repro_torch.core.tridiag import plan as tplan  # noqa: E402
from repro_torch.kernels import common  # noqa: E402
from repro_torch.kernels.common import assert_allclose_by_dtype  # noqa: E402


@pytest.fixture(autouse=True)
def _fresh_executable_caches():
    """Isolate both process-wide executable LRUs per test (stats + capacity)."""
    for mod in (jplan, tplan):
        mod.clear_executable_cache()
    yield
    for mod in (jplan, tplan):
        mod.set_executable_cache_capacity(128)
        mod.clear_executable_cache()


def _stats():
    """Both packages' stats, which must agree; the port's also counts the
    device bytes its graphs hold, none on the CPU."""
    want, got = jplan.executable_cache_stats(), tplan.executable_cache_stats()
    assert got == {**want, "bytes": 0}
    return want


def _solve_both(jex, tex, plan_args, ops):
    want, _ = jex.execute(jplan.build_plan(*plan_args[0], **plan_args[1]), *ops)
    got, _ = tex.execute(tplan.build_plan(*plan_args[0], **plan_args[1]), *ops)
    assert got.dtype == want.dtype
    assert_allclose_by_dtype(got, want, want.dtype)
    return got


# ----------------------------------------------------------- executable LRU --
def test_executable_cache_hits_misses_evictions():
    jex, tex = jplan.FusedExecutor("reference"), tplan.FusedExecutor("reference", device="cpu")
    dl, d, du, b, _ = make_diag_dominant_system(200, seed=5)
    ops = (dl, d, du, b)
    plan2 = ((200, 10), {"num_chunks": 2})

    _solve_both(jex, tex, plan2, ops)
    stats = _stats()
    assert (stats["misses"], stats["hits"], stats["size"]) == (1, 0, 1)

    _solve_both(jex, tex, plan2, ops)
    _solve_both(jex, tex, plan2, ops)
    assert _stats()["hits"] == 2

    # A different chunking is a different plan signature -> new executable;
    # a different dtype re-keys too.
    _solve_both(jex, tex, ((200, 10), {"num_chunks": 3}), ops)
    x32 = _solve_both(jex, tex, plan2, [np.asarray(a, np.float32) for a in ops])
    assert x32.dtype == np.float32
    stats = _stats()
    assert stats["misses"] == 3 and stats["size"] == 3

    # Shrinking the capacity evicts oldest-first and counts it.
    for mod in (jplan, tplan):
        mod.set_executable_cache_capacity(1)
    stats = _stats()
    assert stats["size"] == 1 and stats["evictions"] == 2

    # Capacity 0 disables caching: solves still work, nothing is retained.
    for mod in (jplan, tplan):
        mod.set_executable_cache_capacity(0)
    x = _solve_both(jex, tex, plan2, ops)
    assert_allclose_by_dtype(x, thomas_numpy(*ops), np.float64)
    assert _stats()["size"] == 0

    for mod in (jplan, tplan):
        with pytest.raises(ValueError):
            mod.set_executable_cache_capacity(-1)

    for mod in (jplan, tplan):
        mod.clear_executable_cache()
    assert _stats() == {"hits": 0, "misses": 0, "evictions": 0, "size": 0}


def test_executable_cache_eviction_churn_stays_correct():
    """With a capacity smaller than the working set, every solve rebuilds
    or evicts; results must stay on the oracle throughout, and the two
    packages' counters must move together."""
    for mod in (jplan, tplan):
        mod.set_executable_cache_capacity(2)
    jex, tex = jplan.FusedExecutor("reference"), tplan.FusedExecutor("reference", device="cpu")
    cases = []
    for i, (n, k) in enumerate([(100, 1), (200, 2), (300, 3), (400, 4)]):
        dl, d, du, b, _ = make_diag_dominant_system(n, seed=10 + i)
        cases.append((((n, 10), {"num_chunks": k}), (dl, d, du, b)))
    for _ in range(3):
        for plan_args, ops in cases:
            x = _solve_both(jex, tex, plan_args, ops)
            assert_allclose_by_dtype(x, thomas_numpy(*ops), np.float64)
            _stats()
    stats = _stats()
    assert stats["size"] <= 2 and stats["evictions"] >= len(cases)


def test_executable_cache_keys_layouts_separately():
    """The same plan under two layouts must get two cache entries."""
    dl, d, du, b, _ = make_diag_dominant_system(200, seed=14)
    ops = (dl, d, du, b)
    ref = thomas_numpy(*ops)
    plan = ((200, 10), {"num_chunks": 2})
    sm = (jplan.FusedExecutor("reference", layout="system-major"),
          tplan.FusedExecutor("reference", device="cpu", layout="system-major"))
    il = (jplan.FusedExecutor("reference", layout="interleaved"),
          tplan.FusedExecutor("reference", device="cpu", layout="interleaved"))

    assert_allclose_by_dtype(_solve_both(*sm, plan, ops), ref, np.float64)
    assert_allclose_by_dtype(_solve_both(*il, plan, ops), ref, np.float64)
    stats = _stats()
    assert (stats["misses"], stats["size"]) == (2, 2)

    _solve_both(*sm, plan, ops)
    _solve_both(*il, plan, ops)
    stats = _stats()
    assert (stats["misses"], stats["hits"], stats["size"]) == (2, 2, 2)


def test_auto_layout_resolution_via_cache_key():
    """layout="auto" shares the wide executable with an explicit
    "interleaved" session at B >= the auto threshold, and the system-major
    executable below it, in both packages."""
    bsz = AUTO_INTERLEAVE_MIN_BATCH
    wide = make_diag_dominant_system(100, seed=15, batch=(bsz,))[:4]
    narrow = make_diag_dominant_system(100, seed=16, batch=(4,))[:4]
    jcfg = japi.SolverConfig(m=10, num_chunks=1, dispatch="fused", backend="reference")
    tcfg = tapi.SolverConfig(m=10, num_chunks=1, dispatch="fused", backend="reference", device="cpu")

    def both(layout, ops):
        want = japi.TridiagSession(jcfg.replace(layout=layout)).solve_batched(*ops)
        got = tapi.TridiagSession(tcfg.replace(layout=layout)).solve_batched(*ops)
        assert_allclose_by_dtype(got, want, np.float64)

    both("auto", wide)
    assert _stats()["misses"] == 1
    both("interleaved", wide)
    stats = _stats()
    assert (stats["misses"], stats["hits"]) == (1, 1)

    both("auto", narrow)
    both("system-major", narrow)
    stats = _stats()
    assert (stats["misses"], stats["hits"]) == (2, 2)


def test_two_thread_session_hammer_over_executable_lru():
    """Two sessions solving concurrently (distinct plans, shared tiny LRU):
    the lock-protected cache must neither corrupt results nor deadlock."""
    tplan.set_executable_cache_capacity(2)
    cfg = tapi.SolverConfig(m=10, dispatch="fused", device="cpu")
    sizes = (100, 200, 300)
    problems = {
        (n, k): make_diag_dominant_system(n, seed=n + k)[:4]
        for n in sizes
        for k in (1, 2)
    }
    refs = {key: thomas_numpy(*ops) for key, ops in problems.items()}
    errors = []

    def worker(tid):
        try:
            with tapi.TridiagSession(cfg.replace(num_chunks=1 + tid)) as session:
                for _ in range(10):
                    for n in sizes:
                        x = session.solve(*problems[(n, 1 + tid)])
                        err = np.max(np.abs(x - refs[(n, 1 + tid)]))
                        if err > 1e-11 * np.max(np.abs(refs[(n, 1 + tid)])):
                            errors.append((tid, n, "off oracle", err))
        except Exception as e:  # pragma: no cover - failure path
            errors.append((tid, repr(e)))

    threads = [threading.Thread(target=worker, args=(t,)) for t in range(2)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=120)
        assert not t.is_alive(), "hammer thread deadlocked"
    assert not errors, errors
    stats = tplan.executable_cache_stats()
    assert stats["size"] <= 2
    assert stats["hits"] + stats["misses"] == 60


def test_executor_rejects_bad_operands_before_the_cache():
    ex = tplan.FusedExecutor("reference", device="cpu")
    dl, d, du, b, _ = make_diag_dominant_system(200, seed=5)
    with pytest.raises(ValueError, match="rows"):
        ex.execute(tplan.build_plan(100, 10), dl, d, du, b)
    with pytest.raises(TypeError, match="floating"):
        ex.execute(tplan.build_plan(200, 10), *(np.ones(200, np.int64),) * 4)
    assert tplan.executable_cache_stats() == {"hits": 0, "misses": 0, "evictions": 0, "size": 0, "bytes": 0}


def test_a_miss_runs_eagerly_and_keeps_an_empty_entry():
    """The miss holds nothing on the device; on the CPU a hit stays eager."""
    ex = tplan.FusedExecutor("reference", device="cpu")
    ops = make_diag_dominant_system(200, seed=5)[:4]
    plan = tplan.build_plan(200, 10, num_chunks=2)
    x, _ = ex.execute(plan, *ops)
    (entry,) = tplan._EXEC_CACHE.values()
    assert entry.key == ex._key(plan, [torch.as_tensor(a) for a in ops])
    assert (entry.dtype, entry.shape, entry.nbytes) == (torch.float64, (200,), 0)
    assert entry.graph is None and not entry.capturable
    y, _ = ex.execute(plan, *ops)
    assert entry.graph is None and np.array_equal(x, y)
    assert tplan.executable_cache_stats() == {"hits": 1, "misses": 1, "evictions": 0, "size": 1, "bytes": 0}


@pytest.mark.parametrize(
    "backend, device, capturable",
    [("cuda", "cuda", True), ("cuda", "cpu", False), ("reference", "cuda", False),
     ("reference", "cpu", False)],
)
def test_only_the_kernels_backend_captures_and_only_on_the_card(backend, device, capturable):
    plan = tplan.build_plan(200, 10)
    key = (plan, backend, "system-major", torch.device(device), torch.float64, ())
    entry = tplan._FusedExecutable(key, tplan.BACKENDS[backend])
    assert entry.capturable is capturable
    assert tplan.StageBackend.capturable is False


def _cached_entries(count):
    """``count`` CPU entries, oldest first, made by cache misses."""
    ex = tplan.FusedExecutor("reference", device="cpu")
    for i in range(count):
        n = 100 * (i + 1)
        ex.execute(tplan.build_plan(n, 10), *make_diag_dominant_system(n, seed=i)[:4])
    return list(tplan._EXEC_CACHE.values())


def test_byte_budget_evicts_the_oldest_graphs_first(monkeypatch):
    monkeypatch.setattr(tplan, "_byte_budget", lambda device: 250)
    e0, e1, e2, e3 = _cached_entries(4)
    for e in (e1, e2):
        tplan._charge(e, 100)
    assert tplan.executable_cache_stats()["bytes"] == 200
    tplan._charge(e3, 100)  # over the budget: e1, the oldest graph, goes; e0 holds none
    assert list(tplan._EXEC_CACHE.values()) == [e0, e2, e3]
    stats = tplan.executable_cache_stats()
    assert (stats["bytes"], stats["evictions"], stats["size"]) == (200, 1, 3)


def test_byte_budget_drops_an_entry_larger_than_itself(monkeypatch):
    monkeypatch.setattr(tplan, "_byte_budget", lambda device: 250)
    e0, e1 = _cached_entries(2)
    tplan._charge(e0, 100)
    tplan._charge(e1, 300)
    assert list(tplan._EXEC_CACHE.values()) == []
    stats = tplan.executable_cache_stats()
    assert (stats["bytes"], stats["evictions"], stats["size"]) == (0, 2, 0)


def test_an_entry_evicted_while_it_captured_is_not_charged(monkeypatch):
    monkeypatch.setattr(tplan, "_byte_budget", lambda device: 250)
    (e0,) = _cached_entries(1)
    tplan._EXEC_DROPPED.discard(torch.device("cpu"))  # what earlier tests' clears left
    tplan.set_executable_cache_capacity(0)
    assert torch.device("cpu") not in tplan._EXEC_DROPPED  # it held no graph yet
    tplan._charge(e0, 100)
    assert tplan.executable_cache_stats() == {"hits": 0, "misses": 1, "evictions": 1, "size": 0, "bytes": 0}
    # Its graph, captured after all, is released before the next capture.
    assert torch.device("cpu") in tplan._EXEC_DROPPED


def test_capacity_eviction_and_clear_give_back_the_bytes(monkeypatch):
    monkeypatch.setattr(tplan, "_byte_budget", lambda device: 1000)
    e0, e1, e2 = _cached_entries(3)
    for e in (e0, e1, e2):
        tplan._charge(e, 100)
    tplan.set_executable_cache_capacity(1)
    assert list(tplan._EXEC_CACHE.values()) == [e2]
    assert tplan.executable_cache_stats()["bytes"] == 100
    tplan.clear_executable_cache()
    assert tplan.executable_cache_stats() == {"hits": 0, "misses": 0, "evictions": 0, "size": 0, "bytes": 0}


def test_byte_accounting_holds_under_concurrent_charges(monkeypatch):
    """Threads charging entries at once (eviction included) against a short
    switch interval: the bytes counted must equal those of the entries
    still cached, within the budget; a lost update would break it."""
    import sys

    monkeypatch.setattr(tplan, "_byte_budget", lambda device: 1000)
    entries = _cached_entries(24)
    workers, errors = 12, []

    def charge(tid):
        try:
            for e in entries[tid::workers]:
                tplan._charge(e, 100 + tid)
        except Exception as exc:  # pragma: no cover - failure path
            errors.append(repr(exc))

    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        threads = [threading.Thread(target=charge, args=(t,)) for t in range(workers)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=60)
            assert not t.is_alive(), "charging thread did not finish"
    finally:
        sys.setswitchinterval(interval)
    assert not errors, errors
    stats = tplan.executable_cache_stats()
    held = sum(e.nbytes for e in tplan._EXEC_CACHE.values() if e.nbytes)
    assert stats["bytes"] == held <= 1000
    charged = sum(1 for e in entries if e.nbytes)
    assert stats["evictions"] == charged - sum(1 for e in tplan._EXEC_CACHE.values() if e.nbytes)


def test_a_dropped_graph_is_released_once_before_the_next_capture(monkeypatch):
    released = []
    cpu = torch.device("cpu")
    tplan._EXEC_DROPPED.discard(cpu)  # what earlier tests' clears left
    monkeypatch.setattr(tplan, "_byte_budget", lambda device: 150)
    monkeypatch.setattr(torch.cuda, "empty_cache", lambda: released.append(1))
    e0, e1 = _cached_entries(2)
    tplan._charge(e0, 100)
    tplan._release_dropped(cpu)
    assert released == []  # nothing dropped yet
    tplan._charge(e1, 100)  # evicts e0, whose pool stays reserved until released
    tplan._release_dropped(cpu)
    tplan._release_dropped(cpu)
    assert released == [1]
    tplan.clear_executable_cache()  # drops e1
    tplan._release_dropped(cpu)
    assert released == [1, 1]


# ------------------------------------------------------------------ session --
def test_session_stats_report_the_executable_cache():
    ops = make_diag_dominant_system(200, seed=5)[:4]
    with tapi.TridiagSession(tapi.SolverConfig(m=10, num_chunks=2, dispatch="fused", device="cpu")) as s:
        s.solve(*ops)
        s.solve(*ops)
        stats = s.stats
    with japi.TridiagSession(japi.SolverConfig(m=10, num_chunks=2, dispatch="fused")) as js:
        js.solve(*ops)
        js.solve(*ops)
        want = js.stats["executable_cache"]
    assert stats["executable_cache"] == tapi.executable_cache_stats() == {**want, "bytes": 0}
    assert stats["executable_cache"] == {"hits": 1, "misses": 1, "evictions": 0, "size": 1, "bytes": 0}


@pytest.mark.parametrize(
    "name", ["executable_cache_stats", "clear_executable_cache", "set_executable_cache_capacity"]
)
def test_cache_functions_are_exported(name):
    from repro_torch.core import tridiag

    assert name in tapi.__all__
    assert getattr(tapi, name) is getattr(tplan, name) is getattr(tridiag, name)
    assert hasattr(japi, name)


# ------------------------------------------------------------ launch counts --
def test_launch_counter_adds_n_and_records_a_capture():
    counter = common.LaunchCounter("probe")
    counter.add()
    counter.add(3)
    assert counter.count == 4
    with common.recording() as tally:
        counter.add()
        counter.add(2)
    assert tally == {counter: 3} and counter.count == 4
    for c, n in tally.items():
        c.add_replayed(n)  # what a replay adds, apart from the wrapper's count
    assert (counter.count, counter.replayed, counter.total) == (4, 3, 7)
    counter.reset()
    assert (counter.count, counter.replayed) == (0, 0)


def test_recording_is_per_thread():
    counter = common.LaunchCounter("probe")
    started, done = threading.Event(), threading.Event()

    def other():
        started.wait(timeout=30)
        counter.add()
        done.set()

    t = threading.Thread(target=other)
    t.start()
    with common.recording() as tally:
        started.set()
        assert done.wait(timeout=30)
        counter.add(5)
    t.join(timeout=30)
    assert not t.is_alive()
    assert tally == {counter: 5} and counter.count == 1


def test_launch_count_snapshot_gives_the_difference():
    from repro_torch.kernels import LAUNCH_COUNTERS

    before = common.launch_counts()
    assert set(before) == set(LAUNCH_COUNTERS)
    LAUNCH_COUNTERS["thomas"].add(2)
    try:
        assert common.launches_since(before) == {"thomas": 2}
    finally:
        LAUNCH_COUNTERS["thomas"].add(-2)
    assert common.launches_since(before) == {}
