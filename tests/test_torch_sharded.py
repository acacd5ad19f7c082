"""The port's sharded solve against the JAX package's, on the CPU.

The reference shards over the 8 host devices that ``tests/conftest.py``
forces (``FusedExecutor(mesh=8)``, ``SolverConfig(mesh=8)``); the port runs
the same plans over 8 logical shards of the host, ``mesh=("cpu",) * 8``.
Answers are held to the reference's at the tolerance ladder (fp64 1e-12,
fp32 1e-5), and the port's system-major sharded answers to its own
unsharded answers on the same plan, bit for bit.
"""

import functools

import numpy as np
import pytest
import torch

from repro.core.tridiag import ensure_x64

ensure_x64()

import repro.api as japi  # noqa: E402  (before repro.telemetry: import-order cycle)
from repro.core.tridiag import layout as jlayout  # noqa: E402
from repro.core.tridiag import plan as jplan  # noqa: E402
from repro.core.tridiag.reference import make_diag_dominant_system  # noqa: E402
from repro.parallel import solver as jsolver  # noqa: E402
from repro_torch.api import (  # noqa: E402
    FixedChunkPolicy,
    FusedExecutor,
    SolveRequest,
    SolverConfig,
    TridiagSession,
    clear_executable_cache,
    executable_cache_stats,
)
from repro_torch.core.tridiag import plan as plan_mod  # noqa: E402
from repro_torch.core.tridiag.batched import fuse_systems  # noqa: E402
from repro_torch.core.tridiag.plan import build_plan  # noqa: E402
from repro_torch.kernels.common import assert_allclose_by_dtype  # noqa: E402
from repro_torch.parallel import (  # noqa: E402
    mesh_signature,
    resolve_mesh_devices,
    shard_count,
)

M = 10
MESH = ("cpu",) * 8
CPU = torch.device("cpu")
DTYPES = [np.float64, np.float32]
RAGGED = (80, 160, 320, 240, 80, 160, 320, 240)


# ------------------------------------------------------------ device lists --
@pytest.mark.parametrize(
    "total,limit",
    [(160, 8), (10, 8), (7, 8), (13, 8), (100, 1), (0, 8), (1, 8), (12, 4), (48, 4),
     (64, 4), (1_000_000, 4), (1_000_001, 4), (1_000_001, 8)],
)
def test_shard_count_matches_the_reference(total, limit):
    assert shard_count(total, limit) == jsolver.shard_count(total, limit)


@pytest.mark.parametrize(
    "spec,want",
    [
        (None, None),
        (1, None),
        (np.int64(1), None),
        (("cpu",), None),
        (MESH, (CPU,) * 8),
        ([torch.device("cpu"), "cpu"], (CPU, CPU)),
        (("cuda:0",) * 4, (torch.device("cuda", 0),) * 4),
        (("cuda:1", "cuda:0"), (torch.device("cuda", 1), torch.device("cuda", 0))),
    ],
)
def test_resolve_mesh_devices_specs(spec, want):
    assert resolve_mesh_devices(spec) == want


@pytest.mark.parametrize("visible", [0, 1, 3])
def test_resolve_mesh_devices_counts_cuda_devices(monkeypatch, visible):
    monkeypatch.setattr(torch.cuda, "device_count", lambda: visible)
    want = tuple(torch.device("cuda", i) for i in range(visible))
    assert resolve_mesh_devices("auto") == (want if visible > 1 else None)
    assert resolve_mesh_devices(1) is None
    if visible >= 2:
        assert resolve_mesh_devices(2) == want[:2]
    with pytest.raises(ValueError, match="visible"):
        resolve_mesh_devices(visible + 1 if visible >= 1 else 2)


@pytest.mark.parametrize(
    "spec,error,match",
    [
        (0, ValueError, ">= 1"),
        (-3, ValueError, ">= 1"),
        ("all", ValueError, "auto"),
        ("cuda", ValueError, "auto"),
        (3.5, TypeError, "mesh must be"),
        (torch.device("cpu"), TypeError, "mesh must be"),
        (("cpu", "cuda:0"), ValueError, "mix"),
        (("cpu", "meta"), ValueError, "'cuda' or 'cpu'"),
        (("cpu", "no-such-device"), ValueError, "not a device"),
    ],
)
def test_resolve_mesh_devices_errors(spec, error, match):
    with pytest.raises(error, match=match):
        resolve_mesh_devices(spec)


def test_resolve_mesh_devices_errors_as_the_reference(multi_device_count):
    for spec, error in ((0, ValueError), ("all", ValueError), (3.5, TypeError)):
        with pytest.raises(error):
            jsolver.resolve_mesh_devices(spec)
        with pytest.raises(error):
            resolve_mesh_devices(spec)
    with pytest.raises(ValueError, match="visible"):
        jsolver.resolve_mesh_devices(multi_device_count + 1)


def test_mesh_signature_tells_device_lists_apart(multi_device_count):
    assert mesh_signature(None) is None
    four, two = resolve_mesh_devices(("cuda:0",) * 4), resolve_mesh_devices(("cuda:0",) * 2)
    sigs = {
        mesh_signature(four),
        mesh_signature(two),
        mesh_signature(resolve_mesh_devices(("cpu",) * 4)),
        mesh_signature(resolve_mesh_devices(("cuda:1", "cuda:0"))),
        mesh_signature(resolve_mesh_devices(("cuda:0", "cuda:1"))),
    }
    assert len(sigs) == 5
    assert mesh_signature(four) == (("cuda", 0),) * 4
    hash(mesh_signature(four))
    # one entry per shard, as the reference's
    ref = jsolver.resolve_mesh_devices(multi_device_count)
    assert len(mesh_signature(resolve_mesh_devices(("cpu",) * len(ref)))) == len(
        jsolver.mesh_signature(ref)
    )


# ------------------------------------------------------ shard-aligned plans --
PLAN_SIZES = [1600, 130, 100, 1800, RAGGED, (160,) * 64, 10_000_010]


@pytest.mark.parametrize("shards", [1, 2, 4, 5, 8])
@pytest.mark.parametrize("sizes", PLAN_SIZES, ids=lambda s: f"{len(s)}sys" if isinstance(s, tuple) else str(s))
def test_build_plan_shards_matches_the_reference(sizes, shards):
    for k in (1, 3, 8, 12, 32):
        got = build_plan(sizes, M, num_chunks=k, shards=shards)
        want = jplan.build_plan(sizes, M, num_chunks=k, shards=shards)
        for field in ("m", "sizes", "chunk_bounds", "halo_bounds", "offsets", "shards",
                      "num_chunks", "blocks_per_shard", "local_chunk_bounds"):
            assert getattr(got, field) == getattr(want, field), (sizes, k, shards, field)
    got = build_plan(sizes, M, policy=FixedChunkPolicy(6), shards=shards)
    want = jplan.build_plan(sizes, M, policy=jplan.FixedChunkPolicy(6), shards=shards)
    assert (got.chunk_bounds, got.shards) == (want.chunk_bounds, want.shards)


def test_shard_aligned_plans_snap_and_key_apart():
    # 13 blocks: prime, so 8 shards asked give 1; 10 blocks give 5;
    # 1,000,001 = 101 x 9901 blocks give 1 for 4 asked.
    assert build_plan(130, M, num_chunks=4, shards=8).shards == 1
    assert build_plan(100, M, num_chunks=4, shards=8).shards == 5
    assert build_plan(10_000_010, M, num_chunks=8, shards=4) == build_plan(10_000_010, M, num_chunks=8)
    assert build_plan(1600, M, num_chunks=12) == build_plan(1600, M, num_chunks=12, shards=1)
    assert build_plan(1600, M, num_chunks=8, shards=8) != build_plan(1600, M, num_chunks=8)
    plan = build_plan(1800, M, num_chunks=24, shards=8)  # 180 blocks: 6 shards of 30
    assert plan.shards == 6 and plan.num_chunks == 24
    assert plan.local_chunk_bounds == ((0, 8), (8, 16), (16, 23), (23, 30))
    bps, cps = plan.blocks_per_shard, plan.num_chunks // plan.shards
    for s in range(plan.shards):
        local = plan.chunk_bounds[s * cps : (s + 1) * cps]
        assert tuple((lo - s * bps, hi - s * bps) for lo, hi in local) == plan.local_chunk_bounds
    with pytest.raises(ValueError, match="shards"):
        build_plan(1600, M, num_chunks=8, shards=0)


# --------------------------------------------------- the system-major path --
# (n, num_chunks): one chunk a shard, several, uneven local chunks over 6
# shards, and 5 shards of 2 blocks (10 blocks, 8 asked).
SYSTEM_MAJOR = [(1600, 8), (1600, 32), (1800, 24), (100, 4)]


@functools.lru_cache(maxsize=None)
def _jax_sharded(n, k, dtype):
    ops = make_diag_dominant_system(n, seed=n + k, dtype=dtype)
    plan = jplan.build_plan(n, M, num_chunks=k, shards=8)
    ex = jplan.FusedExecutor(backend="reference", donate=False, mesh=8)
    return ops, ex.execute(plan, *ops[:4])[0]


@pytest.mark.parametrize("backend", ["reference", "cuda"])
@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("n,k", SYSTEM_MAJOR)
def test_sharded_system_major_matches_reference_and_unsharded_bits(
    multi_device_count, n, k, dtype, backend
):
    ops, want = _jax_sharded(n, k, dtype)
    plan = build_plan(n, M, num_chunks=k, shards=8)
    sharded = FusedExecutor(backend, device="cpu", mesh=MESH)
    assert sharded.shard_devices(plan, "system-major") == (CPU,) * plan.shards
    x, timing = sharded.execute(plan, *ops[:4])
    assert x.dtype == np.dtype(dtype) and timing.num_chunks == plan.num_chunks
    assert_allclose_by_dtype(x, want, dtype)
    assert_allclose_by_dtype(x, ops[4], dtype)
    x0, _ = FusedExecutor(backend, device="cpu").execute(plan, *ops[:4])
    np.testing.assert_array_equal(x, x0)


@pytest.mark.parametrize("dtype", DTYPES)
def test_sharded_path_runs_each_shard_on_its_device(dtype):
    """Every shard's span reaches the stages on its own device, the reduced
    rows are gathered once per distinct device, and the reduced system is
    solved once per shard."""
    ops = make_diag_dominant_system(1600, seed=3, dtype=dtype)
    plan = build_plan(1600, M, num_chunks=16, shards=4)
    backend = plan_mod.resolve_backend("reference")
    calls = {"stage1": 0, "reduced": 0}

    class Counting(plan_mod.ReferenceBackend):
        def make_stage1(self, m):
            inner = backend.make_stage1(m)

            def stage1(*a):
                calls["stage1"] += 1
                assert a[1].device == CPU and a[1].shape[-1] % m == 0
                return inner(*a)

            return stage1

        def make_reduced_solve(self):
            inner = backend.make_reduced_solve()

            def solve(*a):
                calls["reduced"] += 1
                assert a[1].shape == (plan.num_blocks,)
                return inner(*a)

            return solve

    tensors = [torch.from_numpy(a) for a in ops[:4]]
    x = plan_mod._fused_sharded(plan, Counting(), (CPU,) * 4, *tensors)
    assert calls == {"stage1": 16, "reduced": 4}
    np.testing.assert_array_equal(x.numpy(), plan_mod._fused(plan, backend, *tensors).numpy())


# -------------------------------------------------- the interleaved lanes --
@functools.lru_cache(maxsize=None)
def _jax_many(sizes, dtype, seed):
    systems = [make_diag_dominant_system(n, seed=seed + i, dtype=dtype)[:4] for i, n in enumerate(sizes)]
    with japi.TridiagSession(japi.SolverConfig(m=M, mesh=8)) as s:
        return systems, s.solve_many(systems)


INTERLEAVED = [
    ((160,) * 256, 8),  # 32 lanes a shard
    (tuple(100 + 10 * (i % 7) for i in range(64)), 2),  # ragged, 32 lanes a shard
]


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("sizes,shards", INTERLEAVED, ids=["uniform256", "ragged64"])
def test_lane_sharded_interleaved_matches_reference(multi_device_count, sizes, shards, dtype):
    systems, want = _jax_many(sizes, dtype, seed=len(sizes))
    with TridiagSession(SolverConfig(m=M, mesh=("cpu",) * shards, device="cpu", backend="cuda")) as s:
        plan = s.plan_for(sizes)
        assert s._fused.resolved_layout(plan) == "interleaved"
        assert s._fused.shard_devices(plan, "interleaved") == (CPU,) * shards
        got = s.solve_many(systems)
    with TridiagSession(SolverConfig(m=M, device="cpu", backend="cuda")) as s0:
        base = s0.solve_many(systems)
    for g, w, b0 in zip(got, want, base):
        assert_allclose_by_dtype(g, w, dtype)
        assert_allclose_by_dtype(g, b0, dtype)


@pytest.mark.parametrize("batch,shards", [(64, 8), (64, 1), (256, 8), (256, 16), (48, 4)])
def test_per_shard_auto_threshold_matches_reference(batch, shards):
    sizes = (160,) * batch
    want = jlayout.resolve_layout("auto", sizes, M, fused=True, batch_shards=shard_count(batch, shards))
    mesh = ("cpu",) * shards if shards > 1 else None
    ex = FusedExecutor("reference", device="cpu", mesh=mesh)
    assert ex.resolved_layout(build_plan(sizes, M)) == want
    # stacked operands stay system-major and unsharded
    assert ex.resolved_layout(build_plan(sizes, M), lead_ndim=1) == "system-major"
    assert ex.shard_devices(build_plan(sizes, M), "system-major", lead_ndim=1) is None


# ---------------------------------------------------------- session verbs --
def _inputs(verb, dtype):
    if verb == "solve":
        return make_diag_dominant_system(1600, seed=1, dtype=dtype)[:4]
    if verb == "batched":
        return make_diag_dominant_system(320, seed=2, batch=(16,), dtype=dtype)[:4]
    return [make_diag_dominant_system(n, seed=n + i, dtype=dtype)[:4] for i, n in enumerate(RAGGED)]


def _run(session, verb, ops):
    if verb == "solve":
        return session.solve(*ops)
    if verb == "batched":
        return session.solve_batched(*ops)
    if verb == "many":
        return session.solve_many(ops)
    futs = [session.submit(SolveRequest(i, *o)) for i, o in enumerate(ops)]
    return [f.result(timeout=60) for f in futs]


@functools.lru_cache(maxsize=None)
def _jax_verb(verb, dtype):
    cfg = japi.SolverConfig(m=M, mesh=8, num_chunks=8, max_batch=len(RAGGED))
    with japi.TridiagSession(cfg) as s:
        return _run(s, verb, _inputs(verb, dtype))


def _check(got, want, dtype):
    if isinstance(want, list):
        assert len(got) == len(want)
        for g, w in zip(got, want):
            _check(g, w, dtype)
        return
    assert isinstance(got, np.ndarray) and got.dtype == np.dtype(dtype)
    assert got.shape == np.asarray(want).shape
    assert_allclose_by_dtype(got, np.asarray(want), dtype)


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("verb", ["solve", "batched", "many", "submit"])
def test_session_verbs_match_reference_sharded_session(multi_device_count, verb, dtype):
    ops = _inputs(verb, dtype)
    cfg = SolverConfig(m=M, mesh=MESH, num_chunks=8, device="cpu", max_batch=len(RAGGED))
    with TridiagSession(cfg) as s:
        got = _run(s, verb, ops)
        if verb == "submit":
            (batch,) = s.stats["per_batch"]
            assert batch["systems"] == len(RAGGED) and batch["num_chunks"] % 8 == 0
        assert s.stats["mesh"] == {"devices": 8, "platform": "cpu", "signature": (("cpu", None),) * 8}
    _check(got, _jax_verb(verb, dtype), dtype)
    # the same verbs on the unsharded session, at the shard-aligned plan
    with TridiagSession(cfg.replace(mesh=None)) as s0:
        assert s0.stats["mesh"] is None
        _check(_run(s0, verb, ops), got, dtype)


def test_session_builds_shard_aligned_plans_and_falls_back_on_stacked_operands():
    cfg = SolverConfig(m=M, mesh=MESH, num_chunks=12, device="cpu")
    with TridiagSession(cfg) as s, TridiagSession(cfg.replace(mesh=None)) as s0:
        plan = s.plan_for(1600)
        assert plan == build_plan(1600, M, num_chunks=12, shards=8)
        assert s0.plan_for(1600) == build_plan(1600, M, num_chunks=12)
        assert s._engine.plan_shards((1600,)) == 8 and s0._engine.plan_shards((1600,)) == 1
        assert s._fused.operand_device == CPU
        # (K, n) operands run the single-device path, bit for bit
        ops = make_diag_dominant_system(1600, seed=5, batch=(3,))
        x = s.solve(*ops[:4])
        assert_allclose_by_dtype(x, ops[4], np.float64)
        with TridiagSession(SolverConfig(m=M, num_chunks=16, device="cpu")) as s16:
            assert s16.plan_for(1600).chunk_bounds == plan.chunk_bounds
            np.testing.assert_array_equal(x, s16.solve(*ops[:4]))


def test_plans_that_snap_to_one_shard_give_the_unsharded_answer():
    """13 blocks have no divisor within 8: the plan is the unsharded one,
    and so is the answer."""
    ops = make_diag_dominant_system(130, seed=6)[:4]
    cfg = SolverConfig(m=M, mesh=MESH, num_chunks=4, device="cpu")
    with TridiagSession(cfg) as s, TridiagSession(cfg.replace(mesh=None)) as s0:
        assert s.plan_for(130) == s0.plan_for(130) and s.plan_for(130).shards == 1
        np.testing.assert_array_equal(s.solve(*ops), s0.solve(*ops))


# ------------------------------------------------- executable-cache keys --
def test_mesh_keys_executables_apart():
    ops = make_diag_dominant_system(1600, seed=7)[:4]
    clear_executable_cache()
    cfg = SolverConfig(m=M, num_chunks=8, device="cpu")
    answers = []
    for mesh in (("cpu",) * 4, ("cpu",) * 2, None):
        with TridiagSession(cfg.replace(mesh=mesh)) as s:
            answers.append(s.solve(*ops))
            answers.append(s.solve(*ops))
    stats = executable_cache_stats()
    assert (stats["size"], stats["misses"], stats["hits"]) == (3, 3, 3)
    with plan_mod._CACHE_LOCK:
        keys = list(plan_mod._EXEC_CACHE)
    assert [k[0].shards for k in keys] == [4, 2, 1]
    assert [len(k) for k in keys] == [7, 7, 6]
    assert keys[0][-1] == (("cpu", None),) * 4 and keys[1][-1] == (("cpu", None),) * 2
    for a in answers[1:]:
        assert_allclose_by_dtype(a, answers[0], np.float64)
    clear_executable_cache()


def test_unsharded_plan_under_a_mesh_shares_the_unsharded_entry():
    ops = [torch.from_numpy(a) for a in make_diag_dominant_system(1600, seed=8)[:4]]
    plan = build_plan(1600, M, num_chunks=8)
    sharded, single = FusedExecutor("reference", device="cpu", mesh=MESH), FusedExecutor("reference", device="cpu")
    assert sharded.shard_devices(plan, "system-major") is None
    assert sharded._key(plan, ops) == single._key(plan, ops)
    aligned = build_plan(1600, M, num_chunks=8, shards=8)
    assert sharded._key(aligned, ops)[:6] == single._key(aligned, ops)
    entry = plan_mod._FusedExecutable(sharded._key(aligned, ops), sharded.backend)
    assert entry.shard_devices == (CPU,) * 8 and not entry.capturable


# ------------------------------------------------------- mesh=None stays --
def test_mesh_none_is_bit_identical_with_todays_keys():
    ops = make_diag_dominant_system(1600, seed=9)
    plan = build_plan(1600, M, num_chunks=8)
    tensors = [torch.from_numpy(a) for a in ops[:4]]
    a, b = FusedExecutor("reference", device="cpu"), FusedExecutor("reference", device="cpu", mesh=None)
    assert a.mesh_devices is None and b.mesh_devices is None
    assert b._key(plan, tensors) == (plan, "reference", "system-major", CPU, torch.float64, ())
    np.testing.assert_array_equal(a.execute(plan, *ops[:4])[0], b.execute(plan, *ops[:4])[0])


# ------------------------------------------------------------------ config --
@pytest.mark.parametrize(
    "kw,match",
    [
        ({"mesh": MESH, "dispatch": "staged"}, "staged"),
        ({"mesh": "everything"}, "auto"),
        ({"mesh": ("cpu", "cuda:0")}, "mix"),
        ({"mesh": MESH, "device": "cuda"}, "mesh's type"),
        ({"mesh": ("cuda:0",) * 2, "device": "cpu"}, "mesh's type"),
    ],
)
def test_config_rejects_what_the_reference_rejects(kw, match):
    with pytest.raises(ValueError, match=match):
        SolverConfig(**{"device": "cpu", **kw}).validate()


def test_config_accepts_a_mesh_on_fused_dispatch(multi_device_count):
    for dispatch in ("fused", "auto"):
        SolverConfig(mesh=MESH, dispatch=dispatch, device="cpu").validate()
        japi.SolverConfig(mesh="auto", dispatch=dispatch).validate()
    SolverConfig(mesh="auto", device="cpu").validate()  # no CUDA device: unsharded
    with pytest.raises(ValueError, match="staged"):
        japi.SolverConfig(mesh="auto", dispatch="staged").validate()
    with pytest.raises(ValueError, match="mesh's type"):
        FusedExecutor("reference", mesh=MESH)  # device defaults to "cuda"


def test_timed_verbs_stay_staged_on_the_sessions_device(multi_device_count):
    ops = make_diag_dominant_system(800, seed=10)
    with TridiagSession(SolverConfig(m=M, mesh=MESH, num_chunks=8, device="cpu")) as s:
        x, timing = s.solve_timed(*ops[:4])
        assert s.plan_for(800).shards == 8
    with japi.TridiagSession(japi.SolverConfig(m=M, mesh="auto", num_chunks=8)) as js:
        want, jtiming = js.solve_timed(*ops[:4])
    assert timing.t_stage2_ms > 0.0 and jtiming.t_stage2_ms > 0.0
    assert timing.num_chunks == jtiming.num_chunks == 8
    assert_allclose_by_dtype(x, want, np.float64)
    assert_allclose_by_dtype(x, ops[4], np.float64)


def test_batched_operands_fuse_on_the_mesh_device():
    ops = make_diag_dominant_system(160, seed=11, batch=(4,))
    fused = fuse_systems(*ops[:4], device=CPU)
    ex = FusedExecutor("cuda", device="cpu", mesh=("cpu",) * 4)
    plan = build_plan((160,) * 4, M, num_chunks=4, shards=4)
    x, _ = ex.execute(plan, *fused)
    assert_allclose_by_dtype(x.reshape(4, 160), ops[4], np.float64)
