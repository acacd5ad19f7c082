"""Parity of the port's plans, fusion helpers, heuristic and executor with
the JAX package (CPU, small sizes)."""

import threading

import numpy as np
import pytest
import torch

from repro.core.tridiag import ensure_x64

ensure_x64()

import repro.api  # noqa: E402,F401  (before repro.telemetry: import-order cycle)
from repro.core.autotune.heuristic import (  # noqa: E402
    fit_batched_stream_heuristic as jax_fit_batched,
    fit_stream_heuristic as jax_fit,
)
from repro.core.streams.simulator import PAPER_SIZES  # noqa: E402
from repro.core.streams.simulator import StreamSimulator as JaxSimulator  # noqa: E402
from repro.core.tridiag import plan as jplan  # noqa: E402
from repro.core.tridiag.batched import fuse_systems as jax_fuse_systems  # noqa: E402
from repro.core.tridiag.ragged import fuse_ragged as jax_fuse_ragged  # noqa: E402
from repro.core.tridiag.reference import make_diag_dominant_system, thomas_numpy  # noqa: E402
from repro_torch.core.autotune import fit_stream_heuristic  # noqa: E402
from repro_torch.core.autotune.convert import heuristic_from_reference  # noqa: E402
from repro_torch.core.autotune.heuristic import (  # noqa: E402
    BatchedStreamHeuristic,
    StreamHeuristic,
)
from repro_torch.core.streams import StreamSimulator  # noqa: E402
from repro_torch.core.tridiag import plan as tplan  # noqa: E402
from repro_torch.core.tridiag.batched import fuse_systems, split_systems  # noqa: E402
from repro_torch.core.tridiag.ragged import fuse_ragged, split_ragged  # noqa: E402
from repro_torch.kernels.common import assert_allclose_by_dtype  # noqa: E402

SIZES = {
    "single": 1000,
    "batched": (200,) * 5,
    "ragged": (30, 500, 70, 1200, 10),
}


@pytest.fixture(scope="module")
def jax_heuristic():
    return jax_fit(JaxSimulator(seed=1).dataset(reps=2))


# ------------------------------------------------------------------ plans --
@pytest.mark.parametrize("k", [1, 2, 3, 8, 1000])
@pytest.mark.parametrize("kind", sorted(SIZES))
def test_build_plan_matches_reference(kind, k):
    sizes = SIZES[kind]
    want = jplan.build_plan(sizes, 10, num_chunks=k)
    got = tplan.build_plan(sizes, 10, num_chunks=k)
    assert got.chunk_bounds == want.chunk_bounds
    assert got.halo_bounds == want.halo_bounds
    assert got.offsets == want.offsets
    assert (got.sizes, got.num_blocks, got.num_chunks) == (want.sizes, want.num_blocks, want.num_chunks)


@pytest.mark.parametrize("kind", sorted(SIZES))
def test_heuristic_policy_plans_match_reference(kind, jax_heuristic):
    sizes = SIZES[kind]
    port_h = heuristic_from_reference(jax_heuristic)
    for fp32 in (False, True):
        want = jplan.build_plan(sizes, 10, policy=jplan.HeuristicChunkPolicy(jax_heuristic, fp32=fp32))
        got = tplan.build_plan(sizes, 10, policy=tplan.HeuristicChunkPolicy(port_h, fp32=fp32))
        assert got.chunk_bounds == want.chunk_bounds


def test_build_plan_rejects_bad_requests():
    with pytest.raises(ValueError):
        tplan.build_plan(25, 10)
    with pytest.raises(ValueError):
        tplan.build_plan(100, 1)
    with pytest.raises(ValueError):
        tplan.build_plan((), 10)
    with pytest.raises(ValueError):
        tplan.build_plan(100, 10, num_chunks=0)
    with pytest.raises(ValueError):
        tplan.build_plan(100, 10, num_chunks=2, policy=tplan.FixedChunkPolicy(2))
    # A policy that rounds to 0 is clamped up, never an error.
    assert tplan.build_plan(100, 10, policy=tplan.FixedChunkPolicy(0)).num_chunks == 1


def test_plan_cache_counts_hits_and_evicts():
    tplan.clear_plan_cache()
    try:
        p1 = tplan.build_plan((40, 60), 10, num_chunks=2)
        assert tplan.build_plan((40, 60), 10, num_chunks=2) is p1
        assert tplan.plan_cache_stats() == {"hits": 1, "misses": 1, "size": 1}
        tplan.set_plan_cache_capacity(1)
        tplan.build_plan(30, 10)
        assert tplan.plan_cache_stats()["size"] == 1
        with pytest.raises(ValueError):
            tplan.set_plan_cache_capacity(-1)
    finally:
        tplan.set_plan_cache_capacity(1024)
        tplan.clear_plan_cache()


def test_plan_cache_is_safe_across_threads():
    tplan.clear_plan_cache()
    plans, errors = [], []

    def work(i):
        try:
            for j in range(50):
                plans.append(tplan.build_plan((10 * (1 + (i + j) % 7),) * 3, 10, num_chunks=2))
        except Exception as e:  # pragma: no cover - surfaced by the assert
            errors.append(e)

    threads = [threading.Thread(target=work, args=(i,)) for i in range(8)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=30)
    assert not errors and not any(t.is_alive() for t in threads)
    stats = tplan.plan_cache_stats()
    assert stats["hits"] + stats["misses"] == 400 and stats["size"] == 7
    tplan.clear_plan_cache()


def test_effective_size_and_price_chunks_match_reference(jax_heuristic):
    port_h = heuristic_from_reference(jax_heuristic)
    for sizes in (1000, (200,) * 5, (4_000_000, 7_000_000)):
        assert tplan.effective_size(sizes) == jplan.effective_size(sizes)
        for fp32 in (False, True):
            assert tplan.price_chunks(port_h, sizes, fp32=fp32) == jplan.price_chunks(
                jax_heuristic, sizes, fp32=fp32
            )


# --------------------------------------------------------------- heuristic --
def test_heuristic_from_reference_prices_every_paper_size_alike(jax_heuristic):
    port_h = heuristic_from_reference(jax_heuristic)
    assert isinstance(port_h, StreamHeuristic)
    for n in PAPER_SIZES:
        assert port_h.predict_optimum(n) == jax_heuristic.predict_optimum(n), n
        assert port_h.predict_optimum_fp32(n) == jax_heuristic.predict_optimum_fp32(n), n


def test_port_fit_matches_reference_fit_on_same_seed(jax_heuristic):
    own = fit_stream_heuristic(StreamSimulator(seed=1).dataset(reps=2))
    np.testing.assert_allclose(own.sum_model.coef, jax_heuristic.sum_model.coef, rtol=1e-9)
    for n in PAPER_SIZES:
        assert own.predict_optimum(n) == jax_heuristic.predict_optimum(n), n


def test_heuristic_from_reference_converts_a_batched_fit():
    jb = jax_fit_batched(JaxSimulator(seed=2).dataset(sizes=PAPER_SIZES[::3], batches=(1, 4)))
    pb = heuristic_from_reference(jb)
    assert isinstance(pb, BatchedStreamHeuristic)
    for sizes in ((1000,) * 4, (50_000, 400_000, 10_000)):
        assert pb.predict_optimum_ragged(sizes) == jb.predict_optimum_ragged(sizes)


def test_heuristic_from_reference_rejects_other_objects():
    with pytest.raises(TypeError):
        heuristic_from_reference(object())


# ----------------------------------------------------------------- fusion --
@pytest.mark.parametrize("dtype", [np.float32, np.float64])
def test_fuse_systems_matches_reference(dtype):
    ops = make_diag_dominant_system(50, seed=4, batch=(3,), dtype=dtype)[:4]
    ops[0][:, 0] = 7.0  # ignored couplings, zeroed in the fused copy only
    ops[2][:, -1] = 7.0
    want = jax_fuse_systems(*ops)
    got = fuse_systems(*ops)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), w)
    assert got[0][50] == 0 and got[2][49] == 0
    assert (ops[0][:, 0] == 7.0).all() and (ops[2][:, -1] == 7.0).all()
    assert split_systems(got[1], 3).shape == (3, 50)


def test_fuse_ragged_matches_reference_and_splits_back():
    systems = [make_diag_dominant_system(n, seed=n)[:4] for n in (20, 50, 10)]
    want = jax_fuse_ragged(systems)
    got = fuse_ragged(systems)
    assert got[4] == want[4] == (20, 50, 10)
    for g, w in zip(got[:4], want[:4]):
        np.testing.assert_array_equal(g.numpy(), w)
    parts = split_ragged(got[1], got[4])
    for part, s in zip(parts, systems):
        np.testing.assert_array_equal(part.numpy(), s[1])
    with pytest.raises(ValueError):
        split_ragged(got[1], (20, 50))


def test_fuse_ragged_names_the_offending_system():
    systems = [make_diag_dominant_system(n, seed=n)[:4] for n in (20, 30)]
    dl, d, du, b = systems[1]
    systems[1] = (dl, d, du[:-1], b)
    with pytest.raises(ValueError, match=r"system 1: du"):
        fuse_ragged(systems)
    with pytest.raises(ValueError, match="1-D"):
        fuse_ragged([tuple(np.ones((2, 10)) for _ in range(4))])
    with pytest.raises(ValueError):
        fuse_ragged([])


# --------------------------------------------------------------- executor --
@pytest.mark.parametrize("backend", ["reference", "cuda", "auto"])
@pytest.mark.parametrize("k", [1, 3, 8])
def test_fused_executor_matches_oracle(backend, k):
    sizes = (60, 200, 40)
    systems = [make_diag_dominant_system(n, seed=n) for n in sizes]
    dl, d, du, b, got_sizes = fuse_ragged([s[:4] for s in systems])
    plan = tplan.build_plan(got_sizes, 10, num_chunks=k)
    x, _ = tplan.FusedExecutor(backend, device="cpu").execute(plan, dl, d, du, b)
    assert isinstance(x, np.ndarray) and x.dtype == np.float64
    for xi, s in zip(split_ragged(x, sizes), systems):
        assert_allclose_by_dtype(xi, thomas_numpy(*s[:4]), np.float64)


def test_chunk_count_does_not_change_the_answer_bitwise():
    dl, d, du, b, _ = make_diag_dominant_system(400, seed=9)
    ex = tplan.FusedExecutor("cuda", device="cpu")
    one, _ = ex.execute(tplan.build_plan(400, 10, num_chunks=1), dl, d, du, b)
    for k in (2, 8):
        np.testing.assert_array_equal(ex.execute(tplan.build_plan(400, 10, num_chunks=k), dl, d, du, b)[0], one)


def test_resolve_backend():
    assert tplan.resolve_backend(None).name == "reference"
    assert tplan.resolve_backend("auto", torch.device("cpu")).name == "reference"
    assert tplan.resolve_backend("auto", torch.device("cuda")).name == "cuda"
    assert tplan.resolve_backend(tplan.CudaBackend()).name == "cuda"
    with pytest.raises(ValueError, match="known"):
        tplan.resolve_backend("pallas")
    with pytest.raises(TypeError):
        tplan.resolve_backend(3)
