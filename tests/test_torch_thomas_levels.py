"""The reduced solve's levels (``repro_torch.kernels.thomas.ops.solve_levels``)
against the JAX package's Thomas kernels in interpret mode.

On the card the reduced solve is the partition method applied to itself:
Stage 1 with m = R, the reduced rows recursively, Stage 3, and the one-thread
Thomas body at N0 rows or fewer. Here the same orchestration runs with the
plain stages (``partition_stage1``/``partition_stage3`` on (B, n) rows,
``partition_stage1_wide``/``partition_stage3_wide`` on (n, B) rows, plain
``thomas``/``thomas_wide`` as the base), on inputs made with numpy from a
seed, and is held to ``thomas_pallas`` / ``thomas_pallas_wide`` at the
tolerance ladder (fp64 1e-12, fp32 1e-5). The sizes are the edges of the
level structure at the module's own R, with a base of N0_SMALL rows (so
that three levels stay small enough for interpret mode) and at the
module's own N0.
"""

import numpy as np
import pytest
import torch

from repro.core.tridiag import ensure_x64

ensure_x64()

import repro.api  # noqa: E402,F401  (before repro.telemetry: import-order cycle)
import jax.numpy as jnp  # noqa: E402

from repro.core.tridiag.reference import make_diag_dominant_system  # noqa: E402
from repro.kernels.thomas.ops import thomas_pallas, thomas_pallas_wide  # noqa: E402
from repro_torch.core.tridiag import layout, partition  # noqa: E402
from repro_torch.core.tridiag.thomas import thomas  # noqa: E402
from repro_torch.kernels.common import assert_allclose_by_dtype  # noqa: E402
from repro_torch.kernels.thomas.ops import N0, R, level_sizes, solve_levels  # noqa: E402

DTYPES = [np.float32, np.float64]
N0_SMALL = 64
# No level, the base alone at its edges, one level at its edges, two
# levels, three levels (at a base of N0_SMALL rows).
SIZES = [1, 2, N0_SMALL, N0_SMALL + 1, R * N0_SMALL - 1, R * N0_SMALL + 1, R * R * N0_SMALL + 1]
# The base at its edges and one level at its edges, at the module's N0.
MODULE_SIZES = [N0, N0 + 1, R * N0 - 1, R * N0 + 1]
BATCHES = [1, 3, 64]

PLAIN = {
    False: dict(stage1=partition.partition_stage1, stage3=partition.partition_stage3, base=thomas),
    True: dict(
        stage1=layout.partition_stage1_wide, stage3=layout.partition_stage3_wide, base=layout.thomas_wide
    ),
}


def _system(n, bsz, dtype, seed):
    return make_diag_dominant_system(n, seed=seed, batch=(bsz,), dtype=dtype)[:4]


def _levels(ops, wide, n0=N0):
    return solve_levels(*(torch.from_numpy(np.array(a)) for a in ops), wide=wide, n0=n0, **PLAIN[wide])


def test_level_sizes_end_at_the_base():
    assert SIZES[-1] > R * N0_SMALL
    assert len(level_sizes(SIZES[-1], n0=N0_SMALL)) == 4  # three partition levels and the base
    assert level_sizes(1_000_000) == [1_000_000, 31_250, 977, 31]
    for n0 in (N0_SMALL, N0):
        for n in SIZES + MODULE_SIZES + [1_000_000, 640_000, 10_000, 1_000]:
            sizes = level_sizes(n, n0=n0)
            assert sizes[0] == n and sizes[-1] <= n0
            assert all(a > n0 and b == -(-a // R) for a, b in zip(sizes, sizes[1:]))


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("bsz", BATCHES)
@pytest.mark.parametrize("n", SIZES)
def test_levels_match_thomas_pallas(n, bsz, dtype):
    ops = _system(n, bsz, dtype, seed=n + bsz)
    want = thomas_pallas(*(jnp.asarray(a) for a in ops), block_b=128)
    got = _levels(ops, wide=False, n0=N0_SMALL)
    assert tuple(got.shape) == (bsz, n) and got.dtype == torch.from_numpy(ops[1]).dtype
    assert_allclose_by_dtype(got, np.asarray(want), dtype)


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("bsz", BATCHES)
@pytest.mark.parametrize("n", SIZES)
def test_wide_levels_match_thomas_pallas_wide(n, bsz, dtype):
    ops = tuple(np.ascontiguousarray(a.T) for a in _system(n, bsz, dtype, seed=2 * n + bsz))
    want = thomas_pallas_wide(*(jnp.asarray(a) for a in ops), block_b=128)
    got = _levels(ops, wide=True, n0=N0_SMALL)
    assert tuple(got.shape) == (n, bsz) and got.dtype == torch.from_numpy(ops[1]).dtype
    assert_allclose_by_dtype(got, np.asarray(want), dtype)


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("bsz", [1, 3])
@pytest.mark.parametrize("n", MODULE_SIZES)
@pytest.mark.parametrize("wide", [False, True])
def test_levels_at_the_module_base_size(wide, n, bsz, dtype):
    ops = _system(n, bsz, dtype, seed=3 * n + bsz)
    if wide:
        ops = tuple(np.ascontiguousarray(a.T) for a in ops)
    ref = thomas_pallas_wide if wide else thomas_pallas
    want = ref(*(jnp.asarray(a) for a in ops), block_b=128)
    got = _levels(ops, wide)
    assert len(level_sizes(n)) == 1 + (n > N0) + (n > R * N0)
    assert_allclose_by_dtype(got, np.asarray(want), dtype)


@pytest.mark.parametrize("wide", [False, True])
def test_ignored_couplings_do_not_change_the_answer(wide):
    """Thomas ignores dl[0] and du[n-1]; the levels must too, though the
    partition couples through them."""
    n = R * N0 + 1
    ops = [np.array(a) for a in _system(n, 3, np.float64, seed=7)]
    ops[0][:, 0], ops[2][:, -1] = 0.0, 0.0
    zeroed = [a.T.copy() if wide else a for a in ops]
    ops[0][:, 0], ops[2][:, -1] = 1e3, -1e3
    loud = [a.T.copy() if wide else a for a in ops]
    want = _levels(zeroed, wide)
    got = _levels(loud, wide)
    torch.testing.assert_close(got, want, rtol=0, atol=0)
    ref = thomas_pallas_wide if wide else thomas_pallas
    assert_allclose_by_dtype(got, np.asarray(ref(*(jnp.asarray(a) for a in loud))), np.float64)


@pytest.mark.parametrize("wide", [False, True])
def test_levels_leave_the_callers_tensors_unchanged(wide):
    n = R * N0 + 1
    ops = [np.array(a) for a in _system(n, 3, np.float64, seed=9)]
    if wide:
        ops = [a.T.copy() for a in ops]
    tensors = [torch.from_numpy(a.copy()) for a in ops]
    solve_levels(*tensors, wide=wide, **PLAIN[wide])
    for t, a in zip(tensors, ops):
        assert np.array_equal(t.numpy(), a)
