"""The port's wide Stage 1 with a row count and ignored ends, and the wide
reduced solve without level-0 copies, against the JAX package on the CPU.

On the card the wide Stage 1 kernel takes a lane's (n, B) rows as they are:
P = ⌈n/m⌉ blocks, the rows past n read as identity rows, and with
``zero_ends`` dl[0] and du[n-1] read as zero; the wide reduced solve
(``solve_levels`` with ``wide=True``) hands it the caller's rows and never
copies them. Here the plain wide Stage 1, which does the same in plain torch,
is held to ``partition_stage1_pallas_wide`` (interpret mode) on the same
operands zeroed and identity-padded in numpy, and the wide levels driven by
the plain stages are held to ``thomas_pallas_wide``, with ``_level0`` made
to raise. Inputs are made with numpy from a seed; the tolerance ladder is
fp64 1e-12, fp32 1e-5.
"""

import numpy as np
import pytest
import torch

from repro.core.tridiag import ensure_x64

ensure_x64()

import repro.api  # noqa: E402,F401  (before repro.telemetry: import-order cycle)
import jax.numpy as jnp  # noqa: E402

from repro.core.tridiag.reference import make_diag_dominant_system  # noqa: E402
from repro.kernels.partition_stage1.ops import partition_stage1_pallas_wide  # noqa: E402
from repro.kernels.thomas.ops import thomas_pallas_wide  # noqa: E402
from repro_torch.core.tridiag import layout, partition  # noqa: E402
from repro_torch.core.tridiag.thomas import thomas  # noqa: E402
from repro_torch.kernels.common import assert_allclose_by_dtype  # noqa: E402
from repro_torch.kernels.partition_stage1.ops import partition_stage1_cuda_wide  # noqa: E402
from repro_torch.kernels.thomas import ops as thomas_ops  # noqa: E402

DTYPES = [np.float32, np.float64]
N0_SMALL = 64
R = thomas_ops.R
PLAIN_WIDE = dict(
    stage1=layout.partition_stage1_wide, stage3=layout.partition_stage3_wide, base=layout.thomas_wide
)


def _rows(n, bsz, dtype, seed):
    """(n, B) rows of B diagonally dominant systems, with loud ignored ends:
    dl[0] = 1e3 and du[n-1] = -1e3 in every lane."""
    system = make_diag_dominant_system(n, seed=seed, batch=(bsz,), dtype=dtype)[:4]
    ops = [np.ascontiguousarray(a.T) for a in system]
    ops[0][0] = 1e3
    ops[2][n - 1] = -1e3
    return ops


def _blocks_numpy(ops, m, zero_ends):
    """The rows zeroed at the ends (with ``zero_ends``) and padded with
    identity rows to P*m, as (P, m, B) blocks: numpy only."""
    n, bsz = ops[1].shape
    p = -(-n // m)
    out = []
    for a, fill in zip(ops, (0.0, 1.0, 0.0, 0.0)):
        full = np.full((p * m, bsz), fill, dtype=a.dtype)
        full[:n] = a
        out.append(full)
    if zero_ends:
        out[0][0] = 0.0
        out[2][n - 1] = 0.0
    return [a.reshape(p, m, bsz) for a in out]


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("zero_ends", [False, True])
@pytest.mark.parametrize("bsz", [3, 64])
@pytest.mark.parametrize("short", [0, 1, "half"])
@pytest.mark.parametrize("m", [2, 10, 32])
def test_plain_wide_stage1_rows_match_pallas_on_padded_blocks(m, short, bsz, zero_ends, dtype):
    p = 5
    n = p * m - (max(1, m // 2) if short == "half" else short)
    ops = _rows(n, bsz, dtype, seed=10 * m + bsz + n)
    want = partition_stage1_pallas_wide(*(jnp.asarray(a) for a in _blocks_numpy(ops, m, zero_ends)), m=m)
    tensors = [torch.from_numpy(a.copy()) for a in ops]
    got = layout.partition_stage1_wide(*tensors, m=m, zero_ends=zero_ends)
    assert tuple(got.y.shape) == (p, m - 1, bsz) and tuple(got.red_d.shape) == (p, bsz)
    for g, w in zip(got, want):
        assert_allclose_by_dtype(g, np.asarray(w), dtype)
    for t, a in zip(tensors, ops):
        assert np.array_equal(t.numpy(), a)


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("zero_ends", [False, True])
def test_plain_wide_stage1_blocks_and_rows_agree(zero_ends, dtype):
    """(P, m, B) blocks and the same rows as (P·m, B) give the same bits,
    through the plain stage and through the wrapper's CPU path."""
    m, p, bsz = 10, 7, 5
    ops = _rows(p * m, bsz, dtype, seed=3)
    rows = [torch.from_numpy(a) for a in ops]
    blocks = [a.reshape(p, m, bsz) for a in rows]
    from_rows = layout.partition_stage1_wide(*rows, m=m, zero_ends=zero_ends)
    from_blocks = layout.partition_stage1_wide(*blocks, m=m, zero_ends=zero_ends)
    for a, b in zip(from_rows, from_blocks):
        torch.testing.assert_close(a, b, rtol=0, atol=0)
    if not zero_ends:
        for a, b in zip(partition_stage1_cuda_wide(*blocks, m=m), from_blocks):
            torch.testing.assert_close(a, b, rtol=0, atol=0)


def _forbid_level0(monkeypatch):
    def raising(*args, **kwargs):
        raise AssertionError("the wide route copied the caller's rows (_level0)")

    monkeypatch.setattr(thomas_ops, "_level0", raising)


# One level at its edges (100; 2048 = R·N0_SMALL, r divides it), two levels
# (2049, 4096 with r dividing both levels, 4103), at a base of N0_SMALL rows.
LEVEL_SIZES = [100, R * N0_SMALL, R * N0_SMALL + 1, 2 * R * N0_SMALL, 2 * R * N0_SMALL + 7]


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("bsz", [1, 3, 64])
@pytest.mark.parametrize("n", LEVEL_SIZES)
def test_wide_levels_read_the_callers_rows_as_they_are(n, bsz, dtype, monkeypatch):
    """The wide route with the plain stages: no ``_level0``, the caller's
    tensors unchanged, the loud ignored ends without effect (bit for bit
    against the same rows with those ends zeroed), and the answer of
    ``thomas_pallas_wide``."""
    _forbid_level0(monkeypatch)
    loud = _rows(n, bsz, dtype, seed=n + bsz)
    zeroed = [a.copy() for a in loud]
    zeroed[0][0] = 0.0
    zeroed[2][n - 1] = 0.0
    tensors = [torch.from_numpy(a.copy()) for a in loud]
    got = thomas_ops.solve_levels(*tensors, wide=True, n0=N0_SMALL, **PLAIN_WIDE)
    for t, a in zip(tensors, loud):
        assert np.array_equal(t.numpy(), a)
    quiet = thomas_ops.solve_levels(*(torch.from_numpy(a) for a in zeroed), wide=True, n0=N0_SMALL,
                                    **PLAIN_WIDE)
    torch.testing.assert_close(got, quiet, rtol=0, atol=0)
    assert tuple(got.shape) == (n, bsz) and got.dtype == tensors[1].dtype
    want = thomas_pallas_wide(*(jnp.asarray(a) for a in loud), block_b=128)
    assert_allclose_by_dtype(got, np.asarray(want), dtype)


@pytest.mark.parametrize("n", [R * thomas_ops.N0 - 1, R * thomas_ops.N0 + 1])
def test_wide_levels_at_the_module_base_size_skip_level0(n, monkeypatch):
    _forbid_level0(monkeypatch)
    ops = _rows(n, 3, np.float64, seed=n)
    got = thomas_ops.solve_levels(*(torch.from_numpy(a) for a in ops), wide=True, **PLAIN_WIDE)
    want = thomas_pallas_wide(*(jnp.asarray(a) for a in ops), block_b=128)
    assert_allclose_by_dtype(got, np.asarray(want), np.float64)


def test_system_major_levels_still_copy_when_r_does_not_divide_n(monkeypatch):
    """The (B, n) route keeps its level-0 copy where n needs padding."""
    calls = []
    level0 = thomas_ops._level0

    def counting(ops, rows):
        calls.append(rows)
        return level0(ops, rows)

    monkeypatch.setattr(thomas_ops, "_level0", counting)
    n = R * N0_SMALL + 1
    ops = [torch.from_numpy(np.ascontiguousarray(a.T)) for a in _rows(n, 3, np.float64, seed=5)]
    thomas_ops.solve_levels(*ops, wide=False, n0=N0_SMALL, stage1=partition.partition_stage1,
                            stage3=partition.partition_stage3, base=thomas)
    assert calls == [R * (N0_SMALL + 1)]
