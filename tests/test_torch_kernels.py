"""Parity of the port's kernel wrappers (their plain PyTorch path on CPU
tensors) with the JAX package's Pallas kernels run in interpret mode.

The same inputs, made with numpy from a seed, go through both packages and
are compared at the tolerance ladder (fp64 1e-12, fp32 1e-5). The CUDA
kernels themselves run only on the card, where ``chip_smoke.py`` holds each
one against these plain versions.
"""

import shutil

import numpy as np
import pytest
import torch

from repro.core.tridiag import ensure_x64

ensure_x64()

import repro.api  # noqa: E402,F401  (before repro.telemetry: import-order cycle)
import jax.numpy as jnp  # noqa: E402

from repro.core.tridiag.reference import make_diag_dominant_system  # noqa: E402
from repro.kernels.partition_stage1.ops import (  # noqa: E402
    partition_stage1_pallas,
    partition_stage1_pallas_batched,
)
from repro.kernels.partition_stage3.ops import (  # noqa: E402
    partition_stage3_pallas,
    partition_stage3_pallas_batched,
)
from repro.kernels.thomas.ops import thomas_pallas  # noqa: E402
from repro_torch.core.tridiag import partition as tpartition  # noqa: E402
from repro_torch.kernels import LAUNCH_COUNTERS  # noqa: E402
from repro_torch.kernels.common import assert_allclose_by_dtype  # noqa: E402
from repro_torch.kernels.partition_stage1.ops import (  # noqa: E402
    partition_stage1_cuda,
    partition_stage1_cuda_batched,
)
from repro_torch.kernels.partition_stage3.ops import (  # noqa: E402
    partition_stage3_cuda,
    partition_stage3_cuda_batched,
)
from repro_torch.kernels.thomas.ops import thomas_cuda  # noqa: E402

DTYPES = [np.float32, np.float64]


def _both(arrays):
    return tuple(jnp.asarray(a) for a in arrays), tuple(torch.from_numpy(np.array(a)) for a in arrays)


def _assert_coeffs(got, want, dtype):
    assert len(got) == len(want) == 7
    for g, w in zip(got, want):
        assert tuple(g.shape) == tuple(w.shape)
        assert_allclose_by_dtype(g, np.asarray(w), dtype)


# ----------------------------------------------------------------- stage 1 --
@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("p,m", [(4, 10), (100, 10), (129, 10), (7, 2), (33, 5), (512, 4)])
def test_stage1_matches_pallas(p, m, dtype):
    dl, d, du, b, _ = make_diag_dominant_system(p * m, seed=p + m, dtype=dtype)
    jx, tx = _both((dl, d, du, b))
    want = partition_stage1_pallas(*jx, m=m, block_p=128)
    got = partition_stage1_cuda(*tx, m=m)
    assert got.y.dtype == tx[0].dtype
    _assert_coeffs(got, want, dtype)


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("bsz,p,m", [(3, 20, 10), (2, 9, 2), (4, 16, 4), (3, 11, 5)])
def test_stage1_batched_matches_pallas(bsz, p, m, dtype):
    dl, d, du, b, _ = make_diag_dominant_system(p * m, seed=bsz * p + m, batch=(bsz,), dtype=dtype)
    jx, tx = _both((dl, d, du, b))
    want = partition_stage1_pallas_batched(*jx, m=m, block_p=128)
    got = partition_stage1_cuda_batched(*tx, m=m)
    _assert_coeffs(got, want, dtype)
    # The next-block shift stops at each system's end: every last block of
    # every system has no right coupling (du[n-1] = 0 by convention).
    assert torch.all(got.red_du[:, -1] == 0)


# ------------------------------------------------------------------ thomas --
@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("bsz,n", [(1, 8), (3, 17), (64, 10), (130, 33)])
def test_thomas_matches_pallas(bsz, n, dtype):
    dl, d, du, b, _ = make_diag_dominant_system(n, seed=bsz * n, batch=(bsz,), dtype=dtype)
    jx, tx = _both((dl, d, du, b))
    want = thomas_pallas(*jx, block_b=128)
    got = thomas_cuda(*tx)
    assert tuple(got.shape) == (bsz, n) and got.dtype == tx[1].dtype
    assert_allclose_by_dtype(got, np.asarray(want), dtype)


@pytest.mark.parametrize("dtype", DTYPES)
def test_thomas_1d_matches_pallas(dtype):
    dl, d, du, b, _ = make_diag_dominant_system(31, seed=5, dtype=dtype)
    jx, tx = _both((dl, d, du, b))
    got = thomas_cuda(*tx)
    assert tuple(got.shape) == (31,)
    assert_allclose_by_dtype(got, np.asarray(thomas_pallas(*jx)), dtype)


# ----------------------------------------------------------------- stage 3 --
@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("p,m", [(4, 10), (100, 10), (129, 3), (7, 2)])
def test_stage3_matches_pallas(p, m, dtype):
    dl, d, du, b, _ = make_diag_dominant_system(p * m, seed=p * m, dtype=dtype)
    jx, tx = _both((dl, d, du, b))
    coeffs = partition_stage1_pallas(*jx, m=m, block_p=128)
    s = np.random.default_rng(p).standard_normal(p).astype(dtype)
    want = partition_stage3_pallas(coeffs, jnp.asarray(s), block_p=128)
    tcoeffs = tpartition.PartitionCoeffs(*(torch.from_numpy(np.array(c)) for c in coeffs))
    got = partition_stage3_cuda(tcoeffs, torch.from_numpy(s))
    assert tuple(got.shape) == (p * m,)
    assert_allclose_by_dtype(got, np.asarray(want), dtype)


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("bsz,p,m", [(3, 20, 10), (2, 9, 5)])
def test_stage3_batched_matches_pallas(bsz, p, m, dtype):
    dl, d, du, b, _ = make_diag_dominant_system(p * m, seed=p + bsz, batch=(bsz,), dtype=dtype)
    jx, _ = _both((dl, d, du, b))
    coeffs = partition_stage1_pallas_batched(*jx, m=m, block_p=128)
    s = np.random.default_rng(bsz).standard_normal((bsz, p)).astype(dtype)
    want = partition_stage3_pallas_batched(coeffs, jnp.asarray(s), block_p=128)
    tcoeffs = tpartition.PartitionCoeffs(*(torch.from_numpy(np.array(c)) for c in coeffs))
    got = partition_stage3_cuda_batched(tcoeffs, torch.from_numpy(s))
    assert tuple(got.shape) == (bsz, p * m)
    assert_allclose_by_dtype(got, np.asarray(want), dtype)


def test_stage3_left_edge_is_the_neighbours_interface_value():
    """Stage 3 on the second half of a system, given the first half's last
    interface value as ``left``, equals the whole system's second half."""
    p, m = 10, 4
    dl, d, du, b, _ = make_diag_dominant_system(p * m, seed=3)
    c = tpartition.partition_stage1(*(torch.from_numpy(a) for a in (dl, d, du, b)), m)
    s = tpartition.partition_stage2(c)
    whole = partition_stage3_cuda(c, s)
    half = tpartition.PartitionCoeffs(*(a[5:] for a in c))
    got = partition_stage3_cuda(half, s[5:], s[4])
    torch.testing.assert_close(got, whole[5 * m :], rtol=0, atol=0)


# ------------------------------------------------------- wrapper contract --
def test_cpu_tensors_take_the_plain_path_without_counting():
    from repro_torch.kernels.partition_stage1.ops import partition_stage1_cuda_wide
    from repro_torch.kernels.partition_stage3.ops import partition_stage3_cuda_wide
    from repro_torch.kernels.ssd_stage1.ops import ssd_stage1_backward_cuda, ssd_stage1_cuda
    from repro_torch.kernels.thomas.ops import thomas_cuda_wide
    from repro_torch.kernels.tridiag_matvec.ops import tridiag_matvec_cuda

    before = {k: c.count for k, c in LAUNCH_COUNTERS.items()}
    dl, d, du, b, _ = (torch.from_numpy(a) for a in make_diag_dominant_system(40, seed=1))
    c = partition_stage1_cuda(dl, d, du, b, m=10)
    partition_stage3_cuda(c, thomas_cuda(c.red_dl, c.red_d, c.red_du, c.red_b))
    cw = partition_stage1_cuda_wide(*(a.reshape(2, 10, 2) for a in (dl, d, du, b)), m=10)
    partition_stage3_cuda_wide(cw, thomas_cuda_wide(cw.red_dl, cw.red_d, cw.red_du, cw.red_b))
    tridiag_matvec_cuda(dl, d, du, b)
    ssd_stage1_cuda(torch.ones(1, 4, 2, 3), -torch.ones(1, 4, 2), torch.ones(1, 4, 5),
                    torch.ones(1, 4, 5))
    ssd_stage1_backward_cuda(torch.ones(1, 4, 2, 3), -torch.ones(1, 4, 2), torch.ones(1, 4, 5),
                             torch.ones(1, 4, 5), torch.ones(1, 4, 2, 3), torch.ones(1, 2, 3, 5))
    assert {k: c.count for k, c in LAUNCH_COUNTERS.items()} == before
    assert set(LAUNCH_COUNTERS) == {
        "partition_stage1",
        "thomas",
        "partition_stage3",
        "partition_stage1_wide",
        "thomas_wide",
        "partition_stage3_wide",
        "ssd_stage1",
        "ssd_stage1_bwd",
        "tridiag_matvec",
    }


@pytest.mark.parametrize(
    "case",
    ["m_too_small", "not_divisible", "shape_mismatch", "wrong_ndim", "meta_device"],
)
def test_wrappers_reject_what_the_kernels_do_not_take(case):
    t = [torch.from_numpy(a) for a in make_diag_dominant_system(40, seed=2)[:4]]
    with pytest.raises((ValueError, TypeError)):
        if case == "m_too_small":
            partition_stage1_cuda(*t, m=1)
        elif case == "not_divisible":
            partition_stage1_cuda(*t, m=7)
        elif case == "shape_mismatch":
            thomas_cuda(t[0][:-1], *t[1:])
        elif case == "wrong_ndim":
            partition_stage1_cuda_batched(*t, m=10)
        else:
            thomas_cuda(*(a.to("meta") for a in t))


# ------------------------------------------------------------ build hash --
@pytest.mark.parametrize("header", ["common.cuh", "ssd_tf32.cuh"])
def test_library_path_follows_every_header(header, tmp_path, monkeypatch):
    from repro_torch.kernels import build

    csrc = tmp_path / "csrc"
    shutil.copytree(build.CSRC_DIR, csrc)
    monkeypatch.setattr(build, "CSRC_DIR", csrc)
    before = {name: build.library_path(name) for name in build.SOURCES}
    path = csrc / header
    text = path.read_bytes()
    path.write_bytes(text + b"\n// edited\n")
    for name in build.SOURCES:
        assert build.library_path(name) != before[name], (name, header)
    path.write_bytes(text)
    assert {name: build.library_path(name) for name in build.SOURCES} == before
    (csrc / "added.cuh").write_bytes(b"#pragma once\n")
    assert all(build.library_path(name) != before[name] for name in build.SOURCES)
