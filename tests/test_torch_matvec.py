"""Parity of the port's tridiagonal matvec with the JAX reference.

The plain version (``repro_torch.core.tridiag.matvec``), and the kernel
wrapper on CPU tensors, against ``tridiag_matvec_pallas`` in interpret mode
and ``tridiag_matvec_ref`` on the same numpy inputs, at the tolerance ladder
(fp64 1e-12, fp32 1e-5). The CUDA kernel itself runs only on the card, where
``chip_smoke.py`` holds it against the plain version.
"""

import numpy as np
import pytest
import torch

from repro.core.tridiag import ensure_x64

ensure_x64()

import repro.api  # noqa: E402,F401  (before repro.telemetry: import-order cycle)
import jax.numpy as jnp  # noqa: E402

from repro.core.tridiag.reference import make_diag_dominant_system  # noqa: E402
from repro.kernels import tridiag_matvec_pallas  # noqa: E402
from repro.kernels.tridiag_matvec.ref import tridiag_matvec_ref  # noqa: E402
from repro_torch.core.tridiag.matvec import tridiag_matvec  # noqa: E402
from repro_torch.kernels import LAUNCH_COUNTERS, tridiag_matvec_cuda  # noqa: E402
from repro_torch.kernels.common import assert_allclose_by_dtype  # noqa: E402


def _system(n, dtype):
    rng = np.random.default_rng(n)
    return tuple(rng.standard_normal(n).astype(dtype) for _ in range(4))


@pytest.mark.parametrize("dtype", [np.float32, np.float64])
@pytest.mark.parametrize("n", [1, 5, 128, 1000, 4099])
def test_plain_matvec_matches_pallas_kernel_and_oracle(n, dtype):
    ops = _system(n, dtype)
    want_k = np.asarray(tridiag_matvec_pallas(*(jnp.asarray(a) for a in ops), interpret=True))
    want_r = np.asarray(tridiag_matvec_ref(*(jnp.asarray(a) for a in ops)))
    before = LAUNCH_COUNTERS["tridiag_matvec"].count
    for fn in (tridiag_matvec, tridiag_matvec_cuda):
        got = fn(*(torch.from_numpy(a) for a in ops))
        assert got.shape == (n,) and got.dtype == torch.from_numpy(ops[1]).dtype
        assert_allclose_by_dtype(got, want_k, dtype)
        assert_allclose_by_dtype(got, want_r, dtype)
    assert LAUNCH_COUNTERS["tridiag_matvec"].count == before


def test_residual_of_an_exact_solution_is_small():
    dl, d, du, b, x = make_diag_dominant_system(1000, seed=3, dtype=np.float64)
    r = tridiag_matvec_cuda(*(torch.from_numpy(a) for a in (dl, d, du, x)))
    assert float((r - torch.from_numpy(b)).abs().max()) < 1e-12


def test_matvec_ignores_the_outer_couplings():
    dl, d, du, x = (torch.from_numpy(a) for a in _system(16, np.float64))
    dl2, du2 = dl.clone(), du.clone()
    dl2[0], du2[-1] = 1e6, -1e6
    assert torch.equal(tridiag_matvec_cuda(dl2, d, du2, x), tridiag_matvec_cuda(dl, d, du, x))


def test_matvec_rejects_bad_shapes():
    dl, d, du, x = (torch.from_numpy(a) for a in _system(8, np.float64))
    with pytest.raises(ValueError, match="x has shape"):
        tridiag_matvec_cuda(dl, d, du, x[:4])
    with pytest.raises(ValueError, match=r"one \(N,\) system"):
        tridiag_matvec_cuda(*(a.reshape(2, 4) for a in (dl, d, du, x)))
