"""The port's functional batched solvers against the JAX package's, on the CPU.

``repro_torch.core.tridiag.batched.solve_batched`` / ``thomas_batched`` and
``repro.core.tridiag.batched.solve_batched`` / ``thomas_batched`` take the
same seeded (B, n) operands (the cases of ``tests/test_batched_tridiag.py``)
and must agree within the tolerance ladder (fp64 1e-12, fp32 1e-5); the
shape errors must match. On the card the port's functions launch one
batched Stage 1, one reduced solve and one batched Stage 3 (``chip_smoke.py``
counts them); here, on CPU tensors, they run the plain stages.
"""

import numpy as np
import pytest
import torch

from repro.core.tridiag import ensure_x64

ensure_x64()

from repro.core.tridiag import batched as jbatched  # noqa: E402
from repro.core.tridiag.reference import make_diag_dominant_system, thomas_numpy  # noqa: E402
from repro_torch.core.tridiag import batched as tbatched  # noqa: E402
from repro_torch.kernels.common import assert_allclose_by_dtype  # noqa: E402


def _per_system_ref(dl, d, du, b):
    return np.stack([thomas_numpy(*(a[i] for a in (dl, d, du, b))) for i in range(d.shape[0])])


@pytest.mark.parametrize("dtype", [np.float64, np.float32])
@pytest.mark.parametrize("bsz,n,m", [(1, 200, 10), (4, 120, 10), (9, 60, 3)])
def test_solve_batched_matches_reference(bsz, n, m, dtype):
    ops = make_diag_dominant_system(n, seed=bsz + n, batch=(bsz,), dtype=dtype)[:4]
    want = np.asarray(jbatched.solve_batched(*ops, m=m))
    got = tbatched.solve_batched(*ops, m=m, device="cpu")
    assert isinstance(got, torch.Tensor) and got.device.type == "cpu"
    assert tuple(got.shape) == want.shape == (bsz, n)
    assert got.numpy().dtype == want.dtype == np.dtype(dtype)
    assert_allclose_by_dtype(got, want, dtype)
    assert_allclose_by_dtype(got, _per_system_ref(*ops), dtype)


@pytest.mark.parametrize("dtype", [np.float64, np.float32])
@pytest.mark.parametrize("bsz,n", [(6, 75), (1, 200), (9, 60)])
def test_thomas_batched_matches_reference(bsz, n, dtype):
    ops = make_diag_dominant_system(n, seed=2 + bsz, batch=(bsz,), dtype=dtype)[:4]
    want = np.asarray(jbatched.thomas_batched(*ops))
    got = tbatched.thomas_batched(*ops, device="cpu")
    assert isinstance(got, torch.Tensor) and got.numpy().dtype == want.dtype
    assert_allclose_by_dtype(got, want, dtype)


def test_solvers_take_tensors_and_leave_them_unchanged():
    ops = make_diag_dominant_system(120, seed=3, batch=(4,))[:4]
    tensors = [torch.from_numpy(a.copy()) for a in ops]
    x = tbatched.solve_batched(*tensors, m=10, device="cpu")
    y = tbatched.thomas_batched(*tensors, device="cpu")
    for t, a in zip(tensors, ops):
        np.testing.assert_array_equal(t.numpy(), a)
    assert_allclose_by_dtype(x, y, np.float64)


def test_mixed_dtypes_promote_as_torch_does():
    ops = list(make_diag_dominant_system(120, seed=4, batch=(2,))[:4])
    ops[0] = ops[0].astype(np.float32)
    x = tbatched.solve_batched(*ops, m=10, device="cpu")
    assert x.dtype == torch.float64
    assert_allclose_by_dtype(x, _per_system_ref(*ops), np.float64)


@pytest.mark.parametrize("fn", ["solve_batched", "thomas_batched"])
def test_solvers_reject_bad_shapes_as_the_reference_does(fn):
    port = getattr(tbatched, fn)
    ref = getattr(jbatched, fn)
    one = make_diag_dominant_system(50, seed=0)[:4]
    with pytest.raises(ValueError):
        ref(*one)  # 1-D, not (batch, n)
    with pytest.raises(ValueError, match="batch, n"):
        port(*one, device="cpu")
    three = make_diag_dominant_system(50, seed=0, batch=(2, 2))[:4]
    with pytest.raises(ValueError, match="batch, n"):
        port(*three, device="cpu")


def test_solve_batched_rejects_m_not_dividing_n():
    ops = make_diag_dominant_system(50, seed=0, batch=(2,))[:4]
    with pytest.raises(ValueError):
        jbatched.solve_batched(*ops, m=7)
    with pytest.raises(ValueError, match="divisible"):
        tbatched.solve_batched(*ops, m=7, device="cpu")


def test_unequal_operand_shapes_raise():
    dl, d, du, b = make_diag_dominant_system(60, seed=1, batch=(3,))[:4]
    with pytest.raises(ValueError, match="du has shape"):
        tbatched.thomas_batched(dl, d, du[:, :50], b, device="cpu")


def test_the_card_is_the_default_device():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present; the missing-card error cannot occur")
    ops = make_diag_dominant_system(60, seed=1, batch=(3,))[:4]
    for fn in (tbatched.solve_batched, tbatched.thomas_batched):
        with pytest.raises(RuntimeError, match="CUDA"):
            fn(*ops)
