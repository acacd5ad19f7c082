"""The SSD Stage 1 kernel's split-TF32 numerics, emulated on the CPU.

``csrc/ssd_stage1.cu`` runs its three products (the scores C·Bᵀ, the
decayed scores times u, and the decayed u times B) on the tensor cores in
split TF32: each fp32 operand x is split as hi = cvt.rna.tf32(x) (round to
10 mantissa bits, ties away from zero) and lo = cvt.rna.tf32(x - hi), and a
product is lo·hi + hi·lo + hi·hi accumulated in fp32; the decay is applied
in fp32 before the split. This file emulates that on CPU tensors (a
product of two TF32 values is exact in fp32, so fp32 matmuls of the parts
are the MMA's products) at mamba2-1.3b's widths, with inputs made by numpy
from a seed as in ``chip_smoke.py``, and holds the result to the fp32
ladder (rtol 1e-5, atol 1e-4) against JAX's ``ssd_stage1_ref`` and the
port's plain ``ssd_stage1``. One TF32 product alone (hi·hi) misses the
ladder on the same inputs: that is why the kernel splits.
"""

import numpy as np
import pytest
import torch

from repro.core.tridiag import ensure_x64

ensure_x64()

import jax.numpy as jnp  # noqa: E402

from repro.kernels.ssd_stage1.ref import ssd_stage1_ref  # noqa: E402
from repro_torch.kernels.common import assert_allclose_by_dtype  # noqa: E402
from repro_torch.models.layers.ssm import ssd_stage1  # noqa: E402

H, P, N = 64, 64, 128  # mamba2-1.3b: heads, head dim, state


def rna_tf32(x: torch.Tensor) -> torch.Tensor:
    """cvt.rna.tf32.f32: fp32 rounded to 10 mantissa bits, ties away from
    zero (on the sign-magnitude bits, adding half of the dropped 13 bits'
    unit rounds the magnitude)."""
    bits = x.contiguous().view(torch.int32)
    return ((bits + 0x1000) & -0x2000).view(torch.float32)


def split(x: torch.Tensor):
    hi = rna_tf32(x)
    return hi, rna_tf32(x - hi)


def mm_split(a: torch.Tensor, b: torch.Tensor, passes: int = 3) -> torch.Tensor:
    """a @ b (batched) as the kernel's MMAs take it: 3 passes
    (lo·hi + hi·lo + hi·hi) or 1 (hi·hi, single-pass TF32)."""
    ahi, alo = split(a)
    bhi, blo = split(b)
    if passes == 1:
        return ahi @ bhi
    return (alo @ bhi + ahi @ blo) + ahi @ bhi


def stage1_emulated(u, dac, b, c, passes=3):
    """The kernel's Stage 1 with its products emulated: u [G, Q, H, P],
    dac [G, Q, H], b/c [G, Q, N], fp32. Returns (y, state)."""
    q = u.shape[1]
    cum = torch.cumsum(dac, dim=1)  # [G, Q, H]
    scores = mm_split(c, b.transpose(1, 2), passes)  # [G, Q, Q]
    cum_h = cum.permute(0, 2, 1)  # [G, H, Q]
    causal = torch.tril(torch.ones(q, q, dtype=torch.bool))
    diff = cum_h[..., :, None] - cum_h[..., None, :]  # [G, H, Q, K]
    decay = torch.where(causal, torch.exp(torch.where(causal, diff, torch.zeros(()))), 0.0)
    a = scores[:, None] * decay  # S o L in fp32, before the split
    y = mm_split(a, u.permute(0, 2, 1, 3), passes)  # [G, H, Q, P]
    dend = torch.exp(cum[:, -1:, :] - cum)  # [G, Q, H]
    ud = (u * dend[..., None]).permute(0, 2, 3, 1)  # [G, H, P, Q]
    state = mm_split(ud, b[:, None], passes)  # [G, H, P, N]
    return y.permute(0, 2, 1, 3), state


def _inputs(g, q, seed):
    """As chip_smoke.ssd_inputs: u ~ 0.5 N(0, 1), dac = -0.1 softplus(N),
    b, c ~ 0.5 N(0, 1), float32."""
    rng = np.random.default_rng(seed)
    u = (rng.standard_normal((g, q, H, P)) * 0.5).astype(np.float32)
    dac = (-0.1 * np.log1p(np.exp(rng.standard_normal((g, q, H))))).astype(np.float32)
    b, c = ((rng.standard_normal((g, q, N)) * 0.5).astype(np.float32) for _ in range(2))
    return u, dac, b, c


def test_rna_tf32_rounds_to_ten_mantissa_bits_ties_away():
    one_ulp = 2.0**-10  # TF32's unit in the last place at 1
    x = torch.tensor([1.0 + one_ulp / 2, -(1.0 + one_ulp / 2), 1.0 + one_ulp / 2 - 2.0**-23,
                      3.0, 1.0 + 3 * one_ulp / 2], dtype=torch.float32)
    want = torch.tensor([1.0 + one_ulp, -(1.0 + one_ulp), 1.0, 3.0, 1.0 + 2 * one_ulp])
    torch.testing.assert_close(rna_tf32(x), want, rtol=0, atol=0)
    assert (rna_tf32(x).view(torch.int32) & 0x1FFF).eq(0).all()


def test_split_keeps_22_bits():
    x = torch.from_numpy(np.random.default_rng(0).standard_normal(4096).astype(np.float32))
    hi, lo = split(x)
    assert torch.equal(x - hi, (x - hi).float())  # the remainder is exact
    rel = ((hi.double() + lo.double() - x.double()).abs() / x.double().abs()).max().item()
    assert rel <= 2.0**-21, rel


@pytest.mark.parametrize("g,q", [(1, 256), (2, 197)])
def test_split_tf32_stage1_within_fp32_ladder(g, q):
    ins = _inputs(g, q, seed=g + q)
    y_e, s_e = stage1_emulated(*(torch.from_numpy(a) for a in ins))
    y_r, s_r = ssd_stage1_ref(*(jnp.asarray(a) for a in ins))
    y_p, s_p = ssd_stage1(*(torch.from_numpy(a) for a in ins))
    for got, want in ((y_e, np.asarray(y_r)), (s_e, np.asarray(s_r)), (y_e, y_p), (s_e, s_p)):
        assert tuple(got.shape) == tuple(want.shape)
        assert_allclose_by_dtype(got, want, torch.float32)


@pytest.mark.parametrize("g,q", [(1, 256), (2, 197)])
def test_single_pass_tf32_misses_the_fp32_ladder(g, q):
    ins = _inputs(g, q, seed=g + q)
    y1, s1 = stage1_emulated(*(torch.from_numpy(a) for a in ins), passes=1)
    y_r, s_r = ssd_stage1_ref(*(jnp.asarray(a) for a in ins))
    for got, want in ((y1, np.asarray(y_r)), (s1, np.asarray(s_r))):
        with pytest.raises(AssertionError):
            assert_allclose_by_dtype(got, want, torch.float32)
