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

The backward kernel ``csrc/ssd_stage1_bwd.cu`` takes its seven products the
same way: the scores C·Bᵀ, W = dy_h·u_hᵀ, Mᵀ·dy, B·ds_hᵀ, dS·B, dSᵀ·C and
(e∘u)ᵀ·ds, with the decays L and e applied in fp32 before the split and
G = S∘(L∘W), its row and column sums, d cum and the reverse scan in fp32.
Its emulation here is held against ``jax.vjp`` of ``ssd_stage1_ref``, each
gradient within 1e-4 of its largest magnitude (``chip_smoke.SSD_BWD_TOL``:
an element's error follows its sum's magnitude), with the incoming
gradients made as ``chip_smoke.ssd_bwd_inputs`` makes them.
"""

import functools

import numpy as np
import pytest
import torch

from repro.core.tridiag import ensure_x64

ensure_x64()

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.kernels.ssd_stage1.ref import ssd_stage1_ref  # noqa: E402
from repro_torch.kernels.common import assert_allclose_by_dtype  # noqa: E402
from repro_torch.models.layers.ssm import ssd_stage1  # noqa: E402

H, P, N = 64, 64, 128  # mamba2-1.3b: heads, head dim, state
BWD_TOL = 1e-4  # chip_smoke.SSD_BWD_TOL: of each gradient's largest magnitude


def rna_tf32(x: torch.Tensor) -> torch.Tensor:
    """cvt.rna.tf32.f32 for every x but a NaN: fp32 rounded to 10 mantissa
    bits, ties away from zero (on the sign-magnitude bits, adding half of
    the dropped 13 bits' unit rounds the magnitude)."""
    bits = x.contiguous().view(torch.int32)
    return ((bits + 0x1000) & -0x2000).view(torch.float32)


def split(x: torch.Tensor):
    """As csrc/ssd_tf32.cuh's split_tf32: hi takes x * 0 (NaN for a NaN or
    an infinity, a zero of x's sign otherwise, which leaves hi as it is)."""
    hi = rna_tf32(x) + x * 0.0
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


def test_split_hi_is_nan_for_nan_and_inf():
    # NaNs with a full mantissa, with only the dropped bits set, quiet and
    # negative; the two infinities; then the largest finite values and a
    # negative zero, whose hi is the rounding alone. The rounding alone
    # turns a NaN with a full mantissa into a zero.
    bits = torch.tensor([0x7FFFFFFF, -1, 0x7F800001, 0x7FC00000, -0x400000,
                         0x7F800000, -0x800000, 0x7F7FFFFF, -0x800001, -0x80000000],
                        dtype=torch.int32)
    x = bits.view(torch.float32)
    assert rna_tf32(x[:2]).eq(0).all()
    hi, _ = split(x)
    tf32 = (hi.view(torch.int32) & -0x2000).view(torch.float32)  # the bits an MMA reads
    assert torch.isnan(tf32[:7]).all()
    assert torch.equal(hi[7:].view(torch.int32), rna_tf32(x[7:]).view(torch.int32))


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


def stage1_backward_emulated(u, dac, b, c, dy, ds, passes=3):
    """The backward kernel with its products emulated: the forward's inputs
    and the incoming gradients dy [G, Q, H, P], ds [G, H, P, N], fp32.
    Returns (du, ddac, db, dc)."""
    g, q = u.shape[:2]
    cum = torch.cumsum(dac, dim=1)  # [G, Q, H]
    cum_h = cum.permute(0, 2, 1)  # [G, H, Q]
    causal = torch.tril(torch.ones(q, q, dtype=torch.bool))
    diff = cum_h[..., :, None] - cum_h[..., None, :]  # [G, H, Q, K]
    decay = torch.where(causal, torch.exp(torch.where(causal, diff, torch.zeros(()))), 0.0)
    e = torch.exp(cum[:, -1:, :] - cum)  # [G, Q, H]
    e_h = e.permute(0, 2, 1)[..., None]  # [G, H, Q, 1]
    uh, dyh = u.permute(0, 2, 1, 3), dy.permute(0, 2, 1, 3)  # [G, H, Q, P]
    scores = mm_split(c, b.transpose(1, 2), passes)  # [G, Q, K]
    w = mm_split(dyh, uh.transpose(-1, -2), passes)  # [G, H, Q, K]
    lw = decay * w  # L o W in fp32, zero above the diagonal
    gm = scores[:, None] * lw  # G = S o (L o W)
    dscores = lw.sum(dim=1)  # [G, Q, K]
    m = scores[:, None] * decay  # M = S o L in fp32, before the split
    bds = mm_split(b[:, None], ds.transpose(-1, -2), passes)  # ds.B_k: [G, H, K, P]
    du = mm_split(m.transpose(-1, -2), dyh, passes) + e_h * bds
    dc = mm_split(dscores, b, passes)
    ue = (u * e[..., None]).reshape(g, q, H * P)  # e o u in fp32, before the split
    db = (mm_split(dscores.transpose(1, 2), c, passes)
          + mm_split(ue, ds.reshape(g, H * P, N), passes))
    r = (uh * (e_h * bds)).sum(dim=-1)  # [G, H, Q]
    dcum = gm.sum(dim=-1) - gm.sum(dim=-2) - r
    dcum[..., -1] += r.sum(dim=-1)
    ddac = torch.flip(torch.cumsum(torch.flip(dcum, (-1,)), dim=-1), (-1,))
    return du.permute(0, 2, 1, 3), ddac.permute(0, 2, 1), db, dc


def _bwd_inputs(g, q, seed):
    """As chip_smoke.ssd_bwd_inputs: Stage 1's inputs, then dy ~ N(0, 1)
    [G, Q, H, P] and ds ~ N(0, 1) [G, H, P, N] from seed + 7."""
    rng = np.random.default_rng(seed + 7)
    dy = rng.standard_normal((g, q, H, P)).astype(np.float32)
    ds = rng.standard_normal((g, H, P, N)).astype(np.float32)
    return (*_inputs(g, q, seed), dy, ds)


@functools.lru_cache(maxsize=None)
def _bwd_case(g, q):
    """The inputs of one backward case and ``jax.vjp`` of the reference."""
    ins = _bwd_inputs(g, q, seed=g + q + 1)
    u, dac, b, c, dy, ds = (jnp.asarray(a) for a in ins)
    _, vjp = jax.vjp(ssd_stage1_ref, u, dac, b, c)
    return ins, [np.asarray(x) for x in vjp((dy, ds))]


def _share_of_max(got, want):
    """The largest error of ``got`` over ``want``'s largest magnitude."""
    return float(np.abs(got.numpy().astype(np.float64) - want).max() / np.abs(want).max())


@pytest.mark.parametrize("g,q", [(1, 256), (2, 197)])
def test_split_tf32_backward_within_tolerance_of_jax_vjp(g, q):
    ins, want = _bwd_case(g, q)
    got = stage1_backward_emulated(*(torch.from_numpy(a) for a in ins))
    for name, gt, wt in zip(("du", "ddac", "db", "dc"), got, want):
        assert tuple(gt.shape) == wt.shape, name
        assert _share_of_max(gt, wt) <= BWD_TOL, (name, _share_of_max(gt, wt))


@pytest.mark.parametrize("g,q", [(1, 256), (2, 197)])
def test_single_pass_tf32_backward_misses_the_tolerance(g, q):
    # One TF32 product alone leaves each gradient about 4e-4 of its largest
    # magnitude off (3.4e-4 ... 4.6e-4 at these shapes); split TF32 ~1e-6.
    ins, want = _bwd_case(g, q)
    got = stage1_backward_emulated(*(torch.from_numpy(a) for a in ins), passes=1)
    for name, gt, wt in zip(("du", "ddac", "db", "dc"), got, want):
        assert _share_of_max(gt, wt) > BWD_TOL, (name, _share_of_max(gt, wt))
