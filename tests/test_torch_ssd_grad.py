"""The gradient of SSD Stage 1 and of the Mamba-2 layer, port against the
JAX reference, on the CPU.

The port trains through ``SSDStage1Function``: on CUDA tensors its forward
and backward are the kernels ``csrc/ssd_stage1.cu`` and
``csrc/ssd_stage1_bwd.cu``, on CPU tensors the plain ``ssd_stage1`` and
``ssd_stage1_backward``, which these tests hold:

- the plain backward against ``torch.autograd`` of the plain forward, and
  the Function through ``gradcheck``, in fp64 (gradcheck's own tolerances,
  atol 1e-5 and rtol 1e-3 on finite differences; the analytic comparison at
  1e-10);
- the plain backward against ``jax.vjp`` of the reference's
  ``ssd_stage1_ref`` in fp32, each gradient within 1e-5 of its largest
  magnitude (a gradient sums hundreds of terms: the error of an element
  follows the sum's magnitude, not its own);
- the Function's wiring on CPU tensors (saved inputs, gradient order,
  ``None`` for an input that needs none, zeros for an output unused);
- ``ssm_apply``'s gradients with respect to every parameter, the input and
  the incoming state against ``jax.grad`` of the reference's ``ssm_apply``
  (chunks of 1 and 12 steps, three chunks, an ``h0``), each within 1e-4 of
  its largest magnitude.
"""

import dataclasses

import numpy as np
import pytest
import torch

from repro.core.tridiag import ensure_x64

ensure_x64()

import repro.api  # noqa: E402,F401  (before repro.telemetry: import-order cycle)
import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs.base import get_config as ref_get_config  # noqa: E402
from repro.kernels.ssd_stage1.ref import ssd_stage1_ref  # noqa: E402
from repro.models.layers import ssm as ref_ssm  # noqa: E402
from repro.parallel.ctx import ParallelCtx as RefCtx  # noqa: E402
from repro_torch.configs.base import get_config  # noqa: E402
from repro_torch.kernels import LAUNCH_COUNTERS  # noqa: E402
from repro_torch.kernels.ssd_stage1 import (  # noqa: E402
    SSDStage1Function,
    ssd_scan_kernel,
    ssd_stage1_backward_cuda,
)
from repro_torch.models.layers import ssm  # noqa: E402
from repro_torch.models.layers.norms import RMSNorm  # noqa: E402
from repro_torch.parallel.ctx import ParallelCtx  # noqa: E402

SHAPES = [(1, 1, 2, 3, 4), (2, 7, 3, 4, 5), (3, 16, 2, 8, 6), (2, 33, 4, 6, 6)]


def _inputs(g, q, nh, p, n, seed, dtype=np.float64):
    rng = np.random.default_rng(seed)
    u = rng.standard_normal((g, q, nh, p)) * 0.5
    dac = -0.1 * np.log1p(np.exp(rng.standard_normal((g, q, nh))))
    b = rng.standard_normal((g, q, n)) * 0.5
    c = rng.standard_normal((g, q, n)) * 0.5
    dy = rng.standard_normal((g, q, nh, p))
    ds = rng.standard_normal((g, nh, p, n))
    return [a.astype(dtype) for a in (u, dac, b, c, dy, ds)]


def _close_to_max(got, want, tol):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    assert got.shape == want.shape
    scale = np.abs(want).max()
    assert np.abs(got - want).max() <= tol * scale, (np.abs(got - want).max(), scale)


@pytest.mark.parametrize("shape", SHAPES, ids=str)
def test_plain_backward_matches_autograd_fp64(shape):
    ins = [torch.from_numpy(a) for a in _inputs(*shape, seed=sum(shape))]
    x = [t.clone().requires_grad_(True) for t in ins[:4]]
    y, s = ssm.ssd_stage1(*x)
    assert y.dtype == s.dtype == torch.float64
    want = torch.autograd.grad((y * ins[4]).sum() + (s * ins[5]).sum(), x)
    got = ssm.ssd_stage1_backward(*ins)
    for g, w in zip(got, want):
        assert g.dtype == torch.float64
        torch.testing.assert_close(g, w, rtol=1e-10, atol=1e-10)


@pytest.mark.parametrize("shape", SHAPES[:3], ids=str)
def test_function_passes_gradcheck_fp64(shape):
    ins = [torch.from_numpy(a).requires_grad_(True) for a in _inputs(*shape, seed=3)[:4]]
    assert torch.autograd.gradcheck(SSDStage1Function.apply, tuple(ins), eps=1e-6,
                                    atol=1e-5, rtol=1e-3)


@pytest.mark.parametrize("shape", SHAPES + [(2, 64, 4, 16, 32)], ids=str)
def test_plain_backward_matches_jax_vjp(shape):
    u, dac, b, c, dy, ds = _inputs(*shape, seed=7, dtype=np.float32)
    _, vjp = jax.vjp(ssd_stage1_ref, *(jnp.asarray(a) for a in (u, dac, b, c)))
    want = vjp((jnp.asarray(dy), jnp.asarray(ds)))
    got = ssm.ssd_stage1_backward(*(torch.from_numpy(a) for a in (u, dac, b, c, dy, ds)))
    for g, w in zip(got, want):
        assert g.dtype == torch.float32
        _close_to_max(g.numpy(), np.asarray(w), 1e-5)


def test_function_wiring_on_cpu():
    u, dac, b, c, dy, ds = (torch.from_numpy(a) for a in _inputs(2, 9, 3, 4, 5, seed=11,
                                                                   dtype=np.float32))
    bwd0 = LAUNCH_COUNTERS["ssd_stage1_bwd"].count
    fwd0 = LAUNCH_COUNTERS["ssd_stage1"].count
    # Only u and c take gradients: the others get None.
    xu, xc = u.clone().requires_grad_(True), c.clone().requires_grad_(True)
    y, s = SSDStage1Function.apply(xu, dac, b, xc)
    want_y, want_s = ssm.ssd_stage1(u, dac, b, c)
    assert torch.equal(y, want_y) and torch.equal(s, want_s)
    ((y * dy).sum() + (s * ds).sum()).backward()
    du, _, _, dc = ssm.ssd_stage1_backward(u, dac, b, c, dy, ds)
    assert torch.equal(xu.grad, du) and torch.equal(xc.grad, dc)
    # An unused output: its incoming gradient is taken as zeros.
    xb = b.clone().requires_grad_(True)
    y, _ = SSDStage1Function.apply(u, dac, xb, c)
    (y * dy).sum().backward()
    assert torch.equal(xb.grad, ssm.ssd_stage1_backward(u, dac, b, c, dy, torch.zeros_like(ds))[2])
    xd = dac.clone().requires_grad_(True)
    _, s = SSDStage1Function.apply(u, xd, b, c)
    (s * ds).sum().backward()
    assert torch.equal(xd.grad, ssm.ssd_stage1_backward(u, dac, b, c, torch.zeros_like(dy), ds)[1])
    # On CPU tensors nothing is launched.
    assert LAUNCH_COUNTERS["ssd_stage1_bwd"].count == bwd0
    assert LAUNCH_COUNTERS["ssd_stage1"].count == fwd0


def test_backward_wrapper_on_cpu_is_the_plain_version_and_checks_shapes():
    ins = [torch.from_numpy(a) for a in _inputs(2, 8, 2, 4, 8, seed=13, dtype=np.float32)]
    for g, w in zip(ssd_stage1_backward_cuda(*ins), ssm.ssd_stage1_backward(*ins)):
        assert torch.equal(g, w)
    with pytest.raises(ValueError, match="ds"):
        ssd_stage1_backward_cuda(*ins[:5], ins[5][:, :, :-1])
    with pytest.raises(ValueError, match="dy"):
        ssd_stage1_backward_cuda(*ins[:4], ins[4][:, :-1], ins[5])


def test_scan_through_the_function_has_the_plain_scans_gradient():
    rng = np.random.default_rng(17)
    bsz, s, nh, p, n = 2, 24, 3, 4, 6
    arrays = [rng.standard_normal((bsz, s, nh, p)) * 0.5,
              np.log1p(np.exp(rng.standard_normal((bsz, s, nh)))),
              -np.exp(rng.standard_normal(nh) * 0.3),
              rng.standard_normal((bsz, s, n)) * 0.5, rng.standard_normal((bsz, s, n)) * 0.5,
              rng.standard_normal((bsz, nh, p, n)) * 0.3]
    grads = []
    for scan in (ssm.ssd_scan, ssd_scan_kernel):
        xs = [torch.from_numpy(a.astype(np.float32)).requires_grad_(True) for a in arrays]
        y, h = scan(*xs[:5], chunk=8, h0=xs[5])
        w = torch.from_numpy(np.cos(np.arange(y.numel())).reshape(y.shape).astype(np.float32))
        grads.append(torch.autograd.grad((y * w).sum() + h.square().sum(), xs))
    for g, w in zip(*grads):
        torch.testing.assert_close(g, w, rtol=1e-5, atol=1e-5)


# ------------------------------------------------------------- the layer --
def _layer(chunk, seed=5):
    from repro_torch.models.layers.ssm import SSM, SSM_PARAMS

    ref_cfg = dataclasses.replace(ref_get_config("mamba2-1.3b").smoke(), ssm_chunk=chunk)
    cfg = dataclasses.replace(get_config("mamba2-1.3b").smoke(), ssm_chunk=chunk)
    jp = ref_ssm.init_ssm(jax.random.PRNGKey(seed), ref_cfg, jnp.float32)
    # a nonzero norm scale, so its gradient is not the only path through it
    jp = dict(jp, out_norm={"scale": jp["out_norm"]["scale"] + 0.1})
    out_norm = RMSNorm(cfg.ssm_d_inner)
    with torch.no_grad():
        out_norm.scale.copy_(torch.from_numpy(np.array(jp["out_norm"]["scale"])))
    tp = SSM(out_norm, **{k: torch.from_numpy(np.array(jp[k])) for k in SSM_PARAMS})
    return ref_cfg, cfg, jp, tp.requires_grad_(True)


@pytest.mark.parametrize("seq,chunk,with_state", [
    (1, 16, False), (24, 12, False), (48, 16, False), (32, 16, True),
], ids=["Q=1", "Q=12,two-chunks", "three-chunks", "h0"])
def test_ssm_apply_gradients_match_reference(seq, chunk, with_state):
    ref_cfg, cfg, jp, tp = _layer(chunk)
    rng = np.random.default_rng(seq + chunk)
    x = rng.standard_normal((2, seq, cfg.d_model)).astype(np.float32)
    w_out = rng.standard_normal((2, seq, cfg.d_model)).astype(np.float32)
    di, nh, p, n = cfg.ssm_d_inner, cfg.ssm_heads, cfg.ssm_head_dim, cfg.ssm_state
    k1 = cfg.ssm_conv - 1
    state = [rng.standard_normal(sh).astype(np.float32) * 0.3
             for sh in ((2, k1, di), (2, k1, n), (2, k1, n), (2, nh, p, n))] if with_state else None
    w_st = rng.standard_normal((2, nh, p, n)).astype(np.float32)

    def ref_loss(params, xx, st):
        out, new = ref_ssm.ssm_apply(params, xx, ref_cfg, RefCtx(),
                                     state=None if st is None else ref_ssm.SSMState(*st),
                                     return_state=True)
        return jnp.sum(out * w_out) + jnp.sum(new.ssd * w_st)

    jst = None if state is None else [jnp.asarray(a) for a in state]
    rg_p, rg_x, rg_s = jax.grad(ref_loss, argnums=(0, 1, 2))(jp, jnp.asarray(x), jst)

    tx = torch.from_numpy(x).requires_grad_(True)
    tst = None if state is None else [torch.from_numpy(a).requires_grad_(True) for a in state]
    out, new = ssm.ssm_apply(tp, tx, cfg, ParallelCtx(),
                             state=None if tst is None else ssm.SSMState(*tst), return_state=True)
    loss = (out * torch.from_numpy(w_out)).sum() + (new.ssd * torch.from_numpy(w_st)).sum()
    named = dict(tp.named_parameters())
    leaves = list(named.values()) + [tx] + (tst or [])
    grads = dict(zip(list(named) + ["x"] + [f"state.{f}" for f in ssm.SSMState._fields][:len(tst or [])],
                     torch.autograd.grad(loss, leaves)))
    want = {k: rg_p[k] for k in named if "." not in k}
    want["out_norm.scale"] = rg_p["out_norm"]["scale"]
    want["x"] = rg_x
    if tst is not None:
        want.update({f"state.{f}": getattr(rg_s, f, None) if not isinstance(rg_s, list) else rg_s[i]
                     for i, f in enumerate(ssm.SSMState._fields)})
    assert set(want) == set(grads)
    for k, g in grads.items():
        _close_to_max(g.numpy(), np.asarray(want[k]), 1e-4)
