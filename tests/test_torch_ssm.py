"""Parity of the port's Mamba-2 layer pieces with the JAX reference.

The same inputs, made with numpy from a seed, go through both packages:
the plain SSD Stage 1 (the CUDA kernel's plain version) against the Pallas
kernel in interpret mode and its jnp oracle, the chunked scan through the
kernel wrapper (on CPU tensors it runs the plain Stage 1) against
``ssd_scan`` and ``ssd_scan_pallas``, the causal conv, the norms and the
decode fast path. Tolerances are stated at each comparison: the fp32 ladder
(rtol 1e-5, atol 1e-4) for Stage 1, 1e-4 for whole scans (as
``tests/test_kernel_ssd.py``), and the ladder of the dtype for the norms.
"""

import dataclasses

import numpy as np
import pytest
import torch

from repro.core.tridiag import ensure_x64

ensure_x64()

import repro.api  # noqa: E402,F401  (before repro.telemetry: import-order cycle)
import jax.numpy as jnp  # noqa: E402

from repro.configs.base import get_config as ref_get_config  # noqa: E402
from repro.kernels.ssd_stage1.ops import ssd_scan_pallas  # noqa: E402
from repro.kernels.ssd_stage1.ref import ssd_stage1_ref  # noqa: E402
from repro.kernels.ssd_stage1.ssd1 import ssd1_tiled  # noqa: E402
from repro.models.layers import norms as ref_norms  # noqa: E402
from repro.models.layers import ssm as ref_ssm  # noqa: E402
from repro.parallel.ctx import ParallelCtx as RefCtx  # noqa: E402
from repro_torch.configs.base import get_config  # noqa: E402
from repro_torch.kernels import LAUNCH_COUNTERS  # noqa: E402
from repro_torch.kernels.common import assert_allclose_by_dtype  # noqa: E402
from repro_torch.kernels.ssd_stage1 import ssd_scan_kernel, ssd_stage1_cuda  # noqa: E402
from repro_torch.models.layers import norms, ssm  # noqa: E402
from repro_torch.models.layers.norms import RMSNorm  # noqa: E402
from repro_torch.parallel.ctx import ParallelCtx  # noqa: E402

SCAN_TOL = dict(rtol=1e-4, atol=1e-4)  # the whole chunked scan, as test_kernel_ssd.py


def _t(a):
    return torch.from_numpy(np.array(a))


def _np(a):
    if isinstance(a, torch.Tensor):
        return a.detach().float().numpy() if a.dtype == torch.bfloat16 else a.detach().numpy()
    return np.asarray(jnp.asarray(a).astype(jnp.float32)) if a.dtype == jnp.bfloat16 else np.asarray(a)


def _stage1_inputs(g, q, nh, p, n, seed):
    rng = np.random.default_rng(seed)
    u = (rng.standard_normal((g, q, nh, p)) * 0.5).astype(np.float32)
    dt = np.log1p(np.exp(rng.standard_normal((g, q, nh))))
    dac = (-0.1 * dt).astype(np.float32)  # negative decays
    b = (rng.standard_normal((g, q, n)) * 0.5).astype(np.float32)
    c = (rng.standard_normal((g, q, n)) * 0.5).astype(np.float32)
    return u, dac, b, c


def _scan_inputs(bsz, s, nh, p, n, seed):
    rng = np.random.default_rng(seed)
    x = (rng.standard_normal((bsz, s, nh, p)) * 0.5).astype(np.float32)
    dt = np.log1p(np.exp(rng.standard_normal((bsz, s, nh)))).astype(np.float32)
    a = (-np.exp(rng.standard_normal(nh) * 0.3)).astype(np.float32)
    b_in = (rng.standard_normal((bsz, s, n)) * 0.5).astype(np.float32)
    c_in = (rng.standard_normal((bsz, s, n)) * 0.5).astype(np.float32)
    return x, dt, a, b_in, c_in


# -------------------------------------------------------------- stage 1 --
@pytest.mark.parametrize("g,q,nh,p,n", [
    (1, 8, 2, 4, 8), (3, 16, 4, 8, 16), (2, 64, 8, 16, 32), (4, 32, 3, 8, 8),
])
def test_plain_stage1_matches_pallas_kernel_and_oracle(g, q, nh, p, n):
    ins = _stage1_inputs(g, q, nh, p, n, seed=g + q)
    y_k, s_k = ssd1_tiled(*(jnp.asarray(a) for a in ins), interpret=True)
    y_r, s_r = ssd_stage1_ref(*(jnp.asarray(a) for a in ins))
    before = LAUNCH_COUNTERS["ssd_stage1"].count
    for fn in (ssm.ssd_stage1, ssd_stage1_cuda):  # the wrapper on CPU tensors
        y, s = fn(*(_t(a) for a in ins))
        assert y.shape == (g, q, nh, p) and s.shape == (g, nh, p, n)
        for want in ((y_k, s_k), (y_r, s_r)):
            assert_allclose_by_dtype(y, np.asarray(want[0]), np.float32)
            assert_allclose_by_dtype(s, np.asarray(want[1]), np.float32)
    # The plain path launches nothing.
    assert LAUNCH_COUNTERS["ssd_stage1"].count == before


def test_stage1_wrapper_rejects_mismatched_shapes():
    u, dac, b, c = (_t(a) for a in _stage1_inputs(2, 8, 2, 4, 8, seed=0))
    with pytest.raises(ValueError, match="dac"):
        ssd_stage1_cuda(u, dac[:, :4], b, c)
    with pytest.raises(ValueError, match="shape"):
        ssd_stage1_cuda(u[0], dac, b, c)


# ----------------------------------------------------------- whole scan --
@pytest.mark.parametrize("with_h0", [False, True], ids=["h0=None", "h0"])
@pytest.mark.parametrize("bsz,s,chunk", [(1, 32, 8), (2, 64, 16), (1, 128, 32)])
def test_ssd_scan_kernel_matches_reference_scans(bsz, s, chunk, with_h0):
    nh, p, n = 4, 8, 16
    ins = _scan_inputs(bsz, s, nh, p, n, seed=s + chunk)
    h0 = (np.full((bsz, nh, p, n), 0.1, np.float32) if with_h0 else None)
    jins = tuple(jnp.asarray(a) for a in ins)
    jh0 = None if h0 is None else jnp.asarray(h0)
    y_p, h_p = ssd_scan_pallas(*jins, chunk=chunk, h0=jh0, interpret=True)
    y_r, h_r = ref_ssm.ssd_scan(*jins, chunk=chunk, h0=jh0)
    th0 = None if h0 is None else _t(h0)
    for fn in (ssd_scan_kernel, ssm.ssd_scan):
        y, h = fn(*(_t(a) for a in ins), chunk=chunk, h0=th0)
        for yw, hw in ((y_p, h_p), (y_r, h_r)):
            np.testing.assert_allclose(_np(y), np.asarray(yw), **SCAN_TOL)
            np.testing.assert_allclose(_np(h), np.asarray(hw), **SCAN_TOL)


@pytest.mark.parametrize("s,chunk", [(197, 256), (26, 13)], ids=["Q=197", "Q=13,NC=2"])
def test_ssd_scan_kernel_with_an_odd_chunk_length(s, chunk):
    nh, p, n = 3, 8, 16
    ins = _scan_inputs(2, s, nh, p, n, seed=s)
    y_r, h_r = ref_ssm.ssd_scan(*(jnp.asarray(a) for a in ins), chunk=chunk)
    y, h = ssd_scan_kernel(*(_t(a) for a in ins), chunk=chunk)
    np.testing.assert_allclose(_np(y), np.asarray(y_r), **SCAN_TOL)
    np.testing.assert_allclose(_np(h), np.asarray(h_r), **SCAN_TOL)


def test_sequence_not_a_multiple_of_the_chunk_raises_on_both_sides():
    ins = _scan_inputs(1, 23, 2, 4, 8, seed=0)
    with pytest.raises(AssertionError, match="seq 23 % chunk 16"):
        ref_ssm.ssd_scan(*(jnp.asarray(a) for a in ins), chunk=16)
    with pytest.raises(ValueError, match="seq 23 % chunk 16"):
        ssd_scan_pallas(*(jnp.asarray(a) for a in ins), chunk=16, interpret=True)
    for fn in (ssd_scan_kernel, ssm.ssd_scan):
        with pytest.raises(ValueError, match="seq 23 % chunk 16"):
            fn(*(_t(a) for a in ins), chunk=16)


# ----------------------------------------------------------- conv, norms --
@pytest.mark.parametrize("with_state", [False, True], ids=["no-state", "state"])
def test_causal_conv_matches_reference(with_state):
    rng = np.random.default_rng(3)
    x = rng.standard_normal((2, 7, 12)).astype(np.float32)
    w = (rng.standard_normal((4, 12)) * 0.2).astype(np.float32)
    b = rng.standard_normal(12).astype(np.float32)
    st = rng.standard_normal((2, 3, 12)).astype(np.float32) if with_state else None
    out_r, new_r = ref_ssm._causal_conv(jnp.asarray(x), jnp.asarray(w), jnp.asarray(b),
                                        None if st is None else jnp.asarray(st))
    out, new = ssm._causal_conv(_t(x), _t(w), _t(b), None if st is None else _t(st))
    assert_allclose_by_dtype(out, np.asarray(out_r), np.float32)
    np.testing.assert_array_equal(_np(new), np.asarray(new_r))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("gated", [False, True], ids=["rms_norm", "gated_rms_norm"])
def test_norms_match_reference(gated, dtype):
    rng = np.random.default_rng(4)
    x = rng.standard_normal((2, 5, 32)).astype(np.float32)
    z = rng.standard_normal((2, 5, 32)).astype(np.float32)
    scale = (rng.standard_normal(32) * 0.1).astype(np.float32)
    jx, jz = (jnp.asarray(a, dtype=jnp.dtype(dtype)) for a in (x, z))
    tx, tz = (_t(a).to(getattr(torch, dtype)) for a in (x, z))
    params = RMSNorm(32)
    params.scale.copy_(_t(scale))
    if gated:
        want = ref_norms.gated_rms_norm(jx, jz, {"scale": jnp.asarray(scale)}, 1e-5)
        got = norms.gated_rms_norm(tx, tz, params, 1e-5)
    else:
        want = ref_norms.rms_norm(jx, {"scale": jnp.asarray(scale)}, 1e-5)
        got = norms.rms_norm(tx, params, 1e-5)
    assert got.dtype == getattr(torch, dtype)
    assert_allclose_by_dtype(_np(got), _np(want), jnp.dtype(dtype))


# ------------------------------------------------------------- the layer --
def _layer_pair(seed):
    """One smoke-size Mamba-2 layer with the same weights on both sides."""
    import jax

    from repro_torch.models.layers.ssm import SSM, SSM_PARAMS

    ref_cfg = ref_get_config("mamba2-1.3b").smoke()
    cfg = get_config("mamba2-1.3b").smoke()
    jp = ref_ssm.init_ssm(jax.random.PRNGKey(seed), ref_cfg, jnp.float32)
    out_norm = RMSNorm(cfg.ssm_d_inner)
    out_norm.scale.copy_(_t(jp["out_norm"]["scale"]))
    tp = SSM(out_norm, **{k: _t(jp[k]) for k in SSM_PARAMS})
    return ref_cfg, cfg, jp, tp


@pytest.mark.parametrize("seq", [1, 16], ids=["decode", "prefill"])
def test_ssm_apply_with_state_matches_reference(seq):
    """s == 1 with a state is the decode fast path (tensor ops); longer
    inputs go through ``ssd_scan_kernel`` with ``h0``."""
    ref_cfg, cfg, jp, tp = _layer_pair(seed=5)
    rng = np.random.default_rng(6)
    x = rng.standard_normal((2, seq, cfg.d_model)).astype(np.float32)
    di, nh, p, n = cfg.ssm_d_inner, cfg.ssm_heads, cfg.ssm_head_dim, cfg.ssm_state
    k1 = cfg.ssm_conv - 1
    state = [rng.standard_normal(shape).astype(np.float32) * 0.3
             for shape in ((2, k1, di), (2, k1, n), (2, k1, n), (2, nh, p, n))]
    out_r, st_r = ref_ssm.ssm_apply(jp, jnp.asarray(x), ref_cfg, RefCtx(),
                                    state=ref_ssm.SSMState(*(jnp.asarray(a) for a in state)))
    out, st = ssm.ssm_apply(tp, _t(x), cfg, ParallelCtx(),
                            state=ssm.SSMState(*(_t(a) for a in state)))
    np.testing.assert_allclose(_np(out), np.asarray(out_r), **SCAN_TOL)
    for f in ssm.SSMState._fields:
        np.testing.assert_allclose(_np(getattr(st, f)), np.asarray(getattr(st_r, f)), **SCAN_TOL)


def test_ssm_apply_without_state_returns_state_only_when_asked():
    _, cfg, _, tp = _layer_pair(seed=7)
    x = _t(np.random.default_rng(8).standard_normal((1, 16, cfg.d_model)).astype(np.float32))
    out, st = ssm.ssm_apply(tp, x, cfg, ParallelCtx())
    assert st is None and out.shape == x.shape
    _, st = ssm.ssm_apply(tp, x, cfg, ParallelCtx(), return_state=True)
    assert st.ssd.shape == (1, cfg.ssm_heads, cfg.ssm_head_dim, cfg.ssm_state)
    assert st.ssd.dtype == torch.float32


def test_parallel_ctx_is_single_device():
    pctx = ParallelCtx()
    x = torch.ones(2, 3, 4)
    assert pctx.shard(x, pctx.batch_axes, None, "model") is x
    assert pctx.shard_residual(x) is x
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        ParallelCtx(mesh=object())


@pytest.mark.parametrize("arch", ["mamba2-1.3b", "zamba2-7b", "qwen3-4b", "gemma2-27b",
                                  "codeqwen1.5-7b", "nemotron-4-340b", "internvl2-2b",
                                  "moonshot-v1-16b-a3b", "kimi-k2-1t-a32b", "whisper-medium"])
def test_configs_are_the_references(arch):
    ref, port = ref_get_config(arch), get_config(arch)
    assert dataclasses.asdict(port) == dataclasses.asdict(ref)
    assert port.param_count() == ref.param_count()
    assert dataclasses.asdict(port.smoke()) == dataclasses.asdict(ref.smoke())


def test_paper_tridiag_config_is_the_references():
    from repro.configs import paper_tridiag as ref_paper
    from repro_torch.configs import paper_tridiag

    assert dataclasses.asdict(paper_tridiag.CONFIG) == dataclasses.asdict(ref_paper.CONFIG)
    assert dataclasses.asdict(paper_tridiag.PaperTridiagConfig()) == dataclasses.asdict(
        ref_paper.PaperTridiagConfig())
