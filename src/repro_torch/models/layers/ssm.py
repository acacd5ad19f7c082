"""Mamba2 / SSD block, the counterpart of ``repro.models.layers.ssm``.

The SSD chunked scan has the partition method's 3-stage structure over time:

  Stage 1 (parallel over chunks)  — intra-chunk outputs + per-chunk reduced
                                    state (the "interface equation");
  Stage 2 (small sequential scan) — the inter-chunk state recurrence over
                                    NC interface states;
  Stage 3 (parallel over chunks)  — broadcast the incoming state into each
                                    chunk's outputs.

:func:`ssd_stage1` is Stage 1 in plain PyTorch (the einsums of the
reference's ``ssd_scan`` on [G = batch·chunks] views, the counterpart of
``repro.kernels.ssd_stage1.ref.ssd_stage1_ref``). It is the plain version of
the CUDA kernel ``csrc/ssd_stage1.cu``, and :func:`ssd_stage1_backward`
its gradient, the plain version of ``csrc/ssd_stage1_bwd.cu``.
:func:`ssd_scan` runs all three stages with it;
``repro_torch.kernels.ssd_stage1.ssd_scan_kernel`` runs the same Stages 2
and 3 around ``SSDStage1Function`` (the two kernels on the card), and is
what the prefill and training branch of :func:`ssm_apply` calls.

Shapes follow the Mamba2 reference: d_inner = expand·d_model, H heads of
head_dim P, shared (ngroups=1) B/C of state size N. The projections stay
separate (w_z/w_x/w_b/w_c/w_dt), as in the reference. Decode keeps a
constant state — (conv_*, ssd) — per layer.

Under a mesh the heads split over ``model``: ``w_z``, ``w_x``, ``w_dt``,
the ``conv_x_*`` leaves, ``dt_bias``, ``a_log``, ``d_skip`` and the gated
norm's scale hold this rank's H/tp heads, ``out_proj`` is row-parallel, and
the SSD stages (the CUDA kernels on the card) run on those heads. The
shared B/C projections and convolutions are computed alike on every rank
and enter the per-head work through Megatron's "f", so their parameters
get whole gradients; the gated norm takes its mean of squares over the
whole d_inner (summed over ``model``).
"""

from __future__ import annotations

import math
from typing import Callable, NamedTuple, Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from repro_torch.configs.base import ArchConfig
from repro_torch.models.layers.norms import RMSNorm, gated_rms_norm
from repro_torch.parallel.ctx import ParallelCtx, split_over_model
from repro_torch.parallel.sharding import Keep, keep_all

Tensor = torch.Tensor
Stage1 = Callable[[Tensor, Tensor, Tensor, Tensor], Tuple[Tensor, Tensor]]


class SSMState(NamedTuple):
    conv_x: Tensor  # [B, K-1, d_inner]
    conv_b: Tensor  # [B, K-1, N]
    conv_c: Tensor  # [B, K-1, N]
    ssd: Tensor     # [B, H, P, N] (fp32)


#: Parameter names of one SSM layer, as in the reference's parameter dict
#: (``out_norm`` is a sub-module holding ``scale``).
SSM_PARAMS = (
    "w_z", "w_x", "w_b", "w_c", "w_dt",
    "conv_x_w", "conv_x_b", "conv_b_w", "conv_b_b", "conv_c_w", "conv_c_b",
    "dt_bias", "a_log", "d_skip", "out_proj",
)


class SSM(nn.Module):
    """The parameters of one Mamba-2 layer (names as in the reference)."""

    def __init__(self, out_norm: RMSNorm, **tensors: Tensor) -> None:
        super().__init__()
        if set(tensors) != set(SSM_PARAMS):
            raise ValueError(f"SSM takes exactly {SSM_PARAMS}, got {sorted(tensors)}")
        for name in SSM_PARAMS:
            setattr(self, name, nn.Parameter(tensors[name], requires_grad=False))
        self.out_norm = out_norm


def _dims(cfg: ArchConfig) -> Tuple[int, int, int, int]:
    di = cfg.ssm_d_inner
    nh = cfg.ssm_heads
    return di, nh, cfg.ssm_head_dim, cfg.ssm_state


def init_ssm(gen: torch.Generator, cfg: ArchConfig, dtype: torch.dtype,
             keep: Keep = keep_all) -> SSM:
    """Random weights drawn from ``gen``, on ``gen``'s device, each leaf
    but the norm's passed through ``keep`` as it is made."""
    d = cfg.d_model
    di, nh, p, n = _dims(cfg)
    dev = gen.device
    s = 1.0 / math.sqrt(d)

    def normal(*shape: int, scale: float) -> Tensor:
        return (torch.randn(*shape, generator=gen, device=dev) * scale).to(dtype)

    def zeros(k: int, dt: torch.dtype = dtype) -> Tensor:
        return torch.zeros(k, dtype=dt, device=dev)

    return SSM(
        RMSNorm(di, device=dev),
        w_z=keep("w_z", normal(d, di, scale=s)),
        w_x=keep("w_x", normal(d, di, scale=s)),
        w_b=keep("w_b", normal(d, n, scale=s)),
        w_c=keep("w_c", normal(d, n, scale=s)),
        w_dt=keep("w_dt", normal(d, nh, scale=s)),
        conv_x_w=keep("conv_x_w", normal(cfg.ssm_conv, di, scale=0.2)),
        conv_x_b=keep("conv_x_b", zeros(di)),
        conv_b_w=keep("conv_b_w", normal(cfg.ssm_conv, n, scale=0.2)),
        conv_b_b=keep("conv_b_b", zeros(n)),
        conv_c_w=keep("conv_c_w", normal(cfg.ssm_conv, n, scale=0.2)),
        conv_c_b=keep("conv_c_b", zeros(n)),
        dt_bias=keep("dt_bias", zeros(nh, torch.float32)),
        a_log=keep("a_log", torch.log(torch.linspace(1.0, float(max(nh, 2)), nh,
                                                     dtype=torch.float32, device=dev))),
        d_skip=keep("d_skip", torch.ones(nh, dtype=torch.float32, device=dev)),
        out_proj=keep("out_proj", normal(di, d, scale=1.0 / math.sqrt(di))),
    )


def _causal_conv(x: Tensor, w: Tensor, b: Tensor,
                 state: Optional[Tensor]) -> Tuple[Tensor, Tensor]:
    """Depthwise causal conv over the sequence. x: [B, S, C]; w: [K, C]."""
    k = w.shape[0]
    if state is None:
        prev = torch.zeros(x.shape[0], k - 1, x.shape[2], dtype=x.dtype, device=x.device)
    else:
        prev = state.to(x.dtype)
    xp = torch.cat([prev, x], dim=1)
    s = x.shape[1]
    out = xp[:, 0:s, :] * w[0]
    for i in range(1, k):
        out = out + xp[:, i:i + s, :] * w[i]
    out = out + b
    new_state = xp[:, -(k - 1):, :] if k > 1 else torch.zeros_like(prev)
    return F.silu(out), new_state


def _segsum_decay(da_chunk: Tensor) -> Tensor:
    """L[..., i, j] = exp(sum_{j<t<=i} dA_t) for i>=j else 0.
    da_chunk: [..., Q, H] -> [..., H, Q, Q]."""
    q = da_chunk.shape[-2]
    cs = torch.cumsum(da_chunk, dim=-2).movedim(-1, -2)  # [..., H, Q]
    diff = cs[..., :, None] - cs[..., None, :]  # [..., H, Q, Q]
    mask = torch.tril(torch.ones(q, q, dtype=torch.bool, device=da_chunk.device))
    # mask BEFORE exp: masked entries are i<j where diff>0 can overflow.
    return torch.exp(torch.where(mask, diff, torch.full((), -1e30, dtype=diff.dtype,
                                                        device=diff.device)))


def _work_dtype(t: Tensor) -> torch.dtype:
    """fp32, or fp64 for fp64 inputs (the gradient checks run in fp64)."""
    return torch.float64 if t.dtype == torch.float64 else torch.float32


def ssd_stage1(u: Tensor, dac: Tensor, b: Tensor, c: Tensor) -> Tuple[Tensor, Tensor]:
    """Plain SSD Stage 1 on [G = batch·chunks] cells, in fp32 (fp64 for
    fp64 inputs).

    u: [G, Q, H, P] (dt-scaled inputs); dac: [G, Q, H]; b/c: [G, Q, N].
    Returns (y_diag [G, Q, H, P], states [G, H, P, N]):
    ``y_diag[q,h,:] = Σ_{k≤q} (C_q·B_k)·exp(cum_q−cum_k)·u[k,h,:]`` and
    ``state[h,:,n] = Σ_k exp(cum_Q−cum_k)·u[k,h,:]·B[k,n]``.
    """
    wt = _work_dtype(u)
    u32, dac32, b32, c32 = (t.to(wt) for t in (u, dac, b, c))
    cum = torch.cumsum(dac32, dim=1)  # [G, Q, H]
    ldec = _segsum_decay(dac32)  # [G, H, Q, Q]
    scores = torch.einsum("gqn,gkn->gqk", c32, b32)  # [G, Q, Q]
    y = torch.einsum("ghqk,gkhp->gqhp", scores[:, None] * ldec, u32)
    decay_end = torch.exp(cum[:, -1:, :] - cum)  # [G, Q, H]
    s = torch.einsum("gkhp,gkn->ghpn", u32 * decay_end[..., None], b32)
    return y, s


def ssd_stage1_backward(u: Tensor, dac: Tensor, b: Tensor, c: Tensor, dy: Tensor,
                        ds: Tensor) -> Tuple[Tensor, Tensor, Tensor, Tensor]:
    """The gradient of :func:`ssd_stage1`: given its inputs and the incoming
    gradients dy [G, Q, H, P] and ds [G, H, P, N], returns (du, ddac, db,
    dc), in fp32 (fp64 for fp64 inputs). The plain version of the CUDA
    kernel ``csrc/ssd_stage1_bwd.cu``. Per cell and head, with
    ``L[q,k] = exp(cum_q−cum_k)`` (k ≤ q), ``S = C·Bᵀ``, ``M = S∘L``,
    ``e_k = exp(cum_{Q−1}−cum_k)`` and ``W[q,k] = dy[q]·u[k]``:

    - ``du[k] = Σ_{q≥k} M[q,k]·dy[q] + e_k·(ds·B_k)``;
    - ``dS = Σ_h L∘W``, ``dC = dS·B``, ``dB = dSᵀ·C + Σ_h e_k·u[k]ᵀ·ds``;
    - with ``G = M∘W`` and ``r_k = e_k·(u[k]·(ds·B_k))``:
      ``dcum[q] = Σ_k G[q,k] − Σ_q' G[q',q] − r_q``, plus ``Σ_k r_k`` at
      ``q = Q−1``;
    - ``ddac[k] = Σ_{q≥k} dcum[q]`` (a reverse cumulative sum).
    """
    wt = _work_dtype(u)
    u, dac, b, c, dy, ds = (t.to(wt) for t in (u, dac, b, c, dy, ds))
    cum = torch.cumsum(dac, dim=1)  # [G, Q, H]
    ldec = _segsum_decay(dac)  # [G, H, Q, Q], zero above the diagonal
    m = torch.einsum("gqn,gkn->gqk", c, b)[:, None] * ldec  # [G, H, Q, Q]
    e = torch.exp(cum[:, -1:, :] - cum)  # [G, Q, H]
    w = torch.einsum("gqhp,gkhp->ghqk", dy, u)  # [G, H, Q, Q]
    bds = torch.einsum("gkn,ghpn->gkhp", b, ds)  # ds·B_k
    du = torch.einsum("ghqk,gqhp->gkhp", m, dy) + e[..., None] * bds
    dscores = (ldec * w).sum(dim=1)  # [G, Q, Q]
    dc = torch.einsum("gqk,gkn->gqn", dscores, b)
    db = (torch.einsum("gqk,gqn->gkn", dscores, c)
          + torch.einsum("gkhp,ghpn->gkn", u * e[..., None], ds))
    gm = m * w
    r = e * (u * bds).sum(dim=-1)  # [G, Q, H]
    dcum = (gm.sum(dim=-1) - gm.sum(dim=-2)).transpose(1, 2) - r  # [G, Q, H]
    dcum = torch.cat([dcum[:, :-1], dcum[:, -1:] + r.sum(dim=1, keepdim=True)], dim=1)
    ddac = torch.flip(torch.cumsum(torch.flip(dcum, (1,)), dim=1), (1,))
    return du, ddac, db, dc


def chunked_ssd(stage1: Stage1, x: Tensor, dt: Tensor, a: Tensor, b_in: Tensor,
                c_in: Tensor, *, chunk: int,
                h0: Optional[Tensor] = None) -> Tuple[Tensor, Tensor]:
    """Chunked SSD with Stage 1 given: ``stage1(u, dac, b, c)`` on the
    [G, Q, ...] views; Stages 2 and 3 are tensor ops (a Python loop over the
    NC chunks for the recurrence). Shapes as in :func:`ssd_scan`."""
    bsz, s, nh, p = x.shape
    n = b_in.shape[-1]
    chunk = min(chunk, s)
    if s % chunk:
        raise ValueError(f"seq {s} % chunk {chunk} != 0")
    nc = s // chunk
    g = bsz * nc

    dt = dt.float()
    a = a.float()
    u = (x.float() * dt[..., None]).reshape(g, chunk, nh, p).contiguous()
    dac = (dt * a).reshape(g, chunk, nh).contiguous()  # (<= 0)
    bc = b_in.float().reshape(g, chunk, n).contiguous()
    cc = c_in.float().reshape(g, chunk, n).contiguous()

    # ---- Stage 1: intra-chunk outputs and per-chunk reduced states ---------
    y_diag, s_chunk = stage1(u, dac, bc, cc)
    y_diag = y_diag.reshape(bsz, nc, chunk, nh, p)
    s_chunk = s_chunk.reshape(bsz, nc, nh, p, n)

    # ---- Stage 2: inter-chunk interface recurrence --------------------------
    cum = torch.cumsum(dac.reshape(bsz, nc, chunk, nh), dim=2)  # [B, NC, Q, H]
    chunk_decay = torch.exp(cum[:, :, -1, :])  # [B, NC, H]
    h = (torch.zeros(bsz, nh, p, n, dtype=torch.float32, device=x.device)
         if h0 is None else h0.float())
    h_prev = []
    for ci in range(nc):
        h_prev.append(h)  # the state entering chunk ci
        h = h * chunk_decay[:, ci, :, None, None] + s_chunk[:, ci]
    h_in = torch.stack(h_prev, dim=1)  # [B, NC, H, P, N]

    # ---- Stage 3: broadcast incoming state into chunk outputs ---------------
    state_decay = torch.exp(cum)  # [B, NC, Q, H]
    y_off = torch.einsum("bcqn,bchpn->bcqhp", cc.reshape(bsz, nc, chunk, n), h_in)
    y = (y_diag + y_off * state_decay[..., None]).reshape(bsz, s, nh, p)
    return y, h


def ssd_scan(
    x: Tensor,     # [B, S, H, P]  (pre-scaled inputs, NOT yet * dt)
    dt: Tensor,    # [B, S, H]     (softplus'd step sizes, fp32)
    a: Tensor,     # [H]           (negative decay rates, fp32)
    b_in: Tensor,  # [B, S, N]
    c_in: Tensor,  # [B, S, N]
    *,
    chunk: int,
    h0: Optional[Tensor] = None,  # [B, H, P, N] initial state
) -> Tuple[Tensor, Tensor]:
    """Chunked SSD in plain PyTorch. Returns (y [B,S,H,P], final_state
    [B,H,P,N]). Raises ``ValueError`` unless S is a multiple of
    ``min(chunk, S)``."""
    return chunked_ssd(ssd_stage1, x, dt, a, b_in, c_in, chunk=chunk, h0=h0)


def ssm_apply(
    params: SSM,
    x: Tensor,  # [B, S, D]
    cfg: ArchConfig,
    pctx: ParallelCtx,
    *,
    state: Optional[SSMState] = None,
    return_state: bool = False,
) -> Tuple[Tensor, Optional[SSMState]]:
    # Imported here: the kernel package imports this module's plain stages.
    from repro_torch.kernels.ssd_stage1.ops import ssd_scan_kernel

    x = pctx.seq_gather(x)
    bsz, s, d = x.shape
    p = cfg.ssm_head_dim
    ba = pctx.batch_axes
    split = split_over_model(params, "w_x", -1, pctx)
    if split != split_over_model(params, "a_log", 0, pctx):
        raise ValueError("d_inner and the SSM heads must both split over model, or neither")
    xt = pctx.tp_enter(x) if split else x

    z = pctx.shard(xt @ params.w_z, ba, None, "model")
    xs = pctx.shard(xt @ params.w_x, ba, None, "model")
    b_raw = x @ params.w_b
    c_raw = x @ params.w_c
    dt_raw = xt @ params.w_dt

    st = state
    xs, conv_x_st = _causal_conv(xs, params.conv_x_w, params.conv_x_b,
                                 st.conv_x if st is not None else None)
    xs = pctx.shard(xs, ba, None, "model")
    b_in, conv_b_st = _causal_conv(b_raw, params.conv_b_w, params.conv_b_b,
                                   st.conv_b if st is not None else None)
    c_in, conv_c_st = _causal_conv(c_raw, params.conv_c_w, params.conv_c_b,
                                   st.conv_c if st is not None else None)
    if split:  # shared B/C entering the per-head work
        b_in, c_in = pctx.tp_enter(b_in), pctx.tp_enter(c_in)

    dt = F.softplus(dt_raw.float() + params.dt_bias)
    a = -torch.exp(params.a_log)  # [H], negative
    nh, di = a.shape[0], xs.shape[-1]  # this rank's heads

    xh = xs.reshape(bsz, s, nh, p)
    if s == 1 and state is not None:
        # Decode fast path: h' = h·exp(dt·a) + dt·(B ⊗ x); y = C·h' + D·x.
        h = state.ssd.float()
        dt1 = dt[:, 0, :]  # [B, H]
        da = torch.exp(dt1 * a[None, :])  # [B, H]
        outer = torch.einsum("bhp,bn->bhpn", xh[:, 0].float() * dt1[..., None],
                             b_in[:, 0].float())
        h_new = h * da[..., None, None] + outer
        y = torch.einsum("bhpn,bn->bhp", h_new, c_in[:, 0].float())
        y = y[:, None]  # [B, 1, H, P]
        new_ssd = h_new
    else:
        y, new_ssd = ssd_scan_kernel(
            xh, dt, a, b_in, c_in, chunk=cfg.ssm_chunk,
            h0=state.ssd if state is not None else None,
        )

    y = y + xh.float() * params.d_skip[None, None, :, None]
    y = y.reshape(bsz, s, di).to(x.dtype)
    y = gated_rms_norm(y, z, params.out_norm, cfg.norm_eps,
                       group=pctx.model_group if split else None)
    y = pctx.shard(y, ba, None, "model")
    out = pctx.tp_exit(y @ params.out_proj, partial=split)

    new_state = (
        SSMState(conv_x=conv_x_st, conv_b=conv_b_st, conv_c=conv_c_st,
                 ssd=new_ssd.float())
        if (return_state or state is not None)
        else None
    )
    return out, new_state


def make_ssm_state(cfg: ArchConfig, batch: int, dtype: torch.dtype = torch.float32,
                   *, device: torch.device | str = "cpu") -> SSMState:
    di, nh, p, n = _dims(cfg)
    k1 = cfg.ssm_conv - 1
    return SSMState(
        conv_x=torch.zeros(batch, k1, di, dtype=dtype, device=device),
        conv_b=torch.zeros(batch, k1, n, dtype=dtype, device=device),
        conv_c=torch.zeros(batch, k1, n, dtype=dtype, device=device),
        ssd=torch.zeros(batch, nh, p, n, dtype=torch.float32, device=device),
    )
