"""The plain reference of a Mamba-2 language model's training step, and the
weights the benchmark hands both sides.

Plain PyTorch in float32 (TF32 off), written from the published
description: Mamba-2 (arXiv:2405.21060) with its minimal SSD listing
(``ssd_minimal_discrete``, chunked, one B/C group), causal depthwise
convolutions on x, B and C, the gated RMSNorm before the output
projection, pre-norm residual blocks, a final RMSNorm and a head tied to
the embedding, the mean next-token cross-entropy, and AdamW. RMSNorm
scales are stored zero-centred (weight ``1 + scale``), as the benchmark
makes them. Each layer is recomputed in the backward
(``torch.utils.checkpoint``) so that the reference fits beside nothing
else; that changes no value.

The configuration trains its matrices in bfloat16 without float32 master
copies: each AdamW update is computed in float32 from float32 moments,
rounded to the parameter's dtype and added in it. The reference computes
in float32 and stores each parameter in the configuration's dtype after
each update in the same way, so that the parameters it moves are the
configuration's.

``precision="fp8"`` is the control: every matrix product's two operands
rounded to float8 e4m3 with a per-tensor scale (the gradient passes
through the rounding unchanged), the rest as above.
"""

from __future__ import annotations

import math
from typing import Dict, Iterator, List, Sequence, Tuple

import numpy as np
import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from cudabench import formulas

Tensor = torch.Tensor
Params = Dict[str, Tensor]

#: A layer's leaves in the order the layer function takes them.
LAYER_LEAVES = ("ln1.scale", "ssm.w_z", "ssm.w_x", "ssm.w_b", "ssm.w_c", "ssm.w_dt",
                "ssm.conv_x_w", "ssm.conv_x_b", "ssm.conv_b_w", "ssm.conv_b_b",
                "ssm.conv_c_w", "ssm.conv_c_b", "ssm.dt_bias", "ssm.a_log",
                "ssm.d_skip", "ssm.out_proj", "ssm.out_norm.scale")
E4M3_MAX = 448.0


# ------------------------------------------------------------------ weights --
def leaf_recipe(arch: Dict) -> Iterator[Tuple[str, Tuple[int, ...], str, float]]:
    """Every leaf as (name, shape, how, scale): ``how`` is ``"normal"`` (a
    standard normal times ``scale``, in the model's dtype), ``"zeros"`` or
    ``"ones"`` (in the model's dtype), ``"zeros32"``, ``"ones32"`` or
    ``"alog32"`` (float32; ``log`` of 1..H evenly spaced)."""
    m = formulas.mamba2_dims(arch)
    d, di, n, h, k = m["d"], m["di"], m["n"], m["h"], m["k"]
    yield "emb.embed", (m["vp"], d), "normal", 0.02
    for i in range(m["layers"]):
        p = f"layers.{i}."
        yield p + "ln1.scale", (d,), "zeros32", 0.0
        for w, cols in (("w_z", di), ("w_x", di), ("w_b", n), ("w_c", n), ("w_dt", h)):
            yield p + "ssm." + w, (d, cols), "normal", 1.0 / math.sqrt(d)
        for c, cols in (("x", di), ("b", n), ("c", n)):
            yield p + f"ssm.conv_{c}_w", (k, cols), "normal", 0.2
            yield p + f"ssm.conv_{c}_b", (cols,), "zeros", 0.0
        yield p + "ssm.dt_bias", (h,), "zeros32", 0.0
        yield p + "ssm.a_log", (h,), "alog32", 0.0
        yield p + "ssm.d_skip", (h,), "ones32", 0.0
        yield p + "ssm.out_proj", (di, d), "normal", 1.0 / math.sqrt(di)
        yield p + "ssm.out_norm.scale", (di,), "zeros32", 0.0
    yield "final_ln.scale", (d,), "zeros32", 0.0


def make_weights(arch: Dict, seed: int, device: torch.device) -> Params:
    """Every leaf from ``seed``: the normal leaves are slices of one
    standard-normal draw made on ``device`` by a ``torch.Generator`` there,
    each scaled and cast to the model's dtype."""
    dtype = getattr(torch, arch["dtype"])
    recipe = list(leaf_recipe(arch))
    total = sum(math.prod(s) for _, s, how, _ in recipe if how == "normal")
    gen = torch.Generator(device=device).manual_seed(seed)
    flat = torch.randn(total, generator=gen, device=device)
    out: Params = {}
    at = 0
    for name, shape, how, scale in recipe:
        if how == "normal":
            size = math.prod(shape)
            out[name] = (flat[at:at + size].view(shape) * scale).to(dtype)
            at += size
        elif how in ("zeros", "ones"):
            out[name] = getattr(torch, how)(shape, dtype=dtype, device=device)
        elif how in ("zeros32", "ones32"):
            out[name] = getattr(torch, how[:-2])(shape, dtype=torch.float32, device=device)
        else:
            out[name] = torch.log(torch.linspace(1.0, float(max(shape[0], 2)), shape[0],
                                                 dtype=torch.float32, device=device))
    return out


# ------------------------------------------------------------------ forward --
def fp8_round(t: Tensor) -> Tensor:
    """``t`` rounded to float8 e4m3 with a per-tensor scale, the gradient
    passed through unchanged."""
    scale = t.detach().abs().amax().clamp(min=1e-30) / E4M3_MAX
    q = (t.detach() / scale).to(torch.float8_e4m3fn).to(t.dtype) * scale
    return t + (q - t.detach())


def _mm(a: Tensor, b: Tensor, fp8: bool) -> Tensor:
    if fp8:
        a, b = fp8_round(a), fp8_round(b)
    return a @ b


def rms_norm(x: Tensor, scale: Tensor, eps: float) -> Tensor:
    return x * torch.rsqrt(x.square().mean(-1, keepdim=True) + eps) * (1.0 + scale)


def causal_conv(x: Tensor, w: Tensor, b: Tensor) -> Tensor:
    """Depthwise causal convolution over the sequence: x [B, S, C], w [K, C];
    output t reads inputs t-K+1 .. t (zeros before the start)."""
    k, c = w.shape
    s = x.shape[1]
    y = F.conv1d(x.transpose(1, 2), w.t().unsqueeze(1), b, padding=k - 1, groups=c)
    return y[..., :s].transpose(1, 2)


def segsum(x: Tensor) -> Tensor:
    """[..., T] → [..., T, T]: entry (i, j) is x[j+1] + ... + x[i] for
    i ≥ j, -inf above the diagonal."""
    t = x.shape[-1]
    xe = x[..., None].expand(*x.shape, t)
    mask = torch.tril(torch.ones(t, t, dtype=torch.bool, device=x.device), diagonal=-1)
    xs = torch.cumsum(xe.masked_fill(~mask, 0), dim=-2)
    keep = torch.tril(torch.ones(t, t, dtype=torch.bool, device=x.device), diagonal=0)
    return xs.masked_fill(~keep, -torch.inf)


def ssd(x: Tensor, a: Tensor, b: Tensor, c: Tensor, chunk: int) -> Tensor:
    """The SSD scan from a zero state (the paper's minimal chunked form):
    x [B, S, H, P] (already times dt), a [B, S, H] (dt times the decay
    rate), b and c [B, S, N] (one group). Returns y [B, S, H, P]."""
    bsz, s, h, p = x.shape
    nc = s // chunk
    x = x.reshape(bsz, nc, chunk, h, p)
    b = b.reshape(bsz, nc, chunk, -1)
    c = c.reshape(bsz, nc, chunk, -1)
    a = a.reshape(bsz, nc, chunk, h).permute(0, 3, 1, 2)  # [B, H, C, L]
    a_cum = torch.cumsum(a, dim=-1)
    # 1. the outputs within each chunk
    decay = torch.exp(segsum(a))  # [B, H, C, L, L]
    scores = torch.einsum("bcln,bcsn->bcls", c, b)
    y_diag = torch.einsum("bhcls,bcshp->bclhp", decay * scores[:, None], x)
    # 2. each chunk's final state
    to_end = torch.exp(a_cum[..., -1:] - a_cum)  # [B, H, C, L]
    states = torch.einsum("bcln,bhcl,bclhp->bchpn", b, to_end, x)
    # 3. the states entering each chunk
    states = torch.cat([torch.zeros_like(states[:, :1]), states], dim=1)
    chunk_decay = torch.exp(segsum(F.pad(a_cum[..., -1], (1, 0))))  # [B, H, C+1, C+1]
    states = torch.einsum("bhzc,bchpn->bzhpn", chunk_decay, states)[:, :-1]
    # 4. their contribution to each output
    y_off = torch.einsum("bcln,bchpn,bhcl->bclhp", c, states, torch.exp(a_cum))
    return (y_diag + y_off).reshape(bsz, s, h, p)


def layer(x: Tensor, *leaves: Tensor, dims: Dict[str, int], eps: float, fp8: bool) -> Tensor:
    """One pre-norm Mamba-2 block: x [B, S, D] → x + mixer(norm(x))."""
    (ln1, w_z, w_x, w_b, w_c, w_dt, cxw, cxb, cbw, cbb, ccw, ccb,
     dt_bias, a_log, d_skip, out_proj, out_norm) = leaves
    bsz, s, _ = x.shape
    h_, p_ = dims["h"], dims["p"]
    u = rms_norm(x, ln1, eps)
    z = _mm(u, w_z, fp8)
    xs = F.silu(causal_conv(_mm(u, w_x, fp8), cxw, cxb))
    bb = F.silu(causal_conv(_mm(u, w_b, fp8), cbw, cbb))
    cc = F.silu(causal_conv(_mm(u, w_c, fp8), ccw, ccb))
    dt = F.softplus(_mm(u, w_dt, fp8) + dt_bias)  # [B, S, H]
    a = -torch.exp(a_log)
    xh = xs.reshape(bsz, s, h_, p_)
    y = ssd(xh * dt[..., None], dt * a, bb, cc, min(dims["q"], s))
    y = (y + xh * d_skip[:, None]).reshape(bsz, s, -1)
    y = rms_norm(y * F.silu(z), out_norm, eps)
    return x + _mm(y, out_proj, fp8)


def loss_of(params: Params, tokens: Tensor, labels: Tensor, arch: Dict, fp8: bool) -> Tensor:
    """The mean next-token cross-entropy of the batch, in float32."""
    dims = formulas.mamba2_dims(arch)
    eps = arch["norm_epsilon"]
    x = params["emb.embed"][tokens.long()]
    for i in range(dims["layers"]):
        leaves = [params[f"layers.{i}.{k}"] for k in LAYER_LEAVES]
        x = checkpoint(layer, x, *leaves, dims=dims, eps=eps, fp8=fp8, use_reentrant=False)
    x = rms_norm(x, params["final_ln.scale"], eps)
    logits = _mm(x, params["emb.embed"].t(), fp8)[..., :dims["v"]]
    return F.cross_entropy(logits.reshape(-1, dims["v"]), labels.long().reshape(-1))


# ------------------------------------------------------------------ training --
def train(arch: Dict, opt: Dict, weights: Params, batches: Sequence[Dict[str, np.ndarray]],
          device: torch.device, precision: str = "fp32") -> Dict[str, List[float]]:
    """Follow AdamW through ``batches`` from ``weights`` (which this takes
    over). Returns the loss of each step, each leaf's gradient norm at the
    first step (``grad_norm``, with ``names``), and each leaf's change after
    the last step (``change_norm``)."""
    if precision not in ("fp32", "fp8"):
        raise ValueError(f"precision {precision!r}: 'fp32' or 'fp8'")
    fp8 = precision == "fp8"
    tf32 = (torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        names = list(weights)
        dtypes = {k: w.dtype for k, w in weights.items()}
        p = {k: w.float().requires_grad_(True) for k, w in weights.items()}
        del weights
        start = {k: v.detach().clone() for k, v in p.items()}
        m = {k: torch.zeros_like(v) for k, v in p.items()}
        vv = {k: torch.zeros_like(v) for k, v in p.items()}
        b1, b2, eps, wd, lr = (opt["b1"], opt["b2"], opt["eps"], opt["weight_decay"], opt["lr"])
        losses: List[float] = []
        grad_norm: List[float] = []
        for step, batch in enumerate(batches):
            tokens = torch.as_tensor(batch["tokens"], device=device)
            labels = torch.as_tensor(batch["labels"], device=device)
            loss = loss_of(p, tokens, labels, arch, fp8)
            grads = torch.autograd.grad(loss, [p[k] for k in names])
            losses.append(float(loss.detach()))
            if step == 0:
                grad_norm = [float(g.norm()) for g in grads]
            c1 = 1.0 - b1 ** (step + 1)
            c2 = 1.0 - b2 ** (step + 1)
            with torch.no_grad():
                for k, g in zip(names, grads):
                    m[k].mul_(b1).add_(g, alpha=1 - b1)
                    vv[k].mul_(b2).addcmul_(g, g, value=1 - b2)
                    upd = -lr * ((m[k] / c1) / (torch.sqrt(vv[k] / c2) + eps) + wd * p[k])
                    # stored in the configuration's dtype, as the program holds it
                    new = (p[k].to(dtypes[k]) + upd.to(dtypes[k])).float()
                    p[k].copy_(new)
            del grads
        change = [float((p[k].detach() - start[k]).norm()) for k in names]
        return {"names": names, "ndim": [p[k].dim() for k in names], "loss": losses,
                "grad_norm": grad_norm, "change_norm": change}
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = tf32
