"""RMSNorm, Mamba-2's gated RMSNorm and whisper's LayerNorm, the
counterparts of ``repro.models.layers.norms``.

The RMSNorm scale is stored zero-centred (the weight is ``1 + scale``); the
LayerNorm keeps a scale (ones) and a bias (zeros). Both are fp32, and the
statistics are taken in fp32 whatever the activation dtype, as in the
reference.

Where the normalised dim is split over a process group (Mamba-2's gated
norm over d_inner, split over ``model`` under a mesh), the mean of squares
is the group's sum of squares over the whole dim: without it the norm
would be taken per shard.
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.distributed as dist
import torch.nn.functional as F
from torch import nn

from repro_torch.device import DeviceLike
from repro_torch.parallel import collectives as C


class RMSNorm(nn.Module):
    """Holds the zero-centred ``scale`` of one RMSNorm (fp32, zeros); also
    Mamba2's gated output norm."""

    def __init__(self, d: int, *, device: DeviceLike = "cpu") -> None:
        super().__init__()
        self.scale = nn.Parameter(
            torch.zeros(d, dtype=torch.float32, device=device), requires_grad=False
        )


def rms_norm(x: torch.Tensor, params: RMSNorm, eps: float = 1e-6, *,
             group: Optional[dist.ProcessGroup] = None) -> torch.Tensor:
    """RMSNorm over the last dim; with ``group``, that dim is split over the
    group and its mean of squares is taken over the whole."""
    dtype = x.dtype
    x32 = x.float()
    if group is None:
        var = x32.square().mean(dim=-1, keepdim=True)
    else:
        n = x32.shape[-1] * dist.get_world_size(group)
        var = C.all_reduce_both(x32.square().sum(dim=-1, keepdim=True), group) / n
    y = x32 * torch.rsqrt(var + eps)
    # "zero-centered" scale (gemma/qwen convention: weight stored as scale-1)
    return (y * (1.0 + params.scale.float())).to(dtype)


class LayerNorm(nn.Module):
    """Holds the ``scale`` (ones) and ``bias`` (zeros) of one LayerNorm, fp32."""

    def __init__(self, d: int, *, device: DeviceLike = "cpu") -> None:
        super().__init__()
        self.scale = nn.Parameter(
            torch.ones(d, dtype=torch.float32, device=device), requires_grad=False
        )
        self.bias = nn.Parameter(
            torch.zeros(d, dtype=torch.float32, device=device), requires_grad=False
        )


def layer_norm(x: torch.Tensor, params: LayerNorm, eps: float = 1e-5) -> torch.Tensor:
    dtype = x.dtype
    x32 = x.float()
    mu = x32.mean(dim=-1, keepdim=True)
    # The population variance, as ``jnp.var`` (torch's default is unbiased).
    var = x32.var(dim=-1, keepdim=True, correction=0)
    y = (x32 - mu) * torch.rsqrt(var + eps)
    return (y * params.scale + params.bias).to(dtype)


def gated_rms_norm(
    x: torch.Tensor, z: torch.Tensor, params: RMSNorm, eps: float = 1e-5, *,
    group: Optional[dist.ProcessGroup] = None,
) -> torch.Tensor:
    y = x * F.silu(z.float()).to(x.dtype)
    return rms_norm(y, params, eps, group=group)
