"""Rotary position embeddings (RoPE), half-rotation convention, the
counterpart of ``repro.models.layers.rotary``.

The angles and the rotation are taken in fp32 whatever the input dtype, and
the result is cast back to it, as in the reference.
"""

from __future__ import annotations

import torch

Tensor = torch.Tensor


def rope_freqs(head_dim: int, theta: float, *, device: torch.device | str = "cpu") -> Tensor:
    return 1.0 / (
        theta ** (torch.arange(0, head_dim, 2, dtype=torch.float32, device=device) / head_dim)
    )


def apply_rope(x: Tensor, positions: Tensor, theta: float) -> Tensor:
    """x: [B, S, H, hd]; positions: [B, S] integer."""
    hd = x.shape[-1]
    freqs = rope_freqs(hd, theta, device=x.device)  # [hd/2]
    angles = positions[..., None].float() * freqs  # [B, S, hd/2]
    cos = torch.cos(angles)[..., None, :]  # [B, S, 1, hd/2]
    sin = torch.sin(angles)[..., None, :]
    x1, x2 = torch.chunk(x.float(), 2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return out.to(x.dtype)
