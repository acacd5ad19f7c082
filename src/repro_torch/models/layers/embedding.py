"""Token embeddings and the output head with a padded vocab, the
counterpart of ``repro.models.layers.embedding``.

The vocab is padded to a multiple of 256, as in the reference (whose padding
lets the vocab shard over the ``model`` axis); padded logits are masked to
-1e30 so they never win. The head is the embedding (tied) or its own
``unembed`` [d, V_pad]; gemma scales the embeddings by sqrt(d) in the
activation dtype and soft-caps the logits before the mask.
"""

from __future__ import annotations

import math
from typing import Optional

import torch
from torch import nn

from repro_torch.configs.base import ArchConfig
from repro_torch.parallel.ctx import ParallelCtx

VOCAB_PAD = 256


def padded_vocab(v: int) -> int:
    return -(-v // VOCAB_PAD) * VOCAB_PAD


class Embedding(nn.Module):
    """``embed`` [V_pad, D]; ``unembed`` [D, V_pad] where the head is not
    tied (else ``None``, and ``embed`` is the head)."""

    unembed: Optional[nn.Parameter]

    def __init__(self, embed: torch.Tensor, unembed: Optional[torch.Tensor] = None) -> None:
        super().__init__()
        self.embed = nn.Parameter(embed, requires_grad=False)
        self.unembed = None if unembed is None else nn.Parameter(unembed, requires_grad=False)


def init_embedding(gen: torch.Generator, cfg: ArchConfig, dtype: torch.dtype) -> Embedding:
    vp = padded_vocab(cfg.vocab_size)
    d = cfg.d_model
    dev = gen.device
    embed = (torch.randn(vp, d, generator=gen, device=dev) * 0.02).to(dtype)
    unembed = None
    if not cfg.tie_embeddings:
        unembed = (torch.randn(d, vp, generator=gen, device=dev) / math.sqrt(d)).to(dtype)
    return Embedding(embed, unembed)


def embed_tokens(params: Embedding, tokens: torch.Tensor, cfg: ArchConfig,
                 pctx: ParallelCtx) -> torch.Tensor:
    x = params.embed[tokens]
    if cfg.emb_scale_by_sqrt_dim:
        x = x * torch.tensor(math.sqrt(cfg.d_model), dtype=x.dtype, device=x.device)
    return pctx.shard(x, pctx.batch_axes, None, None)


def logits_out(params: Embedding, x: torch.Tensor, cfg: ArchConfig,
               pctx: ParallelCtx) -> torch.Tensor:
    head = params.embed.T if params.unembed is None else params.unembed
    logits = pctx.shard(x @ head, pctx.batch_axes, None, "model")
    if cfg.final_softcap is not None:
        logits = torch.tanh(logits / cfg.final_softcap) * cfg.final_softcap
    vp = logits.shape[-1]
    if vp != cfg.vocab_size:
        mask = torch.arange(vp, device=logits.device) < cfg.vocab_size
        logits = torch.where(mask, logits, torch.full((), -1e30, dtype=logits.dtype,
                                                      device=logits.device))
    return logits
