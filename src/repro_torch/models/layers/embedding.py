"""Token embeddings and the tied output head with a padded vocab, the
counterpart of ``repro.models.layers.embedding`` for the configs the port
serves (tied embeddings, no softcap, no embedding scale; the others raise).

The vocab is padded to a multiple of 256, as in the reference (whose padding
lets the vocab shard over the ``model`` axis); padded logits are masked to
-1e30 so they never win.
"""

from __future__ import annotations

import torch
from torch import nn

from repro_torch.configs.base import ArchConfig
from repro_torch.parallel.ctx import ParallelCtx

VOCAB_PAD = 256


def padded_vocab(v: int) -> int:
    return -(-v // VOCAB_PAD) * VOCAB_PAD


class Embedding(nn.Module):
    """``embed`` [V_pad, D], also the output head (tied)."""

    def __init__(self, embed: torch.Tensor) -> None:
        super().__init__()
        self.embed = nn.Parameter(embed, requires_grad=False)


def init_embedding(gen: torch.Generator, cfg: ArchConfig, dtype: torch.dtype) -> Embedding:
    if not cfg.tie_embeddings or cfg.final_softcap is not None or cfg.emb_scale_by_sqrt_dim:
        raise NotImplementedError(
            f"{cfg.arch_id}: the port's embedding is the tied head without softcap or "
            f"embedding scale (the ssm family's); the others are still to be ported (ROADMAP)"
        )
    vp = padded_vocab(cfg.vocab_size)
    dev = gen.device
    return Embedding((torch.randn(vp, cfg.d_model, generator=gen, device=dev) * 0.02).to(dtype))


def embed_tokens(params: Embedding, tokens: torch.Tensor, cfg: ArchConfig,
                 pctx: ParallelCtx) -> torch.Tensor:
    return pctx.shard(params.embed[tokens], pctx.batch_axes, None, None)


def logits_out(params: Embedding, x: torch.Tensor, cfg: ArchConfig,
               pctx: ParallelCtx) -> torch.Tensor:
    logits = pctx.shard(x @ params.embed.T, pctx.batch_axes, None, "model")
    vp = logits.shape[-1]
    if vp != cfg.vocab_size:
        mask = torch.arange(vp, device=logits.device) < cfg.vocab_size
        logits = torch.where(mask, logits, torch.full((), -1e30, dtype=logits.dtype,
                                                      device=logits.device))
    return logits
