"""Token embeddings and the output head with a padded vocab, the
counterpart of ``repro.models.layers.embedding``.

The vocab is padded to a multiple of 256, as in the reference (whose padding
lets the vocab shard over the ``model`` axis); padded logits are masked to
-1e30 so they never win. The head is the embedding (tied) or its own
``unembed`` [d, V_pad]; gemma scales the embeddings by sqrt(d) in the
activation dtype and soft-caps the logits before the mask.

Under a mesh the vocab is split over ``model`` (``embed`` [V_pad/tp, d] and
``unembed`` [d, V_pad/tp] on each rank, tied heads included): a rank looks
up the tokens of its vocab range and the model ranks' rows are summed
(Megatron's "g"); the head gives each rank its vocab range of the logits
(:func:`logits_out`), which the vocab-parallel cross-entropy
(``repro_torch.train.step.cross_entropy``) or :func:`gather_vocab` takes.
"""

from __future__ import annotations

import math
from typing import Optional

import torch
from torch import nn

from repro_torch.configs.base import ArchConfig
from repro_torch.parallel import collectives as C
from repro_torch.parallel.ctx import ParallelCtx
from repro_torch.parallel.sharding import Keep, keep_all

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


def init_embedding(gen: torch.Generator, cfg: ArchConfig, dtype: torch.dtype,
                   keep: Keep = keep_all) -> Embedding:
    """Random tables drawn from ``gen``, on ``gen``'s device, each passed
    through ``keep`` as it is drawn."""
    vp = padded_vocab(cfg.vocab_size)
    d = cfg.d_model
    dev = gen.device
    embed = keep("embed", (torch.randn(vp, d, generator=gen, device=dev) * 0.02).to(dtype))
    unembed = None
    if not cfg.tie_embeddings:
        unembed = keep("unembed",
                       (torch.randn(d, vp, generator=gen, device=dev) / math.sqrt(d)).to(dtype))
    return Embedding(embed, unembed)


def vocab_split(params: Embedding, cfg: ArchConfig) -> bool:
    """Whether this rank holds a slice of the vocab (not the whole)."""
    return params.embed.shape[0] != padded_vocab(cfg.vocab_size)


def lookup(params: Embedding, tokens: torch.Tensor, cfg: ArchConfig,
           pctx: ParallelCtx) -> torch.Tensor:
    """``embed[tokens]``; over a split vocab, each rank's rows of its range
    (zeros elsewhere), summed over ``model``."""
    if not vocab_split(params, cfg):
        return params.embed[tokens]
    v_loc = params.embed.shape[0]
    local = tokens.long() - pctx.model_rank * v_loc
    inside = (local >= 0) & (local < v_loc)
    rows = params.embed[local.clamp(0, v_loc - 1)]
    rows = rows * inside[..., None].to(rows.dtype)
    return C.reduce_from(rows, pctx.model_group)


def embed_tokens(params: Embedding, tokens: torch.Tensor, cfg: ArchConfig,
                 pctx: ParallelCtx) -> torch.Tensor:
    x = lookup(params, tokens, cfg, pctx)
    if cfg.emb_scale_by_sqrt_dim:
        x = x * torch.tensor(math.sqrt(cfg.d_model), dtype=x.dtype, device=x.device)
    return pctx.shard(x, pctx.batch_axes, None, None)


def logits_out(params: Embedding, x: torch.Tensor, cfg: ArchConfig,
               pctx: ParallelCtx) -> torch.Tensor:
    """The logits of this rank's vocab range (all of it without a split)."""
    head = params.embed.T if params.unembed is None else params.unembed
    split = vocab_split(params, cfg)
    if split:
        x = pctx.tp_enter(x)
    logits = pctx.shard(x @ head, pctx.batch_axes, None, "model")
    if cfg.final_softcap is not None:
        logits = torch.tanh(logits / cfg.final_softcap) * cfg.final_softcap
    vp = logits.shape[-1]
    start = pctx.model_rank * vp if split else 0
    if start + vp > cfg.vocab_size:
        mask = torch.arange(start, start + vp, device=logits.device) < cfg.vocab_size
        logits = torch.where(mask, logits, torch.full((), -1e30, dtype=logits.dtype,
                                                      device=logits.device))
    return logits


def gather_vocab(logits: torch.Tensor, params: Embedding, cfg: ArchConfig,
                 pctx: ParallelCtx) -> torch.Tensor:
    """Every rank's vocab range of the logits → all of them (no autograd)."""
    if not vocab_split(params, cfg):
        return logits
    return C.gather_tensor(logits, pctx.model_group, logits.ndim - 1)
