"""Uniform Model facade, the counterpart of ``repro.models.registry``, for
every family: ``ssm``, ``dense``, ``moe`` and ``vlm`` through
:mod:`~repro_torch.models.transformer`, ``hybrid`` and ``encdec`` through
their own assemblies.

Batch dict conventions (as in the reference):
  train   : tokens [B,S] integer, labels [B,S] integer (+ patches [B,P,D]
            for vlm, frames [B,T,D] for encdec)
  prefill : tokens [B,S] integer (+ patches / frames)
  decode  : token [B,1] integer, pos [B] integer (+ caches from
            make_caches/prefill)

``train_logits`` records the autograd graph (the training step,
:mod:`repro_torch.train.step`); ``prefill`` and ``decode_step`` run under
``torch.inference_mode``.

Under a mesh (``pctx.mesh``) each rank calls these with its local
parameters (``repro_torch.parallel.sharding.shard_params``), which are
gathered over the FSDP axes on entry. ``train_logits`` takes this rank's
rows and returns its logits (its vocab range where the vocab is split);
``prefill`` and ``decode_step`` take the GLOBAL batch (the same on every
rank), keep this rank's rows, and return the global logits with this
rank's caches (kept per rank, sized by ``batch_spec``).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, Optional, Tuple, Union

import dataclasses

import torch
from torch import nn

from repro_torch.configs.base import ArchConfig
from repro_torch.device import DeviceLike, resolve_device
from repro_torch.models import encdec as E
from repro_torch.models import hybrid as H
from repro_torch.models import transformer as T
from repro_torch.models.layers.embedding import gather_vocab
from repro_torch.parallel.ctx import ParallelCtx
from repro_torch.parallel.sharding import (
    Keep,
    batch_is_sharded,
    gather_fsdp,
    gather_rows,
    keep_all,
    local_caches,
    shard_batch,
)

Tensor = torch.Tensor


@dataclass(frozen=True)
class Model:
    cfg: ArchConfig

    def __post_init__(self) -> None:
        if self.cfg.family not in T.PORTED_FAMILIES:
            raise T.not_ported(f"Model for family {self.cfg.family!r} ({self.cfg.arch_id})")

    # ------------------------------------------------------------- init -----
    def init(self, seed: Union[int, torch.Generator], *, device: DeviceLike = "cuda",
             max_dec_len: int = 4096, keep: Keep = keep_all) -> nn.Module:
        """Random weights from ``seed`` (an int, or a ``torch.Generator``
        whose device then decides where they are made), drawn on the device
        they live on: an :class:`~repro_torch.models.encdec.EncDec` (its
        ``dec_pos`` of ``max_dec_len`` positions) for the encdec family, a
        :class:`~repro_torch.models.hybrid.HybridLM` for the hybrid family,
        else a :class:`~repro_torch.models.transformer.LM`. Each drawn
        leaf (every one but the norms') is passed through ``keep`` with its
        path in the tree as it is drawn (``init_local`` keeps this rank's
        slice)."""
        if isinstance(seed, torch.Generator):
            gen = seed
        else:
            gen = torch.Generator(device=resolve_device(device)).manual_seed(seed)
        if self.cfg.family == "encdec":
            return E.init_encdec(gen, self.cfg, max_dec_len=max_dec_len, keep=keep)
        if self.cfg.family == "hybrid":
            return H.init_hybrid(gen, self.cfg, keep)
        return T.init_lm(gen, self.cfg, keep)

    # ---------------------------------------------------------- training ----
    def train_logits(self, params: nn.Module, batch: Dict[str, Tensor],
                     pctx: ParallelCtx) -> Tuple[Tensor, Tensor]:
        """Returns (logits over the loss positions, the auxiliary loss): the
        MoE's load-balancing loss summed over its layers, zero for the other
        families. The VLM's logits are cut to the text positions."""
        cfg = self.cfg
        params = gather_fsdp(params, pctx)
        if cfg.family == "encdec":
            enc_out = E.encode(params, batch["frames"], cfg, pctx)
            logits, _ = E.decode(params, batch["tokens"], enc_out, cfg, pctx)
            return logits, torch.zeros((), dtype=torch.float32, device=logits.device)
        if cfg.family == "hybrid":
            logits, _, aux = H.hybrid_forward(params, batch["tokens"], cfg, pctx)
            return logits, aux
        patches = batch.get("patches")
        logits, _, aux = T.lm_forward(params, batch["tokens"], cfg, pctx, patch_embeds=patches)
        if patches is not None:
            logits = logits[:, patches.shape[1]:, :]  # loss on text positions
        return logits, aux

    # ----------------------------------------------------------- serving ----
    def make_caches(self, batch: int, max_len: int, *,
                    device: DeviceLike = "cuda", pctx: Optional[ParallelCtx] = None) -> T.Caches:
        """Zero caches for a (global) batch of ``batch`` rows; on
        ``device="meta"`` they hold shapes and dtypes and no memory
        (``repro_torch.configs.shapes.input_specs``). Under a mesh, this
        rank's slice of each (``batch_spec``)."""
        meta = torch.device(device).type == "meta"
        dev = torch.device("meta") if meta else resolve_device(device)
        if pctx is not None and pctx.mesh is not None:
            full = self.make_caches(batch, max_len, device="meta")
            return local_caches(full, self.cfg, pctx, dev)
        if self.cfg.family == "encdec":
            return E.make_encdec_caches(self.cfg, batch, max_len, device=dev)
        if self.cfg.family == "hybrid":
            return H.make_hybrid_caches(self.cfg, batch, max_len, device=dev)
        return T.make_decoder_caches(self.cfg, batch, max_len, device=dev)

    @torch.inference_mode()
    def prefill(
        self, params: nn.Module, batch: Dict[str, Tensor], pctx: ParallelCtx,
        *, max_len: Optional[int] = None,
    ) -> Tuple[Tensor, T.Caches]:
        """Run the prompt, returning (logits, caches primed at position S).
        KV caches hold ``max_len`` positions (default S); the VLM's patches
        count towards S. The encdec family encodes ``batch["frames"]`` and
        keeps the encoder's output in ``caches["enc_out"]``."""
        cfg = self.cfg
        b, s = batch["tokens"].shape
        max_len = max_len or s
        pctx, params, batch = self._enter(params, batch, pctx)
        tokens = batch["tokens"]
        caches = self.make_caches(b, max_len, device=tokens.device, pctx=pctx)
        zero = torch.zeros((tokens.shape[0],), dtype=torch.int32, device=tokens.device)
        if cfg.family == "encdec":
            enc_out = E.encode(params, batch["frames"], cfg, pctx)
            logits, new_caches = E.decode(params, tokens, enc_out, cfg, pctx,
                                          caches=caches, cache_index=zero)
            assert new_caches is not None
            new_caches["enc_out"] = enc_out
            return self._global(logits, params, b, pctx), new_caches
        if cfg.family == "hybrid":
            logits, new_caches, _ = H.hybrid_forward(
                params, tokens, cfg, pctx, caches=caches, cache_index=zero, want_state=True)
        else:
            logits, new_caches, _ = T.lm_forward(
                params, tokens, cfg, pctx, patch_embeds=batch.get("patches"),
                caches=caches, cache_index=zero, want_state=True)
        assert new_caches is not None
        return self._global(logits, params, b, pctx), new_caches

    def _enter(self, params: nn.Module, batch: Dict[str, Tensor], pctx: ParallelCtx
               ) -> Tuple[ParallelCtx, nn.Module, Dict[str, Tensor]]:
        """Under a mesh: the context for this batch, the parameters gathered
        over the FSDP axes and this rank's rows of the global batch."""
        if pctx.mesh is None:
            return pctx, params, batch
        b = next(iter(batch.values())).shape[0]
        split = batch_is_sharded(b, pctx)
        if split != pctx.batch_split:
            pctx = dataclasses.replace(pctx, batch_split=split)
        return pctx, gather_fsdp(params, pctx), shard_batch(batch, self.cfg, pctx)

    def _global(self, logits: Tensor, params: nn.Module, b: int, pctx: ParallelCtx) -> Tensor:
        """This rank's logits → the global batch's, every vocab entry."""
        if pctx.mesh is None:
            return logits
        return gather_rows(gather_vocab(logits, params.emb, self.cfg, pctx), b, pctx)

    @torch.inference_mode()
    def decode_step(
        self, params: nn.Module, caches: T.Caches,
        batch: Dict[str, Tensor], pctx: ParallelCtx,
    ) -> Tuple[Tensor, T.Caches]:
        """One token step. batch: token [B,1], pos [B] (the position the
        token is written at; the SSM state carries its own)."""
        cfg = self.cfg
        b = batch["token"].shape[0]
        pctx, params, batch = self._enter(params, batch, pctx)
        token, pos = batch["token"], batch["pos"]
        if cfg.family == "encdec":
            enc_out = caches["enc_out"]
            logits, new_caches = E.decode(params, token, enc_out, cfg, pctx,
                                          positions=pos[:, None], caches={"kv": caches["kv"]},
                                          cache_index=pos)
            assert new_caches is not None
            new_caches["enc_out"] = enc_out
            return self._global(logits, params, b, pctx), new_caches
        forward = H.hybrid_forward if cfg.family == "hybrid" else T.lm_forward
        logits, new_caches, _ = forward(
            params, token, cfg, pctx, positions=pos[:, None], caches=caches,
            cache_index=pos, want_state=True)
        assert new_caches is not None
        return self._global(logits, params, b, pctx), new_caches


def build_model(cfg: ArchConfig) -> Model:
    return Model(cfg=cfg)
