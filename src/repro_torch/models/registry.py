"""Uniform Model facade, the counterpart of ``repro.models.registry``, for
every family: ``ssm``, ``dense``, ``moe`` and ``vlm`` through
:mod:`~repro_torch.models.transformer`, ``hybrid`` and ``encdec`` through
their own assemblies.

Batch dict conventions (as in the reference):
  prefill : tokens [B,S] integer (+ patches [B,P,D] for vlm, frames
            [B,T,D] for encdec)
  decode  : token [B,1] integer, pos [B] integer (+ caches from
            make_caches/prefill)

``train_logits`` waits for the training slice.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, Optional, Tuple, Union

import torch
from torch import nn

from repro_torch.configs.base import ArchConfig
from repro_torch.device import DeviceLike, resolve_device
from repro_torch.models import encdec as E
from repro_torch.models import hybrid as H
from repro_torch.models import transformer as T
from repro_torch.parallel.ctx import ParallelCtx

Tensor = torch.Tensor


@dataclass(frozen=True)
class Model:
    cfg: ArchConfig

    def __post_init__(self) -> None:
        if self.cfg.family not in T.PORTED_FAMILIES:
            raise T.not_ported(f"Model for family {self.cfg.family!r} ({self.cfg.arch_id})")

    # ------------------------------------------------------------- init -----
    def init(self, seed: Union[int, torch.Generator], *, device: DeviceLike = "cuda",
             max_dec_len: int = 4096) -> nn.Module:
        """Random weights from ``seed`` (an int, or a ``torch.Generator``
        whose device then decides where they are made), drawn on the device
        they live on: an :class:`~repro_torch.models.encdec.EncDec` (its
        ``dec_pos`` of ``max_dec_len`` positions) for the encdec family, a
        :class:`~repro_torch.models.hybrid.HybridLM` for the hybrid family,
        else a :class:`~repro_torch.models.transformer.LM`."""
        if isinstance(seed, torch.Generator):
            gen = seed
        else:
            gen = torch.Generator(device=resolve_device(device)).manual_seed(seed)
        if self.cfg.family == "encdec":
            return E.init_encdec(gen, self.cfg, max_dec_len=max_dec_len)
        if self.cfg.family == "hybrid":
            return H.init_hybrid(gen, self.cfg)
        return T.init_lm(gen, self.cfg)

    # ----------------------------------------------------------- serving ----
    def make_caches(self, batch: int, max_len: int, *,
                    device: DeviceLike = "cuda") -> T.Caches:
        dev = resolve_device(device)
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
        tokens = batch["tokens"]
        b, s = tokens.shape
        max_len = max_len or s
        caches = self.make_caches(b, max_len, device=tokens.device)
        zero = torch.zeros((b,), dtype=torch.int32, device=tokens.device)
        if cfg.family == "encdec":
            enc_out = E.encode(params, batch["frames"], cfg, pctx)
            logits, new_caches = E.decode(params, tokens, enc_out, cfg, pctx,
                                          caches=caches, cache_index=zero)
            assert new_caches is not None
            new_caches["enc_out"] = enc_out
            return logits, new_caches
        if cfg.family == "hybrid":
            logits, new_caches, _ = H.hybrid_forward(
                params, tokens, cfg, pctx, caches=caches, cache_index=zero, want_state=True)
        else:
            logits, new_caches, _ = T.lm_forward(
                params, tokens, cfg, pctx, patch_embeds=batch.get("patches"),
                caches=caches, cache_index=zero, want_state=True)
        assert new_caches is not None
        return logits, new_caches

    @torch.inference_mode()
    def decode_step(
        self, params: nn.Module, caches: T.Caches,
        batch: Dict[str, Tensor], pctx: ParallelCtx,
    ) -> Tuple[Tensor, T.Caches]:
        """One token step. batch: token [B,1], pos [B] (the position the
        token is written at; the SSM state carries its own)."""
        cfg = self.cfg
        token, pos = batch["token"], batch["pos"]
        if cfg.family == "encdec":
            enc_out = caches["enc_out"]
            logits, new_caches = E.decode(params, token, enc_out, cfg, pctx,
                                          positions=pos[:, None], caches={"kv": caches["kv"]},
                                          cache_index=pos)
            assert new_caches is not None
            new_caches["enc_out"] = enc_out
            return logits, new_caches
        forward = H.hybrid_forward if cfg.family == "hybrid" else T.lm_forward
        logits, new_caches, _ = forward(
            params, token, cfg, pctx, positions=pos[:, None], caches=caches,
            cache_index=pos, want_state=True)
        assert new_caches is not None
        return logits, new_caches


def build_model(cfg: ArchConfig) -> Model:
    return Model(cfg=cfg)
