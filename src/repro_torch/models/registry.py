"""Uniform Model facade, the counterpart of ``repro.models.registry`` for
the ``ssm`` family.

Batch dict conventions (as in the reference):
  prefill : tokens [B,S] integer
  decode  : token [B,1] integer, pos [B] integer (+ caches from
            make_caches/prefill)

``encdec`` and ``hybrid``, and the attention families, raise
``NotImplementedError``; ``train_logits`` waits for the training slice.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, Optional, Tuple, Union

import torch

from repro_torch.configs.base import ArchConfig
from repro_torch.device import DeviceLike, resolve_device
from repro_torch.models import transformer as T
from repro_torch.parallel.ctx import ParallelCtx

Tensor = torch.Tensor


@dataclass(frozen=True)
class Model:
    cfg: ArchConfig

    def __post_init__(self) -> None:
        if self.cfg.family != "ssm":
            raise T.not_ported(f"Model for family {self.cfg.family!r} ({self.cfg.arch_id})")

    # ------------------------------------------------------------- init -----
    def init(self, seed: Union[int, torch.Generator], *, device: DeviceLike = "cuda") -> T.LM:
        """Random weights from ``seed`` (an int, or a ``torch.Generator``
        whose device then decides where they are made), drawn on the device
        they live on."""
        if isinstance(seed, torch.Generator):
            gen = seed
        else:
            gen = torch.Generator(device=resolve_device(device)).manual_seed(seed)
        return T.init_lm(gen, self.cfg)

    # ----------------------------------------------------------- serving ----
    def make_caches(self, batch: int, max_len: int, *,
                    device: DeviceLike = "cuda") -> T.Caches:
        return T.make_decoder_caches(self.cfg, batch, max_len,
                                     device=resolve_device(device))

    @torch.inference_mode()
    def prefill(
        self, params: T.LM, batch: Dict[str, Tensor], pctx: ParallelCtx,
        *, max_len: Optional[int] = None,
    ) -> Tuple[Tensor, T.Caches]:
        """Run the prompt, returning (logits, caches primed at position S)."""
        tokens = batch["tokens"]
        b, s = tokens.shape
        max_len = max_len or s
        caches = self.make_caches(b, max_len, device=tokens.device)
        logits, new_caches, _ = T.lm_forward(params, tokens, self.cfg, pctx,
                                             caches=caches, want_state=True)
        assert new_caches is not None
        return logits, new_caches

    @torch.inference_mode()
    def decode_step(
        self, params: T.LM, caches: T.Caches,
        batch: Dict[str, Tensor], pctx: ParallelCtx,
    ) -> Tuple[Tensor, T.Caches]:
        """One token step. batch: token [B,1], pos [B] (the SSM state
        carries the position; ``pos`` is the reference's, for attention)."""
        logits, new_caches, _ = T.lm_forward(params, batch["token"], self.cfg, pctx,
                                             caches=caches, want_state=True)
        assert new_caches is not None
        return logits, new_caches


def build_model(cfg: ArchConfig) -> Model:
    return Model(cfg=cfg)
