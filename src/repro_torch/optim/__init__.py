"""Optimizers (hand-rolled ``init``/``update`` pairs over dicts of tensors
keyed by parameter name), LR schedules, and error-feedback gradient
compression: the counterpart of ``repro.optim``."""

from repro_torch.optim.adamw import Optimizer, adamw
from repro_torch.optim.adafactor import adafactor
from repro_torch.optim.schedule import cosine_warmup
from repro_torch.optim.grad_compress import ef_int8_compressor

__all__ = ["Optimizer", "adamw", "adafactor", "cosine_warmup", "ef_int8_compressor"]
