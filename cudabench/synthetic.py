"""Deterministic synthetic LM data, the training cells' traffic generator.

Copied from ``src/repro_torch/data/synthetic.py`` (``SyntheticLMDataset``),
unchanged but for this docstring, so that a change to the program does not
change the benchmark's traffic. NumPy only: stateless and indexable by
step, so the same seed and step give the same batch.

Token streams are Zipf-distributed with a Markov next-token bias.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Dict

import numpy as np


@dataclass(frozen=True)
class SyntheticLMDataset:
    vocab_size: int
    seq_len: int
    global_batch: int
    seed: int = 0
    zipf_a: float = 1.2

    def batch_at(self, step: int) -> Dict[str, np.ndarray]:
        """Batch for a given step (same step ⇒ same batch, forever)."""
        rng = np.random.default_rng(
            np.array([self.seed, step], dtype=np.uint64)
        )
        b, s, v = self.global_batch, self.seq_len + 1, self.vocab_size
        base = rng.zipf(self.zipf_a, size=(b, s)).astype(np.int64)
        toks = (base - 1) % v
        # Markov bias: with p=0.5 the next token is a fixed function of the
        # current one — gives the model something learnable.
        nxt = (toks[:, :-1] * 31 + 7) % v
        mask = rng.random((b, s - 1)) < 0.5
        toks[:, 1:] = np.where(mask, nxt, toks[:, 1:])
        toks = toks.astype(np.int32)
        return {"tokens": toks[:, :-1], "labels": toks[:, 1:]}
