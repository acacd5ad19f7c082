"""Learning-rate schedules, the counterpart of ``repro.optim.schedule``.

The reference evaluates its schedule in fp32 (``jnp.float32`` steps); this
one does the same arithmetic on numpy fp32 scalars and returns a Python
float, so both give the same learning rate at every step.
"""

from __future__ import annotations

from typing import Callable

import numpy as np


def cosine_warmup(peak_lr: float, warmup_steps: int, total_steps: int,
                  *, final_frac: float = 0.1) -> Callable[[int], float]:
    f32 = np.float32
    # Python-float subexpressions are folded in double first, as the
    # reference's weakly typed constants are.
    peak, final, half_span = f32(peak_lr), f32(final_frac), f32((1 - final_frac) * 0.5)

    def lr(step: int) -> float:
        s = f32(step)
        if s < warmup_steps:
            return float(peak * (s + f32(1.0)) / f32(max(warmup_steps, 1)))
        prog = np.clip((s - f32(warmup_steps)) / f32(max(total_steps - warmup_steps, 1)),
                       f32(0.0), f32(1.0))
        cos = peak * (final + half_span * (f32(1) + np.cos(f32(np.pi) * prog)))
        return float(cos)

    return lr
