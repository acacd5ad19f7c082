"""AdamW with decoupled weight decay, the counterpart of
``repro.optim.adamw``, over dicts of tensors keyed by parameter name.

As in the reference, ``m`` and ``v`` are fp32 whatever the parameter's
dtype, the step ``-lr·(m̂/(√v̂+ε) + wd·p)`` is computed in fp32 and cast to
the parameter's dtype; the caller adds it in that dtype
(:mod:`repro_torch.train.step`). ``torch.optim.AdamW`` is not used: it keeps
``m`` and ``v`` in the parameter's dtype and orders the decay otherwise.
"""

from __future__ import annotations

from typing import Callable, Dict, Iterator, List, NamedTuple, Tuple, Union

import numpy as np
import torch

Tensors = Dict[str, torch.Tensor]
LR = Union[Callable[[int], float], float]


class Optimizer(NamedTuple):
    init: Callable
    update: Callable  # (grads, state, params, step) -> (updates, new_state)


def lr_schedule(lr: LR) -> Callable[[int], float]:
    return lr if callable(lr) else (lambda _: lr)


#: Elements a chunk of parameters holds at most in :func:`_chunks` (a
#: parameter larger than this is a chunk of its own).
CHUNK_ELEMENTS = 1 << 27


def _chunks(params: Tensors) -> Iterator[List[str]]:
    """The parameters' names in runs of at most ``CHUNK_ELEMENTS``."""
    run: List[str] = []
    size = 0
    for k, p in params.items():
        if run and size + p.numel() > CHUNK_ELEMENTS:
            yield run
            run, size = [], 0
        run.append(k)
        size += p.numel()
    if run:
        yield run


def adamw(
    lr: LR,
    *,
    b1: float = 0.9,
    b2: float = 0.95,
    eps: float = 1e-8,
    weight_decay: float = 0.1,
) -> Optimizer:
    lr_fn = lr_schedule(lr)

    def init(params: Tensors) -> Dict[str, Tensors]:
        def zeros() -> Tensors:
            return {k: torch.zeros(p.shape, dtype=torch.float32, device=p.device)
                    for k, p in params.items()}

        return {"m": zeros(), "v": zeros()}

    def update(grads: Tensors, state: Dict[str, Tensors], params: Tensors,
               step: int) -> Tuple[Tensors, Dict[str, Tensors]]:
        t = np.float32(step) + np.float32(1.0)
        lr_t = lr_fn(step)
        # The bias corrections as fp32 scalars, as the reference's fp32 step.
        c1 = float(np.float32(1.0) - np.float32(b1) ** t)
        c2 = float(np.float32(1.0) - np.float32(b2) ** t)
        updates: Tensors = {}
        m_out: Tensors = {}
        v_out: Tensors = {}
        # The reference's elementwise expressions, op for op (so each value
        # rounds as there), on lists of tensors: one launch an op for a
        # chunk of parameters, whose temporaries stay bounded.
        for keys in _chunks(params):
            g = [grads[k].float() for k in keys]
            m = torch._foreach_mul([state["m"][k] for k in keys], b1)
            torch._foreach_add_(m, torch._foreach_mul(g, 1 - b1))
            v = torch._foreach_mul([state["v"][k] for k in keys], b2)
            torch._foreach_add_(v, torch._foreach_mul(torch._foreach_mul(g, 1 - b2), g))
            den = torch._foreach_sqrt(torch._foreach_div(v, c2))
            torch._foreach_add_(den, eps)
            delta = torch._foreach_div(torch._foreach_div(m, c1), den)
            torch._foreach_add_(delta, torch._foreach_mul([params[k].float() for k in keys],
                                                          weight_decay))
            torch._foreach_mul_(delta, -lr_t)
            for k, d, mk, vk in zip(keys, delta, m, v):
                updates[k] = d.to(params[k].dtype)
                m_out[k], v_out[k] = mk, vk
        return updates, {"m": m_out, "v": v_out}

    return Optimizer(init=init, update=update)
