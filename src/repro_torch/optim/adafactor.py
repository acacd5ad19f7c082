"""Adafactor (factored second moment, no first moment), the counterpart of
``repro.optim.adafactor``, over dicts of tensors keyed by parameter name.

Memory per matrix parameter is O(rows+cols) instead of O(rows·cols): the
row and column statistics of the squared gradient, in fp32. The update's
RMS clipping is taken over the port's parameters of each of the
reference's stacked leaves (:func:`~repro_torch.optim.groups.stacked_leaf`),
as the reference takes it over each of its leaves.

Under a mesh (``pctx`` and the parameters' ``specs``) each rank updates
its slices: the row and column means, and the clipping's sum of squares
and element count, are summed over the axes their dims are split on, so
the statistics equal the unsharded ones.
"""

from __future__ import annotations

from typing import Dict, Mapping, Optional, Tuple

import torch

from repro_torch.optim.adamw import LR, Optimizer, Tensors, lr_schedule
from repro_torch.optim.groups import grouped
from repro_torch.parallel import collectives as C
from repro_torch.parallel.ctx import ParallelCtx


def _factored(p: torch.Tensor) -> bool:
    return p.ndim >= 2 and p.shape[-1] > 1 and p.shape[-2] > 1


def adafactor(
    lr: LR,
    *,
    decay: float = 0.99,
    eps: float = 1e-30,
    clip_threshold: float = 1.0,
    weight_decay: float = 0.0,
    pctx: Optional[ParallelCtx] = None,
    specs: Optional[Mapping[str, tuple]] = None,
) -> Optimizer:
    lr_fn = lr_schedule(lr)
    sharded = pctx is not None and pctx.mesh is not None and specs is not None

    def axis_of(k: str, dim: int) -> object:
        return specs[k][dim] if sharded else None  # type: ignore[index]

    def mean(t: torch.Tensor, k: str, dim: int, pdim: int) -> torch.Tensor:
        """``t.mean(dim)``, where ``dim`` is the parameter's dim ``pdim``,
        taken over the whole dim where it is split."""
        ax = axis_of(k, pdim)
        if ax is None:
            return t.mean(dim=dim)
        assert pctx is not None
        n = t.shape[dim] * pctx.axis_size(ax)
        return C.all_reduce_(t.sum(dim=dim), pctx.group(ax)) / n

    def whole(k: str, t: torch.Tensor) -> Tuple[torch.Tensor, int]:
        """(the sum of squares of the whole ``t``, its element count)."""
        sq, n = (t * t).sum(), t.numel()
        if not sharded:
            return sq, n
        assert pctx is not None and specs is not None
        for ax in specs[k]:
            if ax is not None:
                sq = C.all_reduce_(sq.clone(), pctx.group(ax))
                n *= pctx.axis_size(ax)
        return sq, n

    def init(params: Tensors) -> Dict[str, Tensors]:
        def one(p: torch.Tensor) -> Tensors:
            f32 = dict(dtype=torch.float32, device=p.device)
            if _factored(p):
                return {"vr": torch.zeros(p.shape[:-1], **f32),  # row stats
                        "vc": torch.zeros(p.shape[:-2] + p.shape[-1:], **f32)}
            return {"v": torch.zeros(p.shape, **f32)}

        return {k: one(p) for k, p in params.items()}

    def update(grads: Tensors, state: Dict[str, Tensors], params: Tensors,
               step: int) -> Tuple[Tensors, Dict[str, Tensors]]:
        lr_t = lr_fn(step)
        d = decay
        unclipped: Tensors = {}
        new_state: Dict[str, Tensors] = {}
        for k, p in params.items():
            g = grads[k].float()
            st = state[k]
            g2 = g * g + eps
            if _factored(p):
                vr = d * st["vr"] + (1 - d) * mean(g2, k, -1, -1)
                vc = d * st["vc"] + (1 - d) * mean(g2, k, -2, -2)
                denom = torch.clamp(mean(vr, k, -1, -2)[..., None], min=eps)
                pre = (vr[..., None] / denom[..., None]) * vc[..., None, :]
                unclipped[k] = g * torch.rsqrt(torch.clamp(pre, min=eps))
                new_state[k] = {"vr": vr, "vc": vc}
            else:
                v = d * st["v"] + (1 - d) * g2
                unclipped[k] = g * torch.rsqrt(torch.clamp(v, min=eps))
                new_state[k] = {"v": v}
        updates: Tensors = {}
        for names in grouped(params).values():
            # update clipping (RMS <= threshold) over the group
            parts = [whole(k, unclipped[k]) for k in names]
            sq = torch.stack([p for p, _ in parts]).sum()
            rms = torch.sqrt(sq / sum(n for _, n in parts) + eps)
            for k in names:
                u = unclipped[k] / torch.clamp(rms / clip_threshold, min=1.0)
                if weight_decay:
                    u = u + weight_decay * params[k].float()
                updates[k] = (-lr_t * u).to(params[k].dtype)
        return updates, new_state

    return Optimizer(init=init, update=update)
