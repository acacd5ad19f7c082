"""Error-feedback int8 gradient compression, the counterpart of
``repro.optim.grad_compress``.

Gradients are quantized to int8 with a per-tensor scale; the quantization
residual is carried in an fp32 error-feedback buffer and added back next
step (Karimireddy et al., 2019). On one device nothing crosses a link: the
step sees the quantize-dequantize round trip, as the reference's does. A
"tensor" is the reference's stacked leaf
(:func:`~repro_torch.optim.groups.stacked_leaf`): the port's parameters of
one leaf share one scale.
"""

from __future__ import annotations

from typing import Callable, Dict, NamedTuple, Tuple

import torch

from repro_torch.optim.groups import grouped

Tensors = Dict[str, torch.Tensor]


class EFState(NamedTuple):
    error: Tensors  # fp32 residuals, keyed like the gradients


def ef_int8_compressor() -> Tuple[
        Callable[[Tensors], EFState], Callable[[Tensors, EFState], Tuple[Tensors, EFState]]]:
    def init(grads_shape: Tensors) -> EFState:
        return EFState(error={k: torch.zeros(g.shape, dtype=torch.float32, device=g.device)
                              for k, g in grads_shape.items()})

    def apply(grads: Tensors, state: EFState) -> Tuple[Tensors, EFState]:
        """Quantize and dequantize with error feedback."""
        summed = {k: g.float() + state.error[k] for k, g in grads.items()}
        deq: Tensors = {}
        err: Tensors = {}
        for names in grouped(summed).values():
            amax = torch.stack([summed[k].abs().max() for k in names]).max()
            scale = torch.clamp(amax, min=1e-12) / 127.0
            for k in names:
                q = torch.clamp(torch.round(summed[k] / scale), -127, 127).to(torch.int8)
                deq[k] = q.float() * scale
                err[k] = summed[k] - deq[k]  # new error
        return deq, EFState(error=err)

    return init, apply
