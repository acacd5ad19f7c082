"""Error-feedback int8 gradient compression, the counterpart of
``repro.optim.grad_compress``.

Gradients are quantized to int8 with a per-tensor scale; the quantization
residual is carried in an fp32 error-feedback buffer and added back next
step (Karimireddy et al., 2019). On one device nothing crosses a link: the
step sees the quantize-dequantize round trip, as the reference's does. A
"tensor" is the reference's stacked leaf
(:func:`~repro_torch.optim.groups.stacked_leaf`): the port's parameters of
one leaf share one scale.

Under a mesh (``pctx`` and the parameters' ``specs``) each rank holds its
slice of every reduced gradient and of its error buffer. The scale is the
largest magnitude over the whole logical leaf, as the reference takes it:
each leaf's local largest magnitude is all-reduced with MAX over the axes
its parameters are split on (one collective for each set of axes), so
every rank quantizes its slice with the scale the unsharded step would use.
"""

from __future__ import annotations

from typing import Callable, Dict, List, Mapping, NamedTuple, Optional, Tuple

import torch
import torch.distributed as dist

from repro_torch.optim.groups import grouped
from repro_torch.parallel import collectives as C
from repro_torch.parallel.ctx import ParallelCtx
from repro_torch.parallel.sharding import split_axes

Tensors = Dict[str, torch.Tensor]


class EFState(NamedTuple):
    error: Tensors  # fp32 residuals, keyed like the gradients


def ef_int8_compressor(
    *, pctx: Optional[ParallelCtx] = None, specs: Optional[Mapping[str, tuple]] = None,
) -> Tuple[Callable[[Tensors], EFState], Callable[[Tensors, EFState], Tuple[Tensors, EFState]]]:
    sharded = pctx is not None and pctx.mesh is not None and specs is not None

    def init(grads_shape: Tensors) -> EFState:
        return EFState(error={k: torch.zeros(g.shape, dtype=torch.float32, device=g.device)
                              for k, g in grads_shape.items()})

    def whole_amax(amax: Dict[str, torch.Tensor],
                   groups: Dict[str, List[str]]) -> Dict[str, torch.Tensor]:
        """Each leaf's largest magnitude over the ranks holding its slices:
        one MAX all-reduce for each set of axes the leaves are split on."""
        assert pctx is not None and specs is not None
        names = tuple(pctx.mesh.mesh_dim_names)
        by_axes: Dict[Tuple[str, ...], List[str]] = {}
        for leaf, members in groups.items():
            axes = {a for k in members for a in split_axes(specs[k])}
            by_axes.setdefault(tuple(sorted(axes, key=names.index)), []).append(leaf)
        out = dict(amax)
        for axes, leaves in by_axes.items():
            if not axes:
                continue
            stacked = C.all_reduce_(torch.stack([amax[leaf] for leaf in leaves]),
                                    pctx.group(axes), dist.ReduceOp.MAX)
            out.update(zip(leaves, stacked.unbind(0)))
        return out

    def apply(grads: Tensors, state: EFState) -> Tuple[Tensors, EFState]:
        """Quantize and dequantize with error feedback."""
        summed = {k: g.float() + state.error[k] for k, g in grads.items()}
        groups = grouped(summed)
        amax = {leaf: torch.stack([summed[k].abs().max() for k in members]).max()
                for leaf, members in groups.items()}
        if sharded:
            amax = whole_amax(amax, groups)
        deq: Tensors = {}
        err: Tensors = {}
        for leaf, members in groups.items():
            scale = torch.clamp(amax[leaf], min=1e-12) / 127.0
            for k in members:
                q = torch.clamp(torch.round(summed[k] / scale), -127, 127).to(torch.int8)
                deq[k] = q.float() * scale
                err[k] = summed[k] - deq[k]  # new error
        return deq, EFState(error=err)

    return init, apply
