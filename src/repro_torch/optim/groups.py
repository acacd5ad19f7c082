"""Which parameters share a per-tensor statistic.

The reference keeps each kind of layer parameter as one leaf stacked over
its layers (``layers/ssm/w_x`` is ``[layers, 1, d, d_inner]``), so a
statistic it takes "per tensor" (the EF-int8 compressor's scale,
Adafactor's update-clipping RMS) spans every layer of that kind. The port
keeps one tensor a layer (``layers.3.ssm.w_x``); :func:`stacked_leaf` names
the reference leaf a port parameter belongs to, and the optimizers take
their per-tensor statistics over each such group (:func:`grouped`).
"""

from __future__ import annotations

import re
from typing import Dict, Iterable, List

_LAYER = re.compile(r"^([A-Za-z_]+)\.\d+\.")


def stacked_leaf(name: str) -> str:
    """``layers.3.ssm.w_x`` → ``layers.*.ssm.w_x`` (likewise for
    ``ssm_layers``, ``tail_layers``, ``enc_layers``, ``dec_layers``); a name
    without a layer index is its own leaf."""
    return _LAYER.sub(r"\1.*.", name, count=1)


def grouped(names: Iterable[str]) -> Dict[str, List[str]]:
    """The names by reference leaf, in first-seen order."""
    out: Dict[str, List[str]] = {}
    for k in names:
        out.setdefault(stacked_leaf(k), []).append(k)
    return out
