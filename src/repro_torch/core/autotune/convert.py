"""Carry a stream heuristic fitted by the JAX package across to the port.

The solver has no weights; its state is the fitted Eq. 4–7 heuristic that
prices every dispatch's chunk count. :func:`heuristic_from_reference` reads a
reference ``StreamHeuristic`` (or ``BatchedStreamHeuristic``) by attribute
and rebuilds the port's own, so both packages pick the same chunk count for
every batch. It never imports the reference package: any object with the
same attribute names converts.
"""

from __future__ import annotations

from typing import Any, Optional, Union

import numpy as np

from repro_torch.core.autotune.heuristic import BatchedStreamHeuristic, StreamHeuristic
from repro_torch.core.autotune.linreg import LinearModel


def _popt(a: Any) -> Optional[np.ndarray]:
    return None if a is None else np.array(a, dtype=np.float64, copy=True)


def heuristic_from_reference(
    obj: Any,
) -> Union[StreamHeuristic, BatchedStreamHeuristic]:
    """The port's heuristic with ``obj``'s fitted coefficients.

    Reads ``sum_model.coef``/``sum_model.intercept``, ``popt_small``,
    ``popt_big``, ``split_size`` and ``candidates`` (plus ``metrics`` and
    ``provenance`` where present). A batched heuristic (one with a ``base``)
    converts its base and is wrapped again.
    """
    if hasattr(obj, "base") and not hasattr(obj, "sum_model"):
        base = heuristic_from_reference(obj.base)
        assert isinstance(base, StreamHeuristic)
        return BatchedStreamHeuristic(base=base)
    missing = [
        name
        for name in ("sum_model", "popt_small", "popt_big", "split_size", "candidates")
        if not hasattr(obj, name)
    ]
    if missing:
        raise TypeError(
            f"{type(obj).__name__} is not a fitted stream heuristic: it has "
            f"no {', '.join(missing)}"
        )
    sum_model = LinearModel(
        coef=np.array(obj.sum_model.coef, dtype=np.float64, copy=True),
        intercept=float(obj.sum_model.intercept),
    )
    return StreamHeuristic(
        sum_model=sum_model,
        popt_small=_popt(obj.popt_small),
        popt_big=_popt(obj.popt_big),
        split_size=float(obj.split_size),
        candidates=tuple(int(k) for k in obj.candidates),
        metrics={k: dict(v) for k, v in dict(getattr(obj, "metrics", {})).items()},
        provenance={
            **dict(getattr(obj, "provenance", {})),
            "converted_from": type(obj).__module__,
        },
    )
