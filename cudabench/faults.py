"""Faults planted in the program's timed path, to show that the
comparison that decides ``correct`` catches each fault a cell can have.

The benchmark's own runs plant nothing: ``control.py`` and the tests do,
by patching the program's functions while a run executes. Each fault is
named as the contract names it:

- ``unchanged``: a step that returns its state unchanged (the solver hands
  back its right-hand side; the train step applies no update);
- ``half_batch``: half of the batch left out (the solver's answers for the
  second half of the systems, or of the unknowns, are zeros; the loss is
  the mean over the first half of the rows);
- ``altered``: an answer altered where it is produced (one unknown of each
  solution off by 1e-3; each loss off by one part in a hundred).

The exchange between chips has no fault here: every cell runs on one chip.
"""

from __future__ import annotations

import contextlib
from typing import Any, Callable, Dict, Iterator

import numpy as np

FAULTS = ("unchanged", "half_batch", "altered")


def _no_update(state: Any, grads: Dict[str, Any], *args: Any, **kwargs: Any) -> Any:
    """The train step's optimizer stage, returning its state unchanged."""
    import torch

    return state, torch.zeros(())


def _solver(name: str) -> Dict[str, Callable[..., Any]]:
    from repro_torch.core.tridiag.api import TridiagSession

    def wrap(orig: Callable[..., Any]) -> Callable[..., Any]:
        def verb(self: Any, dl: Any, d: Any, du: Any, b: Any) -> np.ndarray:
            if name == "unchanged":
                return np.array(b, copy=True)
            x = np.array(orig(self, dl, d, du, b), copy=True)
            if name == "half_batch":
                rows = x.reshape(-1, x.shape[-1]) if x.ndim > 1 else x.reshape(1, -1)
                if x.ndim > 1:
                    rows[rows.shape[0] // 2:] = 0.0
                else:
                    rows[:, rows.shape[1] // 2:] = 0.0
            else:
                x[..., x.shape[-1] // 2] += 1e-3
            return x
        return verb

    return {"solve": wrap(TridiagSession.solve),
            "solve_batched": wrap(TridiagSession.solve_batched)}


@contextlib.contextmanager
def planted(kind: str, name: str) -> Iterator[None]:
    """Within the block, the program of the cells of driver ``kind`` has
    fault ``name``."""
    if name not in FAULTS:
        raise ValueError(f"fault {name!r}: one of {FAULTS}")
    if kind == "tridiag_session":
        from repro_torch.core.tridiag import api

        target: Any = api.TridiagSession
        patches = _solver(name)
    elif kind == "lm_train":
        from repro_torch.train import step

        target = step
        orig_ce = step.cross_entropy
        if name == "unchanged":
            patches = {"apply_gradients": _no_update}
        elif name == "half_batch":
            patches = {"cross_entropy": lambda logits, labels: orig_ce(
                logits[: logits.shape[0] // 2], labels[: labels.shape[0] // 2])}
        else:
            patches = {"cross_entropy": lambda logits, labels: orig_ce(logits, labels) * 1.01}
    else:
        raise ValueError(f"no faults for driver kind {kind!r}")
    saved = {k: getattr(target, k) for k in patches}
    try:
        for k, fn in patches.items():
            setattr(target, k, fn)
        yield
    finally:
        for k, fn in saved.items():
            setattr(target, k, fn)
