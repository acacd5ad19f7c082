"""Resolve the device a session runs on; a missing card is an error."""

from __future__ import annotations

from typing import Union

import torch

DeviceLike = Union[str, torch.device]


def resolve_device(device: DeviceLike) -> torch.device:
    """``"cuda"``/``"cuda:N"``/``"cpu"`` (or a ``torch.device``) → device.

    Raises ``RuntimeError`` naming CUDA when a CUDA device is asked for and
    this process sees none: the port never falls back to the CPU silently.
    """
    dev = torch.device(device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                f"device={str(device)!r} asks for CUDA, but torch.cuda."
                f"is_available() is False in this process; pass "
                f"device='cpu' to run the plain PyTorch stages on the CPU"
            )
        if dev.index is None:
            dev = torch.device("cuda", torch.cuda.current_device())
    elif dev.type != "cpu":
        raise ValueError(
            f"device={str(device)!r}: the port runs on 'cuda' or 'cpu'"
        )
    return dev
