"""Shared helpers for the port's CUDA kernels and their wrappers.

Every wrapper follows one contract: given CPU tensors it runs the kernel's
plain PyTorch version; given CUDA tensors it launches the hand-written
kernel (built from ``repro_torch/csrc`` by :mod:`repro_torch.kernels.build`)
on the current stream, or raises. Nothing falls back from the card to the
plain version. Each wrapper counts its launches in a :class:`LaunchCounter`
so a run can show that the main path went through the kernel.
"""

from __future__ import annotations

import contextlib
import ctypes
import threading
from typing import Dict, Iterator, Optional, Sequence, Tuple

import numpy as np
import torch

from repro_torch.kernels import build
from repro_torch.roofline import counting

#: dtypes every kernel is instantiated for, with the C symbol suffix.
KERNEL_DTYPES: Dict[torch.dtype, str] = {torch.float32: "f32", torch.float64: "f64"}


def cdiv(a: int, b: int) -> int:
    return -(-a // b)


def round_up(a: int, b: int) -> int:
    return cdiv(a, b) * b


def assert_allclose_by_dtype(actual: object, desired: object, dtype: object) -> None:
    """Tolerance ladder used by every kernel test (oracle comparisons)."""
    if isinstance(dtype, torch.dtype):
        dtype = torch.empty((), dtype=dtype).numpy().dtype
    tol = {
        "float64": 1e-12,
        "float32": 1e-5,
        "bfloat16": 2e-2,
    }[np.dtype(dtype).name]

    def host(a: object) -> np.ndarray:
        if isinstance(a, torch.Tensor):
            a = a.detach().cpu().numpy()
        return np.asarray(a, np.float64)

    np.testing.assert_allclose(host(actual), host(desired), rtol=tol, atol=tol * 10)


class LaunchCounter:
    """A plain-int count of a wrapper's kernel launches (thread-safe).

    ``count`` is incremented where the wrapper launches its kernel and
    nowhere else, so the plain CPU path and any comparison run outside a
    reset window leave the main path's count unmixed. A CUDA graph capture
    launches nothing: inside :func:`recording` this thread's adds go to the
    capture's tally instead, and each replay of the graph adds that tally to
    ``replayed``, kept apart from ``count``. So a call of the fused executor
    raises ``total`` by one set of launches whether it runs eagerly (a
    cache miss) or replays its CUDA graph (a hit), and ``count`` holds only
    the launches a wrapper made.
    """

    def __init__(self, name: str) -> None:
        self.name = name
        self._lock = threading.Lock()
        self._count = 0
        self._replayed = 0

    @property
    def count(self) -> int:
        with self._lock:
            return self._count

    @property
    def replayed(self) -> int:
        with self._lock:
            return self._replayed

    @property
    def total(self) -> int:
        with self._lock:
            return self._count + self._replayed

    def add(self, n: int = 1) -> None:
        tally = getattr(_RECORDING, "tally", None)
        if tally is not None:
            tally[self] = tally.get(self, 0) + n
            return
        with self._lock:
            self._count += n

    def add_replayed(self, n: int) -> None:
        with self._lock:
            self._replayed += n

    def reset(self) -> None:
        with self._lock:
            self._count = 0
            self._replayed = 0


_RECORDING = threading.local()


@contextlib.contextmanager
def recording() -> Iterator[Dict[LaunchCounter, int]]:
    """Within the block, this thread's launches are recorded, not counted:
    the yielded dict gets what each :class:`LaunchCounter` would have been
    given. A CUDA graph capture runs under it; its replays add the tally
    with :meth:`LaunchCounter.add_replayed`."""
    outer = getattr(_RECORDING, "tally", None)
    tally: Dict[LaunchCounter, int] = {}
    _RECORDING.tally = tally
    try:
        yield tally
    finally:
        _RECORDING.tally = outer


def launch_counts() -> Dict[str, int]:
    """Every counter of :data:`repro_torch.kernels.LAUNCH_COUNTERS` now, as
    its ``total``: the launches made by wrappers and by graph replays."""
    from repro_torch.kernels import LAUNCH_COUNTERS

    return {name: c.total for name, c in LAUNCH_COUNTERS.items()}


def launches_since(before: Dict[str, int]) -> Dict[str, int]:
    """The counters that rose since ``before`` (a :func:`launch_counts`
    snapshot), by how much."""
    now = launch_counts()
    return {name: now[name] - before.get(name, 0) for name in now if now[name] != before.get(name, 0)}


def on_cuda(*tensors: torch.Tensor) -> bool:
    """True when every tensor is on one CUDA device, False when all are on
    the CPU; anything else (mixed devices, another device type) raises."""
    devices = {t.device for t in tensors}
    if len(devices) != 1:
        raise ValueError(f"operands span several devices: {sorted(map(str, devices))}")
    (dev,) = devices
    if dev.type == "cuda":
        return True
    if dev.type == "cpu":
        return False
    raise ValueError(f"operands on {dev}: the kernels take CUDA or CPU tensors")


def check_kernel_operands(
    name: str, tensors: Sequence[torch.Tensor], shapes: Sequence[Sequence[int]]
) -> str:
    """Validate CUDA operands for a launch; return the C symbol dtype suffix.

    Every tensor must be contiguous, of one float dtype the kernel is built
    for, and of the shape given beside it.
    """
    dtype = tensors[0].dtype
    if dtype not in KERNEL_DTYPES:
        raise TypeError(
            f"{name}: kernel takes float32 or float64 operands, got {dtype}"
        )
    for i, (t, shape) in enumerate(zip(tensors, shapes)):
        if t.dtype != dtype:
            raise TypeError(f"{name}: operand {i} is {t.dtype}, operand 0 is {dtype}")
        if tuple(t.shape) != tuple(shape):
            raise ValueError(
                f"{name}: operand {i} has shape {tuple(t.shape)}, expected {tuple(shape)}"
            )
        if not t.is_contiguous():
            raise ValueError(f"{name}: operand {i} must be contiguous")
    return KERNEL_DTYPES[dtype]


def current_stream(device: torch.device) -> ctypes.c_void_p:
    return ctypes.c_void_p(torch.cuda.current_stream(device).cuda_stream)


def raise_on_error(name: str, code: int, lib: ctypes.CDLL) -> None:
    """Raise when a C entry returned a non-zero ``cudaGetLastError()``."""
    if code != 0:
        msg = lib.repro_cuda_error_string(code).decode()
        raise RuntimeError(f"{name}: CUDA kernel launch failed: cudaError {code} ({msg})")


def call(
    name: str,
    lib: str,
    symbol: str,
    argtypes: Tuple[type, ...],
    device: torch.device,
    args: Sequence[object],
    stream: Optional[int] = None,
) -> None:
    """Call a kernel's C entry with ``args`` and a stream last; raise when the
    launch failed. Without ``stream`` it runs on the device's current stream
    with the device made current; a caller that passes ``stream`` (a raw
    ``cudaStream_t``) has done both, once for many launches. Under a
    ``repro_torch.roofline.counting`` count, a kernel without a FLOP and
    byte formula raises before it launches."""
    counting.check_launch(name)
    fn = build.entry(lib, symbol, argtypes)
    if stream is None:
        with torch.cuda.device(device):
            code = fn(*args, current_stream(device))
    else:
        code = fn(*args, stream)
    raise_on_error(name, code, build.load(lib))
