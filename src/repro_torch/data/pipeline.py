"""Host→device input pipeline with overlap-tuned chunked staging, the
counterpart of ``repro.data.pipeline``.

The paper's heuristic decides into how many chunks each global batch is
split for staging (``tune_prefetch_chunks``): the copy of chunk k+1
overlaps the work of chunk k on the host link, until per-transfer overhead
wins. The reference issues one ``jax.device_put`` a chunk; on a CUDA device
this pipeline

1. copies each array of the batch into a pinned host tensor (PyTorch's
   caching host allocator records each copy that reads it and does not
   hand it out again before that copy is done),
2. issues one ``non_blocking`` copy a chunk on a side ``torch.cuda.Stream``
   (the worker thread's), and
3. records an event after the last chunk, on which the consumer's stream
   waits when it takes the batch; ``record_stream`` then marks each device
   tensor as used on the consumer's stream, so the caching allocator does
   not hand its memory out again while the step that reads it may still be
   running.

A background thread keeps ``depth`` batches in flight, in step order from
``start_step``; with the stateless ``SyntheticLMDataset`` that makes a
restart resume exactly. An error in the thread is raised by the next
``next()``. On ``device="cpu"`` there is no stream and no
pinning: the batch's arrays become CPU tensors.
"""

from __future__ import annotations

import queue
import threading
from typing import Any, Callable, Dict, Iterator, Optional, Tuple

import numpy as np
import torch

from repro_torch.core.autotune.overlap import tune_prefetch_chunks
from repro_torch.device import DeviceLike, resolve_device

Batch = Dict[str, torch.Tensor]


class PrefetchPipeline:
    def __init__(
        self,
        batch_fn: Callable[[int], Dict[str, np.ndarray]],
        *,
        start_step: int = 0,
        depth: int = 2,
        num_chunks: Optional[int] = None,
        step_compute_s: float = 0.1,
        host_link_Bps: float = 10e9,
        device: DeviceLike = "cuda",
    ):
        self.batch_fn = batch_fn
        self.depth = depth
        self.device = resolve_device(device)
        self._step = start_step
        self._q: "queue.Queue[Any]" = queue.Queue(maxsize=depth)
        self._stop = threading.Event()
        probe = batch_fn(start_step)
        batch_bytes = float(sum(a.nbytes for a in probe.values()))
        if num_chunks is None:
            num_chunks, _ = tune_prefetch_chunks(
                batch_bytes=batch_bytes,
                host_link_Bps=host_link_Bps,
                step_compute_s=step_compute_s,
            )
        self.num_chunks = max(1, num_chunks)
        self._stream = (torch.cuda.Stream(device=self.device)
                        if self.device.type == "cuda" else None)
        self._thread = threading.Thread(target=self._worker, daemon=True)
        self._thread.start()

    # ------------------------------------------------------------- worker ---
    def _stage(self, batch: Dict[str, np.ndarray]) -> Tuple[Batch, Optional[torch.cuda.Event]]:
        """Chunked copies: dim 0 of every array in ``num_chunks`` transfers
        on the side stream, and the event recorded after the last one."""
        if self._stream is None:
            return {k: torch.from_numpy(np.ascontiguousarray(a)) for k, a in batch.items()}, None
        out: Batch = {}
        with torch.cuda.stream(self._stream):
            for k, arr in batch.items():
                host = torch.from_numpy(np.ascontiguousarray(arr)).pin_memory()
                dst = torch.empty(host.shape, dtype=host.dtype, device=self.device)
                n = host.shape[0]
                bounds = np.linspace(0, n, min(self.num_chunks, n) + 1, dtype=int)
                for lo, hi in zip(bounds[:-1], bounds[1:]):
                    # each copy overlaps the previous chunk's transfer
                    dst[lo:hi].copy_(host[lo:hi], non_blocking=True)
                out[k] = dst
            done = torch.cuda.Event()
            done.record(self._stream)
        return out, done

    def _worker(self) -> None:
        step = self._step
        while not self._stop.is_set():
            try:
                item: Any = (step, *self._stage(self.batch_fn(step)))
            except BaseException as e:  # raised in the consumer by __next__
                item = e
            while not self._stop.is_set():
                try:
                    self._q.put(item, timeout=0.1)
                    break
                except queue.Full:
                    continue
            if isinstance(item, BaseException):
                return
            step += 1

    # ------------------------------------------------------------- public ---
    def __iter__(self) -> Iterator[Tuple[int, Batch]]:
        return self

    def __next__(self) -> Tuple[int, Batch]:
        item = self._q.get()
        if isinstance(item, BaseException):
            raise item
        step, batch, done = item
        if done is not None:
            consumer = torch.cuda.current_stream(self.device)
            consumer.wait_event(done)
            for t in batch.values():
                t.record_stream(consumer)
        return step, batch

    def close(self) -> None:
        self._stop.set()
        try:
            while True:
                self._q.get_nowait()
        except queue.Empty:
            pass
        self._thread.join(timeout=2)
