"""Checkpoint manager, the counterpart of ``repro.ckpt.manager``: keep-k
garbage collection, periodic saves, a forced save at preemption.

Saves run on a background thread. Before it starts, the save takes host
copies of every tensor (the only synchronous part), so a step that runs
meanwhile, and updates the parameters in place, cannot change what is
written.

Under a mesh (``pctx``) that synchronous part is the reference's
"device→host gather": every rank gathers each leaf whole by its spec on
the main thread (:func:`~repro_torch.ckpt.checkpoint.logical_leaves`), and
the mesh's first rank alone writes the logical tree, in its background
thread, and collects old checkpoints; no collective runs off the main
thread. :meth:`CheckpointManager.wait` is where the ranks agree: a write
that failed on the writing rank raises on every rank there, so no rank
trains on, or waits in a collective, alone.
"""

from __future__ import annotations

import shutil
import threading
from pathlib import Path
from typing import Any, Optional

import torch.distributed as dist

from repro_torch.ckpt.checkpoint import (
    latest_step,
    logical_leaves,
    restore_checkpoint,
    save_checkpoint,
)
from repro_torch.device import DeviceLike
from repro_torch.parallel import collectives as C
from repro_torch.parallel.ctx import ParallelCtx


class CheckpointManager:
    def __init__(self, directory: str | Path, *, keep: int = 3,
                 save_every: int = 100, async_save: bool = True,
                 pctx: Optional[ParallelCtx] = None):
        self.dir = Path(directory)
        self.keep = keep
        self.save_every = save_every
        self.async_save = async_save
        self.pctx = pctx if pctx is not None and pctx.mesh is not None else None
        axes = tuple(self.pctx.mesh.mesh_dim_names) if self.pctx is not None else ()
        self._group = self.pctx.group(axes) if self.pctx is not None else None
        self.writer = self.pctx is None or self.pctx.index(axes) == 0
        self._thread: Optional[threading.Thread] = None
        self._last_error: Optional[BaseException] = None

    # ------------------------------------------------------------ saving ----
    def maybe_save(self, step: int, tree: Any, *, force: bool = False) -> bool:
        if not force and (step == 0 or step % self.save_every):
            return False
        self.wait()  # one in-flight save at a time
        # gather and copy to the host synchronously (cheap vs a step), write async
        host_tree = logical_leaves(tree, self.pctx, keep=self.writer)

        def work() -> None:
            try:
                save_checkpoint(self.dir, step, host_tree)
                self._gc()
            except BaseException as e:  # surfaced on next wait()
                self._last_error = e

        if self.writer and self.async_save:
            self._thread = threading.Thread(target=work, daemon=True)
            self._thread.start()
        elif self.writer:
            work()
        if not self.async_save:
            self.wait()  # every rank: the write's error raises on each
        return True

    def wait(self) -> None:
        """Join the write in flight and raise its error; under a mesh every
        rank calls it at the same point and raises if the write failed."""
        if self._thread is not None:
            self._thread.join()
            self._thread = None
        err, self._last_error = self._last_error, None
        if C.any_rank(err is not None, self._group) and err is None:
            err = RuntimeError(f"the checkpoint write under {self.dir} failed on the "
                               f"mesh's writing rank")
        if err is not None:
            raise err

    def _gc(self) -> None:
        steps = sorted(
            int(p.name.split("_")[1])
            for p in self.dir.iterdir()
            if p.name.startswith("step_")
        )
        for s in steps[: -self.keep]:
            shutil.rmtree(self.dir / f"step_{s:08d}", ignore_errors=True)

    # ----------------------------------------------------------- restore ----
    def latest_step(self) -> Optional[int]:
        """The newest complete checkpoint's step; under a mesh, read after a
        barrier, so that every rank sees the same one."""
        if self._group is not None:
            dist.barrier(group=self._group)
        return latest_step(self.dir)

    def restore(self, target_tree: Any, *, device: Optional[DeviceLike] = None):
        return restore_checkpoint(self.dir, target_tree, device=device, pctx=self.pctx)
