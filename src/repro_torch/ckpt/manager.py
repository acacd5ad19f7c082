"""Checkpoint manager, the counterpart of ``repro.ckpt.manager``: keep-k
garbage collection, periodic saves, a forced save at preemption.

Saves run on a background thread. Before it starts, the save takes host
copies of every tensor (the only synchronous part), so a step that runs
meanwhile, and updates the parameters in place, cannot change what is
written.
"""

from __future__ import annotations

import shutil
import threading
from pathlib import Path
from typing import Any, Optional

from repro_torch.ckpt.checkpoint import (
    flatten_with_names,
    host_copy,
    latest_step,
    restore_checkpoint,
    save_checkpoint,
)
from repro_torch.device import DeviceLike


class CheckpointManager:
    def __init__(self, directory: str | Path, *, keep: int = 3,
                 save_every: int = 100, async_save: bool = True):
        self.dir = Path(directory)
        self.keep = keep
        self.save_every = save_every
        self.async_save = async_save
        self._thread: Optional[threading.Thread] = None
        self._last_error: Optional[BaseException] = None

    # ------------------------------------------------------------ saving ----
    def maybe_save(self, step: int, tree: Any, *, force: bool = False) -> bool:
        if not force and (step == 0 or step % self.save_every):
            return False
        self.wait()  # one in-flight save at a time
        # copy to the host synchronously (cheap vs a step), write async
        host_tree = {k: host_copy(v) for k, v in flatten_with_names(tree).items()}

        def work() -> None:
            try:
                save_checkpoint(self.dir, step, host_tree)
                self._gc()
            except BaseException as e:  # surfaced on next wait()
                self._last_error = e

        if self.async_save:
            self._thread = threading.Thread(target=work, daemon=True)
            self._thread.start()
        else:
            work()
            if self._last_error:
                err, self._last_error = self._last_error, None
                raise err
        return True

    def wait(self) -> None:
        if self._thread is not None:
            self._thread.join()
            self._thread = None
        if self._last_error is not None:
            err, self._last_error = self._last_error, None
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
        return latest_step(self.dir)

    def restore(self, target_tree: Any, *, device: Optional[DeviceLike] = None):
        return restore_checkpoint(self.dir, target_tree, device=device)
