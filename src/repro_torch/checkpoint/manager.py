"""Checkpoint lifecycle: retention, auto-resume, async save (counterpart
of ``repro/checkpoint/manager.py``).

  * ``maybe_save(step, tree)``: periodic saves, optionally on a
    background thread so that the card never waits on the disk;
  * ``restore_latest(target)``: resume after a restart; skips torn
    directories (no manifest), restores in place and returns (step, tree),
    or (0, target) when there is none;
  * retention: keep the newest ``max_to_keep`` checkpoints.

A tree of ``DTensor``s (training over a mesh) is saved by every rank of
its mesh: each gathers the leaves, the rank at the mesh's origin writes
(synchronously) and the others wait at a barrier, so that every rank
then sees the new directory.
"""

from __future__ import annotations

import concurrent.futures
import os
import re
import shutil
from typing import Any, Optional, Tuple

from repro_torch.checkpoint.checkpoint import (checkpoint_step, flatten_with_paths, host_array, is_writer,
                                               mesh_barrier, mesh_of, restore_checkpoint, write_leaves)

__all__ = ["CheckpointManager"]

_STEP_RE = re.compile(r"^step_(\d+)$")


class CheckpointManager:
    def __init__(self, directory: str, interval: int = 100, max_to_keep: int = 3, use_async: bool = False):
        self.directory = directory
        self.interval = interval
        self.max_to_keep = max_to_keep
        self._pool = concurrent.futures.ThreadPoolExecutor(max_workers=1) if use_async else None
        self._pending: Optional[concurrent.futures.Future] = None
        os.makedirs(directory, exist_ok=True)

    # -- enumeration -------------------------------------------------------

    def all_steps(self):
        steps = []
        for name in os.listdir(self.directory):
            m = _STEP_RE.match(name)
            if m and os.path.exists(os.path.join(self.directory, name, "manifest.json")):
                steps.append(int(m.group(1)))
        return sorted(steps)

    def latest_path(self) -> Optional[str]:
        steps = self.all_steps()
        return os.path.join(self.directory, f"step_{steps[-1]:010d}") if steps else None

    # -- save --------------------------------------------------------------

    def should_save(self, step: int) -> bool:
        return step > 0 and step % self.interval == 0

    def save(self, step: int, tree: Any):
        # copy every leaf to the host BEFORE handing it to the async thread:
        # the next step updates the same storage in place
        leaves = flatten_with_paths(tree)
        mesh = mesh_of(leaves.values())
        if mesh is not None:
            writer = is_writer(mesh)
            host_tree = {}
            for k, v in leaves.items():     # every rank takes part in each gather; the writer keeps them
                arr = host_array(v, copy=True)
                if writer:
                    host_tree[k] = arr
            if writer:
                self.wait()
                self._save_sync(step, host_tree)
            mesh_barrier(mesh)
            return
        host_tree = {k: host_array(v, copy=True) for k, v in leaves.items()}
        if self._pool is not None:
            self.wait()
            self._pending = self._pool.submit(self._save_sync, step, host_tree)
        else:
            self._save_sync(step, host_tree)

    def _save_sync(self, step: int, leaves: dict):
        write_leaves(self.directory, step, leaves)
        self._gc()

    def maybe_save(self, step: int, tree: Any) -> bool:
        if self.should_save(step):
            self.save(step, tree)
            return True
        return False

    def wait(self):
        if self._pending is not None:
            self._pending.result()
            self._pending = None

    def close(self):
        """Finish a pending save and stop the background thread."""
        self.wait()
        if self._pool is not None:
            self._pool.shutdown()

    def _gc(self):
        steps = self.all_steps()
        for s in steps[: -self.max_to_keep]:
            shutil.rmtree(os.path.join(self.directory, f"step_{s:010d}"), ignore_errors=True)

    # -- restore -----------------------------------------------------------

    def restore_latest(self, target: Any, shardings: Any = None) -> Tuple[int, Any]:
        path = self.latest_path()
        if path is None:
            return 0, target
        return checkpoint_step(path), restore_checkpoint(path, target, shardings)
