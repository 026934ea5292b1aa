"""Checkpoint manager: per-leaf .npy files, atomic rename, retention, async.

The JAX package's ``ckpt/manager.py`` over nested containers of tensors,
in its on-disk format: one ``leaf_XXXXX.npy`` per leaf in the reference's
flatten order (:mod:`repro_torch.tree`: dict keys sorted, NamedTuples in
field order) and a ``manifest.json``, so a directory written by either
package restores in the other.

Fault-tolerance contract (DESIGN.md §5):

- **atomic**: a checkpoint directory appears only fully written (write to
  ``step_XXXX.tmp``, fsync, rename) — a killed writer never leaves a
  half-checkpoint that restore could pick up.
- **retention**: keep the newest ``keep`` checkpoints, delete older ones.
- **async**: ``save(..., blocking=False)`` snapshots to host memory (a
  copy of every leaf) and writes on a background thread, so the train step
  doesn't block on disk — the mitigation BigRoots suggests when
  ``ckpt_time`` shows up as a straggler root cause.
- **restore**: restore returns host numpy leaves, or tensors on the
  ``device`` the caller names.

Leaves are stored in flatten order against a caller-supplied template tree,
so any tree (dicts, NamedTuples) round-trips without pickling its
structure.  A template's leaves need only a ``shape`` (tensors, numpy
arrays, ``meta`` tensors).
"""
from __future__ import annotations

import json
import os
import shutil
import threading
import time
from typing import Any

import numpy as np
import torch

from .. import tree as trees


def _host(leaf) -> np.ndarray:
    """A host copy of a leaf (the caller may change the original after an
    async save returns)."""
    if isinstance(leaf, torch.Tensor):
        return leaf.detach().to("cpu", copy=True).numpy()
    return np.array(leaf)


class CheckpointManager:
    def __init__(self, directory: str, keep: int = 3) -> None:
        self.directory = directory
        self.keep = keep
        os.makedirs(directory, exist_ok=True)
        self._thread: threading.Thread | None = None
        self._last_error: BaseException | None = None

    # -- paths ------------------------------------------------------------
    def _step_dir(self, step: int) -> str:
        return os.path.join(self.directory, f"step_{step:08d}")

    def steps(self) -> list[int]:
        out = []
        for name in os.listdir(self.directory):
            if name.startswith("step_") and not name.endswith(".tmp"):
                try:
                    out.append(int(name.split("_")[1]))
                except (IndexError, ValueError):
                    continue
        return sorted(out)

    def latest_step(self) -> int | None:
        steps = self.steps()
        return steps[-1] if steps else None

    # -- save ---------------------------------------------------------------
    def save(self, step: int, tree: Any, blocking: bool = True) -> str:
        """Save a pytree. With blocking=False, returns immediately after the
        host snapshot; the previous async save is joined first."""
        self.wait()
        host_leaves = [_host(x) for x in trees.leaves(tree)]
        if blocking:
            return self._write(step, host_leaves)
        self._thread = threading.Thread(
            target=self._write_guarded, args=(step, host_leaves), daemon=True
        )
        self._thread.start()
        return self._step_dir(step)

    def _write_guarded(self, step: int, host_leaves: list[np.ndarray]) -> None:
        try:
            self._write(step, host_leaves)
        except BaseException as e:  # surfaced by wait()
            self._last_error = e

    def _write(self, step: int, host_leaves: list[np.ndarray]) -> str:
        final = self._step_dir(step)
        tmp = final + ".tmp"
        if os.path.exists(tmp):
            shutil.rmtree(tmp)
        os.makedirs(tmp)
        manifest = {"step": step, "time": time.time(), "leaves": []}
        for i, leaf in enumerate(host_leaves):
            np.save(os.path.join(tmp, f"leaf_{i:05d}.npy"), leaf)
            manifest["leaves"].append(
                {"shape": list(leaf.shape), "dtype": str(leaf.dtype)}
            )
        with open(os.path.join(tmp, "manifest.json"), "w") as f:
            json.dump(manifest, f)
            f.flush()
            os.fsync(f.fileno())
        if os.path.exists(final):
            shutil.rmtree(final)
        os.rename(tmp, final)
        self._retain()
        return final

    def wait(self) -> None:
        """Join an in-flight async save; re-raise its error if it failed."""
        if self._thread is not None:
            self._thread.join()
            self._thread = None
        if self._last_error is not None:
            err, self._last_error = self._last_error, None
            raise err

    def _retain(self) -> None:
        steps = self.steps()
        for s in steps[: -self.keep] if self.keep > 0 else []:
            shutil.rmtree(self._step_dir(s), ignore_errors=True)

    # -- restore ----------------------------------------------------------
    def restore(self, template: Any, step: int | None = None,
                device=None) -> Any:
        """Fill ``template``'s structure with saved leaves (flatten order):
        numpy arrays, or with ``device`` tensors there."""
        self.wait()
        if step is None:
            step = self.latest_step()
        if step is None:
            raise FileNotFoundError(f"no checkpoints in {self.directory}")
        d = self._step_dir(step)
        with open(os.path.join(d, "manifest.json")) as f:
            manifest = json.load(f)
        t_leaves = trees.leaves(template)
        if len(manifest["leaves"]) != len(t_leaves):
            raise ValueError(
                f"checkpoint has {len(manifest['leaves'])} leaves, template "
                f"has {len(t_leaves)}"
            )
        loaded = []
        for i, (t_leaf, meta) in enumerate(zip(t_leaves, manifest["leaves"])):
            arr = np.load(os.path.join(d, f"leaf_{i:05d}.npy"))
            want = tuple(getattr(t_leaf, "shape", arr.shape))
            if tuple(arr.shape) != want:
                raise ValueError(
                    f"leaf {i}: checkpoint shape {arr.shape} != template {want}"
                )
            loaded.append(arr)
        if device is not None:
            loaded = [torch.from_numpy(a).to(device) for a in loaded]
        return trees.unflatten(template, loaded)
