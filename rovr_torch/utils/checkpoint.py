"""Checkpoints with restore-by-flag (rovr_tpu/utils/checkpoint.py, PyTorch
port of its Orbax manager).

Layout as in the JAX package: <root>/<experiment>/<timestamp>/checkpoints/
<step>/, one numeric directory per saved step, here holding `state.pt`.
A state is a tree of NamedTuples, dicts, tensors and plain values
(`rl.ROVRState`); it is written with `torch.save` as plain dicts, so it loads
back with `torch.load(weights_only=True)`.

`save` copies the state to the host on the caller's thread and writes it on
a background thread, as Orbax saves asynchronously; `wait` joins the write.
The write goes to a hidden temporary directory that is renamed to the step's
directory only once the file is complete, so a crash never leaves a half
step directory.

Under a mesh (`mesh=`, the state replicated over the data axis) the
mesh's first process alone writes, and every `wait` ends in a barrier over
the whole mesh, so the others wait until the write is on disk; every rank
restores from it, and the restored states agree. A state whose parameters
are split over the model axis (tensor or expert parallelism) names its
split in `shardings` (`parallel.tp.state_shardings(mods)`): it is saved
gathered, whole, and restored split (the JAX manager restores by
`shardings`).
"""

from __future__ import annotations

import os
import shutil
import threading
import time
from typing import Any, Optional

import torch

from rovr_torch.parallel import collectives

CHECKPOINT_FILE = "state.pt"


def run_dir(root: str, experiment: str) -> str:
    """Timestamped run directory <root>/<experiment>/<Y-m-d_H-M-S>, with its
    checkpoints/ subdirectory made."""
    path = os.path.join(root, experiment,
                        time.strftime("%Y-%m-%d_%H-%M-%S", time.localtime()))
    os.makedirs(os.path.join(path, "checkpoints"), exist_ok=True)
    return path


def latest_checkpoint_dir(root: str, experiment: str) -> Optional[str]:
    """The newest run's checkpoints directory that holds a saved step, or
    None: the crash-resume hook of `rl.run_resilient`."""
    base = os.path.join(root, experiment)
    if not os.path.isdir(base):
        return None
    for stamp in sorted(os.listdir(base), reverse=True):
        ck = os.path.join(base, stamp, "checkpoints")
        if os.path.isdir(ck) and any(s.isdigit() for s in os.listdir(ck)):
            return ck
    return None


def _to_plain(tree: Any) -> Any:
    """NamedTuples to dicts, tensors copied to the host (detached)."""
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        return {f: _to_plain(getattr(tree, f)) for f in tree._fields}
    if isinstance(tree, dict):
        return {k: _to_plain(v) for k, v in tree.items()}
    if isinstance(tree, torch.Tensor):
        return tree.detach().to("cpu", copy=True)
    return tree


def _like(template: Any, loaded: Any) -> Any:
    """`loaded` (plain dicts) in the structure of `template`, each tensor on
    its template tensor's device. Where the template holds None (RAFT or pi1
    off in its configuration) the checkpoint's part is dropped; where it
    holds a part the checkpoint lacks, ValueError."""
    if isinstance(template, tuple) and hasattr(template, "_fields"):
        # a field may be absent from a checkpoint written before it existed
        return type(template)(**{f: _like(getattr(template, f), loaded.get(f))
                                 for f in template._fields})
    if template is None:
        return None   # a part the template's configuration does not build
    if loaded is None:
        raise ValueError(f"the checkpoint lacks a part the template holds "
                         f"({type(template).__name__})")
    if isinstance(template, dict):
        if set(template) != set(loaded):
            raise ValueError(f"checkpoint keys differ from the template's: "
                             f"{sorted(set(template) ^ set(loaded))}")
        return {k: _like(template[k], loaded[k]) for k in template}
    if isinstance(template, torch.Tensor):
        if tuple(loaded.shape) != tuple(template.shape):
            raise ValueError(f"checkpoint shape {tuple(loaded.shape)} differs from "
                             f"the template's {tuple(template.shape)}")
        return loaded.to(template.device)
    return loaded


class CheckpointManager:
    """Save every `every`-th step, keep the newest `max_to_keep`. With a
    `mesh`, every rank makes the same calls: the first writes, the others
    wait for it; `shardings` ({state field: {name: axis}}) says which
    tensors each model rank holds a part of."""

    def __init__(self, directory: str, max_to_keep: int = 3, every: int = 1,
                 mesh=None, shardings=None):
        if shardings and mesh is None:
            raise ValueError("a split state (shardings) needs the mesh it is split over")
        self.mesh = mesh
        self.shardings = shardings
        self.directory = os.path.abspath(directory)
        os.makedirs(self.directory, exist_ok=True)
        self.every = max(1, every)
        self.max_to_keep = max_to_keep
        self._thread: Optional[threading.Thread] = None
        self._error: Optional[Exception] = None

    def _steps(self):
        return sorted(int(s) for s in os.listdir(self.directory) if s.isdigit())

    def _write(self, step: int, plain: Any) -> None:
        try:
            tmp = os.path.join(self.directory, f".{step}.tmp")
            shutil.rmtree(tmp, ignore_errors=True)
            os.makedirs(tmp)
            torch.save(plain, os.path.join(tmp, CHECKPOINT_FILE))
            final = os.path.join(self.directory, str(step))
            shutil.rmtree(final, ignore_errors=True)
            os.rename(tmp, final)
            for old in self._steps()[:-self.max_to_keep]:
                shutil.rmtree(os.path.join(self.directory, str(old)))
        except Exception as e:  # raised again by wait()
            self._error = e

    def save(self, step: int, state: Any, force: bool = False) -> bool:
        """Copy `state` to the host and write it in the background, unless
        `step` is off the cadence (and not `force`). Waits for the previous
        write first, so at most one is in flight."""
        if not force and step % self.every != 0:
            return False
        self.wait()
        if self.shardings:
            from rovr_torch.parallel import tp

            state = tp.gather_state(state, self.shardings, self.mesh)
        if self.mesh is not None and not self.mesh.first:
            return True
        plain = _to_plain(state)
        self._thread = threading.Thread(target=self._write, args=(step, plain),
                                        name=f"checkpoint-{step}", daemon=True)
        self._thread.start()
        return True

    def restore(self, step: Optional[int] = None, template: Any = None,
                shardings: Any = None) -> Any:
        """The newest (or given) step, or None when there is none. With a
        `template`, the state comes back in its structure and each tensor on
        its template tensor's device; without one, as plain dicts on the
        CPU. A split state (`shardings`, default the manager's) comes back as
        this rank's parts."""
        shardings = self.shardings if shardings is None else shardings
        if shardings and self.mesh is None:
            raise ValueError("a split restore (shardings) needs the manager's mesh")
        self.wait()
        step = self.latest_step() if step is None else step
        if step is None:
            return None
        plain = torch.load(os.path.join(self.directory, str(step), CHECKPOINT_FILE),
                           map_location="cpu", weights_only=True)
        if shardings:
            from rovr_torch.parallel import tp

            plain = tp.shard_state(plain, shardings, self.mesh)
        return plain if template is None else _like(template, plain)

    def latest_step(self) -> Optional[int]:
        steps = self._steps()
        return steps[-1] if steps else None

    def wait(self) -> None:
        """Join the write in flight (under a mesh, every rank then waits for
        rank 0's); raise what it raised."""
        if self._thread is not None:
            self._thread.join()
            self._thread = None
        if self.mesh is not None:
            collectives.barrier(self.mesh)
        if self._error is not None:
            err, self._error = self._error, None
            raise err

    def close(self) -> None:
        self.wait()
