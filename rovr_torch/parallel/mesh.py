"""The data-parallel mesh (rovr_tpu/parallel/mesh.py) over torch.distributed.

The JAX package runs one process over a named device mesh, and GSPMD
splits the batch. Here a `Mesh` is a torch.distributed process group along
the data axis, one process per device: this process's rank in it, its
device and the group's backend. The caller starts the processes and calls
`torch.distributed.init_process_group` (address, world size and rank given
explicitly; `parallel.launch.spawn` does both), then `make_mesh`.

Backends: NCCL for CUDA tensors, gloo for CPU tensors; a group of another
backend is refused, and so is a tensor on the other kind of device
(`collectives`). World size 1 is a real mesh: every collective still runs
through the group.

Only the data axis is in the port. `make_mesh` refuses model_parallel > 1
(tensor, pipeline and expert parallelism come with ROADMAP Queue 1 item
10), and a data_parallel that is not the group's size, where the JAX
`make_mesh` silently makes every device data-parallel.
"""

from __future__ import annotations

import dataclasses
from typing import Any

import torch
import torch.distributed as dist

BACKEND_DEVICE = {"nccl": "cuda", "gloo": "cpu"}


@dataclasses.dataclass(frozen=True)
class Mesh:
    """A process group along the data axis: `size` processes, this one
    `rank`, its tensors on `device`."""

    group: Any
    size: int
    rank: int
    device: torch.device
    backend: str

    def src(self, rank: int = 0) -> int:
        """The global rank of this group's `rank`."""
        return dist.get_global_rank(self.group, rank)


def make_mesh(cfg=None, group=None) -> Mesh:
    """The data mesh over `group` (default: the initialised default group).

    `cfg` (config.MeshConfig) may ask for data_parallel = the group's size
    (or 0: all of it) and model_parallel 1 (or 0); anything else raises.
    A NCCL group's device is the current CUDA device (`torch.cuda.set_device`
    it per process first); a gloo group's is the CPU."""
    if not dist.is_available() or not dist.is_initialized():
        raise RuntimeError("make_mesh needs torch.distributed.init_process_group first "
                           "(or parallel.launch.spawn)")
    group = group if group is not None else dist.group.WORLD
    size, rank = dist.get_world_size(group), dist.get_rank(group)
    if cfg is not None:
        mp = cfg.model_parallel if cfg.model_parallel > 0 else 1
        dp = cfg.data_parallel if cfg.data_parallel > 0 else size
        if mp > 1:
            raise NotImplementedError(
                f"model_parallel={mp}: tensor, pipeline and expert parallelism are not "
                "in the port yet (ROADMAP.md Queue 1 item 10)")
        if dp != size:
            raise ValueError(
                f"data_parallel={dp} x model_parallel={mp} does not cover the group's "
                f"{size} processes (the JAX make_mesh would make all of them "
                "data-parallel; the port refuses)")
    backend = str(dist.get_backend(group))
    if backend not in BACKEND_DEVICE:
        raise ValueError(f"process group backend {backend!r}: the port's mesh takes "
                         "nccl (CUDA tensors) or gloo (CPU tensors)")
    if backend == "nccl":
        device = torch.device("cuda", torch.cuda.current_device())
    else:
        device = torch.device("cpu")
    return Mesh(group, size, rank, device, backend)


def local_batch_size(mesh: Mesh, global_batch: int) -> int:
    if global_batch % mesh.size:
        raise ValueError(f"global batch {global_batch} not divisible by the data "
                         f"axis {mesh.size}")
    return global_batch // mesh.size


def local_rows(mesh: Mesh, global_batch: int) -> slice:
    """This rank's rows of a global batch of `global_batch`."""
    n = local_batch_size(mesh, global_batch)
    return slice(mesh.rank * n, (mesh.rank + 1) * n)


def _map(fn, tree):
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        return type(tree)(*[_map(fn, x) for x in tree])
    if isinstance(tree, (list, tuple)):
        return type(tree)(_map(fn, x) for x in tree)
    if isinstance(tree, dict):
        return {k: _map(fn, v) for k, v in tree.items()}
    return fn(tree)


def shard_batch(mesh: Mesh, tree):
    """This rank's rows (axis 0) of every array or tensor in `tree`, as
    tensors on the mesh's device; None stays None."""
    def take(x):
        if x is None:
            return None
        t = torch.as_tensor(x)
        return t[local_rows(mesh, t.shape[0])].to(mesh.device)
    return _map(take, tree)


def replicate(mesh: Mesh, tree):
    """`tree` (NamedTuples, dicts, lists of tensors and Python numbers) on
    every rank as rank 0 holds it: each tensor and number is broadcast from
    rank 0, tensors onto the mesh's device. Shapes must agree across ranks."""
    from rovr_torch.parallel import collectives

    def bcast(x):
        if isinstance(x, torch.Tensor):
            return collectives.broadcast(x.detach().to(mesh.device, copy=True), mesh)
        if isinstance(x, bool) or not isinstance(x, (int, float)):
            return x
        dt = torch.int64 if isinstance(x, int) else torch.float64
        t = collectives.broadcast(torch.tensor([x], dtype=dt, device=mesh.device), mesh)
        return type(x)(t.item())
    return _map(bcast, tree)
