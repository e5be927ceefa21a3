"""The (data, model) mesh (rovr_tpu/parallel/mesh.py) over torch.distributed.

The JAX package runs one process over a named device mesh, and GSPMD
splits the batch and the model. Here a `Mesh` is one process per device,
laid out as a dp x mp grid: rank r sits at data index r // mp and model
index r % mp, as the JAX mesh reshapes its devices (dp, mp). Each process
holds a process group along each axis: its column (the ranks that share
its model index) is the data group, its row (the ranks that share its data
index) the model group. The caller starts the processes and calls
`torch.distributed.init_process_group` (address, world size and rank given
explicitly; `parallel.launch.spawn` does both), then `make_mesh`.

The clip batch is split over the data axis and replicated over the model
axis: `shard_batch`, `local_rows` and `replicate` act on the data axis
only. The model axis carries tensor, pipeline and expert parallelism and
ring attention (`parallel.tp`, `parallel.pp`, `parallel.ring_attention`,
`models.moe`).

Backends: NCCL for CUDA tensors, gloo for CPU tensors; a group of another
backend is refused, and so is a tensor on the other kind of device
(`collectives`). World size 1 is a real mesh: every data-axis collective
still runs through the group; a model axis of size 1 needs no group, and
its collectives are the identity, as in JAX.

`make_mesh` raises where data_parallel x model_parallel does not cover the
group; the JAX `make_mesh` silently makes every device data-parallel.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Optional

import torch
import torch.distributed as dist

BACKEND_DEVICE = {"nccl": "cuda", "gloo": "cpu"}
DATA_AXIS = "data"
MODEL_AXIS = "model"


@dataclasses.dataclass(frozen=True)
class Axis:
    """One axis of a mesh as this process sees it: the group along it (None
    for a model axis of size 1), its size and this process's index."""

    group: Any
    size: int
    rank: int

    def src(self, rank: int) -> int:
        """The global rank of this axis' `rank`."""
        return dist.get_global_rank(self.group, rank)


@dataclasses.dataclass(frozen=True)
class Mesh:
    """A dp x mp grid of processes. `group`, `size` and `rank` are the data
    axis (this process's column); `model_group`, `model_size` and
    `model_rank` the model axis (its row); `world` the whole grid's group;
    its tensors are on `device`."""

    group: Any
    size: int
    rank: int
    device: torch.device
    backend: str
    model_group: Any = None
    model_size: int = 1
    model_rank: int = 0
    world: Any = None

    @property
    def shape(self) -> dict:
        return {DATA_AXIS: self.size, MODEL_AXIS: self.model_size}

    @property
    def first(self) -> bool:
        """Is this the grid's first process (the one that writes)?"""
        return self.rank == 0 and self.model_rank == 0

    def axis(self, name: str) -> Axis:
        if name == DATA_AXIS:
            return Axis(self.group, self.size, self.rank)
        if name == MODEL_AXIS:
            return Axis(self.model_group, self.model_size, self.model_rank)
        raise ValueError(f"mesh axes are {DATA_AXIS!r} and {MODEL_AXIS!r}, got {name!r}")

    def src(self, rank: int = 0) -> int:
        """The global rank of the data axis' `rank`."""
        return dist.get_global_rank(self.group, rank)


def _subgroups(group, members) -> Any:
    """Make one group per entry of `members` (lists of indices into `group`)
    on every process, as torch.distributed requires; return the one this
    process is in."""
    me = dist.get_rank(group)
    mine = None
    for idx in members:
        g = dist.new_group([dist.get_global_rank(group, i) for i in idx])
        if me in idx:
            mine = g
    return mine


def make_mesh(cfg=None, group=None) -> Mesh:
    """The (data, model) mesh over `group` (default: the initialised
    default group).

    `cfg` (config.MeshConfig): model_parallel mp (0 or 1: no model axis)
    and data_parallel dp (0: the group's size / mp); dp x mp must be the
    group's size, else ValueError. Without `cfg` every process is on the
    data axis. A NCCL group's device is the current CUDA device
    (`torch.cuda.set_device` it per process first); a gloo group's is the
    CPU. Every process of the group must call this with the same `cfg`."""
    if not dist.is_available() or not dist.is_initialized():
        raise RuntimeError("make_mesh needs torch.distributed.init_process_group first "
                           "(or parallel.launch.spawn)")
    group = group if group is not None else dist.group.WORLD
    size, rank = dist.get_world_size(group), dist.get_rank(group)
    mp = dp = 0
    if cfg is not None:
        mp, dp = cfg.model_parallel, cfg.data_parallel
    mp = mp if mp > 0 else 1
    dp = dp if dp > 0 else size // mp
    if dp * mp != size:
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
    d, m = divmod(rank, mp)
    data_group = group if mp == 1 else _subgroups(
        group, [[i * mp + j for i in range(dp)] for j in range(mp)])
    model_group: Optional[Any] = None
    if mp > 1:
        model_group = group if dp == 1 else _subgroups(
            group, [[i * mp + j for j in range(mp)] for i in range(dp)])
    return Mesh(data_group, dp, d, device, backend, model_group, mp, m, group)


def local_batch_size(mesh: Mesh, global_batch: int) -> int:
    if global_batch % mesh.size:
        raise ValueError(f"global batch {global_batch} not divisible by the data "
                         f"axis {mesh.size}")
    return global_batch // mesh.size


def local_rows(mesh: Mesh, global_batch: int) -> slice:
    """This rank's rows of a global batch of `global_batch` (its data index's
    share; the model axis holds the same rows)."""
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
    every rank of the data axis as its rank 0 holds it: each tensor and
    number is broadcast over the data axis, tensors onto the mesh's device.
    A model rank keeps its own shards of a tensor- or expert-parallel state.
    Shapes must agree across the data axis."""
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
