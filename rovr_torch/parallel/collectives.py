"""Collectives over a data mesh (rovr_tpu/parallel/collectives.py) with
torch.distributed, and the context that makes batch statistics global.

Each call checks that its tensor lies on the mesh's kind of device (CUDA
under NCCL, the CPU under gloo) and counts itself in `CALLS` by kind
("all_reduce", "all_gather", "broadcast", "send_recv", "reduce_scatter").

`psum` and `pmean` are differentiable: their backward all-reduces the
gradient. With every rank taking the gradient of its own shard's loss and
the optimiser averaging the gradients (`pmean_grads`), this gives each
rank the gradient of the global-batch loss.

`global_batch(mesh)` is a context under which the model code's reductions
over the batch axis (`layers.BatchStatNorm` and the critic's
standardisation) reduce over every rank, as the JAX package's GSPMD step
does over the global batch. `current_mesh()` is None outside it, and then
every one of them computes exactly what it computes without a mesh.
"""

from __future__ import annotations

import collections
import contextlib
import contextvars
from typing import List, Optional, Sequence

import torch
import torch.distributed as dist

from rovr_torch.parallel.mesh import BACKEND_DEVICE, Mesh

CALLS: collections.Counter = collections.Counter()
_MESH: contextvars.ContextVar = contextvars.ContextVar("rovr_torch_batch_mesh",
                                                       default=None)


@contextlib.contextmanager
def global_batch(mesh: Optional[Mesh]):
    """Within the block, batch statistics reduce over `mesh` (None: local)."""
    token = _MESH.set(mesh)
    try:
        yield mesh
    finally:
        _MESH.reset(token)


def current_mesh() -> Optional[Mesh]:
    return _MESH.get()


def _check(x: torch.Tensor, mesh: Mesh) -> None:
    want = BACKEND_DEVICE[mesh.backend]
    if x.device.type != want:
        raise ValueError(f"a {x.device.type} tensor on a {mesh.backend} mesh: "
                         f"{mesh.backend} takes {want} tensors")


def all_reduce_(x: torch.Tensor, mesh: Mesh) -> torch.Tensor:
    """In place: x = the sum of x over the ranks."""
    _check(x, mesh)
    CALLS["all_reduce"] += 1
    dist.all_reduce(x, op=dist.ReduceOp.SUM, group=mesh.group)
    return x


class _PSum(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mesh):
        ctx.mesh = mesh
        return all_reduce_(x.contiguous().clone(), mesh)

    @staticmethod
    def backward(ctx, grad):
        return all_reduce_(grad.contiguous().clone(), ctx.mesh), None


def psum(x: torch.Tensor, mesh: Mesh) -> torch.Tensor:
    """The sum over the ranks (a new tensor; differentiable)."""
    return _PSum.apply(x, mesh)


def pmean(x: torch.Tensor, mesh: Mesh) -> torch.Tensor:
    """The mean over the ranks (a new tensor; differentiable)."""
    return psum(x, mesh) / mesh.size


def pmean_dict(values: dict, mesh: Mesh) -> dict:
    """Each scalar tensor of `values` averaged over the ranks, in one call."""
    keys = sorted(values)
    if not keys:
        return {}
    flat = torch.stack([values[k].detach().float().reshape(()).to(mesh.device)
                        for k in keys])
    flat = all_reduce_(flat, mesh) / mesh.size
    return dict(zip(keys, flat.unbind()))


def pmean_grads(params: Sequence[torch.Tensor], mesh: Mesh) -> None:
    """In place: each parameter's .grad (None counts as 0) averaged over the
    ranks, in one coalesced call, before the optimiser steps."""
    grads = [p.grad if p.grad is not None else torch.zeros_like(p) for p in params]
    flat = torch.cat([g.reshape(-1) for g in grads])
    flat = all_reduce_(flat, mesh).div_(mesh.size)
    for p, g in zip(params, flat.split([g.numel() for g in grads])):
        p.grad = g.view_as(p).clone()


def broadcast(x: torch.Tensor, mesh: Mesh, src: int = 0) -> torch.Tensor:
    """In place: x = rank `src`'s x."""
    _check(x, mesh)
    CALLS["broadcast"] += 1
    dist.broadcast(x, src=mesh.src(src), group=mesh.group)
    return x


def all_gather(x: torch.Tensor, mesh: Mesh, axis: int = 0,
               tiled: bool = True) -> torch.Tensor:
    """Every rank's x, concatenated along `axis` (tiled) or stacked in a new
    leading axis, in rank order."""
    _check(x, mesh)
    CALLS["all_gather"] += 1
    x = x.contiguous()
    parts: List[torch.Tensor] = [torch.empty_like(x) for _ in range(mesh.size)]
    dist.all_gather(parts, x, group=mesh.group)
    return torch.cat(parts, dim=axis) if tiled else torch.stack(parts)


def ppermute_ring(x: torch.Tensor, mesh: Mesh, shift: int = 1) -> torch.Tensor:
    """Rank r's x goes to rank (r + shift) % size (send/recv around the
    ring); returns what this rank received. At size 1 the ring is the
    identity and there is no peer to send to: a copy comes back."""
    _check(x, mesh)
    if mesh.size == 1:
        return x.clone()
    CALLS["send_recv"] += 1
    out = torch.empty_like(x)
    dst = mesh.src((mesh.rank + shift) % mesh.size)
    src = mesh.src((mesh.rank - shift) % mesh.size)
    ops = [dist.P2POp(dist.isend, x.contiguous(), dst, mesh.group),
           dist.P2POp(dist.irecv, out, src, mesh.group)]
    for req in dist.batch_isend_irecv(ops):
        req.wait()
    return out


def reduce_scatter(x: torch.Tensor, mesh: Mesh, axis: int = 0) -> torch.Tensor:
    """The sum over the ranks, split along `axis` into `size` equal chunks;
    rank r keeps chunk r. NCCL reduces and scatters in one call; gloo has no
    reduce-scatter, so there it is an all-reduce and this rank's slice."""
    _check(x, mesh)
    if x.shape[axis] % mesh.size:
        raise ValueError(f"axis {axis} of size {x.shape[axis]} does not split over "
                         f"{mesh.size} ranks")
    if mesh.backend == "nccl":
        CALLS["reduce_scatter"] += 1
        xt = x.movedim(axis, 0).contiguous()
        out = xt.new_empty((xt.shape[0] // mesh.size,) + tuple(xt.shape[1:]))
        dist.reduce_scatter_tensor(out, xt, group=mesh.group)
        return out.movedim(0, axis)
    total = all_reduce_(x.contiguous().clone(), mesh)
    return total.chunk(mesh.size, dim=axis)[mesh.rank].clone()


def axis_index(mesh: Mesh) -> int:
    """This process's index along the data axis."""
    return mesh.rank


def barrier(mesh: Mesh) -> None:
    CALLS["barrier"] += 1
    if mesh.backend == "nccl":
        dist.barrier(group=mesh.group, device_ids=[mesh.device.index])
    else:
        dist.barrier(group=mesh.group)
