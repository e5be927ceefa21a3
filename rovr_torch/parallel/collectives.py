"""Collectives on the named axes of a mesh (rovr_tpu/parallel/collectives.py)
with torch.distributed, and the context that makes batch statistics global.

Each call takes the mesh and the axis (`axis_name`, the data axis unless
said), checks that its tensor lies on the mesh's kind of device (CUDA under
NCCL, the CPU under gloo) and counts itself in `CALLS` by kind
("all_reduce", "all_gather", "broadcast", "send_recv", "reduce_scatter",
"barrier"), and under "model:<kind>" too when it runs on the model axis. On
a model axis of size 1 every collective is the identity and counts nothing.

`psum` and `pmean` are differentiable: their backward all-reduces the
gradient. With every rank taking the gradient of its own shard's loss and
the optimiser averaging the gradients (`pmean_grads`), this gives each
rank the gradient of the global-batch loss. That is right for a global
batch statistic; it is wrong for a sum that every rank then uses whole.

The model axis follows Megatron's four operators, each the other's
transpose. A tensor there is replicated (every model rank holds all of it
and the same gradient) or split (each holds its part):
  * `copy_to_model`: identity forward, all-reduce backward (a replicated
    tensor entering split computation: each rank's gradient is partial);
  * `reduce_from_model`: all-reduce forward, identity backward (partial
    sums whose total every rank then uses whole);
  * `split(axis_name, dim)`: this rank's chunk forward, all-gather backward;
  * `gather(axis_name, dim)`: all-gather forward, this rank's chunk
    backward.
`ppermute_ring` is differentiable too: its backward permutes by -shift, as
`jax.grad` of `lax.ppermute` does. Every rank of an axis must run the same
collectives in the same order, forward and backward: model code keeps its
autograd graph the same on every rank (no branch on the rank around a
differentiable collective).

`global_batch(mesh)` is a context under which the model code's reductions
over the batch axis (`layers.BatchStatNorm` and the critic's
standardisation) reduce over the data axis, as the JAX package's GSPMD
step does over the global batch. `current_mesh()` is None outside it, and
then every one of them computes exactly what it computes without a mesh.
"""

from __future__ import annotations

import collections
import contextlib
import contextvars
from typing import List, Optional, Sequence

import torch
import torch.distributed as dist

from rovr_torch.parallel.mesh import BACKEND_DEVICE, DATA_AXIS, MODEL_AXIS, Mesh

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


def _count(kind: str, axis_name: str) -> None:
    CALLS[kind] += 1
    if axis_name != DATA_AXIS:
        CALLS[f"{axis_name}:{kind}"] += 1


def all_reduce_(x: torch.Tensor, mesh: Mesh, axis_name: str = DATA_AXIS) -> torch.Tensor:
    """In place: x = the sum of x over the axis."""
    _check(x, mesh)
    ax = mesh.axis(axis_name)
    if ax.size == 1 and axis_name == MODEL_AXIS:
        return x
    _count("all_reduce", axis_name)
    dist.all_reduce(x, op=dist.ReduceOp.SUM, group=ax.group)
    return x


class _PSum(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mesh, axis_name):
        ctx.mesh, ctx.axis_name = mesh, axis_name
        return all_reduce_(x.contiguous().clone(), mesh, axis_name)

    @staticmethod
    def backward(ctx, grad):
        return all_reduce_(grad.contiguous().clone(), ctx.mesh, ctx.axis_name), None, None


def psum(x: torch.Tensor, mesh: Mesh, axis_name: str = DATA_AXIS) -> torch.Tensor:
    """The sum over the axis (a new tensor; differentiable, all-reducing
    the gradient)."""
    return _PSum.apply(x, mesh, axis_name)


def pmean(x: torch.Tensor, mesh: Mesh, axis_name: str = DATA_AXIS) -> torch.Tensor:
    """The mean over the axis (a new tensor; differentiable)."""
    return psum(x, mesh, axis_name) / mesh.axis(axis_name).size


def pmean_dict(values: dict, mesh: Mesh) -> dict:
    """Each scalar tensor of `values` averaged over the data axis, in one call."""
    keys = sorted(values)
    if not keys:
        return {}
    flat = torch.stack([values[k].detach().float().reshape(()).to(mesh.device)
                        for k in keys])
    flat = all_reduce_(flat, mesh) / mesh.size
    return dict(zip(keys, flat.unbind()))


def pmean_grads(params: Sequence[torch.Tensor], mesh: Mesh) -> None:
    """In place: each parameter's .grad (None counts as 0) averaged over the
    data axis, in one coalesced call, before the optimiser steps. A model
    rank's shard of a split parameter is averaged with the same shard on
    the other data ranks, never over the model axis."""
    grads = [p.grad if p.grad is not None else torch.zeros_like(p) for p in params]
    flat = torch.cat([g.reshape(-1) for g in grads])
    flat = all_reduce_(flat, mesh).div_(mesh.size)
    for p, g in zip(params, flat.split([g.numel() for g in grads])):
        p.grad = g.view_as(p).clone()


def broadcast(x: torch.Tensor, mesh: Mesh, src: int = 0) -> torch.Tensor:
    """In place: x = data rank `src`'s x."""
    _check(x, mesh)
    CALLS["broadcast"] += 1
    dist.broadcast(x, src=mesh.src(src), group=mesh.group)
    return x


def all_gather(x: torch.Tensor, mesh: Mesh, axis: int = 0, tiled: bool = True,
               axis_name: str = DATA_AXIS) -> torch.Tensor:
    """Every rank's x along the mesh axis `axis_name`, concatenated along
    the tensor axis `axis` (tiled) or stacked in a new leading axis, in rank
    order."""
    _check(x, mesh)
    ax = mesh.axis(axis_name)
    if ax.size == 1 and axis_name == MODEL_AXIS:
        return x.clone() if tiled else x[None].clone()
    _count("all_gather", axis_name)
    x = x.contiguous()
    parts: List[torch.Tensor] = [torch.empty_like(x) for _ in range(ax.size)]
    dist.all_gather(parts, x, group=ax.group)
    return torch.cat(parts, dim=axis) if tiled else torch.stack(parts)


def _permute(xs, mesh: Mesh, axis_name: str, shift: int):
    """Each of `xs` from axis rank r to rank (r + shift) % size, in one
    batch of sends and receives; returns what this rank received."""
    ax = mesh.axis(axis_name)
    for x in xs:
        _check(x, mesh)
    if ax.size == 1:
        return tuple(x.clone() for x in xs)
    _count("send_recv", axis_name)
    outs = tuple(torch.empty_like(x, memory_format=torch.contiguous_format) for x in xs)
    dst = ax.src((ax.rank + shift) % ax.size)
    src = ax.src((ax.rank - shift) % ax.size)
    ops = []
    for x, out in zip(xs, outs):
        ops += [dist.P2POp(dist.isend, x.contiguous(), dst, ax.group),
                dist.P2POp(dist.irecv, out, src, ax.group)]
    for req in dist.batch_isend_irecv(ops):
        req.wait()
    return outs


class _PPermute(torch.autograd.Function):
    @staticmethod
    def forward(ctx, mesh, axis_name, shift, *xs):
        ctx.mesh, ctx.axis_name, ctx.shift = mesh, axis_name, shift
        return _permute(xs, mesh, axis_name, shift)

    @staticmethod
    def backward(ctx, *grads):
        return (None, None, None) + _permute(grads, ctx.mesh, ctx.axis_name, -ctx.shift)


def ppermute_ring(x, mesh: Mesh, axis_name: str = DATA_AXIS, shift: int = 1):
    """Rank r's x goes to rank (r + shift) % size along the axis (send/recv
    around the ring); returns what this rank received. `x` may be a tuple
    or list of tensors, sent in one batch and returned as a tuple.
    Differentiable: the gradient goes back by -shift. At size 1 a copy
    comes back."""
    many = isinstance(x, (tuple, list))
    out = _PPermute.apply(mesh, axis_name, shift, *(x if many else (x,)))
    return tuple(out) if many else out[0]


class _CopyToModel(torch.autograd.Function):
    @staticmethod
    def forward(ctx, mesh, *xs):
        ctx.mesh = mesh
        return tuple(x.view_as(x) for x in xs)

    @staticmethod
    def backward(ctx, *grads):
        # one all-reduce in f32 whatever the gradients' dtypes
        flat = torch.cat([g.float().reshape(-1) for g in grads])
        flat = all_reduce_(flat, ctx.mesh, MODEL_AXIS)
        return (None,) + tuple(f.view_as(g).to(g.dtype) for f, g in zip(
            flat.split([g.numel() for g in grads]), grads))


def copy_to_model(x, mesh: Mesh):
    """Identity forward; backward all-reduces the gradient over the model
    axis. `x` may be a tuple or list (one coalesced all-reduce; returned as
    a tuple)."""
    many = isinstance(x, (tuple, list))
    xs = tuple(x) if many else (x,)
    if mesh.model_size > 1:
        xs = _CopyToModel.apply(mesh, *xs)
    return tuple(xs) if many else xs[0]


class _ReduceFromModel(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mesh):
        return all_reduce_(x.contiguous().clone(), mesh, MODEL_AXIS)

    @staticmethod
    def backward(ctx, grad):
        return grad, None


def reduce_from_model(x: torch.Tensor, mesh: Mesh) -> torch.Tensor:
    """The sum over the model axis forward; the gradient passes unchanged
    (every model rank then holds the whole sum and its whole gradient)."""
    if mesh.model_size == 1:
        return x
    return _ReduceFromModel.apply(x, mesh)


def _chunk(x: torch.Tensor, mesh: Mesh, axis_name: str, dim: int) -> torch.Tensor:
    ax = mesh.axis(axis_name)
    if x.shape[dim] % ax.size:
        raise ValueError(f"dim {dim} of size {x.shape[dim]} does not split over the "
                         f"{axis_name} axis' {ax.size} ranks")
    return x.chunk(ax.size, dim=dim)[ax.rank].contiguous()


class _Split(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mesh, axis_name, dim):
        ctx.mesh, ctx.axis_name, ctx.dim = mesh, axis_name, dim
        return _chunk(x, mesh, axis_name, dim)

    @staticmethod
    def backward(ctx, grad):
        return all_gather(grad, ctx.mesh, ctx.dim, axis_name=ctx.axis_name), None, None, None


class _Gather(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mesh, axis_name, dim):
        ctx.mesh, ctx.axis_name, ctx.dim = mesh, axis_name, dim
        return all_gather(x, mesh, dim, axis_name=axis_name)

    @staticmethod
    def backward(ctx, grad):
        return _chunk(grad, ctx.mesh, ctx.axis_name, ctx.dim), None, None, None


def split(x: torch.Tensor, mesh: Mesh, axis_name: str = MODEL_AXIS, dim: int = 0):
    """This rank's chunk of `x` along `dim` (the axis' size chunks, in rank
    order); backward all-gathers the chunks' gradients."""
    if mesh.axis(axis_name).size == 1:
        return x
    return _Split.apply(x, mesh, axis_name, dim)


def gather(x: torch.Tensor, mesh: Mesh, axis_name: str = MODEL_AXIS, dim: int = 0):
    """The axis' chunks concatenated along `dim` in rank order; backward
    keeps this rank's chunk of the gradient."""
    if mesh.axis(axis_name).size == 1:
        return x
    return _Gather.apply(x, mesh, axis_name, dim)


def reduce_scatter(x: torch.Tensor, mesh: Mesh, axis: int = 0) -> torch.Tensor:
    """The sum over the data axis, split along `axis` into `size` equal
    chunks; rank r keeps chunk r. NCCL reduces and scatters in one call;
    gloo has no reduce-scatter, so there it is an all-reduce and this rank's
    slice."""
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


def axis_index(mesh: Mesh, axis_name: str = DATA_AXIS) -> int:
    """This process's index along the axis."""
    return mesh.axis(axis_name).rank


def barrier(mesh: Mesh) -> None:
    """Wait for every process of the mesh (both axes)."""
    CALLS["barrier"] += 1
    group = mesh.world if mesh.world is not None else mesh.group
    if mesh.backend == "nccl":
        dist.barrier(group=group, device_ids=[mesh.device.index])
    else:
        dist.barrier(group=group)
