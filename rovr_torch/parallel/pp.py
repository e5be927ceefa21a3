"""Pipeline parallelism: GPipe layer pipelining over a mesh axis
(rovr_tpu/parallel/pp.py).

The L layers split into S = the axis' size stages of contiguous layers;
model rank s runs stage s. The local batch splits into M microbatches, and
every rank runs M + S - 1 ticks. At tick t stage 0 takes microbatch t, the
other stages the activation they received on the previous tick; each
applies its layers and passes the result to the next rank
(`collectives.ppermute_ring`). Activations travel in the input's dtype,
rounded back at every stage boundary and between layers. The last stage's
ticks S-1 .. M+S-2 are the result, made whole on every rank by a masked
sum over the axis. The bubble is GPipe's (S-1)/(M+S-1).

Backward: the permute is differentiable, so autograd builds the reverse
pipeline, as `jax.grad` does. Every rank computes every tick, bubble ticks
too (on zeros or a repeated microbatch, as the JAX schedule does): the
collectives of the backward then match rank for rank. The layers'
parameters are held whole on every rank (the JAX stacked parameters are
sharded by stage); their gradients, which only the owning stage makes, are
summed over the axis, so every rank's gradient is the whole one.
"""

from __future__ import annotations

from typing import Any, Callable, Dict, List, Sequence

import torch

from rovr_torch.parallel import collectives
from rovr_torch.parallel.mesh import MODEL_AXIS, Mesh

Params = Dict[str, torch.Tensor]


def stack_layers(layer_params: Sequence[Params], stages: int) -> Params:
    """Stack per-layer parameter dicts into (stages, layers_per_stage, ...)
    tensors. Layer i goes to stage i // (L // stages): contiguous blocks,
    in application order."""
    n = len(layer_params)
    if stages <= 0 or n % stages:
        raise ValueError(f"{n} layers do not split into {stages} stages")
    per = n // stages
    return {k: torch.stack([p[k] for p in layer_params]).reshape(
        (stages, per) + tuple(layer_params[0][k].shape)) for k in layer_params[0]}


def microbatch_count(local_batch: int, microbatches: int, stages: int) -> int:
    """The largest divisor of the local batch <= the request (0: S)."""
    m = min(microbatches or stages, local_batch)
    while local_batch % m:
        m -= 1
    return m


def pipeline_apply(stage_fn: Callable[[Params, torch.Tensor], torch.Tensor],
                   stacked_params: Params, x: torch.Tensor, mesh: Mesh,
                   axis_name: str = MODEL_AXIS, microbatches: int = 0) -> torch.Tensor:
    """Run `x` (this rank's batch shard, the same on every rank of the
    axis) through the pipelined stack.

    stage_fn(stage params (layers_per_stage, ...), activation (mb, ...)) ->
    activation (mb, ...); stacked_params: leading axis S (`stack_layers`)."""
    if axis_name != MODEL_AXIS:
        raise ValueError(f"pipeline stages run over the {MODEL_AXIS!r} axis, not {axis_name!r}")
    s, stage = mesh.model_size, mesh.model_rank
    if s == 1:   # no pipelining
        return stage_fn({k: v[0] for k, v in stacked_params.items()}, x)
    names = list(stacked_params)
    # whole parameters and input: the owning stage's gradient is summed
    # into every rank's (one coalesced all-reduce in the backward)
    x, *flat = collectives.copy_to_model([x] + [stacked_params[k] for k in names], mesh)
    params = {k: v[stage] for k, v in zip(names, flat)}
    local_b = x.shape[0]
    m = microbatch_count(local_b, microbatches, s)
    stream = x.reshape((m, local_b // m) + tuple(x.shape[1:]))
    first = torch.tensor(stage == 0, device=x.device)
    recv = torch.zeros_like(stream[0])
    outs: List[torch.Tensor] = []
    for t in range(m + s - 1):
        act = torch.where(first, stream[min(t, m - 1)], recv)
        out = stage_fn(params, act).to(x.dtype)
        outs.append(out)
        if t < m + s - 2:   # the last tick's output goes nowhere
            recv = collectives.ppermute_ring(out, mesh, axis_name, 1)
    result = torch.cat(outs[s - 1:]).reshape(x.shape)
    return collectives.reduce_from_model(result * float(stage == s - 1), mesh)


def pipeline_layers(apply_layer: Callable[[Any, torch.Tensor], torch.Tensor],
                    layer_params: List[Params], x: torch.Tensor, mesh: Mesh,
                    axis_name: str = MODEL_AXIS, microbatches: int = 0) -> torch.Tensor:
    """Pipeline a list of per-layer parameter dicts through
    apply_layer(params_i, x) -> x over S = the axis' size stages."""
    stacked = stack_layers(layer_params, mesh.axis(axis_name).size)

    def stage_fn(stage_params: Params, act: torch.Tensor) -> torch.Tensor:
        per = next(iter(stage_params.values())).shape[0]
        for j in range(per):
            # the carry keeps its dtype between layers (see pipeline_apply)
            act = apply_layer({k: v[j] for k, v in stage_params.items()}, act).to(act.dtype)
        return act

    return pipeline_apply(stage_fn, stacked, x, mesh, axis_name, microbatches)
