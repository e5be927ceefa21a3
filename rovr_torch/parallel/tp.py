"""Tensor parallelism for the attention context policy (Megatron style;
rovr_tpu/parallel/tp.py), and the sharded state it and expert parallelism
keep.

The JAX package annotates parameter shardings by path-suffix rules and
lets GSPMD insert the collectives. Here the rules (`_RULES`, the same
suffixes in the port's layouts) say which axis of a parameter each model
rank holds a part of, and the modules compute on their parts with the
collectives written out (`collectives.copy_to_model`,
`reduce_from_model`):

  * q/k/v kernels (hidden, H, D) and biases (H, D): the heads split, so
    attention runs on this rank's H/mp heads (K2-K4 at H/mp heads);
  * the out kernel (H, D, hidden): the heads split, a row-parallel product
    whose partial sums are all-reduced; its bias stays whole;
  * the FFN's Dense_0 (torch (hidden/4, hidden)): its columns split, with
    its bias; Dense_1 (torch (hidden, hidden/4)): its rows split, a
    row-parallel product; its bias stays whole;
  * the MoE's expert axis (`EXPERT_RULES`, expert parallelism; models/moe.py)
    whenever the MoE is bound to a mesh with a model axis;
  * everything else replicated.

A module built on a mesh (`rl.make_modules(cfg, mesh=..., tensor_parallel=
True)`) holds only its rank's parts, as its `model_shards` {param: (axis,
parts, index)} say; `layers.flax_init_state` draws the whole parameter and
keeps the part, so a sharded state is the sharded single-device state.
`param_specs` reads a module's shards, `state_shardings` a module zoo's (the
Adam moments mirror their parameters), `shard_state` and `gather_state` go
between the two. Replicated and split parameters alike are averaged over
the data axis only, never over the model axis.
"""

from __future__ import annotations

from typing import Dict, Optional

from torch import nn

from rovr_torch.parallel import collectives
from rovr_torch.parallel.mesh import MODEL_AXIS, Mesh

# (module name, parameter) -> the axis split over the model axis, in the
# port's layouts (DenseGeneral keeps flax's; Linear is torch's (out, in))
_RULES = {
    ("q", "weight"): 1, ("k", "weight"): 1, ("v", "weight"): 1,   # (hidden, H, D)
    ("q", "bias"): 0, ("k", "bias"): 0, ("v", "bias"): 0,         # (H, D)
    ("out", "weight"): 0,                                         # (H, D, hidden)
    ("Dense_0", "weight"): 0, ("Dense_0", "bias"): 0,             # (hidden/4, hidden)
    ("Dense_1", "weight"): 1,                                     # (hidden, hidden/4)
}
# MoEFeedForward's stacked experts: w1 (E, d, f), b1 (E, f), w2 (E, f, d), b2 (E, d)
EXPERT_RULES = {"w1": 0, "b1": 0, "w2": 0, "b2": 0}


def mark(module: nn.Module, name: str, mesh: Mesh) -> nn.Module:
    """Give `module` (a q/k/v/out DenseGeneral or a Dense_0/Dense_1 Linear,
    built at its part's shape) the shards `_RULES` name for `name`."""
    module.model_shards = {p: (dim, mesh.model_size, mesh.model_rank)
                           for (m, p), dim in _RULES.items() if m == name}
    return module


def part(n: int, mesh: Mesh, what: str) -> int:
    """n / the model axis' size; ValueError where it does not divide."""
    if n % mesh.model_size:
        raise ValueError(f"{what} {n} does not split over model_parallel="
                         f"{mesh.model_size}")
    return n // mesh.model_size


def param_specs(module: nn.Module) -> Dict[str, int]:
    """{parameter name: the axis split over the model axis} of a module's
    split parameters (the JAX `param_specs`, read off the modules)."""
    out = {}
    for mname, m in module.named_modules():
        for pname, (dim, _, _) in getattr(m, "model_shards", {}).items():
            out[f"{mname}.{pname}" if mname else pname] = dim
    return out


def state_shardings(mods) -> Dict[str, Dict[str, int]]:
    """{ROVRState field: param_specs} for every module of the zoo with split
    parameters, its Adam state (`<module>_opt`) mirroring them."""
    from rovr_torch.train import rl

    out = {}
    for name, mod in zip(rl.ROVRModules._fields, mods):
        specs = param_specs(mod) if mod is not None else {}
        if specs:
            out[rl._MODULE_STATE[name]] = specs
            out[f"{name}_opt"] = specs
    return out


def _tree(value, specs: Dict[str, int], fn):
    """Apply fn(tensor, axis) to the split entries of a params dict or an Adam
    state {"step", "exp_avg", "exp_avg_sq"}."""
    if value is None:
        return None
    if "exp_avg" in value:
        return {**value, "exp_avg": _tree(value["exp_avg"], specs, fn),
                "exp_avg_sq": _tree(value["exp_avg_sq"], specs, fn)}
    return {k: fn(v, specs[k]) if k in specs else v for k, v in value.items()}


def _map_state(state, shardings: Dict[str, Dict[str, int]], fn):
    """`state` (a ROVRState or its plain dict) with fn applied to the split
    tensors of every field `shardings` names."""
    if isinstance(state, dict):
        return {**state, **{f: _tree(state[f], specs, fn) for f, specs in shardings.items()}}
    return state._replace(**{f: _tree(getattr(state, f), specs, fn)
                             for f, specs in shardings.items()})


def shard_state(state, shardings: Dict[str, Dict[str, int]], mesh: Mesh):
    """Each model rank's part of a whole (single-device) state."""
    return _map_state(state, shardings, lambda t, dim: t.chunk(
        mesh.model_size, dim)[mesh.model_rank].clone())


def gather_state(state, shardings: Dict[str, Dict[str, int]], mesh: Mesh):
    """The whole state from the model ranks' parts (every rank of a model
    row calls it; each gets the whole)."""
    return _map_state(state, shardings, lambda t, dim: collectives.all_gather(
        t.detach(), mesh, dim, axis_name=MODEL_AXIS))


def is_tensor_parallel(module: Optional[nn.Module]) -> bool:
    return module is not None and any(
        getattr(m, "tensor_parallel", False) for m in module.modules())


def make_tp_train_step(mesh: Mesh, mods, cfg):
    """Data-parallel clips x tensor-parallel attention policy: the batch
    split over the data axis, the policy's heads and FFN columns over the
    model axis. `mods` come from `rl.make_modules(cfg, mesh=mesh,
    tensor_parallel=True)`, the state from `rl.init_state` on them (each
    rank holds its parts; `gather_state` makes the whole). Returns
    `rl.make_sharded_train_step`'s step: the modules carry the sharding."""
    from rovr_torch.train import rl

    if not (is_tensor_parallel(mods.actor2) and is_tensor_parallel(mods.critic2)):
        raise ValueError("make_tp_train_step needs the attention policy built tensor-"
                         "parallel: rl.make_modules(cfg, mesh=mesh, tensor_parallel=True)")
    return rl.make_sharded_train_step(mesh, mods, cfg)
