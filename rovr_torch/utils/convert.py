"""Carry weights from the JAX package into the port.

`params_from_jax(jax_state)` maps a JAX `ROVRState` (flax param trees; any
nested mapping of arrays, numpy or JAX) to the port's `ROVRState`, module
by module. The port's modules keep the flax names, so the map is by rule:

  * conv kernel HWIO (kh,kw,in,out) -> OIHW (out,in,kh,kw);
  * transposed-conv kernel (the UNet's upconv*, PolicyNet1's
    ConvTranspose_0) HWIO -> IOHW (in,out,kh,kw)
    with a spatial flip (flax's ConvTranspose correlates the un-flipped
    kernel; the inverse of rovr_tpu/models/local_net.py:100-104);
  * Dense kernel (in,out) -> Linear weight (out,in);
  * norm `scale` -> `weight`, frozen-norm `mean`/`var` -> `running_mean`/
    `running_var`;
  * flax list names `convs_0`/`norms_0` (PolicyNet1's `enc_0`, `up_0`,
    `dec_0`) -> `convs.0`/`norms.0`, and the
    `final_fc` MLP's `Dense_j` -> `j` (a Dense_j elsewhere, as in the
    attention blocks' FeedForwardBlock, keeps its name);
  * a DenseGeneral kernel (3-D: q/k/v (in,H,D), out (H,D,out), the attention
    policy's tokenize (feat,P,H)) keeps flax's layout: the port's
    DenseGeneral stores it so.

No row permutation is needed for PolicyNet2's first final_fc layer: the
port flattens its conv trunk in the same NHWC order as the JAX package.

`pretrain_state_from_jax` and `imitation_state_from_jax` carry the other
two workloads' states (`PretrainState`, `ImitationState`) by the same
rules: their trees hold the same modules.

RAFT-small's tree (`raft_params`, present only when the spatio signal is
on) needs no rule of its own: its InstanceNorm `scale`/`bias` map as every
norm's do, its block names (`layer1_0`, `conv_down`) are the port's module
names, and the update cell's parameters sit once under `update`, not
stacked per iteration (flax's nn.scan broadcasts them).
"""

from __future__ import annotations

import re
from typing import Any, Dict, Iterator, Mapping, Optional, Tuple

import numpy as np
import torch

from rovr_torch.train.rl import ROVRState, adam_init

_LEAF = {"kernel": "weight", "scale": "weight", "mean": "running_mean",
         "var": "running_var"}


def _leaves(tree: Mapping, prefix: Tuple[str, ...] = ()) -> Iterator:
    for k, v in tree.items():
        if isinstance(v, Mapping):
            yield from _leaves(v, prefix + (k,))
        else:
            yield prefix + (k,), np.asarray(v)


def _module_name(name: str, parent: str) -> str:
    m = re.fullmatch(r"(convs|norms|enc|up|dec)_(\d+)", name)
    if m:
        return f"{m.group(1)}.{m.group(2)}"
    m = re.fullmatch(r"Dense_(\d+)", name)
    return m.group(1) if m and parent == "final_fc" else name


def module_params_from_jax(tree: Mapping) -> Dict[str, torch.Tensor]:
    """One flax param tree -> the matching port module's state dict (CPU)."""
    out = {}
    for path, a in _leaves(tree):
        *mods, leaf = path
        if leaf == "kernel" and a.ndim == 4:
            if mods and mods[-1].startswith(("upconv", "ConvTranspose")):
                a = a[::-1, ::-1].transpose(2, 3, 0, 1)
            else:
                a = a.transpose(3, 2, 0, 1)
        elif leaf == "kernel" and a.ndim == 2:
            a = a.T
        names = [_module_name(m, p) for m, p in zip(mods, [""] + mods)]
        key = ".".join(names + [_LEAF.get(leaf, leaf)])
        out[key] = torch.from_numpy(np.array(a, dtype=np.float32))  # a copy
    return out


def _adam_from_jax(opt, device) -> Optional[dict]:
    """optax.adam's state ((ScaleByAdamState(count, mu, nu), EmptyState()))
    -> the port's {"step", "exp_avg", "exp_avg_sq"}; None when absent."""
    for part in (opt if isinstance(opt, (tuple, list)) else (opt,)):
        if hasattr(part, "mu") and hasattr(part, "nu"):
            return {"step": int(np.asarray(part.count)), **{
                name: {k: v.to(device) for k, v in module_params_from_jax(tree).items()}
                for name, tree in (("exp_avg", part.mu), ("exp_avg_sq", part.nu))}}
    return None


def params_from_jax(jax_state: Any, device=None, policy1: bool = False) -> ROVRState:
    """JAX ROVRState (or a mapping with its `*_params` fields) -> the port's
    ROVRState on `device` (default: the CPU): every module's parameters
    (`raft_params` None where the JAX state has none), the PPO step count
    and, where the JAX state has them, the actor's and critic's Adam states
    (else fresh ones). The JAX state always carries pi1's fields; they are
    taken only with `policy1` (for a port state built with
    cfg.rl.use_policy1), and are None otherwise. The LSTM's cell maps by
    rule: flax's OptimizedLSTMCell names (`cell.ii`..`cell.ho`) are the
    port's."""
    def get(field, default=None):
        if isinstance(jax_state, Mapping):
            return jax_state.get(field, default)
        return getattr(jax_state, field, default)

    dev = device or "cpu"
    pi1 = ("actor1_params", "critic1_params", "lstm_params")
    params = {
        f: None if get(f) is None or (f in pi1 and not policy1) else
        {k: v.to(dev) for k, v in module_params_from_jax(get(f)).items()}
        for f in ROVRState._fields if f.endswith("_params")
    }
    opts = {}
    for f in ("actor2", "critic2") + (("actor1", "critic1") if policy1 else ()):
        opt = _adam_from_jax(get(f"{f}_opt"), dev)
        opts[f"{f}_opt"] = opt if opt is not None else adam_init(params[f"{f}_params"])
    return ROVRState(**params, **opts, step=int(np.asarray(get("step", 0))))



def pretrain_state_from_jax(jax_state: Any, device=None):
    """JAX pretrain_local.PretrainState -> the port's, on `device` (default:
    the CPU): the UNet's and LPIPS' parameters, the step count and the
    UNet's Adam state."""
    from rovr_torch.train.pretrain_local import PretrainState

    dev = device or "cpu"
    params = {k: v.to(dev) for k, v in module_params_from_jax(jax_state.params).items()}
    lpips = {k: v.to(dev) for k, v in module_params_from_jax(jax_state.lpips_params).items()}
    opt = _adam_from_jax(jax_state.opt_state, dev)
    return PretrainState(step=int(np.asarray(jax_state.step)), params=params,
                         opt_state=opt if opt is not None else adam_init(params),
                         lpips_params=lpips)


def imitation_state_from_jax(jax_state: Any, train_vp: bool = True, device=None):
    """JAX imitation.ImitationState -> the port's, on `device` (default: the
    CPU): π₂'s and the VideoProcessor's parameters and the step count. The
    Adam state starts fresh over the trained parameters (π₂, and the
    VideoProcessor's heads with `train_vp`): carry states of step 0."""
    from rovr_torch.train.imitation import ImitationState, _trained_vp

    dev = device or "cpu"
    pn2 = {k: v.to(dev) for k, v in module_params_from_jax(jax_state.pn2_params).items()}
    vp = {k: v.to(dev) for k, v in module_params_from_jax(jax_state.vp_params).items()}
    trained = {f"pn2.{k}": v for k, v in pn2.items()}
    trained.update({f"vp.{k}": v for k, v in vp.items() if _trained_vp(k, train_vp)})
    return ImitationState(int(np.asarray(jax_state.step)), pn2, vp, adam_init(trained))
