"""Carry weights from the JAX package into the port.

`params_from_jax(jax_state)` maps a JAX `ROVRState` (flax param trees; any
nested mapping of arrays, numpy or JAX) to the port's `ROVRState`, module
by module. The port's modules keep the flax names, so the map is by rule:

  * conv kernel HWIO (kh,kw,in,out) -> OIHW (out,in,kh,kw);
  * transposed-conv kernel (the UNet's upconv*) HWIO -> IOHW (in,out,kh,kw)
    with a spatial flip (flax's ConvTranspose correlates the un-flipped
    kernel; the inverse of rovr_tpu/models/local_net.py:100-104);
  * Dense kernel (in,out) -> Linear weight (out,in);
  * norm `scale` -> `weight`, frozen-norm `mean`/`var` -> `running_mean`/
    `running_var`;
  * flax list names `convs_0`/`norms_0` -> `convs.0`/`norms.0`, and the
    MLP's `Dense_j` -> `j`.

No row permutation is needed for PolicyNet2's first final_fc layer: the
port flattens its conv trunk in the same NHWC order as the JAX package.
"""

from __future__ import annotations

import re
from typing import Any, Dict, Iterator, Mapping, Tuple

import numpy as np
import torch

from rovr_torch.train.rl import ROVRState

_LEAF = {"kernel": "weight", "scale": "weight", "mean": "running_mean",
         "var": "running_var"}


def _leaves(tree: Mapping, prefix: Tuple[str, ...] = ()) -> Iterator:
    for k, v in tree.items():
        if isinstance(v, Mapping):
            yield from _leaves(v, prefix + (k,))
        else:
            yield prefix + (k,), np.asarray(v)


def _module_name(name: str) -> str:
    m = re.fullmatch(r"(convs|norms)_(\d+)", name)
    if m:
        return f"{m.group(1)}.{m.group(2)}"
    m = re.fullmatch(r"Dense_(\d+)", name)
    return m.group(1) if m else name


def module_params_from_jax(tree: Mapping) -> Dict[str, torch.Tensor]:
    """One flax param tree -> the matching port module's state dict (CPU)."""
    out = {}
    for path, a in _leaves(tree):
        *mods, leaf = path
        if leaf == "kernel" and a.ndim == 4:
            if mods and mods[-1].startswith("upconv"):
                a = a[::-1, ::-1].transpose(2, 3, 0, 1)
            else:
                a = a.transpose(3, 2, 0, 1)
        elif leaf == "kernel" and a.ndim == 2:
            a = a.T
        key = ".".join([_module_name(m) for m in mods] + [_LEAF.get(leaf, leaf)])
        out[key] = torch.from_numpy(np.array(a, dtype=np.float32))  # a copy
    return out


def params_from_jax(jax_state: Any, device=None) -> ROVRState:
    """JAX ROVRState (or a mapping with its `*_params` fields) -> the port's
    ROVRState, tensors on `device` (default: the CPU)."""
    def get(field):
        if isinstance(jax_state, Mapping):
            return jax_state[field]
        return getattr(jax_state, field)

    return ROVRState(**{
        f: {k: v.to(device or "cpu") for k, v in module_params_from_jax(get(f)).items()}
        for f in ROVRState._fields
    })
