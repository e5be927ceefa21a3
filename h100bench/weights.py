"""The benchmark's weights, drawn from the seed on the device.

For each module of the program the parameter names and shapes are read
from the module itself; the values are drawn here, in one normal and one
uniform call for all modules together, on a generator of the given
device: kernels N(0, 1/fan_in) (the fan-in of an OIHW conv or an (out, in)
linear is the product of all axes but the first, of an IOHW transposed conv
in * kh * kw, of a (*in, *out) projection the product of its input axes),
the embeddings a module names in its `normal_init` N(0, std), LPIPS' `lin`
heads U(0, 0.1), biases and means zero, norm scales and variances one.
Everything is float32, the type the program keeps its parameters in.
"""

from __future__ import annotations

import math
from typing import Dict, List, Tuple

import torch
from torch import nn


def _rule(m: nn.Module, name: str, shape: Tuple[int, ...]):
    """("normal", std) | ("uniform", hi) | ("const", value) for one leaf."""
    if name in getattr(m, "normal_init", {}):
        return "normal", m.normal_init[name]
    if name.startswith("lin") and len(shape) == 1:
        return "uniform", 0.1
    if name in ("bias", "running_mean"):
        return "const", 0.0
    if name == "running_var" or (name == "weight" and len(shape) == 1):
        return "const", 1.0
    if name == "weight":
        if isinstance(m, nn.ConvTranspose2d):
            fan_in = shape[0] * shape[2] * shape[3]
        elif hasattr(m, "in_shape"):
            fan_in = math.prod(shape[:len(m.in_shape)])
        else:
            fan_in = math.prod(shape[1:])
        return "normal", fan_in ** -0.5
    raise ValueError(f"no rule to draw {type(m).__name__}.{name} {shape}")


def draw(mods: Dict[str, nn.Module], seed: int, device) -> Dict[str, Dict[str, torch.Tensor]]:
    """{module: {name: tensor}} for the named modules, from `seed`."""
    leaves: List[tuple] = []
    for mod_name, mod in mods.items():
        for sub_name, m in mod.named_modules():
            own = list(m.named_parameters(recurse=False)) + list(m.named_buffers(recurse=False))
            for name, t in own:
                key = f"{sub_name}.{name}" if sub_name else name
                leaves.append((mod_name, key, tuple(t.shape), _rule(m, name, tuple(t.shape))))
    gen = torch.Generator(device=device).manual_seed(seed % (2 ** 63))
    n_normal = sum(math.prod(s) for _, _, s, r in leaves if r[0] == "normal")
    n_uniform = sum(math.prod(s) for _, _, s, r in leaves if r[0] == "uniform")
    normal = torch.randn(n_normal, generator=gen, device=device)
    uniform = torch.rand(max(n_uniform, 1), generator=gen, device=device)
    out: Dict[str, Dict[str, torch.Tensor]] = {k: {} for k in mods}
    i = j = 0
    for mod_name, key, shape, (kind, arg) in leaves:
        n = math.prod(shape)
        if kind == "normal":
            out[mod_name][key] = (normal[i:i + n] * arg).view(shape)
            i += n
        elif kind == "uniform":
            out[mod_name][key] = (uniform[j:j + n] * arg).view(shape)
            j += n
        else:
            out[mod_name][key] = torch.full(shape, arg, device=device)
    return out
