"""The benchmark's one door into the program under test, `rovr_torch`.

Everything the benchmark takes from the port goes through here: its config
tree, its modules, its state type, the two timed entry points
(`rl.train_step` and `infer.reconstruct_clips`), the launch counters of its
kernels and the name of its profiler range. The weights are the
benchmark's own (weights.py), handed to the port as its state.
"""

from __future__ import annotations

import contextlib
from typing import Dict, List

import torch

from rovr_torch import infer
from rovr_torch.config import from_dict
from rovr_torch.ops import attention as k_attention
from rovr_torch.ops import conv as k_conv
from rovr_torch.train import rl

INIT_RANGE = "rovr/episode_init"
KERNEL_COUNTERS = {
    "K1": k_conv.fused_conv3x3,
    "K2": k_attention.flash_attention_fwd,
    "K3": k_attention.flash_attention_dq,
    "K4": k_attention.flash_attention_dkv,
}


def _tuples(x):
    if isinstance(x, dict):
        return {k: _tuples(v) for k, v in x.items()}
    return tuple(_tuples(v) for v in x) if isinstance(x, list) else x


def config(cfg_dict: dict):
    """The port's Config of a configuration file's plain tree (JSON lists
    back to the tuples the port's dataclasses hold)."""
    return from_dict(_tuples(cfg_dict))


def modules(cfg, device, dtype=None) -> rl.ROVRModules:
    return rl.make_modules(cfg, dtype=dtype, device=device)


# the modules every configuration builds, in the order their weights have
# always been drawn: a configuration with more modules draws these alike
FIRST_MODULES = ("vp", "lpips", "local_net", "actor2", "critic2")


def module_dict(mods: rl.ROVRModules) -> Dict[str, torch.nn.Module]:
    """Every module the port built (each field of `rl.ROVRModules` that is
    not None): `FIRST_MODULES`, then the others in the tuple's field order."""
    names = FIRST_MODULES + tuple(n for n in rl.ROVRModules._fields if n not in FIRST_MODULES)
    return {n: getattr(mods, n) for n in names if getattr(mods, n) is not None}


def state(weights: Dict[str, Dict[str, torch.Tensor]]) -> rl.ROVRState:
    """The port's state holding the benchmark's weights, each module's in
    its field (`rl._MODULE_STATE`), and a fresh Adam state for each module
    the state has an optimizer field for (`<module>_opt`): the policies
    the configuration trains."""
    opts = {f"{n}_opt": rl.adam_init(w) for n, w in weights.items()
            if f"{n}_opt" in rl.ROVRState._fields}
    return rl.ROVRState(**{rl._MODULE_STATE[n]: w for n, w in weights.items()}, **opts, step=0)


def launches() -> Dict[str, int]:
    return {k: fn.launches for k, fn in KERNEL_COUNTERS.items()}


def train_step(st, mods, cfg, video, org, gumbel):
    """(state, metrics, reconstructed) of one `rl.train_step`."""
    return rl.train_step(st, mods, cfg, video, org, gumbel=gumbel)


def serve(cfg, st, mods, batches):
    """`infer.reconstruct_clips`: yields (uint8 frames, actions) per batch."""
    return infer.reconstruct_clips(cfg, st, mods, batches)


@contextlib.contextmanager
def record_losses(out: Dict[str, List[torch.Tensor]]):
    """Append each PPO epoch's actor and critic loss (detached) to
    out["actor"] and out["critic"], and the critic's targets (the
    rewards-to-go, one per row) to out["targets"], while the block runs:
    `rl.actor_loss` and `rl.value_loss`, which `rl.ppo_update` calls once an
    epoch, are wrapped and return what they computed."""
    saved = rl.actor_loss, rl.value_loss

    def wrap(fn, key):
        def recording(*args, **kw):
            loss = fn(*args, **kw)
            out.setdefault(key, []).append(loss.detach())
            if key == "critic":
                out.setdefault("targets", []).append(kw.get("rtgs", args[4] if len(args) > 4 else None))
            return loss
        return recording

    rl.actor_loss, rl.value_loss = wrap(saved[0], "actor"), wrap(saved[1], "critic")
    try:
        yield out
    finally:
        rl.actor_loss, rl.value_loss = saved


@contextlib.contextmanager
def record_pairs(mods: rl.ROVRModules, out: List[torch.Tensor]):
    """Append (pairs (B, 2), their logprobs (B,)) that the actor's `act`
    returns to `out` while the block runs; the call itself is unchanged."""
    actor = mods.actor2
    act = actor.act

    def recording(*args, **kw):
        acs, logp = act(*args, **kw)
        out.append((acs, logp))
        return acs, logp

    actor.act = recording
    try:
        yield out
    finally:
        del actor.act
