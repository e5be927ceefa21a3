"""Carry weights into the port: from the JAX package, and from the
reference's torch checkpoints.

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
  * the mixture-of-experts FFN (`moe_ff`): its stacked expert parameters
    w1 (E,d,f), b1, w2 (E,f,d), b2 keep their names and layouts (the port
    multiplies them with `bmm` as they are); its `router` is a Dense.

No row permutation is needed for PolicyNet2's first final_fc layer: the
port flattens its conv trunk in the same NHWC order as the JAX package.

`pretrain_state_from_jax` and `imitation_state_from_jax` carry the other
two workloads' states (`PretrainState`, `ImitationState`) by the same
rules: their trees hold the same modules.

`episode_init_from_jax` carries a JAX `EpisodeInit` (the rollout's init:
the LPIPS baseline, the org taps, the canvas and the features), so both
packages' steps can start from the same init.

RAFT-small's tree (`raft_params`, present only when the spatio signal is
on) needs no rule of its own: its InstanceNorm `scale`/`bias` map as every
norm's do, its block names (`layer1_0`, `conv_down`) are the port's module
names, and the update cell's parameters sit once under `update`, not
stacked per iteration (flax's nn.scan broadcasts them).
"""

from __future__ import annotations

import os
import re
from typing import Any, Dict, Iterator, Mapping, Optional, Tuple

import numpy as np
import torch

from rovr_torch.train.rl import EpisodeInit, ROVRState, adam_init

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


def episode_init_from_jax(jax_init: Any, dtype: torch.dtype = torch.bfloat16,
                          device=None) -> EpisodeInit:
    """JAX `EpisodeInit` (arrays, numpy or JAX) -> the port's, on `device`
    (default: the CPU). The org taps map (B, S, h, w, c) -> (B, S, c, h, w)
    in `dtype`, the LPIPS compute dtype (the port's taps are NCHW in it,
    models/vgg_lpips.py); `curr_loss`, `canvas` and `feats` keep their
    layouts, in f32."""
    def t(a, dt=torch.float32):
        return torch.from_numpy(np.array(a, dtype=np.float32)).to(device or "cpu", dt)

    taps = jax_init.org_taps
    return EpisodeInit(
        curr_loss=None if jax_init.curr_loss is None else t(jax_init.curr_loss),
        org_taps=None if taps is None else [
            t(np.asarray(x, np.float32).transpose(0, 1, 4, 2, 3), dtype) for x in taps],
        canvas=t(jax_init.canvas), feats=t(jax_init.feats))


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


KINDS = (
    "local_net",    # UNet pretrain checkpoint -> local_net_params
    "policy2",      # imitation checkpoint -> actor2_params
    "policy1",      # pi1 checkpoint -> actor1_params
    "rovr",         # full RL state (test.py:88-93) -> several modules
    "resnet50",     # torchvision resnet50 state dict -> the VideoProcessor's backbone
    "vgg_lpips",    # pip lpips.LPIPS(net='vgg') state dict -> lpips_params
    "raft",         # torchvision raft_small state dict -> raft_params
)


def _load_state_dict(path: str) -> Dict[str, Any]:
    """torch.load a checkpoint (tensors, dicts, lists and numbers only) and
    unwrap the reference's {'model_state_dict': ...} envelope when present."""
    ckpt = torch.load(path, map_location="cpu", weights_only=True)
    if isinstance(ckpt, dict) and "model_state_dict" in ckpt:
        ckpt = ckpt["model_state_dict"]
    return dict(ckpt)


def _split_prefix(sd: Dict[str, Any], prefix: str) -> Dict[str, Any]:
    p = prefix + "."
    return {k[len(p):]: v for k, v in sd.items() if k.startswith(p)}


def _lpips_package_to_converter_inputs(sd: Dict[str, Any]) -> Tuple[Dict, Dict]:
    """pip lpips.LPIPS(net='vgg') state dict -> (vgg_state, lin_state). lpips
    registers each torchvision features module under its global index inside
    per-stage slices, so 'net.slice2.5.weight' is features.5."""
    vgg_state, lin_state = {}, {}
    for k, v in sd.items():
        if k.startswith("net.slice"):
            vgg_state["features." + k.split(".", 2)[2]] = v
        elif k.startswith("lin"):
            lin_state[k] = v
    return vgg_state, lin_state


def convert_reference_checkpoint(kind: str, path: str) -> Tuple[Dict[str, Any], Dict[str, Any]]:
    """Convert one reference checkpoint of `kind` (KINDS). Returns
    (init_params, report): init_params maps `rl.init_state` keyword names
    (local_net_params, actor2_params, ..., vp_backbone_params, raft_params,
    and lstm_cell_params, which init_state does not take) to port-layout
    state dicts on the CPU; report lists what was converted and what was
    skipped, with the converter's error (a missing key, a shape)."""
    from rovr_torch.models import action_lstm, local_net, policy_net_1, policy_net_2
    from rovr_torch.models import raft, resnet, vgg_lpips

    if kind not in KINDS:
        raise ValueError(f"unknown kind {kind!r}; expected one of {KINDS}")
    sd = _load_state_dict(path)
    out: Dict[str, Any] = {}
    report: Dict[str, Any] = {"kind": kind, "converted": [], "skipped": []}

    def attempt(name: str, fn) -> None:
        try:
            out[name] = fn()
            report["converted"].append(name)
        except (KeyError, IndexError, ValueError, RuntimeError) as e:   # reported, not silent
            report["skipped"].append(f"{name}: {type(e).__name__}: {e}")

    def lpips(state):
        return vgg_lpips.convert_lpips_weights(*_lpips_package_to_converter_inputs(state))

    if kind == "local_net":
        attempt("local_net_params", lambda: local_net.convert_torch_state_dict(sd))
    elif kind == "policy2":
        attempt("actor2_params", lambda: policy_net_2.convert_torch_state_dict(sd))
    elif kind == "policy1":
        attempt("actor1_params", lambda: policy_net_1.convert_torch_state_dict(sd))
    elif kind == "resnet50":
        attempt("vp_backbone_params", lambda: resnet.convert_torch_state_dict(sd))
    elif kind == "raft":
        attempt("raft_params", lambda: raft.convert_raft_state_dict(sd))
    elif kind == "vgg_lpips":
        attempt("lpips_params", lambda: lpips(sd))
    elif kind == "rovr":
        # the full RL state: rover.state_dict() (rovr.py:44-58)
        for name, prefix, fn in (
            ("local_net_params", "local_net", local_net.convert_torch_state_dict),
            ("actor2_params", "actor2", policy_net_2.convert_torch_state_dict),
            ("critic2_params", "critic2", policy_net_2.convert_torch_state_dict),
        ):
            sub = _split_prefix(sd, prefix)
            if sub:
                attempt(name, lambda fn=fn, sub=sub: fn(sub))
            else:
                report["skipped"].append(f"{name}: no '{prefix}.' keys")
        enc = _split_prefix(sd, "video_encoder")
        if enc:
            # ResnetFeatureExtractor = frozen resnet50 + Linear(2048->768)
            # (resnet_extractor.py:8-16): only the backbone maps onto the
            # VideoProcessor, whose projection heads differ by design
            backbone = _split_prefix(enc, "resnet") or enc
            attempt("vp_backbone_params", lambda: resnet.convert_torch_state_dict(backbone))
        hist = _split_prefix(sd, "history_encoder")
        if hist:
            attempt("lstm_cell_params", lambda: action_lstm.convert_torch_lstm_cell(hist))
        lp = _split_prefix(sd, "lpips")
        if lp:
            attempt("lpips_params", lambda: lpips(lp))
    return out, report


def merge_vp_backbone(vp_params: Dict[str, torch.Tensor],
                      backbone_params: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
    """A VideoProcessor state dict with its `backbone.` entries replaced by
    converted ResNet-50 weights (its projection heads stay: they have no
    reference twin)."""
    merged = {k: v for k, v in vp_params.items() if not k.startswith("backbone.")}
    merged.update({f"backbone.{k}": v for k, v in backbone_params.items()})
    return merged


def save_converted(out_dir: str, init_params: Dict[str, Any]) -> str:
    """Write converted state dicts as step 0 of a CheckpointManager
    directory (`torch.save`); returns its absolute path."""
    from rovr_torch.utils.checkpoint import CheckpointManager

    mgr = CheckpointManager(out_dir, max_to_keep=1)
    mgr.save(0, init_params, force=True)
    mgr.close()
    return os.path.abspath(out_dir)


def load_converted(out_dir: str) -> Optional[Dict[str, Any]]:
    """A save_converted directory back as `init_state` keyword arguments
    (CPU tensors), or None when it holds no step. A directory the JAX
    package's convert wrote (Orbax) raises: it cannot be read without JAX."""
    from rovr_torch.utils.checkpoint import CHECKPOINT_FILE, CheckpointManager

    mgr = CheckpointManager(out_dir, max_to_keep=1)
    step = mgr.latest_step()
    if step is not None and not os.path.exists(
            os.path.join(mgr.directory, str(step), CHECKPOINT_FILE)):
        raise ValueError(
            f"{out_dir}: step {step} holds no {CHECKPOINT_FILE}; an Orbax checkpoint "
            "written by `python -m rovr_tpu convert` cannot be read without JAX. "
            "Convert the reference checkpoint with `python -m rovr_torch convert`.")
    try:
        return mgr.restore()
    finally:
        mgr.close()
