"""The ROVR episode, the RL train step and its loop, PyTorch port of
rovr_tpu/train/rl.py: the module zoo, its state, the episode init, the
rollout, PPO with Adam, `train_step`, the double-buffered
`train_step_pipelined`, and `run`/`run_resilient` with checkpoints and
metrics.

The port covers both context policies (the canvas PolicyNet2 and the
attention policy of config 5) with sequential targets, the sequential
(vid2vid) baseline, the RAFT spatio signal (`log_spatio` /
`use_spatio_reward`), the `Episode/exposure` diagnostic, and the
frame-selection policy pi1 (`use_policy1`: PolicyNet1 picks each step's
target from the canvas and the ActionLSTM's history token; `ppo_policy1`
also trains it and its critic by PPO). pi1's modules, parameters and Adam
states exist only with `use_policy1`; the JAX state always carries them.
pi1's work runs under torch.profiler ranges: `rovr/pi1_act` and
`rovr/pi1_lstm` in each rollout step, `rovr/pi1_ppo` in the update; the
episode init under `rovr/episode_init`.

State and modules are split as in the JAX package: `ROVRModules` holds the
nn.Modules, `ROVRState` their parameters as state dicts (port layout, f32)
and the actors' and critics' Adam states. `bind` points the modules at a
state without copying it.

The JAX rollout is one `lax.scan`; here it is a Python loop over
`time_steps`. It syncs nothing with the host: target and context indices
stay device tensors. The working video `recon` (and the baseline's
`exp_video`) is a copy of the input in the compute dtype, written in place
one target frame per step (the JAX carry is immutable and rewritten with a
scatter); keeping it in the compute dtype, as the JAX package does, keeps
the uint8 output's LSBs in step.

PPO's epochs are a Python loop of `torch.optim.Adam` steps (optax.adam's
defaults). `ppo_update` returns a new state: the actor's and critic's
parameters are copied once per call and updated in place, and the input
state is left as it was.
"""

from __future__ import annotations

import contextlib
import os
from typing import Dict, List, NamedTuple, Optional, Tuple, Union

import numpy as np
import torch
import torch.nn.functional as F

from rovr_torch.config import Config
from rovr_torch.device import resolve
from rovr_torch.models.action_lstm import ActionLSTM
from rovr_torch.models.layers import flax_init_state
from rovr_torch.models.local_net import LocalNetUNet
from rovr_torch.models.policy_attention import AttentionContextPolicy
from rovr_torch.models.policy_net_1 import PolicyNet1, gumbel_noise
from rovr_torch.models.policy_net_2 import PolicyNet2
from rovr_torch.models.raft import RAFTSmall, pairwise_flows, total_flow_magnitude
from rovr_torch.models.vgg_lpips import LPIPS
from rovr_torch.models.video_processor import VideoProcessor, resize_bilinear
from rovr_torch.ops.metrics import context_exposure, spatio_reward
from rovr_torch.ops.ppo import critic_loss, ppo_clip_actor_loss
from rovr_torch.ops.rewards import normalized_advantage, rewards_to_go
from rovr_torch.parallel import collectives
from rovr_torch.parallel.mesh import Mesh, local_rows, shard_batch
from rovr_torch.utils.profiling import annotate, tree_tensors

Policy = Union[PolicyNet2, AttentionContextPolicy]


class ROVRModules(NamedTuple):
    vp: VideoProcessor
    actor2: Policy    # PolicyNet2 ("canvas") or AttentionContextPolicy ("attention")
    critic2: Policy
    local_net: LocalNetUNet
    lpips: LPIPS
    # RAFT for the train-time spatio signal; built only when cfg.rl.log_spatio
    # or use_spatio_reward asks for it
    raft: Optional[RAFTSmall] = None
    # pi1, V1 and the action-history LSTM; built only with cfg.rl.use_policy1
    actor1: Optional[PolicyNet1] = None
    critic1: Optional[PolicyNet1] = None
    lstm: Optional[ActionLSTM] = None


class ROVRState(NamedTuple):
    """Parameters of each module as a state dict (name -> tensor), the
    count of PPO updates, and the actors' and critics' Adam states
    ({"step": int, "exp_avg": {name: tensor}, "exp_avg_sq": {name: tensor}},
    optax.adam's (count, mu, nu)). `raft_params` is None unless the
    spatio signal is on (cfg.rl.log_spatio / use_spatio_reward); the pi1
    fields are None unless cfg.rl.use_policy1 (the LSTM is never trained:
    it has no Adam state)."""

    vp_params: Dict[str, torch.Tensor]
    actor2_params: Dict[str, torch.Tensor]
    critic2_params: Dict[str, torch.Tensor]
    local_net_params: Dict[str, torch.Tensor]
    lpips_params: Dict[str, torch.Tensor]
    step: int
    actor2_opt: dict
    critic2_opt: dict
    raft_params: Optional[Dict[str, torch.Tensor]] = None
    actor1_params: Optional[Dict[str, torch.Tensor]] = None
    critic1_params: Optional[Dict[str, torch.Tensor]] = None
    lstm_params: Optional[Dict[str, torch.Tensor]] = None
    actor1_opt: Optional[dict] = None
    critic1_opt: Optional[dict] = None


class Trajectory(NamedTuple):
    """Stacked rollout tensors, time-major (T, B, ...)."""

    obs: tuple                  # canvas: (canvas (T,B,C,C,1), target_feat (T,B,D));
                                # attention: (frame feats (T,B,S,D),)
    target_idx: torch.Tensor    # (T, B) int64; pi1's action with use_policy1
    actions: torch.Tensor       # (T, B, 2) int64
    logprobs: torch.Tensor      # (T, B)
    rtgs: Optional[torch.Tensor]  # (T, B); None without rewards
    # pi1 only (None otherwise): (canvas (T,B,C,C,1), token (T,B,C,C,1)),
    # the state pi1 acted on, before the step's tile insert; and its
    # behavior logprobs of target_idx (T, B)
    obs1: Optional[tuple] = None
    logprobs1: Optional[torch.Tensor] = None


class RolloutOut(NamedTuple):
    traj: Trajectory
    reconstructed: torch.Tensor   # (B, S, H, W, 3) in the input's dtype
    experimental: Optional[torch.Tensor]  # the sequential baseline's video, as
                                          # `reconstructed`; None when it is off
    metrics: Dict[str, torch.Tensor]


class EpisodeInit(NamedTuple):
    curr_loss: Optional[torch.Tensor]   # (B, S) LPIPS(corrupted, org)
    org_taps: Optional[List[torch.Tensor]]  # cached-stage org taps (B,S,c,h,w)
    canvas: torch.Tensor                # (B, C, C, 1)
    feats: torch.Tensor                 # (B, S, D)


_MODULE_STATE = {
    "vp": "vp_params", "actor2": "actor2_params", "critic2": "critic2_params",
    "local_net": "local_net_params", "lpips": "lpips_params", "raft": "raft_params",
    "actor1": "actor1_params", "critic1": "critic1_params", "lstm": "lstm_params",
}
_OWN_STREAM = ("raft", "actor1", "critic1", "lstm")  # drawn apart in init_state


def make_modules(cfg: Config, dtype: Optional[torch.dtype] = None,
                 device=None, mesh: Optional[Mesh] = None,
                 tensor_parallel: bool = False) -> ROVRModules:
    """Build the module zoo on `device` (CUDA unless device="cpu"; the
    mesh's device with `mesh`). `dtype` is the compute dtype (bf16 by
    default); parameters are f32.

    `mesh` (parallel.mesh) binds the attention policy to it, as the JAX
    make_modules does: ring attention (cfg.model.attn_impl "ring", over the
    model axis) and the pipeline (attn_pp_microbatches > 0) need it, and the
    MoE (attn_moe_experts > 0) on it routes over the global batch with its
    experts split over the model axis. `tensor_parallel` splits the policy's
    heads and FFN columns over the model axis (`parallel.tp.
    make_tp_train_step`). Modules bound to a mesh expect this rank's batch
    shard and run their collectives on every call."""
    dev = mesh.device if mesh is not None and device is None else resolve(device)
    dt = dtype if dtype is not None else torch.bfloat16
    m = cfg.model
    if cfg.rl.context_policy == "attention" and mesh is None and (
            m.attn_impl == "ring" or m.attn_pp_microbatches > 0):
        raise ValueError("attn_impl='ring' / attn_pp_microbatches>0 require "
                         "make_modules(mesh=...)")
    if tensor_parallel and (mesh is None or cfg.rl.context_policy != "attention"):
        raise ValueError("tensor_parallel splits the attention policy over a mesh's "
                         "model axis: it needs context_policy 'attention' and a mesh")
    mods = ROVRModules(
        vp=make_video_processor(cfg, dt),
        actor2=make_policy(cfg, dt, mesh=mesh, tensor_parallel=tensor_parallel),
        critic2=make_policy(cfg, dt, is_critic=True, mesh=mesh,
                            tensor_parallel=tensor_parallel),
        local_net=LocalNetUNet(channels=m.local_net_channels, dtype=dt),
        lpips=make_lpips(cfg, dt),
        raft=_maybe_raft(cfg, dt),
        **_maybe_policy1(cfg, dt),
    )
    for mod in mods:
        if mod is not None:
            mod.to(dev).requires_grad_(False)
    return mods


def make_policy(cfg: Config, dt: torch.dtype, is_critic: bool = False,
                mesh: Optional[Mesh] = None, tensor_parallel: bool = False) -> Policy:
    """The context policy cfg.rl.context_policy names (PolicyNet2 for
    "canvas", AttentionContextPolicy for "attention"), on the CPU; the
    attention policy bound to `mesh` (see make_modules)."""
    m = cfg.model
    if cfg.rl.context_policy == "attention":
        return AttentionContextPolicy(
            num_frames=m.pn2_num_frames, feature_dim=m.feature_dim,
            hidden_dim=m.attn_hidden_dim, num_heads=m.attn_heads,
            depth=m.attn_depth, patch_tokens=m.attn_patch_tokens,
            temperature=m.pn2_temperature, dtype=dt, attn_impl=m.attn_impl,
            pp_microbatches=m.attn_pp_microbatches,
            moe_experts=m.attn_moe_experts, moe_capacity=m.attn_moe_capacity,
            is_critic=is_critic, mesh=mesh,
            seq_axis=cfg.mesh.model_axis if m.attn_impl == "ring" else None,
            tensor_parallel=tensor_parallel,
        )
    if cfg.rl.context_policy == "canvas":
        return PolicyNet2(
            num_frames=m.pn2_num_frames, fc_dims=m.pn2_fc_dims,
            temperature=m.pn2_temperature, dtype=dt,
            per_sample_stats=m.per_sample_stats, canvas_size=m.canvas_size,
            feature_dim=m.feature_dim, is_critic=is_critic,
        )
    raise ValueError(f"unknown context_policy {cfg.rl.context_policy!r}")


def make_video_processor(cfg: Config, dt: torch.dtype) -> VideoProcessor:
    m = cfg.model
    return VideoProcessor(
        canvas_size=m.canvas_size, tile=m.canvas_tile,
        tiles_per_row=m.canvas_tiles_per_row, feature_dim=m.feature_dim,
        dtype=dt, backbone_name=m.backbone, spatial_pool=m.backbone_spatial_pool,
    )


def make_lpips(cfg: Config, dt: torch.dtype) -> LPIPS:
    return LPIPS(dtype=dt, **(dict(stages=cfg.model.lpips_stages)
                              if cfg.model.lpips_stages else {}))


def _maybe_raft(cfg: Config, dt: torch.dtype) -> Optional[RAFTSmall]:
    if not (cfg.rl.use_spatio_reward or cfg.rl.log_spatio):
        return None
    return RAFTSmall(dtype=dt)


def _maybe_policy1(cfg: Config, dt: torch.dtype) -> dict:
    """actor1, critic1 and lstm with cfg.rl.use_policy1, else nothing. The
    head covers pn1_num_frames; sampling is restricted to the clip's
    vid_length frames; PPO on pi1 (ppo_policy1) needs the noise-free
    logprob."""
    if not cfg.rl.use_policy1:
        return {}
    m = cfg.model
    pn1 = dict(num_frames=m.pn1_num_frames, channels=m.pn1_channels,
               temperature=m.pn1_temperature, dtype=dt, valid_frames=cfg.rl.vid_length,
               exact_logprob=cfg.rl.ppo_policy1, per_sample_stats=m.per_sample_stats,
               canvas_size=m.canvas_size)
    return dict(actor1=PolicyNet1(**pn1), critic1=PolicyNet1(**pn1, is_critic=True),
                lstm=ActionLSTM(hidden_dim=m.lstm_hidden_dim, token_size=m.canvas_size,
                                tile=m.canvas_tile))


def resolved_flow_size(cfg: Config) -> int:
    """The RAFT input size of the spatio path: cfg.rl.spatio_flow_size
    clamped to the smaller frame dimension (upsampling frames past their
    size adds no flow information and costs RAFT time)."""
    return min(cfg.rl.spatio_flow_size, *cfg.data.frame_size)


def adam_init(params: Dict[str, torch.Tensor]) -> dict:
    """optax.adam's initial state: count 0, zero moments."""
    return {"step": 0,
            "exp_avg": {k: torch.zeros_like(v) for k, v in params.items()},
            "exp_avg_sq": {k: torch.zeros_like(v) for k, v in params.items()}}


def init_state(cfg: Config, mods: ROVRModules, seed: int,
               local_net_params: Optional[Dict[str, torch.Tensor]] = None,
               vp_params: Optional[Dict[str, torch.Tensor]] = None,
               actor2_params: Optional[Dict[str, torch.Tensor]] = None,
               lpips_params: Optional[Dict[str, torch.Tensor]] = None,
               critic2_params: Optional[Dict[str, torch.Tensor]] = None,
               vp_backbone_params: Optional[Dict[str, torch.Tensor]] = None,
               raft_params: Optional[Dict[str, torch.Tensor]] = None,
               actor1_params: Optional[Dict[str, torch.Tensor]] = None) -> ROVRState:
    """Fresh parameters from `seed`, drawn as the JAX package's flax
    initializers draw them (lecun-normal kernels, zero biases, LPIPS lins
    U(0, 0.1), N(0, 0.02) attention embeddings), on the modules' device,
    and fresh Adam states. torch's draws differ from JAX's.

    Pretrained or warm-started parameters plug in by argument, each a
    state dict in the port's layout (`utils.convert`). `vp_backbone_params`
    replaces only the VideoProcessor's backbone. A given module's draws are
    still made, so the others' do not depend on what was given; RAFT draws
    from a stream of its own (seed + 99), and pi1's modules (actor1, critic1,
    lstm, with cfg.rl.use_policy1) from another (seed + 98), so turning the
    spatio signal or pi1 on changes no other module's parameters."""
    gen = torch.Generator().manual_seed(seed)
    given = {"local_net_params": local_net_params, "vp_params": vp_params,
             "actor2_params": actor2_params, "lpips_params": lpips_params,
             "critic2_params": critic2_params}
    params = {}
    for name, mod in zip(ROVRModules._fields, mods):
        if name in _OWN_STREAM:
            continue
        field = _MODULE_STATE[name]
        fresh = flax_init_state(mod, gen)
        params[field] = _given(field, given[field], fresh)
    if vp_backbone_params is not None:
        vp = params["vp_params"]
        bb = _given("vp_backbone_params",
                    {f"backbone.{k}": v for k, v in vp_backbone_params.items()},
                    {k: v for k, v in vp.items() if k.startswith("backbone.")})
        params["vp_params"] = {**vp, **bb}
    if mods.raft is not None:
        fresh = flax_init_state(mods.raft, torch.Generator().manual_seed(seed + 99))
        params["raft_params"] = _given("raft_params", raft_params, fresh)
    elif raft_params is not None:
        raise ValueError("raft_params given but the spatio signal is off "
                         "(cfg.rl.log_spatio / use_spatio_reward)")
    if mods.actor1 is not None:
        gen1 = torch.Generator().manual_seed(seed + 98)
        for name in ("actor1", "critic1", "lstm"):
            params[f"{name}_params"] = flax_init_state(getattr(mods, name), gen1)
        params["actor1_params"] = _given("actor1_params", actor1_params,
                                         params["actor1_params"])
        params["actor1_opt"] = adam_init(params["actor1_params"])
        params["critic1_opt"] = adam_init(params["critic1_params"])
    elif actor1_params is not None:
        raise ValueError("actor1_params given but pi1 is off (cfg.rl.use_policy1)")
    return ROVRState(**params, step=0,
                     actor2_opt=adam_init(params["actor2_params"]),
                     critic2_opt=adam_init(params["critic2_params"]))


def _given(field: str, given: Optional[Dict[str, torch.Tensor]],
           fresh: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
    """`given` on `fresh`'s device, checked against its keys and shapes; or
    `fresh` when nothing was given."""
    if given is None:
        return fresh
    want = {k: tuple(v.shape) for k, v in fresh.items()}
    got = {k: tuple(v.shape) for k, v in given.items()}
    if want != got:
        bad = sorted(k for k in set(want) | set(got) if want.get(k) != got.get(k))
        raise ValueError(f"{field} do not match the module: {bad[:8]}")
    return {k: torch.as_tensor(v, dtype=torch.float32).to(fresh[k].device)
            for k, v in given.items()}


def _tree_to(tree, device):
    if isinstance(tree, dict):
        return {k: _tree_to(v, device) for k, v in tree.items()}
    return tree.to(device) if isinstance(tree, torch.Tensor) else tree


def state_to(state: ROVRState, device) -> ROVRState:
    return ROVRState(*[_tree_to(x, device) for x in state])


def bind(mods: ROVRModules, state: ROVRState,
         names: Tuple[str, ...] = ROVRModules._fields) -> None:
    """Make each module of `names` use the state's tensors (no copy when
    they are on the module's device already)."""
    for name in names:
        mod, params = getattr(mods, name), getattr(state, _MODULE_STATE[name])
        if mod is None or params is None:
            continue
        dev = next(mod.parameters()).device
        mod.load_state_dict({k: v.to(dev) for k, v in params.items()},
                            strict=True, assign=True)
        mod.requires_grad_(False)


def _write_frame(video: torch.Tensor, idx: torch.Tensor, frame: torch.Tensor) -> None:
    """In place: video[b, idx[b]] = frame[b]."""
    video[torch.arange(video.shape[0], device=video.device), idx] = frame


def _gather_frames(video: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """(B, K, H, W, 3) frames of (B, S, H, W, 3) at per-sample indices (B, K)."""
    return video[torch.arange(video.shape[0], device=video.device)[:, None], idx]


_LPIPS_CHUNK = 64  # frames per LPIPS call in per_frame_lpips


def per_frame_lpips(mods: ROVRModules, lpips_params: Dict[str, torch.Tensor],
                    video: torch.Tensor, org_video: torch.Tensor) -> torch.Tensor:
    """(B, S, H, W, 3) x2 -> (B, S) LPIPS table, `_LPIPS_CHUNK` frames per
    call (each frame's distance is its own, so the chunks change only the
    peak memory)."""
    b, s = video.shape[:2]
    dev = next(mods.lpips.parameters()).device
    mods.lpips.load_state_dict({k: v.to(dev) for k, v in lpips_params.items()},
                               strict=True, assign=True)
    mods.lpips.requires_grad_(False)
    flat = video.reshape((b * s,) + tuple(video.shape[2:]))
    flat_org = org_video.reshape((b * s,) + tuple(org_video.shape[2:]))
    d = [mods.lpips(flat[i:i + _LPIPS_CHUNK], flat_org[i:i + _LPIPS_CHUNK])
         for i in range(0, b * s, _LPIPS_CHUNK)]
    return torch.cat(d).reshape(b, s)


_INIT_MODULES = ("lpips", "vp")   # the frozen modules episode_init reads


@torch.no_grad()
@annotate("rovr/episode_init")
def episode_init(state: ROVRState, mods: ROVRModules, cfg: Config,
                 video: torch.Tensor, org_video: torch.Tensor,
                 rewards: bool = True) -> EpisodeInit:
    """The per-frame LPIPS baseline and the cached original-frame taps
    (skipped without rewards), then the VideoProcessor state encode of
    the frames resized to 224 (the JAX `episode_init_jit`). It reads only
    the frozen modules, LPIPS and the VideoProcessor, and binds only those,
    so it commutes with a PPO update of the same state."""
    bind(mods, state, _INIT_MODULES)
    b, s = video.shape[:2]
    curr_loss = org_taps = None
    if rewards:
        cache_from = cfg.model.lpips_cache_from_stage
        chunk = cfg.model.lpips_init_chunk
        if not (0 < chunk < s and s % chunk == 0):
            chunk = s
        parts = []
        for i in range(0, s, chunk):
            v = video[:, i:i + chunk].reshape((b * chunk,) + video.shape[2:])
            o = org_video[:, i:i + chunk].reshape((b * chunk,) + video.shape[2:])
            o_taps = mods.lpips.taps(o)
            d = mods.lpips.distance_from_taps(mods.lpips.taps(v), o_taps)
            parts.append((d.reshape(b, chunk), [
                t.reshape((b, chunk) + t.shape[1:]) for t in o_taps[cache_from:]
            ]))
        curr_loss = torch.cat([p[0] for p in parts], dim=1)
        org_taps = [torch.cat(ts, dim=1) for ts in zip(*[p[1] for p in parts])]
    frames224 = resize_bilinear(
        video.reshape((b * s,) + video.shape[2:]), (224, 224)
    ).reshape(b, s, 224, 224, 3)
    canvas, feats = mods.vp(frames224)
    return EpisodeInit(curr_loss, org_taps, canvas, feats)


def _policy_act(mods: ROVRModules, cfg: Config, obs, tgt, gumbel=None,
                generator=None):
    """actor2.act over the configured context policy (greedy per cfg)."""
    return mods.actor2.act(*obs, tgt, greedy=cfg.rl.greedy, gumbel=gumbel,
                           generator=generator)


def _policy_logprob(mods: ROVRModules, obs, tgt, acs, gumbel=None, generator=None):
    """actor2.logprob of stored actions with fresh Gumbel noise."""
    return mods.actor2.logprob(*obs, tgt, acs, gumbel=gumbel, generator=generator)


def _policy_value(mods: ROVRModules, cfg: Config, obs, tgt):
    """critic2.value; the attention critic also reads the target index."""
    if cfg.rl.context_policy == "attention":
        return mods.critic2.value(*obs, tgt)
    return mods.critic2.value(*obs)


@torch.no_grad()
def rollout(state: ROVRState, mods: ROVRModules, cfg: Config,
            video: torch.Tensor, org_video: torch.Tensor,
            generator: Optional[torch.Generator] = None,
            rewards: bool = True,
            gumbel: Optional[torch.Tensor] = None,
            init: Optional[EpisodeInit] = None,
            gumbel1: Optional[torch.Tensor] = None,
            mesh: Optional[Mesh] = None) -> RolloutOut:
    """The episode (ROVR.forward), gradient-free. With a data `mesh` the
    batch is this rank's shard and the policies' batch statistics are the
    global batch's (`collectives.global_batch`); the metrics stay this
    shard's.

    video/org_video: (B, S, H, W, 3) in [0,1]. When cfg.rl.greedy is off the
    Gumbel noise is `gumbel` (T, B, S), or is drawn from `generator`
    (default: seeded from cfg.run.seed). With cfg.rl.use_policy1, pi1 picks
    each step's target (sampled whatever cfg.rl.greedy says, as in the JAX
    package) from the canvas and the LSTM token, with the noise `gumbel1`
    (T, B, pn1_num_frames) or drawn from `generator` before pi2's; after the
    tile insert the LSTM reads the chosen frames' tiles of the new canvas.
    The target stays on the device. `rewards=False` skips the LPIPS
    reward path in the init and in every step, and the spatio signal, which
    is what XLA's dead-code elimination does to a JAX graph that drops
    them; the trajectory then has no rewards-to-go and `metrics` is empty.
    `init`: this batch's `episode_init`, computed by the caller (with the
    same `rewards`).

    cfg.rl.sequential_baseline also reconstructs every target from the
    contexts (t-2, t-1) mod S, in that stack order, gathered from the
    corrupted video (from its own reconstruction with recon_context), into
    `experimental`; it never feeds the rewards. cfg.rl.log_spatio adds the
    RAFT flow recovery of the reconstruction, `Episode/spatio`, and the
    mean over the clips of the total flow magnitude of the reconstruction,
    the original and the corrupted clip it is taken from,
    `Episode/phi_recon`, `Episode/phi_org`, `Episode/phi_corrupted`;
    use_spatio_reward also adds spatio to the last step's reward before the
    rewards-to-go.
    """
    with collectives.global_batch(mesh), annotate("rovr/rollout"):
        return _rollout(state, mods, cfg, video, org_video, generator, rewards, gumbel,
                        init, gumbel1)


def _rollout(state, mods, cfg, video, org_video, generator, rewards, gumbel, init,
             gumbel1) -> RolloutOut:
    rl = cfg.rl
    b, s = video.shape[:2]
    dev = video.device
    attention = rl.context_policy == "attention"
    cache_from = cfg.model.lpips_cache_from_stage
    policy1 = rl.use_policy1
    if policy1 and (mods.actor1 is None or state.actor1_params is None):
        raise ValueError("cfg.rl.use_policy1 needs make_modules and init_state built "
                         "with the same cfg (mods.actor1, actor1_params)")
    draws = ((not rl.greedy and gumbel is None) or (policy1 and gumbel1 is None))
    if draws and generator is None:
        generator = torch.Generator(device=dev).manual_seed(cfg.run.seed)

    if init is None:
        init = episode_init(state, mods, cfg, video, org_video, rewards)  # binds its own
        bind(mods, state, tuple(n for n in ROVRModules._fields if n not in _INIT_MODULES))
    else:
        bind(mods, state)
    cvs, fts = init.canvas, init.feats
    cl = init.curr_loss.clone() if rewards else None

    video_cd = video.to(mods.local_net.dtype)
    recon = video_cd.clone()
    exp_video = video_cd.clone() if rl.sequential_baseline else None
    ar = torch.arange(b, device=dev)
    ys = {k: [] for k in ("obs", "tgt", "acs", "logp", "marginal", "lpips", "mse",
                          "obs1", "logp1")}
    if policy1:
        lstm_c = mods.lstm.init_carry(b)
        token = torch.zeros(b, mods.lstm.token_size, mods.lstm.token_size, 1, device=dev)
    for t in range(rl.time_steps):
        if policy1:
            ys["obs1"].append((cvs, token))
            with annotate("rovr/pi1_act"):
                tgt, lp1 = mods.actor1.act(cvs, token,
                                           None if gumbel1 is None else gumbel1[t], generator)
            ys["logp1"].append(lp1)
        else:
            tgt = torch.full((b,), t % s, dtype=torch.long, device=dev)
        obs = (fts,) if attention else (cvs, fts[ar, tgt])
        ys["obs"].append(obs)
        noise = None if (rl.greedy or gumbel is None) else gumbel[t]
        with annotate("rovr/rollout/policy"):
            acs, logp = _policy_act(mods, cfg, obs, tgt, noise, generator)

        with annotate("rovr/rollout/unet"):
            frame_src = recon if rl.recon_context else video_cd
            y_hat = mods.local_net(frame_src[ar, tgt], _gather_frames(frame_src, acs))
            if rl.sequential_baseline:
                seq_idx = torch.stack([(tgt - 2) % s, (tgt - 1) % s], dim=1)
                exp_src = exp_video if rl.recon_context else video_cd
                exp_hat = mods.local_net(exp_src[ar, tgt], _gather_frames(exp_src, seq_idx))
                _write_frame(exp_video, tgt, exp_hat.to(exp_video.dtype))

        if rewards:
            with annotate("rovr/rollout/reward"):
                org_tgt = org_video[ar, tgt]
                early = (mods.lpips.taps(org_tgt, limit=cache_from)
                         if cache_from > 0 else [])
                lpips_now = mods.lpips.distance_from_taps(
                    mods.lpips.taps(y_hat), early + [o[ar, tgt] for o in init.org_taps]
                )
                ys["marginal"].append(-(lpips_now - cl[ar, tgt]))
                cl[ar, tgt] = lpips_now
                ys["lpips"].append(lpips_now)
                ys["mse"].append(((y_hat - org_tgt) ** 2).mean((1, 2, 3)))

        with annotate("rovr/rollout/reencode"):
            _write_frame(recon, tgt, y_hat.to(recon.dtype))
            cvs, new_feat = mods.vp.insert_encoded_frame_batch(tgt, y_hat, cvs)
            if attention:
                # keep the per-frame feature table in step with the written frame
                # (JAX rl.py:628-633); out of place: ys holds the old table
                fts = fts.index_put((ar, tgt), new_feat.to(fts.dtype))
        if policy1:
            with annotate("rovr/pi1_lstm"):
                chosen = torch.cat([tgt[:, None], acs], 1)
                lstm_c, token = mods.lstm(lstm_c, chosen, mods.vp.extract_patch(chosen, cvs))
        ys["tgt"].append(tgt)
        ys["acs"].append(acs)
        ys["logp"].append(logp)

    recon = recon.to(video.dtype)
    target_idx = torch.stack(ys["tgt"])
    rtgs, metrics = None, {}
    if rewards:
        marginal = torch.stack(ys["marginal"])  # (T, B)
        spatio = None
        if rl.use_spatio_reward or rl.log_spatio:
            with annotate("rovr/rollout/spatio"):
                spatio, phis = _spatio(state, mods, cfg, recon, org_video, video)  # (B,)
            if rl.use_spatio_reward:
                marginal[-1] += spatio
        rtgs = rewards_to_go(marginal, rl.gamma)
        # distinct frames reconstructed per episode / steps
        distinct = F.one_hot(target_idx, s).any(0).sum(1)
        metrics = {
            "Episode/lpips_loss": torch.stack(ys["lpips"]).mean(),
            "Episode/mse_loss": torch.stack(ys["mse"]).mean(),
            "Episode/mean_reward": marginal.mean(),
            "Episode/return": marginal.sum(0).mean(),
            "Episode/coverage": (distinct / rl.time_steps).mean(),
        }
        if spatio is not None:
            metrics["Episode/spatio"] = spatio.mean()
            metrics.update({f"Episode/phi_{k}": v.mean() for k, v in phis.items()})
    traj = Trajectory(
        obs=tuple(torch.stack(x) for x in zip(*ys["obs"])),
        target_idx=target_idx, actions=torch.stack(ys["acs"]),
        logprobs=torch.stack(ys["logp"]), rtgs=rtgs,
        obs1=tuple(torch.stack(x) for x in zip(*ys["obs1"])) if policy1 else None,
        logprobs1=torch.stack(ys["logp1"]) if policy1 else None,
    )
    experimental = None if exp_video is None else exp_video.to(video.dtype)
    return RolloutOut(traj, recon, experimental, metrics)


def _spatio(state: ROVRState, mods: ROVRModules, cfg: Config, recon: torch.Tensor,
            org_video: torch.Tensor, video: torch.Tensor):
    """The spatio signal (B,): RAFT flow recovery of the reconstruction
    toward the original, relative to the corrupted clip, times spatio_scale;
    and the total flow magnitudes (B,) it is taken from, under `recon`,
    `org` and `corrupted`."""
    if mods.raft is None or state.raft_params is None:
        raise ValueError("cfg.rl.use_spatio_reward/log_spatio need make_modules and "
                         "init_state built with the same cfg (mods.raft, raft_params)")
    size = resolved_flow_size(cfg)

    def phi(v):
        return total_flow_magnitude(pairwise_flows(mods.raft, v, size))[0]

    phis = {"recon": phi(recon), "org": phi(org_video), "corrupted": phi(video)}
    return spatio_reward(phis["recon"], phis["org"], phis["corrupted"], cfg.rl.spatio_scale), phis


def _flat(x: torch.Tensor) -> torch.Tensor:
    """(T, B, ...) -> (B*T, ...), batch-major (JAX rl.py:733-740)."""
    return x.transpose(0, 1).reshape((-1,) + tuple(x.shape[2:]))


def actor_loss(mods: ROVRModules, cfg: Config, obs, tgt, acs, old_logp, adv,
               gumbel=None, generator=None) -> torch.Tensor:
    """PPO-clip loss of the bound actor on flattened trajectory tensors."""
    logp = _policy_logprob(mods, obs, tgt, acs, gumbel, generator)
    return ppo_clip_actor_loss(logp, old_logp, adv, cfg.rl.clip)


def value_loss(mods: ROVRModules, cfg: Config, obs, tgt, rtgs) -> torch.Tensor:
    """MSE of the bound critic's values against the rewards-to-go."""
    return critic_loss(_policy_value(mods, cfg, obs, tgt), rtgs)


def _trainable(mod: torch.nn.Module, params: Dict[str, torch.Tensor]):
    """Bind a copy of `params` to `mod` with gradients on; returns the
    module's (name, parameter) list, in a fixed order."""
    dev = next(mod.parameters()).device
    mod.load_state_dict({k: v.detach().to(dev, copy=True) for k, v in params.items()},
                        strict=True, assign=True)
    mod.requires_grad_(True)
    return list(mod.named_parameters())


def _adam(named, opt_state: dict, lr: float) -> torch.optim.Adam:
    """torch.optim.Adam (optax.adam's defaults) resumed from `opt_state`."""
    opt = torch.optim.Adam([p for _, p in named], lr=lr)
    if opt_state["step"] > 0:
        for name, p in named:
            opt.state[p] = {
                "step": torch.tensor(float(opt_state["step"])),
                "exp_avg": opt_state["exp_avg"][name].to(p.device, copy=True),
                "exp_avg_sq": opt_state["exp_avg_sq"][name].to(p.device, copy=True),
            }
    return opt


def _adam_step(opt: torch.optim.Adam, named) -> None:
    """One Adam step. A parameter the loss does not reach (a trunk conv's
    bias that the norm cancels) gets a zero gradient, as under jax.grad, so
    every moment and count advances as optax's do."""
    for _, p in named:
        if p.grad is None:
            p.grad = torch.zeros_like(p)
    opt.step()


def _adam_state(opt: torch.optim.Adam, named) -> dict:
    """The optimizer's state in ROVRState's form."""
    return {
        "step": int(opt.state[named[0][1]]["step"]),
        "exp_avg": {n: opt.state[p]["exp_avg"] for n, p in named},
        "exp_avg_sq": {n: opt.state[p]["exp_avg_sq"] for n, p in named},
    }


def ppo_update(state: ROVRState, mods: ROVRModules, cfg: Config,
               traj: Trajectory, generator: Optional[torch.Generator] = None,
               gumbel: Optional[torch.Tensor] = None, mesh: Optional[Mesh] = None
               ) -> Tuple[ROVRState, Dict[str, torch.Tensor]]:
    """PPO-clip on actor2/critic2 (ROVR.ppo): the advantage from rtg - V(obs)
    normalized once, then n_updates_per_ppo epochs, each an actor Adam step
    and then a critic Adam step. The actor's fresh Gumbel noise is
    `gumbel` (n_updates, B*T, S) in `_flat`'s row order, or is drawn from
    `generator` (default: seeded from cfg.run.seed + 1).

    With cfg.rl.use_policy1 and ppo_policy1, then the same on actor1/critic1
    over the trajectory's obs1 and target_idx, from the same rewards-to-go,
    on their own Adam states (`PPO/actor1_loss`, `PPO/critic1_loss`). Its
    logprob is the noise-free one (exact mode), so it draws no noise. Every
    PPO batch is the whole B*T rows: pi1's norms take the batch's
    statistics, so splitting it would change the result.

    With a data `mesh` the trajectory is this rank's shard: the advantage
    is normalized over the global batch, the batch statistics are global,
    and every gradient is averaged over the ranks before its Adam step, so
    every rank's parameters and Adam states stay identical. The returned
    losses are this shard's."""
    with collectives.global_batch(mesh), annotate("rovr/ppo_update"):
        return _ppo_update(state, mods, cfg, traj, generator, gumbel, mesh)


def _pmean_grads(named, mesh: Optional[Mesh]) -> None:
    if mesh is not None:
        collectives.pmean_grads([p for _, p in named], mesh)


def _ppo_update(state, mods, cfg, traj, generator, gumbel, mesh):
    rl = cfg.rl
    obs = tuple(_flat(x) for x in traj.obs)
    tgt, acs = _flat(traj.target_idx), _flat(traj.actions)
    old_logp, rtgs = _flat(traj.logprobs), _flat(traj.rtgs)
    if gumbel is None and generator is None:
        generator = torch.Generator(device=tgt.device).manual_seed(cfg.run.seed + 1)

    a_named = _trainable(mods.actor2, state.actor2_params)
    c_named = _trainable(mods.critic2, state.critic2_params)
    with torch.no_grad():
        adv = normalized_advantage(rtgs, _policy_value(mods, cfg, obs, tgt), mesh=mesh)
    a_opt = _adam(a_named, state.actor2_opt, rl.actor_lr)
    c_opt = _adam(c_named, state.critic2_opt, rl.critic_lr)
    for e in range(rl.n_updates_per_ppo):
        noise = None if gumbel is None else gumbel[e]
        a_opt.zero_grad(set_to_none=True)
        a_loss = actor_loss(mods, cfg, obs, tgt, acs, old_logp, adv, noise, generator)
        a_loss.backward()
        _pmean_grads(a_named, mesh)
        _adam_step(a_opt, a_named)
        c_opt.zero_grad(set_to_none=True)
        c_loss = value_loss(mods, cfg, obs, tgt, rtgs)
        c_loss.backward()
        _pmean_grads(c_named, mesh)
        _adam_step(c_opt, c_named)
    for mod in (mods.actor2, mods.critic2):
        mod.requires_grad_(False)
    state = state._replace(
        step=state.step + 1,
        actor2_params={n: p.detach() for n, p in a_named},
        critic2_params={n: p.detach() for n, p in c_named},
        actor2_opt=_adam_state(a_opt, a_named),
        critic2_opt=_adam_state(c_opt, c_named),
    )
    metrics = {"PPO/actor_loss": a_loss.detach(), "PPO/critic_loss": c_loss.detach()}
    if rl.use_policy1 and rl.ppo_policy1 and traj.obs1 is not None:
        with annotate("rovr/pi1_ppo"):
            state, m1 = _ppo_policy1(state, mods, cfg, traj, rtgs, generator, mesh)
        metrics.update(m1)
    return state, metrics


def _ppo_policy1(state: ROVRState, mods: ROVRModules, cfg: Config, traj: Trajectory,
                 rtgs: torch.Tensor, generator: Optional[torch.Generator],
                 mesh: Optional[Mesh] = None):
    """PPO-clip on pi1/V1 (JAX rl.py's second epoch scan): V1 on the
    flattened obs1 for the normalized advantage, then n_updates_per_ppo
    epochs of an actor1 Adam step and a critic1 Adam step."""
    rl = cfg.rl
    obs1 = tuple(_flat(x) for x in traj.obs1)
    act1, old_lp1 = _flat(traj.target_idx), _flat(traj.logprobs1)
    a_named = _trainable(mods.actor1, state.actor1_params)
    c_named = _trainable(mods.critic1, state.critic1_params)
    with torch.no_grad():
        adv = normalized_advantage(rtgs, mods.critic1.value(*obs1), mesh=mesh)
    a_opt = _adam(a_named, state.actor1_opt, rl.actor_lr)
    c_opt = _adam(c_named, state.critic1_opt, rl.critic_lr)
    for _ in range(rl.n_updates_per_ppo):
        a_opt.zero_grad(set_to_none=True)
        a_loss = ppo_clip_actor_loss(
            mods.actor1.logprob(*obs1, act1, generator=generator), old_lp1, adv, rl.clip)
        a_loss.backward()
        _pmean_grads(a_named, mesh)
        _adam_step(a_opt, a_named)
        c_opt.zero_grad(set_to_none=True)
        c_loss = critic_loss(mods.critic1.value(*obs1), rtgs)
        c_loss.backward()
        _pmean_grads(c_named, mesh)
        _adam_step(c_opt, c_named)
    for mod in (mods.actor1, mods.critic1):
        mod.requires_grad_(False)
    state = state._replace(
        actor1_params={n: p.detach() for n, p in a_named},
        critic1_params={n: p.detach() for n, p in c_named},
        actor1_opt=_adam_state(a_opt, a_named),
        critic1_opt=_adam_state(c_opt, c_named),
    )
    return state, {"PPO/actor1_loss": a_loss.detach(),
                   "PPO/critic1_loss": c_loss.detach()}


@annotate("rovr/train_step")
def train_step(state: ROVRState, mods: ROVRModules, cfg: Config,
               video: torch.Tensor, org_video: torch.Tensor,
               generator: Optional[torch.Generator] = None,
               gumbel: Optional[Tuple[torch.Tensor, torch.Tensor]] = None,
               masks: Optional[torch.Tensor] = None,
               gumbel1: Optional[torch.Tensor] = None,
               mesh: Optional[Mesh] = None):
    """One RL step: rollout with rewards, then PPO (ROVR.train). Returns
    (state, metrics, reconstructed).

    `video`/`org_video` (B, S, H, W, 3) are uint8, divided by 255 on the
    device, or float in [0, 1]. The Gumbel noise of the rollout and of PPO
    comes from `generator` (default: seeded from cfg.run.seed), or is given
    as `gumbel` = (rollout noise (T, B, S), PPO noise (n_updates, B*T, S));
    pi1's rollout noise (cfg.rl.use_policy1) as `gumbel1` (T, B,
    pn1_num_frames).
    `masks` (B, S, H, W, C), 1 where the frame kept its content, adds
    `Episode/exposure`: the share of the targets' hole pixels that a chosen
    context frame exposes."""
    dev = next(mods.local_net.parameters()).device
    video, org_video = (torch.as_tensor(x).to(dev) for x in (video, org_video))
    if video.dtype == torch.uint8:
        video = video.float() * (1.0 / 255.0)
    if org_video.dtype == torch.uint8:
        org_video = org_video.float() * (1.0 / 255.0)
    if gumbel is None and generator is None:
        generator = torch.Generator(device=dev).manual_seed(cfg.run.seed)
    g_roll, g_ppo = gumbel if gumbel is not None else (None, None)
    out = rollout(state, mods, cfg, video, org_video, generator, True, g_roll,
                  gumbel1=gumbel1, mesh=mesh)
    state, ppo_metrics = ppo_update(state, mods, cfg, out.traj, generator, g_ppo, mesh)
    metrics = dict(out.metrics)
    metrics.update(ppo_metrics)
    if mesh is not None:   # equal shards: the mean of the shards' means
        metrics = collectives.pmean_dict(metrics, mesh)
    if masks is not None:
        hole = 1.0 - torch.as_tensor(masks).to(dev)[..., :1].float()
        metrics["Episode/exposure"] = context_exposure(
            hole, out.traj.target_idx, out.traj.actions, mesh)
    return state, metrics, out.reconstructed


_PIPELINE_STREAMS: Dict[torch.device, Tuple[torch.cuda.Stream, torch.cuda.Stream]] = {}


def _pipeline_streams(dev: torch.device) -> Tuple[torch.cuda.Stream, torch.cuda.Stream]:
    """(the pipelined step's own stream, the next init's stream) of `dev`,
    made once. The step's runs at a higher priority than the init's (the
    default, lowest): at the same priority the block scheduler queues the
    rollout's small kernels behind every conv of the init."""
    if dev not in _PIPELINE_STREAMS:
        _PIPELINE_STREAMS[dev] = (torch.cuda.Stream(dev, priority=-1), torch.cuda.Stream(dev))
    return _PIPELINE_STREAMS[dev]


def _float_clip(x, dev: torch.device) -> torch.Tensor:
    x = torch.as_tensor(x)
    if x.dtype == torch.uint8:
        raise TypeError("train_step_pipelined takes float clips in [0, 1], as the JAX one "
                        "does; train_step takes uint8 clips and divides them by 255")
    return x.to(dev)


def _enqueue_episode_init(state: ROVRState, mods: ROVRModules, cfg: Config,
                          video: torch.Tensor, org_video: torch.Tensor):
    """`episode_init` of a batch, on a CUDA device enqueued on the device's
    init stream (`_pipeline_streams`) behind the work already on the
    caller's stream. Returns (init, the event recorded after it; None on
    the CPU, where it runs in line).

    The clips are tied to the init's stream and the init's tensors to the
    caller's (`record_stream`), so the caching allocator hands neither to
    the other stream's work while it may still be read."""
    if video.device.type != "cuda":
        return episode_init(state, mods, cfg, video, org_video), None
    consumer = torch.cuda.current_stream(video.device)
    side = _pipeline_streams(video.device)[1]
    side.wait_stream(consumer)
    for x in (video, org_video):
        x.record_stream(side)
    with torch.cuda.stream(side):
        init = episode_init(state, mods, cfg, video, org_video)
        ready = torch.cuda.Event()
        ready.record(side)
    for t in tree_tensors(init):
        t.record_stream(consumer)
    return init, ready


@annotate("rovr/train_step")
def train_step_pipelined(state: ROVRState, mods: ROVRModules, cfg: Config,
                         init: EpisodeInit, video, org_video, next_video, next_org_video,
                         generator: Optional[torch.Generator] = None,
                         gumbel: Optional[Tuple[torch.Tensor, torch.Tensor]] = None,
                         gumbel1: Optional[torch.Tensor] = None):
    """The double-buffered RL step (the JAX `train_step_pipelined`): the
    rollout of batch i from its precomputed `init`, then PPO, and batch
    i+1's `episode_init`. Returns (state, metrics, reconstructed,
    next_init); the state, metrics and reconstruction are `train_step`'s on
    batch i with the same noise, and `next_init` is `episode_init` of batch
    i+1 (it reads only the frozen LPIPS and VideoProcessor, which PPO does
    not touch).

    Clips (B, S, H, W, 3) are float in [0, 1]; uint8 raises TypeError (the
    JAX function feeds whatever it is given to LPIPS). The noise is drawn
    as `train_step` draws it: from `generator` (default: seeded from
    cfg.run.seed), or given as `gumbel` = (rollout (T, B, S), PPO
    (n_updates, B*T, S)) and, with cfg.rl.use_policy1, `gumbel1`. No mesh
    and no masks, as in the JAX function.

    On a CUDA device, from this one thread, the next init is enqueued
    first on a stream of its own, then the rollout and PPO on a stream of
    higher priority (`_pipeline_streams`), so the init's convs fill the
    SMs that the rollout's small kernels leave idle. Both streams start
    behind the caller's, and before returning the caller's stream waits on
    both: what the step returns, `next_init` included (like one from
    `episode_init`), is safe to read on the caller's stream. On the CPU it
    all runs in line."""
    dev = next(mods.local_net.parameters()).device
    video, org_video, next_video, next_org_video = (
        _float_clip(x, dev) for x in (video, org_video, next_video, next_org_video))
    if gumbel is None and generator is None:
        generator = torch.Generator(device=dev).manual_seed(cfg.run.seed)
    g_roll, g_ppo = gumbel if gumbel is not None else (None, None)
    next_init, ready = _enqueue_episode_init(state, mods, cfg, next_video, next_org_video)
    cuda = dev.type == "cuda"
    if cuda:
        consumer = torch.cuda.current_stream(dev)
        own = _pipeline_streams(dev)[0]
        own.wait_stream(consumer)
    with torch.cuda.stream(own) if cuda else contextlib.nullcontext():
        out = rollout(state, mods, cfg, video, org_video, generator, True, g_roll, init=init,
                      gumbel1=gumbel1)
        new_state, ppo_metrics = ppo_update(state, mods, cfg, out.traj, generator, g_ppo)
    metrics = dict(out.metrics)
    metrics.update(ppo_metrics)
    if cuda:
        consumer.wait_stream(own)
        consumer.wait_event(ready)
        for t in tree_tensors((new_state, metrics, out.reconstructed)):
            t.record_stream(consumer)
    return new_state, metrics, out.reconstructed, next_init


def make_sharded_train_step(mesh: Mesh, mods: ROVRModules, cfg: Config):
    """The train step over `mesh` (the JAX package's
    `make_sharded_train_step`, which runs `train_step` on the global batch
    with GSPMD). Returns step(state, video, org_video, generator=None,
    gumbel=None, masks=None, gumbel1=None) -> (state, metrics, this rank's
    reconstructions).

    Every rank passes the same global batch (B divisible by the data axis)
    and the same state (`parallel.mesh.replicate`); each takes its B/size
    clips. The Gumbel noise is the global draw, given (`gumbel` = (rollout
    (T, B, S), PPO (n_updates, B*T, S)), `gumbel1` (T, B, pn1_num_frames))
    or drawn from `generator` (default: seeded from cfg.run.seed on the
    mesh's device), sliced to this rank's rows. The batch statistics, the
    advantage and the metrics are the global batch's and the gradients are
    averaged before every Adam step (pi2's actor and critic, pi1's and V1's
    with use_policy1), so the step equals `train_step` on the global batch
    given the same noise, and the state stays identical on every rank.

    On a (data, model) mesh the batch splits over the data axis and every
    rank of a model row takes the same rows. Ring attention, the pipeline,
    the MoE and tensor parallelism need the modules built on this mesh
    (`make_modules(cfg, mesh=mesh)`); a rank then holds its parts of split
    parameters and their Adam moments (`parallel.tp.gather_state` makes the
    whole state)."""
    rl = cfg.rl
    m = cfg.model
    if rl.context_policy == "attention" and (
            m.attn_impl == "ring" or m.attn_pp_microbatches > 0 or m.attn_moe_experts > 0):
        if mods.actor2.mesh is not mesh or mods.critic2.mesh is not mesh:
            raise ValueError("ring attention, the pipeline and the MoE run on the step's "
                             "mesh: build the modules with rl.make_modules(cfg, mesh=mesh)")

    def step(state: ROVRState, video, org_video,
             generator: Optional[torch.Generator] = None,
             gumbel: Optional[Tuple[torch.Tensor, torch.Tensor]] = None,
             masks=None, gumbel1: Optional[torch.Tensor] = None):
        b, s = video.shape[:2]
        rows = local_rows(mesh, b)
        t = rl.time_steps
        if gumbel is None or (rl.use_policy1 and gumbel1 is None):
            gen = generator or torch.Generator(device=mesh.device).manual_seed(cfg.run.seed)
            width = s if rl.context_policy == "attention" else cfg.model.pn2_num_frames
            if gumbel is None:
                gumbel = (gumbel_noise((t, b, width), gen, mesh.device),
                          gumbel_noise((rl.n_updates_per_ppo, b * t, width), gen,
                                       mesh.device))
            if rl.use_policy1 and gumbel1 is None:
                gumbel1 = gumbel_noise((t, b, cfg.model.pn1_num_frames), gen, mesh.device)
        g_roll, g_ppo = (torch.as_tensor(g).to(mesh.device) for g in gumbel)
        g_roll = g_roll[:, rows]
        g_ppo = g_ppo[:, rows.start * t:rows.stop * t]   # _flat's rows: b * T + t
        if gumbel1 is not None:
            gumbel1 = torch.as_tensor(gumbel1).to(mesh.device)[:, rows]
        video, org_video, masks = shard_batch(mesh, (video, org_video, masks))
        return train_step(state, mods, cfg, video, org_video, gumbel=(g_roll, g_ppo),
                          masks=masks, gumbel1=gumbel1, mesh=mesh)

    return step


class HostSyntheticSource:
    """Synthetic clips made on the host (`data.synthetic.synthetic_clips`,
    seeded by cfg.run.seed): `next(i)` is batch i, (corrupted, original,
    masks) float32 (B, S, H, W, 3) numpy arrays of cfg.rl.vid_length frames,
    under the random-mask corruption. A `source` a caller may pass to `run`
    or `evaluate`; the drivers' default is the on-device source
    (data/device_synthetic.make_source). It has no textured clips: those are
    the device source's."""

    def __init__(self, cfg: Config, batch: int, data_texture: float = 0.0):
        if data_texture != 0.0:
            raise NotImplementedError(
                "the host synthetic source makes no textured clips (data_texture != 0); "
                "the on-device source (data/device_synthetic.make_source) does")
        self.cfg, self.batch = cfg, batch

    def next(self, i: int):
        from rovr_torch.data import synthetic

        h, w = self.cfg.data.frame_size
        return synthetic.synthetic_clips(self.cfg.run.seed, i, self.batch,
                                         self.cfg.rl.vid_length, h, w)


class ClipPairs:
    """A dataset's items as the (corrupted, original) clips `run` trains on,
    cut to `s` frames on the host, so the prefetcher stages nothing else."""

    def __init__(self, dataset, s: int):
        self.dataset, self.s = dataset, s

    def __len__(self) -> int:
        return len(self.dataset)

    def __getitem__(self, i: int):
        item = self.dataset[i]
        return tuple(np.asarray(item[f])[:self.s] for f in (0, 1))


def dataset_batch(dataset, start: int, b: int, s: int, fields: int = 2):
    """Items start .. start+b-1 (wrapping) of an indexable dataset, the
    first `fields` of each cut to s frames and stacked."""
    items = [dataset[(start + j) % len(dataset)] for j in range(b)]
    out = [np.stack([np.asarray(it[f])[:s] for it in items]) for f in range(fields)]
    if out[0].shape[1] != s:
        raise ValueError(f"dataset clips have {out[0].shape[1]} frames; "
                         f"cfg.rl.vid_length={s} requires at least that many")
    return out


class DeviceSyntheticSource:
    """The drivers' default clips: batch i of the on-device synthetic source
    (data/device_synthetic.make_source: cfg.data.synthetic_scheme, seeded by
    cfg.run.seed, `data_texture`, `data_texture_vel`), `next(i)` ->
    (corrupted, original, masks) cut to cfg.rl.vid_length frames. That
    source makes 20-frame clips: a longer vid_length raises ValueError."""

    def __init__(self, cfg: Config, batch: int, data_texture: float = 0.0,
                 data_texture_vel: float = 1.5, device=None):
        from rovr_torch.data.device_synthetic import check_source_frames, make_source

        check_source_frames(cfg.rl.vid_length)
        self.s = cfg.rl.vid_length
        self.src = make_source(cfg, batch, cfg.run.seed, data_texture, data_texture_vel,
                               device)

    def next(self, i: int):
        corrupted, original, masks, _, _ = self.src.next(i)
        return corrupted[:, :self.s], original[:, :self.s], masks[:, :self.s]


def run(cfg: Optional[Config] = None, dataset=None, iterations: Optional[int] = None,
        log_cb=None, init_params: Optional[Dict[str, Dict[str, torch.Tensor]]] = None,
        data_texture: float = 0.0, source=None, device=None,
        data_texture_vel: float = 1.5) -> ROVRState:
    """The RL training loop: `iterations` train steps (default
    cfg.run.max_iterations), metrics and the corrupted | reconstructed |
    original strip of frame 0 every cfg.run.log_every, a checkpoint per
    cfg.run.checkpoint_every under <run_dir>/rovr_rl/<timestamp>/.
    Returns the final state.

    `init_params`: keyword arguments of `init_state` (port-layout state
    dicts of pretrained or warm-started modules). cfg.run.restore_from: a
    checkpoints directory whose newest step replaces the fresh state.
    One torch.Generator seeded from cfg.run.seed draws every step's noise.

    Data: `dataset`, indexable items whose [0], [1] are (>= S, H, W, 3)
    corrupted and original clips (no masks, as in the JAX `run`), read by a
    `DevicePrefetcher` (cfg.data.num_workers threads, max(2,
    cfg.data.prefetch_depth * B) items, those two clips cut to S frames,
    staged on the device ahead of the step; the seconds the step waited on
    it are `Data/prefetch_wait_s`);
    else `source`, whose `next(i)` gives batch i as (corrupted, original,
    masks); else `DeviceSyntheticSource` (20-frame clips made on the device,
    textured by `data_texture` and `data_texture_vel`), whose masks add
    `Episode/exposure`. Runs on CUDA unless `device="cpu"`."""
    from rovr_torch.data.dataset import DevicePrefetcher
    from rovr_torch.utils.checkpoint import CheckpointManager, run_dir
    from rovr_torch.utils.logging import MetricsWriter

    cfg = cfg or Config()
    iterations = iterations if iterations is not None else cfg.run.max_iterations
    b, s = cfg.rl.batch_size, cfg.rl.vid_length
    if dataset is None and source is None:
        source = DeviceSyntheticSource(cfg, b, data_texture, data_texture_vel, device)
    mods = make_modules(cfg, device=device)
    dev = next(mods.local_net.parameters()).device
    state = init_state(cfg, mods, cfg.run.seed, **(init_params or {}))

    path = run_dir(cfg.run.run_dir, "rovr_rl")
    writer = MetricsWriter(path)
    ckpt = CheckpointManager(os.path.join(path, "checkpoints"), every=cfg.run.checkpoint_every)
    if cfg.run.restore_from:
        restored = CheckpointManager(cfg.run.restore_from).restore(template=state)
        if restored is not None:
            state = restored
    gen = torch.Generator(device=dev).manual_seed(cfg.run.seed)
    prefetcher = None

    def batches():
        """(corrupted, original, masks, seconds waited on the prefetcher)."""
        if dataset is None:
            for i in range(iterations):
                yield (*source.next(i), None)
            return
        items = iter(prefetcher)
        for _ in range(iterations):
            waited = prefetcher.wait_s
            batch = [next(items) for _ in range(b)]
            video, org = (torch.stack([x[f] for x in batch]) for f in (0, 1))
            if video.shape[1] != s:
                raise ValueError(f"dataset clips have {video.shape[1]} frames; "
                                 f"cfg.rl.vid_length={s} requires at least that many")
            yield video, org, None, prefetcher.wait_s - waited

    try:
        if dataset is not None:
            prefetcher = DevicePrefetcher(
                ClipPairs(dataset, s), indices=[i % len(dataset) for i in range(iterations * b)],
                num_workers=cfg.data.num_workers,
                depth=max(2, cfg.data.prefetch_depth * b), device=dev)
        for i, (video, org, masks, waited) in enumerate(batches()):
            state, metrics, recon = train_step(state, mods, cfg, video, org,
                                               generator=gen, masks=masks)
            if waited is not None:
                metrics["Data/prefetch_wait_s"] = waited
            if i % cfg.run.log_every == 0:
                writer.scalars({k: float(v) for k, v in metrics.items()}, i)
                v0, o0 = (np.asarray(torch.as_tensor(x[0, 0]).cpu()) for x in (video, org))
                if v0.dtype == np.uint8:
                    v0 = v0.astype(np.float32) / 255.0
                    o0 = o0.astype(np.float32) / 255.0
                r0 = recon[0, 0].float().cpu().numpy()
                writer.image("Episode/corrupted_recon_original",
                             np.concatenate([v0, r0, o0], axis=1).clip(0.0, 1.0), i)
                if log_cb:
                    log_cb(i, metrics)
            ckpt.save(i, state)
        ckpt.wait()
    finally:
        if prefetcher is not None:
            prefetcher.close()
        ckpt.close()
        writer.close()
    return state


def run_resilient(cfg: Optional[Config] = None, dataset=None,
                  iterations: Optional[int] = None, log_cb=None,
                  max_restarts: int = 3, source=None, device=None) -> ROVRState:
    """Crash-resuming `run`: on any exception but KeyboardInterrupt, `run`
    again from the newest checkpoint under cfg.run.run_dir (fresh when there
    is none), up to `max_restarts` times. Completed steps persist in the
    restored state's step count."""
    import dataclasses
    import traceback

    from rovr_torch.utils.checkpoint import latest_checkpoint_dir

    cfg = cfg or Config()
    for attempt in range(max_restarts + 1):
        try:
            return run(cfg, dataset=dataset, iterations=iterations, log_cb=log_cb,
                       source=source, device=device)
        except KeyboardInterrupt:
            raise
        except Exception:
            if attempt == max_restarts:
                raise
            traceback.print_exc()
            resume = latest_checkpoint_dir(cfg.run.run_dir, "rovr_rl")
            print(f"[rovr_torch.rl] attempt {attempt + 1} crashed; "
                  + (f"resuming from {resume}" if resume
                     else "restarting fresh (no checkpoint found)"))
            cfg = cfg.replace(run=dataclasses.replace(cfg.run, restore_from=resume))
    raise AssertionError("unreachable")
