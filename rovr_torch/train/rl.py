"""The ROVR episode, PyTorch port of rovr_tpu/train/rl.py: the module zoo,
its state, the episode init and the rollout.

The port covers what serving and the reward path run: the canvas context
policy with sequential targets (`use_policy1=False`), no RAFT spatio signal
and no sequential baseline; `rollout` raises on those options. PPO, Adam and
the train step come in a later slice.

State and modules are split as in the JAX package: `ROVRModules` holds the
nn.Modules, `ROVRState` their parameters as state dicts (port layout, f32).
`bind` points the modules at a state without copying it.

The JAX rollout is one `lax.scan`; here it is a Python loop over
`time_steps`. It syncs nothing with the host: target and context indices
stay device tensors. The working video `recon` is a copy of the input in
the compute dtype, written in place one target frame per step (the JAX
carry is immutable and rewritten with a scatter); keeping it in the compute
dtype, as the JAX package does, keeps the uint8 output's LSBs in step.
"""

from __future__ import annotations

from typing import Dict, List, NamedTuple, Optional

import torch
import torch.nn.functional as F

from rovr_torch.config import Config
from rovr_torch.device import resolve
from rovr_torch.models.layers import flax_init_state
from rovr_torch.models.local_net import LocalNetUNet
from rovr_torch.models.policy_net_2 import PolicyNet2
from rovr_torch.models.vgg_lpips import LPIPS
from rovr_torch.models.video_processor import VideoProcessor, resize_bilinear
from rovr_torch.ops.rewards import rewards_to_go


class ROVRModules(NamedTuple):
    vp: VideoProcessor
    actor2: PolicyNet2
    critic2: PolicyNet2
    local_net: LocalNetUNet
    lpips: LPIPS


class ROVRState(NamedTuple):
    """Parameters of each module as a state dict (name -> tensor)."""

    vp_params: Dict[str, torch.Tensor]
    actor2_params: Dict[str, torch.Tensor]
    critic2_params: Dict[str, torch.Tensor]
    local_net_params: Dict[str, torch.Tensor]
    lpips_params: Dict[str, torch.Tensor]


class Trajectory(NamedTuple):
    """Stacked rollout tensors, time-major (T, B, ...)."""

    obs: tuple                  # (canvas (T,B,C,C,1), target_feat (T,B,D))
    target_idx: torch.Tensor    # (T, B) int64
    actions: torch.Tensor       # (T, B, 2) int64
    logprobs: torch.Tensor      # (T, B)
    rtgs: Optional[torch.Tensor]  # (T, B); None without rewards


class RolloutOut(NamedTuple):
    traj: Trajectory
    reconstructed: torch.Tensor   # (B, S, H, W, 3) in the input's dtype
    metrics: Dict[str, torch.Tensor]


class EpisodeInit(NamedTuple):
    curr_loss: Optional[torch.Tensor]   # (B, S) LPIPS(corrupted, org)
    org_taps: Optional[List[torch.Tensor]]  # cached-stage org taps (B,S,c,h,w)
    canvas: torch.Tensor                # (B, C, C, 1)
    feats: torch.Tensor                 # (B, S, D)


_MODULE_STATE = {
    "vp": "vp_params", "actor2": "actor2_params", "critic2": "critic2_params",
    "local_net": "local_net_params", "lpips": "lpips_params",
}


def make_modules(cfg: Config, dtype: Optional[torch.dtype] = None,
                 device=None) -> ROVRModules:
    """Build the module zoo on `device` (CUDA unless device="cpu"). `dtype`
    is the compute dtype (bf16 by default); parameters are f32."""
    dev = resolve(device)
    dt = dtype if dtype is not None else torch.bfloat16
    m = cfg.model
    if cfg.rl.context_policy != "canvas":
        raise NotImplementedError(
            f"context_policy={cfg.rl.context_policy!r}: only the canvas "
            "policy is ported"
        )
    pn2 = dict(
        num_frames=m.pn2_num_frames, fc_dims=m.pn2_fc_dims,
        temperature=m.pn2_temperature, dtype=dt,
        per_sample_stats=m.per_sample_stats, canvas_size=m.canvas_size,
        feature_dim=m.feature_dim,
    )
    lp = dict(stages=m.lpips_stages) if m.lpips_stages else {}
    mods = ROVRModules(
        vp=VideoProcessor(
            canvas_size=m.canvas_size, tile=m.canvas_tile,
            tiles_per_row=m.canvas_tiles_per_row, feature_dim=m.feature_dim,
            dtype=dt, backbone_name=m.backbone,
            spatial_pool=m.backbone_spatial_pool,
        ),
        actor2=PolicyNet2(**pn2),
        critic2=PolicyNet2(**pn2, is_critic=True),
        local_net=LocalNetUNet(channels=m.local_net_channels, dtype=dt),
        lpips=LPIPS(dtype=dt, **lp),
    )
    for mod in mods:
        mod.to(dev).requires_grad_(False)
    return mods


def init_state(cfg: Config, mods: ROVRModules, seed: int) -> ROVRState:
    """Fresh parameters from `seed`, drawn as the JAX package's flax
    initializers draw them (lecun-normal kernels, zero biases, LPIPS lins
    U(0, 0.1)), on the modules' device. torch's draws differ from JAX's."""
    gen = torch.Generator().manual_seed(seed)
    return ROVRState(**{
        _MODULE_STATE[name]: flax_init_state(mod, gen)
        for name, mod in zip(ROVRModules._fields, mods)
    })


def state_to(state: ROVRState, device) -> ROVRState:
    return ROVRState(*[{k: v.to(device) for k, v in d.items()} for d in state])


def bind(mods: ROVRModules, state: ROVRState) -> None:
    """Make each module use the state's tensors (no copy when they are on
    the module's device already)."""
    for name, mod in zip(ROVRModules._fields, mods):
        dev = next(mod.parameters()).device
        params = getattr(state, _MODULE_STATE[name])
        mod.load_state_dict({k: v.to(dev) for k, v in params.items()},
                            strict=True, assign=True)
        mod.requires_grad_(False)


def _check_supported(cfg: Config) -> None:
    rl = cfg.rl
    unported = {
        "context_policy='attention'": rl.context_policy != "canvas",
        "use_policy1": rl.use_policy1,
        "use_spatio_reward / log_spatio": rl.use_spatio_reward or rl.log_spatio,
        "sequential_baseline": rl.sequential_baseline,
    }
    bad = [k for k, v in unported.items() if v]
    if bad:
        raise NotImplementedError(f"not in the port yet: {', '.join(bad)}")


def _write_frame(video: torch.Tensor, idx: torch.Tensor, frame: torch.Tensor) -> None:
    """In place: video[b, idx[b]] = frame[b]."""
    video[torch.arange(video.shape[0], device=video.device), idx] = frame


def _gather_frames(video: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """(B, K, H, W, 3) frames of (B, S, H, W, 3) at per-sample indices (B, K)."""
    return video[torch.arange(video.shape[0], device=video.device)[:, None], idx]


def episode_init(state: ROVRState, mods: ROVRModules, cfg: Config,
                 video: torch.Tensor, org_video: torch.Tensor,
                 rewards: bool = True) -> EpisodeInit:
    """The per-frame LPIPS baseline and the cached original-frame taps
    (skipped without rewards), then the VideoProcessor state encode of
    the frames resized to 224."""
    bind(mods, state)
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


@torch.no_grad()
def rollout(state: ROVRState, mods: ROVRModules, cfg: Config,
            video: torch.Tensor, org_video: torch.Tensor,
            generator: Optional[torch.Generator] = None,
            rewards: bool = True) -> RolloutOut:
    """The episode (ROVR.forward), gradient-free.

    video/org_video: (B, S, H, W, 3) in [0,1]. `generator` draws the Gumbel
    noise when cfg.rl.greedy is off (default: seeded from cfg.run.seed).
    `rewards=False` skips the LPIPS reward path in the init and in every
    step, which is what XLA's dead-code elimination does to the JAX serving
    graph; the trajectory then has no rewards-to-go and `metrics` is empty.
    """
    _check_supported(cfg)
    rl = cfg.rl
    b, s = video.shape[:2]
    dev = video.device
    cache_from = cfg.model.lpips_cache_from_stage
    if not rl.greedy and generator is None:
        generator = torch.Generator(device=dev).manual_seed(cfg.run.seed)

    init = episode_init(state, mods, cfg, video, org_video, rewards)  # binds
    cvs, fts = init.canvas, init.feats
    cl = init.curr_loss.clone() if rewards else None

    video_cd = video.to(mods.local_net.dtype)
    recon = video_cd.clone()
    ar = torch.arange(b, device=dev)
    ys = {k: [] for k in ("canvas", "feat", "tgt", "acs", "logp", "marginal",
                          "lpips", "mse")}
    for t in range(rl.time_steps):
        tgt = torch.full((b,), t % s, dtype=torch.long, device=dev)
        tgt_feat = fts[ar, tgt]
        ys["canvas"].append(cvs)
        ys["feat"].append(tgt_feat)
        acs, logp = mods.actor2.act(cvs, tgt_feat, tgt, greedy=rl.greedy,
                                    generator=generator)

        frame_src = recon if rl.recon_context else video_cd
        y_hat = mods.local_net(frame_src[ar, tgt], _gather_frames(frame_src, acs))

        if rewards:
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

        _write_frame(recon, tgt, y_hat.to(recon.dtype))
        cvs, _ = mods.vp.insert_encoded_frame_batch(tgt, y_hat, cvs)
        ys["tgt"].append(tgt)
        ys["acs"].append(acs)
        ys["logp"].append(logp)

    target_idx = torch.stack(ys["tgt"])
    rtgs, metrics = None, {}
    if rewards:
        marginal = torch.stack(ys["marginal"])  # (T, B)
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
    traj = Trajectory(
        obs=(torch.stack(ys["canvas"]), torch.stack(ys["feat"])),
        target_idx=target_idx, actions=torch.stack(ys["acs"]),
        logprobs=torch.stack(ys["logp"]), rtgs=rtgs,
    )
    return RolloutOut(traj, recon.to(video.dtype), metrics)

