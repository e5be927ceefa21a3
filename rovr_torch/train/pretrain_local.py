"""Supervised pretraining of the local inpainting UNet
(rovr_tpu/train/pretrain_local.py, PyTorch port).

Loss: MSE + LPIPS with the exponential MSE -> LPIPS anneal
gamma = 0.1 + 0.9 * 0.9993^step (train_local_net_unet.py:109; hard-coded
as in the JAX package, which leaves cfg.pretrain.gamma_* unread); samples
are (target f, contexts f-2, f-1) gathered from clips held on the device;
one Adam (optax.adam's defaults) over the UNet only. LPIPS is frozen: its
parameters take no gradient, and the loss's gradient flows through it to
the UNet's output. The UNet's conv3, conv4 and conv5 run K1 forward and its
cuDNN backward (ops/conv.py) on the card.

Randomness is an input: `draw_batch_indices` takes the sample indices from
a `torch.Generator` and `gather_batch` is a pure function of them, so the
tests replay the JAX package's `jax.random` draws.

Deviation kept from the JAX package: `legacy_target_offset` (supervise
against frame f-1, the original code's off-by-one) is an argument of
`sample_batch`; `train_step` does not pass it, as the JAX `train_step` does
not, so cfg.pretrain.legacy_target_offset is unread there too.
"""

from __future__ import annotations

import os
from typing import Dict, NamedTuple, Optional, Tuple

import numpy as np
import torch

from rovr_torch.config import Config
from rovr_torch.device import resolve
from rovr_torch.models.layers import flax_init_state
from rovr_torch.models.local_net import LocalNetUNet
from rovr_torch.models.vgg_lpips import LPIPS
from rovr_torch.train.rl import (
    _adam, _adam_state, _adam_step, _trainable, adam_init, make_lpips,
)


class PretrainState(NamedTuple):
    """The UNet's parameters (port layout, f32), its Adam state
    ({"step", "exp_avg", "exp_avg_sq"}, as rl.ROVRState's), LPIPS' frozen
    parameters, and the count of steps taken."""

    step: int
    params: Dict[str, torch.Tensor]
    opt_state: dict
    lpips_params: Dict[str, torch.Tensor]


class PretrainModules(NamedTuple):
    local_net: LocalNetUNet
    lpips: LPIPS
    lr: float


class BatchIndices(NamedTuple):
    """The draws of one `sample_batch`: clip, target frame, positive pair and
    whether to use it, each (B,) on the generator's device."""

    ls: torch.Tensor        # int64 in [0, L)
    fs: torch.Tensor        # int64 in [2, S)
    pi: Optional[torch.Tensor] = None       # int64 in [0, P)
    use_pos: Optional[torch.Tensor] = None  # bool, P(True) = positive_prob


def make_modules(cfg: Config, dtype: Optional[torch.dtype] = None,
                 device=None) -> PretrainModules:
    """The UNet and LPIPS on `device` (CUDA unless device="cpu"), computing
    in `dtype` (bf16 by default) with f32 parameters."""
    dev = resolve(device)
    dt = dtype if dtype is not None else torch.bfloat16
    local_net = LocalNetUNet(channels=cfg.model.local_net_channels, dtype=dt)
    lpips = make_lpips(cfg, dt)
    for mod in (local_net, lpips):
        mod.to(dev).requires_grad_(False)
    return PretrainModules(local_net, lpips, cfg.pretrain.lr)


def init_state(cfg: Config, mods: PretrainModules, seed: int) -> PretrainState:
    """Fresh parameters from `seed`, drawn as flax draws them (the UNet's,
    then LPIPS'), on the modules' device, and a fresh Adam state."""
    gen = torch.Generator().manual_seed(seed)
    params = flax_init_state(mods.local_net, gen)
    lpips_params = flax_init_state(mods.lpips, gen)
    return PretrainState(step=0, params=params, opt_state=adam_init(params),
                         lpips_params=lpips_params)


def draw_batch_indices(generator: torch.Generator, num_clips: int, num_frames: int,
                       batch_size: int, num_positives: int = 0,
                       positive_prob: float = 0.5) -> BatchIndices:
    """f ~ U[2, S), the clip ~ U[0, L); with positive tables (P > 0) also a
    pair index ~ U[0, P) and a coin of `positive_prob`."""
    dev = generator.device
    ls = torch.randint(0, num_clips, (batch_size,), generator=generator, device=dev)
    fs = torch.randint(2, num_frames, (batch_size,), generator=generator, device=dev)
    if num_positives == 0:
        return BatchIndices(ls, fs)
    pi = torch.randint(0, num_positives, (batch_size,), generator=generator, device=dev)
    use_pos = torch.rand(batch_size, generator=generator, device=dev) < positive_prob
    return BatchIndices(ls, fs, pi, use_pos)


def gather_batch(idx: BatchIndices, video: torch.Tensor, orig_video: torch.Tensor,
                 legacy_target_offset: bool = False,
                 positives: Optional[torch.Tensor] = None):
    """(image (B,H,W,3), context (B,2,H,W,3), target (B,H,W,3)) at `idx`
    from clips (L, S, H, W, 3): contexts f-2, f-1, or, where `use_pos`, the
    drawn positive pair of `positives` (L, S, P, 2) (each index clipped to
    S-1). The target is frame f of the original clip (f-1 with
    `legacy_target_offset`)."""
    s_count = video.shape[1]
    ls, fs = idx.ls, idx.fs
    c1_idx, c2_idx = fs - 2, fs - 1
    if positives is not None:
        pair = positives[ls, fs, idx.pi].long()  # (B, 2)
        c1_idx = torch.where(idx.use_pos, pair[:, 0].clamp(max=s_count - 1), c1_idx)
        c2_idx = torch.where(idx.use_pos, pair[:, 1].clamp(max=s_count - 1), c2_idx)
    image = video[ls, fs]
    context = torch.stack([video[ls, c1_idx], video[ls, c2_idx]], dim=1)
    target = orig_video[ls, fs - 1] if legacy_target_offset else orig_video[ls, fs]
    return image, context, target


def sample_batch(generator: torch.Generator, video: torch.Tensor,
                 orig_video: torch.Tensor, batch_size: int,
                 legacy_target_offset: bool = False,
                 positives: Optional[torch.Tensor] = None,
                 positive_prob: float = 0.5):
    """Draw and gather one batch (ImageDataset, train_local_net_unet.py:26-57,
    on the device). `positives` (L, S, P, 2): the teacher's exposing context
    pairs; each sample takes one with probability `positive_prob`, which is
    what lets the UNet learn to copy from an exposing context."""
    idx = draw_batch_indices(generator, video.shape[0], video.shape[1], batch_size,
                             0 if positives is None else positives.shape[2],
                             positive_prob)
    return gather_batch(idx, video, orig_video, legacy_target_offset, positives)


def loss_fn(mods: PretrainModules, batch,
            step: int) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """gamma * MSE + (1 - gamma) * LPIPS of the bound UNet's output against
    the target, gamma = 0.1 + 0.9 * 0.9993^step. Returns (total, metrics)."""
    image, context, target = batch
    y_hat = mods.local_net(image, context)
    mse = torch.mean((y_hat - target) ** 2)
    lpips_val = torch.mean(mods.lpips(y_hat, target))
    gamma = 0.1 + 0.9 * torch.pow(torch.tensor(0.9993, dtype=torch.float32),
                                  torch.tensor(float(step), dtype=torch.float32))
    gamma = gamma.to(mse.device)
    total = mse * gamma + lpips_val * (1.0 - gamma)
    return total, {
        "Loss/mse_loss": mse.detach(),
        "Loss/lpips_loss": lpips_val.detach(),
        "Loss/gamma": gamma,
        "Loss/total_loss": total.detach(),
    }


def _bind_lpips(mods: PretrainModules, lpips_params: Dict[str, torch.Tensor]) -> None:
    dev = next(mods.lpips.parameters()).device
    mods.lpips.load_state_dict({k: v.to(dev) for k, v in lpips_params.items()},
                               strict=True, assign=True)
    mods.lpips.requires_grad_(False)


def train_step(state: PretrainState, generator: Optional[torch.Generator],
               mods: PretrainModules, data: Tuple[torch.Tensor, ...], batch_size: int,
               indices: Optional[BatchIndices] = None):
    """One step: sample -> UNet -> LPIPS -> backward -> Adam on the UNet.
    `data` = (video, orig_video[, positives]) on the modules' device; the
    batch is drawn from `generator`, or gathered at the given `indices`.
    Returns (new state, metrics); the input state is left as it was."""
    video, orig_video, *rest = data
    positives = rest[0] if rest else None
    if indices is None:
        batch = sample_batch(generator, video, orig_video, batch_size, positives=positives)
    else:
        batch = gather_batch(indices, video, orig_video, positives=positives)
    _bind_lpips(mods, state.lpips_params)
    named = _trainable(mods.local_net, state.params)
    opt = _adam(named, state.opt_state, mods.lr)
    try:
        total, metrics = loss_fn(mods, batch, state.step)
        total.backward()
        _adam_step(opt, named)
    finally:
        mods.local_net.requires_grad_(False)
    return state._replace(step=state.step + 1,
                          params={n: p.detach() for n, p in named},
                          opt_state=_adam_state(opt, named)), metrics


@torch.no_grad()
def viz_batch(state: PretrainState, generator: torch.Generator, mods: PretrainModules,
              data: Tuple[torch.Tensor, ...]) -> torch.Tensor:
    """(input | ctx1 | ctx2 | target | output) strip of one sampled example,
    (H, 5*W, 3) in [0, 1] (the original's every-200-steps image grid,
    train_local_net_unet.py:117-119)."""
    video, orig_video, *rest = data
    image, context, target = sample_batch(generator, video, orig_video, 1,
                                          positives=rest[0] if rest else None)
    dev = next(mods.local_net.parameters()).device
    mods.local_net.load_state_dict({k: v.to(dev) for k, v in state.params.items()},
                                   strict=True, assign=True)
    mods.local_net.requires_grad_(False)
    y_hat = mods.local_net(image, context)
    strip = torch.cat([image[0], context[0, 0], context[0, 1], target[0],
                       y_hat[0].float()], dim=1)
    return strip.clamp(0.0, 1.0)


def host_clips(cfg: Config, num_clips: int = 4):
    """(video, orig) float32 (L, S, H, W, 3) numpy: `num_clips` host
    synthetic clips of cfg.data's length and size, seeds 0..L-1, the JAX
    `run`'s default data."""
    from rovr_torch.data import synthetic

    clips = [synthetic.synthetic_batch(s, cfg.data.vid_length, *cfg.data.frame_size)
             for s in range(num_clips)]
    return np.stack([c[0] for c in clips]), np.stack([c[1] for c in clips])


def run(cfg: Optional[Config] = None, data=None, steps: Optional[int] = None,
        log_cb=None, device=None) -> PretrainState:
    """The pretraining loop: `steps` train steps (default
    cfg.pretrain.steps) at cfg.pretrain.batch_size, metrics every
    cfg.run.log_every, the image strip every cfg.pretrain.viz_every, a
    checkpoint every cfg.pretrain.checkpoint_every under
    <run_dir>/local_net_pretrain/<timestamp>/; cfg.run.restore_from resumes
    from a checkpoints directory. `data` = (video, orig[, positives])
    (L, S, H, W, 3) clips (and (L, S, P, 2) pairs), default `host_clips`.
    One torch.Generator seeded from cfg.run.seed draws every batch. Runs on
    CUDA unless `device="cpu"`. Returns the final state."""
    from rovr_torch.utils.checkpoint import CheckpointManager, run_dir
    from rovr_torch.utils.logging import MetricsWriter

    cfg = cfg or Config()
    steps = steps if steps is not None else cfg.pretrain.steps
    mods = make_modules(cfg, device=device)
    dev = next(mods.local_net.parameters()).device
    state = init_state(cfg, mods, cfg.run.seed)
    if data is None:
        data = host_clips(cfg)
    data = tuple(torch.as_tensor(x).to(dev) for x in data)

    path = run_dir(cfg.run.run_dir, "local_net_pretrain")
    writer = MetricsWriter(path)
    ckpt = CheckpointManager(os.path.join(path, "checkpoints"),
                             every=cfg.pretrain.checkpoint_every)
    if cfg.run.restore_from:
        restored = CheckpointManager(cfg.run.restore_from).restore(template=state)
        if restored is not None:
            state = restored
    gen = torch.Generator(device=dev).manual_seed(cfg.run.seed)
    try:
        for i in range(steps):
            state, metrics = train_step(state, gen, mods, data, cfg.pretrain.batch_size)
            if i % cfg.run.log_every == 0:
                writer.scalars({k: float(v) for k, v in metrics.items()}, i)
                if log_cb:
                    log_cb(i, metrics)
            if cfg.pretrain.viz_every and i % cfg.pretrain.viz_every == 0:
                writer.image("Pretrain/input_ctx_target_output",
                             viz_batch(state, gen, mods, data).cpu().numpy(), i)
            ckpt.save(i, state)
        ckpt.wait()
    finally:
        ckpt.close()
        writer.close()
    return state
