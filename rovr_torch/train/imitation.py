"""Imitation-learning warm start of the context policy π₂
(rovr_tpu/train/imitation.py, PyTorch port).

Per clip the state is built once (the VideoProcessor over the S frames
resized to 224) and given to the policy as S rows, one per target index;
the policy's masked logits are pulled toward each teacher positive pair's
multi-hot and pushed from each negative pair's (BCE with logits, weights
1.5 and 1.0, imitation_learning.py:83-94), or, with loss_mode "pair_ce",
trained by softmax CE toward one canonical positive pair.

One Adam (optax.adam's defaults) runs over π₂ and, when
cfg.imitation.train_vp is set, the VideoProcessor's two heads. The ResNet
backbone is frozen (no gradient, no Adam state, as optax's `set_to_zero`
partition); with train_vp off the heads freeze too. For the attention
policy each step launches K2 once per encoder block in the forward and K3
and K4 once each in the backward, over S rows of S * patch_tokens tokens.
"""

from __future__ import annotations

import os
from typing import Dict, List, NamedTuple, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from rovr_torch.config import Config
from rovr_torch.device import resolve
from rovr_torch.models.layers import flax_init_state
from rovr_torch.models.policy_net_2 import PolicyNet2
from rovr_torch.models.video_processor import VideoProcessor, resize_bilinear
from rovr_torch.train.rl import (
    Policy, _adam, _adam_state, _adam_step, adam_init, make_policy, make_video_processor,
)


class ImitationState(NamedTuple):
    """π₂'s and the VideoProcessor's parameters (port layout, f32), the
    Adam state of the trained ones (keys "pn2.<name>" and "vp.<name>"),
    and the count of steps taken."""

    step: int
    pn2_params: Dict[str, torch.Tensor]
    vp_params: Dict[str, torch.Tensor]
    opt_state: dict


class ImitationModules(NamedTuple):
    # PolicyNet2 (cfg.rl.context_policy "canvas") or AttentionContextPolicy
    # ("attention"), built as rl.make_modules builds the actor, so the
    # warm start plugs into rl.init_state(actor2_params=...)
    pn2: Policy
    vp: VideoProcessor
    lr: float
    train_vp: bool
    loss_mode: str = "bce"   # "bce" (the original's) or "pair_ce"


def make_modules(cfg: Config, dtype: Optional[torch.dtype] = None,
                 device=None) -> ImitationModules:
    """π₂ and the VideoProcessor on `device` (CUDA unless device="cpu"),
    computing in `dtype` (bf16 by default) with f32 parameters."""
    dev = resolve(device)
    dt = dtype if dtype is not None else torch.bfloat16
    pn2, vp = make_policy(cfg, dt), make_video_processor(cfg, dt)
    for mod in (pn2, vp):
        mod.to(dev).requires_grad_(False)
    im = cfg.imitation
    return ImitationModules(pn2, vp, im.lr, im.train_vp, im.loss_mode)


def _trained_vp(name: str, train_vp: bool) -> bool:
    return train_vp and not name.startswith("backbone.")


def init_state(cfg: Config, mods: ImitationModules, seed: int) -> ImitationState:
    """Fresh parameters from `seed`, drawn as flax draws them (the
    VideoProcessor's, then π₂'s), on the modules' device, and a fresh Adam
    state over the trained parameters."""
    gen = torch.Generator().manual_seed(seed)
    vp_params = flax_init_state(mods.vp, gen)
    pn2_params = flax_init_state(mods.pn2, gen)
    trained = {f"pn2.{k}": v for k, v in pn2_params.items()}
    trained.update({f"vp.{k}": v for k, v in vp_params.items()
                    if _trained_vp(k, mods.train_vp)})
    return ImitationState(0, pn2_params, vp_params, adam_init(trained))


def preprocess_frames(video: torch.Tensor) -> torch.Tensor:
    """(S, H, W, 3) in [0, 1] -> (1, S, 224, 224, 3): jax.image.resize's
    bilinear, antialiased when it shrinks (models/video_processor.py)."""
    return resize_bilinear(video, (224, 224))[None]


def multi_hot(pairs: torch.Tensor, num_classes: int) -> torch.Tensor:
    """(..., 2) index pairs -> (..., num_classes) sum of the two one-hots
    (imitation_learning.py:89)."""
    pairs = pairs.long()
    return (F.one_hot(pairs[..., 0], num_classes)
            + F.one_hot(pairs[..., 1], num_classes)).float()


def bce_with_logits(logits: torch.Tensor, targets: torch.Tensor) -> torch.Tensor:
    """Mean BCE with logits over every element (torch's default reduction)."""
    return -torch.mean(targets * F.logsigmoid(logits)
                       + (1.0 - targets) * F.logsigmoid(-logits))


def imitation_loss(mods: ImitationModules, video: torch.Tensor, positives: torch.Tensor,
                   negatives: torch.Tensor, pos_w: float = 1.5, neg_w: float = 1.0,
                   masks: Optional[torch.Tensor] = None
                   ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """The teacher loss of the bound modules on one clip: video (S,H,W,3),
    positives (S,P,2), negatives (S,N,2), masks (S,H,W,C) with 1 = intact
    (optional: adds `Imitation/exposure`). Returns (loss, metrics) with
    `Imitation/top2_acc`, the share of frames whose top-2 logits (ties to
    the lower index, as lax.top_k) form a tabled positive pair."""
    s = video.shape[0]
    dev = video.device
    positives, negatives = positives.to(dev).long(), negatives.to(dev).long()
    canvas, feats = mods.vp(preprocess_frames(video))
    rows = torch.arange(s, device=dev)
    if isinstance(mods.pn2, PolicyNet2):
        canvas_s = canvas[0][None].expand((s,) + tuple(canvas.shape[1:]))
        logits = mods.pn2.masked_logits(canvas_s, feats[0], rows)
    else:  # the attention policy reads the per-frame feature sequence
        feats_seq = feats[0][None].expand((s,) + tuple(feats[0].shape))
        logits = mods.pn2.masked_logits(feats_seq, rows)
    n = mods.pn2.num_frames
    if mods.loss_mode == "pair_ce":
        # softmax CE toward one canonical teacher pair (positives[:, 0])
        logp = torch.log_softmax(logits, dim=1)
        can = positives[:, 0]
        loss = -torch.mean(logp[rows, can[:, 0]] + logp[rows, can[:, 1]])
    else:
        log_p, log_not_p = F.logsigmoid(logits), F.logsigmoid(-logits)

        def pair_sum_bce(pairs: torch.Tensor) -> torch.Tensor:
            """pairs (S, K, 2) -> the sum over K of the mean-over-(S, n) BCE."""
            t = multi_hot(pairs, n)
            per_pair = -torch.mean(t * log_p[:, None, :] + (1.0 - t) * log_not_p[:, None, :],
                                   dim=(0, 2))
            return per_pair.sum()

        loss = pair_sum_bce(positives) * pos_w - pair_sum_bce(negatives) * neg_w

    top2 = torch.sort(logits.detach(), dim=1, descending=True, stable=True)[1][:, :2]
    table = torch.zeros((s, n, n), dtype=torch.bool, device=dev)
    fr = rows[:, None]
    table[fr, positives[..., 0], positives[..., 1]] = True
    table[fr, positives[..., 1], positives[..., 0]] = True
    acc = table[rows, top2[:, 0], top2[:, 1]].float().mean()
    metrics = {"Loss/expert_loss": loss.detach(), "Imitation/top2_acc": acc}
    if masks is not None:
        # the share of each target's hole pixels that one of the greedy pair
        # exposes: what reconstruction can use
        hole = 1.0 - masks.to(dev)[..., :1].float()
        ha, hb = hole[top2[:, 0]], hole[top2[:, 1]]
        metrics["Imitation/exposure"] = (
            torch.sum(hole * (1.0 - ha * hb)) / torch.clamp(torch.sum(hole), min=1.0))
    return loss, metrics


def _bind_trainable(mods: ImitationModules,
                    state: ImitationState) -> List[Tuple[str, torch.nn.Parameter]]:
    """Bind the state to the modules: copies of the trained parameters with
    gradients on, the frozen ones as they are. Returns the trained
    ("pn2.<name>" / "vp.<name>", parameter) list."""
    named = []
    for prefix, mod, params in (("pn2", mods.pn2, state.pn2_params),
                                ("vp", mods.vp, state.vp_params)):
        dev = next(mod.parameters()).device
        train = (lambda k: True) if prefix == "pn2" else (
            lambda k: _trained_vp(k, mods.train_vp))
        mod.load_state_dict({k: v.detach().to(dev, copy=True) if train(k) else v.to(dev)
                             for k, v in params.items()}, strict=True, assign=True)
        mod.requires_grad_(False)
        for k, p in mod.named_parameters():
            if train(k):
                p.requires_grad_(True)
                named.append((f"{prefix}.{k}", p))
    return named


def train_step(state: ImitationState, batch, mods: ImitationModules):
    """batch = (video, positives, negatives[, masks]) of one clip (masks
    only feed the exposure diagnostic). One Adam step on the trained
    parameters. Returns (new state, metrics); the input state is left as it
    was."""
    video, positives, negatives, *rest = batch
    dev = next(mods.vp.parameters()).device
    named = _bind_trainable(mods, state)
    opt = _adam(named, state.opt_state, mods.lr)
    try:
        loss, metrics = imitation_loss(
            mods, torch.as_tensor(video).to(dev), torch.as_tensor(positives),
            torch.as_tensor(negatives), masks=torch.as_tensor(rest[0]) if rest else None)
        loss.backward()
        _adam_step(opt, named)
    finally:
        mods.pn2.requires_grad_(False)
        mods.vp.requires_grad_(False)
    new = {n: p.detach() for n, p in named}
    pn2 = {k: new[f"pn2.{k}"] for k in state.pn2_params}
    vp = {k: new.get(f"vp.{k}", v) for k, v in state.vp_params.items()}
    return ImitationState(state.step + 1, pn2, vp, _adam_state(opt, named)), metrics


class DeviceTeacherItems:
    """Items (corrupted (S,H,W,3), None, masks, positives, negatives) of the
    on-device synthetic source at batch 1; under the raster scheme the
    teacher tables are the analytic ones of its box geometry, the same for
    every clip: fully exposing positive pairs and the least exposing
    negative pairs."""

    def __init__(self, cfg: Config, data_texture: float, data_texture_vel: float, device):
        from rovr_torch.data.device_synthetic import (
            make_source, raster_negative_pairs, raster_positive_pairs,
        )

        self.src = make_source(cfg, 1, cfg.run.seed, data_texture, data_texture_vel, device)
        self.tables = None
        if cfg.data.synthetic_scheme == "raster":
            h, w = cfg.data.frame_size
            s = cfg.model.pn2_num_frames
            self.tables = (raster_positive_pairs(s, h, w, per_frame=16, seed=cfg.run.seed),
                           raster_negative_pairs(s, h, w, per_frame=3, seed=cfg.run.seed))

    def __len__(self) -> int:
        return 64

    def __getitem__(self, i: int):
        corrupted, _, masks, pos, neg = self.src.next(i)
        if self.tables is not None:
            pos, neg = self.tables[0][None], self.tables[1][None]
        return corrupted[0], None, masks[0], pos[0], neg[0]


def run(cfg: Optional[Config] = None, dataset=None, steps: Optional[int] = None,
        log_cb=None, data_texture: float = 0.0, data_texture_vel: float = 1.5,
        device=None) -> ImitationState:
    """The warm-start loop: `steps` train steps (default
    cfg.imitation.steps) cycling the dataset's items (corrupted, original,
    masks, positives, negatives), metrics every cfg.run.log_every, a
    checkpoint every cfg.imitation.checkpoint_every under
    <run_dir>/warm_start_pn2/<timestamp>/. Without a dataset and with no
    frame folder at cfg.data.root_folder the items come from the on-device
    synthetic source (`DeviceTeacherItems`, textured by `data_texture`);
    else `SyntheticExplicitDataset`, as in the JAX package. The source's
    clips have 20 frames: cfg.model.pn2_num_frames must be 20. Runs on CUDA
    unless `device="cpu"`. Returns the final state."""
    from rovr_torch.data import teacher
    from rovr_torch.data.dataset import SyntheticExplicitDataset
    from rovr_torch.utils.checkpoint import CheckpointManager, run_dir
    from rovr_torch.utils.logging import MetricsWriter

    cfg = cfg or Config()
    steps = steps if steps is not None else cfg.imitation.steps
    if cfg.model.pn2_num_frames != teacher.NUM_FRAMES:
        raise ValueError(
            f"imitation's synthetic clips have {teacher.NUM_FRAMES} frames "
            f"(teacher.NUM_FRAMES); cfg.model.pn2_num_frames is {cfg.model.pn2_num_frames}")
    mods = make_modules(cfg, device=device)
    dev = next(mods.vp.parameters()).device
    state = init_state(cfg, mods, cfg.run.seed)
    if dataset is None and not os.path.isdir(cfg.data.root_folder):
        dataset = DeviceTeacherItems(cfg, data_texture, data_texture_vel, dev)
    else:
        dataset = dataset or SyntheticExplicitDataset(cfg.data, seed=cfg.run.seed)

    path = run_dir(cfg.run.run_dir, "warm_start_pn2")
    writer = MetricsWriter(path)
    ckpt = CheckpointManager(os.path.join(path, "checkpoints"),
                             every=cfg.imitation.checkpoint_every)
    try:
        for i in range(steps):
            corrupted, _, masks, positives, negatives = dataset[i % len(dataset)]
            batch = (corrupted, np.asarray(positives), np.asarray(negatives))
            if masks is not None:
                batch = batch + (masks,)
            state, metrics = train_step(state, batch, mods)
            if i % cfg.run.log_every == 0:
                writer.scalars({k: float(v) for k, v in metrics.items()}, i)
                if log_cb:
                    log_cb(i, metrics)
            ckpt.save(i, state)
        ckpt.wait()
    finally:
        ckpt.close()
        writer.close()
    return state
