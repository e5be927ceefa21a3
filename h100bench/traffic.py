"""The one generator every traffic mix is read by.

A mix (traffic/<name>.json) says what the window drives ("train" steps or
"serve"d batches), how many distinct input batches the pool holds, how many
units the set-up runs first, how many the traced run profiles, and how
the clips look. Every batch of a pool is the same shape, so every seed asks
for the same work; the seed only changes the pixels and the noise.

Clips (made on the device, after rovr_torch/data/device_synthetic.py):
moving sinusoidal gradients plus four drifting Gaussian blobs, blended with
a drifting mid-frequency texture of `texture` weight. Corruption: the
port's standard scheme of RL and evaluation (rovr_torch/data/corruption.py
`corrupt_frame` at difficulty 2, after the reference's video_ds.py:18-89):
each frame, with probability `p_brightness`, gets `brightness` added to its
bytes (wrapping, as uint8 arithmetic does there); else, with probability
`p_noise`, uniform integer noise in [-noise, noise) clipped to [0, 255];
else the raster box of `box` (h, w) pixels that tracks the frame index
(frame s of a clip carries index 2s, the reference's every-second frame,
and `frames_per_section` positions a row) is set to black. Both the
corrupted and the original clip are uint8, the deployment's frame format.
"""

from __future__ import annotations

import json
import math
import os
from typing import Dict, List, Tuple

import numpy as np
import torch
import torch.nn.functional as F

HERE = os.path.dirname(os.path.abspath(__file__))
TEXTURE_CELL = 8


def load(name: str) -> dict:
    with open(os.path.join(HERE, "traffic", f"{name}.json")) as f:
        return json.load(f)


def stream(seed: int, *tags: int) -> int:
    """The seed of the device generator of (seed, *tags): any whole seed,
    folded with the tags by numpy's SeedSequence into 62 bits."""
    state = np.random.SeedSequence([seed % (2 ** 64), *tags]).generate_state(2, np.uint32)
    return int(state[0]) << 31 | int(state[1]) >> 1


def generator(device, seed: int, *tags: int) -> torch.Generator:
    return torch.Generator(device=device).manual_seed(stream(seed, *tags))


def clips(gen: torch.Generator, b: int, s: int, h: int, w: int, texture: float,
          texture_vel: float) -> torch.Tensor:
    """(B, S, H, W, 3) float32 in [0, 1] on the generator's device."""
    dev = gen.device

    def uniform(shape, lo=0.0, hi=1.0):
        return lo + (hi - lo) * torch.rand(shape, generator=gen, device=dev)

    phase, speed = uniform((b, 3), 0, 2 * math.pi), uniform((b, 3), 0.5, 2.0)
    blob_xy, blob_v = uniform((b, 4, 2), 0.2, 0.8), uniform((b, 4, 2), -0.02, 0.02)
    blob_col = uniform((b, 4, 3), 0.3, 1.0)
    ys = (torch.arange(h, device=dev, dtype=torch.float32) / h)[:, None]
    xs = (torch.arange(w, device=dev, dtype=torch.float32) / w)[None, :]
    t = torch.arange(s, device=dev, dtype=torch.float32)
    tt = t[None, :, None, None, None]
    sp, ph = speed[:, None, None, None, :], phase[:, None, None, None, :]
    img = 0.5 + 0.4 * torch.sin(2 * math.pi * (xs[None, None, :, :, None] + 0.01 * sp * tt) + ph) \
        * torch.cos(2 * math.pi * (ys[None, None, :, :, None] - 0.013 * sp * tt))
    for k in range(4):
        cx = blob_xy[:, k, 0:1] + blob_v[:, k, 0:1] * t[None]
        cy = blob_xy[:, k, 1:2] + blob_v[:, k, 1:2] * t[None]
        d2 = (xs[None, None] - cx[..., None, None]) ** 2 + (ys[None, None] - cy[..., None, None]) ** 2
        img = img + torch.exp(d2 / -0.01)[..., None] * blob_col[:, k, None, None, None, :]
    out = torch.clamp(img / torch.amax(img, dim=(2, 3, 4), keepdim=True), 0.0, 1.0)
    if texture > 0:
        margin = int(math.ceil(texture_vel * max(1, s - 1))) + TEXTURE_CELL
        gh, gw = (h + 2 * margin) // TEXTURE_CELL + 2, (w + 2 * margin) // TEXTURE_CELL + 2
        grid, vel = uniform((b, gh, gw, 3)), uniform((b, 2), -texture_vel, texture_vel)
        tex = F.interpolate(grid.permute(0, 3, 1, 2), size=(gh * TEXTURE_CELL, gw * TEXTURE_CELL),
                            mode="bilinear", align_corners=False).permute(0, 2, 3, 1)
        dy = torch.clamp(torch.round(vel[:, 0:1] * t[None]), -margin, margin).long()
        dx = torch.clamp(torch.round(vel[:, 1:2] * t[None]), -margin, margin).long()
        rows = margin + dy[..., None] + torch.arange(h, device=dev)
        cols = margin + dx[..., None] + torch.arange(w, device=dev)
        bi = torch.arange(b, device=dev)[:, None, None, None]
        frames = tex[bi, rows[..., None], cols[:, :, None, :]]
        out = torch.clamp(out * (1.0 - texture) + frames * texture, 0.0, 1.0)
    return out


def raster_masks(s: int, h: int, w: int, box: Tuple[int, int], per_section: int, device):
    """(S, H, W, 1) bool, True inside frame s's raster box: frame index 2s
    halved (corrupt_frame's `frame_index // 2`), row index // per_section
    at a third of the height each, column index % per_section at an
    eighth of the width each, clipped to the frame."""
    idx = torch.arange(s, device=device)
    y0, x0 = (idx // per_section) * h // 3, (idx % per_section) * w // 8
    ys = torch.arange(h, device=device)[None, :, None]
    xs = torch.arange(w, device=device)[None, None, :]
    return ((ys >= y0[:, None, None]) & (ys < (y0 + box[0])[:, None, None])
            & (xs >= x0[:, None, None]) & (xs < (x0 + box[1])[:, None, None]))[..., None]


def corrupt(gen: torch.Generator, org: torch.Tensor, mix: dict) -> torch.Tensor:
    """The uint8 clip `org` (B, S, H, W, 3) under the mix's corruption."""
    b, s, h, w = org.shape[:4]
    dev = org.device
    u = torch.rand(b, s, generator=gen, device=dev)[..., None, None, None]
    bright = u < mix["p_brightness"]
    noisy = ~bright & (u < mix["p_brightness"] + mix["p_noise"])
    noise = torch.randint(-mix["noise"], mix["noise"], org.shape, generator=gen, device=dev,
                          dtype=torch.int16)
    boxed = org.masked_fill(raster_masks(s, h, w, mix["box"], mix["frames_per_section"], dev), 0)
    out = torch.where(noisy, (org.short() + noise).clamp(0, 255).to(torch.uint8), boxed)
    return torch.where(bright, org + mix["brightness"], out)


def to_u8(x: torch.Tensor) -> torch.Tensor:
    return (x * 255.0 + 0.5).clamp(0.0, 255.0).to(torch.uint8)


def pool(mix: dict, cfg: dict, seed: int, device) -> List[Dict[str, torch.Tensor]]:
    """The mix's pool of distinct batches on `device`: each {"video"
    (corrupted, uint8), "org" (uint8), "gumbel" (rollout (T, B, S), PPO
    (epochs, B*T, S)) for training}."""
    rl, data = cfg["rl"], cfg["data"]
    b, s, t = rl["batch_size"], rl["vid_length"], rl["time_steps"]
    h, w = data["frame_size"]
    out = []
    for i in range(mix["pool"]):
        gen = generator(device, seed, 1, i)
        org = to_u8(clips(gen, b, s, h, w, mix["texture"], mix["texture_vel"]))
        item = {"video": corrupt(gen, org, mix), "org": org}
        if mix["kind"] == "train":
            item["gumbel"] = (gumbel(gen, (t, b, s)),
                              gumbel(gen, (rl["n_updates_per_ppo"], b * t, s)))
        out.append(item)
    return out


def gumbel(gen: torch.Generator, shape) -> torch.Tensor:
    u = torch.rand(shape, generator=gen, device=gen.device).clamp_min(torch.finfo(torch.float32).tiny)
    return -torch.log(-torch.log(u))
