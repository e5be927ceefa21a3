"""Serving: reconstruct corrupted clips with the policy + UNet
(rovr_tpu/infer.py, PyTorch port).

`reconstruct_clips` runs the greedy rollout (deterministic top-2 context
selection, no sequential baseline) over uint8 clips and returns uint8
reconstructions. No ground-truth video is needed: the rollout runs without
its LPIPS reward path (`rewards=False`), which is what XLA's dead-code
elimination does to the JAX serving graph, so the corrupted clip stands in
for both inputs. Frames are written as out/<clip>/<frame>.png.

Not ported here: the mesh (data-parallel) serving path, the tunnel-only
chunked device fetch and the on-device synthetic source; `run` draws its
default clips from the port's host generator.
"""

from __future__ import annotations

import dataclasses
import os
from typing import Iterable, Iterator, Optional, Tuple

import numpy as np
import torch

from rovr_torch.config import Config
from rovr_torch.train import rl


def reconstruct_clips(
    cfg: Config,
    state: rl.ROVRState,
    mods: rl.ROVRModules,
    videos: Iterable,
) -> Iterator[Tuple[np.ndarray, np.ndarray]]:
    """Yield (reconstructed uint8 (B,S,H,W,3), actions (T,B,2)) per corrupted
    (B, S, H, W, 3) batch (uint8, or float in [0,1]), on the modules'
    device."""
    cfg = cfg.replace(rl=dataclasses.replace(
        cfg.rl, greedy=True, sequential_baseline=False))
    device = next(mods.local_net.parameters()).device
    state = rl.state_to(state, device)  # once, not per batch
    for video in videos:
        v = torch.as_tensor(video).to(device)
        with torch.inference_mode():
            if v.dtype == torch.uint8:
                v = v.float() / 255.0
            out = rl.rollout(state, mods, cfg, v, v, rewards=False)
            recon_u8 = (out.reconstructed.float() * 255.0 + 0.5).clamp(0.0, 255.0)
            recon_u8 = recon_u8.to(torch.uint8)
        yield recon_u8.cpu().numpy(), out.traj.actions.cpu().numpy()


def write_frames(recon: np.ndarray, out_dir: str, clip_offset: int = 0) -> int:
    """Write (B, S, H, W, 3) frames — uint8, or float in [0,1] — as
    out_dir/<clip>/<frame>.png. Returns frames written. Uses cv2 when it is
    installed, else the pure-Python PNG writer."""
    recon = np.asarray(recon)
    if recon.dtype == np.uint8:
        u8 = recon
    else:
        u8 = np.clip(recon.astype(np.float32) * 255.0 + 0.5, 0, 255).astype(np.uint8)
    try:
        import cv2

        def _write(path, img):
            cv2.imwrite(path, cv2.cvtColor(img, cv2.COLOR_RGB2BGR))
    except ImportError:
        from rovr_torch.utils.png import write_png as _write

    n = 0
    for b in range(u8.shape[0]):
        d = os.path.join(out_dir, f"{clip_offset + b:05d}")
        os.makedirs(d, exist_ok=True)
        for s in range(u8.shape[1]):
            _write(os.path.join(d, f"{s:05d}.png"), u8[b, s])
            n += 1
    return n


def run(
    cfg: Optional[Config] = None,
    restore_from: Optional[str] = None,
    dataset=None,
    num_clips: int = 4,
    out_dir: str = "reconstructed",
    device=None,
) -> dict:
    """Serve end to end: restore a trained RL state from the checkpoints
    directory `restore_from` (random init from cfg.run.seed when it is None
    or holds no step), reconstruct `num_clips` clips in batches of
    cfg.rl.batch_size, write their frames.

    `dataset`: indexable items whose [0] is a (>=S, H, W, 3) clip; None
    draws synthetic clips (rovr_torch.data.synthetic). Runs on CUDA unless
    `device="cpu"`."""
    from rovr_torch.data import synthetic
    from rovr_torch.utils.checkpoint import CheckpointManager

    cfg = cfg or Config()
    mods = rl.make_modules(cfg, device=device)
    state = rl.init_state(cfg, mods, cfg.run.seed)
    restored = False
    if restore_from:
        got = CheckpointManager(restore_from).restore(template=state)
        if got is not None:
            state, restored = got, True
    b = cfg.rl.batch_size
    s = cfg.rl.vid_length
    h, w = cfg.data.frame_size

    def batches():
        for i in range(0, num_clips, b):
            if dataset is not None:
                yield np.stack([np.asarray(dataset[(i + j) % len(dataset)][0][:s])
                                for j in range(b)])
            else:  # uint8, the deployment frame format
                f = synthetic.synthetic_clips(cfg.run.seed, i // b, b, s, h, w)[0]
                yield np.clip(f * 255.0 + 0.5, 0, 255).astype(np.uint8)

    written = clips = 0
    for recon, _ in reconstruct_clips(cfg, state, mods, batches()):
        # fixed batch size b; trim the tail to exactly num_clips clips
        take = min(recon.shape[0], num_clips - clips)
        written += write_frames(recon[:take], out_dir, clip_offset=clips)
        clips += take
    return {
        "clips": clips,
        "frames_written": written,
        "out_dir": out_dir,
        "restored": restored,
        "device": str(next(mods.local_net.parameters()).device),
    }
