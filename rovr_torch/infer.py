"""Serving: reconstruct corrupted clips with the policy + UNet
(rovr_tpu/infer.py, PyTorch port).

`reconstruct_clips` runs the greedy rollout (deterministic top-2 context
selection, no sequential baseline) over uint8 clips and returns uint8
reconstructions. No ground-truth video is needed: the rollout runs without
its LPIPS reward path (`rewards=False`), which is what XLA's dead-code
elimination does to the JAX serving graph, so the corrupted clip stands in
for both inputs. Frames are written as out/<clip>/<frame>.png.

With a data mesh (`parallel.mesh`, one process per device) the clip batch
is sharded over the ranks and the state replicated from rank 0: each rank
runs the greedy rollout on its rows, with the policies' batch statistics
taken over the global batch, and the uint8 reconstructions and actions
are all-gathered, so every rank yields the full batch, as the JAX mesh
path does. `run(mesh=)` writes frames on rank 0 only.

Not ported here: the tunnel-only chunked device fetch and the on-device
synthetic source; `run` draws its default clips from the port's host
generator.
"""

from __future__ import annotations

import dataclasses
import os
from typing import Iterable, Iterator, Optional, Tuple

import numpy as np
import torch

from rovr_torch.config import Config
from rovr_torch.parallel import collectives
from rovr_torch.parallel.mesh import Mesh, local_batch_size, replicate, shard_batch
from rovr_torch.train import rl
from rovr_torch.utils.profiling import annotate


def reconstruct_clips(
    cfg: Config,
    state: rl.ROVRState,
    mods: rl.ROVRModules,
    videos: Iterable,
    mesh: Optional[Mesh] = None,
) -> Iterator[Tuple[np.ndarray, np.ndarray]]:
    """Yield (reconstructed uint8 (B,S,H,W,3), actions (T,B,2)) per corrupted
    (B, S, H, W, 3) batch (uint8, or float in [0,1]), on the modules'
    device. With a data `mesh` every rank passes the same batches (B
    divisible by the mesh size) and gets the full batch back."""
    cfg = cfg.replace(rl=dataclasses.replace(
        cfg.rl, greedy=True, sequential_baseline=False))
    device = next(mods.local_net.parameters()).device
    if mesh is None:
        state = rl.state_to(state, device)  # once, not per batch
    else:
        if device != mesh.device:
            raise ValueError(f"modules on {device}, the mesh's device is {mesh.device}")
        state = replicate(mesh, state)
    for video in videos:
        # the batch's span closes before the yield: the consumer's time is not the batch's
        with annotate("rovr/serve/batch"):
            with annotate("rovr/serve/h2d"):
                v = torch.as_tensor(video)
                if mesh is None:
                    v = v.to(device)
                else:
                    local_batch_size(mesh, v.shape[0])   # B must divide the mesh
                    v = shard_batch(mesh, v)
                if v.dtype == torch.uint8:
                    v = v.float() / 255.0
            with torch.inference_mode():
                out = rl.rollout(state, mods, cfg, v, v, rewards=False, mesh=mesh)
                with annotate("rovr/serve/d2h"):
                    recon_u8 = (out.reconstructed.float() * 255.0 + 0.5).clamp(0.0, 255.0)
                    recon_u8 = recon_u8.to(torch.uint8)
                    actions = out.traj.actions
                    if mesh is not None:
                        recon_u8 = collectives.all_gather(recon_u8, mesh, axis=0)
                        actions = collectives.all_gather(actions, mesh, axis=1)
                    frames, actions = recon_u8.cpu().numpy(), actions.cpu().numpy()
        yield frames, actions


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
    mesh: Optional[Mesh] = None,
) -> dict:
    """Serve end to end: restore a trained RL state from the checkpoints
    directory `restore_from` (random init from cfg.run.seed when it is None
    or holds no step), reconstruct `num_clips` clips in batches of
    cfg.rl.batch_size, write their frames. With a data `mesh` each batch is
    served across its ranks (`device` is then the mesh's) and rank 0 alone
    writes the frames (the others report 0 written).

    `dataset`: indexable items whose [0] is a (>=S, H, W, 3) clip; None
    draws synthetic clips (rovr_torch.data.synthetic). Runs on CUDA unless
    `device="cpu"`."""
    from rovr_torch.data import synthetic
    from rovr_torch.utils.checkpoint import CheckpointManager

    cfg = cfg or Config()
    if mesh is not None:
        device = mesh.device
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
    writes = mesh is None or mesh.first
    for recon, _ in reconstruct_clips(cfg, state, mods, batches(), mesh=mesh):
        # fixed batch size b; trim the tail to exactly num_clips clips
        take = min(recon.shape[0], num_clips - clips)
        if writes:
            written += write_frames(recon[:take], out_dir, clip_offset=clips)
        clips += take
    return {
        "clips": clips,
        "frames_written": written,
        "out_dir": out_dir,
        "restored": restored,
        "device": str(next(mods.local_net.parameters()).device),
    }
