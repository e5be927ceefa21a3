"""The multichip dry run (`__graft_entry__.dryrun_multichip` of the JAX
package): one RL train step in each of eight parallel layouts, at a small
configuration, over n processes.

    python -m rovr_torch.parallel.dryrun N [--device cpu]

starts N processes (`launch.spawn`: NCCL on CUDA devices 0..N-1, or gloo
with --device cpu) and runs, in each, the JAX dry run's passes:

  1. data parallel, the canvas policy, over an (N, 1) mesh;
and with N even, over an (N/2, 2) (data, model) mesh, the attention policy:
  2. tensor parallel (`parallel.tp.make_tp_train_step`);
  3. ring attention over the model axis;
  4. the pipeline: 2 encoder blocks in 2 stages, 2 microbatches;
  5. expert parallelism: 2 experts split over the model axis;
  6. ring attention + the MoE, 2 blocks;
  7. tensor parallel + ring attention + the MoE, 2 blocks;
  8. the pipeline + the MoE, 2 blocks.
(The pipeline and tensor parallelism cannot share the one model axis: the
port raises, and the JAX dry run leaves that pair out.) Each pass builds the
modules on its mesh, takes one step on zero clips (the global batch = the
data axis' size) and checks that `step` is 1 and the reconstruction is this
rank's (1, S, H, W, 3) shard; the first process prints each pass's seconds.
`dryrun_multichip` returns the passes' records.
"""

from __future__ import annotations

import argparse
import dataclasses
import sys
import time
from typing import List

import torch

from rovr_torch.config import Config, MeshConfig

# (context policy, tensor parallel, attn_impl, depth, pp microbatches, experts)
PASSES = (
    ("canvas", False, "auto", 1, 0, 0),
    ("attention", True, "auto", 1, 0, 0),
    ("attention", False, "ring", 1, 0, 0),
    ("attention", False, "auto", 2, 2, 0),
    ("attention", False, "auto", 1, 0, 2),
    ("attention", False, "ring", 2, 0, 2),
    ("attention", True, "ring", 2, 0, 2),
    ("attention", False, "auto", 2, 2, 2),
)


def small_config(batch_size: int, context_policy: str, attn_impl: str = "auto",
                 attn_depth: int = 1, pp_microbatches: int = 0,
                 moe_experts: int = 0) -> Config:
    """The JAX dry run's configuration (`_tiny_config(frame=32, frames=4,
    time_steps=2)` and `small_cfg`): 32^2 frames, 4-frame clips, 2 steps, a
    64^2 canvas, the tiny trunk, a 2-stage LPIPS, narrow UNet and π₁,
    hidden 64 with 2 heads and 1 patch token, one PPO epoch."""
    c = Config()
    frames = 4
    return c.replace(
        data=dataclasses.replace(c.data, frame_size=(32, 32), vid_length=frames),
        model=dataclasses.replace(
            c.model, pn2_num_frames=frames, pn1_num_frames=frames, canvas_size=64,
            canvas_tile=32, canvas_tiles_per_row=2, local_net_channels=(8, 16, 32, 64),
            pn1_channels=(8, 16, 32, 64), backbone="tiny", lpips_stages=((8, 1), (16, 1)),
            pn2_fc_dims=(256, 64), lstm_hidden_dim=64, attn_hidden_dim=64, attn_heads=2,
            attn_depth=attn_depth, attn_patch_tokens=1, attn_impl=attn_impl,
            attn_pp_microbatches=pp_microbatches, attn_moe_experts=moe_experts),
        rl=dataclasses.replace(c.rl, vid_length=frames, time_steps=2, n_updates_per_ppo=1,
                               batch_size=batch_size, context_policy=context_policy),
    )


def _pass(index: int, world: int, spec) -> dict:
    """One pass on this process's share of the mesh; the record of it."""
    from rovr_torch.parallel import tp
    from rovr_torch.parallel.mesh import local_rows, make_mesh, replicate
    from rovr_torch.train import rl

    policy, tensor_parallel, impl, depth, pp, experts = spec
    t0 = time.perf_counter()
    dp, mp = (world, 1) if index == 0 else (world // 2, 2)
    mesh = make_mesh(MeshConfig(data_parallel=dp, model_parallel=mp))
    cfg = small_config(dp, policy, impl, depth, pp, experts)
    mods = rl.make_modules(cfg, mesh=mesh, tensor_parallel=tensor_parallel)
    state = replicate(mesh, rl.init_state(cfg, mods, seed=0))
    h, w = cfg.data.frame_size
    video = torch.zeros(dp, cfg.rl.vid_length, h, w, 3)
    make_step = tp.make_tp_train_step if tensor_parallel else rl.make_sharded_train_step
    t1 = time.perf_counter()
    new, metrics, recon = make_step(mesh, mods, cfg)(state, video, video)
    if mesh.device.type == "cuda":
        torch.cuda.synchronize()
    t2 = time.perf_counter()
    if new.step != 1:
        raise AssertionError(f"pass {index + 1}: step {new.step}, expected 1")
    if tuple(recon.shape) != tuple(video[local_rows(mesh, dp)].shape):
        raise AssertionError(f"pass {index + 1}: reconstruction {tuple(recon.shape)}")
    if not all(torch.isfinite(v).all() for v in metrics.values()):
        raise AssertionError(f"pass {index + 1}: metrics not finite")
    return dict(index=index + 1, mesh=[dp, mp], policy=policy, tp=tensor_parallel,
                impl=impl, depth=depth, pp=pp, moe=experts, seconds=t2 - t0,
                step_seconds=t2 - t1, step_fn=make_step.__name__)


def _run(mesh, queue) -> None:
    world = mesh.size * mesh.model_size
    n = len(PASSES) if world % 2 == 0 else 1
    records: List[dict] = []
    for i, spec in enumerate(PASSES[:n]):
        rec = _pass(i, world, spec)
        records.append(rec)
        if mesh.first:
            print(f"[dryrun] pass {rec['index']} mesh={tuple(rec['mesh'])} "
                  f"policy={rec['policy']} tp={rec['tp']} impl={rec['impl']} pp={rec['pp']} "
                  f"moe={rec['moe']} step={rec['step_fn']}: {rec['seconds']:.1f}s "
                  f"(step {rec['step_seconds']:.2f}s)", file=sys.stderr, flush=True)
    if mesh.first:
        queue.put(records)


def dryrun_multichip(n_devices: int, device: str = "cuda") -> List[dict]:
    """Run the passes over `n_devices` processes on `device` ("cuda": one
    CUDA device each, NCCL; "cpu": gloo); returns the first process's
    records. Passes 2-8 need an even n_devices, as in JAX."""
    from rovr_torch.parallel import launch

    queue = torch.multiprocessing.get_context("spawn").SimpleQueue()
    launch.spawn(_run, n_devices, device, args=(queue,),
                 threads=2 if device == "cpu" else None)
    return queue.get()


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("n", type=int, help="processes: CUDA devices, or CPU ones with --device cpu")
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    args = ap.parse_args(argv)
    records = dryrun_multichip(args.n, args.device)
    print(f"dryrun_multichip({args.n}, {args.device!r}): {len(records)} passes passed")
    return 0


if __name__ == "__main__":
    sys.exit(main())
