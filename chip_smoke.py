#!/usr/bin/env python3
"""Drive of the PyTorch/CUDA port (rovr_torch) on one NVIDIA GPU (H100).

    python3 chip_smoke.py

Builds every hand-written kernel of the port from rovr_torch/csrc with nvcc
(one process per source, all at once, beside g++ for the frame decoder),
holds each kernel against its plain version at the main path's shapes and
times it there beside its bound, its plain version and the library call,
counts the launches of one served batch, then drives the paths that no cell
of the benchmark (h100bench/) reaches:
the RL driver and its checkpoints, evaluation, the command line, the device
source, UNet pretraining, the imitation warm start, the four-stage pipeline,
π₁, training from a frame tree, reference warm starts, the MoE and the
attention leftovers, the s2d canvas, the meshes and the double-buffered
step. Each path checks that it went through the kernels: every launch count
is set to 0 just before a path is driven and read just after.

Where the other checks live: tests/test_torch_cuda.py holds each kernel
against its plain twin at every shape, ragged ones too, and checks the
route the profiler saw; the benchmark's cells serve and train at Config()
and config 5 (with and without RAFT's flow term) against a plain f32
reference, with their launch counts and spans. The phases keep their
numbers, so 4, 6-11 and 13 (the UNet, the serving profile, the config-5
train step, its parts and profiles, the spatio step) are absent. Phases:

  1. device, card name and power limit; TF32 off for the f32 references;
     the build, ptxas' registers and spills, and the TMA kernels' dynamic
     shared memory;
  2. K1 (fused conv3x3) at one serving UNet call (conv3, conv4 and conv5 at
     batch 8, 256^2), held against its plain version (K1_TOL): CUDA-event
     times of the kernel, the plain version and cuDNN (the library
     yardstick, used nowhere in the port), the profiler's device time of
     the kernel and of cuDNN, beside the bound (`conv_bound` of
     h100bench/work.py); K1's backward (cuDNN's conv gradient in bf16) at
     the pretrain step's shapes (batch 24, 256^2), held against its f32
     plain twin (K1_TOL): its times beside cuDNN's forward+backward, the
     plain-autograd backward it replaced and its bound;
  3. K2/K3/K4 (flash attention forward, dq, dk/dv) at the PPO shape
     (512,4,256,64) and K2 at the rollout shape (8,4,256,64), held against
     their plain twins (ATTN_TOL, the LSE within LSE_TOL): times beside
     the bound (work.py's `attention_bound_ms`), the plain twins and
     F.scaled_dot_product_attention (forward, and forward+backward for
     K3+K4; a yardstick the port never calls); RAFT's correlation lookup
     kernel (ops/corr.py) at its main shape (128 pairs, 32 x 32 positions,
     levels 32/16/8/4), held against the plain lookup in bf16 and f32
     (CORR_TOL): times with bf16 out beside its bound and the plain
     lookup's;
  5. one served batch (`infer.reconstruct_clips`, greedy, batch 8) at
     Config() (S = T = 20: exactly 60 K1) and at config 5 (S = T = 64: 192
     K1 and 128 K2), no K3 or K4; uint8 frames written, actions in range;
 12. the RL loop `rl.run` at config 5 (batch 8, S = T = 64, 256^2) on one
     batch of synthetic clips with their masks: 3 iterations, a checkpoint
     and metrics every iteration; each iteration must launch exactly 150
     K2, 20 K3, 20 K4 and 192 K1; metrics.jsonl finite with
     Episode/exposure, the image strip written, the newest checkpoint
     restored bit for bit; one more iteration from `restore_from` continues
     state.step; seconds per iteration, the checkpoint's bytes, save time on
     the training thread against the background write, peak memory;
 14. evaluation at config 5 on the same clips: one `evaluate.run` batch
     (flow size 256; exactly 384 K1 and 128 K2, no K3 or K4, and 12 RAFT
     lookups a RAFT call, `iters` x `pairwise_flows.calls`) and one
     `run_ci` batch with 2 draws (576 K1, 256 K2); every metric finite, the
     sequential output unlike the agentic one; host seconds, one
     `eval_step` under torch.profiler with RAFT's device time, peak memory;
 15. the command line: `cli.main(["rl", ...])` at Config() widths, batch 8,
     2 iterations (exactly 60 K1 per iteration, finite metrics, a
     checkpoint), then `python -m rovr_torch rl --iterations 1` and
     `python -m rovr_torch reconstruct --restore_from` its checkpoint as
     subprocesses (exit 0, frames written, restored);
 16. the on-device synthetic source (`data.device_synthetic.make_source`)
     in both schemes at Config() size (batch 8 x 20 frames, 256^2, texture
     1.0): shapes, the [0, 1] range, masked pixels zero, raster masks equal
     to `raster_box_masks`, determinism; time per batch beside the host
     source's;
 17. UNet pretraining at Config() (`pretrain_local.run`, batch 24, 256^2,
     4 steps): exactly 3 K1 forward launches and 3 backward calls per step
     plus 3 forward launches for the step-0 strip, finite metrics, the UNet
     moved and LPIPS not, a checkpoint restored bit for bit; then timed
     train steps, peak memory, and one step under torch.profiler (device
     time by kernel, K1's share, the backward's cuDNN convs, the idle
     share; fused_conv3x3_plain must not appear);
 18. the imitation warm start (`imitation.run`, 3 steps) at Config() (the
     canvas PolicyNet2, the explicit source) and at the pipeline's
     configuration (the attention policy, 160^2, the raster source): K2,
     K3 and K4 once per encoder block per step with the attention policy
     and no port kernel with the canvas one; finite loss, top2_acc and
     exposure; π₂ and the VideoProcessor's heads moved, the backbone not;
 19. the pipeline (`pipeline.run(default_config(20, 4))`, 4 pretrain and 4
     imitation steps, 2 RL iterations and 1 from a random π₂, 4 eval arms
     of 4 clips, the CI eval with 2 draws, 2 iterations of stage 5 (PPO on
     π₁: 60 K1, 62 K2, 20 K3, 20 K4 each) and its random-π₁ control):
     every stage's launch counts and the record's keys as the JAX `run`
     writes them; then `python -m rovr_torch pretrain`, `imitate` and
     `pipeline` as three subprocesses at once;
 20. config-5 train steps with the frame-selection policy π₁ (use_policy1,
     ppo_policy1: PolicyNet1 32-256 on the 256^2 canvas, a 4096 -> 64 head,
     the ActionLSTM at hidden 1024) on phase 12's clips: a warm-up, then
     timed steps; each must launch exactly what a step without π₁ does
     (192 K1, 150 K2, 20 K3, 20 K4), give finite metrics with
     PPO/actor1_loss, PPO/critic1_loss and Episode/coverage in (0, 1],
     targets in [0, 64), move actor1, critic1, actor2 and critic2 and leave
     the LSTM, the UNet and the VideoProcessor as they were; sec/step, peak
     memory; one step under torch.profiler: the device time of π₁'s ranges
     (`rovr/pi1_act`, `rovr/pi1_lstm`, `rovr/pi1_ppo`), their share, the
     idle share;
 21. `rl.run` with π₁ at config 5: 2 iterations with a checkpoint each
     (the same launch counts), the newest restored bit for bit (π₁'s
     parameters and both new Adam states included), one resumed iteration
     continuing state.step; the checkpoint's bytes beside phase 12's; then
     `python -m rovr_torch rl --ppo_policy1 --iterations 1` at Config() as
     a subprocess (exit 0, PPO/actor1_loss in its metrics.jsonl).
 22. a RealVSR-shaped frame tree (8 clip folders x 50 PNG frames of
     1024x512, 16 videos, the rows encoded with all five PNG filter types by
     an encoder in this file, the content panning) and 2 clips at 1280x720:
     the port's decoder (csrc/frame_decode.cpp, built by g++) exact against
     numpy at 1024x512 (the PNG and the 2x box mean), and at 1280x720 the
     share exact and the largest gap against a float bilinear reference;
     ms per decoded frame on one thread and across decode_clip's 8 threads,
     sec per VideoFolderDataset and ExplicitVideoDataset item, the tree's
     bytes;
 23. `rl.run` at Config() (canvas, S = T = 20, 256^2, batch 8) from the
     tree through the DevicePrefetcher (8 workers), 6 iterations, against 6
     on the device source: sec per iteration, the prefetcher's wait per
     batch, 60 K1 per step in both; one train step under
     utils.profiling.trace fed by the prefetcher while its workers decode,
     against the same step on a device-source batch (the idle shares); 12
     batches at depth 4 through the pinned side-stream copy, every staged
     item bitwise equal to its host item while the consumer's stream is
     busy; once with stage_uint8 (H2D bytes per batch, sec per iteration);
     then `python -m rovr_torch {rl,imitate,eval,reconstruct} --root_folder`
     as four subprocesses at once;
 24. reference checkpoints made from a seed at full width (torchvision
     ResNet-50, lpips' VGG16 + lins, RAFT-small, the reference UNet,
     PolicyNetwork2, a full `rovr` state with its prefixes in the
     model_state_dict envelope): each kind's conversion seconds and bytes,
     `python -m rovr_torch convert --kind <k>` of each (all at once), `rl
     --warm_start` (its first state equal to the converted tensors, bit
     for bit, on the card) and `eval --warm_start` with lpips and raft
     (Eval/metric_weights_random 0);
 25. a DecoderBlock (hidden 256, 4 heads) on (8, 256, 256) queries over an
     (8, 100, 256) encoder output in bf16, forward and backward against the
     plain attention path (2 K2, 2 K3, 2 K4: cross attention with Lq != Lk),
     and K2-K4 at the cross shape against their twins (ATTN_TOL);
     MoEFeedForward (4 experts, capacity 1.25) at N = 2,048 tokens, index
     dispatch against the one-hot einsum twin within bf16 rounding, with
     dropped tokens too; then at PPO's N = 131,072 tokens, forward +
     backward, under 2 GB above its inputs, timed;
 26. config-5 train steps with 4 experts in both encoder blocks: exactly
     192 K1, 150 K2, 20 K3, 20 K4 as the dense step, finite metrics, the
     experts' w1 moved; sec/step and peak memory;
 27. PolicyNet2(canvas_impl="s2d") against "plain" at Config() on the same
     weights (equal greedy actions at batch 8, values at 160 canvases within
     POLICY_TOL), both trunks timed;
 28. data parallel at world size 1 over NCCL (TCP store, in process):
     `make_sharded_train_step` against `train_step` at config 5 on the same
     state and noise, the all-reduces counted and the same K1-K4 launches;
     `reconstruct_clips(mesh=)` against `reconstruct_clips()` (1 LSB, equal
     actions); `DevicePrefetcher(sharding=mesh)` bitwise;
 29. the model axis at config 5 on a (1, 1) NCCL mesh (in process): the
     tensor-parallel step, the ring-attention step, the step with 4 experts
     and the pipelined step (2 microbatches), each against `train_step` on
     the same state and noise after one PPO epoch (every leaf's Adam first
     moment within MOMENT_TOL; the parameters within 2*lr; on one rank but
     for the ring phase 28's metric and 1e-5 bounds), a planted fault (the
     TP and EP gradients through `reduce_from_model` doubled) that the
     first-moment gate must catch, and at five epochs their K1-K4 launches
     (TP, EP, PP: 192/150/20/20; the ring: 192 K1 and no K2-K4, its blocks
     being torch products), collectives, the seconds of a first and a
     second step and peak memory; then `parallel.dryrun.dryrun_multichip`
     over every visible card (one card: pass 1, data parallel);
 30. the double-buffered step `rl.train_step_pipelined` at config 5 (batch
     8, S = T = 64, phase 12's clips as float): a chain of 3 steps, each on
     the previous next_init, against 3 `train_step`s and each next_init
     against `episode_init`, bit for bit (or the gap printed and held at
     phase 28's bounds), 192/150/20/20 K1-K4 launches a step; the plain
     and pipelined arms interleaved, 10 timed steps each after a warm-up
     (sec/step median and spread, frames/s, peak memory, the bytes of one
     EpisodeInit); one pipelined step under utils.profiling.trace (device
     time summed against busy, the idle share, the init's device time and
     its streams, none of them the step's, and the share of the init's
     window in which the step's streams ran work).

`python3 chip_smoke.py --grid 2x2` (four cards) builds the kernels and runs
phase 29's paths and its planted fault on a (2, 2) NCCL mesh in four
processes, each against `train_step` on its card, then
`dryrun_multichip(4)` (all eight passes); `--grid 1x1` is phase 29 alone,
and `--grid DxM --gate` its one-epoch checks and planted fault alone;
it writes chiprun_out/chip_smoke_grid4.json.

Any failure raises (non-zero exit). Prints a {"kernels": [...]} line (each
kernel's `max_abs_err` from its plain version and its times: `ms`,
`plain_ms` and `library_ms` are CUDA events around 20 calls, 10 for K1's
backward and K2-K4 at the PPO shape; `device_ms` and `library_device_ms`
the profiler's device time of the same calls), the card's name and power
limit, and as the last line
{"ok": true, "device": {...}}. Needs a CUDA device and the rovr_torch package
beside this file; without either it exits non-zero and prints no result.
Writes the full record to chiprun_out/chip_smoke.json; the run directories
of phases 12-23 go under chiprun_out/ too, their checkpoints deleted at the
end, and the frame tree and converted checkpoints of phases 22-24 are
deleted.
"""

from __future__ import annotations

import atexit
import glob
import json
import math
import os
import shutil
import subprocess
import sys
import time

SERVING_SHAPES = {         # name: (B, H, W, Cin, Cout), batch 8 at 256^2
    "conv3": (8, 64, 64, 128, 256),
    "conv4": (8, 32, 32, 256, 512),
    "conv5": (8, 64, 64, 512, 256),
}
PRETRAIN_SHAPES = {        # conv3/4/5 of a pretrain step at Config(): batch 24, 256^2
    "conv3": (24, 64, 64, 128, 256),
    "conv4": (24, 32, 32, 256, 512),
    "conv5": (24, 64, 64, 512, 256),
}
ATTN_SHAPES = {                # name: (B, H, Lq, Lk, D)
    "rollout": (8, 4, 256, 256, 64),
    "ppo": (512, 4, 256, 256, 64),
}
K2_KERNELS = {"tma": "flash_fwd_tma_kernel", "mma": "flash_fwd_kernel"}  # by route
BWD_KERNELS = {"dq": {"tma": "flash_dq_tma_kernel", "mma": "flash_dq_kernel"},     # K3
               "dkv": {"tma": "flash_dkv_tma_kernel", "mma": "flash_dkv_kernel"}}  # K4
K1_TOL = 2e-2     # max|kernel - plain| <= K1_TOL * max|plain|, K1 and its backward
ATTN_TOL = 2e-2   # bf16 outputs (2^-8) and P, dS rounded to bf16
LSE_TOL = 1e-3    # absolute, f32 LSE
POLICY_TOL = 5e-2  # s2d against plain PolicyNet2: logprobs and values, x their scale
TRAIN_STEPS = 3    # timed config-5 train steps after one warm-up
RUN_ITERS = 3      # rl.run iterations at config 5
FLOW_SIZE = 256    # RAFT's input size in the config-5 evaluation
TRAIN_LAUNCHES = {"K1": 192, "K2": 150, "K3": 20, "K4": 20}  # per config-5 step
CORR_SHAPE = (128, 32, 32)   # RAFT's lookup: a chunk of 128 pairs at 256^2 / 8
CORR_TOL = 1e-5    # x max|plain|, f32 out: FMA contraction and sum order only
TIMES = ("ms", "device_ms", "plain_ms", "library_ms", "library_device_ms", "bound_ms")


def log(msg: str) -> None:
    print(msg, flush=True)


def card_line() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip().splitlines()[0]


def cuda_ms(fn, iters: int = 20, warmup: int = 3) -> float:
    import torch

    for _ in range(warmup):
        fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / iters


def profiled_ms(torch, fn, kernel: str | None = None, iters: int = 20,
                captures: int = 3) -> float:
    """Device time of one call of `fn`, summed over the launches of the
    kernels whose name holds `kernel` (every kernel if None; torch.profiler):
    unlike events around a loop, it does not count the host's pace between
    short launches. Every call launches the same kernels, so a capture
    whose matched launches are not a positive multiple of `iters` lost
    events and is not an observation: `fn` runs again under a new capture,
    up to `captures` times; a capture that stays short raises (at iters=1
    that catches only a capture with no launches at all). Range rows, a
    record_function's span on the device, are not kernels and are left out
    (of the paths read with `kernel` None only K1's backward runs under a
    range)."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    for _ in range(captures):
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(iters):
                fn()
            torch.cuda.synchronize()
        rows = [e for e in prof.key_averages()
                if getattr(e, "self_device_time_total", 0) > 0
                and not getattr(e, "is_user_annotation", False)
                and (kernel is None or kernel in e.key)]
        n = sum(e.count for e in rows)
        if n and n % iters == 0:
            return sum(e.self_device_time_total for e in rows) / 1e3 / iters
    raise AssertionError(f"the profiler lost launches of {kernel or 'the kernels'} in "
                         f"{captures} captures of {iters} calls")


def bench_work():
    """h100bench/work.py: the peaks, `conv_bound` and `attention_cost` that
    the benchmark's rooflines divide by, the one definition of K1-K4's
    work."""
    path = os.path.join(os.path.dirname(os.path.abspath(__file__)), "h100bench")
    if path not in sys.path:
        sys.path.append(path)
    import work

    return work


def with_shares(row):
    """A timing row with the share of its bound under events and under
    device time."""
    row.update(bound_share=row["bound_ms"] / row["ms"],
               device_bound_share=row["bound_ms"] / row["device_ms"])
    return row


def summed(name, per, rows):
    """One row of the kernels line from several calls' rows: their times
    summed, their largest distance from the plain version."""
    row = dict(name=name, per=per, **{k: sum(r[k] for r in rows) for k in TIMES},
               max_abs_err=max(r["max_abs_err"] for r in rows))
    row["bound_by"] = "operations" if all(r["bound_by"] == "operations" for r in rows) \
        else "bytes"
    return with_shares(row)


def held(what, got, want, tol):
    """max|got - want|, which must be within tol * max|want|."""
    err = (got.float() - want.float()).abs().max().item()
    if not err <= tol * want.float().abs().max().item():
        raise AssertionError(f"{what}: max|kernel-plain| {err} > {tol} * max|plain|")
    return err


def _conv_inputs(torch, gen, b, h, w, cin, cout):
    x = torch.randn(b, h, w, cin, device="cuda", generator=gen).bfloat16()
    k = (torch.randn(3, 3, cin, cout, device="cuda", generator=gen)
         / math.sqrt(9 * cin)).bfloat16()
    bias = 0.1 * torch.randn(cout, device="cuda", generator=gen)
    return x, k, bias


def phase_k1(torch, conv, F):
    """K1 at the serving UNet call's three shapes: held against its plain
    version (K1_TOL), then timed beside the bound, the plain version and
    cuDNN."""
    work = bench_work()
    gen = torch.Generator(device="cuda").manual_seed(0)
    rows = []
    for name, shape in SERVING_SHAPES.items():
        x, k, bias = _conv_inputs(torch, gen, *shape)
        x_cl = x.permute(0, 3, 1, 2)  # NCHW view, channels_last memory
        w_cl = k.permute(3, 2, 0, 1).contiguous(memory_format=torch.channels_last)
        b16 = bias.bfloat16()

        def kernel():
            return conv.fused_conv3x3(x, k, bias, True)

        def cudnn():
            return F.relu(F.conv2d(x_cl, w_cl, b16, padding=1))

        err = held(f"K1 {name}", kernel(),
                   conv.fused_conv3x3_plain(x.float(), k.float(), bias, True), K1_TOL)
        # events around 20 calls (the host's pace can set them for a short
        # kernel), and the profiler's device time of the same calls
        bound_ms, bound_by, _ = work.conv_bound(*shape)
        r = with_shares(dict(
            call=name, shape=list(shape), max_abs_err=err, ms=cuda_ms(kernel),
            device_ms=profiled_ms(torch, kernel, "conv3x3_kernel"),
            plain_ms=cuda_ms(lambda: conv.fused_conv3x3_plain(x, k, bias, True), iters=5),
            library_ms=cuda_ms(cudnn), library_device_ms=profiled_ms(torch, cudnn),
            bound_ms=bound_ms, bound_by=bound_by))
        rows.append(r)
        log(f"K1 {name} {shape}: events: kernel {r['ms']:.4f} ms ({r['bound_share']:.3f} of "
            f"the bound), cuDNN {r['library_ms']:.4f} ms; device time: kernel "
            f"{r['device_ms']:.4f} ms ({r['device_bound_share']:.3f} of the bound), cuDNN "
            f"{r['library_device_ms']:.4f} ms; plain {r['plain_ms']:.4f} ms, bound "
            f"{bound_ms:.4f} ms ({bound_by}); max|kernel-plain| {err:.4g}")
    return rows


def corr_bound(work, b, h, w):
    """Least time (ms) of one lookup call: the coordinates, an 8 x 8 window of
    each of the 4 levels per position in f32 and the bf16 output, each moved
    once over HBM."""
    n = b * h * w
    nbytes = n * (2 * 4 + 4 * 64 * 4 + 196 * 2)
    return nbytes / work.PEAK_BYTES * 1e3, nbytes


def phase_corr_lookup(torch, corr, raft):
    """RAFT's correlation lookup kernel at RAFT's main shape: held against
    the plain lookup cast to bf16 (one bf16 step, 2^-8) and in f32
    (CORR_TOL), then timed with bf16 out beside its bound and the plain
    lookup's."""
    b, h, w = CORR_SHAPE
    gen = torch.Generator(device="cuda").manual_seed(0)
    f1, f2 = (torch.randn(b, h, w, 128, device="cuda", generator=gen).bfloat16()
              for _ in range(2))
    pyramid = raft.correlation_pyramid(f1, f2)
    gy, gx = torch.meshgrid(torch.arange(h, dtype=torch.float32, device="cuda"),
                            torch.arange(w, dtype=torch.float32, device="cuda"), indexing="ij")
    coords = (torch.stack([gx, gy], dim=-1)[None]
              + 4.0 * torch.randn(b, h, w, 2, device="cuda", generator=gen))

    ref = corr.lookup_corr(pyramid, coords).permute(0, 3, 1, 2)
    err = {name: held(f"corr_lookup {name}", corr.corr_lookup(pyramid, coords, dt),
                      ref.to(dt), tol)
           for name, dt, tol in (("bf16", torch.bfloat16, 2.0 ** -8),
                                 ("f32", torch.float32, CORR_TOL))}

    def kernel():
        return corr.corr_lookup(pyramid, coords, torch.bfloat16)

    def plain():
        return corr.lookup_corr(pyramid, coords).permute(0, 3, 1, 2).to(torch.bfloat16)

    bound_ms, nbytes = corr_bound(bench_work(), b, h, w)
    res = with_shares(dict(
        shape=list(CORR_SHAPE), max_abs_err=err["bf16"], max_abs_err_f32=err["f32"],
        ms=cuda_ms(kernel),
        device_ms=profiled_ms(torch, kernel, "corr_lookup_kernel"),
        plain_ms=cuda_ms(plain, iters=5, warmup=1),
        plain_device_ms=profiled_ms(torch, plain, None, iters=5),
        bound_ms=bound_ms, bound_by="bytes"))
    res["device_gb_per_s"] = nbytes / res["device_ms"] / 1e6
    log(f"corr_lookup {CORR_SHAPE} bf16: events {res['ms']:.4f} ms ({res['bound_share']:.3f} "
        f"of the bound), device {res['device_ms']:.4f} ms ({res['device_bound_share']:.3f}, "
        f"{res['device_gb_per_s']:.0f} GB/s); plain {res['plain_ms']:.4f} ms events, "
        f"{res['plain_device_ms']:.4f} ms device; bound {bound_ms:.4f} ms (bytes); "
        f"max|kernel-plain| {err}")
    return res


def phase_k1_backward(torch, conv, F):
    """K1's backward (cuDNN's conv gradient in bf16, `fused_conv3x3_backward`)
    at the pretrain step's shapes: held against its f32 plain twin
    (`fused_conv3x3_backward_plain`, K1_TOL), then CUDA-event and device
    times beside
    cuDNN's forward+backward (the library yardstick), the plain-autograd
    backward the port ran before (`plain_ms`: autograd through the f32
    plain version) and its bound (dgrad + wgrad over the peak, or x, k, y, g
    read and gx, gk, gb written over HBM)."""
    work = bench_work()
    gen = torch.Generator(device="cuda").manual_seed(10)
    rows = []
    for name, (b, h, w, cin, cout) in PRETRAIN_SHAPES.items():
        x, k, bias = _conv_inputs(torch, gen, b, h, w, cin, cout)
        g = torch.randn(b, h, w, cout, device="cuda", generator=gen).bfloat16()
        y = conv.fused_conv3x3(x, k, bias, True)
        x_cl = x.permute(0, 3, 1, 2).detach().requires_grad_()
        w_cl = k.permute(3, 2, 0, 1).contiguous(memory_format=torch.channels_last) \
            .requires_grad_()
        b16 = bias.bfloat16().requires_grad_()
        g_cl = g.permute(0, 3, 1, 2)

        def bwd():
            return conv.fused_conv3x3_backward(x, k, y, g, True)

        def cudnn_fb():
            out = F.relu(F.conv2d(x_cl, w_cl, b16, padding=1))
            return torch.autograd.grad(out, (x_cl, w_cl, b16), g_cl)

        def plain_backward():
            with torch.enable_grad():
                xs, ks, bs = (t.detach().float().requires_grad_() for t in (x, k, bias))
                return torch.autograd.grad(conv.fused_conv3x3_plain(xs, ks, bs, True),
                                           (xs, ks, bs), g.float())

        err = max(held(f"K1 backward {gname} {name}", a, want, K1_TOL) for gname, a, want in zip(
            ("gx", "gk", "gb"), bwd(), conv.fused_conv3x3_backward_plain(x, k, y, g, True)))
        flops = 2 * 2.0 * b * h * w * 9 * cin * cout   # dgrad + wgrad
        nbytes = (2.0 * 2 * b * h * w * cin + 2.0 * 2 * 9 * cin * cout     # x, gx; k, gk
                  + 2.0 * 2 * b * h * w * cout + 4.0 * cout)              # y, g; gb
        t_ops, t_bytes = flops / work.PEAK_BF16_FLOPS, nbytes / work.PEAK_BYTES
        bound_ms = max(t_ops, t_bytes) * 1e3
        r = with_shares(dict(
            call=name, shape=[b, h, w, cin, cout], max_abs_err=err, ms=cuda_ms(bwd, 10),
            device_ms=profiled_ms(torch, bwd, None, 10),
            plain_ms=cuda_ms(plain_backward, iters=3, warmup=1),
            library_ms=cuda_ms(cudnn_fb, 10),
            library_device_ms=profiled_ms(torch, cudnn_fb, None, 10),
            bound_ms=bound_ms, bound_by="operations" if t_ops >= t_bytes else "bytes"))
        rows.append(r)
        log(f"K1 backward {name} {(b, h, w, cin, cout)}: events {r['ms']:.4f} ms, device "
            f"{r['device_ms']:.4f} ms, bound {bound_ms:.4f} ms ({r['device_bound_share']:.3f} "
            f"of it in device time); cuDNN forward+backward events {r['library_ms']:.4f} "
            f"device {r['library_device_ms']:.4f}; the plain-autograd backward "
            f"{r['plain_ms']:.3f} ms ({r['plain_ms'] / r['ms']:.1f}x); max|kernel-plain| "
            f"{err:.4g}")
    return rows


def phase_attention(torch, attention, F):
    """K2-K4 at the PPO shape and K2 at the rollout shape: each output held
    against its plain twin (ATTN_TOL; K2's LSE within LSE_TOL), then CUDA
    events around `iters` calls and the profiler's device time of the same
    calls, beside the bound (work.py's `attention_bound_ms`), the plain
    twins and SDPA (its forward for K2; for K3 and K4 its whole backward,
    forward+backward less forward, which computes dq, dk and dv together).
    One row per kernel and shape."""
    work = bench_work()
    gen = torch.Generator(device="cuda").manual_seed(3)
    rows = []
    for name, kinds in (("ppo", ("fwd", "dq", "dkv")), ("rollout", ("fwd",))):
        b, h, lq, lk, d = ATTN_SHAPES[name]
        iters = 20 if name == "rollout" else 10
        q, k, v, do = (torch.randn(b, h, n, d, device="cuda", generator=gen).bfloat16()
                       for n in (lq, lk, lk, lq))
        o, lse = attention.flash_attention_fwd(q, k, v)
        delta = (do.float() * o.float()).sum(-1)
        args = {"fwd": (q, k, v), "dq": (q, k, v, do, lse, delta),
                "dkv": (q, k, v, do, lse, delta)}
        qg, kg, vg = (t.clone().requires_grad_() for t in (q, k, v))
        sdpa = {"fwd": lambda: F.scaled_dot_product_attention(q, k, v),
                "fwd_bwd": lambda: torch.autograd.grad(
                    F.scaled_dot_product_attention(qg, kg, vg), (qg, kg, vg), do)}
        lib = {key: (cuda_ms(fn, iters), profiled_ms(torch, fn, None, iters))
               for key, fn in sdpa.items()}
        lib["bwd"] = tuple(fb - f for fb, f in zip(lib["fwd_bwd"], lib["fwd"]))
        route = attention.flash_fwd_route(d)  # "tma" at both shapes (D = 64)
        flops, nbytes = work.attention_cost(b, h, lq, lk, d)   # lq == lk at both
        for kind in kinds:
            fn = getattr(attention, f"flash_attention_{kind}")
            plain = getattr(attention, f"flash_attention_{kind}_plain")
            got, want = fn(*args[kind]), plain(*args[kind])
            if kind == "fwd" and not (got[1] - want[1]).abs().max().item() <= LSE_TOL:
                raise AssertionError(f"K2's LSE at {name} is off its plain twin's")
            got, want = {"fwd": (got[:1], want[:1]), "dq": ((got,), (want,)),
                         "dkv": (got, want)}[kind]
            err = max(held(f"{kind} {name}", a, p, ATTN_TOL) for a, p in zip(got, want))
            key = K2_KERNELS[route] if kind == "fwd" else BWD_KERNELS[kind][route]
            bound_ms = work.attention_bound_ms(b, h, lq, d, kind)
            bound_by = "operations" if flops[kind] / work.PEAK_BF16_FLOPS \
                >= nbytes[kind] / work.PEAK_BYTES else "bytes"
            lib_ms, lib_dev_ms = lib["fwd" if kind == "fwd" else "bwd"]
            r = with_shares(dict(
                name=f"flash_attention_{kind}", shape=[b, h, lq, lk, d], call=name,
                max_abs_err=err,
                ms=cuda_ms(lambda: fn(*args[kind]), iters),
                device_ms=profiled_ms(torch, lambda: fn(*args[kind]), key, iters),
                plain_ms=cuda_ms(lambda: plain(*args[kind]), 5),
                library_ms=lib_ms, library_device_ms=lib_dev_ms,
                bound_ms=bound_ms, bound_by=bound_by))
            rows.append(r)
            log(f"{dict(fwd='K2', dq='K3', dkv='K4')[kind]} {name} "
                f"{(b, h, lq, lk, d)}: events {r['ms']:.4f} ms ({r['bound_share']:.3f} of the "
                f"bound), device {r['device_ms']:.4f} ms ({r['device_bound_share']:.3f}); "
                f"SDPA {'forward' if kind == 'fwd' else 'backward'} events {lib_ms:.4f} "
                f"device {lib_dev_ms:.4f}; plain {r['plain_ms']:.4f} ms; bound "
                f"{bound_ms:.4f} ms ({bound_by}); max|kernel-plain| {err:.4g}")
    return rows


def kernels_line(k1, k1_bwd, attn, lookup):
    """The {"kernels": [...]} line, one row per kernel and timed shape: K1
    per serving UNet call and its backward per pretrain UNet call, K2-K4
    per call at each timed shape, the lookup per call at RAFT's main
    shape."""
    return [
        summed("fused_conv3x3", "one UNet call: conv3 + conv4 + conv5 at batch 8, 256^2; "
               "library: cuDNN conv2d + bias + ReLU", k1),
        summed("fused_conv3x3_backward", "one pretrain UNet call: conv3 + conv4 + conv5 at "
               "batch 24, 256^2; plain: autograd through the f32 plain version; library: "
               "cuDNN forward+backward", k1_bwd),
        *(dict(r, per=f"one call at the {r['call']} shape; library: SDPA "
               + ("forward" if r["name"] == "flash_attention_fwd" else
                  "backward (forward+backward less forward: dq, dk and dv together)"))
          for r in attn),
        dict(lookup, name="corr_lookup", per="one call at RAFT's main shape (128 pairs, "
             "32 x 32 positions, levels 32/16/8/4), bf16 out"),
    ]


def config5(Config):
    """Config 5 at the JAX package's one-chip measurement (bench.py
    "scaled"): config_rl_scaled(64, data_parallel=1) at batch 8, LPIPS
    taps cached from stage 1, the init pass in chunks of 8 frames."""
    import dataclasses

    from rovr_torch.config import config_rl_scaled

    c = config_rl_scaled(vid_length=64, data_parallel=1)
    return c.replace(
        rl=dataclasses.replace(c.rl, batch_size=8),
        model=dataclasses.replace(c.model, lpips_cache_from_stage=1,
                                  lpips_init_chunk=8))


def _counts(conv, attention):
    return {"K1": conv.fused_conv3x3.launches,
            "K2": attention.flash_attention_fwd.launches,
            "K3": attention.flash_attention_dq.launches,
            "K4": attention.flash_attention_dkv.launches}


def _zero_counts(conv, attention):
    conv.fused_conv3x3.launches = 0
    conv.fused_conv3x3.backward_calls = 0
    for fn in (attention.flash_attention_fwd, attention.flash_attention_dq,
               attention.flash_attention_dkv):
        fn.launches = 0


def config5_clips(torch, np, synthetic, cfg):
    """uint8 (corrupted, original) clips of config 5, batch 8, on the card,
    and their float masks."""
    b, s = cfg.rl.batch_size, cfg.rl.vid_length
    h, w = cfg.data.frame_size
    data = synthetic.synthetic_clips(200, 0, b, s, h, w)
    u8 = [np.clip(data[i] * 255.0 + 0.5, 0, 255).astype(np.uint8) for i in (0, 1)]
    masks = torch.from_numpy(data[2]).cuda()
    return u8[0], [torch.from_numpy(x).cuda() for x in u8], masks


def phase_serve_counts(torch, np, conv, attention, Config, rl, infer, synthetic, cfg5, u8_5):
    """One greedy served batch (`infer.reconstruct_clips`) at Config() (batch
    8, S = T = 20) and one at config 5 (phase 12's clips): uint8 frames of
    the input's shape, some written, actions in [0, S) (off the target where
    the canvas policy masks it out; the attention policy only zeroes its
    logit), and exactly 60 K1, or 192 K1 and 128 K2, and no K3 or K4."""
    import dataclasses

    c = Config()
    cfg = c.replace(rl=dataclasses.replace(c.rl, batch_size=8, vid_length=20, time_steps=20))
    h, w = cfg.data.frame_size
    clips = np.stack([synthetic.synthetic_batch(j, 20, h, w)[0] for j in range(8)])
    u8 = np.clip(clips * 255.0 + 0.5, 0, 255).astype(np.uint8)
    res = {}
    for name, cfg, u8, k1, k2 in (("config", cfg, u8, 60, 0), ("config5", cfg5, u8_5, 192, 128)):
        mods = rl.make_modules(cfg, device="cuda")
        state = rl.init_state(cfg, mods, seed=0)
        _zero_counts(conv, attention)   # counts from here are this batch's
        ((recon, actions),) = infer.reconstruct_clips(cfg, state, mods, [u8])
        counts = _counts(conv, attention)
        (b, s), t = u8.shape[:2], cfg.rl.time_steps
        tgt = (np.arange(t) % s)[:, None, None]
        off = (actions != tgt) | (cfg.rl.context_policy == "attention")
        if recon.shape != u8.shape or recon.dtype != np.uint8 or actions.shape != (t, b, 2) \
                or np.array_equal(recon, u8) \
                or not ((actions >= 0) & (actions < s) & off).all():
            raise AssertionError(f"{name} serving: frames {recon.shape} {recon.dtype}, "
                                 f"actions {actions.shape}")
        if counts != {"K1": k1, "K2": k2, "K3": 0, "K4": 0}:
            raise AssertionError(f"{name} serving launched {counts} in one batch, expected "
                                 f"K1 {k1}, K2 {k2} and no K3 or K4")
        res[name] = dict(batch=b, vid_length=s, launches=counts)
        log(f"{name} serving: one batch of {b} x {s} frames, launches {counts}")
        del mods, state
    return res


def _finite_metrics(metrics):
    out = {k: float(v) for k, v in metrics.items()}
    if not all(math.isfinite(v) for v in out.values()):
        raise AssertionError(f"non-finite train metric: {out}")
    return out


def _moved(new, old):
    return max((new[k].float() - old[k].float()).abs().max().item() for k in old)


class ClipSource:
    """A clip source for `rl.run` and `evaluate` (`next(i)` -> (corrupted, original, masks)):
    the same batch built once on the card, so a phase times the loop and
    not the host synthetic source."""

    def __init__(self, video, org, masks):
        self.batch = (video, org, masks)

    def next(self, i):
        return self.batch


def _same_tree(a, b) -> bool:
    """Equal structure, dtypes and values, bit for bit."""
    if isinstance(a, tuple) and hasattr(a, "_fields"):
        return type(a) is type(b) and all(_same_tree(getattr(a, f), getattr(b, f))
                                          for f in a._fields)
    if isinstance(a, dict):
        return set(a) == set(b) and all(_same_tree(a[k], b[k]) for k in a)
    if hasattr(a, "dtype") and hasattr(a, "device"):
        import torch

        return a.dtype == b.dtype and a.device == b.device and torch.equal(a, b)
    if isinstance(a, (list, tuple)):
        return (type(a) is type(b) and len(a) == len(b)
                and all(_same_tree(x, y) for x, y in zip(a, b)))
    return a == b


def _run_records(run_root: str, experiment: str):
    """The metrics.jsonl records of the one run under run_root/experiment,
    checked finite, and that run's directory."""
    (path,) = glob.glob(os.path.join(run_root, experiment, "*", "metrics.jsonl"))
    with open(path) as f:
        recs = [json.loads(line) for line in f]
    bad = [r for r in recs if not math.isfinite(r["value"])]
    if not recs or bad:
        raise AssertionError(f"{path}: {len(recs)} records, non-finite {bad[:3]}")
    return recs, os.path.dirname(path)


def _drop_checkpoints(run_root: str) -> None:
    """Checkpoints are hundreds of MB at config 5: keep the logs only."""
    for ck in glob.glob(os.path.join(run_root, "*", "*", "checkpoints")):
        shutil.rmtree(ck)


def phase_rl_run5(torch, conv, attention, rl, checkpoint, cfg, source, out_dir):
    """`rl.run` at config 5: RUN_ITERS iterations with a checkpoint and
    metrics each, then one more from `restore_from`."""
    import dataclasses

    run_root = os.path.join(out_dir, "smoke_rl_run")
    shutil.rmtree(run_root, ignore_errors=True)
    cfg = cfg.replace(run=dataclasses.replace(cfg.run, run_dir=run_root, seed=0,
                                              checkpoint_every=1, log_every=1,
                                              restore_from=None))
    marks = []

    def log_cb(i, metrics):  # after iteration i's step, before its checkpoint
        torch.cuda.synchronize()
        marks.append((time.time(), _counts(conv, attention)))

    dev = source.batch[0].device
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    _zero_counts(conv, attention)   # counts from here are rl.run's
    t0 = time.time()
    state = rl.run(cfg, iterations=RUN_ITERS, log_cb=log_cb, source=source, device=dev)
    total_s = time.time() - t0
    prev_c, prev_t, iter_s = {k: 0 for k in TRAIN_LAUNCHES}, t0, []
    for i, (t, c) in enumerate(marks):
        d = {k: c[k] - prev_c[k] for k in c}
        if d != TRAIN_LAUNCHES:
            raise AssertionError(f"rl.run iteration {i} launched {d}, expected {TRAIN_LAUNCHES}")
        iter_s.append(t - prev_t)
        prev_c, prev_t = c, t
    if len(marks) != RUN_ITERS or state.step != RUN_ITERS:
        raise AssertionError(f"rl.run took {len(marks)} logged steps, state.step {state.step}")
    peak = torch.cuda.max_memory_allocated() / 1e9

    recs, path = _run_records(run_root, "rovr_rl")
    tags = {r["tag"] for r in recs}
    if "Episode/exposure" not in tags or {r["step"] for r in recs} != set(range(RUN_ITERS)):
        raise AssertionError(f"rl.run metrics: tags {sorted(tags)}")
    images = glob.glob(os.path.join(path, "images", "*.png")) or glob.glob(
        os.path.join(path, "events.out.tfevents*"))
    if not images:
        raise AssertionError("rl.run wrote no image strip")
    ck = checkpoint.latest_checkpoint_dir(run_root, "rovr_rl")
    steps = sorted(os.listdir(ck))
    restored = checkpoint.CheckpointManager(ck).restore(template=state)
    if steps != [str(i) for i in range(RUN_ITERS)] or not _same_tree(restored, state):
        raise AssertionError(f"checkpoint {ck} ({steps}) does not restore the state")
    ck_bytes = os.path.getsize(os.path.join(ck, steps[-1], "state.pt"))

    probe = checkpoint.CheckpointManager(os.path.join(run_root, "probe"))
    torch.cuda.synchronize()
    t1 = time.time()
    probe.save(0, state)   # the host copy, on this thread
    t2 = time.time()
    probe.wait()           # the write, on the background thread
    save_s, wait_s = t2 - t1, time.time() - t2
    shutil.rmtree(probe.directory)

    resume = cfg.replace(run=dataclasses.replace(cfg.run, restore_from=ck))
    _zero_counts(conv, attention)   # the resumed run's own counts
    t1 = time.time()
    resumed = rl.run(resume, iterations=1, source=source, device=dev)
    resume_s = time.time() - t1
    counts = _counts(conv, attention)
    if resumed.step != state.step + 1 or counts != TRAIN_LAUNCHES:
        raise AssertionError(f"resumed run: step {resumed.step} after {state.step}, "
                             f"launches {counts}")
    _drop_checkpoints(run_root)
    res = dict(iterations=RUN_ITERS, iter_s=iter_s, total_s=total_s, resume_s=resume_s,
               launches_per_iteration=TRAIN_LAUNCHES, checkpoint_bytes=ck_bytes,
               save_s=save_s, wait_s=wait_s, peak_mem_gb=peak, state_step=state.step,
               resumed_step=resumed.step, metric_tags=sorted(tags),
               last=[r for r in recs if r["step"] == RUN_ITERS - 1])
    log(f"config-5 rl.run: {RUN_ITERS} iterations in {total_s:.2f} s (per iteration "
        + ", ".join(f"{x:.3f}" for x in iter_s) + " s; the first includes set-up), "
        f"launches {TRAIN_LAUNCHES} each; checkpoint {ck_bytes / 1e6:.1f} MB, save "
        f"{save_s:.3f} s on the training thread + {wait_s:.3f} s written in the "
        f"background; restored bit for bit; resumed run {resume_s:.2f} s to step "
        f"{resumed.step}; peak {peak:.2f} GB")
    return res, state


def phase_eval5(torch, conv, attention, evaluate, rl, cfg, state, source, out_dir):
    """One evaluate.run batch and one run_ci batch (2 draws) at config 5;
    one eval_step under torch.profiler, RAFT's device time beside it."""
    import dataclasses
    from torch.profiler import ProfilerActivity, profile

    from rovr_torch.models.raft import pairwise_flows, total_flow_magnitude
    from rovr_torch.ops import corr

    run_root = os.path.join(out_dir, "smoke_eval")
    shutil.rmtree(run_root, ignore_errors=True)
    cfg = cfg.replace(run=dataclasses.replace(cfg.run, run_dir=run_root))
    b, t_steps, depth = cfg.rl.batch_size, cfg.rl.time_steps, cfg.model.attn_depth
    dev = source.batch[0].device
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    _zero_counts(conv, attention)   # counts from here are evaluate.run's
    lookups, calls = corr.corr_lookup.launches, pairwise_flows.calls
    t0 = time.time()
    means = evaluate.run(cfg, num_videos=b, state=state, flow_size=FLOW_SIZE, source=source,
                         device=dev)
    run_s = time.time() - t0
    counts = _counts(conv, attention)
    lookups, calls = corr.corr_lookup.launches - lookups, pairwise_flows.calls - calls
    # 3 K1 per UNet call (agentic and sequential each step), K2 per policy
    # act per encoder block: 384 and 128 at config 5
    want = {"K1": 3 * 2 * t_steps, "K2": depth * t_steps, "K3": 0, "K4": 0}
    if counts != want:
        raise AssertionError(f"evaluate.run launched {counts}, expected {want}")
    if not all(math.isfinite(v) for v in means.values()):
        raise AssertionError(f"non-finite eval metric: {means}")
    if means["Eval/psnr_agentic"] == means["Eval/psnr_sequential"]:
        raise AssertionError("the sequential baseline equals the agentic output")
    _run_records(run_root, "eval")
    peak_run = torch.cuda.max_memory_allocated() / 1e9

    mods = evaluate.make_modules(cfg, device=dev)
    if not calls or lookups != mods.raft.iters * calls:   # one lookup a RAFT iteration
        raise AssertionError(f"evaluate.run: {lookups} lookup launches for {calls} RAFT "
                             f"calls of {mods.raft.iters} iterations")
    raft = evaluate.init_raft_params(mods, 0)
    batch = source.next(0)
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t1 = time.time()
        evaluate.eval_step(state, raft, mods, cfg, batch, FLOW_SIZE)
        torch.cuda.synchronize()
        step_wall_ms = (time.time() - t1) * 1e3
    rows, busy_ms = _profile_rows(torch, prof.key_averages())
    org = batch[1].float() * (1.0 / 255.0)
    with torch.no_grad():
        phi_ms = profiled_ms(torch, lambda: total_flow_magnitude(
            pairwise_flows(mods.raft, org, FLOW_SIZE)), None, iters=1)
    raft_ms = 4 * phi_ms   # eval_step runs four passes of the same shape

    torch.cuda.reset_peak_memory_stats()
    _zero_counts(conv, attention)   # counts from here are run_ci's
    t1 = time.time()
    ci = evaluate.run_ci(cfg, state=state, num_videos=b, sample_draws=2, mods=mods,
                         source=source)
    ci_s = time.time() - t1
    ci_counts = _counts(conv, attention)
    # the greedy pass as above, then the sampled pass (agentic only) on the
    # 2 replicas: 576 K1 and 256 K2 at config 5
    want = {"K1": 3 * 3 * t_steps, "K2": depth * 2 * t_steps, "K3": 0, "K4": 0}
    if ci_counts != want:
        raise AssertionError(f"run_ci launched {ci_counts}, expected {want}")
    flat = [x for ms in ci["per_clip"].values() for v in ms.values() for x in v]
    if len(flat) == 0 or not all(math.isfinite(x) for x in flat):
        raise AssertionError("non-finite run_ci metric")
    g = ci["per_clip"]["greedy"]
    if g["psnr_agentic"] == g["psnr_sequential"]:
        raise AssertionError("run_ci: the sequential baseline equals the agentic output")
    res = dict(run_s=run_s, launches=counts, lookup_launches=lookups, raft_calls=calls,
               means=means, peak_mem_gb=peak_run,
               eval_step_wall_ms=step_wall_ms, eval_step_device_ms=busy_ms,
               eval_step_idle_share=(1 - busy_ms / step_wall_ms) if busy_ms else None,
               raft_device_ms=raft_ms, raft_share=(raft_ms / busy_ms) if busy_ms else None,
               eval_step_top=rows[:20],
               ci_s=ci_s, ci_launches=ci_counts, ci_summary=ci["summary"],
               ci_peak_mem_gb=torch.cuda.max_memory_allocated() / 1e9)
    log(f"config-5 evaluate.run (1 batch of {b}): {run_s:.2f} s, launches {counts}, "
        f"{lookups} lookups over {calls} RAFT calls, peak {peak_run:.2f} GB; means " + ", ".join(
            f"{k.split('/')[-1]} {v:.4f}" for k, v in sorted(means.items())))
    log(f"config-5 eval_step under the profiler: wall {step_wall_ms:.1f} ms, device busy "
        f"{busy_ms:.1f} ms, RAFT (4 passes x {b * (cfg.rl.vid_length - 1)} pairs) "
        f"{raft_ms:.1f} ms of device "
        f"time ({res['raft_share'] or 0:.3f} of the step's)")
    for r in rows[:20]:
        log(f"  {r['ms']:9.3f} ms  x{r['count']:<6d} {r['kernel']}")
    log(f"config-5 run_ci (1 batch, 2 draws): {ci_s:.2f} s, launches {ci_counts}, peak "
        f"{res['ci_peak_mem_gb']:.2f} GB")
    del mods
    return res


PI1_RANGES = ("rovr/pi1_act", "rovr/pi1_lstm", "rovr/pi1_ppo")  # rl.py's profiler ranges


def config5_pi1(cfg):
    """Config 5 with the frame-selection policy trained: use_policy1 and
    ppo_policy1 (π₁ channels 32-256 on the 256^2 canvas, a 4096 -> 64
    head, the ActionLSTM at hidden 1024 with a 256^2 token)."""
    import dataclasses

    return cfg.replace(rl=dataclasses.replace(cfg.rl, use_policy1=True, ppo_policy1=True))


def phase_train5_pi1(torch, conv, attention, rl, cfg, video, org, masks):
    """Config-5 train steps with π₁ (use_policy1, ppo_policy1): one warm-up,
    then TRAIN_STEPS timed steps, each launching exactly what a step
    without π₁ does; then one step under torch.profiler, π₁'s ranges'
    device time and share."""
    from torch.profiler import ProfilerActivity, profile

    cfg = config5_pi1(cfg)
    mods = rl.make_modules(cfg, device=video.device)
    state = rl.init_state(cfg, mods, seed=0)
    gen = torch.Generator(device=video.device).manual_seed(20)
    targets = []
    real_rollout = rl.rollout

    def rollout(*a, **kw):   # keep each step's targets (π₁'s actions)
        out = real_rollout(*a, **kw)
        targets.append(out.traj.target_idx)
        return out

    rl.rollout = rollout
    frozen = ("lstm", "local_net", "vp")
    s_frames = cfg.rl.vid_length
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    _zero_counts(conv, attention)   # counts from here are the π₁ train path's
    times, steps = [], []
    try:
        for i in range(1 + TRAIN_STEPS):
            before = _counts(conv, attention)
            t0 = time.time()
            new, metrics, recon = rl.train_step(state, mods, cfg, video, org,
                                                generator=gen, masks=masks)
            torch.cuda.synchronize()
            times.append(time.time() - t0)
            after = _counts(conv, attention)
            step_counts = {k: after[k] - before[k] for k in after}
            if step_counts != TRAIN_LAUNCHES:
                raise AssertionError(f"π₁ train step {i} launched {step_counts}, "
                                     f"expected {TRAIN_LAUNCHES}")
            m = _finite_metrics(metrics)
            if not ({"PPO/actor1_loss", "PPO/critic1_loss"} <= set(m)
                    and 0 < m["Episode/coverage"] <= 1):
                raise AssertionError(f"π₁ train step {i} metrics {m}")
            tgt = targets[-1]
            if not ((tgt >= 0) & (tgt < s_frames)).all():
                raise AssertionError(f"π₁ targets out of [0, {s_frames})")
            moved = {f: _moved(getattr(new, f"{f}_params"), getattr(state, f"{f}_params"))
                     for f in ("actor1", "critic1", "actor2", "critic2")}
            still = {f: _moved(getattr(new, f"{f}_params"), getattr(state, f"{f}_params"))
                     for f in frozen}
            if not all(v > 0 and math.isfinite(v) for v in moved.values()) or any(
                    still.values()):
                raise AssertionError(f"π₁ train step {i}: moved {moved}, frozen {still}")
            if recon.shape != video.shape or not torch.isfinite(recon).all():
                raise AssertionError("π₁ train step reconstruction not finite / wrong shape")
            steps.append(dict(seconds=times[-1], metrics=m, moved=moved,
                              distinct_targets=[int(x) for x in
                                                torch.nn.functional.one_hot(tgt, s_frames)
                                                .any(0).sum(1).tolist()]))
            log(f"config-5 π₁ train step {i}: {times[-1]:.3f} s, launches {step_counts}, "
                f"metrics {m}, max|param change| {moved}")
            state = new
        peak = torch.cuda.max_memory_allocated() / 1e9

        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            t0 = time.time()
            rl.train_step(state, mods, cfg, video, org, generator=gen)
            torch.cuda.synchronize()
            wall_ms = (time.time() - t0) * 1e3
    finally:
        rl.rollout = real_rollout
    avgs = prof.key_averages()
    rows, busy_ms = _profile_rows(torch, avgs)
    ranges = _range_times(torch, avgs, PI1_RANGES)
    if busy_ms == 0 or set(ranges) != set(PI1_RANGES) or any(
            r["device_ms"] is None for r in ranges.values()):
        log(f"π₁ profile: device busy {busy_ms} ms, ranges {sorted(ranges)} (not measured)")
        prof_res = dict(wall_ms=wall_ms, device_ms=None, ranges=ranges)
    else:
        pi1_ms = sum(r["device_ms"] for r in ranges.values())
        span_ms = sum(r["span_ms"] or 0.0 for r in ranges.values())
        prof_res = dict(wall_ms=wall_ms, device_ms=busy_ms, idle_share=1 - busy_ms / wall_ms,
                        ranges=ranges, pi1_device_ms=pi1_ms, pi1_share=pi1_ms / busy_ms,
                        pi1_span_ms=span_ms, top=rows[:25])
        log(f"profile of one config-5 π₁ train step: wall {wall_ms:.1f} ms, device busy "
            f"{busy_ms:.1f} ms (idle share {prof_res['idle_share']:.3f}); π₁ ranges (device "
            "ms of their kernels, share of the busy time; span on the device timeline): "
            + ", ".join(f"{k} {r['device_ms']:.1f} ({r['device_ms'] / busy_ms:.3f}, "
                        f"x{r['count']}; span {r['span_ms']})" for k, r in ranges.items())
            + f"; π₁ in all {pi1_ms:.1f} ms ({prof_res['pi1_share']:.3f}; the backward's "
            f"kernels run on autograd's thread, outside these sums), spans {span_ms:.1f} ms")
        for r in rows[:25]:
            log(f"  {r['ms']:9.3f} ms  x{r['count']:<6d} {r['kernel']}")
    sec = _median(times[1:])
    b = video.shape[0]
    res = dict(batch=b, vid_length=s_frames, steps=steps, warmup_s=times[0],
               sec_per_step_each=times[1:], sec_per_step=sec,
               frames_per_sec=b * cfg.rl.time_steps / sec,
               launches_per_step=TRAIN_LAUNCHES, peak_mem_gb=peak, profile=prof_res,
               state_step=state.step)
    log(f"config-5 π₁ train: {sec:.4f} s/step (median of {TRAIN_STEPS}; warm-up "
        f"{times[0]:.2f} s); launches {TRAIN_LAUNCHES} per step; peak {peak:.2f} GB")
    return res


PI1_RUN_ITERS = 2   # rl.run iterations with π₁ at config 5


def phase_rl_run5_pi1(torch, conv, attention, rl, checkpoint, cfg, source, here, out_dir,
                      rl_run5):
    """`rl.run` with π₁ at config 5: PI1_RUN_ITERS iterations with a
    checkpoint each, the newest restored bit for bit (π₁'s parameters and
    both new Adam states included), one resumed iteration; then `python -m
    rovr_torch rl --ppo_policy1 --iterations 1` at Config()."""
    import dataclasses

    run_root = os.path.join(out_dir, "smoke_rl_run_pi1")
    shutil.rmtree(run_root, ignore_errors=True)
    cfg = config5_pi1(cfg)
    cfg = cfg.replace(run=dataclasses.replace(cfg.run, run_dir=run_root, seed=0,
                                              checkpoint_every=1, log_every=1,
                                              restore_from=None))
    dev = source.batch[0].device
    marks = []

    def log_cb(i, metrics):
        torch.cuda.synchronize()
        marks.append((time.time(), _counts(conv, attention)))

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    _zero_counts(conv, attention)   # counts from here are this run's
    t0 = time.time()
    state = rl.run(cfg, iterations=PI1_RUN_ITERS, log_cb=log_cb, source=source, device=dev)
    total_s = time.time() - t0
    prev, iter_s, prev_t = {k: 0 for k in TRAIN_LAUNCHES}, [], t0
    for i, (t, c) in enumerate(marks):
        d = {k: c[k] - prev[k] for k in c}
        if d != TRAIN_LAUNCHES:
            raise AssertionError(f"π₁ rl.run iteration {i} launched {d}")
        iter_s.append(t - prev_t)
        prev, prev_t = c, t
    if state.step != PI1_RUN_ITERS or state.actor1_opt["step"] != \
            PI1_RUN_ITERS * cfg.rl.n_updates_per_ppo:
        raise AssertionError(f"π₁ rl.run: step {state.step}, actor1 Adam "
                             f"{state.actor1_opt['step']}")
    peak = torch.cuda.max_memory_allocated() / 1e9
    recs, _ = _run_records(run_root, "rovr_rl")
    tags = {r["tag"] for r in recs}
    if not {"PPO/actor1_loss", "PPO/critic1_loss", "Episode/coverage"} <= tags:
        raise AssertionError(f"π₁ rl.run metrics: tags {sorted(tags)}")
    ck = checkpoint.latest_checkpoint_dir(run_root, "rovr_rl")
    steps = sorted(os.listdir(ck))
    restored = checkpoint.CheckpointManager(ck).restore(template=state)
    if steps != [str(i) for i in range(PI1_RUN_ITERS)] or not _same_tree(restored, state) \
            or restored.actor1_opt is None or restored.lstm_params is None:
        raise AssertionError(f"π₁ checkpoint {ck} ({steps}) does not restore the state")
    ck_bytes = os.path.getsize(os.path.join(ck, steps[-1], "state.pt"))
    resume = cfg.replace(run=dataclasses.replace(cfg.run, restore_from=ck))
    _zero_counts(conv, attention)
    t1 = time.time()
    resumed = rl.run(resume, iterations=1, source=source, device=dev)
    resume_s = time.time() - t1
    counts = _counts(conv, attention)
    if resumed.step != state.step + 1 or counts != TRAIN_LAUNCHES:
        raise AssertionError(f"π₁ resumed run: step {resumed.step} after {state.step}, "
                             f"launches {counts}")
    _drop_checkpoints(run_root)

    sub_root = os.path.join(run_root, "cli")
    _, cli_s = python_m(here, "rl", "--ppo_policy1", "--iterations", "1", "--run_dir",
                        sub_root)
    cli_recs, _ = _run_records(sub_root, "rovr_rl")
    if "PPO/actor1_loss" not in {r["tag"] for r in cli_recs}:
        raise AssertionError("python -m rovr_torch rl --ppo_policy1: no PPO/actor1_loss")
    _drop_checkpoints(sub_root)
    res = dict(iterations=PI1_RUN_ITERS, iter_s=iter_s, total_s=total_s, resume_s=resume_s,
               checkpoint_bytes=ck_bytes, checkpoint_bytes_without_pi1=
               rl_run5["checkpoint_bytes"], peak_mem_gb=peak, state_step=state.step,
               resumed_step=resumed.step, cli_s=cli_s, metric_tags=sorted(tags))
    log(f"config-5 π₁ rl.run: {PI1_RUN_ITERS} iterations in {total_s:.2f} s (per iteration "
        + ", ".join(f"{x:.3f}" for x in iter_s) + f" s), launches {TRAIN_LAUNCHES} each; "
        f"checkpoint {ck_bytes / 1e6:.1f} MB (without π₁, phase 12: "
        f"{rl_run5['checkpoint_bytes'] / 1e6:.1f} MB), restored bit for bit; resumed to "
        f"step {resumed.step} in {resume_s:.2f} s; peak {peak:.2f} GB; python -m rovr_torch "
        f"rl --ppo_policy1 (Config()) {cli_s:.2f} s, exit 0")
    return res


def python_m(here, *args):
    """`python -m rovr_torch <args>` in a subprocess from the checkout;
    raises unless it exits 0. Returns (stdout, seconds)."""
    t = time.time()
    out = subprocess.run([sys.executable, "-m", "rovr_torch", *args], cwd=here,
                         env=dict(os.environ, PYTHONPATH=here), capture_output=True,
                         text=True, timeout=600)
    if out.returncode != 0:
        raise AssertionError(f"python -m rovr_torch {' '.join(args)}: rc "
                             f"{out.returncode}\n{out.stdout[-2000:]}\n{out.stderr[-4000:]}")
    return out.stdout, time.time() - t


def python_m_all(here, argvs, stdouts=None):
    """`python -m rovr_torch <argv>` for every argv at once, each in its own
    subprocess; raises unless each exits 0. Returns {name: seconds until that
    one exited}; fills `stdouts` {name: stdout} when given."""
    from concurrent.futures import ThreadPoolExecutor

    t0 = time.time()

    def one(item):
        name, args = item
        out = subprocess.run([sys.executable, "-m", "rovr_torch", *args], cwd=here,
                             env=dict(os.environ, PYTHONPATH=here), capture_output=True,
                             text=True, timeout=600)
        return name, out, time.time() - t0

    with ThreadPoolExecutor(len(argvs)) as pool:
        done = list(pool.map(one, argvs.items()))
    for name, out, _ in done:
        if out.returncode != 0:
            raise AssertionError(f"python -m rovr_torch {' '.join(argvs[name])}: rc "
                                 f"{out.returncode}\n{out.stdout[-2000:]}\n{out.stderr[-4000:]}")
        if stdouts is not None:
            stdouts[name] = out.stdout
    return {name: s for name, _, s in done}


def phase_cli(torch, conv, attention, cli, checkpoint, here, out_dir):
    """The command line: `rl` in this process at Config() widths, then
    `python -m rovr_torch rl` and `reconstruct --restore_from` as
    subprocesses."""
    run_root = os.path.join(out_dir, "smoke_cli")
    shutil.rmtree(run_root, ignore_errors=True)
    _zero_counts(conv, attention)   # counts from here are the CLI run's
    t0 = time.time()
    rc = cli.main(["rl", "--batch_size", "8", "--iterations", "2", "--run_dir", run_root])
    main_s = time.time() - t0
    counts = _counts(conv, attention)
    if rc != 0 or counts != {"K1": 3 * 20 * 2, "K2": 0, "K3": 0, "K4": 0}:
        raise AssertionError(f"cli rl: rc {rc}, launches {counts}, expected K1 60 x 2")
    recs, _ = _run_records(run_root, "rovr_rl")
    if checkpoint.latest_checkpoint_dir(run_root, "rovr_rl") is None:
        raise AssertionError("cli rl wrote no checkpoint")
    sub_root = os.path.join(run_root, "sub")
    _, rl_s = python_m(here, "rl", "--iterations", "1", "--run_dir", sub_root)
    ck = checkpoint.latest_checkpoint_dir(sub_root, "rovr_rl")
    frames = os.path.join(run_root, "frames")
    printed, rec_s = python_m(here, "reconstruct", "--restore_from", ck, "--out", frames)
    n_png = len(glob.glob(os.path.join(frames, "*", "*.png")))
    if "restored: True" not in printed or n_png == 0:
        raise AssertionError(f"reconstruct: {printed}")
    shutil.rmtree(frames)
    _drop_checkpoints(run_root)
    _drop_checkpoints(sub_root)
    res = dict(main_s=main_s, launches=counts, records=len(recs), subprocess_rl_s=rl_s,
               subprocess_reconstruct_s=rec_s, frames_written=n_png,
               reconstruct_stdout=printed)
    log(f"cli: rl in-process (Config(), batch 8, 2 iterations) {main_s:.2f} s, launches "
        f"{counts}; python -m rovr_torch rl {rl_s:.2f} s; reconstruct --restore_from "
        f"{rec_s:.2f} s, {n_png} frames, restored")
    return res


SOURCE_BATCHES = 3    # timed device-source batches per scheme
PRETRAIN_STEPS = 4    # pretrain_local.run steps at Config()
IMITATION_STEPS = 3   # imitation.run steps per configuration
JAX_PIPELINE_KEYS = {  # the record rovr_tpu/train/pipeline.run writes (stages 1-5, 3b)
    "config", "pretrain", "imitation", "rl", "rl_from_random", "eval_trained",
    "eval_warm_start_only", "eval_random_policy", "eval_ppo_from_random", "ppo_ablation",
    "eval_ci", "ablation_ci", "wall_seconds", "policy1", "policy1_summary",
    "policy1_control",
}
JAX_POLICY1_SUMMARY_KEYS = {  # its policy1_summary
    "coverage_first10", "coverage_last10", "return_first10", "return_last10",
    "coverage_random_expected", "coverage_random_measured", "separates_from_random",
    "verdict",
}


def _median(xs):
    return sorted(xs)[len(xs) // 2]


def phase_source(torch, Config, device_synthetic, corruption, synthetic):
    """The on-device synthetic source in both schemes at Config() size
    (batch 8 x 20 frames, 256^2, texture 1.0): its contract and its time per
    batch beside the host source's."""
    import dataclasses

    c = Config()
    h, w = c.data.frame_size
    b, s = 8, 20
    shape = (b, s, h, w, 3)
    res = {}
    for scheme in ("explicit", "raster"):
        cfg = c.replace(data=dataclasses.replace(c.data, synthetic_scheme=scheme))
        src = device_synthetic.make_source(cfg, b, 0, 1.0, 1.5, device="cuda")
        src.next(0)
        torch.cuda.synchronize()
        times = []
        for i in range(1, 1 + SOURCE_BATCHES):
            t0 = time.time()
            out = src.next(i)
            torch.cuda.synchronize()
            times.append(time.time() - t0)
        corrupted, original, masks, pos, neg = out
        for name, x in (("corrupted", corrupted), ("original", original), ("masks", masks)):
            if tuple(x.shape) != shape or x.dtype != torch.float32 or not x.is_cuda:
                raise AssertionError(f"{scheme} source {name}: {x.shape} {x.dtype} {x.device}")
            if not (x.min().item() >= 0.0 and x.max().item() <= 1.0):
                raise AssertionError(f"{scheme} source {name} outside [0, 1]")
        if not ((masks == 0) | (masks == 1)).all() or not (masks == 0).any():
            raise AssertionError(f"{scheme} source masks are not a 0/1 corruption")
        if not torch.equal(corrupted, original * masks) or corrupted[masks == 0].abs().max() != 0:
            raise AssertionError(f"{scheme} source: masked pixels are not zero")
        again = src.next(SOURCE_BATCHES)
        if not (torch.equal(again[0], corrupted) and torch.equal(again[1], original)):
            raise AssertionError(f"{scheme} source is not deterministic per (seed, i)")
        if scheme == "raster":
            want = corruption.raster_box_masks(2 * torch.arange(s, device="cuda"), h, w)
            if pos is not None or not torch.equal(masks, want[None].expand(shape)):
                raise AssertionError("raster source masks differ from raster_box_masks")
        elif pos.shape != (b, s, 16, 2) or neg.shape != (b, s, 3, 2):
            raise AssertionError(f"explicit source tables {pos.shape} {neg.shape}")
        dev_ms = profiled_ms(torch, lambda: src.next(0), None, iters=1)
        res[scheme] = dict(sec_per_batch=_median(times), sec_each=times, device_ms=dev_ms)
        log(f"device source {scheme} (batch {b} x {s} frames, {h}^2, texture 1.0): "
            f"{_median(times) * 1e3:.2f} ms per batch (host clock, median of {len(times)}), "
            f"{dev_ms:.2f} ms of device time; contract ok")
    t0 = time.time()
    synthetic.synthetic_clips(0, 0, b, s, h, w)
    res["host_sec_per_batch"] = time.time() - t0
    log(f"host synthetic source, the same batch size untextured: "
        f"{res['host_sec_per_batch']:.3f} s per batch")
    return res


def _profile_rows(torch, avgs):
    """Device rows of a trace's `key_averages()` by time, and their sum
    (the device's busy time). A record_function range also shows as a
    device row (its span on the device's timeline, `is_user_annotation`);
    those are left out, or the busy time would count their kernels twice.
    (Take `key_averages()` once per trace: each call walks every event.)"""
    rows = sorted((dict(kernel=e.key[:120], ms=e.self_device_time_total / 1e3, count=e.count)
                   for e in avgs
                   if e.device_type == torch.autograd.DeviceType.CUDA
                   and not getattr(e, "is_user_annotation", False)
                   and getattr(e, "self_device_time_total", 0) > 0), key=lambda r: -r["ms"])
    return rows, sum(r["ms"] for r in rows)


def _range_times(torch, avgs, names):
    """{name: {count, device_ms, span_ms, host_ms}} of record_function
    ranges: device_ms sums the device time of the kernels the range's ops
    launched from its own thread (a backward inside the range runs on
    autograd's device thread, so its kernels are not counted), span_ms is
    the range's extent on the device's timeline (its device-side
    annotation: every kernel in it, gaps included; None where the trace has
    none)."""
    out = {}
    for e in avgs:
        if e.key not in names:
            continue
        r = out.setdefault(e.key, dict(count=e.count, device_ms=None, span_ms=None,
                                       host_ms=None))
        if e.device_type == torch.autograd.DeviceType.CUDA:
            r["span_ms"] = e.self_device_time_total / 1e3
        else:
            r["device_ms"] = getattr(e, "device_time_total", 0) / 1e3
            r["host_ms"] = e.cpu_time_total / 1e3
    return out


def phase_pretrain(torch, conv, attention, Config, pretrain_local, checkpoint, out_dir):
    """`pretrain_local.run` at Config() (UNet 64-512, VGG16 LPIPS, batch 24,
    256^2, the host clips): exactly 3 K1 forward launches and 3 backward
    calls per step plus 3 forward launches for the step-0 strip, finite
    metrics, the UNet moved and LPIPS not, a checkpoint restored bit for
    bit; then timed steps, peak memory, and one step under torch.profiler."""
    import dataclasses
    from torch.profiler import ProfilerActivity, profile

    run_root = os.path.join(out_dir, "smoke_pretrain")
    shutil.rmtree(run_root, ignore_errors=True)
    c = Config()
    cfg = c.replace(run=dataclasses.replace(c.run, run_dir=run_root, log_every=1),
                    pretrain=dataclasses.replace(c.pretrain, checkpoint_every=1))
    b = cfg.pretrain.batch_size
    marks = []

    def log_cb(i, metrics):   # after step i, before its strip and checkpoint
        torch.cuda.synchronize()
        marks.append((time.time(), _counts(conv, attention), conv.fused_conv3x3.backward_calls,
                      _finite_metrics(metrics)))

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    _zero_counts(conv, attention)   # counts from here are pretrain_local.run's
    t0 = time.time()
    state = pretrain_local.run(cfg, steps=PRETRAIN_STEPS, log_cb=log_cb, device="cuda")
    torch.cuda.synchronize()
    total_s = time.time() - t0
    peak_run = torch.cuda.max_memory_allocated() / 1e9
    for i, (_, counts, bwd, _) in enumerate(marks):
        want = {"K1": 3 * (i + 1) + (3 if i else 0), "K2": 0, "K3": 0, "K4": 0}
        if counts != want or bwd != 3 * (i + 1):
            raise AssertionError(f"pretrain step {i}: launches {counts}, backward calls {bwd}; "
                                 f"expected {want} and {3 * (i + 1)}")
    if len(marks) != PRETRAIN_STEPS or state.step != PRETRAIN_STEPS:
        raise AssertionError(f"pretrain ran {len(marks)} logged steps, state.step {state.step}")
    iter_s = [marks[0][0] - t0] + [marks[i][0] - marks[i - 1][0] for i in range(1, len(marks))]
    ck = checkpoint.latest_checkpoint_dir(run_root, "local_net_pretrain")
    restored = checkpoint.CheckpointManager(ck).restore(template=state)
    if not _same_tree(restored, state):
        raise AssertionError(f"pretrain checkpoint {ck} does not restore the state")
    (path,) = glob.glob(os.path.join(run_root, "local_net_pretrain", "*"))
    if not (glob.glob(os.path.join(path, "images", "*.png"))
            or glob.glob(os.path.join(path, "events.out.tfevents*"))):
        raise AssertionError("pretrain wrote no image strip")
    _drop_checkpoints(run_root)

    mods = pretrain_local.make_modules(cfg, device="cuda")
    fresh = pretrain_local.init_state(cfg, mods, cfg.run.seed)
    moved = _moved(state.params, fresh.params)
    if not (moved > 0 and math.isfinite(moved)) or not all(
            torch.equal(state.lpips_params[k], v) for k, v in fresh.lpips_params.items()):
        raise AssertionError(f"pretrain: UNet moved {moved}; LPIPS must not move")

    data = tuple(torch.as_tensor(x).cuda() for x in pretrain_local.host_clips(cfg))
    gen = torch.Generator(device="cuda").manual_seed(1)
    st, times = fresh, []
    torch.cuda.reset_peak_memory_stats()
    for _ in range(1 + 3):
        torch.cuda.synchronize()
        t1 = time.time()
        st, _ = pretrain_local.train_step(st, gen, mods, data, b)
        torch.cuda.synchronize()
        times.append(time.time() - t1)
    peak = torch.cuda.max_memory_allocated() / 1e9
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t1 = time.time()
        pretrain_local.train_step(st, gen, mods, data, b)
        torch.cuda.synchronize()
        wall_ms = (time.time() - t1) * 1e3
    avgs = prof.key_averages()
    rows, busy_ms = _profile_rows(torch, avgs)
    names = {e.key for e in avgs}
    if "fused_conv3x3_plain" in names:
        raise AssertionError("the pretrain step reached fused_conv3x3_plain on the card")
    if "fused_conv3x3_backward" not in names:
        raise AssertionError("the profiler saw no fused_conv3x3_backward range")
    bwd_range = _range_times(torch, avgs, {"fused_conv3x3_backward"})["fused_conv3x3_backward"]
    bwd_dev_ms = bwd_range["device_ms"] or 0.0
    k1_ms = sum(r["ms"] for r in rows if "conv3x3_kernel" in r["kernel"])
    grad_convs = [r for r in rows if "dgrad" in r["kernel"] or "wgrad" in r["kernel"]]
    res = dict(batch=b, steps=PRETRAIN_STEPS, total_s=total_s, iter_s=iter_s,
               launches_per_step={"K1": 3, "K1_backward": 3}, strip_launches={"K1": 3},
               metrics=[m[3] for m in marks], peak_mem_gb_run=peak_run, param_moved=moved,
               sec_per_step_each=times[1:], sec_per_step=_median(times[1:]),
               warmup_s=times[0], peak_mem_gb=peak, wall_ms=wall_ms, device_ms=busy_ms,
               idle_share=(1 - busy_ms / wall_ms) if busy_ms else None, k1_ms=k1_ms,
               k1_share=(k1_ms / busy_ms) if busy_ms else None,
               k1_backward_range_device_ms=bwd_dev_ms, k1_backward_range_calls=bwd_range["count"],
               cudnn_grad_conv_ms=sum(r["ms"] for r in grad_convs),
               cudnn_grad_conv_launches=sum(r["count"] for r in grad_convs), top=rows[:25])
    log(f"pretrain at Config() (batch {b}): {PRETRAIN_STEPS} steps of pretrain_local.run in "
        f"{total_s:.2f} s (per step " + ", ".join(f"{x:.3f}" for x in iter_s)
        + f" s; the first includes set-up), K1 3 forward + 3 backward per step and 3 for the "
        f"strip, checkpoint restored bit for bit, LPIPS unchanged, peak {peak_run:.2f} GB; "
        f"train_step {res['sec_per_step']:.4f} s/step (median of 3), peak {peak:.2f} GB")
    log(f"profile of one pretrain step: wall {wall_ms:.1f} ms, device busy {busy_ms:.1f} ms "
        f"(idle share {res['idle_share'] or 0:.3f}); K1 forward {k1_ms:.2f} ms "
        f"({res['k1_share'] or 0:.3f}); K1 backward (cuDNN, {bwd_range['count']} calls) "
        f"{bwd_dev_ms:.2f} ms; every cuDNN dgrad/wgrad kernel {res['cudnn_grad_conv_ms']:.2f} "
        f"ms x{res['cudnn_grad_conv_launches']}; fused_conv3x3_plain never ran")
    for r in rows[:25]:
        log(f"  {r['ms']:9.3f} ms  x{r['count']:<6d} {r['kernel']}")
    return res


def phase_imitation(torch, conv, attention, Config, imitation, pipeline, out_dir):
    """`imitation.run` for IMITATION_STEPS steps at Config() (the canvas
    PolicyNet2, ResNet-50, the explicit device source) and at the
    pipeline's configuration (the attention policy, 160^2, the raster
    source, texture 1.0): launches per step (K2, K3 and K4 once per encoder
    block each with the attention policy, no port kernel with the canvas
    one), finite loss, top2_acc and exposure, π₂ and the heads moved and the
    backbone not; seconds per step."""
    import dataclasses

    res = {}
    for name, base, texture, vel in (("canvas", Config(), 0.0, 1.5),
                                     ("attention", pipeline.default_config(20, 4), 1.0, 0.0)):
        run_root = os.path.join(out_dir, f"smoke_imitation_{name}")
        shutil.rmtree(run_root, ignore_errors=True)
        cfg = base.replace(run=dataclasses.replace(base.run, run_dir=run_root, log_every=1))
        depth = cfg.model.attn_depth if name == "attention" else 0
        per_step = {"K1": 0, "K2": depth, "K3": depth, "K4": depth}
        marks = []

        def log_cb(i, metrics):
            torch.cuda.synchronize()
            marks.append((time.time(), _counts(conv, attention), _finite_metrics(metrics)))

        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        _zero_counts(conv, attention)   # counts from here are imitation.run's
        t0 = time.time()
        state = imitation.run(cfg, steps=IMITATION_STEPS, log_cb=log_cb, data_texture=texture,
                              data_texture_vel=vel, device="cuda")
        torch.cuda.synchronize()
        total_s = time.time() - t0
        prev = {k: 0 for k in per_step}
        for i, (_, counts, metrics) in enumerate(marks):
            d = {k: counts[k] - prev[k] for k in counts}
            if d != per_step:
                raise AssertionError(f"imitation ({name}) step {i} launched {d}, "
                                     f"expected {per_step}")
            if not {"Loss/expert_loss", "Imitation/top2_acc", "Imitation/exposure"} <= set(metrics):
                raise AssertionError(f"imitation ({name}) metrics {sorted(metrics)}")
            prev = counts
        if len(marks) != IMITATION_STEPS or state.step != IMITATION_STEPS:
            raise AssertionError(f"imitation ({name}): {len(marks)} steps, state.step {state.step}")
        mods = imitation.make_modules(cfg, device="cuda")
        fresh = imitation.init_state(cfg, mods, cfg.run.seed)
        heads = {k: v for k, v in fresh.vp_params.items() if not k.startswith("backbone.")}
        moved = {"pn2": _moved(state.pn2_params, fresh.pn2_params),
                 "heads": _moved(state.vp_params, heads)}
        backbone_same = all(torch.equal(state.vp_params[k], v) for k, v in fresh.vp_params.items()
                            if k.startswith("backbone."))
        if not (all(v > 0 and math.isfinite(v) for v in moved.values()) and backbone_same):
            raise AssertionError(f"imitation ({name}): moved {moved}, backbone unchanged "
                                 f"{backbone_same}")
        del mods
        _drop_checkpoints(run_root)
        iter_s = [marks[0][0] - t0] + [marks[i][0] - marks[i - 1][0]
                                       for i in range(1, len(marks))]
        res[name] = dict(steps=IMITATION_STEPS, total_s=total_s, iter_s=iter_s,
                         sec_per_step=_median(iter_s[1:]), launches_per_step=per_step,
                         metrics=[m[2] for m in marks], moved=moved,
                         peak_mem_gb=torch.cuda.max_memory_allocated() / 1e9)
        log(f"imitation ({name}, {cfg.data.frame_size[0]}^2, {cfg.data.synthetic_scheme} "
            f"source): {IMITATION_STEPS} steps in {total_s:.2f} s (per step "
            + ", ".join(f"{x:.3f}" for x in iter_s) + f" s; the first includes set-up), "
            f"launches {per_step} per step, last metrics {marks[-1][2]}, moved {moved}, "
            f"backbone unchanged, peak {res[name]['peak_mem_gb']:.2f} GB")
        torch.cuda.empty_cache()
    return res


def phase_pipeline(torch, conv, attention, pipeline, pretrain_local, imitation, rl, evaluate,
                   here, out_dir):
    """`pipeline.run(default_config(20, 4), ...)` with a few steps per stage:
    each stage's launch counts (the stage functions wrapped for this run
    only), the record's keys as the JAX `run` writes them; then
    `python -m rovr_torch pretrain`, `imitate` and `pipeline` as three
    subprocesses at once."""
    run_root = os.path.join(out_dir, "smoke_pipeline")
    shutil.rmtree(run_root, ignore_errors=True)
    import dataclasses

    cfg = pipeline.default_config(20, 4)
    cfg = cfg.replace(run=dataclasses.replace(cfg.run, run_dir=run_root))
    t_steps, depth, n_upd = cfg.rl.time_steps, cfg.model.attn_depth, cfg.rl.n_updates_per_ppo
    stages, originals = [], {}

    def counted(mod, fn_name):
        real = getattr(mod, fn_name)
        originals[(mod, fn_name)] = real

        def wrapped(*a, **kw):
            torch.cuda.synchronize()
            _zero_counts(conv, attention)   # counts from here are this stage's
            t = time.time()
            out = real(*a, **kw)
            torch.cuda.synchronize()
            stages.append((f"{mod.__name__.rsplit('.', 1)[-1]}.{fn_name}",
                           dict(_counts(conv, attention),
                                K1_backward=conv.fused_conv3x3.backward_calls),
                           time.time() - t, kw))
            return out
        setattr(mod, fn_name, wrapped)

    for mod, fn_name in ((pretrain_local, "run"), (imitation, "run"), (rl, "run"),
                         (evaluate, "run"), (evaluate, "run_ci")):
        counted(mod, fn_name)
    out_path = os.path.join(run_root, "record.json")
    t0 = time.time()
    try:
        rec = pipeline.run(cfg, pretrain_steps=4, imitation_steps=4, rl_iterations=2,
                           ppo_from_random_iterations=1, eval_videos=4, eval_ci_clips=4,
                           eval_ci_draws=2, out_path=out_path, device="cuda",
                           policy1_iterations=2)
    finally:
        for (mod, fn_name), real in originals.items():
            setattr(mod, fn_name, real)
    total_s = time.time() - t0

    def rl_counts(iters):
        return {"K1": 3 * t_steps * iters, "K2": depth * (t_steps + 2 * n_upd + 1) * iters,
                "K3": 2 * depth * n_upd * iters, "K4": 2 * depth * n_upd * iters,
                "K1_backward": 0}

    zero = {"K1": 0, "K2": 0, "K3": 0, "K4": 0, "K1_backward": 0}
    want = [("pretrain_local.run", dict(zero, K1=3 * 4 + 3, K1_backward=3 * 4)),
            ("imitation.run", dict(zero, K2=depth * 4, K3=depth * 4, K4=depth * 4)),
            ("rl.run", rl_counts(2)), ("rl.run", rl_counts(1))]
    want += [("evaluate.run", dict(zero, K1=3 * 2 * t_steps, K2=depth * t_steps))] * 4
    want += [("evaluate.run_ci", dict(zero, K1=3 * 3 * t_steps, K2=depth * 2 * t_steps))] * 4
    want += [("rl.run", rl_counts(2))]   # stage 5: PPO on π₁ adds no port kernel
    got = [(name, counts) for name, counts, _, _ in stages]
    if got != want:
        raise AssertionError(f"pipeline stage launches {got}, expected {want}")
    with open(out_path) as f:
        written = json.load(f)
    if set(rec) != JAX_PIPELINE_KEYS or set(written) != JAX_PIPELINE_KEYS:
        raise AssertionError(f"pipeline record keys {sorted(rec)}")
    ctl = rec["policy1_control"]
    logged = len(range(0, 2, cfg.run.log_every))   # rows of stage 5's 2 iterations
    if (set(rec["policy1_summary"]) != JAX_POLICY1_SUMMARY_KEYS
            or len(rec["policy1"]) != logged
            or any(set(ctl[k]) != {"trained", "random_policy1", "delta"}
                   for k in ("coverage", "return"))
            or not all("PPO/actor1_loss" in r for r in rec["policy1"])):
        raise AssertionError(f"pipeline stage 5 record: {rec['policy1_summary']}, "
                             f"{sorted(ctl)}")
    flat = [v for k in ("eval_trained", "eval_random_policy") for v in rec[k].values()]
    if not all(math.isfinite(v) for v in flat) or not rec["pretrain"] or not rec["rl"]:
        raise AssertionError("pipeline record: empty curves or non-finite eval metrics")
    _drop_checkpoints(run_root)
    res = dict(total_s=total_s, stages=[dict(stage=n, launches=c, seconds=t)
                                        for n, c, t, _ in stages],
               eval_trained=rec["eval_trained"], ppo_ablation=rec["ppo_ablation"],
               ci_masked_psnr=rec["ablation_ci"]["greedy"]["masked_psnr_agentic"],
               policy1_summary=rec["policy1_summary"],
               policy1_control_n=rec["policy1_control"]["n_clips"])
    log(f"pipeline (default_config(20, 4), 4 + 4 steps, 2 + 1 RL iterations, 4 eval arms, "
        f"2 π₁ iterations and the random-π₁ control): "
        f"{total_s:.1f} s; stages " + "; ".join(
            f"{n} {t:.1f} s {c}" for n, c, t, _ in stages))

    # the three at once, each in a run directory of its own
    sub_root = os.path.join(run_root, "cli")
    argvs = {"pretrain": ["pretrain", "--steps", "2"],
             "imitate": ["imitate", "--steps", "2"],
             "pipeline": ["pipeline", "--pretrain_steps", "2", "--imitation_steps", "2",
                          "--rl_iterations", "1", "--eval_videos", "4", "--eval_ci_clips", "4",
                          "--eval_ci_draws", "2", "--out",
                          os.path.join(sub_root, "record.json")]}
    want_out = {"pretrain": "[pretrain 1]", "imitate": "[imitate 1]",
                "pipeline": "record written"}
    printed = {}
    cli_s = python_m_all(here, {k: a + ["--run_dir", os.path.join(sub_root, k)]
                                for k, a in argvs.items()}, printed)
    for k, want in want_out.items():
        if want not in printed[k]:
            raise AssertionError(f"python -m rovr_torch {k}: {printed[k][-2000:]}")
        _drop_checkpoints(os.path.join(sub_root, k))
    res["cli_s"] = cli_s
    log("python -m rovr_torch " + ", ".join(f"{k} {v:.2f} s" for k, v in cli_s.items())
        + " as subprocesses run at once: exit 0")
    return res


TREE_CLIPS = 8          # RealVSR-shaped clip folders: 50 frames of 1024x512 each
TREE_FRAMES = 50
TREE720_CLIPS = 2       # two more at 1280x720, for the decoder's general resize
FOLDER_ITERS = 6        # rl.run iterations from the tree, and from the device source
UINT8_ITERS = 3         # rl.run iterations from the tree with stage_uint8
STAGE_BATCHES = 12      # prefetched batches held bit for bit against their host items
STAGE_DEPTH = 4


def png_filtered(img, filters):
    """RGB uint8 (H, W, 3) -> PNG bytes, row y filtered with filters[y %
    len(filters)] (0 None, 1 Sub, 2 Up, 3 Average, 4 Paeth). The port writes
    filter 0 only (utils/png.py); this encoder gives the decoder every type."""
    import struct
    import zlib

    import numpy as np

    h, w, _ = img.shape
    x = img.reshape(h, w * 3).astype(np.int16)
    up = np.vstack([np.zeros((1, w * 3), np.int16), x[:-1]])
    left = np.hstack([np.zeros((h, 3), np.int16), x[:, :-3]])
    ul = np.hstack([np.zeros((h, 3), np.int16), up[:, :-3]])
    p = left + up - ul
    pa, pb, pc = np.abs(p - left), np.abs(p - up), np.abs(p - ul)
    paeth = np.where((pa <= pb) & (pa <= pc), left, np.where(pb <= pc, up, ul))
    pred = np.stack([np.zeros_like(x), left, up, (left + up) // 2, paeth])
    f = np.asarray([filters[y % len(filters)] for y in range(h)])
    rows = ((x - pred[f, np.arange(h)]) % 256).astype(np.uint8)
    raw = np.hstack([f[:, None].astype(np.uint8), rows]).tobytes()

    def chunk(tag, body):
        return (struct.pack(">I", len(body)) + tag + body
                + struct.pack(">I", zlib.crc32(tag + body) & 0xFFFFFFFF))

    return (b"\x89PNG\r\n\x1a\n" + chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, 8, 2, 0, 0, 0))
            + chunk(b"IDAT", zlib.compress(raw)) + chunk(b"IEND", b""))


def _clip_source(seed, h, w):
    """A clip's moving content: a frame t is a window of one textured field
    panned by (2t, 3t) pixels."""
    import numpy as np

    rng = np.random.default_rng(seed)
    H, W = h + 2 * TREE_FRAMES, w + 3 * TREE_FRAMES
    yy, xx = np.mgrid[0:H, 0:W].astype(np.float32)
    field = np.zeros((H, W, 3), np.float32)
    for _ in range(3):
        fy, fx = rng.uniform(0.005, 0.06, 2)
        field += rng.uniform(20, 45, 3) * np.sin(fy * yy + fx * xx + rng.uniform(0, 6.3))[..., None]
    field += 128 + rng.normal(0, 12, field.shape)
    field = np.clip(field, 0, 255).astype(np.uint8)
    return lambda t: field[2 * t:2 * t + h, 3 * t:3 * t + w]


def write_frame_tree(root, clips, h, w, seed):
    """`clips` folders of TREE_FRAMES PNGs at h x w under root, every
    filter type on each frame's rows, encoded on 8 threads (zlib releases
    the GIL). Returns {clip: frame source}."""
    from concurrent.futures import ThreadPoolExecutor

    sources = {}
    jobs = []
    for c in range(clips):
        d = os.path.join(root, f"{c:03d}")
        os.makedirs(d, exist_ok=True)
        sources[d] = _clip_source(seed + c, h, w)
        for t in range(TREE_FRAMES):
            jobs.append((os.path.join(d, f"{t:08d}.png"), sources[d], t))

    def one(job):
        path, src, t = job
        with open(path, "wb") as f:
            f.write(png_filtered(src(t), [(t + k) % 5 for k in range(5)]))

    with ThreadPoolExecutor(8) as pool:
        list(pool.map(one, jobs))
    return sources


def _box2(img):
    """The exact 2x downscale (OpenCV's INTER_AREA fast path): (a+b+c+d+2)>>2."""
    x = img.astype(int)
    return ((x[0::2, 0::2] + x[0::2, 1::2] + x[1::2, 0::2] + x[1::2, 1::2] + 2) >> 2
            ).astype("uint8")


def _bilinear(img, oh, ow):
    """Float bilinear resize with half-pixel centres, taps clamped to the
    edge, rounded: a numpy reference for the decoder's fixed-point path."""
    import numpy as np

    def taps(n_in, n_out):
        f = (np.arange(n_out) + 0.5) * (n_in / n_out) - 0.5
        i0 = np.floor(f).astype(int)
        a = (f - i0)[:, None]
        return np.clip(i0, 0, n_in - 1), np.clip(i0 + 1, 0, n_in - 1), a

    y0, y1, ay = taps(img.shape[0], oh)
    x0, x1, ax = taps(img.shape[1], ow)
    x = img.astype(np.float64)
    rows = x[y0] * (1 - ay[..., None]) + x[y1] * ay[..., None]
    out = rows[:, x0] * (1 - ax) + rows[:, x1] * ax
    return np.clip(np.rint(out), 0, 255).astype(np.uint8)


def phase_frame_tree(torch, native_loader, dataset, Config, out_dir):
    """Phase 22: a RealVSR-shaped frame tree (8 clips x 50 PNGs at
    1024x512, 16 videos, every PNG filter type) and two clips at 1280x720;
    the port's decoder held against numpy references of the same frames,
    its time per frame on one thread and across decode_clip's threads, and
    the readers' seconds per item."""
    import dataclasses

    import numpy as np

    root = os.path.join(out_dir, "smoke_tree")
    shutil.rmtree(root, ignore_errors=True)
    atexit.register(shutil.rmtree, root, True)
    tree, tree720 = os.path.join(root, "LQ"), os.path.join(root, "LQ720")
    t0 = time.time()
    src = write_frame_tree(tree, TREE_CLIPS, 512, 1024, seed=100)
    src720 = write_frame_tree(tree720, TREE720_CLIPS, 720, 1280, seed=200)
    write_s = time.time() - t0
    nbytes = {name: sum(os.path.getsize(p) for p in glob.glob(os.path.join(r, "*", "*.png")))
              for name, r in (("1024x512", tree), ("1280x720", tree720))}

    # exact at 1024x512: the PNG decode is lossless and 512 -> 256 is the 2x box mean
    checked = 0
    for d, s in src.items():
        for t in (range(TREE_FRAMES) if d.endswith("000") else (0, 17, 49)):
            path = os.path.join(d, f"{t:08d}.png")
            frame = s(t)
            if not np.array_equal(native_loader.decode_png(path), frame):
                raise AssertionError(f"decode_png({path}) differs from the encoded frame")
            for half in (0, 1):
                got = native_loader.decode_half(path, (256, 256), half)
                if not np.array_equal(got, _box2(frame[:, 512 * half:512 * (half + 1)])):
                    raise AssertionError(f"decode_half({path}, half {half}) is not exact")
                checked += 1
    exact = total = 0
    gap = 0
    for d, s in src720.items():
        for t in (0, 25, 49):
            path = os.path.join(d, f"{t:08d}.png")
            full = _bilinear(s(t), 512, 1024)
            for half in (0, 1):
                got = native_loader.decode_half(path, (256, 256), half).astype(int)
                want = _box2(full[:, 512 * half:512 * (half + 1)]).astype(int)
                diff = np.abs(got - want)
                exact, total, gap = exact + int((diff == 0).sum()), total + diff.size, max(
                    gap, int(diff.max()))
    if gap > 1:
        raise AssertionError(f"decode_half at 1280x720 is {gap} LSB from the float reference")

    def per_frame(paths, fn):
        t = time.time()
        fn(paths)
        return (time.time() - t) / len(paths) * 1e3

    res = dict(write_s=write_s, tree_bytes=nbytes,
               exact_1024x512_halves=checked,
               share_exact_1280x720=exact / total, max_gap_1280x720=gap)
    for name, r in (("1024x512", tree), ("1280x720", tree720)):
        paths = sorted(glob.glob(os.path.join(r, "001", "*.png")))
        res[f"ms_per_frame_1thread_{name}"] = per_frame(
            paths, lambda ps: [native_loader.decode_half(p, (256, 256), 0) for p in ps])
        res[f"ms_per_frame_8threads_{name}"] = per_frame(
            paths, lambda ps: native_loader.decode_clip(ps, (256, 256), 0, threads=8))
    c = Config()
    data = dataclasses.replace(c.data, root_folder=tree)
    for name, cls in (("video_folder", dataset.VideoFolderDataset),
                      ("explicit", dataset.ExplicitVideoDataset)):
        ds = cls(data, seed=0)
        t = time.time()
        items = [ds[i] for i in range(4)]
        res[f"sec_per_{name}_item"] = (time.time() - t) / 4
        if len(ds) != 2 * TREE_CLIPS or items[0][0].shape[1:] != (256, 256, 3):
            raise AssertionError(f"{name}: {len(ds)} items of {items[0][0].shape}")
    log(f"frame tree: {TREE_CLIPS} clips x {TREE_FRAMES} PNGs at 1024x512 "
        f"({nbytes['1024x512'] / 1e6:.1f} MB) + {TREE720_CLIPS} at 1280x720 "
        f"({nbytes['1280x720'] / 1e6:.1f} MB), written in {write_s:.1f} s; {checked} "
        f"halves at 1024x512 exact against numpy; "
        f"1280x720: share exact {exact / total:.6f}, largest gap {gap} LSB against float "
        f"bilinear; decode_half ms per frame: "
        + ", ".join(f"{k[14:]} {v:.2f}" for k, v in res.items() if k.startswith("ms_per"))
        + f"; sec per item: VideoFolderDataset {res['sec_per_video_folder_item']:.3f}, "
        f"ExplicitVideoDataset {res['sec_per_explicit_item']:.3f}")
    return res, tree


class KeepItems:
    """A dataset that keeps a copy of each item it hands out, to hold the
    prefetcher's staged tensors against; a repeated index must give the
    same item again."""

    def __init__(self, ds):
        self.ds, self.kept = ds, {}

    def __len__(self):
        return len(self.ds)

    def __getitem__(self, i):
        import numpy as np

        item = tuple(np.array(x, copy=True) for x in self.ds[i])
        old = self.kept.setdefault(i, item)
        if not all(np.array_equal(a, b) for a, b in zip(old, item)):
            raise AssertionError(f"dataset item {i} is not deterministic")
        return item


def phase_folder_rl(torch, conv, attention, Config, rl, dataset, profiling, tree, here,
                    out_dir):
    """Phase 23: `rl.run` at Config() (canvas policy, S = T = 20, 256^2,
    batch 8) from the frame tree through the DevicePrefetcher (8 workers)
    against `rl.run` on the device source in the same run; one train step
    under utils.profiling.trace fed by the prefetcher while its workers
    decode, against the same step on a device-source batch; the staged
    batches held bit for bit against their host items; stage_uint8; and
    `python -m rovr_torch {rl,imitate,eval,reconstruct} --root_folder`."""
    import dataclasses

    c = Config()
    run_root = os.path.join(out_dir, "smoke_folder")
    shutil.rmtree(run_root, ignore_errors=True)
    cfg = c.replace(data=dataclasses.replace(c.data, root_folder=tree),
                    rl=dataclasses.replace(c.rl, batch_size=8),
                    run=dataclasses.replace(c.run, run_dir=run_root, log_every=1,
                                            checkpoint_every=1000))
    b, s = 8, cfg.rl.vid_length

    def drive(name, cfg_, iters, **kw):
        marks = []

        def log_cb(i, metrics):
            torch.cuda.synchronize()
            marks.append((time.time(), _counts(conv, attention), _finite_metrics(metrics)))

        torch.cuda.synchronize()
        _zero_counts(conv, attention)
        t0 = time.time()
        state = rl.run(cfg_, iterations=iters, log_cb=log_cb, device="cuda", **kw)
        torch.cuda.synchronize()
        if state.step != iters or len(marks) != iters:
            raise AssertionError(f"rl.run ({name}): state.step {state.step}, {len(marks)} logs")
        prev = {"K1": 0, "K2": 0, "K3": 0, "K4": 0}
        for i, (_, counts, _) in enumerate(marks):
            d = {k: counts[k] - prev[k] for k in counts}
            if d != {"K1": 3 * cfg_.rl.time_steps, "K2": 0, "K3": 0, "K4": 0}:
                raise AssertionError(f"rl.run ({name}) iteration {i} launched {d}")
            prev = counts
        iter_s = [marks[0][0] - t0] + [marks[i][0] - marks[i - 1][0] for i in range(1, iters)]
        out = dict(iter_s=iter_s, sec_per_iteration=_median(iter_s[1:]),
                   k1_per_step=3 * cfg_.rl.time_steps, total_s=time.time() - t0)
        if "dataset" in kw:
            out["prefetch_wait_s"] = [m[2]["Data/prefetch_wait_s"] for m in marks]
        return out

    res = {}
    res["folder"] = drive("folder", cfg, FOLDER_ITERS,
                          dataset=dataset.VideoFolderDataset(cfg.data, seed=0))
    res["device_source"] = drive("device source", cfg, FOLDER_ITERS)
    cfg8 = cfg.replace(data=dataclasses.replace(cfg.data, stage_uint8=True))
    res["stage_uint8"] = drive("stage_uint8", cfg8, UINT8_ITERS,
                               dataset=dataset.VideoFolderDataset(cfg8.data, seed=0))
    clip = b * 2 * s * 256 * 256 * 3    # elements staged per batch: two clips an item
    res["h2d_bytes_per_batch"] = {"float32": 4 * clip, "uint8": clip}
    _drop_checkpoints(run_root)

    # one step under the profiler, the prefetcher's workers decoding meanwhile
    mods = rl.make_modules(cfg, device="cuda")
    state = rl.init_state(cfg, mods, 0)
    gen = torch.Generator(device="cuda").manual_seed(0)
    ds = rl.ClipPairs(dataset.VideoFolderDataset(cfg.data, seed=0), s)
    n_items = 8 * b
    p = dataset.DevicePrefetcher(ds, indices=[i % len(ds) for i in range(n_items)],
                                 num_workers=cfg.data.num_workers, depth=n_items, device="cuda")
    profiles = {}
    try:
        items = iter(p)

        def folder_batch():
            got = [next(items) for _ in range(b)]
            return tuple(torch.stack([x[f] for x in got]) for f in (0, 1))

        rl.train_step(state, mods, cfg, *folder_batch(), generator=gen)   # warm-up
        video, org = folder_batch()
        trace_dir = os.path.join(run_root, "trace_folder")
        workers_alive = [sum(t.is_alive() for t in p._workers)]
        with profiling.trace(trace_dir):
            rl.train_step(state, mods, cfg, video, org, generator=gen)
        workers_alive.append(sum(t.is_alive() for t in p._workers))
        profiles["folder"] = profiling.analyze_trace(trace_dir)
    finally:
        p.close()
    src = rl.DeviceSyntheticSource(cfg, b, device="cuda")
    v, o, _ = src.next(0)
    rl.train_step(state, mods, cfg, v, o, generator=gen)
    trace_dir = os.path.join(run_root, "trace_device")
    with profiling.trace(trace_dir):
        rl.train_step(state, mods, cfg, v, o, generator=gen)
    profiles["device_source"] = profiling.analyze_trace(trace_dir)
    for name, r in profiles.items():
        os.remove(r["trace"])
        r["top_device"], r["top_host"] = r["top_device"][:10], r["top_host"][:10]
    res["profile"] = profiles
    res["workers_alive_before_after_profiled_step"] = workers_alive
    del mods, state
    torch.cuda.empty_cache()

    # the staged batches, bit for bit, the consumer's stream kept busy
    keep = KeepItems(ds)
    order = [i % len(ds) for i in range(STAGE_BATCHES * b)]
    p = dataset.DevicePrefetcher(keep, indices=order, num_workers=cfg.data.num_workers,
                                 depth=STAGE_DEPTH, device="cuda")
    busy = torch.randn(4096, 4096, device="cuda", dtype=torch.bfloat16)
    bad = n_seen = 0
    t0 = time.time()
    try:
        for k, item in enumerate(p):
            for _ in range(8):
                busy = torch.tanh(busy @ busy)
            want = keep.kept[order[k]]
            bad += sum(not torch.equal(x.cpu(), torch.from_numpy(w)) for x, w in zip(item, want))
            n_seen += 1
            del item
    finally:
        p.close()
    if bad or n_seen != len(order):
        raise AssertionError(f"prefetcher staging: {bad} tensors differ from their host "
                             f"items, {n_seen} of {len(order)} items seen")
    res["staged_items_bitwise_equal"] = n_seen
    res["staging_check_s"] = time.time() - t0

    # the command line over the tree, the four subprocesses at once
    cli_root = os.path.join(run_root, "cli")
    frames = os.path.join(cli_root, "frames")
    argvs = {
        "rl": ["rl", "--root_folder", tree, "--iterations", "2", "--run_dir", cli_root],
        "imitate": ["imitate", "--root_folder", tree, "--steps", "2", "--run_dir", cli_root],
        "eval": ["eval", "--root_folder", tree, "--num_videos", "2", "--run_dir", cli_root],
        "reconstruct": ["reconstruct", "--root_folder", tree, "--num_clips", "2", "--out",
                        frames, "--run_dir", cli_root],
    }
    res["cli_s"] = python_m_all(here, argvs)
    for experiment in ("rovr_rl", "warm_start_pn2", "eval"):
        _run_records(cli_root, experiment)
    n_png = len(glob.glob(os.path.join(frames, "*", "*.png")))
    if n_png != 2 * cfg.rl.vid_length:
        raise AssertionError(f"reconstruct --root_folder wrote {n_png} frames")
    shutil.rmtree(frames)
    _drop_checkpoints(cli_root)
    f, d = res["folder"], res["device_source"]
    pf, pd = profiles["folder"], profiles["device_source"]
    log(f"rl.run from the tree (Config(), batch 8, {FOLDER_ITERS} iterations, 8 workers): "
        f"{f['sec_per_iteration']:.3f} s per iteration (each "
        + ", ".join(f"{x:.3f}" for x in f["iter_s"]) + "), prefetcher wait per batch "
        + ", ".join(f"{x:.4f}" for x in f["prefetch_wait_s"])
        + f" s; the device source {d['sec_per_iteration']:.3f} s per iteration (each "
        + ", ".join(f"{x:.3f}" for x in d["iter_s"]) + f"); K1 {f['k1_per_step']} per step in "
        f"both; stage_uint8 {res['stage_uint8']['sec_per_iteration']:.3f} s per iteration, "
        f"wait " + ", ".join(f"{x:.4f}" for x in res["stage_uint8"]["prefetch_wait_s"])
        + f" s, H2D {res['h2d_bytes_per_batch']['uint8'] / 1e6:.1f} MB per batch "
        f"(float32 {res['h2d_bytes_per_batch']['float32'] / 1e6:.1f} MB)")
    log(f"profiled step fed by the prefetcher ({workers_alive[0]} of 8 workers decoding at its "
        f"start, {workers_alive[1]} at its end): wall "
        f"{pf['wall_ms']:.1f} ms, device busy {pf['busy_ms']:.1f} ms, idle share "
        f"{pf['idle_share']:.3f}; fed by the device source: wall {pd['wall_ms']:.1f} ms, busy "
        f"{pd['busy_ms']:.1f} ms, idle share {pd['idle_share']:.3f}; {n_seen} staged items "
        f"bitwise equal to their host items ({STAGE_BATCHES} batches, depth {STAGE_DEPTH}); "
        "cli --root_folder (4 at once): "
        + ", ".join(f"{k} {v:.1f} s" for k, v in res["cli_s"].items()))
    return res


def _meta_shapes(torch, make):
    """{name: shape} of a module's state dict, built on the meta device."""
    with torch.device("meta"):
        return {k: tuple(v.shape) for k, v in make().state_dict().items()}


def _reference_name(kind, name):
    """The reference's key (torchvision, lpips, the reference UNet and
    PolicyNetwork2) of the port's state-dict entry `name`."""
    import re

    if kind == "resnet50":
        name = re.sub(r"layer(\d)_(\d+)", r"layer\1.\2", name)
        return name.replace("conv_down", "downsample.0").replace("bn_down", "downsample.1")
    if kind == "policy2":
        m = re.fullmatch(r"(convs|norms)\.(\d)\.(\w+)", name)
        return (f"video_conv.{4 * int(m.group(2)) + (m.group(1) == 'norms')}.{m.group(3)}"
                if m else name)
    if kind == "vgg_lpips":
        from rovr_torch.models.vgg_lpips import _VGG16_CONVS

        m = re.fullmatch(r"vgg\.conv(\d)_(\d)\.(\w+)", name)
        if m:
            s, c = int(m.group(1)), int(m.group(2))
            return f"net.slice{s}.{_VGG16_CONVS[s - 1][c - 1]}.{m.group(3)}"
        return f"{name}.model.1.weight"
    if kind == "raft":
        name = name.replace("fnet.", "feature_encoder.").replace("cnet.", "context_encoder.")
        for pat, rep in ((r"layer(\d)_(\d)\.conv(\d)", r"layer\1.\2.convnormrelu\3.0"),
                         (r"layer(\d)_(\d)\.norm(\d)", r"layer\1.\2.convnormrelu\3.1"),
                         (r"layer(\d)_(\d)\.conv_down", r"layer\1.\2.downsample.0"),
                         (r"layer(\d)_(\d)\.norm_down", r"layer\1.\2.downsample.1"),
                         (r"encoder\.conv1\.", "encoder.convnormrelu.0."),
                         (r"encoder\.norm1\.", "encoder.convnormrelu.1."),
                         (r"encoder\.conv2\.", "encoder.conv.")):
            name = re.sub(pat, rep, name)
        for port, ref in (("motion.convc1", "motion_encoder.convcorr1.0"),
                          ("motion.convf1", "motion_encoder.convflow1.0"),
                          ("motion.convf2", "motion_encoder.convflow2.0"),
                          ("motion.conv.", "motion_encoder.conv.0."),
                          ("gru.", "recurrent_block.convgru."), ("update.", "update_block.")):
            name = name.replace(port, ref)
    return name


def reference_state_dicts(torch, seed):
    """Reference-layout state dicts at full width, made from `seed`: kind ->
    {reference key: tensor}, with lecun-scaled kernels, positive variances
    and norm scales near 1, and LPIPS' non-negative heads."""
    from rovr_torch.models import local_net, policy_net_2, raft, resnet, vgg_lpips

    f32 = torch.float32
    makers = {
        "local_net": lambda: local_net.LocalNetUNet(dtype=f32),
        "policy2": lambda: policy_net_2.PolicyNet2(dtype=f32),
        "critic2": lambda: policy_net_2.PolicyNet2(dtype=f32, is_critic=True),
        "resnet50": lambda: resnet.ResNet50(dtype=f32),
        "vgg_lpips": lambda: vgg_lpips.LPIPS(dtype=f32),
        "raft": lambda: raft.RAFTSmall(dtype=f32),
    }
    g = torch.Generator().manual_seed(seed)
    out = {}
    for kind, make in makers.items():
        sd = {}
        for name, shape in _meta_shapes(torch, make).items():
            leaf = name.rsplit(".", 1)[-1]
            if name.startswith("lin"):
                v = (0.1 * torch.rand(shape, generator=g)).reshape((1,) + shape + (1, 1))
            elif leaf == "running_var" or (len(shape) == 1 and leaf == "weight"
                                           and ("bn" in name or "norm" in name)):
                v = 0.5 + 1.5 * torch.rand(shape, generator=g)
            elif len(shape) == 1:
                v = 0.2 * torch.rand(shape, generator=g) - 0.1
            else:
                v = torch.randn(shape, generator=g) / math.sqrt(math.prod(shape[1:]))
            sd[_reference_name("policy2" if kind == "critic2" else kind, name)] = v
        out[kind] = sd
    return out


def phase_convert(torch, cli, convert, rl, evaluate, here, out_dir):
    """Phase 24: reference checkpoints made from a seed at full width (the
    torchvision ResNet-50, lpips' VGG16 + lins, RAFT-small, the reference
    UNet, PolicyNetwork2, and a full `rovr` state with its prefixes in the
    model_state_dict envelope), `python -m rovr_torch convert --kind <k>` of
    each, then `rl --warm_start` (the state's tensors equal the converted
    ones bit for bit on the card before the first step) and `eval
    --warm_start` with lpips and raft (Eval/metric_weights_random 0)."""
    root = os.path.join(out_dir, "smoke_convert")
    shutil.rmtree(root, ignore_errors=True)
    os.makedirs(root)
    atexit.register(shutil.rmtree, root, True)
    t0 = time.time()
    refs = reference_state_dicts(torch, seed=24)
    full = {f"local_net.{k}": v for k, v in refs["local_net"].items()}
    full.update({f"actor2.{k}": v for k, v in refs["policy2"].items()})
    full.update({f"critic2.{k}": v for k, v in refs["critic2"].items()})
    full.update({f"video_encoder.resnet.{k}": v for k, v in refs["resnet50"].items()})
    full.update({f"lpips.{k}": v for k, v in refs["vgg_lpips"].items()})
    files = {"rovr": {"epoch": 3, "model_state_dict": full},
             "local_net": {"epoch": 2000, "model_state_dict": refs["local_net"]},
             "policy2": refs["policy2"], "resnet50": refs["resnet50"],
             "vgg_lpips": refs["vgg_lpips"], "raft": refs["raft"]}
    paths = {}
    for kind, obj in files.items():
        paths[kind] = os.path.join(root, f"{kind}.pt")
        torch.save(obj, paths[kind])
    make_s = time.time() - t0
    res = dict(make_and_save_s=make_s, kinds={})
    # in process: each kind's conversion and save, timed
    for kind, path in paths.items():
        t = time.time()
        init_params, report = convert.convert_reference_checkpoint(kind, path)
        conv_s = time.time() - t
        if report["skipped"] or not init_params:
            raise AssertionError(f"convert {kind}: {report}")
        t = time.time()
        d = convert.save_converted(os.path.join(root, f"inproc_{kind}"), init_params)
        res["kinds"][kind] = dict(
            convert_s=conv_s, save_s=time.time() - t, converted=report["converted"],
            ckpt_bytes=os.path.getsize(path),
            converted_bytes=os.path.getsize(os.path.join(d, "0", "state.pt")))
        shutil.rmtree(d)
    # the command line, every kind at once
    outs = {}
    cli_s = python_m_all(here, {kind: ["convert", "--kind", kind, "--ckpt", path, "--out",
                                       os.path.join(root, f"out_{kind}")]
                                for kind, path in paths.items()}, outs)
    for kind, stdout in outs.items():
        if "skipped" in stdout:
            raise AssertionError(f"python -m rovr_torch convert --kind {kind}: {stdout[-2000:]}")
        res["kinds"][kind]["cli_s"] = cli_s[kind]
    loaded = convert.load_converted(os.path.join(root, "out_rovr"))

    # rl --warm_start: the first state holds the converted tensors, bit for bit
    checked = {}
    real_init = rl.init_state

    def init_and_check(*a, **kw):
        state = real_init(*a, **kw)
        for field in ("local_net_params", "actor2_params", "critic2_params", "lpips_params"):
            got = getattr(state, field)
            if set(got) != set(loaded[field]) or not all(
                    got[k].is_cuda and torch.equal(got[k].cpu(), v)
                    for k, v in loaded[field].items()):
                raise AssertionError(f"rl --warm_start: {field} differs from the converted one")
            checked[field] = len(got)
        bb = loaded["vp_backbone_params"]
        if not all(torch.equal(state.vp_params[f"backbone.{k}"].cpu(), v) for k, v in bb.items()):
            raise AssertionError("rl --warm_start: the VideoProcessor's backbone differs")
        checked["vp_backbone_params"] = len(bb)
        return state

    rl.init_state = init_and_check
    try:
        t = time.time()
        rc = cli.main(["rl", "--warm_start", os.path.join(root, "out_rovr"), "--iterations", "1",
                       "--run_dir", os.path.join(root, "runs")])
        res["rl_warm_start_s"] = time.time() - t
    finally:
        rl.init_state = real_init
    if rc != 0 or len(checked) != 5:
        raise AssertionError(f"rl --warm_start: rc {rc}, checked {checked}")
    # eval --warm_start: lpips and raft converted into one directory
    metric = os.path.join(root, "out_vgg_lpips")
    if cli.main(["convert", "--kind", "raft", "--ckpt", paths["raft"], "--out", metric]) != 0:
        raise AssertionError("convert --kind raft into the lpips directory failed")
    means = []
    real_run = evaluate.run
    evaluate.run = lambda *a, **kw: means.append(real_run(*a, **kw)) or means[-1]
    try:
        t = time.time()
        rc = cli.main(["eval", "--warm_start", metric, "--num_videos", "1",
                       "--run_dir", os.path.join(root, "runs")])
        res["eval_warm_start_s"] = time.time() - t
    finally:
        evaluate.run = real_run
    m = means[0]
    if rc != 0 or (m["Eval/metric_weights_random"], m["Eval/lpips_weights_random"],
                   m["Eval/raft_weights_random"]) != (0.0, 0.0, 0.0):
        raise AssertionError(f"eval --warm_start: rc {rc}, weights marks "
                             f"{[(k, v) for k, v in m.items() if 'random' in k]}")
    if not all(math.isfinite(v) for v in m.values()):
        raise AssertionError(f"eval --warm_start: non-finite metrics {m}")
    res["rl_warm_start_checked"] = checked
    res["eval_means"] = m
    shutil.rmtree(root)
    log("convert: " + "; ".join(
        f"{k} {v['convert_s']:.2f} s (+save {v['save_s']:.2f} s, CLI {v['cli_s']:.1f} s), "
        f"{v['ckpt_bytes'] / 1e6:.1f} -> {v['converted_bytes'] / 1e6:.1f} MB"
        for k, v in res["kinds"].items())
        + f"; rl --warm_start {res['rl_warm_start_s']:.1f} s, its first state equal to the "
        f"converted tensors ({checked}); eval --warm_start (lpips + raft) "
        f"{res['eval_warm_start_s']:.1f} s, Eval/metric_weights_random 0")
    return res



# ------------------------------------------------------------- phases 25-28

MOE_EXPERTS = 4          # config 5 with experts: attn_moe_experts, capacity 1.25
MOE_PEAK_LIMIT = 2e9     # bytes above its inputs a PPO-size MoE call may allocate
MOE_TRAIN_STEPS = 2      # timed config-5 MoE steps after one warm-up
S2D_ITERS = 10           # CUDA-event iterations per s2d/plain timing


def _rel_max(got, ref):
    return ((got.float() - ref.float()).abs().max() / ref.float().abs().max()).item()


def phase_blocks_moe(torch, conv, attention, flax_init_state):
    """The attention module's rest and the MoE at config-5 width: a
    DecoderBlock (hidden 256, 4 heads) on (8, 256, 256) queries over an
    (8, 100, 256) encoder output in bf16, forward and backward through K2-K4
    (Lq != Lk in its cross attention) against the plain attention path,
    and each kernel at the cross shape against its plain twin (ATTN_TOL);
    MoEFeedForward (4 experts, capacity 1.25) at a rollout step's N = 2,048
    tokens, index dispatch against the one-hot einsum twin (bf16 rounding,
    2^-8 of the largest value), with a dropping capacity too; then at PPO's
    N = 131,072 tokens, forward + backward, its peak allocation above its
    inputs under MOE_PEAK_LIMIT (the dense (N, E, C) dispatch would be
    85.9 GB in f32) and its time."""
    from rovr_torch.models.attention import DecoderBlock
    from rovr_torch.models.moe import MoEFeedForward, capacity

    gen = torch.Generator(device="cuda").manual_seed(25)
    res = {}
    blocks = {impl: DecoderBlock(256, 4, attn_impl=impl).cuda() for impl in ("auto", "jnp")}
    params = flax_init_state(blocks["auto"], torch.Generator().manual_seed(25))
    x = torch.randn(8, 256, 256, device="cuda", generator=gen).bfloat16()
    enc = torch.randn(8, 100, 256, device="cuda", generator=gen).bfloat16()
    outs = {}
    for impl, blk in blocks.items():
        blk.load_state_dict(params)
        xi, ei = x.clone().requires_grad_(), enc.clone().requires_grad_()
        _zero_counts(conv, attention)
        y = blk(xi, ei)
        (y.float() ** 2).mean().backward()
        torch.cuda.synchronize()
        outs[impl] = (y.detach(), xi.grad, ei.grad, _counts(conv, attention))
    want = {"K1": 0, "K2": 2, "K3": 2, "K4": 2}
    if outs["auto"][3] != want or outs["jnp"][3] != {k: 0 for k in want}:
        raise AssertionError(f"decoder block launches {outs['auto'][3]} / plain "
                             f"{outs['jnp'][3]}, expected {want} / none")
    errs = {n: _rel_max(outs["auto"][i], outs["jnp"][i])
            for i, n in enumerate(("out", "grad_x", "grad_enc"))}
    # each kernel at the cross-attention shape (8, 4, 256 x 100, 64)
    q = torch.randn(8, 4, 256, 64, device="cuda", generator=gen).bfloat16()
    k, v = (torch.randn(8, 4, 100, 64, device="cuda", generator=gen).bfloat16()
            for _ in range(2))
    do = torch.randn_like(q)
    out, lse = attention.flash_attention_fwd(q, k, v)
    out_p, lse_p = attention.flash_attention_fwd_plain(q, k, v)
    delta = (do.float() * out.float()).sum(-1)
    dq = attention.flash_attention_dq(q, k, v, do, lse, delta)
    dk, dv = attention.flash_attention_dkv(q, k, v, do, lse, delta)
    dq_p = attention.flash_attention_dq_plain(q, k, v, do, lse, delta)
    dk_p, dv_p = attention.flash_attention_dkv_plain(q, k, v, do, lse, delta)
    torch.cuda.synchronize()
    errs.update(cross_out=_rel_max(out, out_p), cross_dq=_rel_max(dq, dq_p),
                cross_dk=_rel_max(dk, dk_p), cross_dv=_rel_max(dv, dv_p))
    errs["cross_lse_abs"] = (lse.float() - lse_p.float()).abs().max().item()
    log(f"decoder block (8,256)x(8,100), hidden 256: launches {outs['auto'][3]}; "
        f"kernel vs plain (x max|plain|, limit {ATTN_TOL}; lse abs, limit {LSE_TOL}) {errs}")
    if max(v for n, v in errs.items() if n != "cross_lse_abs") > ATTN_TOL \
            or errs["cross_lse_abs"] > LSE_TOL:
        raise AssertionError(f"decoder block / cross attention disagrees with plain: {errs}")
    res["decoder"] = dict(launches=outs["auto"][3], rel_err=errs)

    moe = {}
    for factor in (1.25, 0.3):
        m = MoEFeedForward(256, MOE_EXPERTS, factor).cuda()
        m.load_state_dict(flax_init_state(m, torch.Generator().manual_seed(26)))
        twin = MoEFeedForward(256, MOE_EXPERTS, factor, dispatch="onehot").cuda()
        twin.load_state_dict(m.state_dict())
        xr = torch.randn(8, 256, 256, device="cuda", generator=gen).bfloat16()
        with torch.no_grad():
            yi, yo = m(xr), twin(xr)
        torch.cuda.synchronize()
        err = _rel_max(yi, yo)
        dropped = int((yo.float() == 0).all(-1).sum())
        same_drops = torch.equal((yi.float() == 0).all(-1), (yo.float() == 0).all(-1))
        moe[f"n2048_cap{factor}"] = dict(rel_err=err, dropped=dropped,
                                        cap=capacity(2048, MOE_EXPERTS, factor))
        log(f"MoE N=2048 capacity {factor}: index vs one-hot max|d| {err:.3g} x max "
            f"(limit 2^-8), {dropped} tokens dropped")
        if err > 2 ** -8 or not same_drops or (dropped > 0) != (factor < 1.0):
            raise AssertionError(f"MoE index dispatch disagrees with the one-hot twin: "
                                 f"{moe[f'n2048_cap{factor}']}")
    m = MoEFeedForward(256, MOE_EXPERTS, 1.25).cuda()
    m.load_state_dict(flax_init_state(m, torch.Generator().manual_seed(27)))
    xb = torch.randn(512, 256, 256, device="cuda", generator=gen).bfloat16().requires_grad_()
    gy = torch.randn(512, 256, 256, device="cuda", generator=gen).bfloat16()
    torch.cuda.synchronize()

    def fwd_bwd():
        xb.grad = None
        for p in m.parameters():
            p.grad = None
        m(xb).backward(gy)

    fwd_bwd()                      # warm-up
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    fwd_bwd()
    torch.cuda.synchronize()
    peak = torch.cuda.max_memory_allocated() - base
    ms = cuda_ms(fwd_bwd, iters=5, warmup=1)
    with torch.no_grad():
        t_fwd = cuda_ms(lambda: m(xb), iters=5, warmup=1)
    cap = capacity(131072, MOE_EXPERTS, 1.25)
    moe["n131072"] = dict(cap=cap, peak_above_inputs_gb=peak / 1e9, fwd_bwd_ms=ms,
                          fwd_ms=t_fwd, buffer_gb=(MOE_EXPERTS * cap + 1) * 256 * 2 / 1e9,
                          dense_dispatch_f32_gb=131072 * MOE_EXPERTS * cap * 4 / 1e9,
                          finite=bool(torch.isfinite(xb.grad.float()).all()))
    log(f"MoE N=131072 (PPO's tokens), cap {cap}: forward {t_fwd:.3f} ms, forward + "
        f"backward {ms:.3f} ms, peak {peak / 1e9:.3f} GB above its inputs (limit "
        f"{MOE_PEAK_LIMIT / 1e9:.0f} GB; the (E, C, d) buffer "
        f"{moe['n131072']['buffer_gb']:.3f} GB, the dense dispatch would be "
        f"{moe['n131072']['dense_dispatch_f32_gb']:.1f} GB)")
    if peak > MOE_PEAK_LIMIT or not moe["n131072"]["finite"]:
        raise AssertionError(f"MoE at N=131072: {moe['n131072']}")
    res["moe"] = moe
    return res


def config5_moe(cfg5):
    import dataclasses

    return cfg5.replace(model=dataclasses.replace(cfg5.model, attn_moe_experts=MOE_EXPERTS,
                                                  attn_moe_capacity=1.25))


def phase_train5_moe(torch, conv, attention, rl, cfg5, video, org):
    """Config-5 train steps with the MoE FFN in both encoder blocks (4
    experts, capacity 1.25): a warm-up, then MOE_TRAIN_STEPS timed steps;
    each must launch exactly what the dense step launches (192 K1, 150 K2,
    20 K3, 20 K4), give finite metrics and move the actor's and critic's
    parameters, the experts' w1 among them; sec/step and peak memory."""
    cfg = config5_moe(cfg5)
    mods = rl.make_modules(cfg, device="cuda")
    state = rl.init_state(cfg, mods, seed=0)
    if "block0.moe_ff.w1" not in state.actor2_params:
        raise AssertionError("config 5 with experts built no moe_ff")
    gen = torch.Generator(device="cuda").manual_seed(26)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    _zero_counts(conv, attention)   # counts from here are this path's
    times = []
    for i in range(1 + MOE_TRAIN_STEPS):
        before = _counts(conv, attention)
        t0 = time.time()
        new, metrics, recon = rl.train_step(state, mods, cfg, video, org, generator=gen)
        torch.cuda.synchronize()
        times.append(time.time() - t0)
        after = _counts(conv, attention)
        step_counts = {k: after[k] - before[k] for k in after}
        if step_counts != TRAIN_LAUNCHES:
            raise AssertionError(f"MoE train step {i} launched {step_counts}, expected "
                                 f"{TRAIN_LAUNCHES}")
        m = _finite_metrics(metrics)
        moved = {f: _moved(getattr(new, f"{f}_params"), getattr(state, f"{f}_params"))
                 for f in ("actor2", "critic2")}
        w1 = (new.actor2_params["block0.moe_ff.w1"]
              - state.actor2_params["block0.moe_ff.w1"]).abs().max().item()
        if not (all(v > 0 for v in moved.values()) and w1 > 0):
            raise AssertionError(f"MoE train step {i} did not move the params: {moved}, w1 {w1}")
        if not torch.isfinite(recon).all():
            raise AssertionError("MoE train step reconstruction not finite")
        log(f"config-5 MoE train step {i}: {times[-1]:.3f} s, launches {step_counts}, "
            f"metrics {m}, max|w1 change| {w1:.3g}")
        state = new
    aux = [float(getattr(mods.actor2, f"block{i}").moe_ff.moe_aux.detach()) for i in range(2)]
    sec = sorted(times[1:])[len(times[1:]) // 2]
    res = dict(experts=MOE_EXPERTS, capacity=1.25, launches=_counts(conv, attention),
               launches_per_step=TRAIN_LAUNCHES, warmup_s=times[0], sec_per_step_each=times[1:],
               sec_per_step=sec, peak_mem_gb=torch.cuda.max_memory_allocated() / 1e9,
               moe_aux=aux, metrics=m)
    log(f"config-5 MoE train: {sec:.4f} s/step, peak {res['peak_mem_gb']:.2f} GB, "
        f"moe_aux {aux}")
    return res


def phase_s2d(torch, Config, flax_init_state):
    """PolicyNet2(canvas_impl="s2d") against "plain" at Config() on the same
    weights: greedy `act` at serving's batch 8 (equal actions, logprobs
    within POLICY_TOL of their scale) and the critic's `value` at PPO's
    B*T = 160 canvases (POLICY_TOL); then both trunks timed (CUDA events):
    `_video_conv` forward at batch 8 and forward + backward at 160."""
    from rovr_torch.models.policy_net_2 import PolicyNet2

    cfg = Config()
    m = cfg.model
    kw = dict(num_frames=m.pn2_num_frames, fc_dims=m.pn2_fc_dims, canvas_size=m.canvas_size,
              feature_dim=m.feature_dim)
    gen = torch.Generator(device="cuda").manual_seed(27)
    res, outs = {}, {}
    for critic in (False, True):
        pols = {impl: PolicyNet2(**kw, canvas_impl=impl, is_critic=critic).cuda()
                for impl in ("plain", "s2d")}
        params = flax_init_state(pols["plain"], torch.Generator().manual_seed(27 + critic))
        b = 160 if critic else 8
        canvas = torch.rand(b, m.canvas_size, m.canvas_size, 1, device="cuda", generator=gen)
        feat = torch.randn(b, m.feature_dim, device="cuda", generator=gen)
        tgt = torch.arange(b, device="cuda") % m.pn2_num_frames
        for impl, pol in pols.items():
            pol.load_state_dict(params)
            with torch.no_grad():
                outs[(impl, critic)] = (pol.value(canvas, feat) if critic else
                                        pol.act(canvas, feat, tgt, greedy=True))
            pol.requires_grad_(True)
            cv = canvas.clone().requires_grad_()
            res[f"{impl}_{'ppo_fwd_bwd' if critic else 'serve_fwd'}_ms"] = cuda_ms(
                (lambda p=pol, c=cv: p._video_conv(c).sum().backward()) if critic else
                (lambda p=pol, c=canvas: p._video_conv(c)), iters=S2D_ITERS, warmup=2)
    torch.cuda.synchronize()
    (acs_p, lp_p), (acs_s, lp_s) = outs[("plain", False)], outs[("s2d", False)]
    v_p, v_s = outs[("plain", True)], outs[("s2d", True)]
    res.update(actions_equal=bool(torch.equal(acs_p, acs_s)), logprob_rel=_rel_max(lp_s, lp_p),
               value_rel=_rel_max(v_s, v_p))
    log(f"s2d canvas at Config(): {res}")
    if not res["actions_equal"] or res["logprob_rel"] > POLICY_TOL \
            or res["value_rel"] > POLICY_TOL:
        raise AssertionError(f"PolicyNet2 s2d disagrees with plain: {res}")
    return res


def phase_dp1(torch, np, conv, attention, rl, infer, dataset, cfg5, video, org, masks, u8):
    """Data parallel at world size 1 over NCCL (a TCP store on a localhost
    port, in this process): `make_sharded_train_step` against `train_step`
    on config 5's state with the same global noise (metrics within 1e-3
    relative + 1e-4; the updated actor and critic within 2*lr*n_updates
    everywhere and 1e-5 on 99% of entries), the all-reduces counted (more
    than 0) and the step's K1-K4 launches; `reconstruct_clips(mesh=)` against
    `reconstruct_clips()` (uint8 within 1 LSB, equal actions);
    `DevicePrefetcher(sharding=mesh)` staging bitwise equal to the host items."""
    import torch.distributed as dist

    from rovr_torch.parallel import collectives, launch
    from rovr_torch.parallel.mesh import make_mesh

    mods = rl.make_modules(cfg5, device="cuda")
    state = rl.init_state(cfg5, mods, seed=0)
    gen = torch.Generator(device="cuda").manual_seed(28)
    b, s, t = video.shape[0], video.shape[1], cfg5.rl.time_steps
    noise = (rl.gumbel_noise((t, b, s), gen, "cuda"),
             rl.gumbel_noise((cfg5.rl.n_updates_per_ppo, b * t, s), gen, "cuda"))
    t0 = time.time()
    want = rl.train_step(state, mods, cfg5, video, org, gumbel=noise, masks=masks)
    torch.cuda.synchronize()
    single_s = time.time() - t0
    serve_want = next(infer.reconstruct_clips(cfg5, state, mods, [u8]))
    dist.init_process_group("nccl", init_method=f"tcp://127.0.0.1:{launch.free_port()}",
                            world_size=1, rank=0)
    try:
        mesh = make_mesh(cfg5.mesh)
        calls = dict(collectives.CALLS)
        step = rl.make_sharded_train_step(mesh, mods, cfg5)
        _zero_counts(conv, attention)   # counts from here are the sharded step's
        t0 = time.time()
        got = step(state, video, org, gumbel=noise, masks=masks)
        torch.cuda.synchronize()
        sharded_s = [time.time() - t0]
        counts = _counts(conv, attention)
        step_calls = {k: collectives.CALLS[k] - calls.get(k, 0) for k in collectives.CALLS}
        t0 = time.time()   # a second step: the first set up NCCL's communicator
        step(state, video, org, gumbel=noise, masks=masks)
        torch.cuda.synchronize()
        sharded_s.append(time.time() - t0)
        serve_got = next(infer.reconstruct_clips(cfg5, state, mods, [u8], mesh=mesh))
        items = [(np.random.default_rng(i).uniform(size=(8, 64, 64, 3)).astype(np.float32),)
                 for i in range(6)]
        pre = dataset.DevicePrefetcher(items, num_workers=2, sharding=mesh)
        staged_equal = all(torch.equal(x[0].cpu(), torch.from_numpy(items[i][0]))
                           for i, x in enumerate(pre))
        pre.close()
    finally:
        dist.destroy_process_group()
    if counts != TRAIN_LAUNCHES or step_calls.get("all_reduce", 0) == 0:
        raise AssertionError(f"sharded step launches {counts}, collectives {step_calls}")
    merr = {k: abs(float(got[1][k]) - float(v)) / (abs(float(v)) + 1e-1)
            for k, v in want[1].items()}
    bound = 2 * cfg5.rl.actor_lr * cfg5.rl.n_updates_per_ppo
    pdiff = {}
    for field in ("actor2_params", "critic2_params"):
        a, ref = getattr(got[0], field), getattr(want[0], field)
        d = torch.cat([(a[k] - ref[k]).abs().flatten() for k in ref])
        pdiff[field] = dict(max=d.max().item(), share_1e5=(d <= 1e-5).float().mean().item())
    lsb = int(np.abs(serve_got[0].astype(int) - serve_want[0].astype(int)).max())
    res = dict(launches=counts, collectives=step_calls, metrics_rel=merr, params=pdiff,
               single_s=single_s, sharded_s=sharded_s, serve_max_lsb=lsb,
               serve_actions_equal=bool(np.array_equal(serve_got[1], serve_want[1])),
               staged_equal=staged_equal)
    log(f"data parallel, world size 1 over NCCL: {res}")
    ok = (set(got[1]) == set(want[1])
          and all(abs(float(got[1][k]) - float(v)) <= 1e-3 * abs(float(v)) + 1e-4
                  for k, v in want[1].items())
          and all(p["max"] <= bound and p["share_1e5"] >= 0.99 for p in pdiff.values())
          and lsb <= 1 and res["serve_actions_equal"] and staged_equal)
    if not ok:
        raise AssertionError(f"the world-size-1 mesh disagrees with one device: {res}")
    return res


MODEL_AXIS_PATHS = ("tp", "ring", "ep", "pp")   # phase 29's steps on the model axis
# launches per config-5 step of each path on a model axis of 1: the ring's
# blocks are torch products (the JAX ring is jnp), so no K2-K4 in the encoder
MODEL_AXIS_LAUNCHES = {"tp": TRAIN_LAUNCHES, "ep": TRAIN_LAUNCHES, "pp": TRAIN_LAUNCHES,
                       "ring": {"K1": 192, "K2": 0, "K3": 0, "K4": 0}}


def model_axis_config(cfg5, path):
    """Config 5 as each model-axis path runs it, and the config of its
    single-device reference (`train_step` on the global batch)."""
    import dataclasses

    m = cfg5.model
    over = {"tp": {}, "ring": dict(attn_impl="ring"), "pp": dict(attn_pp_microbatches=2),
            "ep": dict(attn_moe_experts=MOE_EXPERTS, attn_moe_capacity=1.25)}[path]
    cfg = cfg5.replace(model=dataclasses.replace(m, **over))
    ref = cfg5 if path != "ep" else cfg
    return cfg, ref


def _params_close(torch, got, want, bound):
    """phase_dp1's parameter bounds: within `bound` everywhere, within 1e-5
    on 99% of entries; the measured max and share."""
    out = {}
    for field in ("actor2_params", "critic2_params"):
        a, ref = got[field], getattr(want, field)
        d = torch.cat([(a[k] - ref[k]).abs().flatten() for k in ref])
        out[field] = dict(max=d.max().item(), share_1e5=(d <= 1e-5).float().mean().item())
    ok = all(p["max"] <= bound and p["share_1e5"] >= 0.99 for p in out.values())
    return ok, out


def ring_vs_flash(torch, attention, mesh):
    """Ring attention (over the mesh's model axis) at the PPO shape
    (512,4,256,64) in bf16 against the exact attention (f32 products of the
    same bf16 values): out and dq, dk, dv of sum(out * w), each within
    ATTN_TOL of max|exact|. The flash op (K2-K4, which round P and dS to
    bf16 as their plain twins do) on the same inputs is recorded beside it,
    not held here (tests/test_torch_cuda.py holds it to its twins)."""
    from rovr_torch.models.attention import attend_plain
    from rovr_torch.parallel.ring_attention import ring_attend

    gen = torch.Generator(device="cuda").manual_seed(290)
    b, h, l, _, d = ATTN_SHAPES["ppo"]
    q, k, v = (torch.randn(b, h, l, d, generator=gen, device="cuda").to(torch.bfloat16)
               for _ in range(3))
    w = torch.randn(b, h, l, d, generator=gen, device="cuda")

    def run(fn, dtype):
        xs = [t.to(dtype).detach().clone().requires_grad_() for t in (q, k, v)]
        out = fn(*xs)
        (out.float() * w).sum().backward()
        return [out.float()] + [t.grad.float() for t in xs]

    want = run(attend_plain, torch.float32)
    res = {}
    for name, fn in (("ring", lambda *x: ring_attend(*x, mesh)),
                     ("flash", attention.flash_attention)):
        got = run(fn, torch.bfloat16)
        res[name] = {part: ((g - r).abs().max() / r.abs().max()).item()
                     for part, g, r in zip(("out", "dq", "dk", "dv"), got, want)}
    res["ok"] = all(e <= ATTN_TOL for e in res["ring"].values())
    return res


def _one_epoch(cfg):
    import dataclasses

    return cfg.replace(rl=dataclasses.replace(cfg.rl, n_updates_per_ppo=1))


# Adam first moments after one PPO epoch (0.1 * g): each leaf's largest
# |m - m_ref| over its network's largest |m_ref| (the CPU tests' rule, at
# 1e-3 in f32 there). Held on the critic: on one H100 the sound paths read
# at most 6.0e-4 there and the planted fault 4.9e-2 to 0.27 (PERF.md, slice
# 8). The actor is recorded: its largest first moment is 2e-4 against the
# critic's 1.3 (at PPO's first epoch its gradient is a sum of advantage-
# weighted terms that mostly cancel), so the ring's other bf16 rounding
# alone moves it by 0.19, above the planted fault in EP (0.11)
MOMENT_TOL = 1e-2


def _moments_close(torch, got, want):
    """The first moments of the actor and critic (gathered whole) against
    `want`'s: per network the worst leaf's reading; the critic's held to
    MOMENT_TOL."""
    out = {}
    for field in ("actor2", "critic2"):
        mine, ref = got[f"{field}_opt"]["exp_avg"], getattr(want, f"{field}_opt")["exp_avg"]
        top = max(v.abs().max().item() for v in ref.values())
        errs = {k: (mine[k] - ref[k]).abs().max().item() / top for k in ref}
        leaf = max(errs, key=errs.get)
        out[field] = dict(max=errs[leaf], leaf=leaf, top=top)
    return out["critic2"]["max"] <= MOMENT_TOL, out


def _reference_step(torch, rl, ref_cfg, device, video, org, masks, noise):
    """`train_step` on the global batch from the seed-0 state: the new
    state, the metrics and the host seconds."""
    mods = rl.make_modules(ref_cfg, device=device)
    st = rl.init_state(ref_cfg, mods, seed=0)
    n_up = ref_cfg.rl.n_updates_per_ppo
    torch.cuda.synchronize()
    t0 = time.time()
    new, metrics, _ = rl.train_step(st, mods, ref_cfg, video, org,
                                    gumbel=(noise[0], noise[1][:n_up]), masks=masks)
    torch.cuda.synchronize()
    return new, {k: float(v) for k, v in metrics.items()}, time.time() - t0


def _path_step(torch, rl, cfg, mesh, path, video, org, masks, noise):
    """The model-axis path's modules, seed-0 state and step on `mesh`."""
    from rovr_torch.parallel import tp

    tensor_parallel = path == "tp"
    mods = rl.make_modules(cfg, mesh=mesh, tensor_parallel=tensor_parallel)
    state = rl.init_state(cfg, mods, seed=0)
    make = tp.make_tp_train_step if tensor_parallel else rl.make_sharded_train_step
    step = make(mesh, mods, cfg)
    n_up = cfg.rl.n_updates_per_ppo
    return mods, lambda: step(state, video, org, gumbel=(noise[0], noise[1][:n_up]),
                              masks=masks)


def model_axis_steps(torch, conv, attention, rl, cfg5, mesh, video, org, masks, noise,
                     timing=True):
    """Each model-axis path of config 5 on `mesh` (tensor parallel, ring
    attention, 4 experts, the pipeline with 2 microbatches) against
    `train_step` on the global batch with the same global noise, on every
    rank. After one PPO epoch: each leaf's Adam first moment of the critic
    within MOMENT_TOL (`_moments_close`; Adam's first step is lr * sign(g), so the
    parameters alone cannot see a gradient off by a positive factor); the
    updated actor and critic (gathered whole) within 2*lr everywhere; on a
    (1, 1) mesh, but for the ring (f32 products where K2-K4 round P and dS to
    bf16: `ring_vs_flash` holds its attention and gradients), the metrics
    within 1e-3 relative + 1e-4 and the parameters within 1e-5 on 99% of
    entries; elsewhere the metrics and the share are recorded. Then the path
    at the config's five epochs, for timing (unless `timing` is False): K1-K4
    launches and collectives of its first step, host seconds of the first
    and of a second step from the same state, peak memory, the metrics'
    distance recorded."""
    from rovr_torch.parallel import collectives, tp

    refs, res = {}, {}
    one_rank = mesh.size * mesh.model_size == 1
    for path in MODEL_AXIS_PATHS:
        cfg_full, ref_full = model_axis_config(cfg5, path)
        r = {}
        runs = [("one_epoch", _one_epoch(cfg_full), _one_epoch(ref_full))]
        for label, cfg, ref_cfg in runs + [("full", cfg_full, ref_full)] * timing:
            n_up = cfg.rl.n_updates_per_ppo
            key = (ref_cfg.model.attn_moe_experts, n_up)
            if key not in refs:
                refs[key] = _reference_step(torch, rl, ref_cfg, mesh.device, video, org,
                                            masks, noise)
            want, want_m, ref_s = refs[key]
            mods, step = _path_step(torch, rl, cfg, mesh, path, video, org, masks, noise)
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            before = dict(collectives.CALLS)
            _zero_counts(conv, attention)   # counts from here are this path's
            times = []
            for i in range(2 if label == "full" else 1):
                t0 = time.time()
                out = step()
                torch.cuda.synchronize()
                times.append(time.time() - t0)
                if i == 0:
                    new, metrics, recon = out
                    counts = _counts(conv, attention)
                    calls = {k: v - before.get(k, 0) for k, v in collectives.CALLS.items()
                             if v - before.get(k, 0)}
            merr = {k: abs(float(metrics[k]) - v) / (abs(v) + 1e-1) for k, v in want_m.items()}
            ok = (set(metrics) == set(want_m) and new.step == 1
                  and bool(torch.isfinite(recon).all()))
            r[label] = dict(launches=counts, collectives=calls, sec=times, ref_sec=ref_s,
                            metrics_rel=merr, peak_mem_gb=torch.cuda.max_memory_allocated() / 1e9)
            if label == "one_epoch":
                whole = tp.gather_state(new, tp.state_shardings(mods), mesh)
                _, pdiff = _params_close(torch, {f: getattr(whole, f) for f in (
                    "actor2_params", "critic2_params")}, want, 2 * cfg.rl.actor_lr)
                moments_ok, moments = _moments_close(torch, whole._asdict(), want)
                held = one_rank and path != "ring"
                ok = (ok and moments_ok and all(p["max"] <= 2 * cfg.rl.actor_lr
                                                for p in pdiff.values())
                      and (not held or (
                          all(abs(float(metrics[k]) - v) <= 1e-3 * abs(v) + 1e-4
                              for k, v in want_m.items())
                          and all(p["share_1e5"] >= 0.99 for p in pdiff.values()))))
                r[label].update(params=pdiff, moments=moments)
                del whole
            r[label]["ok"] = ok
            del mods, step, new
            torch.cuda.empty_cache()
        if not timing:
            res[path] = dict(ok=r["one_epoch"]["ok"], one_epoch=r["one_epoch"])
            continue
        full = r["full"]
        res[path] = dict(ok=r["one_epoch"]["ok"] and full["ok"], launches=full["launches"],
                         collectives=full["collectives"], sec_first=full["sec"][0],
                         sec_second=full["sec"][1], ref_sec=full["ref_sec"],
                         peak_mem_gb=full["peak_mem_gb"], one_epoch=r["one_epoch"], full=full)
    return res


def planted_fault(torch, rl, cfg5, mesh, video, org, masks, noise):
    """The first-moment gate against a planted fault: the TP and the EP step
    after one epoch with `reduce_from_model`'s gradient doubled (on a model
    axis of 2 that is the Trap of an all-reducing backward; on one card it
    reads as it would there). Each must read above MOMENT_TOL on the critic
    (the network `model_axis_steps` holds). On one card
    also a look at the (1, 1) actor's last-bit distance: the TP step with the
    advantage normalised without the mesh (the same function on one rank),
    its parameters against `train_step`'s."""
    from rovr_torch.parallel import collectives, tp

    class _Twice(torch.autograd.Function):
        @staticmethod
        def forward(ctx, x):
            return x.view_as(x)

        @staticmethod
        def backward(ctx, g):
            return 2 * g

    res = {}
    reduce = collectives.reduce_from_model
    collectives.reduce_from_model = lambda x, m: _Twice.apply(reduce(x, m))
    try:
        for path in ("tp", "ep"):
            cfg, ref_cfg = (_one_epoch(c) for c in model_axis_config(cfg5, path))
            want = _reference_step(torch, rl, ref_cfg, mesh.device, video, org, masks, noise)[0]
            mods, step = _path_step(torch, rl, cfg, mesh, path, video, org, masks, noise)
            whole = tp.gather_state(step()[0], tp.state_shardings(mods), mesh)
            res[path] = _moments_close(torch, whole._asdict(), want)[1]
    finally:
        collectives.reduce_from_model = reduce
    res["caught"] = all(res[p]["critic2"]["max"] > MOMENT_TOL for p in ("tp", "ep"))
    if mesh.size * mesh.model_size == 1:
        normalized = rl.normalized_advantage
        rl.normalized_advantage = lambda *a, mesh=None: normalized(*a)
        try:
            cfg, ref_cfg = (_one_epoch(c) for c in model_axis_config(cfg5, "tp"))
            want = _reference_step(torch, rl, ref_cfg, mesh.device, video, org, masks, noise)[0]
            mods, step = _path_step(torch, rl, cfg, mesh, "tp", video, org, masks, noise)
            new = step()[0]
            res["meshless_advantage_params"] = _params_close(torch, {f: getattr(new, f) for f in (
                "actor2_params", "critic2_params")}, want, 2 * cfg.rl.actor_lr)[1]
        finally:
            rl.normalized_advantage = normalized
    return res


def phase_model_axis(torch, conv, attention, rl, cfg5, video, org, masks):
    """Config 5's model-axis paths on a (1, 1) NCCL mesh (a TCP store on a
    localhost port, in this process) against `train_step`
    (`model_axis_steps`): TP, EP and PP must launch 192 K1, 150 K2, 20 K3,
    20 K4 a step, the ring 192 K1 and no K2-K4 (its blocks are torch
    products); the first-moment gate must catch `planted_fault`; then
    `dryrun_multichip` over every visible card (one card: pass 1)."""
    import torch.distributed as dist

    from rovr_torch.config import MeshConfig
    from rovr_torch.parallel import dryrun, launch
    from rovr_torch.parallel.mesh import make_mesh

    gen = torch.Generator(device="cuda").manual_seed(29)
    b, s, t = video.shape[0], video.shape[1], cfg5.rl.time_steps
    noise = (rl.gumbel_noise((t, b, s), gen, "cuda"),
             rl.gumbel_noise((cfg5.rl.n_updates_per_ppo, b * t, s), gen, "cuda"))
    dist.init_process_group("nccl", init_method=f"tcp://127.0.0.1:{launch.free_port()}",
                            world_size=1, rank=0)
    try:
        mesh = make_mesh(MeshConfig(data_parallel=1, model_parallel=1))
        res = model_axis_steps(torch, conv, attention, rl, cfg5, mesh, video, org, masks,
                               noise)
        res["ring_attention"] = ring_vs_flash(torch, attention, mesh)
        res["planted_fault"] = planted_fault(torch, rl, cfg5, mesh, video, org, masks, noise)
    finally:
        dist.destroy_process_group()
    for path, r in res.items():
        log(f"model axis (1, 1), {path}: {r}")
    bad = {p: res[p] for p in MODEL_AXIS_PATHS
           if not res[p]["ok"] or res[p]["launches"] != MODEL_AXIS_LAUNCHES[p]}
    if not res["ring_attention"]["ok"]:
        bad["ring_attention"] = res["ring_attention"]
    if not res["planted_fault"]["caught"]:
        bad["planted_fault"] = res["planted_fault"]
    if bad:
        raise AssertionError(f"model-axis paths disagree with train_step: {bad}")
    torch.cuda.empty_cache()
    t0 = time.time()
    passes = dryrun.dryrun_multichip(torch.cuda.device_count())
    res["dryrun"] = dict(passes=passes, seconds=time.time() - t0)
    log(f"dryrun_multichip({torch.cuda.device_count()}): {len(passes)} passes in "
        f"{res['dryrun']['seconds']:.1f} s: {passes}")
    return res


PIPE_CHAIN = 3    # pipelined steps held against train_step, each on the previous next_init
PIPE_STEPS = 10   # timed steps of each arm of phase 30, after one warm-up step each


def _gap(got, want):
    """Largest |got - want| over the tensors of two like trees."""
    from rovr_torch.utils.profiling import tree_tensors

    return max([(a.float() - b.float()).abs().max().item()
                for a, b in zip(tree_tensors(got), tree_tensors(want))] or [0.0])


def _absmax(tree):
    from rovr_torch.utils.profiling import tree_tensors

    return max([t.float().abs().max().item() for t in tree_tensors(tree)] or [0.0])


def _pipelined_against_plain(torch, rl, cfg, got, want, want_next, steps):
    """A pipelined step (state, metrics, reconstructed, next_init) against
    `train_step`'s (state, metrics, reconstructed) and `episode_init` of the
    next batch: bit for bit, or else phase 28's bounds (metrics within 1e-3
    relative + 1e-4; actor and critic within 2*lr*n_updates per step taken,
    and 1e-5 on 99% of entries) and the next init within bf16 rounding of
    its largest value; returns (bitwise, ok, gaps)."""
    bitwise = (_same_tree(got[0], want[0]) and _same_tree(got[1], want[1])
               and _same_tree(got[2], want[2]) and _same_tree(got[3], want_next))
    if bitwise:
        return True, True, {}
    bound = 2 * cfg.rl.actor_lr * cfg.rl.n_updates_per_ppo * steps
    params_ok, params = _params_close(torch, got[0]._asdict(), want[0], bound)
    metric_gap = {k: abs(float(got[1][k]) - float(v)) for k, v in want[1].items()}
    metrics_ok = all(metric_gap[k] <= 1e-3 * abs(float(v)) + 1e-4 for k, v in want[1].items())
    fields = rl.EpisodeInit._fields
    init_gap = {f: _gap(getattr(got[3], f), getattr(want_next, f)) for f in fields}
    init_ok = all(init_gap[f] <= 2 ** -8 * _absmax(getattr(want_next, f))
                  for f in fields)
    gaps = dict(params=params, metrics=metric_gap, recon=_gap(got[2], want[2]),
                next_init=init_gap)
    return False, params_ok and metrics_ok and init_ok, gaps


def _arm_steps(rl, mods, cfg):
    """Phase 30's arms, each step(state, init, batch, next batch, generator)
    -> (state, the init of the next batch): `train_step` (its rollout runs
    the init in line; the init is handed through) and
    `train_step_pipelined`."""
    def plain(state, init, cur, nxt, gen):
        return rl.train_step(state, mods, cfg, *cur, generator=gen)[0], init

    def pipelined(state, init, cur, nxt, gen):
        out = rl.train_step_pipelined(state, mods, cfg, init, *cur, *nxt, generator=gen)
        return out[0], out[3]

    return dict(plain=plain, pipelined=pipelined)


def _profile_pipelined(torch, rl, profiling, fn, state, mods, cfg, batches, out_dir):
    """One pipelined step (after one untraced step) under
    utils.profiling.trace: device time summed against busy (their
    difference is the time two streams ran at once), the idle share,
    `rovr/episode_init`'s device time and streams, the step's own streams,
    and the share of the init's window in which the step's streams ran."""
    init = rl.episode_init(state, mods, cfg, *batches[0])
    gen = torch.Generator(device="cuda").manual_seed(32)
    fn(state, init, batches[0], batches[1], gen)
    trace_dir = os.path.join(out_dir, "pipelined_trace")
    torch.cuda.synchronize()
    with profiling.trace(trace_dir):
        t0 = time.time()
        fn(state, init, batches[0], batches[1], gen)
        torch.cuda.synchronize()
        wall_ms = (time.time() - t0) * 1e3
    rep = profiling.analyze_trace(trace_dir)
    shutil.rmtree(trace_dir, ignore_errors=True)
    if rep["idle_share"] is None:
        raise AssertionError("the profiler saw no device work in the pipelined step")
    init_streams = rep["range_streams"].get("rovr/episode_init", {})
    step_streams = {st: v["ms"] - init_streams.get(st, [0.0])[0]
                    for st, v in rep["streams"].items()}
    step_streams = {st: ms for st, ms in step_streams.items() if ms > 1e-6}
    if not init_streams or set(init_streams) & set(step_streams):
        raise AssertionError(f"the init's kernels did not run on a stream of their own: "
                             f"init {init_streams}, step {step_streams}")
    window = {str(st): rep["streams"][st] for st in init_streams}
    init_ms = sum(ms for ms, _ in init_streams.values())
    res = dict(wall_ms=wall_ms, trace_wall_ms=rep["wall_ms"], device_ms=rep["device_ms"],
               busy_ms=rep["busy_ms"], overlap_ms=rep["device_ms"] - rep["busy_ms"],
               idle_share=rep["idle_share"], episode_init_ms=init_ms,
               init_streams={str(k): v for k, v in init_streams.items()},
               step_streams={str(k): v for k, v in step_streams.items()},
               init_window=window, top=rep["top_device"][:15])
    log(f"profile of one config-5 pipelined step: trace {rep['wall_ms']:.1f} ms, device "
        f"{rep['device_ms']:.1f} ms summed against {rep['busy_ms']:.1f} ms busy (the streams "
        f"overlapped {res['overlap_ms']:.1f} ms), idle share {rep['idle_share']:.3f}; "
        f"rovr/episode_init {init_ms:.1f} ms of device time on streams "
        f"{res['init_streams']}, the step's own on {res['step_streams']}; the init's "
        f"stream's window and the share of it in which the step's streams ran: {window}")
    return res


def phase_pipelined5(torch, conv, attention, rl, profiling, cfg5, video, org, out_dir):
    """Config 5's double-buffered step, `rl.train_step_pipelined` (batch 8,
    S = T = 64, the attention policy, phase 12's clips as float): a chain of
    PIPE_CHAIN steps, each on the previous `next_init`, against as many
    `train_step`s with the same generator (bit for bit, or a gap printed and
    held at phase 28's bounds) and each `next_init` against `episode_init`,
    with 192/150/20/20 K1-K4 launches a step; then the two arms interleaved
    (plain `train_step`, whose rollout runs the init in line; the pipelined
    step), PIPE_STEPS timed steps each after a warm-up: sec/step, frames/s,
    peak memory, the bytes of one EpisodeInit; then one pipelined step under
    utils.profiling.trace: device time summed against busy (their difference
    is the time the two streams ran at once), the idle share, the init's
    device time and streams (none of them the step's), and the share of the
    init's window in which the step's streams ran."""
    mods = rl.make_modules(cfg5, device="cuda")
    state = rl.init_state(cfg5, mods, seed=0)
    v, o = (x.float() * (1.0 / 255.0) for x in (video, org))
    batches = [(torch.roll(v, i, 0), torch.roll(o, i, 0)) for i in range(PIPE_CHAIN + 1)]
    del v, o
    b, t = video.shape[0], cfg5.rl.time_steps

    # a chain of pipelined steps against train_step + episode_init
    section_s = {}
    t_section = time.time()
    g_plain, g_pipe = (torch.Generator(device="cuda").manual_seed(30) for _ in range(2))
    init = rl.episode_init(state, mods, cfg5, *batches[0])
    plain_state = pipe_state = state
    chain = []
    for i in range(PIPE_CHAIN):
        want = rl.train_step(plain_state, mods, cfg5, *batches[i], generator=g_plain)
        want_next = rl.episode_init(state, mods, cfg5, *batches[i + 1])
        torch.cuda.synchronize()
        _zero_counts(conv, attention)   # counts from here are the pipelined step's
        got = rl.train_step_pipelined(pipe_state, mods, cfg5, init, *batches[i],
                                      *batches[i + 1], generator=g_pipe)
        torch.cuda.synchronize()
        counts = _counts(conv, attention)
        if counts != TRAIN_LAUNCHES:
            raise AssertionError(f"pipelined step {i} launched {counts}, "
                                 f"expected {TRAIN_LAUNCHES}")
        _finite_metrics(got[1])
        bitwise, ok, gaps = _pipelined_against_plain(torch, rl, cfg5, got, want, want_next,
                                                     i + 1)
        chain.append(dict(step=i, bitwise=bitwise, ok=ok, gaps=gaps, launches=counts))
        log(f"config-5 pipelined step {i} against train_step + episode_init: "
            + ("bit for bit" if bitwise else f"NOT bit for bit, gaps {gaps}, phase 28's "
               f"bounds {'held' if ok else 'FAILED'}") + f"; launches {counts}")
        if not ok:
            raise AssertionError(f"pipelined step {i} is off train_step: {gaps}")
        plain_state, pipe_state, init = want[0], got[0], got[3]
    init_bytes = sum(x.numel() * x.element_size() for x in profiling.tree_tensors(init))
    taps_bytes = sum(x.numel() * x.element_size() for x in init.org_taps)
    del want, got, want_next, plain_state, pipe_state
    torch.cuda.empty_cache()
    init = rl.episode_init(state, mods, cfg5, *batches[0])

    section_s["chain"] = time.time() - t_section
    t_section = time.time()

    # the arms, interleaved
    steps = _arm_steps(rl, mods, cfg5)
    states = dict.fromkeys(steps, state)
    inits = dict.fromkeys(steps, init)
    gens = {a: torch.Generator(device="cuda").manual_seed(31) for a in steps}
    times, host, peaks = ({a: [] for a in steps} for _ in range(3))
    for i in range(1 + PIPE_STEPS):
        cur, nxt = batches[i % 2], batches[(i + 1) % 2]
        for arm, fn in steps.items():
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            start = torch.cuda.memory_allocated()
            held = 0 if arm == "plain" else sum(
                x.numel() * x.element_size() for x in profiling.tree_tensors(inits[arm]))
            t0 = time.time()
            states[arm], inits[arm] = fn(states[arm], inits[arm], cur, nxt, gens[arm])
            t1 = time.time()
            torch.cuda.synchronize()
            if i:
                times[arm].append(time.time() - t0)
                host[arm].append(t1 - t0)
                peaks[arm].append((torch.cuda.max_memory_allocated(), start, held))
    timing = {}
    for arm in steps:
        ts = sorted(times[arm])
        peak, start, held = max(peaks[arm])
        own = (peak - start + held) / 1e9
        timing[arm] = dict(sec_each=times[arm], sec_per_step=_median(ts), sec_min=ts[0],
                           sec_max=ts[-1], frames_per_sec=b * t / _median(ts),
                           host_sec_per_step=_median(host[arm]),
                           peak_gb=peak / 1e9, peak_above_start_gb=(peak - start) / 1e9,
                           footprint_gb=own)
        log(f"config-5 {arm} arm: {_median(ts):.4f} s/step (median of {len(ts)}, "
            f"{ts[0]:.4f}-{ts[-1]:.4f}; the call returned after {_median(host[arm]):.4f} s), "
            f"{b * t / _median(ts):.1f} frames/s, peak {peak / 1e9:.2f} GB, of it "
            f"{(peak - start) / 1e9:.2f} GB above the step's start; the step's own "
            f"{own:.2f} GB with the init it holds at its start")
    ratio = timing["pipelined"]["sec_per_step"] / timing["plain"]["sec_per_step"]
    log(f"config-5 pipelined / plain sec/step {ratio:.4f} (interleaved, one call); one "
        f"EpisodeInit {init_bytes / 1e9:.3f} GB, its org taps {taps_bytes / 1e9:.3f} GB")
    del states, inits
    torch.cuda.empty_cache()

    section_s["arms"] = time.time() - t_section
    t_section = time.time()

    # one pipelined step under the profiler
    prof = _profile_pipelined(torch, rl, profiling, steps["pipelined"], state, mods, cfg5,
                              batches, out_dir)
    section_s["profile"] = time.time() - t_section
    log(f"phase 30 sections (host seconds): {section_s}")
    return dict(chain=chain, bitwise=all(c["bitwise"] for c in chain), timing=timing,
                pipelined_over_plain=ratio, init_bytes=init_bytes, taps_bytes=taps_bytes,
                profile=prof, section_s=section_s)


def _grid_rank(_mesh, out_dir, grid, timing):
    """One process of `--grid DxM`: config 5's model-axis paths on the
    (D, M) NCCL mesh, against `train_step` on this card; each process
    writes its record."""
    import numpy as np
    import torch

    from rovr_torch.config import Config
    from rovr_torch.data import synthetic
    from rovr_torch.ops import attention, conv
    from rovr_torch.train import rl

    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    dp, mp = grid
    from rovr_torch.config import MeshConfig
    from rovr_torch.parallel.mesh import make_mesh

    mesh = make_mesh(MeshConfig(data_parallel=dp, model_parallel=mp))
    cfg5 = config5(Config)
    _, (video, org), masks = config5_clips(torch, np, synthetic, cfg5)
    gen = torch.Generator(device="cuda").manual_seed(29)
    b, s, t = video.shape[0], video.shape[1], cfg5.rl.time_steps
    noise = (rl.gumbel_noise((t, b, s), gen, "cuda"),
             rl.gumbel_noise((cfg5.rl.n_updates_per_ppo, b * t, s), gen, "cuda"))
    res = model_axis_steps(torch, conv, attention, rl, cfg5, mesh, video, org, masks, noise,
                           timing)
    res["ring_attention"] = ring_vs_flash(torch, attention, mesh)
    res["planted_fault"] = planted_fault(torch, rl, cfg5, mesh, video, org, masks, noise)
    res["rank"] = (mesh.rank, mesh.model_rank)
    with open(os.path.join(out_dir, f"grid_rank{mesh.rank * mp + mesh.model_rank}.json"),
              "w") as f:
        json.dump(res, f, indent=1)


def main_grid(grid: str, gate_only: bool = False) -> int:
    """`python3 chip_smoke.py --grid DxM [--gate]`: D*M cards. Builds the
    kernels, runs config 5's model-axis paths on a (D, M) NCCL mesh in D*M
    processes (`_grid_rank`), then `dryrun_multichip(D*M)`; prints each
    rank's record, the card line and the last line as the one-card run
    does. `--gate`: the one-epoch checks and the planted fault alone (no
    five-epoch timing, no dry run)."""
    import torch

    if not torch.cuda.is_available():
        log("chip_smoke: no CUDA device is visible; this script runs on the GPU")
        return 2
    here = os.path.dirname(os.path.abspath(__file__))
    sys.path.insert(0, here)
    from rovr_torch.ops import cuda_build
    from rovr_torch.parallel import dryrun, launch

    dims = tuple(int(x) for x in grid.split("x"))
    n = dims[0] * dims[1]
    kind = torch.cuda.get_device_name(0)
    log(f"device: {kind} x{torch.cuda.device_count()}; nvidia-smi: {card_line()}")
    cuda_build.build(["fused_conv3x3", "flash_attention"])
    out_dir = os.path.join(here, "chiprun_out")
    os.makedirs(out_dir, exist_ok=True)
    t0 = time.time()
    launch.spawn(_grid_rank, n, "cuda", args=(out_dir, dims, not gate_only))
    grid_s = time.time() - t0
    ranks = []
    for r in range(n):
        with open(os.path.join(out_dir, f"grid_rank{r}.json")) as f:
            ranks.append(json.load(f))
        log(f"grid {dims} rank {r}: {ranks[-1]}")
    t0 = time.time()
    passes = [] if gate_only else dryrun.dryrun_multichip(n)
    log(f"dryrun_multichip({n}): {len(passes)} passes in {time.time() - t0:.1f} s: {passes}")
    bad = [(r, p) for r, rec in enumerate(ranks) for p in MODEL_AXIS_PATHS + ("ring_attention",)
           if not rec[p]["ok"]] + [(r, "planted_fault") for r, rec in enumerate(ranks)
                                   if not rec["planted_fault"]["caught"]]
    with open(os.path.join(out_dir, f"chip_smoke_grid{n}.json"), "w") as f:
        json.dump(dict(grid=dims, ranks=ranks, grid_s=grid_s, dryrun=passes,
                       card=card_line(), kind=kind), f, indent=1)
    if bad or len(passes) != (0 if gate_only else 8 if n % 2 == 0 else 1):
        raise AssertionError(f"grid {dims}: paths off train_step {bad}, passes {len(passes)}")
    log(f"card: {card_line()}")
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind, "count": torch.cuda.device_count()}}), flush=True)
    return 0


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        log("chip_smoke: no CUDA device is visible; this script runs on the GPU")
        return 2
    here = os.path.dirname(os.path.abspath(__file__))
    if not os.path.isdir(os.path.join(here, "rovr_torch")):
        log("chip_smoke: the rovr_torch package is not beside this script")
        return 2
    sys.path.insert(0, here)
    import numpy as np
    import torch.nn.functional as F

    from rovr_torch import cli, infer
    from rovr_torch.config import Config
    from rovr_torch.data import corruption, dataset, device_synthetic, native_loader, synthetic
    from rovr_torch.models.layers import flax_init_state
    from rovr_torch.models import raft
    from rovr_torch.ops import attention, conv, corr, cuda_build
    from rovr_torch.train import evaluate, imitation, pipeline, pretrain_local, rl
    from rovr_torch.utils import checkpoint, convert, profiling

    t_start = time.time()
    card = card_line()
    kind = torch.cuda.get_device_name(0)
    log(f"device: {kind} x{torch.cuda.device_count()}, torch {torch.__version__}, "
        f"CUDA {torch.version.cuda}; nvidia-smi: {card}")
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    log("TF32 off for cuDNN convs and matmuls (f32 references run in full f32)")

    t0 = time.time()
    logs = cuda_build.build(["fused_conv3x3", "flash_attention", "corr_lookup", "frame_decode"])
    build_s = time.time() - t0
    log(f"build (nvcc for the three CUDA sources, g++ for the frame decoder, all at once): "
        f"{build_s:.1f} s")
    ptxas = {}
    label = {"fused_conv3x3": "K1", "flash_attention": "K2-K4", "corr_lookup": "lookup",
             "frame_decode": "decoder"}
    for name, text in logs.items():
        kernel = None
        for line in text.splitlines():
            if "Compiling entry function" in line:
                kernel = line.split("'")[1] if "'" in line else line.strip()
            if "registers" in line or "spill" in line or "smem" in line:
                ptxas.setdefault(name, []).append(f"{kernel}: {line.strip()}")
                log(f"  ptxas {label[name]} {kernel}: {line.strip()}")
    lib = attention._lib()
    for kid, which in (("K2", 0), ("K3", 1), ("K4", 2)):
        smem = {f"<{dp}, {nwg}>": lib.rovr_flash_tma_smem(which, dp, nwg)
                for dp in (64, 128) for nwg in (1, 2)}
        ptxas[f"{kid}_tma_dynamic_smem"] = {k: v for k, v in smem.items() if v >= 0}
        log(f"  {kid} TMA kernel dynamic shared memory (bytes): "
            f"{ptxas[f'{kid}_tma_dynamic_smem']}")

    phase_s = {}   # host seconds of each phase, for the record

    def timed(fn, *args):
        t = time.time()
        out = fn(*args)
        phase_s[fn.__name__] = time.time() - t
        return out

    k1 = timed(phase_k1, torch, conv, F)
    k1_bwd = timed(phase_k1_backward, torch, conv, F)
    attn = timed(phase_attention, torch, attention, F)
    lookup = timed(phase_corr_lookup, torch, corr, raft)
    out_dir = os.path.join(here, "chiprun_out")
    os.makedirs(out_dir, exist_ok=True)
    # a phase that fails leaves its run's checkpoints (hundreds of MB at
    # config 5); drop them at exit too, so a failed run keeps only its logs
    atexit.register(lambda: [shutil.rmtree(ck, ignore_errors=True) for ck in glob.glob(
        os.path.join(out_dir, "**", "checkpoints"), recursive=True)])

    cfg5 = config5(Config)
    u8_5, (video5, org5), masks5 = config5_clips(torch, np, synthetic, cfg5)
    source = ClipSource(video5, org5, masks5)
    serve = timed(phase_serve_counts, torch, np, conv, attention, Config, rl, infer, synthetic,
                  cfg5, u8_5)
    torch.cuda.empty_cache()
    rl_run5, state_run5 = timed(phase_rl_run5, torch, conv, attention, rl, checkpoint, cfg5,
                                source, out_dir)
    torch.cuda.empty_cache()
    eval5 = timed(phase_eval5, torch, conv, attention, evaluate, rl, cfg5, state_run5, source,
                  out_dir)
    torch.cuda.empty_cache()
    cli_res = timed(phase_cli, torch, conv, attention, cli, checkpoint, here, out_dir)
    torch.cuda.empty_cache()
    source = timed(phase_source, torch, Config, device_synthetic, corruption, synthetic)
    torch.cuda.empty_cache()
    pretrain = timed(phase_pretrain, torch, conv, attention, Config, pretrain_local, checkpoint,
                     out_dir)
    torch.cuda.empty_cache()
    imitate = timed(phase_imitation, torch, conv, attention, Config, imitation, pipeline, out_dir)
    torch.cuda.empty_cache()
    pipe = timed(phase_pipeline, torch, conv, attention, pipeline, pretrain_local, imitation, rl,
                 evaluate, here, out_dir)
    torch.cuda.empty_cache()
    train5_pi1 = timed(phase_train5_pi1, torch, conv, attention, rl, cfg5, video5, org5, masks5)
    torch.cuda.empty_cache()
    rl_run5_pi1 = timed(phase_rl_run5_pi1, torch, conv, attention, rl, checkpoint, cfg5,
                        ClipSource(video5, org5, masks5), here, out_dir, rl_run5)
    del video5, org5, masks5, u8_5, state_run5
    torch.cuda.empty_cache()
    frame_tree, tree = timed(phase_frame_tree, torch, native_loader, dataset, Config, out_dir)
    folder_rl = timed(phase_folder_rl, torch, conv, attention, Config, rl, dataset, profiling,
                      tree, here, out_dir)
    torch.cuda.empty_cache()
    convert_res = timed(phase_convert, torch, cli, convert, rl, evaluate, here, out_dir)
    torch.cuda.empty_cache()
    blocks_moe = timed(phase_blocks_moe, torch, conv, attention, flax_init_state)
    torch.cuda.empty_cache()
    u8_5, (video5, org5), masks5 = config5_clips(torch, np, synthetic, cfg5)
    train5_moe = timed(phase_train5_moe, torch, conv, attention, rl, cfg5, video5, org5)
    torch.cuda.empty_cache()
    s2d = timed(phase_s2d, torch, Config, flax_init_state)
    torch.cuda.empty_cache()
    dp1 = timed(phase_dp1, torch, np, conv, attention, rl, infer, dataset, cfg5, video5, org5,
                masks5, u8_5)
    torch.cuda.empty_cache()
    model_axis = timed(phase_model_axis, torch, conv, attention, rl, cfg5, video5, org5, masks5)
    torch.cuda.empty_cache()
    pipelined5 = timed(phase_pipelined5, torch, conv, attention, rl, profiling, cfg5, video5,
                       org5, out_dir)

    kernels = kernels_line(k1, k1_bwd, attn, lookup)
    record = dict(card=card, kind=kind, torch=torch.__version__, build_s=build_s,
                  ptxas=ptxas, k1=k1, k1_backward=k1_bwd, attention=attn,
                  corr_lookup=lookup, serve=serve, rl_run5=rl_run5, eval5=eval5, cli=cli_res,
                  source=source, pretrain=pretrain, imitation=imitate, pipeline=pipe,
                  train5_pi1=train5_pi1, rl_run5_pi1=rl_run5_pi1, frame_tree=frame_tree,
                  folder_rl=folder_rl, convert=convert_res, blocks_moe=blocks_moe,
                  train5_moe=train5_moe, s2d=s2d, dp1=dp1, model_axis=model_axis,
                  pipelined5=pipelined5,
                  phase_seconds=phase_s,
                  kernels=kernels, seconds=time.time() - t_start)
    with open(os.path.join(out_dir, "chip_smoke.json"), "w") as f:
        json.dump(record, f, indent=1)
    log(f"chip_smoke: all phases passed in {record['seconds']:.1f} s (build {build_s:.1f} s; "
        + ", ".join(f"{k[6:]} {v:.1f}" for k, v in phase_s.items()) + ")")
    log(json.dumps({"kernels": kernels}))
    log(f"card: {card_line()}")
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind, "count": torch.cuda.device_count()}}),
        flush=True)
    return 0


if __name__ == "__main__":
    if len(sys.argv) in (3, 4) and sys.argv[1] == "--grid" and sys.argv[3:] in ([], ["--gate"]):
        sys.exit(main_grid(sys.argv[2], gate_only=sys.argv[3:] == ["--gate"]))
    sys.exit(main())
