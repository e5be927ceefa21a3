#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (rovr_torch) on one NVIDIA GPU (H100).

    python3 chip_smoke.py

Builds every hand-written kernel of the serving path from rovr_torch/csrc
with nvcc, holds each against its plain PyTorch version at the shapes
serving gives it, then drives serving (`rovr_torch.infer.reconstruct_clips`)
at the full width of `Config()` and checks that the main path really went
through the kernels. Phases:

  1. device, card name and power limit; TF32 off for the comparisons;
  2. K1 (fused conv3x3) vs its plain version at the three serving shapes,
     a ragged shape and relu=False; the backward once; CUDA-event times of
     the kernel, the plain version and cuDNN (the library yardstick, used
     nowhere in the port) beside the computed bound;
  3. one full-width UNet call, kernel vs plain;
  4. serving: ResNet-50, UNet 64-512, PolicyNet2 on a 160^2 canvas, 256^2
     frames, S = T = 20, batch 8, random init from a seed, uint8 synthetic
     clips: one warm-up batch, then timed batches; K1 must launch exactly
     60 times per batch;
  5. one more serving batch under torch.profiler: device time by kernel,
     K1's share, the device's idle share (trace in chiprun_out/);
  6. one greedy rollout with the LPIPS reward path at full width (batch 2);
     its metrics must be finite.

Any failure raises (non-zero exit). Prints a {"kernels": [...]} line, the
card's name and power limit, and as the last line
{"ok": true, "device": {...}}. Needs a CUDA device and the rovr_torch package
beside this file; without either it exits non-zero and prints no result.
Writes the full record to chiprun_out/chip_smoke.json.
"""

from __future__ import annotations

import json
import math
import os
import subprocess
import sys
import time

PEAK_BF16_FLOPS = 989e12   # H100 SXM dense bf16 (NVIDIA data sheet)
PEAK_BYTES = 3.35e12       # H100 SXM HBM3
SERVING_SHAPES = {         # name: (B, H, W, Cin, Cout), batch 8 at 256^2
    "conv3": (8, 64, 64, 128, 256),
    "conv4": (8, 32, 32, 256, 512),
    "conv5": (8, 64, 64, 512, 256),
}
RAGGED = (3, 37, 29, 72, 40)   # odd H/W, Cin and Cout off the 32/128 tiles
K1_TOL = 2e-2                  # max|kernel - plain| <= K1_TOL * max|plain|
UNET_TOL = dict(max_abs=1e-2, mean_abs=5e-4)  # K1 vs plain differ by bf16 LSBs
SERVE_BATCHES = 3


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


def conv_bound(b, h, w, cin, cout, peak=PEAK_BF16_FLOPS):
    """Least time (ms) for one conv call: operations over the peak rate,
    or each operand read once and the output written once over HBM."""
    flops = 2.0 * b * h * w * 9 * cin * cout
    nbytes = 2.0 * b * h * w * cin + 2.0 * 9 * cin * cout + 4.0 * cout \
        + 2.0 * b * h * w * cout
    t_ops, t_bytes = flops / peak, nbytes / PEAK_BYTES
    return max(t_ops, t_bytes) * 1e3, ("operations" if t_ops >= t_bytes else "bytes"), flops


def phase_k1(torch, conv, F):
    """K1 against its plain version; times beside the bound."""
    gen = torch.Generator(device="cuda").manual_seed(0)
    rows, max_err = [], 0.0

    def inputs(b, h, w, cin, cout):
        x = torch.randn(b, h, w, cin, device="cuda", generator=gen).bfloat16()
        k = (torch.randn(3, 3, cin, cout, device="cuda", generator=gen)
             / math.sqrt(9 * cin)).bfloat16()
        bias = 0.1 * torch.randn(cout, device="cuda", generator=gen)
        return x, k, bias

    cases = [(n, s, True) for n, s in SERVING_SHAPES.items()]
    cases += [("ragged", RAGGED, True), ("ragged", RAGGED, False),
              ("conv4", SERVING_SHAPES["conv4"], False)]
    for name, shape, relu in cases:
        x, k, bias = inputs(*shape)
        y = conv.fused_conv3x3(x, k, bias, relu).float()
        ref = conv.fused_conv3x3_plain(x.float(), k.float(), bias, relu)
        torch.cuda.synchronize()
        err = (y - ref).abs().max().item()
        scale = ref.abs().max().item()
        ok = err <= K1_TOL * scale
        log(f"K1 {name} {shape} relu={relu}: max|kernel-plain| {err:.4g} "
            f"(limit {K1_TOL * scale:.4g}) {'ok' if ok else 'FAIL'}")
        if not ok:
            raise AssertionError(f"K1 disagrees with its plain version at {name}")
        max_err = max(max_err, err)
        if name not in SERVING_SHAPES or not relu:
            continue
        b, h, w, cin, cout = shape
        x_cl = x.permute(0, 3, 1, 2)  # NCHW view, channels_last memory
        w_cl = k.permute(3, 2, 0, 1).contiguous(memory_format=torch.channels_last)
        b16 = bias.bfloat16()
        ms = cuda_ms(lambda: conv.fused_conv3x3(x, k, bias, True))
        plain_ms = cuda_ms(lambda: conv.fused_conv3x3_plain(x, k, bias, True), iters=5)
        lib_ms = cuda_ms(lambda: F.relu(F.conv2d(x_cl, w_cl, b16, padding=1)))
        bound_ms, bound_by, flops = conv_bound(b, h, w, cin, cout)
        rows.append(dict(call=name, shape=list(shape), ms=ms, plain_ms=plain_ms,
                         library_ms=lib_ms, bound_ms=bound_ms, bound_by=bound_by,
                         tflops=flops / ms / 1e9, max_abs_err=err))
        log(f"K1 {name}: kernel {ms:.4f} ms ({flops / ms / 1e9:.1f} TFLOP/s), "
            f"plain {plain_ms:.4f} ms, cuDNN {lib_ms:.4f} ms, bound {bound_ms:.4f} ms "
            f"({bound_by})")

    # backward: the autograd.Function's gradient is the plain version's
    x, k, bias = inputs(2, 9, 7, 16, 24)
    xs, ks, bs = (t.clone().requires_grad_() for t in (x, k, bias))
    (conv.fused_conv3x3(xs, ks, bs, True).float() ** 2).sum().backward()
    xr, kr, br = (t.clone().requires_grad_() for t in (x, k, bias))
    (conv.fused_conv3x3_plain(xr, kr, br, True).float() ** 2).sum().backward()
    for a, r in ((xs.grad, xr.grad), (ks.grad, kr.grad), (bs.grad, br.grad)):
        err = (a.float() - r.float()).abs().max().item()
        if err > K1_TOL * r.float().abs().max().item():
            raise AssertionError(f"K1 backward disagrees with the plain gradient: {err}")
    log("K1 backward vs plain autograd: ok")
    return rows, max_err


def phase_unet(torch, conv, LocalNetUNet, flax_init_state):
    """One full-width UNet call (batch 8, 256^2), kernel vs plain."""
    gen = torch.Generator(device="cuda").manual_seed(1)
    nets = {impl: LocalNetUNet(dtype=torch.bfloat16, conv_impl=impl).cuda()
            for impl in ("kernel", "plain")}
    params = flax_init_state(nets["kernel"], torch.Generator().manual_seed(2))
    for net in nets.values():
        net.load_state_dict(params)
    tgt = torch.rand(8, 256, 256, 3, device="cuda", generator=gen)
    ctx = torch.rand(8, 2, 256, 256, 3, device="cuda", generator=gen)
    with torch.inference_mode():
        before = conv.fused_conv3x3.launches
        y_k = nets["kernel"](tgt, ctx)
        launches = conv.fused_conv3x3.launches - before
        y_p = nets["plain"](tgt, ctx)
    torch.cuda.synchronize()
    d = (y_k - y_p).abs()
    res = dict(max_abs=d.max().item(), mean_abs=d.mean().item(), launches=launches)
    log(f"UNet full width, kernel vs plain: max|d| {res['max_abs']:.4g} "
        f"mean|d| {res['mean_abs']:.4g} (limits {UNET_TOL}), K1 launches {launches}")
    if not (torch.isfinite(y_k).all() and y_k.shape == (8, 256, 256, 3)):
        raise AssertionError("UNet output not finite or of the wrong shape")
    if res["max_abs"] > UNET_TOL["max_abs"] or res["mean_abs"] > UNET_TOL["mean_abs"]:
        raise AssertionError("UNet through K1 disagrees with the plain UNet")
    if launches != 3:
        raise AssertionError(f"UNet launched K1 {launches} times, expected 3")
    return res


def phase_serving(torch, np, conv, Config, rl, infer, synthetic):
    """Serving at Config() widths, batch 8, S = T = 20."""
    import dataclasses

    c = Config()
    b = 8
    cfg = c.replace(rl=dataclasses.replace(c.rl, batch_size=b, vid_length=20,
                                           time_steps=20))
    s, t_steps = cfg.rl.vid_length, cfg.rl.time_steps
    h, w = cfg.data.frame_size
    t0 = time.time()
    mods = rl.make_modules(cfg, device="cuda")
    state = rl.init_state(cfg, mods, seed=0)
    clips = np.stack([synthetic.synthetic_batch(j, s, h, w)[0] for j in range(b)])
    u8 = np.clip(clips * 255.0 + 0.5, 0, 255).astype(np.uint8)
    log(f"serving set-up (modules, init, clips): {time.time() - t0:.2f} s")

    torch.cuda.reset_peak_memory_stats()
    conv.fused_conv3x3.launches = 0   # counts from here are the main path's
    times, outs = [], []
    stream = infer.reconstruct_clips(cfg, state, mods, [u8] * (1 + SERVE_BATCHES))
    t_prev = time.time()
    for recon, actions in stream:
        now = time.time()
        times.append(now - t_prev)
        outs.append((recon, actions))
        t_prev = time.time()
    launches = conv.fused_conv3x3.launches
    n = len(outs)
    recon, actions = outs[-1]
    if recon.shape != u8.shape or recon.dtype != np.uint8:
        raise AssertionError(f"serving output {recon.shape} {recon.dtype}")
    if actions.shape != (t_steps, b, 2):
        raise AssertionError(f"actions shape {actions.shape}")
    tgt = (np.arange(t_steps) % s)[:, None, None]
    if not ((actions >= 0) & (actions < s) & (actions != tgt)).all():
        raise AssertionError("actions out of [0, S) or equal to the target")
    if np.array_equal(recon, u8):
        raise AssertionError("serving wrote no frame")
    if any(not np.array_equal(o[0], recon) for o in outs):
        raise AssertionError("greedy serving is not deterministic across batches")
    if launches != 60 * n:
        raise AssertionError(f"K1 launched {launches} times over {n} batches, "
                             f"expected {60 * n}")
    sec = sorted(times[1:])
    sec_per_batch = sec[len(sec) // 2]
    res = dict(batch=b, vid_length=s, time_steps=t_steps, frame=[h, w],
               batches=n, k1_launches=launches, k1_launches_per_batch=launches // n,
               warmup_s=times[0], sec_per_batch_each=times[1:],
               sec_per_batch=sec_per_batch,
               frames_per_sec=b * s / sec_per_batch,
               peak_mem_gb=torch.cuda.max_memory_allocated() / 1e9)
    log(f"serving: {res['frames_per_sec']:.1f} frames/s, {sec_per_batch:.4f} s/batch "
        f"(median of {len(sec)}; warm-up {times[0]:.2f} s), K1 launches "
        f"{launches} = 60 x {n}, peak {res['peak_mem_gb']:.2f} GB")
    return res, mods, state, cfg, u8


def phase_profile(torch, infer, cfg, state, mods, u8, out_dir):
    """One serving batch under torch.profiler: device time by kernel, K1's
    share of it, and the device's idle share of the batch's wall time."""
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.time()
        for _ in infer.reconstruct_clips(cfg, state, mods, [u8]):
            pass
        wall_ms = (time.time() - t0) * 1e3
    prof.export_chrome_trace(os.path.join(out_dir, "serving_trace.json"))
    rows = []
    for e in prof.key_averages():
        dev_us = getattr(e, "self_device_time_total", 0)
        if dev_us > 0 and e.device_type == torch.autograd.DeviceType.CUDA:
            rows.append(dict(kernel=e.key[:120], ms=dev_us / 1e3, count=e.count))
    rows.sort(key=lambda r: -r["ms"])
    busy_ms = sum(r["ms"] for r in rows)
    if busy_ms == 0:
        log("profile: the profiler saw no device time (not measured)")
        return dict(wall_ms=wall_ms, device_ms=None)
    k1_ms = sum(r["ms"] for r in rows if "conv3x3_kernel" in r["kernel"])
    res = dict(wall_ms=wall_ms, device_ms=busy_ms, idle_share=1 - busy_ms / wall_ms,
               k1_ms=k1_ms, k1_share=k1_ms / busy_ms, top=rows[:15])
    log(f"profile of one serving batch: wall {wall_ms:.1f} ms, device busy "
        f"{busy_ms:.1f} ms (idle share {res['idle_share']:.3f}), K1 {k1_ms:.2f} ms "
        f"({res['k1_share']:.3f} of device time)")
    for r in rows[:15]:
        log(f"  {r['ms']:9.3f} ms  x{r['count']:<5d} {r['kernel']}")
    return res


def phase_rollout_rewards(torch, np, conv, rl, synthetic, mods, state, cfg):
    """One greedy rollout with the LPIPS reward path, batch 2."""
    import dataclasses

    b = 2
    cfg = cfg.replace(rl=dataclasses.replace(cfg.rl, batch_size=b, greedy=True))
    s = cfg.rl.vid_length
    h, w = cfg.data.frame_size
    data = [synthetic.synthetic_batch(100 + j, s, h, w) for j in range(b)]
    v = torch.from_numpy(np.stack([d[0] for d in data])).cuda()
    o = torch.from_numpy(np.stack([d[1] for d in data])).cuda()
    before = conv.fused_conv3x3.launches
    t0 = time.time()
    out = rl.rollout(state, mods, cfg, v, o, rewards=True)
    torch.cuda.synchronize()
    secs = time.time() - t0
    metrics = {k: float(val) for k, val in out.metrics.items()}
    launches = conv.fused_conv3x3.launches - before
    log(f"rollout with rewards (batch {b}): {secs:.2f} s, K1 launches {launches}, "
        f"metrics {metrics}")
    if not all(math.isfinite(val) for val in metrics.values()):
        raise AssertionError("non-finite Episode metric")
    if not torch.isfinite(out.traj.rtgs).all():
        raise AssertionError("non-finite rewards-to-go")
    return dict(batch=b, seconds=secs, k1_launches=launches, metrics=metrics)


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

    from rovr_torch import infer
    from rovr_torch.config import Config
    from rovr_torch.data import synthetic
    from rovr_torch.models.layers import flax_init_state
    from rovr_torch.models.local_net import LocalNetUNet
    from rovr_torch.ops import conv, cuda_build
    from rovr_torch.train import rl

    t_start = time.time()
    card = card_line()
    kind = torch.cuda.get_device_name(0)
    log(f"device: {kind} x{torch.cuda.device_count()}, torch {torch.__version__}, "
        f"CUDA {torch.version.cuda}; nvidia-smi: {card}")
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    log("TF32 off for cuDNN convs and matmuls (f32 references run in full f32)")

    t0 = time.time()
    logs = cuda_build.build(["fused_conv3x3"])
    log(f"nvcc build: {time.time() - t0:.1f} s")
    for name, text in logs.items():
        for line in text.splitlines():
            if "registers" in line or "spill" in line:
                log(f"  {name}: {line.strip()}")

    rows, k1_err = phase_k1(torch, conv, F)
    unet = phase_unet(torch, conv, LocalNetUNet, flax_init_state)
    serving, mods, state, cfg, u8 = phase_serving(torch, np, conv, Config, rl,
                                                  infer, synthetic)
    out_dir = os.path.join(here, "chiprun_out")
    os.makedirs(out_dir, exist_ok=True)
    profile = phase_profile(torch, infer, cfg, state, mods, u8, out_dir)
    rewards = phase_rollout_rewards(torch, np, conv, rl, synthetic, mods, state, cfg)

    # one row per kernel; its numbers are per UNet call (conv3 + conv4 + conv5)
    total = {k: sum(r[k] for r in rows) for k in ("ms", "plain_ms", "library_ms",
                                                   "bound_ms")}
    kernels = [dict(
        name="fused_conv3x3", route="cuda",
        source="rovr_torch/csrc/fused_conv3x3.cu",
        replaces="rovr_tpu/ops/pallas/conv.py:104",
        launches=serving["k1_launches"], max_abs_err=k1_err,
        ms=total["ms"], plain_ms=total["plain_ms"], bound_ms=total["bound_ms"],
        bound_by="operations" if all(r["bound_by"] == "operations" for r in rows)
        else "bytes",
        library_ms=total["library_ms"],
        per="one UNet call: conv3 + conv4 + conv5 at batch 8, 256^2 frames",
    )]
    record = dict(card=card, kind=kind, torch=torch.__version__, k1=rows,
                  unet=unet, serving=serving, profile=profile,
                  rollout_rewards=rewards, kernels=kernels,
                  seconds=time.time() - t_start)
    with open(os.path.join(out_dir, "chip_smoke.json"), "w") as f:
        json.dump(record, f, indent=1)
    log(json.dumps({"kernels": kernels}))
    log(f"card: {card_line()}")
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind, "count": torch.cuda.device_count()}}),
        flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
