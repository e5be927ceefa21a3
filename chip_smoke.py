#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (rovr_torch) on one NVIDIA GPU (H100).

    python3 chip_smoke.py

Builds every hand-written kernel of the port from rovr_torch/csrc with nvcc
(one process per source, all at once), holds each against its plain
PyTorch version at the shapes its paths give it, then drives serving
(`rovr_torch.infer.reconstruct_clips`) at the full width of `Config()` and
of config 5, and the config-5 RL train step (`rovr_torch.train.rl.
train_step`), and checks that each path really went through the kernels:
every launch count is set to 0 just before a path is driven and read just
after. Phases:

  1. device, card name and power limit; TF32 off for the comparisons;
  2. K1 (fused conv3x3) vs its plain version at the three serving shapes,
     two ragged shapes (odd H/W, Cin = 72 past a 64-channel slice, one at
     W = 32 under the 4 x 32 spatial tile) and relu=False; the backward
     once; CUDA-event times of the kernel, the plain version and cuDNN (the
     library yardstick, used nowhere in the port), and the profiler's
     device time of the kernel and of cuDNN, beside the computed bound,
     with each shape's share of the bound and its ratio to cuDNN under
     both measures;
  3. K2/K3/K4 (flash attention forward, dq, dk/dv) vs their plain twins at
     the rollout shape (8,4,256,64), the PPO shape (512,4,256,64),
     tests/test_attention.py's shapes (padded D, unaligned L, cross 128x200,
     D 128) and 256 heads of L 130: out, lse, dq, dk, dv, and the mma.sync
     forward (by its test hook) on the same inputs; the K2 kernel the
     profiler saw at each shape against `flash_fwd_route`; at the rollout
     and PPO shapes CUDA-event times and the profiler's device time beside
     the bound, the twins, the mma.sync forward and F.scaled_dot_product_attention
     (forward, and forward+backward for K3+K4; a yardstick the port never
     calls), the layout copies the policy makes around K2, and at the
     rollout shape the host's microseconds per forward call;
  4. one full-width UNet call, kernel vs plain;
  5. serving at Config() widths: ResNet-50, UNet 64-512, PolicyNet2 on a
     160^2 canvas, 256^2 frames, S = T = 20, batch 8, random init from a
     seed, uint8 synthetic clips: one warm-up batch, then timed batches; K1
     must launch exactly 60 times per batch;
  6. one more serving batch under torch.profiler: device time by kernel,
     K1's share, the device's idle share (trace in chiprun_out/);
  7. one greedy rollout with the LPIPS reward path at full width (batch 2);
     its metrics must be finite;
  8. config 5's attention policy at full width (hidden 256, 4 heads, depth
     2, 4 patch tokens, 64 frames, batch 8): logits, values and the actor
     loss's gradient through K2-K4 vs the plain attention path;
  9. config-5 serving: batch 8, S = T = 64, greedy; exactly 128 K2 and 192
     K1 launches per batch;
 10. config-5 train steps (batch 8, S = T = 64, 256^2, LPIPS cache from
     stage 1, init chunk 8): a warm-up, then timed steps; each must launch
     exactly 150 K2, 20 K3, 20 K4 and 192 K1, give finite metrics and move
     the actor's and critic's parameters; sec/step, frames/s, peak memory;
 11. one config-5 train step taken in parts (episode init, rollout, PPO),
     host-timed, then one under torch.profiler: device time by kernel and
     the idle share.

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
RAGGED = (3, 37, 29, 72, 40)   # odd H/W, Cin and Cout off the 64/128 tiles
RAGGED32 = (2, 30, 32, 72, 200)  # W = 32 (4 x 32 tile), H off TH, Cout off 256
K1_TOL = 2e-2                  # max|kernel - plain| <= K1_TOL * max|plain|
UNET_TOL = dict(max_abs=1e-2, mean_abs=5e-4)  # K1 vs plain differ by bf16 LSBs
SERVE_BATCHES = 3
ATTN_SHAPES = {                # name: (B, H, Lq, Lk, D)
    "rollout": (8, 4, 256, 256, 64),
    "ppo": (512, 4, 256, 256, 64),
    "L100_D32": (1, 1, 100, 100, 32),
    "L130_D48": (2, 1, 130, 130, 48),
    "cross128x200": (1, 2, 128, 200, 64),
    "D128": (1, 1, 128, 128, 128),
    "wide_L130": (64, 4, 130, 130, 64),  # K2's 128-row items, a warpgroup past Lq
    "L70_D20": (1, 2, 70, 70, 20),   # D % 8 != 0: the mma.sync forward, element-wise copies
}
K2_KERNELS = {"tma": "flash_fwd_tma_kernel", "mma": "flash_fwd_kernel"}  # by route
ATTN_TOL = 2e-2   # bf16 outputs (2^-8) and P, dS rounded to bf16
LSE_TOL = 1e-3    # absolute, f32 LSE
POLICY_TOL = 5e-2  # kernel vs plain attention path through the whole policy
TRAIN_STEPS = 3    # timed config-5 train steps after one warm-up


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


def profiled_ms(torch, fn, kernel: str | None = None, iters: int = 20) -> float:
    """Device time of one call of `fn`, summed over the launches of the
    kernels whose name holds `kernel` (every kernel if None; torch.profiler):
    unlike events around a loop, it does not count the host's pace between
    short launches."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(iters):
            fn()
        torch.cuda.synchronize()
    us = sum(getattr(e, "self_device_time_total", 0) for e in prof.key_averages()
             if kernel is None or kernel in e.key)
    return us / 1e3 / iters


def conv_bound(b, h, w, cin, cout, peak=PEAK_BF16_FLOPS):
    """Least time (ms) for one conv call: operations over the peak rate,
    or each operand read once and the output written once over HBM."""
    flops = 2.0 * b * h * w * 9 * cin * cout
    nbytes = 2.0 * b * h * w * cin + 2.0 * 9 * cin * cout + 4.0 * cout \
        + 2.0 * b * h * w * cout
    t_ops, t_bytes = flops / peak, nbytes / PEAK_BYTES
    return max(t_ops, t_bytes) * 1e3, ("operations" if t_ops >= t_bytes else "bytes"), flops


def attention_cost(b, h, lq, lk, d):
    """(FLOPs, bytes) of each of K2, K3, K4 at one shape. FLOPs: 2 per
    multiply-add of the products (K2 two: S, PV; K3 three: S, dP, dQ; K4
    four: S^T, dP^T, dV, dK). Bytes: every input read once and every output
    written once (bf16 tensors, f32 LSE and delta)."""
    mm = 2.0 * b * h * lq * lk * d
    ql, kl, stat = 2.0 * b * h * lq * d, 2.0 * b * h * lk * d, 4.0 * b * h * lq
    flops = {"fwd": 2 * mm, "dq": 3 * mm, "dkv": 4 * mm}
    nbytes = {
        "fwd": 2 * ql + 2 * kl + stat,          # q, k, v -> o, lse
        "dq": 3 * ql + 2 * kl + 2 * stat,       # q, k, v, dO, lse, delta -> dq
        "dkv": 2 * ql + 4 * kl + 2 * stat,      # q, k, v, dO, lse, delta -> dk, dv
    }
    return flops, nbytes


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
              ("ragged32", RAGGED32, True), ("ragged32", RAGGED32, False),
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
        def kernel():
            return conv.fused_conv3x3(x, k, bias, True)

        def cudnn():
            return F.relu(F.conv2d(x_cl, w_cl, b16, padding=1))

        # events around 20 calls (the host's pace can set them for a short
        # kernel), and the profiler's device time of the same calls
        ms, lib_ms = cuda_ms(kernel), cuda_ms(cudnn)
        dev_ms = profiled_ms(torch, kernel, "conv3x3_kernel")
        lib_dev_ms = profiled_ms(torch, cudnn)
        plain_ms = cuda_ms(lambda: conv.fused_conv3x3_plain(x, k, bias, True), iters=5)
        bound_ms, bound_by, flops = conv_bound(b, h, w, cin, cout)
        rows.append(dict(call=name, shape=list(shape), ms=ms, plain_ms=plain_ms,
                         library_ms=lib_ms, bound_ms=bound_ms, bound_by=bound_by,
                         tflops=flops / ms / 1e9, bound_share=bound_ms / ms,
                         vs_library=ms / lib_ms, device_ms=dev_ms,
                         library_device_ms=lib_dev_ms, device_tflops=flops / dev_ms / 1e9,
                         device_bound_share=bound_ms / dev_ms,
                         device_vs_library=dev_ms / lib_dev_ms, max_abs_err=err))
        log(f"K1 {name}: events: kernel {ms:.4f} ms ({flops / ms / 1e9:.1f} TFLOP/s, "
            f"{bound_ms / ms:.3f} of the bound), cuDNN {lib_ms:.4f} ms (kernel/cuDNN "
            f"{ms / lib_ms:.3f}); device time: kernel {dev_ms:.4f} ms ({bound_ms / dev_ms:.3f} "
            f"of the bound), cuDNN {lib_dev_ms:.4f} ms (kernel/cuDNN "
            f"{dev_ms / lib_dev_ms:.3f}); plain {plain_ms:.4f} ms, bound {bound_ms:.4f} ms "
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


def kernels_run(torch, fn):
    """Names of the device kernels one call of `fn` launches (torch.profiler)."""
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    return [e.key for e in prof.key_averages()
            if getattr(e, "self_device_time_total", 0) > 0]


def host_us(torch, fn, n: int = 1000) -> float:
    """Host time of one call of `fn` (microseconds): the clock over n calls
    with no synchronize between them, then one synchronize."""
    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(n):
        fn()
    t1 = time.perf_counter()
    torch.cuda.synchronize()
    return (t1 - t0) / n * 1e6


def check_k2_route(torch, attention, name, q, k, v):
    """K2 by its wrapper: the kernel the profiler saw must be the one
    `flash_fwd_route` names, and the C entry point must agree with it."""
    d = q.shape[-1]
    route = attention.flash_fwd_route(d)
    if attention._lib().rovr_flash_fwd_route(d) != (route == "tma"):
        raise AssertionError(f"K2 route at {name}: the C entry point disagrees with {route}")
    out = {}
    ran = kernels_run(torch, lambda: out.update(o=attention.flash_attention_fwd(q, k, v)))
    want = K2_KERNELS[route]
    other = K2_KERNELS["mma" if route == "tma" else "tma"]
    if not any(want in n for n in ran) or any(other in n for n in ran):
        raise AssertionError(f"K2 at {name}: route {route}, the profiler saw {ran}")
    log(f"K2 {name}: route {route}, ran {[n for n in ran if 'flash' in n]}")
    return route, out["o"]


def phase_attention(torch, attention, F):
    """K2/K3/K4 against their plain twins at every listed shape, with the K2
    kernel each shape took; at the rollout and PPO shapes times beside the
    bound, the twins, the mma.sync forward, SDPA and the layout copies around K2."""
    gen = torch.Generator(device="cuda").manual_seed(3)
    rows, max_err = {}, {"fwd": 0.0, "dq": 0.0, "dkv": 0.0}
    for name, (b, h, lq, lk, d) in ATTN_SHAPES.items():
        def rnd(length):
            return torch.randn(b, h, length, d, device="cuda", generator=gen).bfloat16()
        q, k, v, do = rnd(lq), rnd(lk), rnd(lk), rnd(lq)
        route, (o, lse) = check_k2_route(torch, attention, name, q, k, v)
        o_p, lse_p = attention.flash_attention_fwd_plain(q, k, v)
        o_m, lse_m = attention.flash_attention_fwd_mma(q, k, v)
        delta = (do.float() * o.float()).sum(-1)
        dq = attention.flash_attention_dq(q, k, v, do, lse, delta)
        dq_p = attention.flash_attention_dq_plain(q, k, v, do, lse, delta)
        dk, dv = attention.flash_attention_dkv(q, k, v, do, lse, delta)
        dk_p, dv_p = attention.flash_attention_dkv_plain(q, k, v, do, lse, delta)
        torch.cuda.synchronize()
        lse_err = (lse - lse_p).abs().max().item()
        errs = {}
        for out, got, ref in (("out", o, o_p), ("dq", dq, dq_p), ("dk", dk, dk_p),
                              ("dv", dv, dv_p), ("out_mma", o_m, o_p)):
            err = (got.float() - ref.float()).abs().max().item()
            scale = ref.float().abs().max().item()
            errs[out] = err
            if not err <= ATTN_TOL * scale:
                raise AssertionError(f"{out} at {name}: max|kernel-plain| {err} > "
                                     f"{ATTN_TOL} * {scale}")
        if not lse_err <= LSE_TOL or not (lse_m - lse_p).abs().max().item() <= LSE_TOL:
            raise AssertionError(f"lse at {name}: {lse_err}")
        max_err["fwd"] = max(max_err["fwd"], errs["out"])
        max_err["dq"] = max(max_err["dq"], errs["dq"])
        max_err["dkv"] = max(max_err["dkv"], errs["dk"], errs["dv"])
        log(f"K2-K4 {name} {(b, h, lq, lk, d)}: max|kernel-plain| out {errs['out']:.4g} "
            f"(mma.sync forward {errs['out_mma']:.4g}) lse {lse_err:.3g} dq {errs['dq']:.4g} "
            f"dk {errs['dk']:.4g} dv {errs['dv']:.4g}: ok")
        row = dict(shape=[b, h, lq, lk, d], route=route, lse_err=lse_err, **errs)
        if name in ("rollout", "ppo"):
            row.update(attention_times(torch, attention, F, name, q, k, v, do, lse, delta))
        rows[name] = row
    return rows, max_err


def attention_times(torch, attention, F, name, q, k, v, do, lse, delta):
    """K2-K4 at one shape: CUDA events around `iters` calls (`ms`, and SDPA's
    `sdpa_ms`) and the profiler's device time of the same calls (`device_ms`,
    `sdpa_device_ms`); the mma.sync forward by its test hook (`fwd_mma`) under
    both; at the rollout shape the host's microseconds per call of either
    forward; and the layout copies the policy makes around K2 (q, k, v from
    (B,L,H,D) to (B,H,L,D), O back), under both."""
    b, h, lq, d = q.shape
    lk = k.shape[2]
    iters = 20 if name == "rollout" else 10
    calls = {
        "fwd": lambda: attention.flash_attention_fwd(q, k, v),
        "fwd_mma": lambda: attention.flash_attention_fwd_mma(q, k, v),
        "dq": lambda: attention.flash_attention_dq(q, k, v, do, lse, delta),
        "dkv": lambda: attention.flash_attention_dkv(q, k, v, do, lse, delta),
    }
    keys = {"fwd": K2_KERNELS["tma"], "fwd_mma": K2_KERNELS["mma"],
            "dq": "flash_dq_kernel", "dkv": "flash_dkv_kernel"}
    res = {"ms": {kn: cuda_ms(fn, iters) for kn, fn in calls.items()},
           "device_ms": {kn: profiled_ms(torch, fn, keys[kn], iters)
                         for kn, fn in calls.items()}}
    res["plain_ms"] = {
        "fwd": cuda_ms(lambda: attention.flash_attention_fwd_plain(q, k, v), 5),
        "dq": cuda_ms(lambda: attention.flash_attention_dq_plain(q, k, v, do, lse, delta), 5),
        "dkv": cuda_ms(lambda: attention.flash_attention_dkv_plain(q, k, v, do, lse, delta),
                       5),
    }
    qg, kg, vg = (t.clone().requires_grad_() for t in (q, k, v))
    sdpa = lambda: F.scaled_dot_product_attention(q, k, v)  # noqa: E731
    sdpa_fb = lambda: torch.autograd.grad(  # noqa: E731
        F.scaled_dot_product_attention(qg, kg, vg), (qg, kg, vg), do)
    ev = {"fwd": cuda_ms(sdpa, iters), "fwd_bwd": cuda_ms(sdpa_fb, iters)}
    dev = {"fwd": profiled_ms(torch, sdpa, None, iters),
           "fwd_bwd": profiled_ms(torch, sdpa_fb, None, iters)}
    res["sdpa_ms"] = dict(ev, bwd=ev["fwd_bwd"] - ev["fwd"])
    res["sdpa_device_ms"] = dict(dev, bwd=dev["fwd_bwd"] - dev["fwd"])
    if name == "rollout":  # at the PPO shape the host waits on a full launch queue
        res["host_us"] = {"fwd": host_us(torch, calls["fwd"]),
                          "fwd_mma": host_us(torch, calls["fwd_mma"])}

    x = torch.randn(b, lq, h, d, device="cuda").bfloat16()   # a projection's output
    o = calls["fwd"]()[0]
    copy_in = lambda: [x.transpose(1, 2).contiguous() for _ in range(3)]  # noqa: E731
    copy_out = lambda: o.transpose(1, 2).reshape(b * lq, h * d)  # noqa: E731
    res["layout_ms"] = {"qkv_in": cuda_ms(copy_in, iters), "o_out": cuda_ms(copy_out, iters)}
    res["layout_device_ms"] = {"qkv_in": profiled_ms(torch, copy_in, None, iters),
                               "o_out": profiled_ms(torch, copy_out, None, iters)}
    res["layout_bytes"] = {"qkv_in": 3 * 2 * 2.0 * b * lq * h * d,
                           "o_out": 2 * 2.0 * b * lq * h * d}

    flops, nbytes = attention_cost(b, h, lq, lk, d)
    res["bound_ms"], res["bound_by"], res["tflops"] = {}, {}, {}
    for kname in ("fwd", "dq", "dkv"):
        t_ops = flops[kname] / PEAK_BF16_FLOPS
        t_bytes = nbytes[kname] / PEAK_BYTES
        res["bound_ms"][kname] = max(t_ops, t_bytes) * 1e3
        res["bound_by"][kname] = "operations" if t_ops >= t_bytes else "bytes"
        res["tflops"][kname] = flops[kname] / res["ms"][kname] / 1e9
    res["flops"], res["bytes"] = flops, nbytes
    bound = res["bound_ms"]["fwd"]
    ms, dv_ms = res["ms"], res["device_ms"]
    log(f"K2-K4 {name} times (ms): " + ", ".join(
        f"{kn} kernel {ms[kn]:.4f} [device {dv_ms[kn]:.4f}] / bound {res['bound_ms'][kn]:.4f} "
        f"({res['bound_by'][kn]}) / plain {res['plain_ms'][kn]:.4f}"
        for kn in ("fwd", "dq", "dkv")))
    log(f"K2 {name}: events {ms['fwd']:.4f} ms ({bound / ms['fwd']:.3f} of the bound, "
        f"{ms['fwd'] / ev['fwd']:.3f}x SDPA {ev['fwd']:.4f}), device {dv_ms['fwd']:.4f} ms "
        f"({bound / dv_ms['fwd']:.3f} of the bound, {dv_ms['fwd'] / dev['fwd']:.3f}x SDPA "
        f"{dev['fwd']:.4f}); mma.sync forward events {ms['fwd_mma']:.4f}, device "
        f"{dv_ms['fwd_mma']:.4f}" + ("; host us per call {fwd:.2f} (mma.sync forward "
                                      "{fwd_mma:.2f})".format(**res["host_us"])
                                      if "host_us" in res else ""))
    log(f"K3+K4 {name}: events {ms['dq'] + ms['dkv']:.4f} ms against SDPA backward "
        f"{res['sdpa_ms']['bwd']:.4f}; device {dv_ms['dq'] + dv_ms['dkv']:.4f} against "
        f"{res['sdpa_device_ms']['bwd']:.4f}")
    log(f"layout copies around K2 at {name} (ms): q, k, v to (B,H,L,D) events "
        f"{res['layout_ms']['qkv_in']:.4f} device {res['layout_device_ms']['qkv_in']:.4f}; "
        f"O back events {res['layout_ms']['o_out']:.4f} device "
        f"{res['layout_device_ms']['o_out']:.4f}")
    return res


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


def phase_serving(torch, np, conv, attention, Config, rl, infer, synthetic):
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
    _zero_counts(conv, attention)   # counts from here are the serving path's
    times, outs = [], []
    stream = infer.reconstruct_clips(cfg, state, mods, [u8] * (1 + SERVE_BATCHES))
    t_prev = time.time()
    for recon, actions in stream:
        now = time.time()
        times.append(now - t_prev)
        outs.append((recon, actions))
        t_prev = time.time()
    counts = _counts(conv, attention)
    launches = counts["K1"]
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
    if counts != {"K1": 60 * n, "K2": 0, "K3": 0, "K4": 0}:
        raise AssertionError(f"serving launched {counts} over {n} batches, "
                             f"expected K1 {60 * n} and no K2-K4")
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
    for fn in (attention.flash_attention_fwd, attention.flash_attention_dq,
               attention.flash_attention_dkv):
        fn.launches = 0


def phase_policy(torch, attention, cfg, flax_init_state):
    """Config 5's attention actor and critic at full width, batch 8: the
    kernel path (K2-K4) against the plain attention path (attn_impl="jnp")
    on the same bf16 params: masked logits, values, and the gradient of a
    PPO-style logprob loss."""
    from rovr_torch.models.policy_attention import AttentionContextPolicy

    m = cfg.model
    kw = dict(num_frames=m.pn2_num_frames, feature_dim=m.feature_dim,
              hidden_dim=m.attn_hidden_dim, num_heads=m.attn_heads,
              depth=m.attn_depth, patch_tokens=m.attn_patch_tokens,
              temperature=m.pn2_temperature, dtype=torch.bfloat16)
    gen = torch.Generator(device="cuda").manual_seed(4)
    res = {}
    for critic in (False, True):
        pols = {impl: AttentionContextPolicy(**kw, attn_impl=impl, is_critic=critic).cuda()
                for impl in ("auto", "jnp")}
        params = flax_init_state(pols["auto"], torch.Generator().manual_seed(5 + critic))
        b, s = 8, m.pn2_num_frames
        feats = torch.randn(b, s, m.feature_dim, device="cuda", generator=gen)
        tgt = torch.arange(b, device="cuda") * 7 % s
        noise = -torch.log(-torch.log(torch.rand(b, s, device="cuda", generator=gen)
                                      .clamp_min(1e-20)))
        acs = torch.stack([(tgt + 1) % s, (tgt + 2) % s], 1)
        outs, grads = {}, {}
        for impl, pol in pols.items():
            pol.load_state_dict(params)
            before = attention.flash_attention_fwd.launches
            if critic:
                y = pol.value(feats, tgt)
                loss = (y ** 2).mean()
            else:
                y = pol.masked_logits(feats, tgt)
                loss = -pol.logprob(feats, tgt, acs, gumbel=noise).mean()
            named = list(pol.named_parameters())
            g = torch.autograd.grad(loss, [p for _, p in named])
            outs[impl] = y.detach().float()
            grads[impl] = torch.cat([x.float().flatten() for x in g])
            if (attention.flash_attention_fwd.launches > before) != (impl == "auto"):
                raise AssertionError(f"policy impl={impl} took the wrong attention path")
        torch.cuda.synchronize()
        err = (outs["auto"] - outs["jnp"]).abs().max().item()
        scale = outs["jnp"].abs().max().item()
        gerr = ((grads["auto"] - grads["jnp"]).norm() / grads["jnp"].norm()).item()
        name = "critic value" if critic else "actor logits"
        log(f"config-5 policy {name}, K2-K4 vs plain attention: max|d| {err:.4g} "
            f"(scale {scale:.4g}), gradient relative error {gerr:.4g} "
            f"(limit {POLICY_TOL})")
        if not (torch.isfinite(outs["auto"]).all() and err <= POLICY_TOL * scale
                and gerr <= POLICY_TOL):
            raise AssertionError(f"config-5 {name} through K2-K4 disagrees with plain")
        res["critic" if critic else "actor"] = dict(max_abs=err, scale=scale,
                                                    grad_rel=gerr)
    return res


def config5_clips(torch, np, synthetic, cfg):
    """uint8 (corrupted, original) clips of config 5, batch 8, on the card."""
    b, s = cfg.rl.batch_size, cfg.rl.vid_length
    h, w = cfg.data.frame_size
    data = [synthetic.synthetic_batch(200 + j, s, h, w) for j in range(b)]
    u8 = [np.clip(np.stack([d[i] for d in data]) * 255.0 + 0.5, 0, 255).astype(np.uint8)
          for i in (0, 1)]
    return u8[0], [torch.from_numpy(x).cuda() for x in u8]


def phase_serving5(torch, np, conv, attention, infer, cfg, state, mods, u8):
    """Config-5 serving: greedy, batch 8, S = T = 64; 128 K2 and 192 K1
    launches per batch."""
    n = 2
    _zero_counts(conv, attention)   # counts from here are this path's
    times, outs = [], []
    t_prev = time.time()
    for recon, actions in infer.reconstruct_clips(cfg, state, mods, [u8] * n):
        times.append(time.time() - t_prev)
        outs.append((recon, actions))
        t_prev = time.time()
    counts = _counts(conv, attention)
    recon, actions = outs[-1]
    b, s = u8.shape[:2]
    if recon.shape != u8.shape or recon.dtype != np.uint8 or actions.shape != (s, b, 2):
        raise AssertionError(f"config-5 serving output {recon.shape} {actions.shape}")
    tgt = (np.arange(s) % s)[:, None, None]
    if not ((actions >= 0) & (actions < s) & (actions != tgt)).all():
        raise AssertionError("config-5 actions out of [0, S) or equal to the target")
    if np.array_equal(recon, u8) or not np.array_equal(outs[0][0], recon):
        raise AssertionError("config-5 serving wrote nothing or is not deterministic")
    want = {"K1": 192 * n, "K2": 128 * n, "K3": 0, "K4": 0}
    if counts != want:
        raise AssertionError(f"config-5 serving launches {counts}, expected {want}")
    res = dict(batches=n, launches=counts, warmup_s=times[0], sec_per_batch=times[-1],
               frames_per_sec=b * s / times[-1])
    log(f"config-5 serving: {res['frames_per_sec']:.1f} frames/s, "
        f"{times[-1]:.4f} s/batch (warm-up {times[0]:.2f} s), launches {counts} "
        f"= (K1 192, K2 128) x {n}")
    return res


def _finite_metrics(metrics):
    out = {k: float(v) for k, v in metrics.items()}
    if not all(math.isfinite(v) for v in out.values()):
        raise AssertionError(f"non-finite train metric: {out}")
    return out


def _moved(new, old):
    return max((new[k].float() - old[k].float()).abs().max().item() for k in old)


def phase_train5(torch, conv, attention, rl, cfg, state, mods, video, org):
    """Config-5 train steps: one warm-up, then TRAIN_STEPS timed steps."""
    per_step = {"K1": 192, "K2": 150, "K3": 20, "K4": 20}
    gen = torch.Generator(device="cuda").manual_seed(7)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    _zero_counts(conv, attention)   # counts from here are the train path's
    times, steps = [], []
    for i in range(1 + TRAIN_STEPS):
        before = _counts(conv, attention)
        t0 = time.time()
        new, metrics, recon = rl.train_step(state, mods, cfg, video, org, generator=gen)
        torch.cuda.synchronize()
        times.append(time.time() - t0)
        after = _counts(conv, attention)
        step_counts = {k: after[k] - before[k] for k in after}
        if step_counts != per_step:
            raise AssertionError(f"train step {i} launched {step_counts}, "
                                 f"expected {per_step}")
        m = _finite_metrics(metrics)
        moved = {f: _moved(getattr(new, f"{f}_params"), getattr(state, f"{f}_params"))
                 for f in ("actor2", "critic2")}
        if not all(v > 0 and math.isfinite(v) for v in moved.values()):
            raise AssertionError(f"train step {i} did not move the params: {moved}")
        if recon.shape != video.shape or not torch.isfinite(recon).all():
            raise AssertionError("train step reconstruction not finite / wrong shape")
        steps.append(dict(seconds=times[-1], metrics=m, moved=moved))
        log(f"config-5 train step {i}: {times[-1]:.3f} s, launches {step_counts}, "
            f"metrics {m}, max|param change| {moved}")
        state = new
    counts = _counts(conv, attention)
    b, s = video.shape[:2]
    sec = sorted(times[1:])[len(times[1:]) // 2]
    res = dict(batch=b, vid_length=s, time_steps=cfg.rl.time_steps, steps=steps,
               launches=counts, launches_per_step=per_step, warmup_s=times[0],
               sec_per_step_each=times[1:], sec_per_step=sec,
               frames_per_sec=b * cfg.rl.time_steps / sec,
               peak_mem_gb=torch.cuda.max_memory_allocated() / 1e9, state_step=state.step)
    log(f"config-5 train: {sec:.4f} s/step (median of {len(times) - 1}; warm-up "
        f"{times[0]:.2f} s), {res['frames_per_sec']:.1f} frames/s, launches {counts} "
        f"over {len(times)} steps, peak {res['peak_mem_gb']:.2f} GB")
    return res, state


def phase_split_train(torch, rl, cfg, state, mods, video, org):
    """Host time of the train step's parts, one step taken piece by piece:
    the episode init alone, the rollout (init included), the PPO update."""
    gen = torch.Generator(device="cuda").manual_seed(9)
    v, o = (x.float() * (1.0 / 255.0) for x in (video, org))
    torch.cuda.synchronize()
    t0 = time.time()
    rl.episode_init(state, mods, cfg, v, o)
    torch.cuda.synchronize()
    t1 = time.time()
    out = rl.rollout(state, mods, cfg, v, o, gen)
    torch.cuda.synchronize()
    t2 = time.time()
    rl.ppo_update(state, mods, cfg, out.traj, gen)
    torch.cuda.synchronize()
    t3 = time.time()
    res = dict(episode_init_s=t1 - t0, rollout_s=t2 - t1, ppo_s=t3 - t2)
    log(f"config-5 train step in parts: episode init {res['episode_init_s']:.3f} s, "
        f"rollout (init included) {res['rollout_s']:.3f} s, PPO update "
        f"{res['ppo_s']:.3f} s")
    return res


def phase_profile_train(torch, rl, cfg, state, mods, video, org):
    """One config-5 train step under torch.profiler: device time by kernel,
    each port kernel's share, the device's idle share of the step. (Its
    chrome trace is too large to keep; the table goes to the record.)"""
    from torch.profiler import ProfilerActivity, profile

    gen = torch.Generator(device="cuda").manual_seed(8)
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.time()
        rl.train_step(state, mods, cfg, video, org, generator=gen)
        torch.cuda.synchronize()
        wall_ms = (time.time() - t0) * 1e3
    rows = []
    for e in prof.key_averages():
        dev_us = getattr(e, "self_device_time_total", 0)
        if dev_us > 0 and e.device_type == torch.autograd.DeviceType.CUDA:
            rows.append(dict(kernel=e.key[:120], ms=dev_us / 1e3, count=e.count))
    rows.sort(key=lambda r: -r["ms"])
    busy_ms = sum(r["ms"] for r in rows)
    if busy_ms == 0:
        log("train profile: the profiler saw no device time (not measured)")
        return dict(wall_ms=wall_ms, device_ms=None)
    k2 = {route: sum(r["count"] for r in rows if key in r["kernel"])
          for route, key in K2_KERNELS.items()}
    if k2["mma"] or not k2["tma"]:  # D = 64: every K2 launch is the TMA kernel
        raise AssertionError(f"K2 launches of the config-5 train step by kernel: {k2}")
    ours = {name: sum(r["ms"] for r in rows if any(key in r["kernel"] for key in keys))
            for name, keys in (("K1", ("conv3x3_kernel",)), ("K2", tuple(K2_KERNELS.values())),
                               ("K3", ("flash_dq_kernel",)), ("K4", ("flash_dkv_kernel",)))}
    res = dict(wall_ms=wall_ms, device_ms=busy_ms, idle_share=1 - busy_ms / wall_ms,
               kernel_ms=ours, k2_launches_by_kernel=k2, top=rows[:25])
    log(f"profile of one config-5 train step: wall {wall_ms:.1f} ms, device busy "
        f"{busy_ms:.1f} ms (idle share {res['idle_share']:.3f}); port kernels (ms) "
        + ", ".join(f"{k} {v:.2f}" for k, v in ours.items()) + f"; K2 launches {k2}")
    for r in rows[:25]:
        log(f"  {r['ms']:9.3f} ms  x{r['count']:<6d} {r['kernel']}")
    return res


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
    from rovr_torch.ops import attention, conv, cuda_build
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
    logs = cuda_build.build(["fused_conv3x3", "flash_attention"])
    build_s = time.time() - t0
    log(f"nvcc build (both sources at once): {build_s:.1f} s")
    ptxas = {}
    label = {"fused_conv3x3": "K1", "flash_attention": "K2-K4"}
    for name, text in logs.items():
        kernel = None
        for line in text.splitlines():
            if "Compiling entry function" in line:
                kernel = line.split("'")[1] if "'" in line else line.strip()
            if "registers" in line or "spill" in line or "smem" in line:
                ptxas.setdefault(name, []).append(f"{kernel}: {line.strip()}")
                log(f"  ptxas {label[name]} {kernel}: {line.strip()}")

    rows, k1_err = phase_k1(torch, conv, F)
    attn, attn_err = phase_attention(torch, attention, F)
    unet = phase_unet(torch, conv, LocalNetUNet, flax_init_state)
    serving, mods, state, cfg, u8 = phase_serving(torch, np, conv, attention, Config,
                                                  rl, infer, synthetic)
    out_dir = os.path.join(here, "chiprun_out")
    os.makedirs(out_dir, exist_ok=True)
    profile = phase_profile(torch, infer, cfg, state, mods, u8, out_dir)
    rewards = phase_rollout_rewards(torch, np, conv, rl, synthetic, mods, state, cfg)
    del mods, state
    torch.cuda.empty_cache()

    cfg5 = config5(Config)
    policy = phase_policy(torch, attention, cfg5, flax_init_state)
    t0 = time.time()
    mods5 = rl.make_modules(cfg5, device="cuda")
    state5 = rl.init_state(cfg5, mods5, seed=0)
    u8_5, (video5, org5) = config5_clips(torch, np, synthetic, cfg5)
    setup5_s = time.time() - t0
    log(f"config-5 set-up (modules, init, 8 x 64 clips): {setup5_s:.2f} s")
    serving5 = phase_serving5(torch, np, conv, attention, infer, cfg5, state5, mods5, u8_5)
    train5, state5 = phase_train5(torch, conv, attention, rl, cfg5, state5, mods5,
                                  video5, org5)
    split5 = phase_split_train(torch, rl, cfg5, state5, mods5, video5, org5)
    profile5 = phase_profile_train(torch, rl, cfg5, state5, mods5, video5, org5)

    # one row per kernel, launches from the config-5 train run (warm-up +
    # timed steps); K1's times are per UNet call (conv3 + conv4 + conv5 at
    # batch 8, 256^2), K2-K4's per call at the PPO shape (512,4,256,64)
    total = {k: sum(r[k] for r in rows) for k in (
        "ms", "device_ms", "plain_ms", "library_ms", "library_device_ms", "bound_ms")}
    ppo = attn["ppo"]
    kernels = [dict(
        name="fused_conv3x3", route="cuda",
        source="rovr_torch/csrc/fused_conv3x3.cu",
        replaces="rovr_tpu/ops/pallas/conv.py:104",
        launches=train5["launches"]["K1"], max_abs_err=k1_err,
        ms=total["ms"], plain_ms=total["plain_ms"], bound_ms=total["bound_ms"],
        bound_by="operations" if all(r["bound_by"] == "operations" for r in rows)
        else "bytes",
        library_ms=total["library_ms"],
        device_ms=total["device_ms"], library_device_ms=total["library_device_ms"],
        per="one UNet call: conv3 + conv4 + conv5 at batch 8, 256^2 frames; ms and "
            "library_ms: CUDA events over 20 calls, as for K2-K4; device_ms and "
            "library_device_ms: the profiler's device time of the same calls; "
            "library: cuDNN conv2d + bias + ReLU",
        design="implicit GEMM: 4-D TMA boxes of the unpadded NHWC input (128-pixel "
               "spatial tile, zero-filled halo) and 3-D boxes of the HWIO weights, "
               "128B swizzle, 4-stage mbarrier ring, wgmma m64n256k16 bf16 -> f32 in "
               "two consumer warpgroups, bias + ReLU on the accumulators",
    )]
    for kid, kname, fn, line, lib_what in (
            ("K2", "flash_attention_fwd", "fwd", 94, "F.scaled_dot_product_attention forward"),
            ("K3", "flash_attention_dq", "dq", 184,
             "SDPA backward (fwd+bwd minus fwd), dq, dk and dv together"),
            ("K4", "flash_attention_dkv", "dkv", 217,
             "SDPA backward (fwd+bwd minus fwd), dq, dk and dv together")):
        lib = "fwd" if fn == "fwd" else "bwd"
        kernels.append(dict(
            name=kname, route="cuda", source="rovr_torch/csrc/flash_attention.cu",
            replaces=f"rovr_tpu/ops/pallas/attention.py:{line}",
            launches=train5["launches"][kid], max_abs_err=attn_err[fn],
            ms=ppo["ms"][fn], plain_ms=ppo["plain_ms"][fn], bound_ms=ppo["bound_ms"][fn],
            bound_by=ppo["bound_by"][fn], library_ms=ppo["sdpa_ms"][lib],
            device_ms=ppo["device_ms"][fn], library_device_ms=ppo["sdpa_device_ms"][lib],
            per="one call at the PPO shape (512,4,256,64) bf16; ms and library_ms: CUDA "
                "events over 10 calls; device_ms and library_device_ms: the profiler's "
                "device time of the same calls; library: " + lib_what,
        ))
    kernels[1].update(
        mma_ms=ppo["ms"]["fwd_mma"], mma_device_ms=ppo["device_ms"]["fwd_mma"],
        design="persistent blocks over (head, 128-query-row) items (64 rows when few "
               "heads); one producer thread keeps TMA loads of Q (two buffers) and of the "
               "head's K/V (3-D maps, 128B swizzle, zero-filled past L and D) in a 4-stage "
               "mbarrier ring; two consumer warpgroups run S = Q K^T and O += P V as wgmma "
               "(P bf16 from registers, V MN-major), online softmax in f32 registers; O "
               "stored by TMA from a swizzled staging tile")
    kernels[1]["per"] += ("; mma_ms and mma_device_ms: the mma.sync forward on the "
                          "same inputs, by its test hook")
    record = dict(card=card, kind=kind, torch=torch.__version__, build_s=build_s,
                  ptxas=ptxas, k1=rows, attention=attn, unet=unet, serving=serving,
                  profile=profile, rollout_rewards=rewards, policy5=policy,
                  setup5_s=setup5_s, serving5=serving5, train5=train5,
                  split_train5=split5, profile_train5=profile5, kernels=kernels,
                  seconds=time.time() - t_start)
    with open(os.path.join(out_dir, "chip_smoke.json"), "w") as f:
        json.dump(record, f, indent=1)
    log(f"chip_smoke: all phases passed in {record['seconds']:.1f} s")
    log(json.dumps({"kernels": kernels}))
    log(f"card: {card_line()}")
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind, "count": torch.cuda.device_count()}}),
        flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
