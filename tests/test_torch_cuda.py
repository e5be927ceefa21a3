"""The port's CUDA kernels (K1-K4) against their plain versions on the card,
and the CPU-side rules that choose and guard them.

The `cuda`-marked tests need an NVIDIA GPU and skip without one. This file
imports only numpy, torch, pytest and rovr_torch, so it also runs on a
machine that has neither JAX nor the repo's test conftest:

    python -m pytest -o addopts="" --noconftest -p no:cacheprovider -m cuda tests/test_torch_cuda.py

The unmarked tests (which K2 kernel a head dim gets, and the wrappers'
argument checks) run anywhere. chip_smoke.py makes the same kernel-vs-plain
checks at the main paths' full-size shapes.
"""

import numpy as np
import pytest
import torch

from rovr_torch.ops import attention as tops
from rovr_torch.ops import conv as tconv

ATTN_TOL = 2e-2   # x max|plain|: bf16 outputs (2^-8), P and dS rounded to bf16
LSE_TOL = 1e-3    # absolute, f32 LSE
K1_TOL = 2e-2     # x max|plain|: bf16 output

# name: ((B, H, Lq, Lk, D), the K2 kernel it must launch). The TMA kernel
# takes 64 query rows an item below the SM count's worth of 128-row items
# and 128 above it, so the "wide" shapes reach its two-warpgroup form.
K2_SHAPES = {
    "rollout": ((8, 4, 256, 256, 64), "tma"),          # 32 heads, 128 items of 64 rows
    "L100_D32": ((1, 1, 100, 100, 32), "tma"),         # ragged L, D below a 64-column box
    "L130_D48": ((2, 1, 130, 130, 48), "tma"),
    "Lq130_Lk70": ((3, 2, 130, 70, 64), "tma"),        # cross, one ragged key tile
    "cross128x200": ((1, 2, 128, 200, 64), "tma"),
    "D128": ((1, 1, 128, 128, 128), "tma"),
    "wide_L130": ((64, 4, 130, 130, 64), "tma"),       # a warpgroup's rows all past Lq
    "wide_D128_cross": ((64, 4, 200, 130, 128), "tma"),
    "wide_Lq300_Lk77": ((40, 4, 300, 77, 64), "tma"),
    "L70_D20": ((1, 2, 70, 70, 20), "mma"),            # D % 8 != 0
    "L64_D136": ((1, 1, 64, 64, 136), "mma"),          # D > 128
}
KERNEL_NAME = {"tma": "flash_fwd_tma_kernel", "mma": "flash_fwd_kernel"}


def _qkv(seed, b, h, lq, lk, d):
    rng = np.random.default_rng(seed)
    q = rng.standard_normal((b, h, lq, d)).astype(np.float32)
    k = rng.standard_normal((b, h, lk, d)).astype(np.float32)
    v = rng.standard_normal((b, h, lk, d)).astype(np.float32)
    g = rng.standard_normal((b, h, lq, d)).astype(np.float32)
    return q, k, v, g


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")


def _kernels_run(fn):
    """Names of the device kernels one call of fn launches (torch.profiler)."""
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    return [e.key for e in prof.key_averages()
            if getattr(e, "self_device_time_total", 0) > 0]


def _close(got, ref):
    err = (got.float() - ref.float()).abs().max().item()
    return err <= ATTN_TOL * ref.float().abs().max().item()


# ---------------------------------------------------------------- anywhere


@pytest.mark.parametrize("name", list(K2_SHAPES))
def test_k2_route_by_shape(name):
    (_, _, _, _, d), route = K2_SHAPES[name]
    assert tops.flash_fwd_route(d) == route


@pytest.mark.parametrize("d,route", [
    (8, "tma"), (16, "tma"), (64, "tma"), (120, "tma"), (128, "tma"),
    (1, "mma"), (7, "mma"), (20, "mma"), (68, "mma"), (130, "mma"), (136, "mma"),
    (256, "mma"),
])
def test_k2_route_edges(d, route):
    """TMA needs 16-byte row strides (D % 8 == 0) and its buffers fit up to
    D = 128; every other D of the wrapper's 1..256 takes the mma.sync kernel."""
    assert tops.flash_fwd_route(d) == route


@pytest.mark.parametrize("bad,err,match", [
    (dict(k_len=9, v_len=8), ValueError, "do not fit"),
    (dict(d=0), ValueError, "1 <= D"),
    (dict(d=264), ValueError, "D <="),
    (dict(dtype=torch.float16), TypeError, "bf16"),
    (dict(noncontig=True), ValueError, "contiguous"),
    (dict(three_d=True), ValueError, r"\(B,H,L,D\)"),
    (dict(do_len=7), ValueError, "dO"),
    (dict(lse_dtype=torch.bfloat16), TypeError, "f32 lse"),
])
def test_wrapper_arg_checks_refuse(bad, err, match):
    d = bad.get("d", 16)
    dt = bad.get("dtype", torch.bfloat16)
    q = torch.zeros(1, 2, 8, d, dtype=dt)
    k = torch.zeros(1, 2, bad.get("k_len", 8), d, dtype=dt)
    v = torch.zeros(1, 2, bad.get("v_len", 8), d, dtype=dt)
    if bad.get("noncontig"):
        q = torch.zeros(1, 8, 2, d, dtype=dt).transpose(1, 2)
    if bad.get("three_d"):
        q = q[0]
    extra = ()
    if "do_len" in bad or "lse_dtype" in bad:
        do = torch.zeros(1, 2, bad.get("do_len", 8), d, dtype=dt)
        lse = torch.zeros(1, 2, 8, dtype=bad.get("lse_dtype", torch.float32))
        extra = (do, lse, lse.float())
    with pytest.raises(err, match=match):
        tops.check_kernel_args(q, k, v, *extra)


def test_wrapper_arg_checks_accept_the_paths_shapes():
    for (b, h, lq, lk, d), _ in K2_SHAPES.values():
        q = torch.zeros(b, h, lq, d, dtype=torch.bfloat16)
        kv = torch.zeros(b, h, lk, d, dtype=torch.bfloat16)
        tops.check_kernel_args(q, kv, kv)


def test_mma_hook_refuses_cpu_tensors():
    q = torch.zeros(1, 1, 8, 16, dtype=torch.bfloat16)
    with pytest.raises(ValueError, match="CUDA"):
        tops.flash_attention_fwd_mma(q, q, q)


def test_cpu_forward_runs_the_twin_and_counts_no_launch():
    q, k, v, _ = (torch.from_numpy(a) for a in _qkv(0, 1, 2, 70, 40, 48))
    before = tops.flash_attention_fwd.launches
    o, lse = tops.flash_attention_fwd(q, k, v)
    o_p, lse_p = tops.flash_attention_fwd_plain(q, k, v)
    assert tops.flash_attention_fwd.launches == before
    torch.testing.assert_close(o, o_p, atol=0, rtol=0)
    torch.testing.assert_close(lse, lse_p, atol=0, rtol=0)


# ---------------------------------------------------------------- on the card


@pytest.mark.cuda
@pytest.mark.parametrize("name", list(K2_SHAPES))
def test_k2_matches_plain_on_its_route(cuda, name):
    """K2 against its plain twin, and the kernel the profiler saw against
    the route; the mma.sync kernel (the test hook) against the twin too."""
    (b, h, lq, lk, d), route = K2_SHAPES[name]
    q, k, v, _ = (torch.from_numpy(a).cuda().bfloat16() for a in _qkv(7, b, h, lq, lk, d))
    assert tops._lib().rovr_flash_fwd_route(d) == (route == "tma")
    before = tops.flash_attention_fwd.launches
    out = {}
    ran = _kernels_run(lambda: out.update(kernel=tops.flash_attention_fwd(q, k, v)))
    assert tops.flash_attention_fwd.launches == before + 1
    assert any(KERNEL_NAME[route] in n for n in ran), ran
    other = KERNEL_NAME["mma" if route == "tma" else "tma"]
    assert not any(other in n for n in ran), ran
    o, lse = out["kernel"]
    o_p, lse_p = tops.flash_attention_fwd_plain(q, k, v)
    o_m, lse_m = tops.flash_attention_fwd_mma(q, k, v)
    torch.cuda.synchronize()
    assert tops.flash_attention_fwd.launches == before + 1  # the hook counts none
    for got, got_lse in ((o, lse), (o_m, lse_m)):
        assert torch.isfinite(got.float()).all()
        assert _close(got, o_p)
        assert (got_lse - lse_p).abs().max().item() <= LSE_TOL


@pytest.mark.cuda
def test_cuda_kernels_match_plain(cuda):
    """On the card: K2, K3 and K4 against their plain twins on the same
    bf16 inputs, K3 and K4 fed K2's O and LSE."""
    for shape in [(8, 4, 256, 256, 64), (1, 1, 100, 100, 32), (2, 1, 130, 130, 48),
                  (1, 2, 128, 200, 64), (1, 1, 128, 128, 128), (1, 2, 70, 70, 20),
                  (64, 4, 130, 130, 64)]:
        q, k, v, g = (torch.from_numpy(a).cuda().bfloat16() for a in _qkv(3, *shape))
        o, lse = tops.flash_attention_fwd(q, k, v)
        o_p, lse_p = tops.flash_attention_fwd_plain(q, k, v)
        delta = (g.float() * o.float()).sum(-1)
        dq = tops.flash_attention_dq(q, k, v, g, lse, delta)
        dk, dv = tops.flash_attention_dkv(q, k, v, g, lse, delta)
        dq_p = tops.flash_attention_dq_plain(q, k, v, g, lse, delta)
        dk_p, dv_p = tops.flash_attention_dkv_plain(q, k, v, g, lse, delta)
        torch.cuda.synchronize()
        assert (lse - lse_p).abs().max().item() <= LSE_TOL
        for a, r in ((o, o_p), (dq, dq_p), (dk, dk_p), (dv, dv_p)):
            assert _close(a, r), shape


def _conv_inputs(seed, b, h, w, cin, cout):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((b, h, w, cin)).astype(np.float32)
    k = (rng.standard_normal((3, 3, cin, cout)) * 0.1).astype(np.float32)
    bias = rng.standard_normal(cout).astype(np.float32)
    return x, k, bias


@pytest.mark.cuda
def test_cuda_kernel_matches_plain(cuda):
    """On the card: K1 against the plain version on the same bf16 inputs at
    conv3's and conv4's widths, ragged shapes (Cin = 72, odd H and W, W = 32
    under the 4 x 32 tile) and the backward check's shape."""
    for shape in [(2, 64, 64, 128, 256), (2, 32, 32, 256, 512), (1, 37, 29, 72, 40),
                  (2, 30, 32, 72, 200), (2, 9, 7, 16, 24)]:
        x, k, bias = _conv_inputs(6, *shape)
        xc = torch.from_numpy(x).cuda().bfloat16()
        kc = torch.from_numpy(k).cuda().bfloat16()
        bc = torch.from_numpy(bias).cuda()
        for relu in (True, False):
            y = tconv.fused_conv3x3(xc, kc, bc, relu).float()
            ref = tconv.fused_conv3x3_plain(xc.float(), kc.float(), bc, relu)
            torch.cuda.synchronize()
            assert (y - ref).abs().max().item() <= K1_TOL * ref.abs().max().item()
