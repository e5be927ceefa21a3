"""The port's CUDA kernels (K1-K4, RAFT's correlation lookup) against their
plain versions on the card, and the CPU-side rules that choose and guard
them; the rollout's re-encode replayed from its CUDA graph against the eager
method.

The `cuda`-marked tests need an NVIDIA GPU and skip without one. This file
imports only numpy, torch, pytest and rovr_torch, so it also runs on a
machine that has neither JAX nor the repo's test conftest:

    python -m pytest -o addopts="" --noconftest -p no:cacheprovider -m cuda tests/test_torch_cuda.py

The unmarked tests (which K2, K3 and K4 kernel a head dim gets, and the
wrappers' argument checks) run anywhere. This file is where the kernels are
held against their plain twins on the card, at the main paths' full-size
shapes among others, ragged ones and the routes the profiler saw;
chip_smoke.py holds them again only at the shapes it times.
"""

import numpy as np
import pytest
import torch

from rovr_torch.models import raft as traft
from rovr_torch.ops import attention as tops
from rovr_torch.ops import conv as tconv
from rovr_torch.ops import corr as tcorr

ATTN_TOL = 2e-2   # x max|plain|: bf16 outputs (2^-8), P and dS rounded to bf16
LSE_TOL = 1e-3    # absolute, f32 LSE
K1_TOL = 2e-2     # x max|plain|: bf16 output
# RAFT's lookup kernel against the plain lookup cast to the output dtype:
# f32 within CORR_TOL x max|plain|, bf16 within one bf16 ulp of the plain
# value. The margin is for FMA contraction and summation order only: the
# kernel rounds each product and sum in the plain version's order, so it
# should read 0.
CORR_TOL = 1e-5

# name: (B, H, W) of the coordinates; the levels are H >> l by W >> l.
CORR_SHAPES = {
    "main": (128, 32, 32),     # a chunk of 128 pairs at 256^2: levels 32/16/8/4
    "odd_7x9": (3, 7, 9),      # odd edges crop: levels 7x9, 3x4, 1x2, 0x1
    "empty_2x2": (5, 2, 2),    # levels 2x2, 1x1, 0x0, 0x0
}

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
    "ppo": ((512, 4, 256, 256, 64), "tma"),            # a config-5 PPO epoch's call
    "imitation": ((20, 4, 80, 80, 64), "tma"),         # the pipeline's imitation, 20 x 4 tokens
    "rollout160": ((4, 4, 80, 80, 64), "tma"),         # the pipeline's rollout, batch 4
}
KERNEL_NAME = {"tma": "flash_fwd_tma_kernel", "mma": "flash_fwd_kernel"}

# name: ((B, H, Lq, Lk, D), the K3 and K4 kernels' route). The TMA kernels
# take 128-row items (two warpgroups) when those still cover the SMs and
# D <= 64, else 64-row items; "persistent" has more items than SMs.
BWD_SHAPES = {
    "rollout": ((8, 4, 256, 256, 64), "tma"),          # 32 heads: 64-row items
    "persistent": ((64, 4, 256, 256, 64), "tma"),      # 512 items of 128 rows
    "L100_D32": ((1, 1, 100, 100, 32), "tma"),
    "L130_D48": ((2, 1, 130, 130, 48), "tma"),
    "Lq130_Lk70": ((3, 2, 130, 70, 64), "tma"),        # cross, ragged tiles both ways
    "cross128x200": ((1, 2, 128, 200, 64), "tma"),
    "wide_Lq300_Lk77": ((40, 4, 300, 77, 64), "tma"),
    "D128": ((1, 1, 128, 128, 128), "tma"),
    "wide_D128_cross": ((64, 4, 200, 130, 128), "tma"),
    "wide_L130": ((64, 4, 130, 130, 64), "tma"),       # a warpgroup's rows all past L
    "L70_D20": ((1, 2, 70, 70, 20), "mma"),            # D % 8 != 0
    "L64_D136": ((1, 1, 64, 64, 136), "mma"),          # D > 128
    "ppo": ((512, 4, 256, 256, 64), "tma"),            # a config-5 PPO epoch's call
    "imitation": ((20, 4, 80, 80, 64), "tma"),         # the pipeline's imitation, 20 x 4 tokens
    "rollout160": ((4, 4, 80, 80, 64), "tma"),         # the pipeline's rollout, batch 4
}
BWD_KERNEL_NAME = {
    "dq": {"tma": "flash_dq_tma_kernel", "mma": "flash_dq_kernel"},
    "dkv": {"tma": "flash_dkv_tma_kernel", "mma": "flash_dkv_kernel"},
}


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


CAPTURES = 3  # profiler captures before an empty trace fails


def _kernels_run(fn, wrapper):
    """Names of the device kernels one call of fn launches (torch.profiler).

    The device is synchronized before the profiler starts, so no earlier
    work is in flight when tracing begins. A trace with no kernel at all is
    "not observed" and fn runs again under a new capture, up to CAPTURES
    times; every capture must raise `wrapper.launches` by exactly one, and a
    trace that stays empty fails. The caller checks the route on the first
    trace that shows kernels."""
    from torch.profiler import ProfilerActivity, profile

    for _ in range(CAPTURES):
        torch.cuda.synchronize()
        before = wrapper.launches
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            fn()
            torch.cuda.synchronize()
        assert wrapper.launches == before + 1
        ran = [e.key for e in prof.key_averages()
               if getattr(e, "self_device_time_total", 0) > 0]
        if ran:
            return ran
    raise AssertionError(f"the profiler saw no kernel in {CAPTURES} captures")


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


@pytest.mark.parametrize("name", list(BWD_SHAPES))
def test_bwd_route_by_shape(name):
    (_, _, _, _, d), route = BWD_SHAPES[name]
    assert tops.flash_bwd_route(d) == route


@pytest.mark.parametrize("d,route", [
    (8, "tma"), (16, "tma"), (64, "tma"), (120, "tma"), (128, "tma"),
    (1, "mma"), (7, "mma"), (20, "mma"), (68, "mma"), (130, "mma"), (136, "mma"),
    (256, "mma"),
])
def test_bwd_route_edges(d, route):
    """K3 and K4 take K2's rule: TMA for D % 8 == 0 up to 128, the mma.sync
    kernels for every other D of the wrapper's 1..256."""
    assert tops.flash_bwd_route(d) == route == tops.flash_fwd_route(d)


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


@pytest.mark.parametrize("hook", ["fwd", "dq", "dkv"])
def test_mma_hook_refuses_cpu_tensors(hook):
    q = torch.zeros(1, 1, 8, 16, dtype=torch.bfloat16)
    stats = torch.zeros(1, 1, 8)
    args = (q, q, q) if hook == "fwd" else (q, q, q, q, stats, stats)
    with pytest.raises(ValueError, match="CUDA"):
        getattr(tops, f"flash_attention_{hook}_mma")(*args)


def test_kernels_run_captures_again_on_an_empty_trace(monkeypatch):
    """The route check's capture: an empty trace is not an observation (a
    new capture follows, each one launch), a trace that stays empty fails,
    and the first trace with kernels is returned as it is."""
    import torch.profiler

    class Event:
        def __init__(self, key, us):
            self.key, self.self_device_time_total = key, us

    traces = []

    class FakeProfile:
        def __init__(self, activities):
            pass

        def __enter__(self):
            return self

        def __exit__(self, *exc):
            return False

        def key_averages(self):
            return traces.pop(0)

    class Wrapper:
        launches = 0

    def fn():
        Wrapper.launches += 1

    monkeypatch.setattr(torch.cuda, "synchronize", lambda: None)
    monkeypatch.setattr(torch.profiler, "profile", FakeProfile)
    traces[:] = [[Event("memcpy", 0)], [], [Event("flash_dq_tma_kernel", 5),
                                            Event("elementwise", 0)]]
    assert _kernels_run(fn, Wrapper) == ["flash_dq_tma_kernel"]
    assert Wrapper.launches == 3 and not traces
    traces[:] = [[], [], [], [Event("flash_dq_kernel", 5)]]
    with pytest.raises(AssertionError, match="no kernel in 3 captures"):
        _kernels_run(fn, Wrapper)
    assert Wrapper.launches == 6


def test_cpu_forward_runs_the_twin_and_counts_no_launch():
    q, k, v, _ = (torch.from_numpy(a) for a in _qkv(0, 1, 2, 70, 40, 48))
    before = tops.flash_attention_fwd.launches
    o, lse = tops.flash_attention_fwd(q, k, v)
    o_p, lse_p = tops.flash_attention_fwd_plain(q, k, v)
    assert tops.flash_attention_fwd.launches == before
    torch.testing.assert_close(o, o_p, atol=0, rtol=0)
    torch.testing.assert_close(lse, lse_p, atol=0, rtol=0)


def _corr_inputs(b, h, w, device="cpu", dim=16, seed=0):
    """A pyramid of random features and coordinates inside, on and past
    every edge of each level (fractions, integers, and values just below an
    integer, where cx + dx rounds up to the next one)."""
    gen = torch.Generator(device=device).manual_seed(seed)
    f1, f2 = (torch.randn(b, h, w, dim, device=device, generator=gen) for _ in range(2))
    pyramid = traft.correlation_pyramid(f1, f2)
    gy, gx = torch.meshgrid(torch.arange(h, dtype=torch.float32, device=device),
                            torch.arange(w, dtype=torch.float32, device=device), indexing="ij")
    grid = torch.stack([gx, gy], dim=-1).expand(b, h, w, 2)
    coords = grid + 4.0 * torch.randn(b, h, w, 2, device=device, generator=gen)
    edges = []
    for lvl in range(tcorr.NUM_LEVELS):
        s = 2.0 ** lvl
        for size in (h >> lvl, w >> lvl):
            edges += [s * e for e in (-4.5, -4.0, -3.5, -3.0, -0.5, 0.0, size - 1.0,
                                      size - 0.5, size, size + 3.0, size + 3.5, size + 4.0)]
    below = torch.nextafter(torch.tensor(edges), torch.tensor(-1e9)).tolist()
    values = torch.tensor(edges + below, device=device)
    flat = coords.reshape(-1, 2)[1::2]   # every other position: x and y from the edges
    flat.copy_(values[torch.randint(0, values.numel(), flat.shape, device=device,
                                    generator=gen)])
    coords[0] = grid[0]            # the first iteration's coordinates
    return pyramid, coords.contiguous()


def _within_one_bf16_ulp(got, ref):
    """|got - ref| <= one bf16 ulp at the larger of the two magnitudes."""
    g, r = got.float(), ref.float()
    _, e = torch.frexp(torch.maximum(g.abs(), r.abs()))
    return bool(((g - r).abs() <= torch.ldexp(torch.ones_like(g), e - 8)).all())


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32], ids=["bf16", "f32"])
@pytest.mark.parametrize("name", ["odd_7x9", "empty_2x2"])
def test_corr_lookup_cpu_runs_the_twin_and_counts_no_launch(name, dtype):
    """A CPU call is the plain lookup, permuted and cast, in the kernel's
    layout: (B, 196, H, W) over NHWC memory."""
    pyramid, coords = _corr_inputs(*CORR_SHAPES[name])
    before = tcorr.corr_lookup.launches
    got = tcorr.corr_lookup(pyramid, coords, dtype)
    want = tcorr.lookup_corr(pyramid, coords).permute(0, 3, 1, 2).to(dtype)
    assert tcorr.corr_lookup.launches == before
    assert got.dtype == dtype and got.stride() == want.stride()
    assert got.permute(0, 2, 3, 1).is_contiguous()
    torch.testing.assert_close(got, want, atol=0, rtol=0)


def test_corr_lookup_meta_runs_the_twin_and_counts_no_launch():
    b, h, w = CORR_SHAPES["main"]
    coords = torch.empty(b, h, w, 2, device="meta")
    pyramid = [torch.empty(b, h * w, h >> l, w >> l, device="meta") for l in range(4)]
    before = tcorr.corr_lookup.launches
    out = tcorr.corr_lookup(pyramid, coords, torch.bfloat16)
    assert tcorr.corr_lookup.launches == before
    assert out.device.type == "meta" and out.shape == (b, tcorr.CHANNELS, h, w)
    assert out.dtype == torch.bfloat16


@pytest.mark.parametrize("bad,err,match", [
    ("coords_f64", TypeError, "f32 coords"),
    ("level_bf16", TypeError, "f32 level 2"),
    ("out_f16", TypeError, "bf16 or f32"),
    ("level_noncontig", ValueError, "contiguous level 1"),
    ("coords_noncontig", ValueError, "contiguous coords"),
    ("coords_3", ValueError, r"coords \(B,H,W,2\)"),
    ("coords_3d", ValueError, r"coords \(B,H,W,2\)"),
    ("level_shape", ValueError, "level 3 .* does not fit"),
    ("three_levels", ValueError, "4 levels"),
    ("no_positions", ValueError, r"0 < B\*H\*W"),
    ("requires_grad", ValueError, "forward only"),
])
def test_corr_lookup_arg_checks_refuse(bad, err, match):
    """What a CUDA call checks before any launch, on CPU tensors."""
    b, h, w = 2, 8, 8
    coords = torch.zeros(b, h, w, 2)
    pyramid = [torch.zeros(b, h * w, h >> l, w >> l) for l in range(4)]
    dtype = torch.bfloat16
    if bad == "coords_f64":
        coords = coords.double()
    elif bad == "level_bf16":
        pyramid[2] = pyramid[2].bfloat16()
    elif bad == "out_f16":
        dtype = torch.float16
    elif bad == "level_noncontig":
        pyramid[1] = torch.zeros(b, h * w, w >> 1, h >> 1).transpose(2, 3)
    elif bad == "coords_noncontig":
        coords = torch.zeros(b, w, h, 2).transpose(1, 2)
    elif bad == "coords_3":
        coords = torch.zeros(b, h, w, 3)
    elif bad == "coords_3d":
        coords = coords[0]
    elif bad == "level_shape":
        pyramid[3] = torch.zeros(b, h * w, 2, 2)
    elif bad == "three_levels":
        pyramid = pyramid[:3]
    elif bad == "no_positions":
        coords = torch.zeros(0, h, w, 2)
        pyramid = [p[:0] for p in pyramid]
    elif bad == "requires_grad":
        pyramid[0].requires_grad_()
    with pytest.raises(err, match=match):
        tcorr.check_kernel_args(pyramid, coords, dtype)


@pytest.mark.parametrize("name", list(CORR_SHAPES))
def test_corr_lookup_arg_checks_accept_the_shapes(name):
    b, h, w = CORR_SHAPES[name]
    coords = torch.empty(b, h, w, 2, device="meta")
    pyramid = [torch.empty(b, h * w, h >> l, w >> l, device="meta") for l in range(4)]
    for dtype in tcorr.OUT_DTYPES:
        tcorr.check_kernel_args(pyramid, coords, dtype)


# ---------------------------------------------------------------- on the card


@pytest.mark.cuda
@pytest.mark.parametrize("name", list(K2_SHAPES))
def test_k2_matches_plain_on_its_route(cuda, name):
    """K2 against its plain twin, and the kernel the profiler saw against
    the route; the mma.sync kernel (the test hook) against the twin too."""
    (b, h, lq, lk, d), route = K2_SHAPES[name]
    q, k, v, _ = (torch.from_numpy(a).cuda().bfloat16() for a in _qkv(7, b, h, lq, lk, d))
    assert tops._lib().rovr_flash_fwd_route(d) == (route == "tma")
    out = {}
    ran = _kernels_run(lambda: out.update(kernel=tops.flash_attention_fwd(q, k, v)),
                       tops.flash_attention_fwd)
    before = tops.flash_attention_fwd.launches
    assert any(KERNEL_NAME[route] in n for n in ran), ran
    other = KERNEL_NAME["mma" if route == "tma" else "tma"]
    assert not any(other in n for n in ran), ran
    o, lse = out["kernel"]
    o_p, lse_p = tops.flash_attention_fwd_plain(q, k, v)
    o_m, lse_m = tops.flash_attention_fwd_mma(q, k, v)
    torch.cuda.synchronize()
    assert tops.flash_attention_fwd.launches == before  # the hook counts none
    for got, got_lse in ((o, lse), (o_m, lse_m)):
        assert torch.isfinite(got.float()).all()
        assert _close(got, o_p)
        assert (got_lse - lse_p).abs().max().item() <= LSE_TOL


@pytest.mark.cuda
@pytest.mark.parametrize("kernel", ["dq", "dkv"])
@pytest.mark.parametrize("name", list(BWD_SHAPES))
def test_bwd_matches_plain_on_its_route(cuda, name, kernel):
    """K3 or K4 against its plain twin, fed K2's O and LSE: the kernel the
    profiler saw is the one the route names and the other route's did not
    run, the launch count rose by one per capture, and the mma.sync kernel (its test
    hook, which counts nothing) is within the tolerance of the twin too."""
    (b, h, lq, lk, d), route = BWD_SHAPES[name]
    q, k, v, g = (torch.from_numpy(a).cuda().bfloat16() for a in _qkv(11, b, h, lq, lk, d))
    assert tops._lib().rovr_flash_bwd_route(d) == (route == "tma")
    o, lse = tops.flash_attention_fwd(q, k, v)
    delta = (g.float() * o.float()).sum(-1)
    wrapper = getattr(tops, f"flash_attention_{kernel}")
    out = {}
    ran = _kernels_run(lambda: out.update(kernel=wrapper(q, k, v, g, lse, delta)), wrapper)
    before = wrapper.launches
    names = BWD_KERNEL_NAME[kernel]
    assert any(names[route] in n for n in ran), ran
    other = names["mma" if route == "tma" else "tma"]
    assert not any(other in n for n in ran), ran
    hook = getattr(tops, f"flash_attention_{kernel}_mma")(q, k, v, g, lse, delta)
    plain = getattr(tops, f"flash_attention_{kernel}_plain")(q, k, v, g, lse, delta)
    torch.cuda.synchronize()
    assert wrapper.launches == before  # the hook counts none
    got = out["kernel"]
    if kernel == "dq":
        got, hook, plain = (got,), (hook,), (plain,)
    for a, m, r in zip(got, hook, plain):
        assert torch.isfinite(a.float()).all()
        assert _close(a, r)
        assert _close(m, r)


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
    conv3's, conv4's and conv5's widths, the pipeline rollout's 40^2 map,
    ragged shapes (Cin = 72, odd H and W, W = 32 under the 4 x 32 tile) and
    the backward check's shape."""
    for shape in [(2, 64, 64, 128, 256), (2, 32, 32, 256, 512), (2, 64, 64, 512, 256),
                  (4, 40, 40, 128, 256), (1, 37, 29, 72, 40), (2, 30, 32, 72, 200),
                  (2, 9, 7, 16, 24)]:
        x, k, bias = _conv_inputs(6, *shape)
        xc = torch.from_numpy(x).cuda().bfloat16()
        kc = torch.from_numpy(k).cuda().bfloat16()
        bc = torch.from_numpy(bias).cuda()
        for relu in (True, False):
            y = tconv.fused_conv3x3(xc, kc, bc, relu).float()
            ref = tconv.fused_conv3x3_plain(xc.float(), kc.float(), bc, relu)
            torch.cuda.synchronize()
            assert (y - ref).abs().max().item() <= K1_TOL * ref.abs().max().item()


# (B, H, W, Cin, Cout) of conv3, conv4 and conv5 under the pretrain step
# (batch 24, 256^2 frames) and at the pipeline's 160^2 frames (40^2 and 20^2
# maps, ragged under K1's 4 x 32 spatial tile)
PRETRAIN_SHAPES = [(24, 64, 64, 128, 256), (24, 32, 32, 256, 512), (24, 64, 64, 512, 256),
                   (24, 40, 40, 128, 256), (24, 20, 20, 256, 512), (24, 40, 40, 512, 256)]


@pytest.mark.cuda
@pytest.mark.parametrize("shape", PRETRAIN_SHAPES)
def test_cuda_k1_backward_at_pretrain_shapes(cuda, shape):
    """On the card: K1's forward and its cuDNN backward in bf16 (gx, gk, gb)
    against the backward's f32 plain twin on the same inputs (the same saved
    output, so the same ReLU mask: K1's bf16 output and an f32 forward can
    round a pre-activation near zero to opposite signs)."""
    x, k, bias = _conv_inputs(7, *shape)
    g = np.random.default_rng(8).standard_normal(shape[:3] + (shape[4],)).astype(np.float32)
    xc, kc = (torch.from_numpy(a).cuda().bfloat16().requires_grad_() for a in (x, k))
    bc = torch.from_numpy(bias).cuda().requires_grad_()
    gc = torch.from_numpy(g).cuda().bfloat16()
    before = tconv.fused_conv3x3.backward_calls, tconv.fused_conv3x3.launches
    tconv.fused_conv3x3(xc, kc, bc, True).backward(gc)
    assert (tconv.fused_conv3x3.backward_calls, tconv.fused_conv3x3.launches) == (
        before[0] + 1, before[1] + 1)
    y = tconv.fused_conv3x3(xc.detach(), kc.detach(), bc.detach(), True)
    refs = tconv.fused_conv3x3_backward_plain(xc, kc, y, gc, True)
    torch.cuda.synchronize()
    for got, ref in zip((xc.grad, kc.grad, bc.grad), refs):
        assert got.dtype == (torch.float32 if got is bc.grad else torch.bfloat16)
        assert torch.isfinite(got.float()).all()
        err = (got.float() - ref).abs().max().item()
        assert err <= K1_TOL * ref.abs().max().item(), (shape, err)


@pytest.mark.cuda
def test_policy1_act_on_the_card(cuda):
    """pi1 (PolicyNet1 at config 5's widths: channels 32-256, a 256^2 canvas,
    a 64-way head) in bf16 on the card, batch 8: finite logits, targets in
    [0, 64), and the exact-mode logprob equal to log_softmax of the same
    standardized logits at the chosen target."""
    from rovr_torch.models.layers import flax_init_state, standardize
    from rovr_torch.models.policy_net_1 import PolicyNet1

    pol = PolicyNet1(num_frames=64, valid_frames=64, exact_logprob=True,
                     canvas_size=256).cuda()
    pol.load_state_dict(flax_init_state(pol, torch.Generator().manual_seed(0)))
    gen = torch.Generator(device="cuda").manual_seed(1)
    canvas = torch.randn(8, 256, 256, 1, device="cuda", generator=gen).bfloat16()
    token = torch.randn(8, 256, 256, 1, device="cuda", generator=gen)
    with torch.no_grad():
        logits = pol.logits(canvas, token)
        action, logprob = pol.act(canvas, token, generator=gen)
    torch.cuda.synchronize()
    assert logits.shape == (8, 64) and torch.isfinite(logits).all()
    assert ((action >= 0) & (action < 64)).all()
    want = torch.log_softmax(standardize(logits, 1, eps=0.1), 1).gather(1, action[:, None])
    assert (logprob - want[:, 0]).abs().max().item() <= 1e-4


class _Items:
    """Item i: a float32 clip and a uint8 clip made from seed i, after a
    sleep that lets the queues fill while the consumer is busy."""

    def __init__(self, n, shape=(25, 64, 64, 3)):
        self.n, self.shape = n, shape

    def __len__(self):
        return self.n

    def __getitem__(self, i):
        rng = np.random.default_rng(i)
        return (rng.uniform(size=self.shape).astype(np.float32),
                rng.integers(0, 256, self.shape, dtype=np.uint8))


@pytest.mark.cuda
def test_prefetcher_staging_is_bitwise_and_stream_safe(cuda, tmp_path):
    """Items staged by the pinned side-stream copy equal their host arrays
    bit for bit while the consumer's stream is busy with other kernels, and
    the frame decoder builds (g++) on the card's machine."""
    from rovr_torch.data import dataset, native_loader
    from rovr_torch.utils.png import png_bytes

    ds = _Items(24)
    p = dataset.DevicePrefetcher(ds, num_workers=4, depth=4, device="cuda")
    busy = torch.randn(2048, 2048, device="cuda")
    try:
        for i, (clip, u8) in enumerate(p):
            for _ in range(4):     # keep the consumer's stream behind the copies
                busy = torch.tanh(busy @ busy)
            assert clip.is_cuda and u8.dtype == torch.uint8
            want_f, want_u = ds[i]
            assert torch.equal(clip.cpu(), torch.from_numpy(want_f))
            assert torch.equal(u8.cpu(), torch.from_numpy(want_u))
            del clip, u8      # freed on the consumer's stream (record_stream)
    finally:
        p.close()
    assert i == len(ds) - 1 and torch.isfinite(busy).all()
    img = np.random.default_rng(0).integers(0, 256, (32, 48, 3), dtype=np.uint8)
    path = tmp_path / "frame.png"
    path.write_bytes(png_bytes(img))
    np.testing.assert_array_equal(native_loader.decode_png(str(path)), img)


@pytest.mark.cuda
@pytest.mark.parametrize("factor", [1.25, 0.3], ids=["cap1.25", "drops"])
def test_moe_index_dispatch_on_the_card(cuda, factor):
    """The MoE FFN at config 5's width (d 256, 4 experts) on a rollout
    step's 2,048 tokens in bf16: the index dispatch against the one-hot
    einsum twin, forward and input gradient, within bf16 rounding (2^-8 of
    the largest value); with factor 0.3 tokens are dropped and their rows
    are exactly 0 in both."""
    from rovr_torch.models.layers import flax_init_state
    from rovr_torch.models.moe import MoEFeedForward

    m = MoEFeedForward(256, 4, factor).cuda()
    m.load_state_dict(flax_init_state(m, torch.Generator().manual_seed(0)))
    twin = MoEFeedForward(256, 4, factor, dispatch="onehot").cuda()
    twin.load_state_dict(m.state_dict())
    gen = torch.Generator(device="cuda").manual_seed(1)
    x = torch.randn(8, 256, 256, device="cuda", generator=gen).bfloat16()
    xi, xo = x.clone().requires_grad_(), x.clone().requires_grad_()
    yi, yo = m(xi), twin(xo)
    (yi.float() ** 2).sum().backward()
    (yo.float() ** 2).sum().backward()
    torch.cuda.synchronize()
    assert yi.dtype == torch.bfloat16 and torch.isfinite(yi.float()).all()
    for got, ref in ((yi, yo), (xi.grad, xo.grad)):
        err = (got.float() - ref.float()).abs().max().item()
        assert err <= 2 ** -8 * ref.float().abs().max().item(), err
    dropped = (yo.float() == 0).all(-1)
    assert torch.equal((yi.float() == 0).all(-1), dropped)
    assert bool(dropped.any()) == (factor < 1.0)


@pytest.mark.cuda
def test_sharded_step_world_size_one_over_nccl(cuda):
    """`make_sharded_train_step` over a NCCL group of one against
    `train_step` at config 5's widths (batch 2, 8 frames), same state and
    noise: the collectives run (counted) and change nothing beyond f32
    rounding. Metrics within 1e-3 relative (+1e-4); the updated actor and
    critic within 2*lr*n_updates everywhere (Adam turns the sign of a
    near-zero gradient into a +-lr step) and within 1e-5 on 99% of entries;
    the reconstructions within one uint8 step."""
    import dataclasses

    import torch.distributed as dist

    from rovr_torch.config import config_rl_scaled
    from rovr_torch.parallel import collectives, launch
    from rovr_torch.parallel.mesh import make_mesh
    from rovr_torch.train import rl

    c = config_rl_scaled(vid_length=8, data_parallel=1)
    cfg = c.replace(rl=dataclasses.replace(c.rl, batch_size=2, n_updates_per_ppo=2))
    mods = rl.make_modules(cfg, device="cuda")
    state = rl.init_state(cfg, mods, seed=0)
    gen = torch.Generator(device="cuda").manual_seed(2)
    h, w = cfg.data.frame_size
    video, org = (torch.rand(2, 8, h, w, 3, device="cuda", generator=gen) for _ in range(2))
    t = cfg.rl.time_steps
    noise = (rl.gumbel_noise((t, 2, 8), gen, "cuda"),
             rl.gumbel_noise((cfg.rl.n_updates_per_ppo, 2 * t, 8), gen, "cuda"))
    want = rl.train_step(state, mods, cfg, video, org, gumbel=noise)
    dist.init_process_group("nccl", init_method=f"tcp://127.0.0.1:{launch.free_port()}",
                            world_size=1, rank=0)
    try:
        mesh = make_mesh(cfg.mesh)
        before = collectives.CALLS["all_reduce"]
        got = rl.make_sharded_train_step(mesh, mods, cfg)(state, video, org, gumbel=noise)
        torch.cuda.synchronize()
        assert collectives.CALLS["all_reduce"] - before > 0
    finally:
        dist.destroy_process_group()
    assert set(got[1]) == set(want[1])
    for k, v in want[1].items():
        np.testing.assert_allclose(float(got[1][k]), float(v), rtol=1e-3, atol=1e-4,
                                   err_msg=k)
    bound = 2 * cfg.rl.actor_lr * cfg.rl.n_updates_per_ppo
    for field in ("actor2_params", "critic2_params"):
        a, b = getattr(got[0], field), getattr(want[0], field)
        diff = torch.cat([(a[k] - b[k]).abs().flatten() for k in b])
        assert float(diff.max()) <= bound, field
        assert float((diff <= 1e-5).float().mean()) >= 0.99, field
    assert (got[2].float() - want[2].float()).abs().max().item() <= 1 / 255


@pytest.mark.cuda
def test_pipelined_step_on_the_card(cuda):
    """`train_step_pipelined` at config 5's widths (batch 2, 8 frames) on
    the card: the next batch's init on a stream of its own, the step on one
    of higher priority, the step equal to `train_step` bit for bit (the streams change no arithmetic),
    `next_init` equal to `episode_init`, and a uint8 clip refused."""
    import dataclasses

    from rovr_torch.config import config_rl_scaled
    from rovr_torch.train import rl

    c = config_rl_scaled(vid_length=8, data_parallel=1)
    cfg = c.replace(rl=dataclasses.replace(c.rl, batch_size=2, n_updates_per_ppo=2))
    mods = rl.make_modules(cfg, device="cuda")
    state = rl.init_state(cfg, mods, seed=0)
    gen = torch.Generator(device="cuda").manual_seed(2)
    h, w = cfg.data.frame_size
    v0, o0, v1, o1 = (torch.rand(2, 8, h, w, 3, device="cuda", generator=gen)
                      for _ in range(4))
    want = rl.train_step(state, mods, cfg, v0, o0,
                         generator=torch.Generator(device="cuda").manual_seed(3))
    want_next = rl.episode_init(state, mods, cfg, v1, o1)
    init = rl.episode_init(state, mods, cfg, v0, o0)
    got = rl.train_step_pipelined(state, mods, cfg, init, v0, o0, v1, o1,
                                  generator=torch.Generator(device="cuda").manual_seed(3))
    torch.cuda.synchronize()
    own, side = rl._pipeline_streams(torch.device("cuda", torch.cuda.current_device()))
    assert len({own, side, torch.cuda.current_stream()}) == 3
    assert own.priority < side.priority      # the step's kernels go first
    assert set(got[1]) == set(want[1])
    for k, v in want[1].items():
        assert torch.equal(got[1][k], v), k
    assert torch.equal(got[2], want[2])
    for field in ("actor2_params", "critic2_params"):
        a, b = getattr(got[0], field), getattr(want[0], field)
        assert all(torch.equal(a[k], b[k]) for k in b), field
    for name in ("curr_loss", "canvas", "feats"):
        assert torch.equal(getattr(got[3], name), getattr(want_next, name)), name
    assert all(torch.equal(a, b) for a, b in zip(got[3].org_taps, want_next.org_taps))
    with pytest.raises(TypeError, match="train_step"):
        rl.train_step_pipelined(state, mods, cfg, init, (v0 * 255).to(torch.uint8), o0,
                                v1, o1)


def _frames(gen, b, size):
    """(B, H, W, 3) frames laid out as the UNet hands them back (an NHWC
    view of NCHW memory)."""
    return torch.rand(b, 3, size, size, device="cuda", generator=gen).permute(0, 2, 3, 1)


@pytest.mark.cuda
@pytest.mark.parametrize("mode", ["no_grad", "inference_mode"])
@pytest.mark.parametrize("canvas,per_row", [(256, 8), (160, 5)], ids=["config5", "Config"])
def test_reencode_graph_matches_eager(cuda, canvas, per_row, mode):
    """The rollout's re-encode (ResNet-50 over B = 8 frames of 256^2, bf16,
    D = 1024) replayed from its CUDA graph equals the eager method bit for
    bit over 3 steps that feed the canvas back; a returned canvas stays as
    it was after the next replay; weights bound anew (as `rl.bind` binds
    them) are captured anew, not replayed stale; no K1 launch is in it."""
    from rovr_torch.models.layers import flax_init_state
    from rovr_torch.models.video_processor import VideoProcessor

    vp = VideoProcessor(canvas_size=canvas, tile=32, tiles_per_row=per_row,
                        feature_dim=1024).cuda()
    w_a = flax_init_state(vp, torch.Generator().manual_seed(0))
    gen = torch.Generator(device="cuda").manual_seed(2)
    # the BatchNorms' statistics off their construction values, and a second set
    w_a = {k: v * (0.5 + torch.rand(v.shape, device="cuda", generator=gen))
           if k.endswith(("running_var", "weight")) else v for k, v in w_a.items()}
    w_b = {k: v * (1 + 0.1 * torch.rand(v.shape, device="cuda", generator=gen))
           for k, v in w_a.items()}

    def bind(w):
        vp.load_state_dict(w, strict=True, assign=True)
        vp.requires_grad_(False)

    b, steps = 8, 3
    frames = [_frames(gen, b, 256) for _ in range(steps + 1)]
    idx = [torch.randint(0, per_row * per_row, (b,), device="cuda", generator=gen)
           for _ in range(steps + 1)]
    canvas0 = torch.rand(b, canvas, canvas, 1, device="cuda", generator=gen)
    counts = VideoProcessor.insert_encoded_frame_batch
    ctx = torch.no_grad if mode == "no_grad" else torch.inference_mode
    bind(w_a)
    k1 = tconv.fused_conv3x3.launches
    before = counts.captures, counts.replays, counts.eager
    with ctx():
        got, kept, c = [], [], canvas0
        for t in range(steps):
            c, f = vp.insert_encoded_frame_batch(idx[t], frames[t], c)
            got.append((c, f))
            kept.append((c.clone(), f.clone()))
        want, c = [], canvas0
        for t in range(steps):
            c, f = vp._insert_eager(idx[t], frames[t], c)
            want.append((c, f))
    torch.cuda.synchronize()
    assert (counts.captures - before[0], counts.replays - before[1],
            counts.eager - before[2]) == (1, steps - 1, 0)
    for t in range(steps):
        for g, k, w in zip(got[t], kept[t], want[t]):
            assert torch.equal(g, k), f"step {t}'s output changed by a later replay"
            assert torch.equal(g, w), f"step {t}: graph and eager differ"

    bind(w_b)
    with ctx():
        c_b, f_b = vp.insert_encoded_frame_batch(idx[steps], frames[steps], got[-1][0])
        c_e, f_e = vp._insert_eager(idx[steps], frames[steps], got[-1][0])
        bind(w_a)
        _, f_a = vp._insert_eager(idx[steps], frames[steps], got[-1][0])
    torch.cuda.synchronize()
    assert counts.captures - before[0] == 2 and counts.eager == before[2]
    assert torch.equal(c_b, c_e) and torch.equal(f_b, f_e)
    assert not torch.equal(f_b, f_a)
    assert tconv.fused_conv3x3.launches == k1


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32], ids=["bf16", "f32"])
@pytest.mark.parametrize("name", list(CORR_SHAPES))
def test_corr_lookup_matches_plain_on_the_card(cuda, name, dtype):
    """RAFT's lookup kernel against the plain lookup on the card, cast to
    the output dtype, with its strides; one launch a call."""
    pyramid, coords = _corr_inputs(*CORR_SHAPES[name], device="cuda",
                                   dim=128 if name == "main" else 16)
    before = tcorr.corr_lookup.launches
    got = tcorr.corr_lookup(pyramid, coords, dtype)
    assert tcorr.corr_lookup.launches == before + 1
    want = tcorr.lookup_corr(pyramid, coords).permute(0, 3, 1, 2).to(dtype)
    torch.cuda.synchronize()
    assert got.dtype == dtype and got.shape == want.shape and got.stride() == want.stride()
    assert want.float().abs().min().item() == 0.0     # some taps fell outside
    if dtype == torch.float32:
        err = (got - want).abs().max().item()
        assert err <= CORR_TOL * want.abs().max().item(), err
    else:
        assert _within_one_bf16_ulp(got, want)


@pytest.mark.cuda
def test_pairwise_flows_launches_the_lookup_iters_times_calls(cuda, monkeypatch):
    """RAFT on the card: `corr_lookup.launches` grows by iters x the RAFT
    calls `pairwise_flows` makes, and the plain lookup never runs."""
    plain = []
    monkeypatch.setattr(tcorr, "lookup_corr",
                        lambda *a: plain.append(a) or pytest.fail("plain lookup on the card"))
    m = traft.RAFTSmall(iters=3).cuda().requires_grad_(False)
    gen = torch.Generator(device="cuda").manual_seed(0)
    video = torch.rand(2, 4, 64, 64, 3, device="cuda", generator=gen)   # 6 pairs
    before = (tcorr.corr_lookup.launches, traft.pairwise_flows.calls)
    with torch.no_grad():
        flows = traft.pairwise_flows(m, video, size=64, chunk=4)
    torch.cuda.synchronize()
    calls = traft.pairwise_flows.calls - before[1]
    assert calls == 2 and not plain
    assert tcorr.corr_lookup.launches - before[0] == m.iters * calls
    assert flows.shape == (2, 3, 64, 64, 2) and bool(torch.isfinite(flows).all())
