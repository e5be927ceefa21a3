"""Module-by-module parity of the PyTorch port (rovr_torch/models) with the
JAX package (rovr_tpu/models), at f32 on the CPU.

Inputs come from numpy seeds; weights are flax's own init, carried into the
port by `rovr_torch.utils.convert.module_params_from_jax`, so each test also
pins the layout conversion. Tolerances: 2e-5/1e-4 for the UNet, 1e-4/1e-3
for the deep trunks (ResNet-50, LPIPS), 1e-4 elsewhere — f32 sums taken in
another order by another library.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rovr_tpu.models import layers as jl
from rovr_tpu.models import local_net as jln
from rovr_tpu.models import policy_net_2 as jpn2
from rovr_tpu.models import resnet as jrn
from rovr_tpu.models import vgg_lpips as jvl
from rovr_tpu.models import video_processor as jvp
from rovr_torch.models import layers as tl
from rovr_torch.models import local_net as tln
from rovr_torch.models import policy_net_2 as tpn2
from rovr_torch.models import resnet as trn
from rovr_torch.models import vgg_lpips as tvl
from rovr_torch.models import video_processor as tvp
from rovr_torch.ops.rewards import rewards_to_go
from rovr_torch.utils.convert import module_params_from_jax

JF = jnp.float32
TF = torch.float32


def _rand(seed, *shape, low=None, high=None):
    rng = np.random.default_rng(seed)
    if low is not None:
        return rng.uniform(low, high, shape).astype(np.float32)
    return rng.standard_normal(shape).astype(np.float32)


def _carry(module, jax_params):
    module.load_state_dict(module_params_from_jax(jax_params), strict=True)
    return module.eval()


def _nchw(a):
    return torch.from_numpy(a).permute(0, 3, 1, 2)


def _nhwc(t):
    return t.detach().permute(0, 2, 3, 1).numpy()


# ---------------------------------------------------------------- layers


@pytest.mark.parametrize("per_sample", [False, True])
def test_batch_stat_norm(per_sample):
    x = _rand(0, 4, 5, 6, 8) * 3 + 1
    jm = jl.BatchStatNorm(per_sample=per_sample)
    params = {"scale": _rand(1, 8), "bias": _rand(2, 8)}
    want = np.asarray(jm.apply({"params": params}, jnp.asarray(x)))
    tm = _carry(tl.BatchStatNorm(8, per_sample=per_sample), params)
    with torch.no_grad():
        got = _nhwc(tm(_nchw(x)))
    np.testing.assert_allclose(got, want, atol=1e-4, rtol=1e-4)


@pytest.mark.parametrize("h,w,window,strides,padding", [
    (8, 8, (2, 2), None, None),
    (9, 7, (2, 2), None, None),                       # VALID trims the odd edge
    (9, 9, (3, 3), (2, 2), ((1, 1), (1, 1))),         # ResNet stem, -inf pad
    (5, 5, (2, 2), (2, 1), None),                     # policy trunk 2x2/s(2,1)
    (16, 16, (8, 8), None, None),
    (1, 2, (2, 2), (2, 2), None),                     # window > input: empty
])
def test_max_pool(h, w, window, strides, padding):
    x = _rand(3, 2, h, w, 4) - 2.0  # negative values: -inf padding matters
    want = np.asarray(jl.max_pool(jnp.asarray(x), window, strides, padding))
    got = _nhwc(tl.max_pool(_nchw(x), window, strides, padding))
    assert got.shape == want.shape
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("axis,eps", [(0, 0.001), (1, 0.1)])
def test_standardize(axis, eps):
    x = _rand(4, 6, 20) * 2 + 0.5
    x[:, 3] = 1.5  # a constant column
    want = np.asarray(jl.standardize(jnp.asarray(x), axis=axis, eps=eps))
    got = tl.standardize(torch.from_numpy(x), dim=axis, eps=eps).numpy()
    np.testing.assert_allclose(got, want, atol=1e-4, rtol=1e-4)


def test_rewards_to_go():
    from rovr_tpu.ops.rewards import rewards_to_go as jrtg

    r = _rand(5, 7, 3)
    for gamma in (1.0, 0.9):
        np.testing.assert_allclose(
            rewards_to_go(torch.from_numpy(r), gamma).numpy(),
            np.asarray(jrtg(jnp.asarray(r), gamma)), atol=1e-5, rtol=1e-5)


# ---------------------------------------------------------------- UNet


def test_local_net_unet():
    ch = (8, 16, 32, 64)
    tgt = _rand(6, 2, 32, 32, 3, low=0, high=1)
    ctx = _rand(7, 2, 2, 32, 32, 3, low=0, high=1)
    jm = jln.LocalNetUNet(channels=ch, dtype=JF)
    params = jm.init(jax.random.PRNGKey(0), jnp.asarray(tgt), jnp.asarray(ctx))["params"]
    # nonzero biases so the bias paths (incl. the upconvs') are exercised
    params = jax.tree_util.tree_map_with_path(
        lambda p, v: v + 0.05 if p[-1].key == "bias" else v, params)
    want = np.asarray(jm.apply({"params": params}, jnp.asarray(tgt), jnp.asarray(ctx)))
    tm = _carry(tln.LocalNetUNet(channels=ch, dtype=TF), params)
    with torch.no_grad():
        got = tm(torch.from_numpy(tgt), torch.from_numpy(ctx)).numpy()
    assert got.shape == (2, 32, 32, 3)
    np.testing.assert_allclose(got, want, atol=2e-5, rtol=1e-4)


def test_local_net_plain_impl_matches_auto_on_cpu():
    ch = (8, 16, 32, 64)
    auto = tln.LocalNetUNet(channels=ch, dtype=TF)
    plain = tln.LocalNetUNet(channels=ch, dtype=TF, conv_impl="plain")
    plain.load_state_dict(auto.state_dict())
    tgt = torch.from_numpy(_rand(8, 1, 16, 16, 3, low=0, high=1))
    ctx = torch.from_numpy(_rand(9, 1, 2, 16, 16, 3, low=0, high=1))
    with torch.no_grad():
        torch.testing.assert_close(auto(tgt, ctx), plain(tgt, ctx), atol=0, rtol=0)


# ---------------------------------------------------------------- backbones


def _perturb_frozen_bn(params, seed):
    rng = np.random.default_rng(seed)

    def f(path, v):
        name = path[-1].key
        if name == "mean":
            return rng.uniform(-0.5, 0.5, v.shape).astype(np.float32)
        if name == "var":
            return rng.uniform(0.5, 2.0, v.shape).astype(np.float32)
        if name in ("scale", "bias"):
            return rng.uniform(0.5, 1.5, v.shape).astype(np.float32)
        return v
    return jax.tree_util.tree_map_with_path(f, params)


def test_resnet50():
    x = _rand(10, 2, 32, 32, 3, low=0, high=1)
    jm = jrn.ResNet50(dtype=JF)
    params = jm.init(jax.random.PRNGKey(1), jnp.asarray(x))["params"]
    params = _perturb_frozen_bn(params, 11)
    want = np.asarray(jm.apply({"params": params}, jnp.asarray(x)))
    tm = _carry(trn.ResNet50(dtype=TF), params)
    with torch.no_grad():
        got = tm(torch.from_numpy(x)).numpy()
    assert got.shape == (2, 2048)
    np.testing.assert_allclose(got, want, atol=1e-4, rtol=1e-3)


@pytest.mark.parametrize("g", [1, 2])
def test_tiny_backbone(g):
    x = _rand(12, 3, 64, 64, 3, low=0, high=1)
    jm = jrn.TinyBackbone(dtype=JF, spatial_pool=g)
    params = jm.init(jax.random.PRNGKey(2), jnp.asarray(x))["params"]
    want = np.asarray(jm.apply({"params": params}, jnp.asarray(x)))
    tm = _carry(trn.TinyBackbone(dtype=TF, spatial_pool=g), params)
    with torch.no_grad():
        got = tm(torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(got, want, atol=1e-4, rtol=1e-3)


def test_pool_spatial_unequal_bins():
    x = _rand(13, 2, 7, 7, 5)
    want = np.asarray(jrn._pool_spatial(jnp.asarray(x), 3))
    got = trn._pool_spatial(_nchw(x), 3).numpy()
    np.testing.assert_allclose(got, want, atol=1e-6, rtol=1e-6)


# ---------------------------------------------------------------- VideoProcessor


@pytest.mark.parametrize("size", [256, 160, 224])  # shrink, grow, identity
def test_resize_bilinear(size):
    x = _rand(14, 2, size, size, 3, low=0, high=1)
    want = np.asarray(jax.image.resize(jnp.asarray(x), (2, 224, 224, 3), "bilinear"))
    got = tvp.resize_bilinear(torch.from_numpy(x), (224, 224)).numpy()
    np.testing.assert_allclose(got, want, atol=1e-5, rtol=1e-5)


VP_KW = dict(canvas_size=96, tile=32, tiles_per_row=3, feature_dim=64,
             backbone_name="tiny")


@pytest.fixture(scope="module")
def vp_pair():
    frames = _rand(15, 2, 5, 224, 224, 3, low=0, high=1)
    jm = jvp.VideoProcessor(dtype=JF, **VP_KW)
    params = jm.init(jax.random.PRNGKey(3), jnp.asarray(frames))["params"]
    params = jax.tree_util.tree_map_with_path(
        lambda p, v: v + 0.01 if p[-1].key == "bias" else v, params)
    tm = _carry(tvp.VideoProcessor(dtype=TF, **VP_KW), params)
    return jm, params, tm, frames


def test_video_processor_canvas(vp_pair):
    jm, params, tm, frames = vp_pair
    canvas_j, feats_j = jm.apply({"params": params}, jnp.asarray(frames))
    with torch.no_grad():
        canvas_t, feats_t = tm(torch.from_numpy(frames))
    assert canvas_t.shape == (2, 96, 96, 1) and feats_t.shape == (2, 5, 64)
    np.testing.assert_allclose(canvas_t.numpy(), np.asarray(canvas_j), atol=1e-4, rtol=1e-4)
    np.testing.assert_allclose(feats_t.numpy(), np.asarray(feats_j), atol=1e-4, rtol=1e-4)


@pytest.mark.parametrize("size,grad", [  # resize down and up to 224
    pytest.param(256, False, id="256"), pytest.param(160, False, id="160"),
    pytest.param(256, True, id="256-grad")])
def test_insert_encoded_frame_batch(vp_pair, size, grad):
    """On the CPU, and with grad enabled (heads trained through it), the
    call runs eagerly: `eager` counts it, no graph is captured or replayed."""
    jm, params, tm, _ = vp_pair
    frames = _rand(16, 2, size, size, 3, low=0, high=1)
    canvas = _rand(17, 2, 96, 96, 1)
    idx = np.array([4, 1], np.int32)
    cj, fj = jm.apply({"params": params}, jnp.asarray(idx), jnp.asarray(frames),
                      jnp.asarray(canvas),
                      method=jvp.VideoProcessor.insert_encoded_frame_batch)
    counts = tvp.VideoProcessor.insert_encoded_frame_batch
    before = counts.captures, counts.replays, counts.eager
    with torch.set_grad_enabled(grad):
        ct, ft = tm.insert_encoded_frame_batch(
            torch.from_numpy(idx).long(), torch.from_numpy(frames),
            torch.from_numpy(canvas))
    assert (counts.captures, counts.replays, counts.eager) == (
        before[0], before[1], before[2] + 1)
    assert ft.requires_grad == grad and not tm._graphs
    ct, ft = ct.detach(), ft.detach()
    np.testing.assert_allclose(ct.numpy(), np.asarray(cj), atol=1e-4, rtol=1e-4)
    np.testing.assert_allclose(ft.numpy(), np.asarray(fj), atol=1e-4, rtol=1e-4)
    assert not np.array_equal(ct.numpy(), canvas)


# ---------------------------------------------------------------- PolicyNet2


PN2_KW = dict(num_frames=6, fc_dims=(256, 64))


@pytest.fixture(scope="module")
def pn2_pair():
    b = 4
    canvas = _rand(18, b, 160, 160, 1, low=0, high=1)
    feat = _rand(19, b, 1024)
    tgt = np.array([0, 3, 5, 2], np.int32)
    jm = jpn2.PolicyNet2(dtype=JF, **PN2_KW)
    params = jm.init(jax.random.PRNGKey(4), jnp.asarray(canvas), jnp.asarray(feat),
                     jnp.asarray(tgt), jax.random.PRNGKey(5))["params"]
    tm = _carry(tpn2.PolicyNet2(dtype=TF, **PN2_KW), params)
    return jm, params, tm, (canvas, feat, tgt)


def _jin(inputs):
    return [jnp.asarray(a) for a in inputs]


def _tin(inputs):
    canvas, feat, tgt = inputs
    return torch.from_numpy(canvas), torch.from_numpy(feat), torch.from_numpy(tgt).long()


def test_policy_masked_logits(pn2_pair):
    jm, params, tm, inputs = pn2_pair
    want = np.asarray(jm.apply({"params": params}, *_jin(inputs),
                               method=jpn2.PolicyNet2.masked_logits))
    with torch.no_grad():
        got = tm.masked_logits(*_tin(inputs)).numpy()
    np.testing.assert_allclose(got, want, atol=1e-4, rtol=1e-4)


@pytest.mark.parametrize("greedy", [True, False])
def test_policy_act(pn2_pair, greedy):
    jm, params, tm, inputs = pn2_pair
    key = jax.random.PRNGKey(6)
    acs_j, lp_j = jm.apply({"params": params}, *_jin(inputs), key, greedy,
                           method=jpn2.PolicyNet2.act)
    # replay the JAX package's Gumbel draw (gumbel_log_softmax's own key use)
    noise = torch.from_numpy(np.array(
        jax.random.gumbel(key, (4, PN2_KW["num_frames"]), jnp.float32)))
    with torch.no_grad():
        acs_t, lp_t = tm.act(*_tin(inputs), greedy=greedy, gumbel=noise)
    np.testing.assert_array_equal(acs_t.numpy(), np.asarray(acs_j))
    np.testing.assert_allclose(lp_t.numpy(), np.asarray(lp_j), atol=1e-4, rtol=1e-4)


def test_policy_logprob_and_value(pn2_pair):
    jm, params, tm, inputs = pn2_pair
    canvas, feat, tgt = inputs
    action = np.array([[1, 2], [0, 4], [3, 1], [5, 0]], np.int32)
    key = jax.random.PRNGKey(7)
    lp_j = jm.apply({"params": params}, *_jin(inputs), jnp.asarray(action), key,
                    method=jpn2.PolicyNet2.logprob)
    noise = torch.from_numpy(np.array(jax.random.gumbel(key, (4, 6), jnp.float32)))
    with torch.no_grad():
        lp_t = tm.logprob(*_tin(inputs), torch.from_numpy(action), gumbel=noise)
    np.testing.assert_allclose(lp_t.numpy(), np.asarray(lp_j), atol=1e-4, rtol=1e-4)

    jc = jpn2.PolicyNet2(dtype=JF, is_critic=True, **PN2_KW)
    cparams = jc.init(jax.random.PRNGKey(8), jnp.asarray(canvas), jnp.asarray(feat),
                      method=jpn2.PolicyNet2.value)["params"]
    v_j = jc.apply({"params": cparams}, jnp.asarray(canvas), jnp.asarray(feat),
                   method=jpn2.PolicyNet2.value)
    tc = _carry(tpn2.PolicyNet2(dtype=TF, is_critic=True, **PN2_KW), cparams)
    with torch.no_grad():
        v_t = tc.value(torch.from_numpy(canvas), torch.from_numpy(feat))
    np.testing.assert_allclose(v_t.numpy(), np.asarray(v_j), atol=1e-4, rtol=1e-4)


# ---------------------------------------------------------------- LPIPS


@pytest.mark.parametrize("stages,size", [
    (((8, 1), (16, 1)), 32),
    (((8, 2), (8, 2), (16, 3), (16, 3), (16, 3)), 32),  # VGG16's 5-stage plan, narrow
])
def test_lpips(stages, size):
    x = _rand(20, 2, size, size, 3, low=0, high=1)
    y = _rand(21, 2, size, size, 3, low=0, high=1)
    jm = jvl.LPIPS(dtype=JF, stages=stages)
    params = jm.init(jax.random.PRNGKey(9), jnp.asarray(x), jnp.asarray(y))["params"]
    want = np.asarray(jm.apply({"params": params}, jnp.asarray(x), jnp.asarray(y)))
    taps_j = jm.apply({"params": params}, jnp.asarray(x), method=jvl.LPIPS.taps)
    tm = _carry(tvl.LPIPS(dtype=TF, stages=stages), params)
    with torch.no_grad():
        got = tm(torch.from_numpy(x), torch.from_numpy(y)).numpy()
        taps_t = tm.taps(torch.from_numpy(x))
    np.testing.assert_allclose(got, want, atol=1e-4, rtol=1e-3)
    for a, b in zip(taps_t, taps_j):
        np.testing.assert_allclose(_nhwc(a), np.asarray(b), atol=1e-4, rtol=1e-3)


def test_lpips_taps_limit_is_exact_prefix():
    stages = ((8, 2), (8, 2), (16, 3))
    tm = tvl.LPIPS(dtype=TF, stages=stages)
    x = torch.from_numpy(_rand(22, 2, 32, 32, 3, low=0, high=1))
    with torch.no_grad():
        full = tm.taps(x)
        for k in (1, 2):
            part = tm.taps(x, limit=k)
            assert len(part) == k
            for a, b in zip(part, full):
                torch.testing.assert_close(a, b, atol=0, rtol=0)
