"""The rest of the attention module (CrossAttentionBlock, DecoderBlock,
ImagePositionalEncoding, ContextPositionalEncoding) and the space-to-depth
canvas conv (CanvasConv3x3(packed=True), PolicyNet2(canvas_impl="s2d"))
against the JAX package at f32 on the CPU.

flax's init is carried into the port by `module_params_from_jax`, with
non-trivial norms and biases added, and the inputs come from a seeded
numpy generator. Tolerances: 1e-4 for the blocks (outputs and input
gradients), as tests/test_torch_attention.py holds the encoder block; the
s2d path 1e-4 against plain and against JAX's s2d, as tests/test_models.py
holds JAX's s2d against its plain path. Cross attention reaches the flash
op (its plain twin on the CPU) with Lq != Lk.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rovr_tpu.models import attention as jatt
from rovr_tpu.models import layers as jlayers
from rovr_tpu.models import policy_net_2 as jpn2
from rovr_torch.models import attention as tatt
from rovr_torch.models import layers as tlayers
from rovr_torch.models.layers import flax_init_state
from rovr_torch.models.policy_net_2 import PolicyNet2
from rovr_torch.utils.convert import module_params_from_jax

TOL = dict(rtol=1e-4, atol=1e-4)


def _perturbed(params, seed):
    rng = np.random.default_rng(seed)
    return jax.tree_util.tree_map(
        lambda a: a + 0.1 * jnp.asarray(rng.standard_normal(a.shape), jnp.float32), params)


def _carry(module, params):
    module.load_state_dict(module_params_from_jax(params), strict=True)
    return module


@pytest.mark.parametrize("lq,lk", [(12, 20), (16, 16), (30, 7)],
                         ids=["Lq12_Lk20", "Lq16_Lk16", "Lq30_Lk7"])
def test_cross_attention_block(lq, lk):
    rng = np.random.default_rng(lq)
    x = rng.standard_normal((2, lq, 32)).astype(np.float32)
    enc = rng.standard_normal((2, lk, 32)).astype(np.float32)
    jm = jatt.CrossAttentionBlock(32, 4, dtype=jnp.float32, attn_impl="jnp")
    params = _perturbed(jm.init(jax.random.PRNGKey(0), jnp.asarray(x), jnp.asarray(enc))
                        ["params"], 1)
    assert set(params) == {"LayerNorm_0", "LayerNorm_1", "MultiHeadAttention_0"}
    f = lambda x, e: jm.apply({"params": params}, x, e)  # noqa: E731
    want = np.asarray(f(jnp.asarray(x), jnp.asarray(enc)))
    gx, ge = jax.grad(lambda x, e: jnp.sum(f(x, e) ** 2), (0, 1))(jnp.asarray(x),
                                                                 jnp.asarray(enc))
    tm = _carry(tatt.CrossAttentionBlock(32, 4, torch.float32), params)
    xt, et = (torch.from_numpy(a).requires_grad_() for a in (x, enc))
    y = tm(xt, et)
    (y ** 2).sum().backward()
    np.testing.assert_allclose(y.detach().numpy(), want, **TOL)
    np.testing.assert_allclose(xt.grad.numpy(), np.asarray(gx), **TOL)
    np.testing.assert_allclose(et.grad.numpy(), np.asarray(ge), **TOL)


def test_decoder_block_with_lq_not_lk():
    """tests/test_attention.py:165-177's shapes, then Lq != Lk."""
    rng = np.random.default_rng(3)
    x = rng.standard_normal((2, 16, 64)).astype(np.float32)
    enc = rng.standard_normal((2, 10, 64)).astype(np.float32)
    jm = jatt.DecoderBlock(64, 4, dtype=jnp.float32, attn_impl="jnp")
    params = _perturbed(jm.init(jax.random.PRNGKey(3), jnp.asarray(x), jnp.asarray(enc))
                        ["params"], 2)
    f = lambda x, e: jm.apply({"params": params}, x, e)  # noqa: E731
    want = np.asarray(f(jnp.asarray(x), jnp.asarray(enc)))
    gx, ge = jax.grad(lambda x, e: jnp.sum(f(x, e) ** 2), (0, 1))(jnp.asarray(x),
                                                                 jnp.asarray(enc))
    tm = _carry(tatt.DecoderBlock(64, 4, torch.float32), params)
    assert set(module_params_from_jax(params)) == set(tm.state_dict())
    xt, et = (torch.from_numpy(a).requires_grad_() for a in (x, enc))
    y = tm(xt, et)
    assert y.shape == x.shape
    (y ** 2).sum().backward()
    np.testing.assert_allclose(y.detach().numpy(), want, **TOL)
    np.testing.assert_allclose(xt.grad.numpy(), np.asarray(gx), **TOL)
    np.testing.assert_allclose(et.grad.numpy(), np.asarray(ge), **TOL)
    # flax's init draws, by the port's rules: lecun kernels, zero biases
    fresh = flax_init_state(tatt.DecoderBlock(64, 4), torch.Generator().manual_seed(0))
    assert float(fresh["CrossAttentionBlock_0.LayerNorm_1.weight"].min()) == 1.0
    assert float(fresh["CrossAttentionBlock_0.MultiHeadAttention_0.q.bias"].abs().max()) == 0.0


def test_image_positional_encoding():
    x = np.random.default_rng(4).standard_normal((2, 9, 12)).astype(np.float32)
    jm = jatt.ImagePositionalEncoding(num_image_patches=3, patch_size=2, num_channels=3)
    params = _perturbed(jm.init(jax.random.PRNGKey(4), jnp.asarray(x))["params"], 3)
    assert params["positional_encoder"]["kernel"].shape == (1, 12)
    want = np.asarray(jm.apply({"params": params}, jnp.asarray(x)))
    tm = _carry(tatt.ImagePositionalEncoding(3, 2, 3), params)
    assert tm.positional_encoder.weight.shape == (12, 1)
    with torch.no_grad():
        got = tm(torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(got, want, **TOL)
    fresh = flax_init_state(tm, torch.Generator().manual_seed(0))
    assert float(fresh["positional_encoder.bias"].abs().max()) == 0.0


def test_context_positional_encoding():
    x = np.random.default_rng(5).standard_normal((2, 3, 4, 8)).astype(np.float32)
    jm = jatt.ContextPositionalEncoding(num_context_patches=2, patch_size=2,
                                        num_channels=2, num_context=3)
    params = _perturbed(jm.init(jax.random.PRNGKey(5), jnp.asarray(x))["params"], 4)
    assert set(params) == {"patch_positional_encoder", "context_positional_encoder"}
    want = np.asarray(jm.apply({"params": params}, jnp.asarray(x)))
    tm = _carry(tatt.ContextPositionalEncoding(2, 2, 2, 3), params)
    with torch.no_grad():
        got = tm(torch.from_numpy(x)).numpy()
    assert got.shape == want.shape == (2, 12, 8)
    np.testing.assert_allclose(got, want, **TOL)


# ---------------------------------------------------------------- s2d canvas


def test_s2d_assembly_equals_jax():
    np.testing.assert_array_equal(tlayers._s2d_conv_assembly(8).numpy(),
                                  np.asarray(jlayers._s2d_conv_assembly(8)))


@pytest.mark.parametrize("bias", [False, True], ids=["folded", "bias"])
def test_packed_conv_against_plain_and_jax(bias):
    rng = np.random.default_rng(6)
    x = rng.standard_normal((2, 32, 48, 1)).astype(np.float32)   # NHWC, JAX's layout
    jm = jlayers.CanvasConv3x3(16, dtype=jnp.float32, fold_bias_into_norm=not bias)
    params = _perturbed(jm.init(jax.random.PRNGKey(6), jnp.asarray(x))["params"], 5)
    want = np.asarray(jm.apply({"params": params}, jnp.asarray(x), packed=True))
    tm = _carry(tlayers.CanvasConv3x3(1, 16, torch.float32, fold_bias_into_norm=not bias),
                params)
    xt = torch.from_numpy(x).permute(0, 3, 1, 2)
    with torch.no_grad():
        packed = tm(xt, packed=True)               # (B, F, 8, 8, H/8, W/8)
        plain = tm(xt)                             # (B, F, H, W)
    assert packed.shape == (2, 16, 8, 8, 4, 6)
    np.testing.assert_allclose(packed.permute(0, 4, 5, 2, 3, 1).numpy(), want, **TOL)
    unpacked = packed.permute(0, 1, 4, 2, 5, 3).reshape(2, 16, 32, 48)
    np.testing.assert_allclose(unpacked.numpy(), plain.numpy(), **TOL)
    with pytest.raises(ValueError, match="divisible"):
        tm(xt[:, :, :30], packed=True)
    with pytest.raises(ValueError, match="1-channel"):
        tlayers.CanvasConv3x3(2, 4)(torch.zeros(1, 2, 8, 8), packed=True)


def test_policy_s2d_equals_plain_and_jax():
    """The port's canvas_impl="s2d" against its plain path on the same
    weights (`_video_conv`, masked logits, value) and against JAX's
    canvas_impl="s2d" (tests/test_models.py:93-105)."""
    rng = np.random.default_rng(7)
    canvas = rng.standard_normal((3, 160, 160, 1)).astype(np.float32)
    feat = rng.standard_normal((3, 1024)).astype(np.float32)
    tgt = np.array([0, 1, 2], np.int32)
    key = jax.random.PRNGKey(7)
    jm = jpn2.PolicyNet2(dtype=jnp.float32, canvas_impl="s2d")
    params = _perturbed(jm.init(key, jnp.asarray(canvas), jnp.asarray(feat),
                                jnp.asarray(tgt), key)["params"], 6)
    want = np.asarray(jm.apply({"params": params}, jnp.asarray(canvas),
                               method=jpn2.PolicyNet2._video_conv))
    want_logits = np.asarray(jm.apply({"params": params}, jnp.asarray(canvas),
                                      jnp.asarray(feat), jnp.asarray(tgt),
                                      method=jpn2.PolicyNet2.masked_logits))
    ported = module_params_from_jax(params)
    pols = {impl: PolicyNet2(dtype=torch.float32, canvas_impl=impl)
            for impl in ("auto", "plain", "s2d")}
    cv, ft = torch.from_numpy(canvas), torch.from_numpy(feat)
    out = {}
    with torch.no_grad():
        for impl, pol in pols.items():
            pol.load_state_dict(ported, strict=True)
            out[impl] = (pol._video_conv(cv),
                         pol.masked_logits(cv, ft, torch.from_numpy(tgt).long()))
    assert torch.equal(out["auto"][0], out["plain"][0])   # "auto" is plain
    for i, w in ((0, want), (1, want_logits)):
        np.testing.assert_allclose(out["s2d"][i].numpy(), out["plain"][i].numpy(), **TOL)
        np.testing.assert_allclose(out["s2d"][i].numpy(), w, **TOL)
    critics = [PolicyNet2(dtype=torch.float32, canvas_impl=impl, is_critic=True)
               for impl in ("plain", "s2d")]
    cstate = flax_init_state(critics[0], torch.Generator().manual_seed(8))
    for c in critics:
        c.load_state_dict(cstate)
    with torch.no_grad():
        vals = [c.value(cv, ft) for c in critics]
    np.testing.assert_allclose(vals[1].numpy(), vals[0].numpy(), **TOL)
    with pytest.raises(ValueError, match="canvas_impl"):
        PolicyNet2(canvas_impl="packed")
