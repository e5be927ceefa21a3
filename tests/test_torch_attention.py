"""K2-K4 (rovr_torch/ops/attention.py), the transformer blocks and the
attention context policy against the JAX package, at f32 on the CPU.

On the CPU the wrappers run their plain twins. Each twin is held against
the Pallas kernel it replaces, run in interpret mode: `_flash_forward`
(out 2e-5, lse 1e-5) and `_flash_backward` (1e-4), and the autograd
Function's gradients against `jax.grad` of `flash_attention(interpret=True)`
(1e-4), at test_attention.py's shapes: padded D, unaligned L, cross
128x200. Modules carry flax's own init by `module_params_from_jax`; their
outputs agree within 1e-4 (f32 sums in another order), with the JAX Gumbel
draws replayed into the policy. The CUDA kernels are held against the twins
on the card by the `cuda`-marked tests in tests/test_torch_cuda.py and by
chip_smoke.py.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rovr_tpu.models import attention as jatt
from rovr_tpu.models import policy_attention as jpa
from rovr_tpu.ops.pallas import attention as pattn
from rovr_torch.models import attention as tatt
from rovr_torch.models import policy_attention as tpa
from rovr_torch.models.layers import flax_init_state
from rovr_torch.ops import attention as tops
from rovr_torch.utils.convert import module_params_from_jax

SHAPES = [  # (B, H, Lq, Lk, D)
    (1, 1, 100, 100, 32),    # unaligned L: key masking
    (2, 1, 130, 130, 48),    # both unaligned, D off the tile
    (1, 2, 128, 200, 64),    # cross-attention lengths
    (1, 1, 128, 128, 128),
    (1, 2, 256, 256, 64),    # config 5's head dim
]
IDS = ["L100_D32", "L130_D48", "cross128x200", "D128", "L256_D64"]


def _qkv(seed, b, h, lq, lk, d):
    rng = np.random.default_rng(seed)
    q = rng.standard_normal((b, h, lq, d)).astype(np.float32)
    k = rng.standard_normal((b, h, lk, d)).astype(np.float32)
    v = rng.standard_normal((b, h, lk, d)).astype(np.float32)
    g = rng.standard_normal((b, h, lq, d)).astype(np.float32)
    return q, k, v, g


def _t(*arrays):
    return [torch.from_numpy(a) for a in arrays]


# ---------------------------------------------------------------- kernels


@pytest.mark.parametrize("shape", SHAPES, ids=IDS)
def test_fwd_plain_matches_pallas_interpret(shape):
    b, h, lq, lk, d = shape
    q, k, v, _ = _qkv(0, *shape)
    out_j, lse_j = pattn._flash_forward(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                                        128, 128, interpret=True)
    out_t, lse_t = tops.flash_attention_fwd_plain(*_t(q, k, v))
    np.testing.assert_allclose(out_t.numpy(), np.asarray(out_j), atol=2e-5, rtol=0)
    np.testing.assert_allclose(lse_t.reshape(b * h, lq).numpy(),
                               np.asarray(lse_j)[:, :lq, 0], atol=1e-5, rtol=0)


@pytest.mark.parametrize("shape", SHAPES, ids=IDS)
def test_backward_plain_matches_pallas_interpret(shape):
    q, k, v, g = _qkv(1, *shape)
    qj, kj, vj, gj = map(jnp.asarray, (q, k, v, g))
    out_j, lse_j = pattn._flash_forward(qj, kj, vj, 64, 64, interpret=True)
    dq_j, dk_j, dv_j = pattn._flash_backward((qj, kj, vj, out_j, lse_j), gj, 64, 64,
                                             interpret=True)
    qt, kt, vt, gt = _t(q, k, v, g)
    out_t, lse_t = tops.flash_attention_fwd_plain(qt, kt, vt)
    delta = (gt * out_t).sum(-1)
    dq_t = tops.flash_attention_dq_plain(qt, kt, vt, gt, lse_t, delta)
    dk_t, dv_t = tops.flash_attention_dkv_plain(qt, kt, vt, gt, lse_t, delta)
    for ours, want in ((dq_t, dq_j), (dk_t, dk_j), (dv_t, dv_j)):
        np.testing.assert_allclose(ours.numpy(), np.asarray(want), atol=1e-4, rtol=0)


@pytest.mark.parametrize("shape", SHAPES, ids=IDS)
def test_autograd_function_matches_jax_grad(shape):
    q, k, v, g = _qkv(2, *shape)
    fa = functools.partial(pattn.flash_attention, bq=64, bk=64, interpret=True)
    want = jax.grad(lambda q, k, v: jnp.sum(fa(q, k, v) * jnp.asarray(g)), (0, 1, 2))(
        *map(jnp.asarray, (q, k, v)))
    ts = [t.requires_grad_() for t in _t(q, k, v)]
    before = tops.flash_attention_fwd.launches
    (tops.flash_attention(*ts) * torch.from_numpy(g)).sum().backward()
    assert tops.flash_attention_fwd.launches == before  # CPU: the twins, no kernel
    for t, w in zip(ts, want):
        np.testing.assert_allclose(t.grad.numpy(), np.asarray(w), atol=1e-4, rtol=0)


def test_wrappers_refuse_what_the_kernels_do_not_take():
    q = torch.zeros(1, 1, 8, 16, dtype=torch.bfloat16)
    tops.check_kernel_args(q, q, q)
    with pytest.raises(TypeError, match="bf16"):
        tops.check_kernel_args(q.float(), q.float(), q.float())
    with pytest.raises(ValueError, match="contiguous"):
        t = torch.zeros(1, 8, 2, 16, dtype=torch.bfloat16).transpose(1, 2)
        tops.check_kernel_args(t, t, t)
    with pytest.raises(ValueError, match="D <="):
        big = torch.zeros(1, 1, 8, 264, dtype=torch.bfloat16)
        tops.check_kernel_args(big, big, big)
    with pytest.raises(TypeError, match="f32 lse"):
        lse = torch.zeros(1, 1, 8, dtype=torch.bfloat16)
        tops.check_kernel_args(q, q, q, q, lse, lse.float())
    with pytest.raises(ValueError, match="cuda or cpu"):
        tops.flash_attention_fwd(q.to("meta"), q.to("meta"), q.to("meta"))


# ---------------------------------------------------------------- modules


def _carry(module, jax_params):
    module.load_state_dict(module_params_from_jax(jax_params), strict=True)
    return module.eval()


@pytest.mark.parametrize("impl", ["auto", "jnp"])
def test_multi_head_attention(impl):
    rng = np.random.default_rng(4)
    x = rng.standard_normal((2, 24, 32)).astype(np.float32)
    kv = rng.standard_normal((2, 40, 32)).astype(np.float32)
    jm = jatt.MultiHeadAttention(32, 4, dtype=jnp.float32, attn_impl="jnp")
    params = jm.init(jax.random.PRNGKey(0), jnp.asarray(x), jnp.asarray(kv))["params"]
    assert params["q"]["kernel"].shape == (32, 4, 8)
    assert params["out"]["kernel"].shape == (4, 8, 32)
    want = np.asarray(jm.apply({"params": params}, jnp.asarray(x), jnp.asarray(kv)))
    tm = _carry(tatt.MultiHeadAttention(32, 4, dtype=torch.float32, attn_impl=impl), params)
    with torch.no_grad():
        got = tm(*_t(x, kv)).numpy()
    np.testing.assert_allclose(got, want, atol=1e-4, rtol=1e-4)


def test_encoder_block_forward_and_gradient():
    rng = np.random.default_rng(5)
    x = rng.standard_normal((2, 12, 32)).astype(np.float32)
    jm = jatt.EncoderBlock(32, 2, dtype=jnp.float32)
    params = jm.init(jax.random.PRNGKey(1), jnp.asarray(x))["params"]
    # non-trivial norms and biases, so every parameter path is exercised
    params = jax.tree_util.tree_map(
        lambda a: a + 0.1 * jnp.asarray(rng.standard_normal(a.shape), jnp.float32), params)
    want = np.asarray(jm.apply({"params": params}, jnp.asarray(x)))
    gx_want = np.asarray(jax.grad(
        lambda x: jnp.sum(jm.apply({"params": params}, x) ** 2))(jnp.asarray(x)))
    tm = _carry(tatt.EncoderBlock(32, 2, dtype=torch.float32), params)
    xt = torch.from_numpy(x).requires_grad_()
    y = tm(xt)
    (y ** 2).sum().backward()
    np.testing.assert_allclose(y.detach().numpy(), want, atol=1e-4, rtol=1e-4)
    np.testing.assert_allclose(xt.grad.numpy(), gx_want, atol=1e-4, rtol=1e-4)


def test_unported_options_raise():
    with pytest.raises(NotImplementedError):
        tatt.MultiHeadAttention(32, 4, attn_impl="ring")
    with pytest.raises(NotImplementedError):
        tatt._attend(*[torch.zeros(1, 1, 4, 8)] * 3, impl="ring")
    with pytest.raises(NotImplementedError):
        tatt.EncoderBlock(32, 4, moe_experts=2)
    with pytest.raises(NotImplementedError):
        tpa.AttentionContextPolicy(num_frames=5, feature_dim=16, hidden_dim=32,
                                   num_heads=2, pp_microbatches=2)
    with pytest.raises(NotImplementedError):
        tpa.AttentionContextPolicy(num_frames=5, feature_dim=16, hidden_dim=32,
                                   num_heads=2, moe_experts=2)


# ---------------------------------------------------------------- policy

S, FEAT, B = 5, 24, 3
POLICY = dict(num_frames=S, feature_dim=FEAT, hidden_dim=32, num_heads=2, depth=2,
              patch_tokens=2, temperature=0.7)


@pytest.fixture(scope="module")
def policies():
    rng = np.random.default_rng(6)
    feats = rng.standard_normal((B, S, FEAT)).astype(np.float32)
    tgt = np.array([0, 3, 4], np.int32)
    ja = jpa.AttentionContextPolicy(**POLICY, dtype=jnp.float32)
    jc = jpa.AttentionContextPolicy(**POLICY, dtype=jnp.float32, is_critic=True)
    key = jax.random.PRNGKey(2)
    pa = ja.init(key, jnp.asarray(feats), jnp.asarray(tgt), key)["params"]
    pc = jc.init(key, jnp.asarray(feats), jnp.asarray(tgt),
                 method=jpa.AttentionContextPolicy.value)["params"]
    ta = _carry(tpa.AttentionContextPolicy(**POLICY, dtype=torch.float32), pa)
    tc = _carry(tpa.AttentionContextPolicy(**POLICY, dtype=torch.float32,
                                           is_critic=True), pc)
    return dict(feats=feats, tgt=tgt, ja=ja, jc=jc, pa=pa, pc=pc, ta=ta, tc=tc)


def test_policy_masked_logits_and_value(policies):
    p = policies
    f, tg = jnp.asarray(p["feats"]), jnp.asarray(p["tgt"])
    ft, tgt = _t(p["feats"], p["tgt"].astype(np.int64))
    want = np.asarray(p["ja"].apply({"params": p["pa"]}, f, tg,
                                    method=jpa.AttentionContextPolicy.masked_logits))
    want_v = np.asarray(p["jc"].apply({"params": p["pc"]}, f, tg,
                                      method=jpa.AttentionContextPolicy.value))
    with torch.no_grad():
        got = p["ta"].masked_logits(ft, tgt).numpy()
        got_v = p["tc"].value(ft, tgt).numpy()
    np.testing.assert_allclose(got, want, atol=1e-4, rtol=1e-4)
    np.testing.assert_allclose(got_v, want_v, atol=1e-4, rtol=1e-4)


@pytest.mark.parametrize("greedy", [False, True])
def test_policy_act_and_logprob_with_replayed_gumbel(policies, greedy):
    p = policies
    f, tg = jnp.asarray(p["feats"]), jnp.asarray(p["tgt"])
    ft, tgt = _t(p["feats"], p["tgt"].astype(np.int64))
    key = jax.random.PRNGKey(7)
    noise = torch.from_numpy(np.array(jax.random.gumbel(key, (B, S), jnp.float32)))
    acs_j, lp_j = p["ja"].apply({"params": p["pa"]}, f, tg, key, greedy)
    with torch.no_grad():
        acs_t, lp_t = p["ta"].act(ft, tgt, greedy=greedy, gumbel=noise)
    np.testing.assert_array_equal(acs_t.numpy(), np.asarray(acs_j))
    np.testing.assert_allclose(lp_t.numpy(), np.asarray(lp_j), atol=1e-4, rtol=1e-4)
    key2 = jax.random.PRNGKey(8)
    noise2 = torch.from_numpy(np.array(jax.random.gumbel(key2, (B, S), jnp.float32)))
    want = np.asarray(p["ja"].apply({"params": p["pa"]}, f, tg, acs_j, key2,
                                    method=jpa.AttentionContextPolicy.logprob))
    with torch.no_grad():
        got = p["ta"].logprob(ft, tgt, acs_t, gumbel=noise2).numpy()
    np.testing.assert_allclose(got, want, atol=1e-4, rtol=1e-4)


def test_policy_weights_cross_and_init_like_flax(policies):
    """Key sets equal flax's (no value_head in the actor, no head in the
    critic), 3-D DenseGeneral layouts kept, N(0, 0.02) embeddings."""
    p = policies
    for params, mod in ((p["pa"], p["ta"]), (p["pc"], p["tc"])):
        assert set(module_params_from_jax(params)) == set(mod.state_dict())
    assert not any(k.startswith("value_head") for k in p["ta"].state_dict())
    assert not any(k.startswith("head") for k in p["tc"].state_dict())
    sd = p["ta"].state_dict()
    assert sd["tokenize.weight"].shape == (FEAT, 2, 32)
    assert sd["block0.SelfAttentionBlock_0.MultiHeadAttention_0.q.weight"].shape == (32, 2, 16)
    assert sd["block0.SelfAttentionBlock_0.MultiHeadAttention_0.out.weight"].shape == (2, 16, 32)
    assert sd["block1.FeedForwardBlock_0.Dense_0.weight"].shape == (8, 32)

    big = tpa.AttentionContextPolicy(num_frames=64, feature_dim=256, hidden_dim=256,
                                     num_heads=4, depth=1, patch_tokens=4)
    fresh = flax_init_state(big, torch.Generator().manual_seed(0))
    for name in ("frame_pos", "patch_pos", "target_emb"):
        assert abs(float(fresh[name].std()) - 0.02) < 0.004, name
        assert abs(float(fresh[name].mean())) < 0.004, name
    w = fresh["block0.SelfAttentionBlock_0.MultiHeadAttention_0.out.weight"]
    assert abs(float(w.std()) - 256 ** -0.5) < 0.1 * 256 ** -0.5  # lecun, fan-in H*D
    assert float(w.abs().max()) <= 2 * 256 ** -0.5 / 0.87962566103423978 + 1e-6
    tok = fresh["tokenize.weight"]
    assert abs(float(tok.std()) - 256 ** -0.5) < 0.1 * 256 ** -0.5
    for k, v in fresh.items():
        if k.endswith("bias"):
            assert float(v.abs().max()) == 0.0, k
    assert float(fresh["block0.FeedForwardBlock_0.LayerNorm_0.weight"].min()) == 1.0
