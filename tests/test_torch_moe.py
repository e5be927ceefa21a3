"""The port's mixture-of-experts FFN (rovr_torch/models/moe.py) against the
JAX package's (rovr_tpu/models/moe.py) at f32 on the CPU, after
tests/test_ep.py: flax's init carried over by `module_params_from_jax`, the
same inputs from a seeded numpy generator.

Tolerances: the module's outputs and `moe_aux` 2e-5 relative / 2e-6
absolute, as tests/test_ep.py holds the MoE; parameter gradients against
jax.grad 1e-4 relative / 1e-6 absolute (f32 sums in another order, as the
other gradient tests of the port); the attention policy with experts 1e-4
(tests/test_torch_attention.py's), with the JAX Gumbel draws replayed. The
index dispatch is exactly the one-hot einsum twin (each output row has one
non-zero term).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rovr_tpu.models import moe as jmoe
from rovr_tpu.models import policy_attention as jpa
from rovr_tpu.models.attention import EncoderBlock as JEncoder
from rovr_tpu.models.attention import FeedForwardBlock as JFeedForward
from rovr_torch.models import moe as tmoe
from rovr_torch.models import policy_attention as tpa
from rovr_torch.models.attention import EncoderBlock, FeedForwardBlock
from rovr_torch.models.layers import flax_init_state
from rovr_torch.utils.convert import module_params_from_jax

TOL = dict(rtol=2e-5, atol=2e-6)


def _x(b=2, l=8, d=32, seed=0):
    return np.random.default_rng(seed).standard_normal((b, l, d)).astype(np.float32)


def _pair(e, factor, x, seed=0, **kw):
    """(JAX module, its params, the port's module carrying them)."""
    jm = jmoe.MoEFeedForward(hidden_dim=x.shape[-1], num_experts=e,
                             capacity_factor=factor, dtype=jnp.float32)
    params = jm.init(jax.random.PRNGKey(seed), jnp.asarray(x))["params"]
    tm = tmoe.MoEFeedForward(x.shape[-1], e, factor, torch.float32, **kw)
    tm.load_state_dict(module_params_from_jax(params), strict=True)
    return jm, params, tm


def _apply(jm, params, x):
    y, inter = jm.apply({"params": params}, jnp.asarray(x), mutable=["intermediates"])
    return np.asarray(y), float(inter["intermediates"]["moe_aux"][0])


@pytest.mark.parametrize("e,factor", [(4, 1.25), (2, 1.0), (3, 0.5)],
                         ids=["e4_cap1.25", "e2_cap1", "e3_drops"])
def test_forward_and_aux_match_jax(e, factor):
    x = _x(seed=e)
    jm, params, tm = _pair(e, factor, x)
    want, aux = _apply(jm, params, x)
    with torch.no_grad():
        got = tm(torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(got, want, **TOL)
    np.testing.assert_allclose(float(tm.moe_aux), aux, **TOL)


def test_single_expert_equals_the_dense_ffn():
    """E = 1 with full capacity: the gate is exactly 1, so the MoE with the
    dense FFN's weights is the dense FFN (tests/test_ep.py:28-52), in the
    port and against JAX's dense block."""
    x = _x()
    dense_j = JFeedForward(hidden_dim=32, dtype=jnp.float32)
    dp = dense_j.init(jax.random.PRNGKey(1), jnp.asarray(x))["params"]
    want = np.asarray(dense_j.apply({"params": dp}, jnp.asarray(x)))
    dense_t = FeedForwardBlock(32, torch.float32)
    dense_t.load_state_dict(module_params_from_jax(dp), strict=True)
    m = tmoe.MoEFeedForward(32, 1, 1.0, torch.float32)
    sd = dense_t.state_dict()
    m.load_state_dict({
        "LayerNorm_0.weight": sd["LayerNorm_0.weight"], "LayerNorm_0.bias": sd["LayerNorm_0.bias"],
        "router.weight": m.router.weight.detach(), "router.bias": m.router.bias.detach(),
        "w1": sd["Dense_0.weight"].T[None], "b1": sd["Dense_0.bias"][None],
        "w2": sd["Dense_1.weight"].T[None], "b2": sd["Dense_1.bias"][None]})
    with torch.no_grad():
        got = m(torch.from_numpy(x)).numpy()
        dense = dense_t(torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(got, dense, **TOL)
    np.testing.assert_allclose(got, want, **TOL)


def test_ample_capacity_keeps_every_token():
    """Capacity >= tokens: every token's output is its routed expert's MLP
    times the gate (tests/test_ep.py:54-87), so no expert's first E-1
    tokens are lost to the slot formula."""
    x = _x(b=1, l=16, seed=3)
    jm, params, tm = _pair(4, 4.0, x)
    with torch.no_grad():
        y = tm(torch.from_numpy(x))[0]
        tok = tm.LayerNorm_0(torch.from_numpy(x))[0]
        probs = torch.softmax(tm.router(tok), -1)
        expert, gate = probs.argmax(-1), probs.max(-1).values
        for i in range(16):
            k = int(expert[i])
            h = torch.nn.functional.gelu(tok[i] @ tm.w1[k] + tm.b1[k], approximate="tanh")
            ref = gate[i] * (h @ tm.w2[k] + tm.b2[k])
            assert not torch.all(y[i] == 0), f"token {i} dropped"
            np.testing.assert_allclose(y[i].numpy(), ref.numpy(), rtol=2e-4, atol=2e-5)
    np.testing.assert_allclose(y.numpy(), _apply(jm, params, x)[0][0], **TOL)


def test_dropped_tokens_have_an_exactly_zero_delta():
    """cap = 1 slot per expert: at most one token per expert is kept; the
    others' outputs are exactly 0, as JAX's (tests/test_ep.py:89-100)."""
    x = _x(b=1, l=16)
    jm, params, tm = _pair(2, 0.01, x)
    with torch.no_grad():
        y = tm(torch.from_numpy(x)).numpy()
    want = _apply(jm, params, x)[0]
    zero = np.all(y[0] == 0.0, axis=-1)
    assert zero.sum() >= 14 and np.array_equal(zero, np.all(want[0] == 0.0, axis=-1))
    np.testing.assert_allclose(y, want, **TOL)


def test_capacity_is_the_jax_expression_not_ceil():
    """n / e * factor = 5.0005: int(x + 0.999) gives 5 slots where ceil
    gives 6, and the sixth token of an expert is dropped as in JAX."""
    factor = 5.0005 * 3 / 16
    assert tmoe.capacity(16, 3, factor) == 5
    assert tmoe.capacity(16, 3, 5.0 * 3 / 16) == 5
    assert tmoe.capacity(16, 3, 5.002 * 3 / 16) == 6
    assert tmoe.capacity(4, 8, 0.1) == 1
    x = _x(b=2, l=8, seed=7)
    jm, params, tm = _pair(3, factor, x, seed=2)
    with torch.no_grad():
        got = tm(torch.from_numpy(x)).numpy()
        _, _, slot, keep, cap = tm.route(tm.LayerNorm_0(torch.from_numpy(x)).reshape(16, 32))
    assert cap == 5 and not keep.all() and bool((slot[~keep] >= 5).all())
    np.testing.assert_allclose(got, _apply(jm, params, x)[0], **TOL)


@pytest.mark.parametrize("factor", [1.25, 0.3], ids=["cap1.25", "drops"])
def test_index_dispatch_is_the_onehot_einsum(factor):
    x = torch.from_numpy(_x(b=3, l=10, d=32, seed=11))
    m = tmoe.MoEFeedForward(32, 4, factor, torch.float32)
    m.load_state_dict(flax_init_state(m, torch.Generator().manual_seed(3)))
    twin = tmoe.MoEFeedForward(32, 4, factor, torch.float32, dispatch="onehot")
    twin.load_state_dict(m.state_dict())
    xi, xo = x.clone().requires_grad_(), x.clone().requires_grad_()
    yi, yo = m(xi), twin(xo)
    assert torch.equal(yi, yo)
    (yi ** 2).sum().backward()
    (yo ** 2).sum().backward()
    torch.testing.assert_close(xi.grad, xo.grad, rtol=1e-6, atol=1e-7)
    for (n, p), q in zip(m.named_parameters(), twin.parameters()):
        torch.testing.assert_close(p.grad, q.grad, rtol=1e-6, atol=1e-7, msg=n)
    with pytest.raises(ValueError, match="dispatch"):
        tmoe.MoEFeedForward(32, 4, dispatch="dense")


def test_gradients_match_jax_grad():
    x = _x(seed=5)
    jm, params, tm = _pair(2, 1.25, x)
    want = jax.grad(lambda p: jnp.sum(jm.apply({"params": p}, jnp.asarray(x)) ** 2))(params)
    want = module_params_from_jax(want)   # the port's names and layouts
    xt = torch.from_numpy(x)
    (tm(xt) ** 2).sum().backward()
    for name, p in tm.named_parameters():
        assert torch.isfinite(p.grad).all(), name
        np.testing.assert_allclose(p.grad.numpy(), want[name].numpy(), rtol=1e-4,
                                   atol=1e-6, err_msg=name)
    assert float(tm.w1.grad.abs().sum()) > 0


def test_init_and_names_like_flax():
    """flax_init_state draws w1/w2 lecun-normal with the expert axis as the
    batch axis (fan-in d, resp. d/4), zero b1/b2, a lecun-normal router
    with a zero bias; the names are flax's under `moe_ff`."""
    m = EncoderBlock(256, 4, moe_experts=4)
    fresh = flax_init_state(m, torch.Generator().manual_seed(0))
    for name, fan_in in (("moe_ff.w1", 256), ("moe_ff.w2", 64), ("moe_ff.router.weight", 256)):
        std = fan_in ** -0.5
        assert abs(float(fresh[name].std()) - std) < 0.1 * std, name
        assert float(fresh[name].abs().max()) <= 2 * std / 0.87962566103423978 + 1e-6
    for name in ("moe_ff.b1", "moe_ff.b2", "moe_ff.router.bias"):
        assert float(fresh[name].abs().max()) == 0.0
    assert fresh["moe_ff.w1"].shape == (4, 256, 64) and fresh["moe_ff.w2"].shape == (4, 64, 256)
    jp = JEncoder(32, 2, dtype=jnp.float32, moe_experts=2).init(jax.random.PRNGKey(0),
                                                                jnp.zeros((1, 4, 32)))
    port = EncoderBlock(32, 2, torch.float32, moe_experts=2)
    assert set(module_params_from_jax(jp["params"])) == set(port.state_dict())


# ---------------------------------------------------------------- policy

S, FEAT, B = 5, 24, 3
POLICY = dict(num_frames=S, feature_dim=FEAT, hidden_dim=32, num_heads=2, depth=2,
              patch_tokens=2, temperature=0.7, moe_experts=2)


@pytest.fixture(scope="module")
def policies():
    rng = np.random.default_rng(6)
    feats = rng.standard_normal((B, S, FEAT)).astype(np.float32)
    tgt = np.array([0, 3, 4], np.int32)
    ja = jpa.AttentionContextPolicy(**POLICY, dtype=jnp.float32, attn_impl="jnp")
    jc = jpa.AttentionContextPolicy(**POLICY, dtype=jnp.float32, attn_impl="jnp",
                                    is_critic=True)
    key = jax.random.PRNGKey(2)
    pa = ja.init(key, jnp.asarray(feats), jnp.asarray(tgt), key)["params"]
    pc = jc.init(key, jnp.asarray(feats), jnp.asarray(tgt),
                 method=jpa.AttentionContextPolicy.value)["params"]
    assert "moe_ff" in pa["block0"]
    ta = tpa.AttentionContextPolicy(**POLICY, dtype=torch.float32)
    tc = tpa.AttentionContextPolicy(**POLICY, dtype=torch.float32, is_critic=True)
    ta.load_state_dict(module_params_from_jax(pa), strict=True)
    tc.load_state_dict(module_params_from_jax(pc), strict=True)
    return dict(feats=feats, tgt=tgt, ja=ja, jc=jc, pa=pa, pc=pc, ta=ta, tc=tc)


def test_policy_with_experts_act_logprob_value(policies):
    """tests/test_ep.py:145-165 held against the port with replayed noise."""
    p = policies
    f, tg = jnp.asarray(p["feats"]), jnp.asarray(p["tgt"])
    ft, tgt = torch.from_numpy(p["feats"]), torch.from_numpy(p["tgt"].astype(np.int64))
    key = jax.random.PRNGKey(7)
    noise = torch.from_numpy(np.array(jax.random.gumbel(key, (B, S), jnp.float32)))
    acs_j, lp_j = p["ja"].apply({"params": p["pa"]}, f, tg, key)
    key2 = jax.random.PRNGKey(8)
    noise2 = torch.from_numpy(np.array(jax.random.gumbel(key2, (B, S), jnp.float32)))
    lp2_j = p["ja"].apply({"params": p["pa"]}, f, tg, acs_j, key2,
                          method=jpa.AttentionContextPolicy.logprob)
    v_j = p["jc"].apply({"params": p["pc"]}, f, tg, method=jpa.AttentionContextPolicy.value)
    with torch.no_grad():
        acs_t, lp_t = p["ta"].act(ft, tgt, gumbel=noise)
        lp2_t = p["ta"].logprob(ft, tgt, acs_t, gumbel=noise2)
        v_t = p["tc"].value(ft, tgt)
    np.testing.assert_array_equal(acs_t.numpy(), np.asarray(acs_j))
    for got, want in ((lp_t, lp_j), (lp2_t, lp2_j), (v_t, v_j)):
        assert np.all(np.isfinite(got.numpy()))
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-4, atol=1e-4)
    aux = [float(getattr(p["ta"], f"block{i}").moe_ff.moe_aux) for i in range(2)]
    assert all(np.isfinite(a) and a > 0 for a in aux)
