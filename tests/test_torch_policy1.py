"""The port's frame-selection path (pi1: PolicyNet1, ActionLSTM,
extract_patch, PPO on pi1) against the JAX package on the CPU.

Two tiny configurations, f32 on both sides: "tpr2" is tests/test_rl.py's
tiny_config with use_policy1 (32^2 frames, a 64^2 canvas of 2 x 2 tiles,
S = 4, T = 3) and the attention context policy, with ppo_policy1 (the
noise-free logprob); "tpr3" has 3 tiles per row (64^2 frames, a 96^2
canvas, S = 5 under a 6-way pi1 head, so `valid_frames` masks one logit),
the canvas context policy and the noised logprob. The JAX package's random
init is carried into the port by `params_from_jax(..., policy1=True)` and
its Gumbel draws are replayed: each rollout step splits its key four ways,
pi1 samples with the first, pi2 with the second.

Tolerances: modules 1e-5 (f32 sums in another order), logprobs and
metrics 1e-4; pi1's first-epoch gradients 1e-4 relative / 1e-6 absolute on
at least 99% of the entries and everywhere within 1e-6 plus 1e-5 of their
tensor's largest entry (a conv or norm weight's gradient sums ~24k
products with cancellation; against a float64 reference both sides' f32
errors are about 1e-6 of that entry), and a conv bias that feeds a
batch-stat norm, whose gradient is exactly zero, rounding below 1e-5 of
the largest gradient on both sides; updated
parameters within 1e-5 on at least 99% of entries and everywhere within
2*lr*n_updates (Adam turns the sign of a near-zero gradient into a +-lr
step); actions, targets and gathered tiles exactly.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from conftest import tiny_model_overrides
from rovr_tpu.config import Config as JConfig
from rovr_tpu.models import action_lstm as jlstm
from rovr_tpu.models import layers as jlayers
from rovr_tpu.models import policy_net_1 as jp1
from rovr_tpu.models.video_processor import VideoProcessor as JVideoProcessor
from rovr_tpu.ops import ppo as jppo
from rovr_tpu.ops import rewards as jrewards
from rovr_tpu.train import rl as jrl
from rovr_torch.config import from_dict
from rovr_torch.data import synthetic as tsynthetic
from rovr_torch.models import action_lstm as tlstm
from rovr_torch.models import layers as tlayers
from rovr_torch.models import policy_net_1 as tp1
from rovr_torch.models.video_processor import VideoProcessor
from rovr_torch.ops import ppo as tppo
from rovr_torch.ops import rewards as trewards
from rovr_torch.train import rl as trl
from rovr_torch.utils import checkpoint as tckpt
from rovr_torch.utils.convert import module_params_from_jax, params_from_jax

B = 2
F32 = jnp.float32


def _np(x):
    return np.array(x)  # a writable copy


def _t(x):
    return torch.from_numpy(_np(x))


def _configs(name):
    c = JConfig()
    if name == "tpr2":   # tests/test_rl.py's tiny_config(use_policy1=True)
        frame, s, canvas, tpr, pn1, t_steps = 32, 4, 64, 2, 4, 3
        policy, ppo1 = "attention", True
    else:
        frame, s, canvas, tpr, pn1, t_steps = 64, 5, 96, 3, 6, 4
        policy, ppo1 = "canvas", False
    cj = c.replace(
        data=dataclasses.replace(c.data, frame_size=(frame, frame), vid_length=s),
        model=dataclasses.replace(
            c.model, **tiny_model_overrides(), pn2_num_frames=s, pn1_num_frames=pn1,
            canvas_size=canvas, canvas_tile=32, canvas_tiles_per_row=tpr,
            lstm_hidden_dim=32, attn_hidden_dim=32, attn_heads=2, attn_depth=1,
            attn_patch_tokens=2),
        rl=dataclasses.replace(
            c.rl, vid_length=s, time_steps=t_steps, n_updates_per_ppo=2, batch_size=B,
            use_policy1=True, ppo_policy1=ppo1, context_policy=policy),
    )
    return cj, from_dict(dataclasses.asdict(cj))


_PAIRS = {}


def _pair(name):
    if name not in _PAIRS:
        cj, ct = _configs(name)
        mods_j = jrl.make_modules(cj, dtype=F32)
        state_j = jrl.init_state(cj, mods_j, jax.random.PRNGKey(0))
        mods_t = trl.make_modules(ct, dtype=torch.float32, device="cpu")
        h, w = cj.data.frame_size
        s = cj.rl.vid_length
        batch = [tsynthetic.synthetic_batch(20 + j, s, h, w) for j in range(B)]
        _PAIRS[name] = dict(
            cj=cj, ct=ct, mods_j=mods_j, state_j=state_j, mods_t=mods_t,
            state_t=params_from_jax(state_j, policy1=True),
            video=np.stack([x[0] for x in batch]), org=np.stack([x[1] for x in batch]),
            rng=jax.random.PRNGKey(5))
    return _PAIRS[name]


def _rollout_noise(key, cfg):
    """The JAX rollout's draws: pi1's (T, B, pn1) and pi2's (T, B, S)."""
    g1, g2 = [], []
    for _ in range(cfg.rl.time_steps):
        key, k1, k2, _ = jax.random.split(key, 4)
        g1.append(jax.random.gumbel(k1, (B, cfg.model.pn1_num_frames), F32))
        g2.append(jax.random.gumbel(k2, (B, cfg.rl.vid_length), F32))
    return _t(jnp.stack(g1)), _t(jnp.stack(g2))


def _rollouts(p):
    """(JAX rollout, port rollout) on the pair's clips, computed once."""
    if "rollouts" not in p:
        k_roll, _ = jax.random.split(p["rng"])
        out_j = jax.jit(lambda st, v, o, k: jrl.rollout(st, p["mods_j"], p["cj"], v, o, k))(
            p["state_j"], jnp.asarray(p["video"]), jnp.asarray(p["org"]), k_roll)
        g1, g2 = _rollout_noise(k_roll, p["cj"])
        out_t = trl.rollout(p["state_t"], p["mods_t"], p["ct"], torch.from_numpy(p["video"]),
                            torch.from_numpy(p["org"]), gumbel=g2, gumbel1=g1)
        p["rollouts"] = (out_j, out_t)
    return p["rollouts"]


def _close(got, want, tol, msg=""):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), rtol=tol, atol=tol,
                               err_msg=msg)


# ---------------------------------------------------------------- modules


@pytest.mark.parametrize("per_sample", [False, True])
@pytest.mark.parametrize("up", [False, True])
def test_conv_blocks_match_flax(up, per_sample):
    """ConvBlock and UpConvBlock (conv or 2x2/s2 transposed conv -> norm ->
    relu), output and the gradients of a weighted sum (input and every
    parameter: the norm's written-out backward against jax.grad)."""
    rng = np.random.default_rng(1)
    x = rng.standard_normal((3, 10, 12, 5)).astype(np.float32)
    jcls = jlayers.UpConvBlock if up else jlayers.ConvBlock
    jm = jcls(7, dtype=F32, per_sample_stats=per_sample)
    params = jm.init(jax.random.PRNGKey(2), jnp.asarray(x))["params"]
    y_j = jm.apply({"params": params}, jnp.asarray(x))
    w = rng.standard_normal(y_j.shape).astype(np.float32)
    gx_j, gp_j = jax.grad(lambda xx, pp: jnp.sum(jm.apply({"params": pp}, xx) * w),
                          argnums=(0, 1))(jnp.asarray(x), params)

    tcls = tlayers.UpConvBlock if up else tlayers.ConvBlock
    tm = tcls(5, 7, dtype=torch.float32, per_sample_stats=per_sample)
    tm.load_state_dict(module_params_from_jax(params))
    xt = torch.from_numpy(x).permute(0, 3, 1, 2).requires_grad_()
    y_t = tm(xt).permute(0, 2, 3, 1)
    _close(y_t.detach(), y_j, 1e-5)
    (y_t * torch.from_numpy(w)).sum().backward()
    np.testing.assert_allclose(xt.grad.permute(0, 2, 3, 1).numpy(), np.asarray(gx_j),
                               rtol=1e-4, atol=1e-6)
    want = module_params_from_jax(gp_j)
    conv = "ConvTranspose_0" if up else "Conv_0"
    scale = float(want[f"{conv}.weight"].abs().max())
    for n, prm in tm.named_parameters():
        if n == f"{conv}.bias":   # the norm cancels it: zero up to rounding, both sides
            assert max(float(prm.grad.abs().max()), float(want[n].abs().max())) \
                <= 1e-5 * scale
            continue
        np.testing.assert_allclose(prm.grad.numpy(), want[n].numpy(), rtol=1e-4,
                                   atol=1e-6, err_msg=n)


def _pn1_pair(exact, critic=False, valid=None, canvas=64, frames=6):
    kw = dict(num_frames=frames, channels=(4, 8, 8, 16), temperature=0.5,
              is_critic=critic, valid_frames=valid, exact_logprob=exact)
    jm = jp1.PolicyNet1(**kw, dtype=F32)
    rng = np.random.default_rng(3)
    img = rng.standard_normal((3, canvas, canvas, 1)).astype(np.float32)
    ctx = rng.standard_normal((3, canvas, canvas, 1)).astype(np.float32)
    key = jax.random.PRNGKey(4)
    if critic:
        params = jm.init(key, img, ctx, method=jp1.PolicyNet1.value)["params"]
    else:
        params = jm.init(key, img, ctx, key)["params"]
    tm = tp1.PolicyNet1(**kw, dtype=torch.float32, canvas_size=canvas)
    tm.load_state_dict(module_params_from_jax(params))
    return jm, params, tm, img, ctx


@pytest.mark.parametrize("exact", [True, False])
def test_policy_net1_act_logits_logprob_match_flax(exact):
    jm, params, tm, img, ctx = _pn1_pair(exact, valid=4)
    ti, tc = torch.from_numpy(img), torch.from_numpy(ctx)
    _close(tm.logits(ti, tc).detach(), jm.apply({"params": params}, img, ctx,
                                                method=jp1.PolicyNet1.logits), 1e-5)
    key = jax.random.PRNGKey(6)
    a_j, lp_j = jm.apply({"params": params}, img, ctx, key, method=jp1.PolicyNet1.act)
    noise = _t(jax.random.gumbel(key, (3, 6), F32))
    a_t, lp_t = tm.act(ti, tc, noise)
    np.testing.assert_array_equal(a_t.numpy(), np.asarray(a_j))
    assert (a_t < 4).all()                      # valid_frames masks frames 4 and 5
    _close(lp_t, lp_j, 1e-4)
    acts = jnp.asarray([0, 3, 2])
    k2 = jax.random.PRNGKey(7)
    want = jm.apply({"params": params}, img, ctx, acts, k2, method=jp1.PolicyNet1.logprob)
    got = tm.logprob(ti, tc, torch.from_numpy(_np(acts)),
                     _t(jax.random.gumbel(k2, (3, 6), F32)))
    _close(got.detach(), want, 1e-4)
    if exact:   # the PPO ratio is 1 at unchanged parameters
        _close(tm.logprob(ti, tc, a_t).detach(), lp_t, 1e-6)


def test_policy_net1_value_and_masking():
    jm, params, tm, img, ctx = _pn1_pair(True, critic=True)
    v_j = jm.apply({"params": params}, img, ctx, method=jp1.PolicyNet1.value)
    v_t = tm.value(torch.from_numpy(img), torch.from_numpy(ctx))
    assert v_t.shape == (3,)
    _close(v_t.detach(), v_j, 1e-5)
    with pytest.raises(ValueError, match="actor"):
        tm.act(torch.from_numpy(img), torch.from_numpy(ctx))
    logits = torch.zeros(2, 6)
    for valid, masked in ((None, 0), (6, 0), (9, 0), (2, 4)):
        m = tp1.PolicyNet1(num_frames=6, channels=(4, 8, 8, 16), valid_frames=valid,
                           canvas_size=64)
        out = m._mask_invalid(logits)
        assert int((out == -1e9).sum()) == 2 * masked
        assert (out[:, :valid or 6] == 0).all()


def test_action_lstm_three_carried_steps_match_flax():
    tile, hidden, token = 8, 16, 24
    jm = jlstm.ActionLSTM(hidden_dim=hidden, token_size=token, tile=tile)
    rng = np.random.default_rng(8)
    acts = [rng.integers(0, 20, (2, 3)) for _ in range(3)]
    patches = [rng.standard_normal((2, 3, tile, tile)).astype(np.float32) for _ in range(3)]
    params = jm.init(jax.random.PRNGKey(9), jm.init_carry(2), jnp.asarray(acts[0]),
                     jnp.asarray(patches[0]))["params"]
    tm = tlstm.ActionLSTM(hidden_dim=hidden, token_size=token, tile=tile)
    tm.load_state_dict(module_params_from_jax(params))
    assert set(tm.state_dict()) == set(module_params_from_jax(params))
    cj, ct = jm.init_carry(2), tm.init_carry(2)
    for a, pt in zip(acts, patches):
        cj, tok_j = jm.apply({"params": params}, cj, jnp.asarray(a), jnp.asarray(pt))
        ct, tok_t = tm(ct, torch.from_numpy(a), torch.from_numpy(pt))
        assert tok_t.shape == (2, token, token, 1)
        _close(tok_t.detach(), tok_j, 1e-5)
        for got, want in zip(ct, cj):   # (c, h), flax's order
            _close(got.detach(), want, 1e-5)


@pytest.mark.parametrize("tpr,canvas", [(3, 96), (8, 256), (5, 160)])
def test_extract_patch_matches_jax_exactly(tpr, canvas):
    """Tiles by index, row = idx // tiles_per_row, including an index whose
    tile would leave the canvas (clamped as dynamic_slice clamps)."""
    tile = 32
    rng = np.random.default_rng(tpr)
    cv = rng.standard_normal((2, canvas, canvas, 1)).astype(np.float32)
    n_tiles = (canvas // tile) ** 2
    idx = np.stack([rng.integers(0, n_tiles, 3), [n_tiles - 1, tpr, n_tiles + tpr]])
    jvp = JVideoProcessor(canvas_size=canvas, tile=tile, tiles_per_row=tpr)
    want = jvp.apply({}, jnp.asarray(idx), jnp.asarray(cv),
                     method=JVideoProcessor.extract_patch)
    tvp = VideoProcessor(canvas_size=canvas, tile=tile, tiles_per_row=tpr,
                         backbone_name="tiny", feature_dim=16)
    got = tvp.extract_patch(torch.from_numpy(idx), torch.from_numpy(cv))
    assert got.shape == (2, 3, tile, tile)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_module_converters_agree_with_the_jax_ones():
    """One random reference-layout state dict through the JAX converter
    (then the port's JAX map) and through the port's own converter gives
    the same port state dict, which the module loads strictly; the LSTM
    cell's weights then compute torch's nn.LSTMCell exactly."""
    rng = np.random.default_rng(11)
    c1, c2, c3, c4 = 4, 8, 8, 16
    ref = {}

    def put(name, *shape):
        ref[name] = rng.standard_normal(shape).astype(np.float32)

    for i, (ci, co) in enumerate(zip((2, c1, c2, c3), (c1, c2, c3, c4))):
        put(f"conv{i + 1}.weight", co, ci, 3, 3)
        put(f"conv{i + 1}.bias", co)
        put(f"bn{i + 1}.weight", co)
        put(f"bn{i + 1}.bias", co)
        put(f"bn{i + 1}.running_mean", co)
    for i, (ci, co) in enumerate(zip((c4, c3, c2), (c3, c2, c1))):
        put(f"upconv{i + 1}.weight", ci, co, 2, 2)
        put(f"upconv{i + 1}.bias", co)
        put(f"bn_up{i + 1}.weight", co)
        put(f"bn_up{i + 1}.bias", co)
        put(f"conv{i + 5}.weight", co, 2 * co, 3, 3)
        put(f"conv{i + 5}.bias", co)
        put(f"bn{i + 5}.weight", co)
        put(f"bn{i + 5}.bias", co)
    for conv, bn, ci, co in (("conv8", "bn8", c1, 3), ("conv9", "bn9", 3, 1)):
        put(f"{conv}.weight", co, ci, 1, 1)
        put(f"{conv}.bias", co)
        put(f"{bn}.weight", co)
        put(f"{bn}.bias", co)
    put("fc_final.weight", 6, 256)
    put("fc_final.bias", 6)
    via_jax = module_params_from_jax(jp1.convert_torch_state_dict(ref))
    direct = tp1.convert_torch_state_dict(ref)
    assert set(via_jax) == set(direct)
    for k in direct:
        np.testing.assert_array_equal(direct[k].numpy(), via_jax[k].numpy(), err_msg=k)
    tp1.PolicyNet1(num_frames=6, channels=(c1, c2, c3, c4), canvas_size=64) \
        .load_state_dict(direct, strict=True)

    cell = torch.nn.LSTMCell(12, 5)
    sd = {f"lstm.{k}": v.detach().numpy() for k, v in cell.state_dict().items()}
    via_jax = module_params_from_jax(jlstm.convert_torch_lstm_cell(sd))
    direct = tlstm.convert_torch_lstm_cell(sd)
    assert set(via_jax) == set(direct)
    for k in direct:
        np.testing.assert_array_equal(direct[k].numpy(), via_jax[k].numpy(), err_msg=k)
    mine = tlstm.OptimizedLSTMCell(12, 5)
    mine.load_state_dict(direct, strict=True)
    x, h, c = (torch.from_numpy(rng.standard_normal((3, n)).astype(np.float32))
               for n in (12, 5, 5))
    with torch.no_grad():
        h_ref, c_ref = cell(x, (h, c))
        (c_new, h_new), out = mine((c, h), x)
    torch.testing.assert_close(h_new, h_ref, rtol=1e-5, atol=1e-6)
    torch.testing.assert_close(c_new, c_ref, rtol=1e-5, atol=1e-6)
    assert out is h_new


# ---------------------------------------------------------------- state


def test_init_state_draws_pi1_from_its_own_stream():
    """With use_policy1 the other modules' parameters are those without it;
    pi1's fields have the JAX state's keys and shapes; the recurrent
    kernels are orthogonal per gate, the input kernels lecun-normal over
    3 + 3*tile^2, the biases zero; fresh Adam states for actor1 and critic1,
    none for the LSTM; without use_policy1 every pi1 field is None."""
    p = _pair("tpr2")
    ct = p["ct"]
    off = ct.replace(rl=dataclasses.replace(ct.rl, use_policy1=False, ppo_policy1=False))
    mods_off = trl.make_modules(off, dtype=torch.float32, device="cpu")
    s_on = trl.init_state(ct, p["mods_t"], seed=3)
    s_off = trl.init_state(off, mods_off, seed=3)
    assert mods_off.actor1 is mods_off.critic1 is mods_off.lstm is None
    for f in ("actor1_params", "critic1_params", "lstm_params", "actor1_opt", "critic1_opt"):
        assert getattr(s_off, f) is None
        assert getattr(params_from_jax(p["state_j"]), f) is None
    for f in ("vp_params", "actor2_params", "critic2_params", "local_net_params",
              "lpips_params"):
        a, b = getattr(s_on, f), getattr(s_off, f)
        assert set(a) == set(b) and all(torch.equal(a[k], b[k]) for k in a), f
    carried = p["state_t"]
    for f in ("actor1_params", "critic1_params", "lstm_params"):
        a, b = getattr(s_on, f), getattr(carried, f)
        assert {k: tuple(v.shape) for k, v in a.items()} == \
            {k: tuple(v.shape) for k, v in b.items()}, f
    for f in ("actor1", "critic1"):
        for st in (s_on, carried):
            opt = getattr(st, f"{f}_opt")
            assert opt["step"] == 0 and set(opt["exp_avg"]) == set(getattr(st, f"{f}_params"))
    lstm = s_on.lstm_params
    hid, fan_in = ct.model.lstm_hidden_dim, 3 + 3 * ct.model.canvas_tile ** 2
    for g in "ifgo":
        w = lstm[f"cell.h{g}.weight"]
        torch.testing.assert_close(w @ w.T, torch.eye(hid), atol=1e-5, rtol=0)
        assert float(lstm[f"cell.h{g}.bias"].abs().max()) == 0
        wi = lstm[f"cell.i{g}.weight"]
        assert wi.shape == (hid, fan_in)
        assert abs(float(wi.std()) * fan_in ** 0.5 - 1.0) < 0.1
    assert not any(torch.equal(lstm["cell.hi.weight"], lstm[f"cell.h{g}.weight"])
                   for g in "fgo")
    with pytest.raises(ValueError, match="pi1 is off"):
        trl.init_state(off, mods_off, seed=0, actor1_params=s_on.actor1_params)
    given = trl.init_state(ct, p["mods_t"], seed=4, actor1_params=carried.actor1_params)
    assert all(torch.equal(given.actor1_params[k], carried.actor1_params[k])
               for k in carried.actor1_params)


def test_flax_init_state_refuses_a_parameter_it_has_no_rule_for():
    class Odd(torch.nn.Module):
        def __init__(self):
            super().__init__()
            self.scale = torch.nn.Parameter(torch.ones(3))

    with pytest.raises(ValueError, match="no initializer for scale"):
        tlayers.flax_init_state(Odd(), torch.Generator().manual_seed(0))


# ---------------------------------------------------------------- rollout


@pytest.mark.parametrize("name", ["tpr2", "tpr3"])
def test_policy1_rollout_matches_jax(name):
    p = _pair(name)
    out_j, out_t = _rollouts(p)
    tj, tt = out_j.traj, out_t.traj
    np.testing.assert_array_equal(tt.target_idx.numpy(), np.asarray(tj.target_idx))
    np.testing.assert_array_equal(tt.actions.numpy(), np.asarray(tj.actions))
    assert ((tt.target_idx >= 0) & (tt.target_idx < p["ct"].rl.vid_length)).all()
    _close(tt.logprobs1, tj.logprobs1, 1e-4)
    _close(tt.logprobs, tj.logprobs, 1e-4)
    _close(tt.rtgs, tj.rtgs, 1e-4)
    assert set(out_t.metrics) == set(out_j.metrics)
    for k in out_j.metrics:
        _close(float(out_t.metrics[k]), float(out_j.metrics[k]), 1e-4, k)
    for got, want in zip(tt.obs1, tj.obs1):   # (canvas, token) before each insert
        assert tuple(got.shape) == tuple(want.shape)
        _close(got, want, 1e-4)
    assert float(tt.obs1[1][0].abs().max()) == 0   # the first token is zeros
    _close(out_t.reconstructed, out_j.reconstructed, 1e-4)


def _traj_to_torch(traj):
    return trl.Trajectory(
        obs=tuple(_t(x) for x in traj.obs), target_idx=_t(traj.target_idx).long(),
        actions=_t(traj.actions).long(), logprobs=_t(traj.logprobs), rtgs=_t(traj.rtgs),
        obs1=tuple(_t(x) for x in traj.obs1), logprobs1=_t(traj.logprobs1))


def _ppo_noise(k_ppo, cfg):
    return torch.stack([_t(jax.random.gumbel(k, (B * cfg.rl.time_steps, cfg.rl.vid_length),
                                             F32))
                        for k in jax.random.split(k_ppo, cfg.rl.n_updates_per_ppo)])


def test_policy1_first_epoch_gradients_match_jax_grad():
    p = _pair("tpr2")
    cj, mods_j, state_j = p["cj"], p["mods_j"], p["state_j"]
    traj = _rollouts(p)[0].traj
    pn1 = jp1.PolicyNet1

    @jax.jit
    def grads_j(traj):
        cvs, tok = (jrl._flat(x) for x in traj.obs1)
        act, old = jrl._flat(traj.target_idx), jrl._flat(traj.logprobs1)
        rtgs = jrl._flat(traj.rtgs)
        adv = jrewards.normalized_advantage(rtgs, mods_j.critic1.apply(
            {"params": state_j.critic1_params}, cvs, tok, method=pn1.value))
        ga = jax.grad(lambda a: jppo.ppo_clip_actor_loss(mods_j.actor1.apply(
            {"params": a}, cvs, tok, act, None, method=pn1.logprob), old, adv,
            cj.rl.clip))(state_j.actor1_params)
        gc = jax.grad(lambda c: jppo.critic_loss(mods_j.critic1.apply(
            {"params": c}, cvs, tok, method=pn1.value), rtgs))(state_j.critic1_params)
        return ga, gc

    ga, gc = grads_j(traj)
    tt = _traj_to_torch(traj)
    mods = p["mods_t"]
    cvs, tok = (trl._flat(x) for x in tt.obs1)
    act, old, rtgs = (trl._flat(x) for x in (tt.target_idx, tt.logprobs1, tt.rtgs))
    named_a = trl._trainable(mods.actor1, p["state_t"].actor1_params)
    named_c = trl._trainable(mods.critic1, p["state_t"].critic1_params)
    try:
        with torch.no_grad():
            adv = trewards.normalized_advantage(rtgs, mods.critic1.value(cvs, tok))
        tppo.ppo_clip_actor_loss(mods.actor1.logprob(cvs, tok, act), old, adv,
                                 p["ct"].rl.clip).backward()
        tppo.critic_loss(mods.critic1.value(cvs, tok), rtgs).backward()
    finally:
        mods.actor1.requires_grad_(False)
        mods.critic1.requires_grad_(False)
    cancelled = ("Conv_0.bias", "ConvTranspose_0.bias", "head1.bias", "head2.bias")
    for named, want in ((named_a, ga), (named_c, gc)):
        want = module_params_from_jax(want)
        assert set(want) == {n for n, _ in named}
        scale = max(float(v.abs().max()) for v in want.values())
        oks = []
        for n, prm in named:
            got = prm.grad if prm.grad is not None else torch.zeros_like(prm)
            if n.endswith(cancelled):   # a bias feeding a batch-stat norm: exactly 0
                assert max(float(got.abs().max()), float(want[n].abs().max())) \
                    <= 1e-5 * scale, n
                continue
            d = (got - want[n]).abs()
            oks.append((d <= 1e-6 + 1e-4 * want[n].abs()).flatten())
            assert float(d.max()) <= 1e-6 + 1e-5 * float(want[n].abs().max()), \
                (n, float(d.max()))
        assert float(torch.cat(oks).float().mean()) >= 0.99


def test_policy1_ppo_update_matches_jax():
    """ppo_update on one fixed (JAX) trajectory: pi2's epochs, then pi1's on
    their own Adam states; losses 1e-4, parameters as the module doc says,
    the LSTM and the frozen modules unchanged, the input state untouched."""
    p = _pair("tpr2")
    cj, ct, rl_cfg = p["cj"], p["ct"], p["cj"].rl
    traj = _rollouts(p)[0].traj
    _, k_ppo = jax.random.split(p["rng"])
    state_j, m_j = jax.jit(lambda st, tr, k: jrl.ppo_update(st, p["mods_j"], cj, tr, k))(
        p["state_j"], traj, k_ppo)
    before = {f: dict(getattr(p["state_t"], f)) for f in ("actor1_params", "lstm_params")}
    state_t, m_t = trl.ppo_update(p["state_t"], p["mods_t"], ct, _traj_to_torch(traj),
                                  gumbel=_ppo_noise(k_ppo, cj))
    assert set(m_t) == set(m_j) >= {"PPO/actor1_loss", "PPO/critic1_loss"}
    for k in m_j:
        _close(float(m_t[k]), float(m_j[k]), 1e-4, k)
    new_j = params_from_jax(state_j, policy1=True)
    bound = 2 * rl_cfg.actor_lr * rl_cfg.n_updates_per_ppo
    for field in ("actor1", "critic1", "actor2", "critic2"):
        got, want = getattr(state_t, f"{field}_params"), getattr(new_j, f"{field}_params")
        diff = torch.cat([(got[k] - want[k]).abs().flatten() for k in got])
        assert float(diff.max()) <= bound, (field, float(diff.max()))
        assert float((diff <= 1e-5).float().mean()) >= 0.99, field
        assert getattr(state_t, f"{field}_opt")["step"] == rl_cfg.n_updates_per_ppo
    moved = max(float((state_t.actor1_params[k] - before["actor1_params"][k]).abs().max())
                for k in before["actor1_params"])
    assert moved > 0
    for k, v in before["lstm_params"].items():
        assert torch.equal(state_t.lstm_params[k], v)
        assert torch.equal(p["state_t"].lstm_params[k], v)
    for k, v in before["actor1_params"].items():
        assert torch.equal(p["state_t"].actor1_params[k], v)


# ---------------------------------------------------------------- checkpoints


def _equal_trees(a, b):
    if isinstance(a, tuple) and hasattr(a, "_fields"):
        return all(_equal_trees(getattr(a, f), getattr(b, f)) for f in a._fields)
    if isinstance(a, dict):
        return set(a) == set(b) and all(_equal_trees(a[k], b[k]) for k in a)
    if isinstance(a, torch.Tensor):
        return a.dtype == b.dtype and torch.equal(a, b)
    return a == b


def test_policy1_state_checkpoint_round_trips(tmp_path):
    """A pi1 state after a train step (both new Adam states moved) restores
    bit for bit; a checkpoint written without pi1's fields restores into a
    state without pi1, and refuses a template that holds them."""
    p = _pair("tpr3")
    ct = p["ct"].replace(rl=dataclasses.replace(p["ct"].rl, ppo_policy1=True))
    mods = trl.make_modules(ct, dtype=torch.float32, device="cpu")
    state = trl.init_state(ct, mods, seed=1)
    state, metrics, _ = trl.train_step(state, mods, ct, p["video"], p["org"],
                                       generator=torch.Generator().manual_seed(2))
    assert state.actor1_opt["step"] == state.critic1_opt["step"] == 2
    assert {"PPO/actor1_loss", "PPO/critic1_loss"} <= set(metrics)
    mgr = tckpt.CheckpointManager(str(tmp_path / "p1"))
    mgr.save(0, state)
    assert _equal_trees(mgr.restore(template=state), state)

    off = ct.replace(rl=dataclasses.replace(ct.rl, use_policy1=False, ppo_policy1=False))
    plain = state._replace(actor1_params=None, critic1_params=None, lstm_params=None,
                           actor1_opt=None, critic1_opt=None)
    old = {k: v for k, v in tckpt._to_plain(plain).items()
           if k not in ("actor1_params", "critic1_params", "lstm_params", "actor1_opt",
                        "critic1_opt")}
    mgr_old = tckpt.CheckpointManager(str(tmp_path / "old"))
    mgr_old._write(0, old)
    template = trl.init_state(off, trl.make_modules(off, dtype=torch.float32, device="cpu"),
                              seed=1)
    assert _equal_trees(mgr_old.restore(template=template), plain)
    with pytest.raises(ValueError, match="lacks"):
        mgr_old.restore(template=state)
    # a pi1 checkpoint served by a configuration without pi1: pi1's part dropped
    assert _equal_trees(mgr.restore(template=template), plain)
