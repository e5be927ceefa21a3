"""The port's RL train step against the JAX package, end to end on the CPU.

Tiny configuration (`__graft_entry__._tiny_config` + `tiny_model_overrides`,
attention policy at hidden 32, 2 heads, depth 2, 2 patch tokens), f32 on
both sides, the JAX package's random init carried into the port by
`params_from_jax`, the same clips, and the JAX Gumbel draws replayed into
the port: `k_roll, k_ppo = split(rng)`; each rollout step splits its key
four ways and samples with the second; PPO samples epoch e with
`split(k_ppo, n_updates)[e]` over `_flat`'s (B*T) rows.

Tolerances: metrics 1e-4 (f32 sums in another order); first-epoch
gradients 1e-4 relative / 1e-6 absolute; updated parameters within 1e-5 on
at least 99% of entries and everywhere within 2*lr*n_updates (Adam turns
the sign of a near-zero gradient into a +-lr step); serving uint8 within
1 LSB with equal actions. The train step's spans, recorded, at both context
policies.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from __graft_entry__ import _tiny_config
from conftest import tiny_model_overrides
from rovr_tpu import infer as jinfer
from rovr_tpu.ops import ppo as jppo
from rovr_tpu.ops import rewards as jrewards
from rovr_tpu.train import rl as jrl
from rovr_torch import infer as tinfer
from rovr_torch.config import from_dict
from rovr_torch.data import synthetic as tsynthetic
from rovr_torch.ops import ppo as tppo
from rovr_torch.ops import rewards as trewards
from rovr_torch.train import rl as trl
from rovr_torch.utils import profiling
from rovr_torch.utils.convert import module_params_from_jax, params_from_jax

B = 2
ATTN = dict(attn_hidden_dim=32, attn_heads=2, attn_depth=2, attn_patch_tokens=2)


def _configs(policy):
    c = _tiny_config(batch_size=B)
    cj = c.replace(
        model=dataclasses.replace(c.model, **tiny_model_overrides(), **ATTN),
        rl=dataclasses.replace(c.rl, context_policy=policy),
    )
    return cj, from_dict(dataclasses.asdict(cj))


def _np(x):
    return np.array(x)  # a writable copy


def _noise(rng, cfg):
    """The JAX train step's Gumbel draws: (T, B, S) rollout, (n, B*T, S) PPO."""
    rl = cfg.rl
    s = rl.vid_length
    k_roll, k_ppo = jax.random.split(rng)
    key, roll = k_roll, []
    for _ in range(rl.time_steps):
        key, _, k2, _ = jax.random.split(key, 4)
        roll.append(jax.random.gumbel(k2, (B, s), jnp.float32))
    ppo = [jax.random.gumbel(k, (B * rl.time_steps, s), jnp.float32)
           for k in jax.random.split(k_ppo, rl.n_updates_per_ppo)]
    return k_roll, k_ppo, torch.from_numpy(_np(jnp.stack(roll))), \
        torch.from_numpy(_np(jnp.stack(ppo)))


_PAIRS = {}


def _pair(policy):
    if policy not in _PAIRS:
        cj, ct = _configs(policy)
        mods_j = jrl.make_modules(cj, dtype=jnp.float32)
        state_j = jrl.init_state(cj, mods_j, jax.random.PRNGKey(0))
        mods_t = trl.make_modules(ct, dtype=torch.float32, device="cpu")
        state_t = params_from_jax(state_j)
        h, w = cj.data.frame_size
        s = cj.rl.vid_length
        batch = [tsynthetic.synthetic_batch(10 + j, s, h, w) for j in range(B)]
        _PAIRS[policy] = dict(
            cj=cj, ct=ct, mods_j=mods_j, state_j=state_j, mods_t=mods_t,
            state_t=state_t, corrupted=np.stack([x[0] for x in batch]),
            original=np.stack([x[1] for x in batch]), rng=jax.random.PRNGKey(3))
    return _PAIRS[policy]


def _rollout_j(p, key):
    """The JAX sampled rollout on the pair's clips (computed once per key)."""
    memo = p.setdefault("rollouts", {})
    k = tuple(np.asarray(key).tolist())
    if k not in memo:
        memo[k] = jax.jit(lambda st, v, o, k: jrl.rollout(
            st, p["mods_j"], p["cj"], v, o, k))(
            p["state_j"], jnp.asarray(p["corrupted"]), jnp.asarray(p["original"]), key)
    return memo[k]


# ---------------------------------------------------------------- losses


def test_ppo_losses_and_normalized_advantage():
    rng = np.random.default_rng(0)
    curr, old, adv, vals, rtg = (rng.standard_normal(64).astype(np.float32)
                                 for _ in range(5))
    old[:3] += np.array([30.0, -30.0, 0.1], np.float32)  # the +-20 log-ratio bound
    for clip in (0.2, 0.1):
        np.testing.assert_allclose(
            float(tppo.ppo_clip_actor_loss(*map(torch.from_numpy, (curr, old, adv)), clip)),
            float(jppo.ppo_clip_actor_loss(*map(jnp.asarray, (curr, old, adv)), clip)),
            rtol=1e-6, atol=1e-6)
    np.testing.assert_allclose(
        float(tppo.critic_loss(torch.from_numpy(vals), torch.from_numpy(rtg))),
        float(jppo.critic_loss(jnp.asarray(vals), jnp.asarray(rtg))), rtol=1e-6)
    vt = torch.from_numpy(vals).requires_grad_()
    a = trewards.normalized_advantage(torch.from_numpy(rtg), vt)
    np.testing.assert_allclose(
        a.detach().numpy(),
        np.asarray(jrewards.normalized_advantage(jnp.asarray(rtg), jnp.asarray(vals))),
        rtol=1e-5, atol=1e-5)
    assert not a.requires_grad  # the values are detached
    one = trewards.normalized_advantage(torch.ones(1), torch.zeros(1))
    assert float(one) == 0.0


def test_init_state_and_params_from_jax_cover_the_attention_policy():
    """The port's fresh state and the JAX state carried across hold the
    same keys and shapes: no `value_head` in the actor, no `head` in the
    critic, flax's 3-D DenseGeneral layouts; fresh Adam states at step 0."""
    p = _pair("attention")
    fresh = trl.init_state(p["ct"], p["mods_t"], seed=0)
    carried = p["state_t"]
    for field in ("actor2", "critic2"):
        a, b = getattr(fresh, f"{field}_params"), getattr(carried, f"{field}_params")
        assert {k: tuple(v.shape) for k, v in a.items()} == \
            {k: tuple(v.shape) for k, v in b.items()}
        for st in (fresh, carried):
            opt = getattr(st, f"{field}_opt")
            assert opt["step"] == 0 and set(opt["exp_avg"]) == set(a)
            assert all(float(t.abs().max()) == 0 for t in opt["exp_avg_sq"].values())
    assert "value_head.weight" not in fresh.actor2_params
    assert "head.weight" not in fresh.critic2_params
    assert "value_head.weight" in fresh.critic2_params and "head.weight" in fresh.actor2_params
    q = "block0.SelfAttentionBlock_0.MultiHeadAttention_0.q.weight"
    assert tuple(fresh.actor2_params[q].shape) == (32, 2, 16)
    assert tuple(fresh.actor2_params["tokenize.weight"].shape) == (
        p["ct"].model.feature_dim, 2, 32)
    assert fresh.step == carried.step == 0


# ---------------------------------------------------------------- rollout


def test_sampled_attention_rollout_with_replayed_noise():
    p = _pair("attention")
    k_roll, _, roll, _ = _noise(p["rng"], p["cj"])
    out_j = _rollout_j(p, k_roll)
    out_t = trl.rollout(p["state_t"], p["mods_t"], p["ct"],
                        torch.from_numpy(p["corrupted"]), torch.from_numpy(p["original"]),
                        gumbel=roll)
    np.testing.assert_array_equal(out_t.traj.actions.numpy(), np.asarray(out_j.traj.actions))
    for k in out_j.metrics:
        np.testing.assert_allclose(float(out_t.metrics[k]), float(out_j.metrics[k]),
                                   atol=1e-4, rtol=1e-4, err_msg=k)
    np.testing.assert_allclose(out_t.traj.rtgs.numpy(), np.asarray(out_j.traj.rtgs),
                               atol=1e-4, rtol=1e-4)
    np.testing.assert_allclose(out_t.traj.logprobs.numpy(),
                               np.asarray(out_j.traj.logprobs), atol=1e-4, rtol=1e-4)
    (fts_j,), (fts_t,) = out_j.traj.obs, out_t.traj.obs  # the refreshed feature table
    np.testing.assert_allclose(fts_t.numpy(), np.asarray(fts_j), atol=1e-4, rtol=1e-4)


def test_reconstruct_clips_attention_matches_jax():
    p = _pair("attention")
    u8 = np.clip(p["corrupted"] * 255.0 + 0.5, 0, 255).astype(np.uint8)
    (recon_j, acts_j), = jinfer.reconstruct_clips(p["cj"], p["state_j"], p["mods_j"], [u8])
    (recon_t, acts_t), = tinfer.reconstruct_clips(p["ct"], p["state_t"], p["mods_t"], [u8])
    np.testing.assert_array_equal(acts_t, np.asarray(acts_j))
    diff = np.abs(recon_t.astype(np.int16) - np.asarray(recon_j).astype(np.int16))
    assert diff.max() <= 1, f"uint8 recon differs by {diff.max()} LSB"
    assert not np.array_equal(recon_t, u8)


# ---------------------------------------------------------------- PPO


def _traj_to_torch(traj):
    return trl.Trajectory(
        obs=tuple(torch.from_numpy(_np(x)) for x in traj.obs),
        target_idx=torch.from_numpy(_np(traj.target_idx)).long(),
        actions=torch.from_numpy(_np(traj.actions)).long(),
        logprobs=torch.from_numpy(_np(traj.logprobs)),
        rtgs=torch.from_numpy(_np(traj.rtgs)))


def check_first_epoch_gradients(policy):
    """The port's first-epoch actor and critic gradients against jax.grad
    of the same losses on the same (JAX) trajectory."""
    p = _pair(policy)
    cj, ct, mods_j, state_j = p["cj"], p["ct"], p["mods_j"], p["state_j"]
    k_roll, k_ppo, _, ppo_noise = _noise(p["rng"], cj)
    traj = _rollout_j(p, k_roll).traj

    @jax.jit
    def grads_j(traj):
        obs = jax.tree.map(jrl._flat, traj.obs)
        tgt, acs = jrl._flat(traj.target_idx), jrl._flat(traj.actions)
        old, rtgs = jrl._flat(traj.logprobs), jrl._flat(traj.rtgs)
        adv = jrewards.normalized_advantage(
            rtgs, jrl._policy_value(mods_j, cj, state_j.critic2_params, obs, tgt))
        key0 = jax.random.split(k_ppo, cj.rl.n_updates_per_ppo)[0]
        ga = jax.grad(lambda a: jppo.ppo_clip_actor_loss(
            jrl._policy_logprob(mods_j, cj, a, obs, tgt, acs, key0), old, adv,
            cj.rl.clip))(state_j.actor2_params)
        gc = jax.grad(lambda c: jppo.critic_loss(
            jrl._policy_value(mods_j, cj, c, obs, tgt), rtgs))(state_j.critic2_params)
        return ga, gc

    ga, gc = grads_j(traj)
    tt = _traj_to_torch(traj)
    obs = tuple(trl._flat(x) for x in tt.obs)
    tgt, acs = trl._flat(tt.target_idx), trl._flat(tt.actions)
    old, rtgs = trl._flat(tt.logprobs), trl._flat(tt.rtgs)
    mods = p["mods_t"]
    named_a = trl._trainable(mods.actor2, p["state_t"].actor2_params)
    named_c = trl._trainable(mods.critic2, p["state_t"].critic2_params)
    try:
        with torch.no_grad():
            adv = trewards.normalized_advantage(rtgs, trl._policy_value(mods, ct, obs, tgt))
        trl.actor_loss(mods, ct, obs, tgt, acs, old, adv, ppo_noise[0]).backward()
        trl.value_loss(mods, ct, obs, tgt, rtgs).backward()
    finally:
        mods.actor2.requires_grad_(False)
        mods.critic2.requires_grad_(False)
    for named, want in ((named_a, ga), (named_c, gc)):
        want = module_params_from_jax(want)
        assert set(want) == {n for n, _ in named}
        for n, prm in named:
            got = prm.grad if prm.grad is not None else torch.zeros_like(prm)
            np.testing.assert_allclose(got.numpy(), want[n].numpy(), rtol=1e-4,
                                       atol=1e-6, err_msg=n)


def check_train_step(policy):
    """Two full train steps (uint8 clips) from shared params, with the JAX
    noise replayed; the second resumes both sides' Adam states."""
    p = _pair(policy)
    cj, rl_cfg = p["cj"], p["cj"].rl
    u8 = [np.clip(x * 255.0 + 0.5, 0, 255).astype(np.uint8)
          for x in (p["corrupted"], p["original"])]  # the uint8 path
    state_j, state_t = p["state_j"], p["state_t"]
    for step, rng in ((1, p["rng"]), (2, jax.random.PRNGKey(4))):
        _, _, roll, ppo_noise = _noise(rng, cj)
        prev_t = state_t
        state_j, metrics_j, recon_j = jrl.train_step(
            state_j, p["mods_j"], cj, jnp.asarray(u8[0]), jnp.asarray(u8[1]), rng)
        state_t, metrics_t, recon_t = trl.train_step(
            state_t, p["mods_t"], p["ct"], torch.from_numpy(u8[0]),
            torch.from_numpy(u8[1]), gumbel=(roll, ppo_noise))
        assert set(metrics_t) == set(metrics_j)
        for k in metrics_j:
            np.testing.assert_allclose(float(metrics_t[k]), float(metrics_j[k]),
                                       atol=1e-4, rtol=1e-4, err_msg=f"step {step} {k}")
        np.testing.assert_allclose(recon_t.numpy(), np.asarray(recon_j), atol=1e-4,
                                   rtol=1e-4)
        assert state_t.step == int(state_j.step) == step
        bound = 2 * rl_cfg.actor_lr * rl_cfg.n_updates_per_ppo * step
        new_j = params_from_jax(state_j)
        for field in ("actor2", "critic2"):
            got = getattr(state_t, f"{field}_params")
            want = getattr(new_j, f"{field}_params")
            before = getattr(prev_t, f"{field}_params")
            assert set(got) == set(want)
            moved = max(float((got[k] - before[k]).abs().max()) for k in got)
            assert moved > 0, f"{field} params did not change"
            diff = torch.cat([(got[k] - want[k]).abs().flatten() for k in got])
            assert float(diff.max()) <= bound, (step, field, float(diff.max()))
            assert float((diff <= 1e-5).float().mean()) >= 0.99, (step, field)
            opt = getattr(state_t, f"{field}_opt")
            assert opt["step"] == rl_cfg.n_updates_per_ppo * step
            mu_j = getattr(new_j, f"{field}_opt")["exp_avg"]
            for k in got:
                np.testing.assert_allclose(opt["exp_avg"][k].numpy(), mu_j[k].numpy(),
                                           rtol=1e-3, atol=1e-6, err_msg=k)
    # the input state is untouched: the update works on copies
    for k, v in p["state_t"].actor2_params.items():
        np.testing.assert_array_equal(
            v.numpy(), module_params_from_jax(p["state_j"].actor2_params)[k].numpy())


def test_first_epoch_gradients_match_jax_grad_attention():
    check_first_epoch_gradients("attention")


def test_train_step_matches_jax_attention():
    check_train_step("attention")


# ---------------------------------------------------------------- spans


def _spans_by_parent(spans):
    """{(parent name or None, name): count} of the recorded spans whose name
    starts with "rovr/"."""
    out = {}
    for s in spans:
        if s.name.startswith("rovr/"):
            key = (None if s.parent is None else spans[s.parent].name, s.name)
            out[key] = out.get(key, 0) + 1
    return out


@pytest.mark.parametrize("policy", ["canvas", "attention"])
def test_train_step_spans_and_outputs_with_the_recorder(policy):
    """A recorded tiny train step holds one train_step root with the
    rollout (the episode init inside it) and PPO under it, and T each of
    the policy, UNet, reward and re-encode spans under the rollout; the
    step's outputs are the same bits with the recorder on and off."""
    _, ct = _configs(policy)
    mods = trl.make_modules(ct, dtype=torch.float32, device="cpu")
    state = trl.init_state(ct, mods, seed=0)
    h, w = ct.data.frame_size
    s, t = ct.rl.vid_length, ct.rl.time_steps
    batch = [tsynthetic.synthetic_batch(20 + j, s, h, w) for j in range(B)]
    video, org = (torch.from_numpy(np.stack([x[i] for x in batch])) for i in (0, 1))
    off = trl.train_step(state, mods, ct, video, org)
    with profiling.recording() as spans:
        on = trl.train_step(state, mods, ct, video, org)
    assert _spans_by_parent(spans) == {
        (None, "rovr/train_step"): 1, ("rovr/train_step", "rovr/rollout"): 1,
        ("rovr/rollout", "rovr/episode_init"): 1, ("rovr/train_step", "rovr/ppo_update"): 1,
        **{("rovr/rollout", f"rovr/rollout/{k}"): t
           for k in ("policy", "unet", "reward", "reencode")}}
    assert {sp.root for sp in spans} == {0} and all(sp.t1_ns is not None for sp in spans)
    a, b = list(profiling.tree_tensors(off)), list(profiling.tree_tensors(on))
    assert len(a) == len(b) > 0
    for x, y in zip(a, b):
        assert torch.equal(x, y)
