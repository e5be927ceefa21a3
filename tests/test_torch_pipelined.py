"""The port's double-buffered RL step (`rl.train_step_pipelined`) on the
CPU: against the port's own `train_step` + `episode_init`, bit for bit, and
against the JAX package's `train_step_pipelined` at f32.

Tiny configuration (tests/test_torch_train.py's: `_tiny_config` +
`tiny_model_overrides`, the attention policy at hidden 32, 2 heads, depth
2, 2 patch tokens), random init carried from JAX by `params_from_jax`, the
JAX init by `episode_init_from_jax`, the JAX Gumbel draws replayed.

Tolerances against JAX: metrics and the reconstruction 1e-4 (abs and rel);
parameters within 2*lr*n_updates everywhere and 1e-5 on >= 99% of entries
(Adam turns the sign of a near-zero gradient into a +-lr step); Adam first
moments 1e-3 rel / 1e-6 abs; the next init 1e-4 abs / 1e-3 rel (LPIPS and
the tiny trunk). Against the port's own step: bit for bit (the same ops
in the same order; on the CPU the next init runs in line).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rovr_tpu.train import rl as jrl
from rovr_torch.config import Config
from rovr_torch.train import rl as trl
from rovr_torch.utils import profiling
from rovr_torch.utils.convert import episode_init_from_jax, params_from_jax
from test_torch_train import _noise, _np, _pair

POLICIES = ("attention", "canvas")


def _batches(p, n):
    """n float (corrupted, original) batches: the pair's clips, each next
    one rolled by a sample and brightened, so every batch differs."""
    v, o = (torch.from_numpy(p[k]) for k in ("corrupted", "original"))
    out = []
    for i in range(n):
        out.append(tuple((torch.roll(x, i, 0) * (1.0 - 0.05 * i)).contiguous()
                         for x in (v, o)))
    return out


def _equal_trees(a, b, what):
    ta, tb = list(profiling.tree_tensors(a)), list(profiling.tree_tensors(b))
    assert len(ta) == len(tb), what
    for i, (x, y) in enumerate(zip(ta, tb)):
        assert x.dtype == y.dtype and torch.equal(x, y), f"{what}: leaf {i}"


def _equal_steps(got, want, what):
    """(state, metrics, recon) of two steps, bit for bit."""
    gs, gm, gr = got
    ws, wm, wr = want
    assert set(gm) == set(wm), what
    for k in wm:
        assert torch.equal(gm[k], wm[k]), f"{what} {k}"
    assert torch.equal(gr, wr), f"{what} reconstructed"
    assert gs.step == ws.step, what
    _equal_trees(list(gs), list(ws), f"{what} state")


def _clone(tree):
    if isinstance(tree, torch.Tensor):
        return tree.clone()
    if isinstance(tree, dict):
        return {k: _clone(v) for k, v in tree.items()}
    return tree


@pytest.mark.parametrize("policy", POLICIES)
def test_pipelined_step_equals_train_step_bitwise(policy):
    """train_step_pipelined(state, episode_init(b0), b0, b1) is train_step(b0)
    bit for bit (state, every parameter and Adam moment, metrics,
    reconstruction), with the noise drawn from a generator in the same
    order; next_init is episode_init(b1) on every leaf. The modules are
    bound to another state first: the step binds what it reads."""
    p = _pair(policy)
    ct, mods, state = p["ct"], p["mods_t"], p["state_t"]
    (v0, o0), (v1, o1) = _batches(p, 2)
    want = trl.train_step(state, mods, ct, v0, o0,
                          generator=torch.Generator().manual_seed(5))
    want_next = trl.episode_init(state, mods, ct, v1, o1)
    init = trl.episode_init(state, mods, ct, v0, o0)
    trl.bind(mods, want[0])     # the modules now point at another state
    got = trl.train_step_pipelined(state, mods, ct, init, v0, o0, v1, o1,
                                   generator=torch.Generator().manual_seed(5))
    _equal_steps(got[:3], want, policy)
    _equal_trees(list(got[3]), list(want_next), f"{policy} next_init")
    assert got[0].step == 1 and got[0].actor2_opt["step"] == ct.rl.n_updates_per_ppo


@pytest.mark.parametrize("policy", POLICIES)
def test_pipelined_step_matches_jax(policy):
    """The port's pipelined step against jrl.train_step_pipelined from the
    same state and the same init (JAX's episode_init carried across), the
    JAX noise replayed; next_init against JAX's."""
    p = _pair(policy)
    cj, ct, rl_cfg = p["cj"], p["ct"], p["cj"].rl
    (v0, o0), (v1, o1) = _batches(p, 2)
    jv = [jnp.asarray(x.numpy()) for x in (v0, o0, v1, o1)]
    rng = jax.random.PRNGKey(21)
    init_j = jax.jit(lambda st, v, o: jrl.episode_init(st, p["mods_j"], cj, v, o))(
        p["state_j"], jv[0], jv[1])
    # args 0 and 3 are donated: hand the step private copies
    state_in, init_in = jax.tree.map(jnp.array, (p["state_j"], init_j))
    state_j, metrics_j, recon_j, next_j = jrl.train_step_pipelined(
        state_in, p["mods_j"], cj, init_in, *jv, rng)
    _, _, roll, ppo = _noise(rng, cj)
    state_t, metrics_t, recon_t, next_t = trl.train_step_pipelined(
        p["state_t"], p["mods_t"], ct, episode_init_from_jax(init_j, torch.float32),
        v0, o0, v1, o1, gumbel=(roll, ppo))
    assert set(metrics_t) == set(metrics_j)
    for k in metrics_j:
        np.testing.assert_allclose(float(metrics_t[k]), float(metrics_j[k]),
                                   atol=1e-4, rtol=1e-4, err_msg=k)
    np.testing.assert_allclose(recon_t.numpy(), np.asarray(recon_j), atol=1e-4, rtol=1e-4)
    new_j = params_from_jax(state_j)
    bound = 2 * rl_cfg.actor_lr * rl_cfg.n_updates_per_ppo
    assert state_t.step == int(state_j.step) == 1
    for field in ("actor2", "critic2"):
        got, want = getattr(state_t, f"{field}_params"), getattr(new_j, f"{field}_params")
        assert set(got) == set(want)
        diff = torch.cat([(got[k] - want[k]).abs().flatten() for k in got])
        assert float(diff.max()) <= bound, (field, float(diff.max()))
        assert float((diff <= 1e-5).float().mean()) >= 0.99, field
        mu_t = getattr(state_t, f"{field}_opt")["exp_avg"]
        mu_j = getattr(new_j, f"{field}_opt")["exp_avg"]
        for k in got:
            np.testing.assert_allclose(mu_t[k].numpy(), mu_j[k].numpy(), rtol=1e-3,
                                       atol=1e-6, err_msg=k)
    want_next = episode_init_from_jax(next_j, torch.float32)
    for name in ("curr_loss", "canvas", "feats"):
        np.testing.assert_allclose(getattr(next_t, name).numpy(),
                                   getattr(want_next, name).numpy(),
                                   atol=1e-4, rtol=1e-3, err_msg=name)
    assert len(next_t.org_taps) == len(want_next.org_taps)
    for got, want in zip(next_t.org_taps, want_next.org_taps):
        assert got.shape == want.shape and got.dtype == want.dtype
        np.testing.assert_allclose(got.numpy(), want.numpy(), atol=1e-4, rtol=1e-3)


def test_episode_init_from_jax_maps_the_layout():
    """JAX's init carried across equals the port's episode_init on the same
    state and clips (taps NCHW in the requested dtype; the rest f32)."""
    p = _pair("attention")
    (v0, o0), = _batches(p, 1)
    init_j = jrl.episode_init(p["state_j"], p["mods_j"], p["cj"],
                              jnp.asarray(v0.numpy()), jnp.asarray(o0.numpy()))
    got = episode_init_from_jax(init_j, torch.float32)
    want = trl.episode_init(p["state_t"], p["mods_t"], p["ct"], v0, o0)
    for g, w in zip(list(got), list(want)):
        for a, b in zip(profiling.tree_tensors(g), profiling.tree_tensors(w)):
            assert a.shape == b.shape and a.dtype == b.dtype
            np.testing.assert_allclose(a.numpy(), b.numpy(), atol=1e-4, rtol=1e-3)
    bf = episode_init_from_jax(init_j)
    assert all(t.dtype == torch.bfloat16 for t in bf.org_taps)
    assert bf.curr_loss.dtype == bf.canvas.dtype == bf.feats.dtype == torch.float32
    np.testing.assert_array_equal(
        bf.org_taps[0][1, 2, :, 3, 4].float().numpy(),
        torch.from_numpy(_np(init_j.org_taps[0][1, 2, 3, 4])).bfloat16().float().numpy())


def test_chain_of_three_pipelined_steps_bitwise():
    """Three pipelined steps, each consuming the previous next_init, equal
    three train_steps bit for bit; the caller's first state is untouched."""
    p = _pair("attention")
    ct, mods, state = p["ct"], p["mods_t"], p["state_t"]
    before = [_clone(x) for x in state]
    batches = _batches(p, 4)
    g_want, g_got = (torch.Generator().manual_seed(9) for _ in range(2))
    want_state, got_state = state, state
    init = trl.episode_init(state, mods, ct, *batches[0])
    for i in range(3):
        want = trl.train_step(want_state, mods, ct, *batches[i], generator=g_want)
        got = trl.train_step_pipelined(got_state, mods, ct, init, *batches[i],
                                       *batches[i + 1], generator=g_got)
        _equal_steps(got[:3], want, f"step {i}")
        want_state, got_state, init = want[0], got[0], got[3]
    assert got_state.step == 3
    _equal_trees(list(state), before, "the first state")


def _policy1_config():
    c = Config()
    return c.replace(
        model=dataclasses.replace(
            c.model, backbone="tiny", lpips_stages=((8, 1), (16, 1)),
            local_net_channels=(8, 16, 32, 64), pn1_channels=(8, 16, 32, 64),
            pn2_fc_dims=(256, 64), pn2_num_frames=5, pn1_num_frames=5,
            canvas_size=96, canvas_tiles_per_row=3, attn_hidden_dim=32, attn_heads=2,
            attn_patch_tokens=2, lstm_hidden_dim=32),
        data=dataclasses.replace(c.data, frame_size=(64, 64), vid_length=5),
        rl=dataclasses.replace(c.rl, vid_length=5, time_steps=4, n_updates_per_ppo=2,
                               batch_size=2, context_policy="attention",
                               use_policy1=True, ppo_policy1=True))


def test_policy1_pipelined_step_bitwise():
    """With use_policy1 and ppo_policy1 the pipelined step equals train_step
    bit for bit: pi1's targets, its PPO and both new Adam states."""
    cfg = _policy1_config()
    mods = trl.make_modules(cfg, dtype=torch.float32, device="cpu")
    state = trl.init_state(cfg, mods, seed=0)
    rng = np.random.default_rng(3)
    v0, o0, v1, o1 = (torch.from_numpy(rng.uniform(size=(2, 5, 64, 64, 3)).astype(np.float32))
                      for _ in range(4))
    want = trl.train_step(state, mods, cfg, v0, o0, generator=torch.Generator().manual_seed(2))
    init = trl.episode_init(state, mods, cfg, v0, o0)
    got = trl.train_step_pipelined(state, mods, cfg, init, v0, o0, v1, o1,
                                   generator=torch.Generator().manual_seed(2))
    _equal_steps(got[:3], want, "pi1")
    assert "PPO/actor1_loss" in got[1] and got[0].actor1_opt["step"] == 2
    _equal_trees(list(got[3]), list(trl.episode_init(state, mods, cfg, v1, o1)), "next_init")


def test_uint8_clips_raise_type_error():
    p = _pair("attention")
    ct, mods, state = p["ct"], p["mods_t"], p["state_t"]
    (v0, o0), = _batches(p, 1)
    init = trl.episode_init(state, mods, ct, v0, o0)
    u8 = (v0 * 255).to(torch.uint8)
    for args in ((u8, o0, v0, o0), (v0, o0, v0, u8)):
        with pytest.raises(TypeError, match="train_step"):
            trl.train_step_pipelined(state, mods, ct, init, *args)


def test_episode_init_is_a_profiler_range(tmp_path):
    """The init runs under `rovr/episode_init`: once in a pipelined step
    (the next batch's), once in a train step (inside its rollout)."""
    p = _pair("attention")
    ct, mods, state = p["ct"], p["mods_t"], p["state_t"]
    (v0, o0), (v1, o1) = _batches(p, 2)
    init = trl.episode_init(state, mods, ct, v0, o0)
    with profiling.trace(str(tmp_path / "piped")):
        trl.train_step_pipelined(state, mods, ct, init, v0, o0, v1, o1)
    with profiling.trace(str(tmp_path / "plain")):
        trl.train_step(state, mods, ct, v0, o0)
    for d in ("piped", "plain"):
        assert profiling.analyze_trace(str(tmp_path / d))["ranges"]["rovr/episode_init"][1] == 1
