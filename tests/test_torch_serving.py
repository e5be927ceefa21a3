"""The port's serving slice against the JAX package, end to end on the CPU.

Tiny configuration (`__graft_entry__._tiny_config` + `tiny_model_overrides`),
f32 on both sides (`rl.make_modules(cfg, dtype=f32)`), the JAX package's
random init carried into the port by `params_from_jax`, the same uint8 clips.
Serving must pick the same context frames and reconstruct within 1 uint8
LSB (the wobble infer.py:47-49 allows for reduction order); the greedy
rollout with rewards must give the same metrics and rewards-to-go (1e-4).
The serving spans, recorded, close before each batch is handed over.
"""

import dataclasses
import os
import time

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from __graft_entry__ import _tiny_config
from conftest import tiny_model_overrides
from rovr_tpu import infer as jinfer
from rovr_tpu.data import synthetic as jsynthetic
from rovr_tpu.train import rl as jrl
from rovr_torch import infer as tinfer
from rovr_torch.config import from_dict
from rovr_torch.data import synthetic as tsynthetic
from rovr_torch.train import rl as trl
from rovr_torch.utils import profiling
from rovr_torch.utils.convert import params_from_jax

B = 2


def _configs(**rl_kw):
    c = _tiny_config(batch_size=B)
    cj = c.replace(
        model=dataclasses.replace(c.model, **tiny_model_overrides()),
        rl=dataclasses.replace(c.rl, **rl_kw),
    )
    return cj, from_dict(dataclasses.asdict(cj))


@pytest.fixture(scope="module")
def pair():
    cj, ct = _configs()
    mods_j = jrl.make_modules(cj, dtype=jnp.float32)
    state_j = jrl.init_state(cj, mods_j, jax.random.PRNGKey(0))
    mods_t = trl.make_modules(ct, dtype=torch.float32, device="cpu")
    state_t = params_from_jax(state_j)
    h, w = cj.data.frame_size
    s = cj.rl.vid_length
    batch = [tsynthetic.synthetic_batch(j, s, h, w) for j in range(B)]
    corrupted = np.stack([x[0] for x in batch])
    original = np.stack([x[1] for x in batch])
    return dict(cj=cj, ct=ct, mods_j=mods_j, state_j=state_j, mods_t=mods_t,
                state_t=state_t, corrupted=corrupted, original=original)


def test_synthetic_clips_match_jax_package():
    for a, b in zip(tsynthetic.synthetic_batch(3, 4, 32, 48),
                    jsynthetic.synthetic_batch(3, 4, 32, 48)):
        np.testing.assert_array_equal(a, b)


def test_reconstruct_clips_matches_jax(pair):
    u8 = np.clip(pair["corrupted"] * 255.0 + 0.5, 0, 255).astype(np.uint8)
    (recon_j, acts_j), = jinfer.reconstruct_clips(
        pair["cj"], pair["state_j"], pair["mods_j"], [u8])
    (recon_t, acts_t), = tinfer.reconstruct_clips(
        pair["ct"], pair["state_t"], pair["mods_t"], [u8])
    assert recon_t.dtype == np.uint8 and recon_t.shape == recon_j.shape
    np.testing.assert_array_equal(acts_t, np.asarray(acts_j))
    diff = np.abs(recon_t.astype(np.int16) - np.asarray(recon_j).astype(np.int16))
    assert diff.max() <= 1, f"uint8 recon differs by {diff.max()} LSB"
    assert not np.array_equal(recon_t, u8)  # the rollout really wrote frames


def test_greedy_rollout_with_rewards_matches_jax(pair):
    cj = pair["cj"].replace(rl=dataclasses.replace(pair["cj"].rl, greedy=True))
    ct = pair["ct"].replace(rl=dataclasses.replace(pair["ct"].rl, greedy=True))
    v, o = pair["corrupted"], pair["original"]
    out_j = jax.jit(lambda st, v, o: jrl.rollout(
        st, pair["mods_j"], cj, v, o, jax.random.PRNGKey(0)))(
        pair["state_j"], jnp.asarray(v), jnp.asarray(o))
    out_t = trl.rollout(pair["state_t"], pair["mods_t"], ct,
                        torch.from_numpy(v), torch.from_numpy(o), rewards=True)
    assert set(out_t.metrics) == set(out_j.metrics)
    for k in out_j.metrics:
        np.testing.assert_allclose(float(out_t.metrics[k]), float(out_j.metrics[k]),
                                   atol=1e-4, rtol=1e-4, err_msg=k)
    np.testing.assert_allclose(out_t.traj.rtgs.numpy(), np.asarray(out_j.traj.rtgs),
                               atol=1e-4, rtol=1e-4)
    np.testing.assert_array_equal(out_t.traj.actions.numpy(),
                                  np.asarray(out_j.traj.actions))
    np.testing.assert_allclose(out_t.traj.logprobs.numpy(),
                               np.asarray(out_j.traj.logprobs), atol=1e-4, rtol=1e-4)
    np.testing.assert_allclose(out_t.reconstructed.numpy(),
                               np.asarray(out_j.reconstructed), atol=1e-4, rtol=1e-4)


def test_sampled_rollout_draws_from_generator(pair):
    ct = pair["ct"]
    v = torch.from_numpy(pair["corrupted"])

    def acts(seed):
        g = torch.Generator().manual_seed(seed)
        return trl.rollout(pair["state_t"], pair["mods_t"], ct, v, v,
                           generator=g, rewards=False).traj.actions

    a0, a0_again, a1 = acts(0), acts(0), acts(1)
    torch.testing.assert_close(a0, a0_again, atol=0, rtol=0)
    assert not torch.equal(a0, a1)
    assert ((a0 >= 0) & (a0 < ct.rl.vid_length)).all()


def test_rollout_rejects_unported_options(pair):
    """pi1 (use_policy1) is ported: a rollout with it refuses modules and a
    state built without it, and with them picks every target by pi1 (in
    [0, S), one per step and clip, deterministic under a seeded generator)
    and records pi1's observations and logprobs."""
    v = torch.from_numpy(pair["corrupted"])
    _, ct = _configs(use_policy1=True)
    ct = ct.replace(model=dataclasses.replace(ct.model, lstm_hidden_dim=32))
    with pytest.raises(ValueError, match="use_policy1"):
        trl.rollout(pair["state_t"], pair["mods_t"], ct, v, v, rewards=False)
    mods = trl.make_modules(ct, dtype=torch.float32, device="cpu")
    state = trl.init_state(ct, mods, seed=0)

    def run(seed):
        return trl.rollout(state, mods, ct, v, v, rewards=False,
                           generator=torch.Generator().manual_seed(seed)).traj

    traj, again = run(0), run(0)
    t, s = ct.rl.time_steps, ct.rl.vid_length
    assert traj.target_idx.shape == (t, B) and traj.logprobs1.shape == (t, B)
    assert ((traj.target_idx >= 0) & (traj.target_idx < s)).all()
    assert torch.equal(traj.target_idx, again.target_idx)
    assert torch.equal(traj.actions, again.actions)
    canvas, token = traj.obs1
    c = ct.model.canvas_size
    assert canvas.shape == token.shape == (t, B, c, c, 1)
    assert float(token[0].abs().max()) == 0 and float(token[1:].abs().max()) > 0


def test_init_state_draws_like_flax(pair):
    mods = pair["mods_t"]
    state = trl.init_state(pair["ct"], mods, seed=0)
    for name, mod in zip(trl.ROVRModules._fields, mods):
        params = getattr(state, trl._MODULE_STATE[name])
        if mod is None:  # RAFT, built only for the spatio signal
            assert params is None
            continue
        assert set(params) == set(mod.state_dict())
    unet = state.local_net_params
    assert all(float(unet[f"conv{i}.bias"].abs().max()) == 0 for i in range(1, 9))
    w = unet["conv5.weight"]  # fan_in 9*64, truncated at 2 sd
    std = (1.0 / w[0].numel()) ** 0.5 / 0.87962566103423978
    assert float(w.abs().max()) <= 2 * std + 1e-6
    assert abs(float(w.std()) - (1.0 / w[0].numel()) ** 0.5) < 0.1 * float(w.std())
    lins = [v for k, v in state.lpips_params.items() if k.startswith("lin")]
    assert lins and all(float(x.min()) >= 0 and float(x.max()) < 0.1 for x in lins)
    again = trl.init_state(pair["ct"], mods, seed=0)
    torch.testing.assert_close(again.vp_params, state.vp_params, atol=0, rtol=0)


@pytest.mark.parametrize("source", ["synthetic", "dataset"])
def test_run_writes_frames(tmp_path, source):
    _, ct = _configs()
    s = ct.rl.vid_length
    dataset = None
    if source == "dataset":  # float clips longer than S, as the folder datasets give
        dataset = [(tsynthetic.synthetic_batch(j, s + 2, 64, 64)[0],) for j in range(2)]
    out = tinfer.run(ct, dataset=dataset, num_clips=3, out_dir=str(tmp_path),
                     device="cpu")
    assert out["clips"] == 3 and out["frames_written"] == 3 * s
    assert sorted(os.listdir(tmp_path)) == ["00000", "00001", "00002"]
    assert len(os.listdir(tmp_path / "00002")) == s


def test_lpips_cache_split_and_init_chunks_change_nothing(pair):
    """lpips_cache_from_stage recomputes the early taps per step and
    lpips_init_chunk runs the init LPIPS pass in S-chunks: both are the
    same arithmetic, so the episode's rewards must not move."""
    v = torch.from_numpy(pair["corrupted"])
    o = torch.from_numpy(pair["original"])

    def metrics(**model_kw):
        ct = pair["ct"]
        ct = ct.replace(rl=dataclasses.replace(ct.rl, greedy=True),
                        model=dataclasses.replace(ct.model, **model_kw))
        out = trl.rollout(pair["state_t"], pair["mods_t"], ct, v, o)
        return out.metrics, out.traj.rtgs

    base, rtgs = metrics()
    split, rtgs_split = metrics(lpips_cache_from_stage=1, lpips_init_chunk=1)
    for k in base:
        torch.testing.assert_close(split[k], base[k], atol=1e-6, rtol=1e-6)
    torch.testing.assert_close(rtgs_split, rtgs, atol=1e-6, rtol=1e-6)


def test_reconstruct_clips_spans_close_before_the_yield(pair):
    """Each recorded batch is one rovr/serve/batch root over the copy in,
    the rollout (the episode init inside it, no reward span) and the copy
    out, with T policy, UNet and re-encode spans; the root closes before
    the batch is handed over, so the consumer's sleep is not the batch's."""
    u8 = np.clip(pair["corrupted"] * 255.0 + 0.5, 0, 255).astype(np.uint8)
    t = pair["ct"].rl.time_steps
    handed = []
    with profiling.recording() as spans:
        t0 = time.perf_counter_ns()
        for _ in tinfer.reconstruct_clips(pair["ct"], pair["state_t"], pair["mods_t"],
                                          [u8, u8]):
            handed.append(time.perf_counter_ns())
            # longer than a batch takes on this machine, however loaded
            sleep_s = 3 * (handed[0] - t0) / 1e9 + 0.2
            time.sleep(sleep_s)
    roots = [i for i, s in enumerate(spans) if s.parent is None]
    assert [spans[i].name for i in roots] == ["rovr/serve/batch"] * 2
    for k, r in enumerate(roots):
        got = {}
        for s in spans:
            if s.root == r and s.name.startswith("rovr/"):
                key = (None if s.parent is None else spans[s.parent].name, s.name)
                got[key] = got.get(key, 0) + 1
        assert got == {(None, "rovr/serve/batch"): 1, ("rovr/serve/batch", "rovr/serve/h2d"): 1,
                       ("rovr/serve/batch", "rovr/rollout"): 1,
                       ("rovr/serve/batch", "rovr/serve/d2h"): 1,
                       ("rovr/rollout", "rovr/episode_init"): 1,
                       **{("rovr/rollout", f"rovr/rollout/{n}"): t
                          for n in ("policy", "unet", "reencode")}}
        assert spans[r].t1_ns <= handed[k]
        assert spans[r].ms < sleep_s * 1e3
    assert spans[roots[1]].t0_ns - spans[roots[0]].t1_ns >= sleep_s * 1e9
