"""The port's evaluation path against the JAX package on the CPU, float32:
the rollout's sequential baseline, `eval_step`, `eval_ci_step` and the CI
statistics.

Tiny configuration (`__graft_entry__._tiny_config` + `tiny_model_overrides`,
the attention policy at hidden 32, 2 heads, 2 patch tokens), the JAX random
init (RAFT's too, from `evaluate.init_raft_params`) carried over by
`utils.convert`, the same synthetic clips with their masks, and the JAX
Gumbel draws replayed: each rollout step splits its key four ways and
samples with the second, over the step's (rows, S) logits.

Tolerances: the sequential baseline's video as uint8 within 1 LSB; eval
metrics 1e-4 (float32 sums in another order); CI statistics 1e-12.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from __graft_entry__ import _tiny_config
from conftest import tiny_model_overrides
from rovr_tpu.train import evaluate as jevaluate
from rovr_tpu.train import rl as jrl
from rovr_torch.config import from_dict
from rovr_torch.data import synthetic as tsynthetic
from rovr_torch.train import evaluate as tevaluate
from rovr_torch.train import rl as trl
from rovr_torch.utils.convert import module_params_from_jax, params_from_jax


@pytest.fixture(autouse=True, scope="module")
def _few_threads():
    """Small shapes: more intra-op threads only contend with the other test
    workers of the run."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


B = 2
FLOW = 64
ATTN = dict(attn_hidden_dim=32, attn_heads=2, attn_depth=2, attn_patch_tokens=2)
TOL = dict(rtol=1e-4, atol=1e-4)


@pytest.fixture(scope="module")
def pair():
    c = _tiny_config(batch_size=B)
    cj = c.replace(
        model=dataclasses.replace(c.model, **tiny_model_overrides(), **ATTN),
        rl=dataclasses.replace(c.rl, context_policy="attention"))
    ct = from_dict(dataclasses.asdict(cj))
    mods_j = jevaluate.make_modules(cj, dtype=jnp.float32)
    key = jax.random.PRNGKey(0)
    state_j = jrl.init_state(cj, mods_j.rovr, key)
    raft_j = jevaluate.init_raft_params(mods_j, key, size=FLOW)
    mods_t = tevaluate.make_modules(ct, dtype=torch.float32, device="cpu")
    h, w = cj.data.frame_size
    clips = tsynthetic.synthetic_clips(5, 0, B, cj.rl.vid_length, h, w)
    return dict(cj=cj, ct=ct, mods_j=mods_j, state_j=state_j, raft_j=raft_j,
                mods_t=mods_t, state_t=params_from_jax(state_j),
                raft_t=module_params_from_jax(raft_j), clips=clips)


def _gumbel(key, steps, rows, s):
    """The JAX rollout's per-step draws, (T, rows, S)."""
    out = []
    for _ in range(steps):
        key, _, k2, _ = jax.random.split(key, 4)
        out.append(np.asarray(jax.random.gumbel(k2, (rows, s), jnp.float32)))
    return torch.from_numpy(np.stack(out))


def _u8(x):
    return np.clip(np.asarray(x, np.float32) * 255.0 + 0.5, 0, 255).astype(np.uint8)


@pytest.mark.parametrize("recon_context", [False, True])
def test_sequential_baseline_matches_jax(pair, recon_context):
    """rollout(sequential_baseline=True), sampled with replayed noise:
    `experimental` within 1 LSB, the agentic path unchanged by it."""
    cj = pair["cj"].replace(rl=dataclasses.replace(
        pair["cj"].rl, sequential_baseline=True, recon_context=recon_context))
    ct = from_dict(dataclasses.asdict(cj))
    v, o, _ = pair["clips"]
    key = jax.random.PRNGKey(7)
    out_j = jax.jit(lambda st, v, o, k: jrl.rollout(st, pair["mods_j"].rovr, cj, v, o, k))(
        pair["state_j"], jnp.asarray(v), jnp.asarray(o), key)
    noise = _gumbel(key, cj.rl.time_steps, B, cj.rl.vid_length)
    out_t = trl.rollout(pair["state_t"], pair["mods_t"].rovr, ct, torch.from_numpy(v),
                        torch.from_numpy(o), gumbel=noise)
    np.testing.assert_array_equal(out_t.traj.actions.numpy(), np.asarray(out_j.traj.actions))
    for name in ("experimental", "reconstructed"):
        got, want = _u8(getattr(out_t, name).numpy()), _u8(getattr(out_j, name))
        diff = np.abs(got.astype(np.int16) - want.astype(np.int16)).max()
        assert diff <= 1, f"{name} differs by {diff} LSB"
    assert not np.array_equal(_u8(out_t.experimental.numpy()), _u8(out_t.reconstructed.numpy()))
    assert not np.array_equal(_u8(out_t.experimental.numpy()), _u8(v))
    ct_off = ct.replace(rl=dataclasses.replace(ct.rl, sequential_baseline=False))
    off = trl.rollout(pair["state_t"], pair["mods_t"].rovr, ct_off, torch.from_numpy(v),
                      torch.from_numpy(o), gumbel=noise)
    assert off.experimental is None
    np.testing.assert_array_equal(off.reconstructed.numpy(), out_t.reconstructed.numpy())


def test_eval_step_matches_jax(pair):
    batch = pair["clips"]
    want = jevaluate.eval_step(pair["state_j"], pair["raft_j"], pair["mods_j"], pair["cj"],
                               tuple(jnp.asarray(x) for x in batch), FLOW)
    got = tevaluate.eval_step(pair["state_t"], pair["raft_t"], pair["mods_t"], pair["ct"],
                              batch, FLOW)
    assert set(got) == set(want)
    for k in want:
        assert np.isfinite(float(got[k])), k
        np.testing.assert_allclose(float(got[k]), float(want[k]), err_msg=k, **TOL)
    assert float(got["Eval/psnr_agentic"]) != float(got["Eval/psnr_sequential"])
    no_masks = tevaluate.eval_step(pair["state_t"], pair["raft_t"], pair["mods_t"],
                                   pair["ct"], batch[:2], FLOW)
    assert set(no_masks) == {k for k in got if "masked" not in k and "exposure" not in k}


def test_eval_ci_step_matches_jax_with_replayed_noise(pair):
    draws = 2
    batch = pair["clips"]
    key = jax.random.PRNGKey(11)
    want = jevaluate.eval_ci_step(pair["state_j"], pair["mods_j"].rovr, pair["cj"],
                                  tuple(jnp.asarray(x) for x in batch), draws, key)
    noise = _gumbel(key, pair["cj"].rl.time_steps, draws * B, pair["cj"].rl.vid_length)
    got = tevaluate.eval_ci_step(pair["state_t"], pair["mods_t"].rovr, pair["ct"], batch,
                                 draws, gumbel=noise)
    assert set(got) == set(want) == {"greedy", "sampled"}
    for readout in want:
        assert set(got[readout]) == set(want[readout])
        for k, v in want[readout].items():
            assert tuple(got[readout][k].shape) == (B,)
            np.testing.assert_allclose(got[readout][k].numpy(), np.asarray(v),
                                       err_msg=f"{readout} {k}", **TOL)


def test_summarize_and_paired_delta_match_jax():
    rng = np.random.default_rng(0)
    a = rng.normal(size=40)
    b = a - 0.3 + 0.1 * rng.normal(size=40)
    for vals in (a, a[:2], [1.0, 2.0, 4.0, 3.0, 5.0]):
        got, want = tevaluate.summarize(vals), jevaluate.summarize(vals)
        assert got["n"] == want["n"]
        np.testing.assert_allclose([got["mean"], got["ci95"]], [want["mean"], want["ci95"]],
                                   rtol=1e-12)
    for x, y in ((a, b), (rng.normal(size=200), np.zeros(200))):
        got, want = tevaluate.paired_delta(x, y), jevaluate.paired_delta(x, y)
        assert got["separates"] == want["separates"]
        np.testing.assert_allclose([got["mean"], got["ci95"]], [want["mean"], want["ci95"]],
                                   rtol=1e-12)
    one = tevaluate.summarize([3.0])
    assert one["mean"] == 3.0 and one["ci95"] == float("inf")


def test_run_and_run_ci_on_the_host_source(pair, tmp_path):
    """`run` and `run_ci` end to end at tiny width: finite means, the random-weight
    marks, the t-interval summaries over every clip."""
    ct = pair["ct"].replace(run=dataclasses.replace(pair["ct"].run, run_dir=str(tmp_path)))
    host = trl.HostSyntheticSource(ct, B)
    means = tevaluate.run(ct, num_videos=B, flow_size=FLOW, source=host, device="cpu")
    assert all(np.isfinite(v) for v in means.values())
    assert means["Eval/metric_weights_random"] == 1.0
    with pytest.raises(ValueError, match="converted"):
        tevaluate.run(ct, num_videos=B, flow_size=FLOW, weights="converted", device="cpu")
    res = tevaluate.run_ci(ct, num_videos=B + 1, sample_draws=2, mods=pair["mods_t"],
                           state=pair["state_t"], source=host)
    assert res["n_clips"] == 2 * B
    for readout in ("greedy", "sampled"):
        for k, summ in res["summary"][readout].items():
            assert summ["n"] == 2 * B and np.isfinite(summ["mean"]), (readout, k)
    with pytest.raises(NotImplementedError, match="no textured clips"):
        trl.HostSyntheticSource(ct, B, data_texture=1.0)
