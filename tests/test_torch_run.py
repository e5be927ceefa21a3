"""The port's RL loop (`rl.run`, `run_resilient`), its checkpoints and
metrics, on the CPU at tiny width; and a train step with the RAFT spatio
signal against the JAX package.

By contract, since torch cannot replay `jax.random`: one iteration of `run`
equals `train_step` on the same clips with a generator seeded as `run`
seeds its own; a checkpoint restores bit for bit; a resumed run continues
`state.step`; `run_resilient` survives a data source that fails once;
metrics.jsonl holds the JAX package's record keys with finite values.
The spatio step (`log_spatio` and `use_spatio_reward`) replays the JAX
Gumbel draws and holds every metric, `Episode/spatio` among them, within
1e-4 of the JAX train step on the same weights; the flow magnitudes the
port logs beside spatio (`Episode/phi_*`) are held within 1e-4 of the JAX
package's RAFT over its own reconstruction, the original and the
corrupted clip.
"""

import dataclasses
import glob
import json
import math
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from __graft_entry__ import _tiny_config
from conftest import tiny_model_overrides
from rovr_tpu.models import raft as jraft
from rovr_tpu.train import rl as jrl
from rovr_torch.config import from_dict
from rovr_torch.data import synthetic as tsynthetic
from rovr_torch.train import rl as trl
from rovr_torch.utils import checkpoint as tckpt
from rovr_torch.utils.convert import params_from_jax


@pytest.fixture(autouse=True, scope="module")
def _few_threads():
    """Small shapes: more intra-op threads only contend with the other test
    workers of the run."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


B = 2


def _cfg(tmp_path, **rl_kw):
    c = _tiny_config(batch_size=B)
    cj = c.replace(model=dataclasses.replace(c.model, **tiny_model_overrides()),
                   rl=dataclasses.replace(c.rl, **rl_kw))
    ct = from_dict(dataclasses.asdict(cj))
    return cj, ct.replace(run=dataclasses.replace(ct.run, run_dir=str(tmp_path), seed=3))


class ClipSource:
    """`next(i)` -> (corrupted, original, masks); fails once at `fail_at`."""

    def __init__(self, cfg, fail_at=None):
        h, w = cfg.data.frame_size
        self.batches = [tsynthetic.synthetic_clips(40, i, B, cfg.rl.vid_length, h, w)
                        for i in range(3)]
        self.fail_at, self.calls = fail_at, 0

    def next(self, i):
        self.calls += 1
        if i == self.fail_at:
            self.fail_at = None
            raise OSError("the data source failed")
        return self.batches[i % len(self.batches)]


def _equal_trees(a, b):
    if isinstance(a, tuple) and hasattr(a, "_fields"):
        return all(_equal_trees(getattr(a, f), getattr(b, f)) for f in a._fields)
    if isinstance(a, dict):
        return set(a) == set(b) and all(_equal_trees(a[k], b[k]) for k in a)
    if isinstance(a, torch.Tensor):
        return a.dtype == b.dtype and torch.equal(a, b)
    return a == b


def _records(cfg):
    (path,) = glob.glob(os.path.join(cfg.run.run_dir, "rovr_rl", "*", "metrics.jsonl"))
    with open(path) as f:
        return [json.loads(line) for line in f]


def test_one_iteration_equals_train_step_and_checkpoints_round_trip(tmp_path):
    _, ct = _cfg(tmp_path)
    src = ClipSource(ct)
    got = trl.run(ct, iterations=1, source=src, device="cpu")

    mods = trl.make_modules(ct, device="cpu")
    state0 = trl.init_state(ct, mods, ct.run.seed)
    v, o, m = src.batches[0]
    want, metrics, _ = trl.train_step(state0, mods, ct, v, o, masks=m,
                                      generator=torch.Generator().manual_seed(ct.run.seed))
    assert got.step == want.step == 1
    assert _equal_trees(got, want)

    recs = _records(ct)
    assert {r["tag"] for r in recs} == set(metrics) and "Episode/exposure" in metrics
    assert all(set(r) == {"t", "tag", "value", "step"} and math.isfinite(r["value"])
               and r["step"] == 0 for r in recs)
    (ck,) = glob.glob(os.path.join(ct.run.run_dir, "rovr_rl", "*", "checkpoints"))
    assert tckpt.latest_checkpoint_dir(ct.run.run_dir, "rovr_rl") == ck
    mgr = tckpt.CheckpointManager(ck)
    assert mgr.latest_step() == 0 and sorted(os.listdir(ck)) == ["0"]
    assert _equal_trees(mgr.restore(template=want), got)
    plain = mgr.restore()
    assert isinstance(plain, dict) and plain["step"] == 1


def test_checkpoint_manager_cadence_keeps_three_and_restores_any_step(tmp_path):
    mgr = tckpt.CheckpointManager(str(tmp_path / "ck"), every=2)
    states = {i: {"w": torch.full((3,), float(i)), "step": i, "opt": None}
              for i in range(9)}
    saved = [i for i in range(9) if mgr.save(i, states[i])]
    mgr.wait()
    assert saved == [0, 2, 4, 6, 8]
    assert sorted(int(s) for s in os.listdir(mgr.directory)) == [4, 6, 8]  # max_to_keep 3
    assert _equal_trees(mgr.restore(6, template=states[6]), states[6])
    assert mgr.save(3, states[3], force=True)
    assert mgr.latest_step() == 8
    with pytest.raises(ValueError, match="shape"):
        mgr.restore(template={"w": torch.zeros(4), "step": 0, "opt": None})
    # a split restore needs the mesh the state is split over
    with pytest.raises(ValueError, match="mesh"):
        mgr.restore(shardings={"actor2_params": {"w": 0}})
    mgr.close()


def test_resume_continues_step_and_resilient_run_recovers(tmp_path):
    _, ct = _cfg(tmp_path / "a")
    first = trl.run(ct, iterations=2, source=ClipSource(ct), device="cpu")
    ck = tckpt.latest_checkpoint_dir(ct.run.run_dir, "rovr_rl")
    resumed_cfg = ct.replace(run=dataclasses.replace(ct.run, restore_from=ck))
    resumed = trl.run(resumed_cfg, iterations=1, source=ClipSource(ct), device="cpu")
    assert first.step == 2 and resumed.step == 3

    _, ct2 = _cfg(tmp_path / "b")
    src = ClipSource(ct2, fail_at=1)
    state = trl.run_resilient(ct2, iterations=2, source=src, max_restarts=1, device="cpu")
    # attempt 1 saved step 0 then failed; attempt 2 resumed from it and took 2 more
    assert state.step == 3 and src.calls == 4


def test_dataset_path_and_unported_options(tmp_path):
    _, ct = _cfg(tmp_path)
    v, o, _ = ClipSource(ct).batches[0]
    dataset = [(v[j], o[j]) for j in range(B)]
    state = trl.run(ct, dataset=dataset, iterations=1, device="cpu")
    assert state.step == 1 and "Episode/exposure" not in {r["tag"] for r in _records(ct)}
    short = [(v[j][:2], o[j][:2]) for j in range(B)]
    with pytest.raises(ValueError, match="frames"):
        trl.run(ct, dataset=short, iterations=1, device="cpu")
    # textured clips come from the default on-device source, with masks
    _, tex = _cfg(tmp_path / "textured")
    assert trl.run(tex, iterations=1, data_texture=1.0, device="cpu").step == 1
    assert "Episode/exposure" in {r["tag"] for r in _records(tex)}
    # pi1 with PPO on it: the run trains it and logs its losses
    _, p1 = _cfg(tmp_path / "pi1")
    p1 = p1.replace(rl=dataclasses.replace(p1.rl, use_policy1=True, ppo_policy1=True),
                    model=dataclasses.replace(p1.model, lstm_hidden_dim=32))
    state = trl.run(p1, iterations=1, device="cpu")
    assert state.step == 1 and state.actor1_opt["step"] == p1.rl.n_updates_per_ppo
    assert {"PPO/actor1_loss", "PPO/critic1_loss", "Episode/coverage"} <= \
        {r["tag"] for r in _records(p1)}


def test_spatio_train_step_matches_jax(tmp_path):
    cj, ct = _cfg(tmp_path, log_spatio=True, use_spatio_reward=True, spatio_flow_size=256)
    assert trl.resolved_flow_size(ct) == jrl.resolved_flow_size(cj) == 64
    mods_j = jrl.make_modules(cj, dtype=jnp.float32)
    state_j = jrl.init_state(cj, mods_j, jax.random.PRNGKey(0))
    mods_t = trl.make_modules(ct, dtype=torch.float32, device="cpu")
    state_t = params_from_jax(state_j)
    assert set(state_t.raft_params) == set(mods_t.raft.state_dict())
    v, o, _ = ClipSource(ct).batches[1]
    rng = jax.random.PRNGKey(5)
    s, t, n = cj.rl.vid_length, cj.rl.time_steps, cj.rl.n_updates_per_ppo
    k_roll, k_ppo = jax.random.split(rng)
    key, roll = k_roll, []
    for _ in range(t):
        key, _, k2, _ = jax.random.split(key, 4)
        roll.append(np.asarray(jax.random.gumbel(k2, (B, s), jnp.float32)))
    ppo = [np.asarray(jax.random.gumbel(k, (B * t, s), jnp.float32))
           for k in jax.random.split(k_ppo, n)]
    _, metrics_j, recon_j = jrl.train_step(state_j, mods_j, cj, jnp.asarray(v), jnp.asarray(o),
                                           rng)
    _, metrics_t, _ = trl.train_step(state_t, mods_t, ct, torch.from_numpy(v),
                                     torch.from_numpy(o), gumbel=(
                                         torch.from_numpy(np.stack(roll)),
                                         torch.from_numpy(np.stack(ppo))))
    phis = {"recon": recon_j, "org": jnp.asarray(o), "corrupted": jnp.asarray(v)}
    assert "Episode/spatio" in metrics_j and \
        set(metrics_t) == set(metrics_j) | {f"Episode/phi_{k}" for k in phis}
    for k in metrics_j:
        np.testing.assert_allclose(float(metrics_t[k]), float(metrics_j[k]), rtol=1e-4,
                                   atol=1e-4, err_msg=k)
    for k, clip in phis.items():
        flows = jraft.pairwise_flows(mods_j.raft, state_j.raft_params, clip,
                                     size=jrl.resolved_flow_size(cj))
        np.testing.assert_allclose(float(metrics_t[f"Episode/phi_{k}"]),
                                   float(jraft.total_flow_magnitude(flows)[0].mean()),
                                   rtol=1e-4, atol=1e-4, err_msg=k)
    no_raft = trl.make_modules(ct.replace(rl=dataclasses.replace(
        ct.rl, log_spatio=False, use_spatio_reward=False)), device="cpu")
    with pytest.raises(ValueError, match="raft"):
        trl.train_step(state_t._replace(raft_params=None), mods_t, ct, v, o)
    assert no_raft.raft is None


def test_init_state_plugs_in_given_params(tmp_path):
    """`init_state`'s warm-start arguments (what `run(init_params=...)`
    forwards): a given module's parameters replace its draws and no other
    module's; the backbone splice; a mismatched tree raises."""
    _, ct = _cfg(tmp_path)
    mods = trl.make_modules(ct, device="cpu")
    fresh = trl.init_state(ct, mods, 0)
    given = {k: torch.full_like(v, 0.5) for k, v in fresh.local_net_params.items()}
    bb = {k[len("backbone."):]: torch.ones_like(v) for k, v in fresh.vp_params.items()
          if k.startswith("backbone.")}
    st = trl.init_state(ct, mods, 0, local_net_params=given, vp_backbone_params=bb)
    assert _equal_trees(st.local_net_params, given)
    assert _equal_trees(st.lpips_params, fresh.lpips_params)
    assert _equal_trees(st.actor2_params, fresh.actor2_params)
    for k, v in st.vp_params.items():
        want = torch.ones_like(v) if k.startswith("backbone.") else fresh.vp_params[k]
        assert torch.equal(v, want), k
    with pytest.raises(ValueError, match="local_net_params"):
        trl.init_state(ct, mods, 0, local_net_params={"conv1.weight": torch.zeros(1)})
    with pytest.raises(ValueError, match="spatio"):
        trl.init_state(ct, mods, 0, raft_params={})
    state = trl.run(ct, iterations=1, source=ClipSource(ct), device="cpu",
                    init_params={"local_net_params": given})
    assert _equal_trees(state.local_net_params, given)  # frozen in RL


def test_metrics_writer_records_and_png_fallback(tmp_path):
    from rovr_torch.utils.logging import MetricsWriter

    w = MetricsWriter(str(tmp_path), use_tensorboard=False)
    w.scalars({"a/b": torch.tensor(1.5), "c": 2}, 7)
    w.text("note", "hello", 7)
    w.image("Episode/strip", np.full((4, 6, 3), 0.5, np.float32), 7)
    w.close()
    with open(tmp_path / "metrics.jsonl") as f:
        recs = [json.loads(line) for line in f]
    assert [(r["tag"], r.get("value"), r.get("text"), r["step"]) for r in recs] == [
        ("a/b", 1.5, None, 7), ("c", 2.0, None, 7), ("note", None, "hello", 7)]
    png = tmp_path / "images" / "Episode_strip_00000007.png"
    assert png.read_bytes()[:8] == b"\x89PNG\r\n\x1a\n"
