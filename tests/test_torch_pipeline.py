"""The four-stage pipeline (rovr_torch/train/pipeline.py) on the CPU at
tiny widths: its record has the JAX `run`'s keys, stage 5 (π₁) included,
and each stage's parameters are threaded into the next by argument.

The stages themselves are held against the JAX package in their own files
(test_torch_pretrain.py, test_torch_imitation.py, test_torch_train*.py,
test_torch_eval.py); here RAFT's input is cut to 64^2 (`evaluate.run`'s
flow_size) to keep the held-out eval short.
"""

import dataclasses
import functools
import json
import math

import numpy as np
import pytest
import torch

from conftest import tiny_model_overrides
from rovr_tpu.train import pipeline as jpipeline
from rovr_torch.train import evaluate, imitation, pipeline, pretrain_local, rl

JAX_RECORD_KEYS = {  # what rovr_tpu/train/pipeline.run writes, stages 1-5 and 3b
    "config", "pretrain", "imitation", "rl", "rl_from_random", "eval_trained",
    "eval_warm_start_only", "eval_random_policy", "eval_ppo_from_random", "ppo_ablation",
    "eval_ci", "ablation_ci", "wall_seconds", "policy1", "policy1_summary",
    "policy1_control",
}
JAX_POLICY1_SUMMARY_KEYS = {  # rovr_tpu/train/pipeline.py stage 5
    "coverage_first10", "coverage_last10", "return_first10", "return_last10",
    "coverage_random_expected", "coverage_random_measured", "separates_from_random",
    "verdict",
}


@pytest.fixture(autouse=True, scope="module")
def _few_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def _tiny(tmp_path):
    c = pipeline.default_config(20, 2)
    return c.replace(
        model=dataclasses.replace(c.model, **tiny_model_overrides(), feature_dim=64,
                                  attn_hidden_dim=32, attn_heads=2, attn_patch_tokens=2,
                                  lstm_hidden_dim=32),
        rl=dataclasses.replace(c.rl, time_steps=3, n_updates_per_ppo=1),
        pretrain=dataclasses.replace(c.pretrain, batch_size=2),
        run=dataclasses.replace(c.run, run_dir=str(tmp_path)))


def test_default_config_matches_jax():
    for args in ((), (12, 3, 192)):
        assert dataclasses.asdict(pipeline.default_config(*args)) == \
            dataclasses.asdict(jpipeline.default_config(*args))


def test_stage5_raises_before_any_stage(tmp_path, monkeypatch):
    """Stage 5 is ported: asking for it refuses nothing up front, and the
    stages run in order from stage 1 (stopped there by this test)."""
    class Stop(Exception):
        pass

    def stage1(*a, **kw):
        raise Stop

    monkeypatch.setattr(pretrain_local, "run", stage1)
    with pytest.raises(Stop):
        pipeline.run(_tiny(tmp_path), policy1_iterations=1, device="cpu")


def test_pipeline_threads_each_stage_into_the_next(tmp_path, monkeypatch):
    seen = {"rl": [], "init": []}

    def spy(mod, name, key):
        real = getattr(mod, name)

        def wrapped(*a, **kw):
            out = real(*a, **kw)
            seen.setdefault(key, []).append((kw, out))
            return out
        monkeypatch.setattr(mod, name, wrapped)

    spy(pretrain_local, "run", "pretrain")
    spy(imitation, "run", "imitation")
    spy(rl, "run", "rl")
    spy(rl, "init_state", "init")
    monkeypatch.setattr(evaluate, "run", functools.partial(evaluate.run, flow_size=64))
    out = tmp_path / "record.json"
    rec = pipeline.run(_tiny(tmp_path), pretrain_steps=2, imitation_steps=2, rl_iterations=1,
                       ppo_from_random_iterations=1, eval_videos=2, eval_ci_clips=2,
                       eval_ci_draws=2, pretrain_clips=4, out_path=str(out), device="cpu",
                       policy1_iterations=1)
    assert set(rec) == JAX_RECORD_KEYS
    with open(out) as f:
        assert set(json.load(f)) == JAX_RECORD_KEYS

    (pre_kw, state_p), = seen["pretrain"]
    video, orig, pos = pre_kw["data"]
    assert video.shape == orig.shape == (4, 20, 160, 160, 3) and pos.shape[:2] == (4, 20)
    (_, state_i), = seen["imitation"]
    assert state_p.step == 2 and state_i.step == 2
    (kw_rl, rl_state), (kw_rnd, _), (kw_p1, p1_state) = seen["rl"]
    warm = kw_rl["init_params"]
    assert warm["local_net_params"] is state_p.params
    assert warm["lpips_params"] is state_p.lpips_params
    assert warm["vp_params"] is state_i.vp_params
    assert warm["actor2_params"] is state_i.pn2_params
    assert "actor2_params" not in kw_rnd["init_params"]
    assert kw_rnd["init_params"]["local_net_params"] is state_p.params
    for name in ("local_net_params", "vp_params"):
        for k, v in getattr(rl_state, name).items():  # frozen through PPO
            assert torch.equal(v, warm[name][k]), (name, k)
    # stage 5 from stage 3's trained π₂, π₁ fresh; its control: a fresh π₁
    # (seed + 6) on the same warm start
    assert kw_p1["init_params"]["actor2_params"] is rl_state.actor2_params
    assert "actor1_params" not in kw_p1["init_params"]
    assert p1_state.step == 1 and p1_state.actor1_opt["step"] == 1
    ctrl_kw, ctrl = seen["init"][-1]
    assert ctrl_kw["actor2_params"] is rl_state.actor2_params
    w = "enc.0.Conv_0.weight"
    assert not torch.equal(ctrl.actor1_params[w], p1_state.actor1_params[w])
    # the eval arms: the random-policy control and the warm start alone (the
    # last two calls are stage 5's run and its control)
    evals = [kw for kw, _ in seen["init"][-4:-2]]
    assert "actor2_params" not in evals[0] and evals[1]["actor2_params"] is state_i.pn2_params

    assert [r["step"] for r in rec["pretrain"]] == [0] and len(rec["rl"]) == 1
    assert rec["config"]["ppo_from_random_iterations"] == 1
    assert all(math.isfinite(v) for v in rec["eval_trained"].values())
    assert rec["eval_ci"]["trained"]["n_clips"] == 2
    for readout in ("greedy", "sampled"):
        row = rec["ablation_ci"][readout]["masked_psnr_agentic"]
        assert {"trained_vs_random", "ppo_on_warm_start", "warm_start_vs_random",
                "ppo_from_random_vs_random", "trained_agentic_vs_sequential"} == set(row)
    assert set(rec["ppo_ablation"]) == {"ppo_on_warm_start", "ppo_from_random_vs_random",
                                        "warm_start_vs_random"}
    assert np.isfinite(rec["wall_seconds"])
    assert len(rec["policy1"]) == 1 and "PPO/actor1_loss" in rec["policy1"][0]
    assert set(rec["policy1_summary"]) == JAX_POLICY1_SUMMARY_KEYS
    ctl = rec["policy1_control"]
    assert ctl["n_clips"] == 2
    for key in ("coverage", "return"):
        assert set(ctl[key]) == {"trained", "random_policy1", "delta"}
    assert 0 < ctl["coverage"]["trained"]["mean"] <= 1
