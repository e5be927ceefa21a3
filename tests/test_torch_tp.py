"""Tensor parallelism in the port (rovr_torch/parallel/tp.py) on the CPU over
gloo processes: the attention policy's heads and FFN columns split over
the model axis, against the single-process port and the JAX package's
rules.

  * the TP train step at (data, model) = (1, 2) and (2, 2), and TP + ring +
    expert parallelism on the one model axis, against the single-process
    `train_step` on the global batch (which tests/test_torch_train.py holds
    against JAX), with tests/test_torch_data_parallel.py's tolerances, the
    state gathered whole;
  * the gathered state bitwise equal on every rank, and a round trip through
    CheckpointManager(mesh=, shardings=) (saved whole, restored split)
    bitwise;
  * the Adam moments split as their parameters (the JAX
    test_optimizer_mirrors_get_same_specs), and the split axes the JAX
    `_RULES` name, in the port's layouts;
  * the pipeline and tensor parallelism on one model axis raise.
"""

import dataclasses

import pytest
import torch
from jax.sharding import PartitionSpec

from rovr_tpu.parallel import tp as jtp
from rovr_torch.models.policy_attention import AttentionContextPolicy
from rovr_torch.parallel import tp
from rovr_torch.parallel.mesh import Mesh

import torch_model_workers as workers
from test_torch_data_parallel import _case, _cfg

GRIDS = [(1, 2), (2, 2)]
IDS = ["1x2", "2x2"]


@pytest.fixture(scope="module")
def tp_runs(tmp_path_factory):
    torch.set_num_threads(2)
    cfg = _cfg("attention")
    composed_cfg = _cfg("attention", attn_impl="ring", attn_moe_experts=2)
    step, composed = _case(cfg, 5), _case(composed_cfg, 6)
    runs = {}
    for grid in GRIDS:
        tmp = tmp_path_factory.mktemp(f"tp{grid[0]}{grid[1]}")
        runs[grid] = workers.spawn_cases(dict(
            step=dict(kind="train", tp=True, checkpoint=str(tmp / "ckpt"), **step),
            composed=dict(kind="train", tp=True, **composed)), tmp, *grid)
    ref_composed = composed_cfg.replace(
        model=dataclasses.replace(composed_cfg.model, attn_impl="auto"))
    return dict(runs=runs, cfg=cfg, ref=workers.single_step(cfg, step),
                composed_cfg=composed_cfg,
                ref_composed=workers.single_step(ref_composed, composed))


@pytest.mark.parametrize("grid", GRIDS, ids=IDS)
def test_tp_step_equals_the_global_batch_step(tp_runs, grid):
    for got in tp_runs["runs"][grid]:
        workers.assert_step_matches(got["step"], tp_runs["ref"], tp_runs["cfg"])
        # the row-parallel sums and the split inputs' gradients: model all-reduces
        assert got["step"]["calls"].get("model:all_reduce", 0) > 0


@pytest.mark.parametrize("grid", GRIDS, ids=IDS)
def test_tp_ring_and_experts_on_one_model_axis(tp_runs, grid):
    for got in tp_runs["runs"][grid]:
        workers.assert_step_matches(got["composed"], tp_runs["ref_composed"],
                                    tp_runs["composed_cfg"])
        calls = got["composed"]["calls"]
        assert calls.get("model:send_recv", 0) > 0 and calls.get("model:all_gather", 0) > 0


@pytest.mark.parametrize("grid", GRIDS, ids=IDS)
def test_gathered_state_is_bitwise_equal_and_round_trips(tp_runs, grid):
    ranks = tp_runs["runs"][grid]
    first = ranks[0]["step"]["state"]
    for got in ranks:
        state = got["step"]["state"]
        for field in ("actor2_params", "critic2_params"):
            assert all(torch.equal(state[field][k], first[field][k]) for k in first[field])
        for field in ("actor2_opt", "critic2_opt"):
            for moment in ("exp_avg", "exp_avg_sq"):
                assert all(torch.equal(state[field][moment][k], first[field][moment][k])
                           for k in first[field][moment])
        assert got["step"]["restored_equal"]
        assert got["step"]["checkpoint_files"] == ["0"]   # one write, the first rank's


def test_optimizer_mirrors_get_same_specs(tp_runs):
    shardings = tp_runs["runs"][(1, 2)][0]["step"]["shardings"]
    assert set(shardings) == {"actor2_params", "critic2_params", "actor2_opt", "critic2_opt"}
    for field in ("actor2", "critic2"):
        assert shardings[f"{field}_params"] == shardings[f"{field}_opt"]
    want = {}
    for i in range(2):
        mha = f"block{i}.SelfAttentionBlock_0.MultiHeadAttention_0"
        want.update({f"{mha}.{n}.weight": 1 for n in "qkv"})
        want.update({f"{mha}.{n}.bias": 0 for n in "qkv"})
        ff = f"block{i}.FeedForwardBlock_0"
        want.update({f"{mha}.out.weight": 0, f"{ff}.Dense_0.weight": 0,
                     f"{ff}.Dense_0.bias": 0, f"{ff}.Dense_1.weight": 1})
    assert shardings["actor2_params"] == want


def test_rules_are_the_jax_rules_in_the_port_layouts():
    """Each JAX rule (flax kernels (in, out), DenseGeneral's (in..., out...))
    names the same split as the port's rule for the same suffix (torch
    Linear weights are (out, in)); the out bias and Dense_1's stay whole."""
    def axis(spec: PartitionSpec) -> int:
        return list(spec).index(jtp.MODEL_AXIS)

    port = {(m, "kernel" if p == "weight" else p): d for (m, p), d in tp._RULES.items()}
    assert set(port) == set(jtp._RULES)
    for (m, p), spec in jtp._RULES.items():
        flax_axis = axis(spec)
        linear_weight = m.startswith("Dense_") and p == "kernel"
        assert port[(m, p)] == (1 - flax_axis if linear_weight else flax_axis), (m, p)


def test_pipeline_and_tensor_parallel_on_one_axis_raise():
    mesh = Mesh(None, 1, 0, torch.device("cpu"), "gloo", None, 2, 0)
    with pytest.raises(ValueError, match="pipeline and tensor parallelism"):
        AttentionContextPolicy(num_frames=5, feature_dim=16, hidden_dim=32, num_heads=2,
                               pp_microbatches=2, mesh=mesh, tensor_parallel=True)
    with pytest.raises(ValueError, match="tensor_parallel"):
        tp.make_tp_train_step(mesh, workers.rl.make_modules(
            _cfg("attention"), dtype=torch.float32, device="cpu"), _cfg("attention"))
