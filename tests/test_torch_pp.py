"""Pipeline parallelism in the port (rovr_torch/parallel/pp.py, the attention
policy's pp_microbatches) on the CPU over gloo processes, against the JAX
package's GPipe on a CPU mesh of the same (data, model) shape and against
the single-process port. Shapes after tests/test_pp.py; rtol/atol 2e-4 for
the JAX comparisons (tests/test_pp.py's policy bound), gradients 5e-5
(its gradient bound).

  * `pipeline_layers` of 4 dense tanh layers in 2 stages at (1, 2) and
    (2, 2): the default microbatches (S) and a request that does not
    divide the local batch; the layers' gradients of sum(y^2); bf16
    activations through a stage that widens to f32 come back bf16;
  * `stack_layers` refuses layers that do not split into the stages;
  * the PP policy's masked_logits (depth 4, 2 microbatches) against the JAX
    PP policy at (1, 2), and at (2, 2) with a 2-expert MoE whose capacity is
    the microbatch's tokens on each data shard, as in JAX, with dropped
    tokens;
  * the config's PP train step (depth 2, 2 microbatches) at (1, 2) and
    (2, 2) against the single-process `train_step` on the global batch,
    with tests/test_torch_data_parallel.py's tolerances.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import Mesh

from rovr_tpu.models.policy_attention import AttentionContextPolicy as JPolicy
from rovr_tpu.parallel.pp import pipeline_layers as jax_pipeline_layers
from rovr_torch.parallel.pp import stack_layers
from rovr_torch.utils.convert import module_params_from_jax

import torch_model_workers as workers
from test_torch_data_parallel import _case, _cfg

GRIDS = [(1, 2), (2, 2)]
IDS = ["1x2", "2x2"]
TOL = dict(rtol=2e-4, atol=2e-4)
MICROBATCHES = (0, 4)   # the default (S); 4 does not divide (2, 2)'s local batch of 6
POLICY = dict(num_frames=4, feature_dim=16, hidden_dim=16, num_heads=2, depth=4,
              patch_tokens=1, dtype=jnp.float32)
POLICIES = {"dense": {}, "moe": dict(moe_experts=2, moe_capacity=0.5)}
POLICY_GRIDS = {"dense": (1, 2), "moe": (2, 2)}   # the MoE's capacity per data shard


def _jmesh(grid):
    return Mesh(np.asarray(jax.devices()[:grid[0] * grid[1]]).reshape(grid),
                ("data", "model"))


def _layers(seed, d, n=4):
    rng = np.random.default_rng(seed)
    return [dict(w=(0.3 * rng.standard_normal((d, d))).astype(np.float32),
                 b=(0.1 * rng.standard_normal(d)).astype(np.float32)) for _ in range(n)]


def _apply_dense(p, x):
    return jnp.tanh(x @ p["w"] + p["b"])


def _policy_case(name, grid):
    rng = np.random.default_rng(11)
    feats = rng.standard_normal((4, 4, 16)).astype(np.float32)
    tgt = np.arange(4)
    kw = dict(POLICY, **POLICIES[name])
    params = jax.jit(JPolicy(**kw).init)(jax.random.PRNGKey(7), jnp.asarray(feats),
                                         jnp.asarray(tgt), jax.random.PRNGKey(0))["params"]
    pol = JPolicy(**kw, mesh=_jmesh(grid), pp_microbatches=2)
    want = jax.jit(lambda p, f, t: pol.apply({"params": p}, f, t, method=JPolicy.masked_logits))(
        params, jnp.asarray(feats), jnp.asarray(tgt))
    port_kw = dict(kw, dtype=torch.float32, pp_microbatches=2)
    return dict(kind="policy_pp", kw=port_kw, params=module_params_from_jax(params),
                feats=feats, tgt=tgt.astype(np.int64)), np.asarray(want)


@pytest.fixture(scope="module")
def pp(tmp_path_factory):
    torch.set_num_threads(2)
    layers = _layers(0, 8)
    x = np.random.default_rng(1).standard_normal((12, 8)).astype(np.float32)
    cfg = _cfg("attention", attn_pp_microbatches=2)
    step = dict(kind="train", **_case(cfg, 8))
    runs, wants = {}, {}
    for grid in GRIDS:
        cases = dict(fn=dict(kind="pipeline_fn", layers=layers, x=x,
                             microbatches=MICROBATCHES), step=step)
        for name in POLICIES:
            if POLICY_GRIDS[name] == grid:
                cases[name], wants[name] = _policy_case(name, grid)
        runs[grid] = workers.spawn_cases(cases, tmp_path_factory.mktemp(
            f"pp{grid[0]}{grid[1]}"), *grid)
    ref_cfg = cfg.replace(model=dataclasses.replace(cfg.model, attn_pp_microbatches=0))
    return dict(runs=runs, wants=wants, layers=layers, x=x, cfg=cfg,
                ref=workers.single_step(ref_cfg, step))


def _rows(ranks, grid, key, field):
    dp, mp = grid
    return np.concatenate([ranks[d * mp][key][field].numpy() for d in range(dp)])


@pytest.mark.parametrize("grid", GRIDS, ids=IDS)
def test_pipeline_layers_matches_jax(pp, grid):
    layers = [{k: jnp.asarray(v) for k, v in p.items()} for p in pp["layers"]]
    mesh, x = _jmesh(grid), jnp.asarray(pp["x"])
    ranks = pp["runs"][grid]
    y, vjp = jax.vjp(jax.jit(lambda ls: jax_pipeline_layers(_apply_dense, ls, x, mesh)),
                     layers)
    wants = {0: y, 4: jax.jit(lambda ls: jax_pipeline_layers(
        _apply_dense, ls, x, mesh, microbatches=4))(layers)}
    for mb in MICROBATCHES:
        got = np.concatenate([ranks[d * grid[1]]["fn"]["outs"][mb].numpy()
                              for d in range(grid[0])])
        np.testing.assert_allclose(got, np.asarray(wants[mb]), err_msg=f"microbatches {mb}",
                                   **TOL)
    grads, = vjp(2 * y)   # d sum(y^2)
    for i, g in enumerate(grads):
        for k in ("w", "b"):
            # every model rank holds the whole gradient; the data shards' parts add up
            got = sum(ranks[d * grid[1]]["fn"]["grads"][i][k] for d in range(grid[0]))
            for m in range(grid[1]):
                assert torch.equal(ranks[m]["fn"]["grads"][i][k], ranks[0]["fn"]["grads"][i][k])
            np.testing.assert_allclose(got.numpy(), np.asarray(g[k]), rtol=5e-5, atol=5e-5)


@pytest.mark.parametrize("grid", GRIDS, ids=IDS)
def test_mixed_precision_stage_comes_back_in_the_input_dtype(pp, grid):
    want = pp["x"]
    for p in pp["layers"]:   # the sequential twin with the boundary rounding
        y = jnp.asarray(want, jnp.bfloat16) @ jnp.asarray(p["w"], jnp.bfloat16)
        want = np.asarray(jnp.tanh(y.astype(jnp.float32) + p["b"]).astype(jnp.bfloat16),
                          np.float32)
    ranks = pp["runs"][grid]
    assert ranks[0]["fn"]["mixed_dtype"] == "torch.bfloat16"
    got = np.concatenate([ranks[d * grid[1]]["fn"]["mixed"].float().numpy()
                          for d in range(grid[0])])
    np.testing.assert_allclose(got, want, rtol=2e-2, atol=2e-2)


def test_stack_layers_validates():
    layers = [{k: torch.from_numpy(v) for k, v in p.items()} for p in _layers(2, 4, 3)]
    with pytest.raises(ValueError):
        stack_layers(layers, 2)
    assert stack_layers(layers, 3)["w"].shape == (3, 1, 4, 4)


@pytest.mark.parametrize("name", sorted(POLICIES))
def test_pp_policy_matches_the_jax_pp_policy(pp, name):
    grid = POLICY_GRIDS[name]
    got = _rows(pp["runs"][grid], grid, name, "logits")
    np.testing.assert_allclose(got, pp["wants"][name], **TOL)


@pytest.mark.parametrize("grid", GRIDS, ids=IDS)
def test_pp_train_step_equals_the_global_batch_step(pp, grid):
    for got in pp["runs"][grid]:
        workers.assert_step_matches(got["step"], pp["ref"], pp["cfg"])
        calls = got["step"]["calls"]
        assert calls.get("model:send_recv", 0) > 0 and calls.get("model:all_reduce", 0) > 0
