"""Expert parallelism in the port (rovr_torch/models/moe.py on a mesh) on the
CPU over gloo processes, against the JAX package's MoEFeedForward on the
global batch and the single-process port.

  * the MoE at (data, model) = (1, 2) and (2, 2), each model rank owning 2
    of 4 experts, against the JAX module on the whole batch: the output and
    `moe_aux` 2e-5 relative / 2e-6 absolute (tests/test_torch_moe.py's
    bounds), with ample capacity and with dropped tokens (routing global over
    the data axis: the capacity from the global N, the slots in the global
    token order); the input and parameter gradients of sum(y * w) against
    jax.grad, 1e-4 relative / 1e-6 absolute (the other gradient tests' bound),
    the data shards' parts summed and the experts' parts joined;
  * the config's train step with 2 experts at (1, 2) and (2, 2) against the
    single-process `train_step` on the global batch, with
    tests/test_torch_data_parallel.py's tolerances.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rovr_tpu.models import moe as jmoe
from rovr_torch.models import moe as tmoe
from rovr_torch.utils.convert import module_params_from_jax

import torch_model_workers as workers
from test_torch_data_parallel import _case, _cfg

GRIDS = [(1, 2), (2, 2)]
IDS = ["1x2", "2x2"]
FACTORS = {"ample": 1.25, "drops": 0.5}
TOL = dict(rtol=2e-5, atol=2e-6)
GRAD_TOL = dict(rtol=1e-4, atol=1e-6)


def _moe_case(factor, seed):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((4, 8, 32)).astype(np.float32)
    w = rng.standard_normal((4, 8, 32)).astype(np.float32)
    jm = jmoe.MoEFeedForward(hidden_dim=32, num_experts=4, capacity_factor=factor,
                             dtype=jnp.float32)
    params = jm.init(jax.random.PRNGKey(seed), jnp.asarray(x))["params"]
    # non-trivial norms and biases, so every parameter's gradient is exercised
    params = jax.tree_util.tree_map(
        lambda a: a + 0.1 * jnp.asarray(rng.standard_normal(a.shape), jnp.float32), params)
    case = dict(kind="moe", x=x, w=w, params=module_params_from_jax(params),
                kw=dict(hidden_dim=32, num_experts=4, capacity_factor=factor,
                        dtype=torch.float32))
    y, inter = jax.jit(lambda p, x: jm.apply({"params": p}, x, mutable=["intermediates"]))(
        params, jnp.asarray(x))
    gx, gp = jax.jit(jax.grad(lambda x, p: jnp.sum(jm.apply({"params": p}, x) * w),
                              argnums=(0, 1)))(jnp.asarray(x), params)
    want = dict(y=np.asarray(y), aux=float(inter["intermediates"]["moe_aux"][0]),
                gx=np.asarray(gx), grads={k: v.numpy() for k, v in
                                          module_params_from_jax(gp).items()})
    return case, want


@pytest.fixture(scope="module")
def ep(tmp_path_factory):
    torch.set_num_threads(2)
    cases, wants = {}, {}
    for i, (name, factor) in enumerate(FACTORS.items()):
        cases[name], wants[name] = _moe_case(factor, i)
    cfg = _cfg("attention", attn_moe_experts=2)
    cases["step"] = dict(kind="train", **_case(cfg, 7))
    runs = {grid: workers.spawn_cases(cases, tmp_path_factory.mktemp(
        f"ep{grid[0]}{grid[1]}"), *grid) for grid in GRIDS}
    return dict(runs=runs, wants=wants, cfg=cfg, ref=workers.single_step(cfg, cases["step"]))


@pytest.mark.parametrize("name", sorted(FACTORS))
@pytest.mark.parametrize("grid", GRIDS, ids=IDS)
def test_expert_parallel_moe_matches_jax_on_the_global_batch(ep, grid, name):
    want = ep["wants"][name]
    ranks = ep["runs"][grid]
    dp, mp = grid
    ys = [ranks[d * mp][name]["y"].numpy() for d in range(dp)]
    np.testing.assert_allclose(np.concatenate(ys), want["y"], **TOL)
    gx = np.concatenate([ranks[d * mp][name]["gx"].numpy() for d in range(dp)])
    np.testing.assert_allclose(gx, want["gx"], **GRAD_TOL)
    for got in ranks:
        np.testing.assert_allclose(got[name]["aux"], want["aux"], **TOL)
    specs = ranks[0][name]["specs"]
    assert specs == {"w1": 0, "b1": 0, "w2": 0, "b2": 0}
    for k, g in want["grads"].items():
        # each data shard's part summed; the experts' parts joined along axis 0
        parts = [sum(ranks[d * mp + m][name]["grads"][k] for d in range(dp))
                 for m in range(mp)]
        got = torch.cat(parts).numpy() if k in specs else parts[0].numpy()
        np.testing.assert_allclose(got, g, err_msg=k, **GRAD_TOL)


def test_drops_happen_and_capacity_is_global(ep):
    """At capacity factor 0.5 some tokens are dropped (their delta is 0);
    routing each data shard on its own (its own capacity and slots) would
    keep others, so the (2, 2) match above needs the global routing."""
    want = ep["wants"]["drops"]["y"]
    y = want.reshape(-1, 32)
    assert 0 < int((np.abs(y).max(1) == 0).sum()) < y.shape[0]
    case, _ = _moe_case(FACTORS["drops"], 1)
    local = tmoe.MoEFeedForward(**case["kw"])
    local.load_state_dict(case["params"], strict=True)
    with torch.no_grad():
        halves = np.concatenate([local(torch.from_numpy(h)).numpy()
                                 for h in np.split(case["x"], 2)])
    assert np.abs(halves - want).max() > 1e-3


@pytest.mark.parametrize("grid", GRIDS, ids=IDS)
def test_ep_train_step_equals_the_global_batch_step(ep, grid):
    for got in ep["runs"][grid]:
        workers.assert_step_matches(got["step"], ep["ref"], ep["cfg"])
        assert got["step"]["shardings"]["actor2_params"]["block0.moe_ff.w1"] == 0
