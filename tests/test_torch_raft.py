"""The port's RAFT-small (rovr_torch/models/raft.py) against
rovr_tpu.models.raft at float32 on the CPU, on the JAX random init carried
over by `utils.convert`: the correlation pyramid and the lookup alone within
1e-5 (coordinates pushed past every edge), the flow of a 64x64 pair with 2
refinement iterations within 1e-4 * max|flow|, and `pairwise_flows` the
same whatever its chunk of pairs (within 1e-5 * max|flow|)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rovr_tpu.models import raft as jraft
from rovr_torch.models import raft as traft
from rovr_torch.utils.convert import module_params_from_jax


@pytest.fixture(autouse=True, scope="module")
def _few_threads():
    """Small shapes: more intra-op threads only contend with the other test
    workers of the run."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


SIZE = 64


@pytest.fixture(scope="module")
def nets():
    jm = jraft.RAFTSmall(iters=2, dtype=jnp.float32)
    x = jnp.zeros((1, SIZE, SIZE, 3))
    params = jax.jit(jm.init)(jax.random.PRNGKey(0), x, x)["params"]
    tm = traft.RAFTSmall(iters=2, dtype=torch.float32).requires_grad_(False)
    tm.load_state_dict(module_params_from_jax(params), strict=True)
    return jm, params, tm


def _frames(n, seed):
    rng = np.random.default_rng(seed)
    a = rng.uniform(size=(n, SIZE, SIZE, 3)).astype(np.float32)
    return a, np.clip(np.roll(a, 3, axis=2) + 0.02 * rng.standard_normal(a.shape), 0, 1
                      ).astype(np.float32)


def test_params_map_onto_the_port_module(nets):
    """One `update` subtree (no per-iteration axis), InstanceNorm scale/bias,
    the blocks' projections: every flax leaf is a port parameter and back."""
    _, params, tm = nets
    assert "update" in params and set(params["update"]) == {"motion", "gru", "flow_head"}
    assert params["update"]["gru"]["convz"]["kernel"].shape == (3, 3, 96 + 146, 96)
    assert set(params["fnet"]["norm1"]) == {"scale", "bias"}
    sd = module_params_from_jax(params)
    assert set(sd) == set(tm.state_dict())
    assert "cnet.norm1.weight" not in sd and "fnet.layer2_0.norm_down.weight" in sd


def test_correlation_pyramid_and_lookup_out_of_range():
    rng = np.random.default_rng(1)
    f1 = rng.standard_normal((2, 7, 9, 16)).astype(np.float32)   # odd edges crop
    f2 = rng.standard_normal((2, 7, 9, 16)).astype(np.float32)
    pj = jraft.correlation_pyramid(jnp.asarray(f1), jnp.asarray(f2))
    pt = traft.correlation_pyramid(torch.from_numpy(f1), torch.from_numpy(f2))
    assert [tuple(p.shape) for p in pt] == [p.shape for p in pj]
    for a, b in zip(pt, pj):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-5, atol=1e-5)
    # coordinates inside, on and past every edge of each level, fractional
    coords = rng.uniform(-6.0, 14.0, size=(2, 7, 9, 2)).astype(np.float32)
    coords[0, 0, 0] = (-3.5, -3.5)
    coords[1, -1, -1] = (12.25, 9.75)
    lj = jraft.lookup_corr(pj, jnp.asarray(coords))
    lt = traft.lookup_corr(pt, torch.from_numpy(coords))
    assert tuple(lt.shape) == lj.shape == (2, 7, 9, 4 * 49)
    np.testing.assert_allclose(lt.numpy(), np.asarray(lj), rtol=1e-5, atol=1e-5)
    assert float(np.abs(np.asarray(lj)).min()) == 0.0  # some taps fell outside


def test_flow_matches_jax(nets):
    jm, params, tm = nets
    a, b = _frames(2, 2)
    fj = np.asarray(jax.jit(jm.apply)({"params": params}, jnp.asarray(a), jnp.asarray(b)))
    ft = tm(torch.from_numpy(a), torch.from_numpy(b)).numpy()
    assert ft.shape == fj.shape == (2, SIZE, SIZE, 2)
    scale = np.abs(fj).max()
    assert scale > 0
    np.testing.assert_allclose(ft, fj, rtol=0, atol=1e-4 * scale)


def test_pairwise_flows_chunks_and_magnitudes(nets):
    jm, params, tm = nets
    rng = np.random.default_rng(3)
    video = rng.uniform(size=(1, 4, 80, 72, 3)).astype(np.float32)  # shrunk to 64
    fj = jax.jit(lambda p, v: jraft.pairwise_flows(jm, p, v, size=SIZE))(
        params, jnp.asarray(video))
    v = torch.from_numpy(video)
    whole = traft.pairwise_flows(tm, v, SIZE, chunk=None)
    chunked = traft.pairwise_flows(tm, v, SIZE, chunk=2)
    assert tuple(whole.shape) == fj.shape == (1, 3, SIZE, SIZE, 2)
    # the same per-pair math; the CPU's convolutions pick their algorithm by
    # batch size, so the last bits may differ
    np.testing.assert_allclose(chunked.numpy(), whole.numpy(), rtol=0,
                               atol=1e-5 * float(whole.abs().max()))
    np.testing.assert_allclose(whole.numpy(), np.asarray(fj), rtol=0,
                               atol=1e-4 * float(np.abs(np.asarray(fj)).max()))
    tot_t, per_t = traft.total_flow_magnitude(whole)
    tot_j, per_j = jraft.total_flow_magnitude(fj)
    np.testing.assert_allclose(per_t.numpy(), np.asarray(per_j), rtol=1e-4)
    np.testing.assert_allclose(tot_t.numpy(), np.asarray(tot_j), rtol=1e-4)
