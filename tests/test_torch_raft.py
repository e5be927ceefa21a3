"""The port's RAFT-small (rovr_torch/models/raft.py) against
rovr_tpu.models.raft at float32 on the CPU, on the JAX random init carried
over by `utils.convert`: the correlation pyramid and the lookup alone within
1e-5 (coordinates pushed past every edge), the flow of a 64x64 pair with 2
refinement iterations within 1e-4 * max|flow|, and `pairwise_flows` the
same whatever its chunk of pairs (within 1e-5 * max|flow|). Then RAFT's
spans and counters: a recorded rollout with the spatio signal opens
`rovr/rollout/spatio` once with RAFT's three spans in it once per RAFT
call, and `pairwise_flows.pairs`/`.calls` count its pairs and chunks; one
without it opens none of them."""

import dataclasses
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from conftest import tiny_model_overrides
from rovr_tpu.models import raft as jraft
from rovr_torch.config import Config
from rovr_torch.models import raft as traft
from rovr_torch.ops.metrics import spatio_reward
from rovr_torch.train import rl as trl
from rovr_torch.utils import profiling
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


# ----------------------------------------------------------- spans, counters

RAFT_SPANS = ("rovr/raft/encode", "rovr/raft/corr", "rovr/raft/update")


def _spans_by_parent(spans):
    """{(parent name or None, name): count} of the recorded spans."""
    out = {}
    for sp in spans:
        key = (None if sp.parent is None else spans[sp.parent].name, sp.name)
        out[key] = out.get(key, 0) + 1
    return out


def test_pairwise_flows_counts_its_pairs_and_chunks(nets):
    _, _, tm = nets
    video = torch.rand(1, 4, SIZE, SIZE, 3, generator=torch.Generator().manual_seed(4))
    fn = traft.pairwise_flows
    before = fn.pairs, fn.calls
    with profiling.recording() as spans:
        traft.pairwise_flows(tm, video, SIZE, chunk=2)
    assert (fn.pairs - before[0], fn.calls - before[1]) == (3, 2)
    assert _spans_by_parent(spans) == {(None, name): 2 for name in RAFT_SPANS}


def _tiny_rollout(b, s, size=32, **rl):
    """A tiny attention-free configuration with the RL flags `rl`, its f32
    modules and state, and a (video, org) pair of clips."""
    c = Config()
    cfg = c.replace(
        model=dataclasses.replace(c.model, **tiny_model_overrides(), pn2_num_frames=s,
                                  canvas_size=96, canvas_tiles_per_row=3),
        data=dataclasses.replace(c.data, frame_size=(size, size), vid_length=s),
        rl=dataclasses.replace(c.rl, vid_length=s, time_steps=4, batch_size=b, **rl))
    mods = trl.make_modules(cfg, dtype=torch.float32, device="cpu")
    state = trl.init_state(cfg, mods, seed=0)
    g = torch.Generator().manual_seed(5)
    video, org = (torch.rand(b, s, size, size, 3, generator=g) for _ in range(2))
    return cfg, mods, state, video, org


@pytest.mark.parametrize("spatio", [True, False])
def test_a_rollout_opens_the_spatio_spans_and_counts_raft(spatio):
    """With `use_spatio_reward` the rollout opens `rovr/rollout/spatio` once
    under `rovr/rollout`, RAFT's three spans once per RAFT call under it,
    and sends 3 * B * (S - 1) pairs through RAFT in 3 * ceil(B * (S - 1) /
    PAIR_CHUNK) calls; without it, none of these."""
    b, s = 2, 5
    cfg, mods, state, video, org = _tiny_rollout(b, s, use_spatio_reward=spatio)
    fn = traft.pairwise_flows
    before = fn.pairs, fn.calls
    with profiling.recording() as spans:
        out = trl.rollout(state, mods, cfg, video, org, generator=torch.Generator().manual_seed(0))
    pairs = b * (s - 1)
    calls = 3 * math.ceil(pairs / traft.PAIR_CHUNK) if spatio else 0
    assert (fn.pairs - before[0], fn.calls - before[1]) == (3 * pairs if spatio else 0, calls)
    got = {k: n for k, n in _spans_by_parent(spans).items()
           if k[1] == "rovr/rollout/spatio" or k[1] in RAFT_SPANS}
    want = {("rovr/rollout", "rovr/rollout/spatio"): 1,
            **{("rovr/rollout/spatio", name): calls for name in RAFT_SPANS}} if spatio else {}
    assert got == want
    assert ("Episode/spatio" in out.metrics) == spatio


def test_a_spatio_rollout_logs_the_flow_magnitudes_spatio_is_taken_from():
    """With `log_spatio` the rollout logs, beside `Episode/spatio`, the mean
    over the clips of RAFT's total flow magnitude of the reconstruction,
    the original and the corrupted clip, and spatio is taken from those
    per-clip magnitudes."""
    cfg, mods, state, video, org = _tiny_rollout(3, 4, log_spatio=True)
    out = trl.rollout(state, mods, cfg, video, org, generator=torch.Generator().manual_seed(0))
    size = trl.resolved_flow_size(cfg)
    phis = {k: traft.total_flow_magnitude(traft.pairwise_flows(mods.raft, clip, size))[0]
            for k, clip in (("recon", out.reconstructed), ("org", org), ("corrupted", video))}
    assert {k for k in out.metrics if k.startswith("Episode/phi_")} == \
        {f"Episode/phi_{k}" for k in phis}
    for k, phi in phis.items():
        assert torch.allclose(out.metrics[f"Episode/phi_{k}"], phi.mean(), rtol=1e-6)
    spatio = spatio_reward(phis["recon"], phis["org"], phis["corrupted"], cfg.rl.spatio_scale)
    assert torch.allclose(out.metrics["Episode/spatio"], spatio.mean(), rtol=1e-5, atol=1e-5)
