"""Data parallelism in the port (rovr_torch/parallel, rl.make_sharded_train_step,
infer.reconstruct_clips(mesh=), DevicePrefetcher(sharding=), checkpoints
under a mesh) on the CPU: two processes over gloo, spawned with a file store
under tmp_path, against the single-process port on the global batch.

The JAX sharded step is `train_step` on the global batch (GSPMD), so every
statistic over the batch axis is the global batch's. The port's ranks each
take B/2 clips; BatchStatNorm (the canvas policy's trunk and pi1),
the critic's standardisation, the advantage and the metrics reduce over
both ranks, and the gradients are averaged before every Adam step. Given
the same (global) Gumbel noise the sharded step must equal the
single-process step on all four clips.

Tolerances (f32 sums in another order, as in tests/test_torch_train.py):
metrics 1e-4; reconstructions 1e-4; updated parameters within 1e-5 on at
least 99% of entries and everywhere within 2*lr*n_updates (Adam turns the
sign of a near-zero gradient into a +-lr step); Adam first moments (one PPO
epoch, so they are 0.1 x the first gradients) within 1e-4 of their tensor's
largest entry + 1e-6 on at least 99% of entries, and everywhere within
1e-3 of it: pi1's first conv sums ~400k products through its batch-stat
norms (measured: 3.9e-4 of the largest entry there, ~1e-5 elsewhere). One
epoch, because a second one starts from parameters that the first one's
+-lr sign flips already set apart.
Across ranks the parameters and Adam states are bitwise equal. Serving:
uint8 within 1 LSB and equal actions. The canvas runs at 160^2, where the policy's trunk features are not empty, so the
global BatchStatNorm's forward and backward reach the loss.
"""

import dataclasses
import re

import numpy as np
import pytest
import torch
import torch.distributed as dist

from __graft_entry__ import _tiny_config
from conftest import tiny_model_overrides
from rovr_torch import infer
from rovr_torch.config import from_dict
from rovr_torch.data import synthetic
from rovr_torch.models.layers import BatchStatNorm, standardize
from rovr_torch.ops.rewards import normalized_advantage
from rovr_torch.parallel import collectives, launch
from rovr_torch.parallel.mesh import make_mesh
from rovr_torch.train import rl

import torch_dp_workers

WORLD, B = 2, 4
ATTN = dict(attn_hidden_dim=32, attn_heads=2, attn_depth=2, attn_patch_tokens=2)
CANVAS = dict(canvas_size=160, canvas_tile=32, canvas_tiles_per_row=5)


def _cfg(policy="canvas", policy1=False, **model):
    c = _tiny_config(batch_size=B)
    c = c.replace(
        model=dataclasses.replace(c.model, **tiny_model_overrides(), **ATTN, **CANVAS,
                                  lstm_hidden_dim=16, **model),
        rl=dataclasses.replace(c.rl, context_policy=policy, use_policy1=policy1,
                               ppo_policy1=policy1, n_updates_per_ppo=1))
    return from_dict(dataclasses.asdict(c))


def _gumbel(rng, shape):
    u = rng.uniform(np.finfo(np.float32).tiny, 1.0, shape).astype(np.float32)
    return torch.from_numpy(-np.log(-np.log(u)))


def _case(cfg, seed, **extra):
    rl_cfg, s = cfg.rl, cfg.rl.vid_length
    clips = [synthetic.synthetic_batch(100 * seed + j, s, 64, 64) for j in range(B)]
    video, org, masks = (torch.from_numpy(np.stack([c[i] for c in clips])) for i in (0, 1, 2))
    rng = np.random.default_rng(seed)
    t = rl_cfg.time_steps
    case = dict(cfg=cfg, video=video, org=org, masks=masks,
                gumbel=(_gumbel(rng, (t, B, s)),
                        _gumbel(rng, (rl_cfg.n_updates_per_ppo, B * t, s))), **extra)
    if rl_cfg.use_policy1:
        case["gumbel1"] = _gumbel(rng, (t, B, cfg.model.pn1_num_frames))
    return case


@pytest.fixture(scope="module")
def dp(tmp_path_factory):
    """The cases, the single-process port's results on the global batch, and
    what each of the two ranks saw."""
    torch.set_num_threads(2)
    tmp = tmp_path_factory.mktemp("dp")
    cases = {
        "canvas": _case(_cfg(), 1, serve=True, checkpoint=str(tmp / "ckpt")),
        "attention": _case(_cfg("attention"), 2),
        "policy1": _case(_cfg(policy1=True), 3),
        "moe": _case(_cfg("attention", attn_moe_experts=2, attn_moe_capacity=0.5), 4),
    }
    inputs = tmp / "inputs.pt"
    torch.save({"train": cases}, inputs)
    launch.spawn(torch_dp_workers.run_all, WORLD, "cpu", args=(str(inputs), str(tmp)),
                 init_method=f"file://{tmp / 'store'}", threads=2)
    ranks = [torch.load(tmp / f"rank{r}.pt", weights_only=False) for r in range(WORLD)]
    ref = {}
    for name, case in cases.items():
        cfg = case["cfg"]
        mods = rl.make_modules(cfg, dtype=torch.float32, device="cpu")
        state = rl.init_state(cfg, mods, seed=0)
        new, metrics, recon = rl.train_step(state, mods, cfg, case["video"], case["org"],
                                            gumbel=case["gumbel"], masks=case["masks"],
                                            gumbel1=case.get("gumbel1"))
        ref[name] = dict(state=new, before=state, metrics=metrics, recon=recon)
        if case.get("serve"):
            u8 = (case["video"] * 255.0 + 0.5).clamp(0, 255).to(torch.uint8)
            ref[name]["serve"] = next(infer.reconstruct_clips(cfg, state, mods, [u8]))
    return dict(cases=cases, ranks=ranks, ref=ref)


# pi1's conv biases that feed a batch-stat norm: the norm cancels them, so
# their exact gradient is 0
NORMED_BIAS = re.compile(r"(Conv_0|ConvTranspose_0|head1|head2)\.bias$")
TRAINED = {"canvas": ("actor2", "critic2"), "attention": ("actor2", "critic2"),
           "policy1": ("actor2", "critic2", "actor1", "critic1"),
           "moe": ("actor2", "critic2")}


@pytest.mark.parametrize("name", sorted(TRAINED))
def test_sharded_step_equals_the_global_batch_step(dp, name):
    ref, cfg = dp["ref"][name], dp["cases"][name]["cfg"]
    for r, got in enumerate(dp["ranks"]):
        got = got[name]
        assert set(got["metrics"]) == set(ref["metrics"])
        for k, v in ref["metrics"].items():
            np.testing.assert_allclose(got["metrics"][k], float(v), rtol=1e-4, atol=1e-4,
                                       err_msg=f"rank {r} {k}")
        np.testing.assert_allclose(got["recon"].numpy(), ref["recon"][got["rows"]].numpy(),
                                   rtol=1e-4, atol=1e-4)
        bound = 2 * cfg.rl.actor_lr * cfg.rl.n_updates_per_ppo
        for field in TRAINED[name]:
            mine, want = (getattr(s, f"{field}_params") for s in (got["state"], ref["state"]))
            before = getattr(ref["before"], f"{field}_params")
            assert max(float((mine[k] - before[k]).abs().max()) for k in mine) > 0, field
            diff = torch.cat([(mine[k] - want[k]).abs().flatten() for k in want])
            assert float(diff.max()) <= bound, (field, float(diff.max()))
            assert float((diff <= 1e-5).float().mean()) >= 0.99, field
            opt, opt_ref = (getattr(s, f"{field}_opt") for s in (got["state"], ref["state"]))
            assert opt["step"] == opt_ref["step"] == cfg.rl.n_updates_per_ppo
            top = max(float(v.abs().max()) for v in opt_ref["exp_avg"].values())
            for k in want:
                a, b = opt["exp_avg"][k], opt_ref["exp_avg"][k]
                if NORMED_BIAS.search(k):   # exact gradient 0: f32 noise on both sides
                    assert max(float(a.abs().max()), float(b.abs().max())) <= 1e-2 * top, k
                    continue
                assert float((a - b).abs().max()) <= 1e-3 * top + 1e-6, (field, k)


def test_ranks_hold_bitwise_identical_states(dp):
    r0, r1 = dp["ranks"]
    for name, fields in TRAINED.items():
        for field in fields:
            for part in (f"{field}_params",):
                a, b = getattr(r0[name]["state"], part), getattr(r1[name]["state"], part)
                for k in a:
                    assert torch.equal(a[k], b[k]), (name, part, k)
            for moment in ("exp_avg", "exp_avg_sq"):
                a = getattr(r0[name]["state"], f"{field}_opt")[moment]
                b = getattr(r1[name]["state"], f"{field}_opt")[moment]
                for k in a:
                    assert torch.equal(a[k], b[k]), (name, field, moment, k)
        assert r0[name]["metrics"] == r1[name]["metrics"], name
    # each rank reconstructed its own half of the batch
    assert (r0["canvas"]["rows"], r1["canvas"]["rows"]) == (slice(0, 2), slice(2, 4))


def test_mesh_serving_equals_single_device(dp):
    want_recon, want_actions = dp["ref"]["canvas"]["serve"]
    for got in dp["ranks"]:
        (recon, actions), = got["canvas"]["serve"]
        assert recon.shape == want_recon.shape and recon.dtype == np.uint8
        assert np.abs(recon.astype(int) - want_recon.astype(int)).max() <= 1
        np.testing.assert_array_equal(actions, want_actions)


def test_prefetcher_shards_concatenate_to_the_items(dp):
    items = torch_dp_workers.Items()
    r0, r1 = (got["prefetch"] for got in dp["ranks"])
    assert len(r0) == len(r1) == len(items)
    for i, (a, b) in enumerate(zip(r0, r1)):
        for f, want in enumerate(items[i]):
            assert a[f].shape[0] == b[f].shape[0] == 3
            assert torch.equal(torch.cat([a[f], b[f]]), torch.as_tensor(want))


def test_checkpoint_under_the_mesh_restores_on_every_rank(dp):
    for got in dp["ranks"]:
        canvas = got["canvas"]
        assert canvas["checkpoint_files"] == ["0"]   # one write, rank 0's
        restored, trained = canvas["restored"], canvas["state"]
        assert restored.step == trained.step == 1
        for field in ("actor2_params", "critic2_params", "vp_params"):
            a, b = getattr(restored, field), getattr(trained, field)
            assert all(torch.equal(a[k], b[k]) for k in a), field
    a, b = (got["canvas"]["restored"].actor2_opt["exp_avg"] for got in dp["ranks"])
    assert all(torch.equal(a[k], b[k]) for k in a)


def test_moe_under_a_mesh_raises(dp):
    """The MoE under a data mesh (capacity 0.5: tokens dropped) equals the
    global-batch step (test_sharded_step_equals_the_global_batch_step[moe]):
    its capacity and slots are the global batch's, from one all-gather of
    the shards' expert counts per MoE call. Only modules not built on the
    mesh raise."""
    want = dp["ref"]["moe"]["state"].actor2_params["block0.moe_ff.w1"]
    for got in dp["ranks"]:
        moe = got["moe"]
        assert moe["calls"].get("all_gather", 0) > 0
        assert torch.allclose(moe["state"].actor2_params["block0.moe_ff.w1"], want,
                              rtol=0, atol=2 * dp["cases"]["moe"]["cfg"].rl.actor_lr)
        assert got["moe_unbound"] is not None and "mesh" in got["moe_unbound"]


def test_collectives_over_gloo(dp):
    x = [torch.arange(4.0) + 10 * r for r in range(WORLD)]
    for r, got in enumerate(dp["ranks"]):
        c = got["collectives"]
        assert torch.equal(c["psum"], x[0] + x[1])
        assert torch.equal(c["pmean"], (x[0] + x[1]) / 2)
        assert torch.equal(c["all_gather"], torch.stack(x))
        assert torch.equal(c["stacked"], torch.stack(x))
        total = torch.arange(8.0) * 1 + torch.arange(8.0) * 2
        assert torch.equal(c["reduce_scatter"], total[4 * r:4 * r + 4])
        assert torch.equal(c["ring"], x[(r - 1) % WORLD])
        assert c["axis_index"] == r
        # d/dg of sum(pmean(g) * [1, 2]) over both ranks' losses: psum's
        # backward all-reduces, so each rank holds the sum over ranks / 2
        assert torch.equal(c["pmean_grad"], torch.tensor([1.0, 2.0]))
        assert "gloo" in c["wrong_device"]
        # model_parallel = the world: a (1, 2) grid, rank r at model index r
        grid = c["refusals"]["model_parallel"]
        assert grid["shape"] == {"data": 1, "model": WORLD} and grid["index"] == (0, r)
        assert torch.equal(grid["ring"], torch.tensor([float((r - 1) % WORLD)]))
        assert c["refusals"]["grid"].startswith("ValueError")
        assert c["refusals"]["data_parallel"].startswith("ValueError")
        # every train step went through the group: batch statistics, the
        # advantage, the gradient means and the metrics
        before, after = got["calls_before"], got["calls"]
        assert after["all_reduce"] - before.get("all_reduce", 0) > 3 * 2 * 2


def test_world_size_one_is_a_real_mesh(tmp_path):
    """One gloo process in this process: the collectives still run through
    the group (counted), and nothing changes the values."""
    dist.init_process_group("gloo", init_method=f"file://{tmp_path / 'store'}",
                            world_size=1, rank=0)
    try:
        mesh = make_mesh()
        assert (mesh.size, mesh.rank, mesh.device.type, mesh.backend) == (1, 0, "cpu", "gloo")
        before = collectives.CALLS["all_reduce"]
        x = torch.randn(6, 3)
        assert torch.equal(collectives.psum(x, mesh), x)
        # batch statistics and the advantage over a world of one agree with
        # the local ones to f32 rounding (sums / n against means)
        norm = BatchStatNorm(3)
        y_local = norm(x[:, :, None, None])
        with collectives.global_batch(mesh):
            y_mesh = norm(x[:, :, None, None])
        torch.testing.assert_close(y_mesh, y_local, rtol=1e-5, atol=1e-6)
        torch.testing.assert_close(standardize(x, 0, 1e-3, mesh=mesh),
                                   standardize(x, 0, 1e-3), rtol=1e-5, atol=1e-6)
        torch.testing.assert_close(normalized_advantage(x[:, 0], x[:, 1], mesh=mesh),
                                   normalized_advantage(x[:, 0], x[:, 1]),
                                   rtol=1e-5, atol=1e-6)
        assert collectives.CALLS["all_reduce"] - before == 6   # 1 + 1 + 2 + 2
        assert collectives.current_mesh() is None
    finally:
        dist.destroy_process_group()


def test_without_a_mesh_nothing_changes():
    """No mesh: BatchStatNorm, standardize and the advantage compute what
    they computed before the mesh existed, bit for bit."""
    torch.manual_seed(0)
    x = torch.randn(5, 4, 3, 3)
    norm = BatchStatNorm(4)
    x32 = x.float()
    mean = x32.mean((0, 2, 3), keepdim=True)
    var = (x32 * x32).mean((0, 2, 3), keepdim=True) - mean * mean
    assert torch.equal(norm(x), (x32 - mean) * torch.rsqrt(var + 1e-5))
    a = torch.randn(7)
    assert torch.equal(normalized_advantage(a, torch.zeros(7)),
                       (a - a.mean()) / (a.std(correction=1) + 1e-10))
    assert collectives.current_mesh() is None
