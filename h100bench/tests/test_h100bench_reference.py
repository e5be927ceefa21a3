"""The benchmark's plain reference against the port's CPU path at test size.

Both sides compute in float32 from the same drawn weights, clips and
Gumbel noise. The rollout (the port's pairs, their logprobs, the
reconstruction, the rewards), one PPO epoch (its losses, Adam's first
moments and the parameters), and a served batch (pairs and uint8 frames)
must agree, for the canvas and the attention policy. Tolerances: f32 sums
taken in another order (1e-5 on values of order one); Adam's first step
moves each element by lr * sign(g), so the parameters are held within
2 * lr, the moments (0.1 * g) within 1e-3 of their network's largest.
"""

import pytest
import torch

from conftest import tiny_config
import program
import traffic
import weights
from reference.episode import Ref, adam_state

SEED = 2 ** 33 + 17


def _setup(policy, epochs=1):
    cfg = tiny_config(policy)
    cfg["rl"]["n_updates_per_ppo"] = epochs
    c = program.config(cfg)
    mods = program.modules(c, "cpu", torch.float32)
    w = weights.draw(program.module_dict(mods), SEED, "cpu")
    mix = traffic.load("train_step")
    mix.update(box=[8, 12], pool=1)
    item = traffic.pool(mix, cfg, SEED, "cpu")[0]
    return cfg, c, mods, w, item


@pytest.mark.parametrize("policy", ["canvas", "attention"])
def test_rollout_and_ppo_match_the_port(policy):
    cfg, c, mods, w, item = _setup(policy)
    pairs = []
    with program.record_pairs(mods, pairs):
        st, metrics, recon = program.train_step(program.state(w), mods, c, item["video"],
                                                item["org"], item["gumbel"])
    acs = torch.stack([a for a, _ in pairs])
    ref = Ref(cfg, w)
    r = ref.rollout(item["video"].float() / 255, item["org"].float() / 255, item["gumbel"][0], acs)
    assert torch.allclose(r["logp"], torch.stack([lp for _, lp in pairs]), atol=1e-5)
    assert r["choice_gap"].max().item() < 1e-5          # the port picked the top pair
    assert torch.allclose(r["recon"], recon, atol=1e-5)
    for k in ("lpips_loss", "mse_loss", "mean_reward"):
        assert r["metrics"][k].item() == pytest.approx(metrics[f"Episode/{k}"].item(),
                                                       rel=1e-5, abs=1e-7)
    p = ref.ppo(r, item["gumbel"][1], {n: adam_state(w[n]) for n in ("actor2", "critic2")})
    for k in ("actor_loss", "critic_loss"):
        assert p[k].item() == pytest.approx(metrics[f"PPO/{k}"].item(), rel=1e-5, abs=1e-6)
    lr = cfg["rl"]["actor_lr"]
    for n in ("actor2", "critic2"):
        mine, theirs = p["opt"][n]["m"], getattr(st, f"{n}_opt")["exp_avg"]
        top = max(v.abs().max().item() for v in mine.values())
        for k in mine:
            assert (mine[k] - theirs[k]).abs().max().item() <= 1e-3 * top + 1e-9, k
            assert (p[n][k] - getattr(st, f"{n}_params")[k]).abs().max().item() <= 2 * lr, k


@pytest.mark.parametrize("policy", ["canvas", "attention"])
def test_served_batch_matches_the_port(policy):
    cfg, c, mods, w, item = _setup(policy)
    (frames, pairs), = list(program.serve(c, program.state(w), mods, [item["video"].numpy()]))
    r = Ref(cfg, w).rollout(item["video"].float() / 255)
    assert torch.equal(r["actions"], torch.from_numpy(pairs))
    u8 = traffic.to_u8(r["recon"])
    assert (u8.int() - torch.from_numpy(frames).int()).abs().max().item() <= 1


def test_fp8_rounding_is_coarser_than_bf16():
    x = torch.randn(4096, generator=torch.Generator().manual_seed(0))
    from reference.model import Precision
    fp8 = (Precision("fp8").q(x) - x).abs().max().item()
    bf16 = (x.bfloat16().float() - x).abs().max().item()
    assert Precision("f32").q(x) is not None and fp8 > 4 * bf16
