"""PPO-clip objective (rovr_tpu/ops/ppo.py): ratio = exp(curr - old);
surrogate = min(ratio A, clip(ratio, 1 +- clip) A); actor loss =
-mean(surrogate); critic loss = MSE(V, rtg)."""

from __future__ import annotations

import torch


def ppo_clip_actor_loss(curr_logprob: torch.Tensor, old_logprob: torch.Tensor,
                        advantages: torch.Tensor, clip: float = 0.2) -> torch.Tensor:
    """-mean(min(r A, clip(r) A)). The log-ratio is bounded at +-20 before
    exp: fresh-Gumbel logprobs can be hundreds of nats from the behaviour
    sample, and e^+-20 is far outside the clip interval anyway."""
    ratio = torch.exp(torch.clamp(curr_logprob - old_logprob, -20.0, 20.0))
    l1 = ratio * advantages
    l2 = torch.clamp(ratio, 1.0 - clip, 1.0 + clip) * advantages
    return -torch.minimum(l1, l2).mean()


def critic_loss(values: torch.Tensor, rtgs: torch.Tensor) -> torch.Tensor:
    """MSE(V, rtg)."""
    return ((values - rtgs) ** 2).mean()
