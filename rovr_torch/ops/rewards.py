"""Reward bookkeeping (rovr_tpu/ops/rewards.py): rewards-to-go and the
normalized advantage."""

from __future__ import annotations

import torch


def rewards_to_go(rewards: torch.Tensor, gamma: float = 1.0) -> torch.Tensor:
    """Reverse discounted cumulative sum along axis 0.

    rewards: (T,) or (T, B). Returns the same shape."""
    out = torch.empty_like(rewards)
    carry = torch.zeros_like(rewards[0])
    for t in range(rewards.shape[0] - 1, -1, -1):
        carry = rewards[t] + gamma * carry
        out[t] = carry
    return out


def normalized_advantage(rtgs: torch.Tensor, values: torch.Tensor,
                         eps: float = 1e-10) -> torch.Tensor:
    """A = rtg - V (V detached), standardized with the unbiased std."""
    a = rtgs - values.detach()
    std = a.std(correction=1) if a.numel() > 1 else a.new_zeros(())
    return (a - a.mean()) / (std + eps)
