"""Reward bookkeeping (rovr_tpu/ops/rewards.py): rewards-to-go and the
normalized advantage."""

from __future__ import annotations

import torch

from rovr_torch.parallel import collectives


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
                         eps: float = 1e-10, mesh=None) -> torch.Tensor:
    """A = rtg - V (V detached), standardized with the unbiased std. With a
    data `mesh` the mean and the std are the global batch's (ddof 1 over the
    global count)."""
    a = rtgs - values.detach()
    if mesh is None:
        std = a.std(correction=1) if a.numel() > 1 else a.new_zeros(())
        return (a - a.mean()) / (std + eps)
    n = a.numel() * mesh.size
    mean = collectives.psum(a.sum(), mesh) / n
    var = collectives.psum(((a - mean) ** 2).sum(), mesh) / (n - 1) if n > 1 else 0.0 * mean
    return (a - mean) / (torch.sqrt(var) + eps)
