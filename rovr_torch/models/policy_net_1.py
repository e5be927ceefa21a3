"""Gumbel-softmax helpers of rovr_tpu/models/policy_net_1.py. PolicyNet1
itself (the pi1 frame-selection policy) is not in the port yet.

The noise is an input: pass it as a tensor (tests replay the JAX package's
draws) or give a `torch.Generator` to draw it. torch and JAX draw different
numbers from the same seed."""

from __future__ import annotations

from typing import Optional

import torch


def gumbel_noise(shape, generator: Optional[torch.Generator] = None,
                 device=None) -> torch.Tensor:
    """Standard Gumbel noise, float32: -log(-log(u)), u ~ U[tiny, 1)."""
    u = torch.rand(shape, generator=generator, device=device, dtype=torch.float32)
    u = u.clamp_min(torch.finfo(torch.float32).tiny)
    return -torch.log(-torch.log(u))


def _noise(logits, noise, generator):
    if noise is None:
        noise = gumbel_noise(logits.shape, generator, logits.device)
    return noise.to(logits.dtype)


def gumbel_softmax(logits: torch.Tensor, temperature: float,
                   noise: Optional[torch.Tensor] = None,
                   generator: Optional[torch.Generator] = None) -> torch.Tensor:
    """softmax((logits + Gumbel noise) / tau) (F.gumbel_softmax, hard=False)."""
    return torch.softmax((logits + _noise(logits, noise, generator)) / temperature, -1)


def gumbel_log_softmax(logits: torch.Tensor, temperature: float,
                       noise: Optional[torch.Tensor] = None,
                       generator: Optional[torch.Generator] = None) -> torch.Tensor:
    """log_softmax((logits + Gumbel noise) / tau), float32: the stable twin
    of log(gumbel_softmax(...)), finite for every finite logit."""
    logits = logits.float()
    return torch.log_softmax((logits + _noise(logits, noise, generator)) / temperature, -1)
