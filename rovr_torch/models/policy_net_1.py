"""The frame-selection policy pi1 / V1 (rovr_tpu/models/policy_net_1.py):
which frame to reconstruct next, read from the state canvas and the
ActionLSTM's history token.

A 4-level UNet (ConvBlock encoders with 2x2 max pools between them, three
UpConvBlock + ConvBlock decoders with skips) over cat([canvas, token]), two
1x1 head convs with norms, ReLUs and max pools, a flatten, a per-sample
standardization (unbiased std, no eps), then a float32 `fc_final` to
`num_frames` logits (actor) or one value (critic).

`valid_frames` puts -1e9 on the logits past it, so sampling never picks a
frame the clip does not have. `exact_logprob` (the PPO-on-pi1 mode) gives
the noise-free log_softmax(logits)[action], the exact probability of a
Gumbel-max sample; without it the log-probability is that of the noised
softmax, as the reference computes it.

The noise is an input: pass it as a tensor `(B, num_frames)` (tests replay
the JAX package's draws) or give a `torch.Generator` to draw it. torch and
JAX draw different numbers from the same seed.

Layout: the public methods take NHWC canvases (B, C, C, 1), as the JAX
package's; the UNet runs on their NCHW view.
"""

from __future__ import annotations

from typing import Optional, Sequence, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from rovr_torch.models.layers import (
    BatchStatNorm, Conv2d, ConvBlock, UpConvBlock, max_pool, reference_tensor,
    standardize,
)


class PolicyNet1(nn.Module):
    def __init__(self, num_frames: int = 25,
                 channels: Sequence[int] = (32, 64, 128, 256),
                 temperature: float = 0.5, is_critic: bool = False,
                 dtype: torch.dtype = torch.bfloat16,
                 valid_frames: Optional[int] = None, exact_logprob: bool = False,
                 per_sample_stats: bool = False, canvas_size: int = 160):
        super().__init__()
        c1, c2, c3, c4 = channels
        self.num_frames = num_frames
        self.temperature = temperature
        self.is_critic = is_critic
        self.dtype = dtype
        self.valid_frames = valid_frames
        self.exact_logprob = exact_logprob
        kw = dict(dtype=dtype, per_sample_stats=per_sample_stats)
        self.enc = nn.ModuleList(ConvBlock(i, o, **kw) for i, o in zip(
            (2, c1, c2, c3), (c1, c2, c3, c4)))
        self.up = nn.ModuleList(UpConvBlock(i, o, **kw) for i, o in zip(
            (c4, c3, c2), (c3, c2, c1)))
        self.dec = nn.ModuleList(ConvBlock(2 * o, o, **kw) for o in (c3, c2, c1))
        self.head1 = Conv2d(c1, 3, 1, compute_dtype=dtype)
        self.head1_norm = BatchStatNorm(3, dtype=dtype, per_sample=per_sample_stats)
        self.head2 = Conv2d(3, 1, 1, compute_dtype=dtype)
        self.head2_norm = BatchStatNorm(1, dtype=dtype, per_sample=per_sample_stats)
        # float32 (flax's Dense without a dtype sees the f32 standardized
        # features); the flatten is the canvas after the head's two pools
        self.fc_final = nn.Linear((canvas_size // 4) ** 2, 1 if is_critic else num_frames)

    def _unet(self, x: torch.Tensor) -> torch.Tensor:
        x1 = self.enc[0](x)
        x2 = self.enc[1](max_pool(x1, (2, 2)))
        x3 = self.enc[2](max_pool(x2, (2, 2)))
        x4 = self.enc[3](max_pool(x3, (2, 2)))
        y = self.up[0](x4)
        y = self.dec[0](torch.cat([y, x3], 1))
        y = self.up[1](y)
        y = self.dec[1](torch.cat([y, x2], 1))
        y = self.up[2](y)
        y = self.dec[2](torch.cat([y, x1], 1))
        y = F.relu(self.head1_norm(self.head1(y)))
        y = F.relu(self.head2_norm(self.head2(max_pool(y, (2, 2)))))
        return max_pool(y, (2, 2))

    def logits(self, image: torch.Tensor, context: torch.Tensor) -> torch.Tensor:
        """image (B, C, C, 1) canvas, context (B, C, C, 1) history token ->
        (B, num_frames) float32 (the critic: (B, 1))."""
        x = torch.cat([image, context], -1).to(self.dtype).permute(0, 3, 1, 2)
        y = self._unet(x).permute(0, 2, 3, 1)          # NHWC, as the JAX flatten
        feat = standardize(y.reshape(x.shape[0], -1).float(), 1, eps=0.0)
        return self.fc_final(feat)

    def _mask_invalid(self, logits: torch.Tensor) -> torch.Tensor:
        """-1e9 on the logits past valid_frames (none when it is None or
        covers the head)."""
        if self.valid_frames is None or self.valid_frames >= self.num_frames:
            return logits
        ok = torch.arange(self.num_frames, device=logits.device) < self.valid_frames
        return torch.where(ok, logits, torch.full_like(logits, -1e9))

    @torch.no_grad()
    def act(self, image: torch.Tensor, context: torch.Tensor,
            noise: Optional[torch.Tensor] = None,
            generator: Optional[torch.Generator] = None
            ) -> Tuple[torch.Tensor, torch.Tensor]:
        """Sample a frame: (action (B,) int64, logprob (B,) float32). The
        Gumbel noise is `noise` (B, num_frames) or is drawn from
        `generator`; the action is the first maximum, as jnp.argmax."""
        if self.is_critic:
            raise ValueError("act() is for the actor head")
        logits = standardize(self.logits(image, context), 1, eps=0.1)
        masked = self._mask_invalid(logits)
        logp = gumbel_log_softmax(masked, self.temperature, noise, generator)
        action = torch.argmax(logp, 1)
        if self.exact_logprob:
            exact = torch.log_softmax(masked.float(), 1)
            logprob = exact.gather(1, action[:, None])[:, 0]
        else:
            logprob = logp.max(1).values
        return action, logprob

    def logprob(self, image: torch.Tensor, context: torch.Tensor, action: torch.Tensor,
                noise: Optional[torch.Tensor] = None,
                generator: Optional[torch.Generator] = None) -> torch.Tensor:
        """Log-probability of `action` (B,): noise-free log_softmax of the
        standardized, masked logits in exact mode (so the PPO ratio is 1 at
        unchanged parameters), else with fresh Gumbel noise (`noise` or
        drawn from `generator`) on the unstandardized masked logits."""
        logits = self.logits(image, context)
        if self.exact_logprob:
            masked = self._mask_invalid(standardize(logits, 1, eps=0.1))
            logp = torch.log_softmax(masked.float(), 1)
        else:
            logp = gumbel_log_softmax(self._mask_invalid(logits), self.temperature,
                                      noise, generator)
        return logp.gather(1, action.long()[:, None])[:, 0]

    def value(self, image: torch.Tensor, context: torch.Tensor) -> torch.Tensor:
        if not self.is_critic:
            raise ValueError("value() is for the critic head")
        return self.logits(image, context)[:, 0]


def convert_torch_state_dict(state_dict) -> dict:
    """A reference PolicyNetwork1UNet checkpoint (policy_net_1.py:20-57)
    -> this module's state dict: conv1-4 -> enc.0-3, upconv1-3 -> up.0-2,
    conv5-7 -> dec.0-2, conv8/bn8 -> head1/head1_norm, conv9/bn9 ->
    head2/head2_norm, fc_final. Both sides are torch layouts (OIHW convs,
    IOHW transposed convs, (out, in) linears), so only names change; the
    BatchNorm2d running statistics are dropped (the reference never leaves
    train mode, see layers.BatchStatNorm)."""
    def t(name):
        return reference_tensor(state_dict, name)

    def block(dst, conv, bn, conv_name="Conv_0"):
        return {f"{dst}.{conv_name}.weight": t(f"{conv}.weight"),
                f"{dst}.{conv_name}.bias": t(f"{conv}.bias"),
                f"{dst}.BatchStatNorm_0.weight": t(f"{bn}.weight"),
                f"{dst}.BatchStatNorm_0.bias": t(f"{bn}.bias")}

    out = {}
    for i in range(4):
        out.update(block(f"enc.{i}", f"conv{i + 1}", f"bn{i + 1}"))
    for i in range(3):
        out.update(block(f"up.{i}", f"upconv{i + 1}", f"bn_up{i + 1}", "ConvTranspose_0"))
        out.update(block(f"dec.{i}", f"conv{i + 5}", f"bn{i + 5}"))
    for head, conv, bn in (("head1", "conv8", "bn8"), ("head2", "conv9", "bn9")):
        out.update({f"{head}.weight": t(f"{conv}.weight"), f"{head}.bias": t(f"{conv}.bias"),
                    f"{head}_norm.weight": t(f"{bn}.weight"),
                    f"{head}_norm.bias": t(f"{bn}.bias")})
    out["fc_final.weight"] = t("fc_final.weight")
    out["fc_final.bias"] = t("fc_final.bias")
    return out


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
