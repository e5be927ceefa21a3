"""LPIPS perceptual distance with a VGG-16 trunk
(rovr_tpu/models/vgg_lpips.py): features tapped after each stage,
channel-unit-normalized, squared difference weighted by per-layer |lin|
weights, spatial mean, summed over layers. Inputs in [0,1] map to [-1,1],
then the LPIPS shift/scale.

Taps are NCHW tensors in the compute dtype (an internal layout: only the
rollout consumes them). `taps(x, limit=k)` runs only the first k stages and
is an exact prefix of the full list.
"""

from __future__ import annotations

from typing import List, Optional, Tuple

import numpy as np
import torch
from torch import nn

from rovr_torch.models.layers import Conv2d, max_pool, reference_tensor

# lpips.ScalingLayer constants
_SHIFT = np.array([-0.030, -0.088, -0.188], np.float32)
_SCALE = np.array([0.458, 0.448, 0.450], np.float32)

# VGG16 conv plan: (features, num_convs) per stage; taps after each stage.
_STAGES = ((64, 2), (128, 2), (256, 3), (512, 3), (512, 3))


class VGG16Features(nn.Module):
    def __init__(self, dtype: torch.dtype = torch.bfloat16,
                 stages: Tuple[Tuple[int, int], ...] = _STAGES):
        super().__init__()
        self.dtype = dtype
        self.stages = tuple(stages)
        cin = 3
        for s, (feats, n_convs) in enumerate(self.stages):
            for c in range(n_convs):
                self.add_module(f"conv{s + 1}_{c + 1}", Conv2d(
                    cin, feats, 3, padding=1, compute_dtype=dtype))
                cin = feats

    def forward(self, x: torch.Tensor, limit: Optional[int] = None) -> List[torch.Tensor]:
        """x NCHW -> per-stage taps of the first `limit` stages (all: None)."""
        stages = self.stages if limit is None else self.stages[:limit]
        taps = []
        x = x.to(self.dtype)
        for s, (_, n_convs) in enumerate(stages):
            for c in range(n_convs):
                x = torch.relu(getattr(self, f"conv{s + 1}_{c + 1}")(x))
            taps.append(x)
            if s < len(stages) - 1:
                x = max_pool(x, (2, 2))
        return taps


class LPIPS(nn.Module):
    """lpips.LPIPS(net='vgg') twin; forward(x, y) with x, y (B,H,W,3)."""

    def __init__(self, dtype: torch.dtype = torch.bfloat16,
                 stages: Tuple[Tuple[int, int], ...] = _STAGES):
        super().__init__()
        self.dtype = dtype
        self.vgg = VGG16Features(dtype=dtype, stages=stages)
        for i, (feats, _) in enumerate(self.vgg.stages):
            self.register_parameter(
                f"lin{i}", nn.Parameter(torch.empty(feats).uniform_(0.0, 0.1))
            )

    def lins(self) -> List[torch.Tensor]:
        return [getattr(self, f"lin{i}") for i in range(len(self.vgg.stages))]

    def taps(self, x: torch.Tensor, normalize: bool = True,
             limit: Optional[int] = None) -> List[torch.Tensor]:
        """Unit-normalized VGG feature taps (NCHW, compute dtype) of x
        (B,H,W,3); `limit` computes only the first `limit` stages."""
        if normalize:  # [0,1] -> [-1,1]
            x = 2.0 * x - 1.0
        x = (x - x.new_tensor(_SHIFT)) / x.new_tensor(_SCALE)
        out = []
        for tap in self.vgg(x.permute(0, 3, 1, 2), limit=limit):
            t32 = tap.float()
            t32 = t32 * torch.rsqrt((t32 * t32).sum(1, keepdim=True) + 1e-10)
            out.append(t32.to(self.dtype))
        return out

    def distance_from_taps(self, fx: List[torch.Tensor],
                           fy: List[torch.Tensor]) -> torch.Tensor:
        """LPIPS distance (B,) f32 from two unit-normalized tap lists."""
        total = fx[0].new_zeros(fx[0].shape[0], dtype=torch.float32)
        for lin, tx, ty in zip(self.lins(), fx, fy):
            diff = (tx.float() - ty.float()) ** 2
            total = total + torch.einsum("bchw,c->bhw", diff, lin.abs()).mean((1, 2))
        return total

    def forward(self, x: torch.Tensor, y: torch.Tensor,
                normalize: bool = True) -> torch.Tensor:
        b = x.shape[0]
        both = self.taps(torch.cat([x, y], dim=0), normalize=normalize)
        return self.distance_from_taps([t[:b] for t in both], [t[b:] for t in both])


# torchvision vgg16.features' conv indices, stage by stage
_VGG16_CONVS = ((0, 2), (5, 7), (10, 12, 14), (17, 19, 21), (24, 26, 28))


def convert_lpips_weights(vgg_state, lin_state) -> dict:
    """torchvision vgg16.features (`features.{i}.weight`, OIHW) and lpips'
    linear heads (`lin{i}.model.1.weight`, (1, C, 1, 1)) -> this LPIPS's
    state dict: `vgg.conv{s}_{c}` and the flattened `lin{i}`."""
    out = {}
    for s, idxs in enumerate(_VGG16_CONVS):
        for c, i in enumerate(idxs):
            for leaf in ("weight", "bias"):
                out[f"vgg.conv{s + 1}_{c + 1}.{leaf}"] = reference_tensor(
                    vgg_state, f"features.{i}.{leaf}")
    for i in range(len(_VGG16_CONVS)):
        out[f"lin{i}"] = reference_tensor(lin_state, f"lin{i}.model.1.weight").reshape(-1)
    return out
