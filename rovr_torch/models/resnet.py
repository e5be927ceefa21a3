"""Frozen ResNet-50 backbone for per-frame features
(rovr_tpu/models/resnet.py), plus the small TinyBackbone the tests use.

The backbone is frozen and eval-only, so BatchNorm is a pure affine map from
stored statistics (`FrozenBatchNorm`, f32 math then a cast). Convs compute
in `dtype` (bf16 by default) with f32 weights. Module names follow the JAX
package's (`layer{stage}_{block}`, `conv_down`/`bn_down`).
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch
from torch import nn

from rovr_torch.models.layers import Conv2d, max_pool, reference_tensor

STAGE_SIZES = (3, 4, 6, 3)  # resnet50


class FrozenBatchNorm(nn.Module):
    """Eval-mode BatchNorm: y = weight * (x - mean) / sqrt(var + eps) + bias,
    statistics held as (frozen) buffers."""

    init_as_constructed = True   # flax_init_state: its construction values

    def __init__(self, num_features: int, eps: float = 1e-5,
                 dtype: Optional[torch.dtype] = None):
        super().__init__()
        self.register_buffer("weight", torch.ones(num_features))
        self.register_buffer("bias", torch.zeros(num_features))
        self.register_buffer("running_mean", torch.zeros(num_features))
        self.register_buffer("running_var", torch.ones(num_features))
        self.eps = eps
        self.dtype = dtype

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        inv = self.weight / torch.sqrt(self.running_var + self.eps)
        shift = self.bias - self.running_mean * inv
        y = x.float() * inv.view(1, -1, 1, 1) + shift.view(1, -1, 1, 1)
        return y.to(x.dtype if self.dtype is None else self.dtype)


def _pool_spatial(x: torch.Tensor, g: int) -> torch.Tensor:
    """(B, C, H, W) -> (B, C) for g=1 (global mean) or (B, g*g*C) for g>1
    (AdaptiveAvgPool2d(g) bins, cells row-major, channels minor)."""
    if g <= 1:
        return x.mean((2, 3))
    h, w = x.shape[-2:]
    he = np.linspace(0, h, g + 1).round().astype(int)
    we = np.linspace(0, w, g + 1).round().astype(int)
    cells = [
        x[:, :, he[i]:he[i + 1], we[j]:we[j + 1]].mean((2, 3))
        for i in range(g) for j in range(g)
    ]
    return torch.cat(cells, dim=-1)


class Bottleneck(nn.Module):
    def __init__(self, in_features: int, features: int, strides: int = 1,
                 dtype: torch.dtype = torch.bfloat16):
        super().__init__()

        def conv(cin, f, k, s):
            return Conv2d(cin, f, k, stride=s, padding=k // 2, bias=False,
                          compute_dtype=dtype)

        self.conv1 = conv(in_features, features, 1, 1)
        self.bn1 = FrozenBatchNorm(features, dtype=dtype)
        self.conv2 = conv(features, features, 3, strides)
        self.bn2 = FrozenBatchNorm(features, dtype=dtype)
        self.conv3 = conv(features, features * 4, 1, 1)
        self.bn3 = FrozenBatchNorm(features * 4, dtype=dtype)
        if strides != 1 or in_features != features * 4:
            self.conv_down = conv(in_features, features * 4, 1, strides)
            self.bn_down = FrozenBatchNorm(features * 4, dtype=dtype)
        else:
            self.conv_down = None

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = torch.relu(self.bn1(self.conv1(x)))
        y = torch.relu(self.bn2(self.conv2(y)))
        y = self.bn3(self.conv3(y))
        residual = x if self.conv_down is None else self.bn_down(self.conv_down(x))
        return torch.relu(y + residual)


class ResNet50(nn.Module):
    """ResNet-50 trunk -> pooled f32 features (B, 2048 * spatial_pool^2)."""

    out_features = 2048

    def __init__(self, dtype: torch.dtype = torch.bfloat16, spatial_pool: int = 1):
        super().__init__()
        self.dtype = dtype
        self.spatial_pool = spatial_pool
        self.conv1 = Conv2d(3, 64, 7, stride=2, padding=3, bias=False,
                            compute_dtype=dtype)
        self.bn1 = FrozenBatchNorm(64, dtype=dtype)
        cin, features = 64, 64
        for stage, num_blocks in enumerate(STAGE_SIZES):
            for block in range(num_blocks):
                strides = 2 if stage > 0 and block == 0 else 1
                self.add_module(
                    f"layer{stage + 1}_{block}",
                    Bottleneck(cin, features, strides, dtype=dtype),
                )
                cin = features * 4
            features *= 2

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        """x (B, H, W, 3) in [0, 1] -> (B, 2048 * spatial_pool^2) f32."""
        x = x.to(self.dtype).permute(0, 3, 1, 2)
        x = torch.relu(self.bn1(self.conv1(x)))
        x = max_pool(x, (3, 3), strides=(2, 2), padding=((1, 1), (1, 1)))
        for stage, num_blocks in enumerate(STAGE_SIZES):
            for block in range(num_blocks):
                x = getattr(self, f"layer{stage + 1}_{block}")(x)
        return _pool_spatial(x.float(), self.spatial_pool)


class TinyBackbone(nn.Module):
    """Small frozen conv trunk with the ResNet50 interface
    ((B,H,W,3) -> pooled (B, features*4) f32), for fast tests."""

    def __init__(self, features: int = 32, dtype: torch.dtype = torch.bfloat16,
                 spatial_pool: int = 1):
        super().__init__()
        self.dtype = dtype
        self.spatial_pool = spatial_pool
        self.out_features = features * 4
        cin = 3
        for i, stride in enumerate((4, 2, 2)):
            f = features * (2 ** i)
            self.add_module(f"conv{i + 1}", Conv2d(
                cin, f, 3, stride=stride, padding=1, compute_dtype=dtype))
            cin = f

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = x.to(self.dtype).permute(0, 3, 1, 2)
        for i in range(3):
            x = torch.relu(getattr(self, f"conv{i + 1}")(x))
        return _pool_spatial(x.float(), self.spatial_pool)


def convert_torch_state_dict(state_dict) -> dict:
    """A torchvision resnet50 state dict -> this module's: the same convs
    (OIHW on both sides), `layer{s}.{b}` -> `layer{s}_{b}`, `downsample.0/1`
    -> `conv_down`/`bn_down`, each BatchNorm's weight, bias and running
    statistics into its FrozenBatchNorm; the classifier (`fc`) is dropped."""
    out = {}

    def bn(dst, src):
        for leaf in ("weight", "bias", "running_mean", "running_var"):
            out[f"{dst}.{leaf}"] = reference_tensor(state_dict, f"{src}.{leaf}")

    out["conv1.weight"] = reference_tensor(state_dict, "conv1.weight")
    bn("bn1", "bn1")
    for stage, num_blocks in enumerate(STAGE_SIZES):
        for block in range(num_blocks):
            src, dst = f"layer{stage + 1}.{block}", f"layer{stage + 1}_{block}"
            for j in (1, 2, 3):
                out[f"{dst}.conv{j}.weight"] = reference_tensor(state_dict,
                                                                f"{src}.conv{j}.weight")
                bn(f"{dst}.bn{j}", f"{src}.bn{j}")
            if f"{src}.downsample.0.weight" in state_dict:
                out[f"{dst}.conv_down.weight"] = reference_tensor(
                    state_dict, f"{src}.downsample.0.weight")
                bn(f"{dst}.bn_down", f"{src}.downsample.1")
    return out
