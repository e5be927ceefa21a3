"""Local inpainting network: reconstruct a target frame from two context
frames. 4-level UNet, sigmoid output (rovr_tpu/models/local_net.py).

The input is the target frame plus the 2 context frames stacked on channels
(9 channels). Convs compute in `dtype` (bf16 by default) with f32 params; the
sigmoid runs in f32. conv3, conv4 and conv5 are FusedConv3x3: on CUDA they
run the hand-written K1 kernel, three launches per call. Parameter names
follow the original UNet (conv1..conv8, upconv1..upconv3).
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch
from torch import nn

from rovr_torch.models.layers import (
    Conv2d, ConvTranspose2d, FusedConv3x3, max_pool, reference_tensor,
)


class LocalNetUNet(nn.Module):
    def __init__(self, channels: Tuple[int, ...] = (64, 128, 256, 512),
                 dtype: torch.dtype = torch.bfloat16, conv_impl: str = "auto"):
        super().__init__()
        c1, c2, c3, c4 = channels
        self.dtype = dtype

        def conv(cin, f, k):
            return Conv2d(cin, f, k, padding=k // 2, compute_dtype=dtype)

        def fconv(cin, f):
            return FusedConv3x3(cin, f, relu=True, dtype=dtype, impl=conv_impl)

        def upconv(cin, f):
            return ConvTranspose2d(cin, f, 2, stride=2, compute_dtype=dtype)

        self.conv1 = conv(9, c1, 3)
        self.conv2 = conv(c1, c2, 3)
        self.conv3 = fconv(c2, c3)
        self.conv4 = fconv(c3, c4)
        self.upconv1 = upconv(c4, c3)
        self.conv5 = fconv(2 * c3, c3)
        self.upconv2 = upconv(c3, c2)
        self.conv6 = conv(2 * c2, c2, 3)
        self.upconv3 = upconv(c2, c1)
        self.conv7 = conv(2 * c1, c1, 3)
        self.conv8 = conv(c1, 3, 1)

    def forward(self, target: torch.Tensor, context: torch.Tensor) -> torch.Tensor:
        """target (B,H,W,3), context (B,2,H,W,3) -> (B,H,W,3) f32 in [0,1]."""
        x = torch.cat([target, context[:, 0], context[:, 1]], dim=-1)
        x = x.to(self.dtype).permute(0, 3, 1, 2)  # NCHW, channels_last memory
        relu = torch.relu

        # contracting path
        x1 = relu(self.conv1(x))
        x2 = relu(self.conv2(max_pool(x1, (2, 2))))
        x3 = self.conv3(max_pool(x2, (2, 2)))
        x4 = self.conv4(max_pool(x3, (2, 2)))

        # expanding path with skip concat
        y = relu(self.upconv1(x4))
        y = self.conv5(torch.cat([y, x3], dim=1))
        y = relu(self.upconv2(y))
        y = relu(self.conv6(torch.cat([y, x2], dim=1)))
        y = relu(self.upconv3(y))
        y = relu(self.conv7(torch.cat([y, x1], dim=1)))

        out = self.conv8(y)
        return torch.sigmoid(out.float()).permute(0, 2, 3, 1)


def convert_torch_state_dict(state_dict) -> dict:
    """A reference LocalNetworkUNetNorm checkpoint (local_net.py:12-39) ->
    this module's state dict. The names (conv1..conv8, upconv1..upconv3) are
    the reference's and both sides keep torch layouts (OIHW convs, IOHW
    transposed convs), so each tensor is taken as it is. The reference's
    BatchNorm parameters are dead (never applied in its forward,
    local_net.py:52-71) and are dropped."""
    names = [f"conv{i}" for i in range(1, 9)] + [f"upconv{i}" for i in range(1, 4)]
    return {f"{n}.{leaf}": reference_tensor(state_dict, f"{n}.{leaf}")
            for n in names for leaf in ("weight", "bias")}
