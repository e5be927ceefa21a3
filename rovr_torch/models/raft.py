"""RAFT-small optical flow, the frozen flow metric φ (rovr_tpu/models/raft.py,
PyTorch port).

Frames are resized to size x size, the flow between consecutive frames is
the last refinement iteration's, and a pair's magnitude is
sqrt(sum flow^2). The architecture is RAFT's "small" configuration: feature
encoder -> 128-d features at 1/8 resolution (instance norm); context encoder
-> 96 hidden (tanh) + 64 context (relu); a 4-level correlation pyramid with
radius-3 lookups; the small motion encoder, a ConvGRU(96) and the flow head,
applied `iters` times with one set of parameters; the final flow upsampled
8x bilinearly.

Conventions kept from the JAX file: public tensors NHWC, coordinates
(x, y), level l of the pyramid at coordinates / 2^l, each level the mean of
2x2 blocks with an odd edge cropped; features in the compute dtype, the
correlation, flow state and the flow head's last conv in float32.

The correlation is one batched matmul. Its lookup, bilinear with zero
padding outside the level as the JAX file's one-hot products compute it, is
`ops.corr.corr_lookup`: one CUDA kernel a refinement iteration on the card
(csrc/corr_lookup.cu), the plain `lookup_corr` (an index gather with a
validity mask) on the CPU. The convolutions are stock PyTorch (`F.conv2d`):
XLA lowered them by itself, no kernel of the port stands behind them.
`pairwise_flows` runs the frame pairs in chunks of at most `PAIR_CHUNK`:
every op is per pair, so chunks change only the peak memory.

Parameter names follow the flax tree (`fnet`, `cnet`, `update.motion`,
`update.gru`, `update.flow_head`), so `utils.convert` carries JAX weights
over by its rule; the update cell's parameters live once under `update`,
shared by every iteration.

Spans (`utils.profiling.annotate`), one of each per RAFT call:
`rovr/raft/encode` (the feature encoder over both frames, the context
encoder and the hidden/context split), `rovr/raft/corr`
(`correlation_pyramid`) and `rovr/raft/update` (all `iters` refinement
iterations: lookups, motion encoder, GRU, flow head). Counters on
`pairwise_flows`: `pairwise_flows.pairs`, the frame pairs it has sent
through RAFT, and `pairwise_flows.calls`, the RAFT calls (chunks) it has
made; both count on the host from shapes alone.
"""

from __future__ import annotations

import math
from typing import List, Optional, Tuple

import torch
from torch import nn

from rovr_torch.models.layers import Conv2d, reference_tensor
from rovr_torch.models.video_processor import resize_bilinear
# lookup_corr, the lookup's plain version, is named here for the parity tests
from rovr_torch.ops.corr import NUM_LEVELS, RADIUS, corr_lookup, lookup_corr  # noqa: F401
from rovr_torch.utils.profiling import annotate

HIDDEN_DIM = 96
CONTEXT_DIM = 64
PAIR_CHUNK = 128   # frame pairs per RAFT call in pairwise_flows


def _conv(cin: int, f: int, k: int, dtype, stride: int = 1) -> Conv2d:
    return Conv2d(cin, f, k, stride=stride, padding=k // 2, compute_dtype=dtype)


class InstanceNorm(nn.Module):
    """Per-sample, per-channel normalization over H and W, learnable scale
    (`weight`, flax `scale`) and bias, biased variance, eps 1e-5, computed in
    float32 and returned in the input's dtype. NCHW."""

    init_as_constructed = True   # flax_init_state: its construction values

    def __init__(self, num_features: int, eps: float = 1e-5):
        super().__init__()
        self.weight = nn.Parameter(torch.ones(num_features))
        self.bias = nn.Parameter(torch.zeros(num_features))
        self.eps = eps

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x32 = x.float()
        mean = x32.mean((2, 3), keepdim=True)
        var = ((x32 - mean) ** 2).mean((2, 3), keepdim=True)
        y = (x32 - mean) * torch.rsqrt(var + self.eps) * self.weight.view(1, -1, 1, 1) \
            + self.bias.view(1, -1, 1, 1)
        return y.to(x.dtype)


class BottleneckBlock(nn.Module):
    """Residual bottleneck: 1x1 down, 3x3 (strided), 1x1 up; a strided or
    widening block adds a 1x1 projection of its input."""

    def __init__(self, in_features: int, features: int, strides: int = 1,
                 use_norm: bool = True, dtype=torch.bfloat16):
        super().__init__()
        f4 = features // 4
        self.conv1 = _conv(in_features, f4, 1, dtype)
        self.conv2 = _conv(f4, f4, 3, dtype, strides)
        self.conv3 = _conv(f4, features, 1, dtype)
        self.use_norm = use_norm
        if use_norm:
            self.norm1, self.norm2, self.norm3 = (InstanceNorm(c) for c in (f4, f4, features))
        self.down = strides != 1 or in_features != features
        if self.down:
            self.conv_down = _conv(in_features, features, 1, dtype, strides)
            if use_norm:
                self.norm_down = InstanceNorm(features)

    def _norm(self, name: str, x: torch.Tensor) -> torch.Tensor:
        return getattr(self, name)(x) if self.use_norm else x

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = torch.relu(self._norm("norm1", self.conv1(x)))
        y = torch.relu(self._norm("norm2", self.conv2(y)))
        y = torch.relu(self._norm("norm3", self.conv3(y)))
        if self.down:
            x = self._norm("norm_down", self.conv_down(x))
        return torch.relu(x + y)


class SmallEncoder(nn.Module):
    """Feature/context encoder: (N, 3, H, W) -> (N, out_dim, H/8, W/8)."""

    def __init__(self, out_dim: int = 128, use_norm: bool = True, dtype=torch.bfloat16):
        super().__init__()
        self.dtype = dtype
        self.conv1 = _conv(3, 32, 7, dtype, 2)
        self.norm1 = InstanceNorm(32) if use_norm else None
        cin = 32
        for i, (feats, stride) in enumerate(((32, 1), (64, 2), (96, 2))):
            self.add_module(f"layer{i + 1}_0",
                            BottleneckBlock(cin, feats, stride, use_norm, dtype))
            self.add_module(f"layer{i + 1}_1",
                            BottleneckBlock(feats, feats, 1, use_norm, dtype))
            cin = feats
        self.conv2 = _conv(96, out_dim, 1, dtype)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = self.conv1(x.to(self.dtype))
        if self.norm1 is not None:
            x = self.norm1(x)
        x = torch.relu(x)
        for i in range(1, 4):
            x = getattr(self, f"layer{i}_1")(getattr(self, f"layer{i}_0")(x))
        return self.conv2(x)


def correlation_pyramid(fmap1: torch.Tensor, fmap2: torch.Tensor) -> List[torch.Tensor]:
    """All-pairs correlation and its 4-level average pyramid.

    fmap1/fmap2: (B, H, W, D) -> list of (B, H*W, H/2^l, W/2^l) float32,
    scaled by 1/sqrt(D)."""
    b, h, w, d = fmap1.shape
    f1 = fmap1.reshape(b, h * w, d).float()
    f2 = fmap2.reshape(b, h * w, d).float()
    corr = torch.bmm(f1, f2.transpose(1, 2)) / math.sqrt(d)
    pyramid = [corr.reshape(b, h * w, h, w)]
    for _ in range(NUM_LEVELS - 1):
        c = pyramid[-1]
        hh, ww = c.shape[2] // 2, c.shape[3] // 2
        c = c[:, :, :hh * 2, :ww * 2].reshape(b, h * w, hh, 2, ww, 2)
        pyramid.append(c.mean((3, 5)))
    return pyramid


class SmallMotionEncoder(nn.Module):
    """corr + flow -> 82 motion channels (80 conv features + the flow)."""

    def __init__(self, dtype=torch.bfloat16):
        super().__init__()
        self.dtype = dtype
        self.convc1 = _conv(NUM_LEVELS * (2 * RADIUS + 1) ** 2, 96, 1, dtype)
        self.convf1 = _conv(2, 64, 7, dtype)
        self.convf2 = _conv(64, 32, 3, dtype)
        self.conv = _conv(128, 80, 3, dtype)

    def forward(self, flow: torch.Tensor, corr: torch.Tensor) -> torch.Tensor:
        """flow (N, 2, H, W), corr (N, 196, H, W) -> (N, 82, H, W)."""
        c = torch.relu(self.convc1(corr.to(self.dtype)))
        f = torch.relu(self.convf1(flow.to(self.dtype)))
        f = torch.relu(self.convf2(f))
        out = torch.relu(self.conv(torch.cat([c, f], dim=1)))
        return torch.cat([out, flow.to(self.dtype)], dim=1)


class ConvGRU(nn.Module):
    def __init__(self, hidden_dim: int = HIDDEN_DIM,
                 input_dim: int = CONTEXT_DIM + 82, dtype=torch.bfloat16):
        super().__init__()
        self.dtype = dtype
        cin = hidden_dim + input_dim
        self.convz, self.convr, self.convq = (_conv(cin, hidden_dim, 3, dtype)
                                              for _ in range(3))

    def forward(self, h: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
        hx = torch.cat([h, x], dim=1).to(self.dtype)
        z = torch.sigmoid(self.convz(hx))
        r = torch.sigmoid(self.convr(hx))
        q = torch.tanh(self.convq(torch.cat([r * h, x], dim=1)))
        return (1.0 - z) * h + z * q


class FlowHead(nn.Module):
    def __init__(self, dtype=torch.bfloat16):
        super().__init__()
        self.conv1 = _conv(HIDDEN_DIM, 128, 3, dtype)
        self.conv2 = _conv(128, 2, 3, torch.float32)

    def forward(self, h: torch.Tensor) -> torch.Tensor:
        return self.conv2(torch.relu(self.conv1(h)))


class UpdateCell(nn.Module):
    """One refinement iteration: corr lookup -> motion -> GRU -> delta flow.

    The lookup is `ops.corr.corr_lookup`: on the card one kernel launch
    (counted by `corr_lookup.launches`) writes the 196 motion features in the
    motion encoder's compute dtype, NHWC in memory under (N, 196, h, w)
    strides, as casting the plain lookup's permuted output gave; on the CPU
    and `meta` the plain `lookup_corr` computes them."""

    def __init__(self, dtype=torch.bfloat16):
        super().__init__()
        self.motion = SmallMotionEncoder(dtype)
        self.gru = ConvGRU(dtype=dtype)
        self.flow_head = FlowHead(dtype)

    def forward(self, hid, coords1, coords0, context, pyramid):
        """hid (N, 96, h, w) f32, coords (N, h, w, 2) f32 (x, y), context
        (N, 64, h, w) f32 -> (hid, coords1)."""
        corr = corr_lookup(pyramid, coords1.contiguous(), self.motion.dtype)
        flow = (coords1 - coords0).permute(0, 3, 1, 2)
        m = self.motion(flow, corr)
        inp = torch.cat([context, m.float()], dim=1)
        hid = self.gru(hid, inp).float()
        delta = self.flow_head(hid)
        return hid, coords1 + delta.permute(0, 2, 3, 1)


class RAFTSmall(nn.Module):
    """forward(image1, image2) -> flow (B, H, W, 2) float32 at full
    resolution. Images NHWC in [0, 1], mapped to [-1, 1] inside."""

    def __init__(self, iters: int = 12, dtype=torch.bfloat16):
        super().__init__()
        self.iters = iters
        self.dtype = dtype
        self.fnet = SmallEncoder(128, True, dtype)
        self.cnet = SmallEncoder(HIDDEN_DIM + CONTEXT_DIM, False, dtype)
        self.update = UpdateCell(dtype)

    def forward(self, image1: torch.Tensor, image2: torch.Tensor) -> torch.Tensor:
        b, h, w, _ = image1.shape
        with annotate("rovr/raft/encode"):
            x1 = (2.0 * image1 - 1.0).permute(0, 3, 1, 2)
            x2 = (2.0 * image2 - 1.0).permute(0, 3, 1, 2)
            fmaps = self.fnet(torch.cat([x1, x2], dim=0)).permute(0, 2, 3, 1)
            fmap1, fmap2 = fmaps[:b], fmaps[b:]
            cmap = self.cnet(x1)
            hidden = torch.tanh(cmap[:, :HIDDEN_DIM].float())
            context = torch.relu(cmap[:, HIDDEN_DIM:]).float()

        with annotate("rovr/raft/corr"):
            pyramid = correlation_pyramid(fmap1, fmap2)
        h8, w8 = fmap1.shape[1], fmap1.shape[2]
        gy, gx = torch.meshgrid(
            torch.arange(h8, dtype=torch.float32, device=image1.device),
            torch.arange(w8, dtype=torch.float32, device=image1.device), indexing="ij")
        coords0 = torch.stack([gx, gy], dim=-1)[None].expand(b, h8, w8, 2)
        coords1 = coords0
        with annotate("rovr/raft/update"):
            for _ in range(self.iters):
                hidden, coords1 = self.update(hidden, coords1, coords0, context, pyramid)
        flow8 = coords1 - coords0   # the last refinement
        return resize_bilinear(flow8, (h, w)) * 8.0


def pairwise_flows(raft: RAFTSmall, video: torch.Tensor, size: int = 256,
                   chunk: Optional[int] = PAIR_CHUNK) -> torch.Tensor:
    """Flows between consecutive frames of (B, S, H, W, 3) -> (B, S-1, size,
    size, 2), the frames resized to size x size first. The B*(S-1) pairs run
    `chunk` at a time (None: all at once); each call adds them to
    `pairwise_flows.pairs` and its RAFT calls to `pairwise_flows.calls`."""
    b, s = video.shape[:2]
    small = resize_bilinear(video.reshape((b * s,) + tuple(video.shape[2:])).float(),
                            (size, size)).reshape(b, s, size, size, 3)
    f1 = small[:, :-1].reshape(b * (s - 1), size, size, 3)
    f2 = small[:, 1:].reshape(b * (s - 1), size, size, 3)
    step = chunk or f1.shape[0]
    starts = range(0, f1.shape[0], step)
    pairwise_flows.pairs += f1.shape[0]
    pairwise_flows.calls += len(starts)
    flows = torch.cat([raft(f1[i:i + step], f2[i:i + step]) for i in starts])
    return flows.reshape(b, s - 1, size, size, 2)


pairwise_flows.pairs = 0
pairwise_flows.calls = 0


def total_flow_magnitude(flows: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """(B, P, H, W, 2) -> (total (B,), per-pair (B, P)) flow magnitudes."""
    per_pair = torch.sqrt((flows.float() ** 2).sum((-3, -2, -1)))
    return per_pair.sum(-1), per_pair


def convert_raft_state_dict(sd) -> dict:
    """A torchvision raft_small state dict -> this module's: the encoders'
    `convnormrelu` (layer{i}.{b}.convnormrelu{j}, downsample, conv) ->
    conv1/norm1, layer{i}_{b}.conv{j}/norm{j}, conv_down/norm_down, conv2
    (the context encoder has no norms); the update block's motion encoder,
    ConvGRU and flow head -> update.motion, update.gru, update.flow_head.
    Convs are OIHW on both sides; a bias is taken where the reference has
    one."""
    out = {}

    def conv(dst, src):
        out[f"{dst}.weight"] = reference_tensor(sd, f"{src}.weight")
        if f"{src}.bias" in sd:
            out[f"{dst}.bias"] = reference_tensor(sd, f"{src}.bias")

    def norm(dst, src):
        for leaf in ("weight", "bias"):
            out[f"{dst}.{leaf}"] = reference_tensor(sd, f"{src}.{leaf}")

    for name, prefix, use_norm in (("fnet", "feature_encoder", True),
                                   ("cnet", "context_encoder", False)):
        conv(f"{name}.conv1", f"{prefix}.convnormrelu.0")
        if use_norm:
            norm(f"{name}.norm1", f"{prefix}.convnormrelu.1")
        for i in range(1, 4):
            for blk in range(2):
                src, dst = f"{prefix}.layer{i}.{blk}", f"{name}.layer{i}_{blk}"
                for j in range(1, 4):
                    conv(f"{dst}.conv{j}", f"{src}.convnormrelu{j}.0")
                    if use_norm:
                        norm(f"{dst}.norm{j}", f"{src}.convnormrelu{j}.1")
                if f"{src}.downsample.0.weight" in sd:
                    conv(f"{dst}.conv_down", f"{src}.downsample.0")
                    if use_norm:
                        norm(f"{dst}.norm_down", f"{src}.downsample.1")
        conv(f"{name}.conv2", f"{prefix}.conv")
    for dst, src in (("motion.convc1", "motion_encoder.convcorr1.0"),
                     ("motion.convf1", "motion_encoder.convflow1.0"),
                     ("motion.convf2", "motion_encoder.convflow2.0"),
                     ("motion.conv", "motion_encoder.conv.0"),
                     ("gru.convz", "recurrent_block.convgru.convz"),
                     ("gru.convr", "recurrent_block.convgru.convr"),
                     ("gru.convq", "recurrent_block.convgru.convq"),
                     ("flow_head.conv1", "flow_head.conv1"),
                     ("flow_head.conv2", "flow_head.conv2")):
        conv(f"update.{dst}", f"update_block.{src}")
    return out
