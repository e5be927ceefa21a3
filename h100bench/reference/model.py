"""Plain float32 reference of the ROVR models, written from the model
equations and independent of the code it checks.

Every network is a function of a parameter dict (name -> tensor) whose names
and layouts are those the benchmark draws: OIHW convs, IOHW transposed
convs, (out, in) linears, and (*in, *out) kernels for the attention
projections. Each product (conv, transposed conv, linear, batched matmul)
goes through `Precision`, which either computes in float32 (TF32 off, set by
the caller) or, for the control, rounds both operands to float8 e4m3 with
one scale per tensor first.

Models: the ResNet-50 (or the small test trunk) + VideoProcessor heads and
state canvas, the VGG16 LPIPS distance, the local inpainting UNet, and the
two context policies (PolicyNet2 on the canvas, the attention policy over
frame-patch tokens).
"""

from __future__ import annotations

import math
from typing import Dict, List, Optional, Sequence, Tuple

import torch
import torch.nn.functional as F

Params = Dict[str, torch.Tensor]

LN2 = 0.69314                 # the original policy's constant for the pair logprob
LPIPS_SHIFT = (-0.030, -0.088, -0.188)
LPIPS_SCALE = (0.458, 0.448, 0.450)
VGG16_STAGES = ((64, 2), (128, 2), (256, 3), (512, 3), (512, 3))
RESNET50_BLOCKS = (3, 4, 6, 3)
POLICY_TRUNK = (64, 128, 256, 512)
FP8_MAX = 448.0               # largest finite float8 e4m3fn


class Precision:
    """How the reference multiplies: "f32", or "fp8" (both operands of each
    product rounded to float8 e4m3fn at a per-tensor scale, amax -> 448,
    then multiplied in float32: the step below bfloat16 that a port could
    take)."""

    def __init__(self, mode: str = "f32"):
        if mode not in ("f32", "fp8"):
            raise ValueError(f"precision must be f32 or fp8, got {mode!r}")
        self.mode = mode

    def q(self, x: torch.Tensor) -> torch.Tensor:
        x = x.float()
        if self.mode == "f32" or x.device.type == "meta":
            return x
        scale = x.detach().abs().amax().clamp_min(1e-30) / FP8_MAX
        rounded = (x.detach() / scale).to(torch.float8_e4m3fn).float() * scale
        return x + (rounded - x).detach()    # rounded forward, straight-through backward

    def conv(self, x, w, b=None, stride=1, padding=0):
        return F.conv2d(self.q(x), self.q(w), None if b is None else b.float(),
                        stride, padding)

    def conv_t(self, x, w, b, stride):
        return F.conv_transpose2d(self.q(x), self.q(w), b.float(), stride)

    def linear(self, x, w, b=None):
        return F.linear(self.q(x), self.q(w), None if b is None else b.float())

    def matmul(self, a, b):
        return torch.matmul(self.q(a), self.q(b))


def sub(params: Params, prefix: str) -> Params:
    """The entries of `params` under `prefix.`, with the prefix taken off."""
    n = len(prefix) + 1
    return {k[n:]: v for k, v in params.items() if k.startswith(prefix + ".")}


def resize224(frames: torch.Tensor) -> torch.Tensor:
    """(N, H, W, 3) -> (N, 224, 224, 3): bilinear, half-pixel centres,
    with the kernel widened (antialiased) when it shrinks."""
    h, w = frames.shape[1:3]
    y = F.interpolate(frames.permute(0, 3, 1, 2).float(), size=(224, 224),
                      mode="bilinear", align_corners=False,
                      antialias=(224 < h or 224 < w))
    return y.permute(0, 2, 3, 1)


# ---------------------------------------------------------------- backbones

def _frozen_bn(p: Params, x: torch.Tensor, eps: float = 1e-5) -> torch.Tensor:
    inv = p["weight"] / torch.sqrt(p["running_var"] + eps)
    shift = p["bias"] - p["running_mean"] * inv
    return x * inv.view(1, -1, 1, 1) + shift.view(1, -1, 1, 1)


def resnet50(P: Precision, p: Params, x: torch.Tensor) -> torch.Tensor:
    """(N, H, W, 3) in [0, 1] -> (N, 2048): the ResNet-50 trunk with
    eval-mode BatchNorm, then the global mean."""
    x = x.float().permute(0, 3, 1, 2)
    x = torch.relu(_frozen_bn(sub(p, "bn1"), P.conv(x, p["conv1.weight"], None, 2, 3)))
    x = F.max_pool2d(x, 3, 2, 1)
    for stage, n in enumerate(RESNET50_BLOCKS):
        for blk in range(n):
            b = sub(p, f"layer{stage + 1}_{blk}")
            s = 2 if stage > 0 and blk == 0 else 1
            y = torch.relu(_frozen_bn(sub(b, "bn1"), P.conv(x, b["conv1.weight"])))
            y = torch.relu(_frozen_bn(sub(b, "bn2"), P.conv(y, b["conv2.weight"], None, s, 1)))
            y = _frozen_bn(sub(b, "bn3"), P.conv(y, b["conv3.weight"]))
            if "conv_down.weight" in b:
                x = _frozen_bn(sub(b, "bn_down"), P.conv(x, b["conv_down.weight"], None, s))
            x = torch.relu(y + x)
    return x.mean((2, 3))


def tiny_trunk(P: Precision, p: Params, x: torch.Tensor) -> torch.Tensor:
    """The small test trunk: three 3x3 convs (strides 4, 2, 2) with ReLU,
    then the global mean."""
    x = x.float().permute(0, 3, 1, 2)
    for i, s in enumerate((4, 2, 2)):
        x = torch.relu(P.conv(x, p[f"conv{i + 1}.weight"], p[f"conv{i + 1}.bias"], s, 1))
    return x.mean((2, 3))


def vp_encode(P: Precision, p: Params, frames224: torch.Tensor, backbone: str,
              tile: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """frames (N, 224, 224, 3) -> (tiles (N, tile, tile), feats (N, D))."""
    trunk = resnet50 if backbone == "resnet50" else tiny_trunk
    pooled = trunk(P, sub(p, "backbone"), frames224)
    feats = P.linear(pooled, p["feat_head.weight"], p["feat_head.bias"])
    tiles = P.linear(pooled, p["tile_head.weight"], p["tile_head.bias"])
    return tiles.reshape(-1, tile, tile), feats


def canvas_of(tiles: torch.Tensor, canvas_size: int, per_row: int) -> torch.Tensor:
    """(B, S, t, t) tiles -> (B, C, C) canvas, row-major, `per_row` a row."""
    b, s, t, _ = tiles.shape
    canvas = tiles.new_zeros(b, canvas_size, canvas_size)
    for i in range(s):
        y, x = i // per_row * t, i % per_row * t
        canvas[:, y:y + t, x:x + t] = tiles[:, i]
    return canvas


def put_tile(canvas: torch.Tensor, idx: torch.Tensor, tiles: torch.Tensor,
             per_row: int) -> torch.Tensor:
    """A copy of canvas (B, C, C) with tile idx[b] replaced by tiles[b]."""
    out = canvas.clone()
    t = tiles.shape[-1]
    for b, i in enumerate(idx.tolist()):
        y, x = i // per_row * t, i % per_row * t
        out[b, y:y + t, x:x + t] = tiles[b]
    return out


# -------------------------------------------------------------------- LPIPS

def vgg_taps(P: Precision, p: Params, x: torch.Tensor,
             stages: Sequence[Tuple[int, int]]) -> List[torch.Tensor]:
    """(N, H, W, 3) in [0, 1] -> the unit-normalized VGG taps, one a stage."""
    x = (2.0 * x.float() - 1.0 - x.new_tensor(LPIPS_SHIFT)) / x.new_tensor(LPIPS_SCALE)
    x = x.permute(0, 3, 1, 2)
    taps = []
    for s, (_, n) in enumerate(stages):
        for c in range(n):
            name = f"vgg.conv{s + 1}_{c + 1}"
            x = torch.relu(P.conv(x, p[f"{name}.weight"], p[f"{name}.bias"], 1, 1))
        taps.append(x * torch.rsqrt((x * x).sum(1, keepdim=True) + 1e-10))
        if s < len(stages) - 1:
            x = F.max_pool2d(x, 2)
    return taps


def lpips_from_taps(p: Params, fx: List[torch.Tensor], fy: List[torch.Tensor]) -> torch.Tensor:
    """(N,) LPIPS: per stage the |lin|-weighted squared tap difference summed
    over channels and averaged over pixels, summed over stages."""
    total = 0.0
    for i, (a, b) in enumerate(zip(fx, fy)):
        d = ((a - b) ** 2 * p[f"lin{i}"].abs().view(1, -1, 1, 1)).sum(1)
        total = total + d.mean((1, 2))
    return total


# --------------------------------------------------------------------- UNet

def unet(P: Precision, p: Params, target: torch.Tensor, context: torch.Tensor) -> torch.Tensor:
    """target (B, H, W, 3), context (B, 2, H, W, 3) -> (B, H, W, 3) in [0, 1]."""
    x = torch.cat([target, context[:, 0], context[:, 1]], -1).float().permute(0, 3, 1, 2)

    def conv(name, x):
        return torch.relu(P.conv(x, p[f"{name}.weight"], p[f"{name}.bias"], 1, 1))

    def up(name, x):
        return torch.relu(P.conv_t(x, p[f"{name}.weight"], p[f"{name}.bias"], 2))

    x1 = conv("conv1", x)
    x2 = conv("conv2", F.max_pool2d(x1, 2))
    x3 = conv("conv3", F.max_pool2d(x2, 2))
    x4 = conv("conv4", F.max_pool2d(x3, 2))
    y = conv("conv5", torch.cat([up("upconv1", x4), x3], 1))
    y = conv("conv6", torch.cat([up("upconv2", y), x2], 1))
    y = conv("conv7", torch.cat([up("upconv3", y), x1], 1))
    y = P.conv(y, p["conv8.weight"], p["conv8.bias"])
    return torch.sigmoid(y).permute(0, 2, 3, 1)


# ----------------------------------------------------------------- policies

def standardize(x: torch.Tensor, dim: int, eps: float) -> torch.Tensor:
    """(x - mean) / (sqrt(unbiased var + 1e-12) + eps) along `dim`."""
    mean = x.mean(dim, keepdim=True)
    var = x.var(dim, keepdim=True, correction=1)
    return (x - mean) / (torch.sqrt(var + 1e-12) + eps)


def _batch_norm(p: Params, x: torch.Tensor) -> torch.Tensor:
    """Normalization by the current batch's statistics over (N, H, W),
    biased variance, eps 1e-5."""
    mean = x.mean((0, 2, 3), keepdim=True)
    var = ((x - mean) ** 2).mean((0, 2, 3), keepdim=True)
    return (x - mean) / torch.sqrt(var + 1e-5) * p["weight"].view(1, -1, 1, 1) \
        + p["bias"].view(1, -1, 1, 1)


def _pool(x, k, s=None):
    return F.max_pool2d(x, k, s or k)


def canvas_trunk(P: Precision, p: Params, canvas: torch.Tensor) -> torch.Tensor:
    """(B, C, C, 1) -> (B, F): four conv3x3 (no bias: the norm after it
    cancels one) -> batch norm -> ReLU stages with pools 8, 4, -, -, then
    pools 2x2/(2, 1) and 2x2/2, flattened channel-minor."""
    x = canvas.float().permute(0, 3, 1, 2)
    pools = ((8, 8), (4, 4), None, None)
    for i, pool in enumerate(pools):
        x = torch.relu(_batch_norm(sub(p, f"norms.{i}"), P.conv(x, p[f"convs.{i}.weight"], None, 1, 1)))
        if pool:
            x = _pool(x, pool)
    x = _pool(_pool(x, (2, 2), (2, 1)), (2, 2))
    return x.permute(0, 2, 3, 1).reshape(x.shape[0], -1)


def _mlp(P: Precision, p: Params, x: torch.Tensor) -> torch.Tensor:
    i = 0
    while f"final_fc.{i}.weight" in p:
        x = P.linear(x, p[f"final_fc.{i}.weight"], p[f"final_fc.{i}.bias"])
        i += 1
    return x


def _mask(logits: torch.Tensor, tgt: torch.Tensor) -> torch.Tensor:
    return logits * (1.0 - F.one_hot(tgt.long(), logits.shape[1]).float())


def _layer_norm(p: Params, x: torch.Tensor) -> torch.Tensor:
    mean = x.mean(-1, keepdim=True)
    var = ((x - mean) ** 2).mean(-1, keepdim=True)
    return (x - mean) / torch.sqrt(var + 1e-6) * p["weight"] + p["bias"]


def _dense(P: Precision, p: Params, x: torch.Tensor, n_in: int) -> torch.Tensor:
    """Contract the last `n_in` axes of x with a (*in, *out) kernel."""
    w = p["weight"]
    fan_in = math.prod(w.shape[:n_in])
    out = w.shape[n_in:]
    lead = x.shape[:x.dim() - n_in]
    y = P.matmul(x.reshape(-1, fan_in), w.reshape(fan_in, -1)) + p["bias"].reshape(-1)
    return y.reshape(lead + out)


def _attention(P: Precision, p: Params, x: torch.Tensor) -> torch.Tensor:
    """Multi-head self attention of x (B, L, hidden): softmax(q k^T / sqrt(D)) v."""
    q, k, v = (_dense(P, sub(p, n), x, 1).transpose(1, 2) for n in ("q", "k", "v"))
    s = P.matmul(q, k.transpose(-1, -2)) * q.shape[-1] ** -0.5
    o = P.matmul(torch.softmax(s, -1), v).transpose(1, 2)      # (B, L, H, D)
    return _dense(P, sub(p, "out"), o, 2)


def attention_encode(P: Precision, p: Params, feats: torch.Tensor, tgt: torch.Tensor,
                     depth: int) -> torch.Tensor:
    """feats (B, S, F), target (B,) -> per-frame embeddings (B, S, hidden):
    P patch tokens a frame plus frame, patch and target embeddings; each
    block is x + (LN(x) + MHA(LN(x))), then x + FF(LN(x)) with a tanh GELU;
    the patch tokens are averaged back to frames."""
    b, s, _ = feats.shape
    tok = _dense(P, sub(p, "tokenize"), feats.float(), 1)       # (B, S, P, H)
    n_tok, hidden = tok.shape[2:]
    tok = tok + p["frame_pos"][:s] + p["patch_pos"]
    tok = tok + F.one_hot(tgt.long(), s).float()[:, :, None, None] * p["target_emb"]
    x = tok.reshape(b, s * n_tok, hidden)
    for i in range(depth):
        blk = sub(p, f"block{i}")
        sa = sub(blk, "SelfAttentionBlock_0")
        y = _layer_norm(sub(sa, "LayerNorm_0"), x)
        x = x + y + _attention(P, sub(sa, "MultiHeadAttention_0"), y)
        ff = sub(blk, "FeedForwardBlock_0")
        y = _layer_norm(sub(ff, "LayerNorm_0"), x)
        y = F.gelu(P.linear(y, ff["Dense_0.weight"], ff["Dense_0.bias"]), approximate="tanh")
        x = x + P.linear(y, ff["Dense_1.weight"], ff["Dense_1.bias"])
    return x.reshape(b, s, n_tok, hidden).mean(2)


class Policy:
    """The context policy of a configuration ("canvas" or "attention"):
    raw logits for the actor, values for the critic. `obs` is the canvas
    policy's (canvas (B, C, C, 1), target feature (B, F)) or the attention
    policy's (feats (B, S, F),)."""

    def __init__(self, kind: str, depth: int, temperature: float):
        self.kind, self.depth, self.temperature = kind, depth, temperature

    def logits(self, P: Precision, p: Params, obs, tgt) -> torch.Tensor:
        """(B, S) logits with the target's own zeroed (not standardized)."""
        if self.kind == "attention":
            x = attention_encode(P, p, obs[0], tgt, self.depth)
            raw = P.linear(x, p["head.weight"], p["head.bias"])[..., 0]
        else:
            stacked = torch.cat([canvas_trunk(P, p, obs[0]), obs[1].float()], 1)
            raw = _mlp(P, p, stacked)
        return _mask(raw, tgt)

    def scores(self, P: Precision, p: Params, obs, tgt, gumbel: Optional[torch.Tensor]):
        """log_softmax((standardized masked logits + noise) / tau): what the
        actor ranks to pick its pair (greedy without noise)."""
        z = standardize(self.logits(P, p, obs, tgt), 1, 0.1)
        if gumbel is not None:
            z = z + gumbel.float()
        return torch.log_softmax(z / self.temperature, 1)

    def logprob(self, P: Precision, p: Params, obs, tgt, acs, gumbel) -> torch.Tensor:
        """PPO's logprob of a stored pair with fresh noise: the masked logits
        are not standardized again here, as in the original."""
        lp = torch.log_softmax((self.logits(P, p, obs, tgt) + gumbel.float())
                               / self.temperature, 1).gather(1, acs.long())
        return (lp[:, 0] + lp[:, 1]) / 2 + LN2

    def value(self, P: Precision, p: Params, obs, tgt) -> torch.Tensor:
        if self.kind == "attention":
            x = attention_encode(P, p, obs[0], tgt, self.depth).mean(1)
            return P.linear(x, p["value_head.weight"], p["value_head.bias"])[:, 0]
        stacked = torch.cat([canvas_trunk(P, p, obs[0]), obs[1].float()], 1)
        return _mlp(P, p, standardize(stacked, 0, 0.001))[:, 0]


def top2(scores: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """The two best frames of each row (ties to the lower index) and their
    pair logprob (mean of the two + LN2)."""
    values, idx = torch.sort(scores, dim=1, descending=True, stable=True)
    return idx[:, :2], values[:, :2].sum(1) / 2 + LN2
