"""Quality and evaluation metrics: PSNR, SSIM, optical-flow preservation and
context exposure (rovr_tpu/ops/metrics.py, PyTorch port).

Images are NHWC (any leading axes, trailing (H, W, C)), as in the JAX
package. Everything computes in float32. SSIM's Gaussian blur is a
depthwise VALID convolution, H then W (stock `F.conv2d`: XLA lowered it by
itself in the JAX package, so no kernel of the port stands behind it).
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from rovr_torch.parallel import collectives

_EPS32 = torch.finfo(torch.float32).eps


def psnr(x: torch.Tensor, y: torch.Tensor, max_val: float = 1.0) -> torch.Tensor:
    """Peak signal-to-noise ratio over the trailing (H, W, C) axes."""
    mse = ((x.float() - y.float()) ** 2).mean((-3, -2, -1))
    return 10.0 * torch.log10(max_val ** 2 / mse.clamp_min(1e-12))


def _gaussian(filter_size: int, sigma: float, device) -> torch.Tensor:
    r = filter_size // 2
    coords = torch.arange(-r, r + 1, dtype=torch.float32, device=device)
    g = torch.exp(-(coords ** 2) / (2 * sigma ** 2))
    return g / g.sum()


def ssim(x: torch.Tensor, y: torch.Tensor, max_val: float = 1.0,
         filter_size: int = 11, sigma: float = 1.5, k1: float = 0.01,
         k2: float = 0.03) -> torch.Tensor:
    """Gaussian-windowed SSIM of (..., H, W, C) images, the mean over space
    and channels: one value per leading index."""
    lead = x.shape[:-3]
    c = x.shape[-1]
    g = _gaussian(filter_size, sigma, x.device)
    kh = g.view(1, 1, filter_size, 1).expand(c, 1, filter_size, 1)
    kw = g.view(1, 1, 1, filter_size).expand(c, 1, 1, filter_size)

    def blur(img):  # (N, C, H, W), separable, VALID
        return F.conv2d(F.conv2d(img, kh, groups=c), kw, groups=c)

    x = x.float().reshape((-1,) + tuple(x.shape[-3:])).permute(0, 3, 1, 2)
    y = y.float().reshape((-1,) + tuple(y.shape[-3:])).permute(0, 3, 1, 2)
    mu_x, mu_y = blur(x), blur(y)
    mu_x2, mu_y2, mu_xy = mu_x * mu_x, mu_y * mu_y, mu_x * mu_y
    sx = blur(x * x) - mu_x2
    sy = blur(y * y) - mu_y2
    sxy = blur(x * y) - mu_xy
    c1 = (k1 * max_val) ** 2
    c2 = (k2 * max_val) ** 2
    s = ((2 * mu_xy + c1) * (2 * sxy + c2)) / ((mu_x2 + mu_y2 + c1) * (sx + sy + c2))
    return s.mean((-3, -2, -1)).reshape(lead)


def preservation(org_values: torch.Tensor, computed_values: torch.Tensor) -> torch.Tensor:
    """1 - |computed - org| / org, an org of 0 replaced by float32 eps."""
    org = torch.where(org_values == 0, torch.full_like(org_values, _EPS32), org_values)
    return 1.0 - (computed_values - org).abs() / org


def flow_recovery(recon_flow: torch.Tensor, org_flow: torch.Tensor,
                  corrupted_flow: torch.Tensor) -> torch.Tensor:
    """O = 1 - |φ(recon) - φ(org)| / |φ(corrupted) - φ(org)|: 1 when the
    reconstruction restores the original's flow magnitude exactly."""
    return 1.0 - (recon_flow - org_flow).abs() / (corrupted_flow - org_flow).abs()


def spatio_reward(recon_flow, org_flow, corrupted_flow,
                  scale: float = 7.5) -> torch.Tensor:
    """flow_recovery(...) * scale."""
    return flow_recovery(recon_flow, org_flow, corrupted_flow) * scale


def flow_magnitudes(flows: torch.Tensor) -> torch.Tensor:
    """Per-pair scalar magnitude sqrt(sum flow^2): (P, H, W, 2) -> (P,)."""
    return torch.sqrt((flows.float() ** 2).sum((-3, -2, -1)))


def _exposure_sums(hole: torch.Tensor, tgt_idx: torch.Tensor, pairs: torch.Tensor):
    """Per step and clip, (T, B) each: num = sum(ht * (1 - ha * hb)), the
    target's hole pixels that a chosen context exposes, and den = sum(ht)."""
    b = hole.shape[0]
    ar = torch.arange(b, device=hole.device)[None, :]
    tgt_idx, pairs = tgt_idx.long(), pairs.long()
    ht = hole[ar, tgt_idx]                   # (T, B, H, W, 1)
    ha = hole[ar, pairs[..., 0]]
    hb = hole[ar, pairs[..., 1]]
    dims = tuple(range(2, ht.dim()))
    return (ht * (1.0 - ha * hb)).sum(dims), ht.sum(dims)


def context_exposure(hole: torch.Tensor, tgt_idx: torch.Tensor,
                     pairs: torch.Tensor, mesh=None) -> torch.Tensor:
    """The fraction of the targets' hole pixels visible in at least one
    chosen context frame, pooled over the batch (with a data `mesh`, over
    the global batch: both sums are all-reduced).

    hole: (B, S, H, W, 1), 1 where corruption removed content; tgt_idx:
    (T, B) target frame per step; pairs: (T, B, 2) chosen contexts."""
    num, den = _exposure_sums(hole.float(), tgt_idx, pairs)
    num, den = num.sum(1).sum(), den.sum(1).sum()
    if mesh is not None:
        num, den = collectives.all_reduce_(torch.stack([num, den]), mesh).unbind()
    return num / den.clamp_min(1.0)


def context_exposure_per_clip(hole: torch.Tensor, tgt_idx: torch.Tensor,
                              pairs: torch.Tensor) -> torch.Tensor:
    """`context_exposure` per clip: (B,) rates, weighted by hole pixels over
    the clip's own steps."""
    num, den = _exposure_sums(hole.float(), tgt_idx, pairs)
    return num.sum(0) / den.sum(0).clamp_min(1.0)
