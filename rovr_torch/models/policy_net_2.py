"""Policy network pi2 / V2: pick the TWO context frames for inpainting the
current target (rovr_tpu/models/policy_net_2.py).

  * `_video_conv`: 4x [conv3x3 -> batch-stat norm -> relu -> maxpool] over
    the (C,C,1) state canvas (pools 8x, 4x, 1x, then 2x2/s(2,1) and 2x2)
    -> flattened trunk feature (1024-d on the 160^2 canvas).
  * concat with the target's per-frame feature -> final_fc chain of bare
    Linears -> num_frames logits.
  * masked logits: the target's own logit is zeroed, then standardized with
    eps 0.1.
  * act: Gumbel (or greedy) top-2 of log_softmax(logits / tau); joint
    logprob (log p_a + log p_b)/2 + LN2.

The trunk output is flattened in NHWC order (spatial-major), as the JAX
package flattens, so `final_fc`'s first layer takes the JAX weights as they
are (transposed) with no row permutation.

`canvas_impl` picks stage 1's layout: "plain" (and "auto", which resolves
to it, as in the JAX package) runs the 1-channel conv on the canvas;
"s2d" runs it as one conv over 8x8 space-to-depth tiles
(`CanvasConv3x3(packed=True)`), then the norm and ReLU on the packed
tensor and the 8x8 pool as a max over the two block axes. Both are the same
function on the same parameters; "s2d" is an opt-in, the default stays
plain (see PERF.md for both paths' times on the card).
"""

from __future__ import annotations

from typing import Optional, Sequence

import torch
from torch import nn

from rovr_torch.models.layers import (
    BatchStatNorm, CanvasConv3x3, MLP, max_pool, reference_tensor, standardize,
)
from rovr_torch.models.policy_net_1 import gumbel_log_softmax
from rovr_torch.parallel import collectives

LN2 = 0.69314  # the original policy's literal constant (policy_net_2.py:101)
_TRUNK = (64, 128, 256, 512)
CANVAS_IMPLS = ("auto", "plain", "s2d")


def _trunk_hw(canvas_size: int):
    """Spatial size of the trunk output: floor-mode VALID pools (an axis can
    reach 0, as on a 96^2 canvas, and then the trunk adds no features)."""
    h = w = canvas_size // 8 // 4
    h, w = (h - 2) // 2 + 1, (w - 2) // 1 + 1
    h, w = (h - 2) // 2 + 1, (w - 2) // 2 + 1
    return max(h, 0), max(w, 0)


class PolicyNet2(nn.Module):
    def __init__(self, num_frames: int = 20,
                 fc_dims: Sequence[int] = (1024, 512, 256, 64),
                 temperature: float = 0.7, is_critic: bool = False,
                 dtype: torch.dtype = torch.bfloat16,
                 per_sample_stats: bool = False, canvas_size: int = 160,
                 feature_dim: int = 1024, canvas_impl: str = "auto"):
        super().__init__()
        if canvas_impl not in CANVAS_IMPLS:
            raise ValueError(f"canvas_impl must be one of {CANVAS_IMPLS}, "
                             f"got {canvas_impl!r}")
        self.canvas_impl = canvas_impl
        self.num_frames = num_frames
        self.temperature = temperature
        self.is_critic = is_critic
        self.dtype = dtype
        cins = (1,) + _TRUNK[:-1]
        self.convs = nn.ModuleList(
            CanvasConv3x3(ci, f, dtype=dtype, fold_bias_into_norm=True)
            for ci, f in zip(cins, _TRUNK)
        )
        self.norms = nn.ModuleList(
            BatchStatNorm(f, dtype=dtype, per_sample=per_sample_stats)
            for f in _TRUNK
        )
        h, w = _trunk_hw(canvas_size)
        out = 1 if is_critic else num_frames
        self.final_fc = MLP(_TRUNK[-1] * h * w + feature_dim, tuple(fc_dims) + (out,))

    def _video_conv(self, canvas: torch.Tensor) -> torch.Tensor:
        """(B,C,C,1) -> (B, trunk features) f32."""
        x = canvas.to(self.dtype).permute(0, 3, 1, 2)
        relu = torch.relu
        if self.canvas_impl == "s2d":   # (B,64,8,8,C/8,C/8); the max is the 8x8 pool
            x = relu(self.norms[0](self.convs[0](x, packed=True))).amax(dim=(2, 3))
        else:
            x = max_pool(relu(self.norms[0](self.convs[0](x))), (8, 8))
        x = max_pool(relu(self.norms[1](self.convs[1](x))), (4, 4))
        x = relu(self.norms[2](self.convs[2](x)))
        x = relu(self.norms[3](self.convs[3](x)))
        x = max_pool(x, (2, 2), (2, 1))
        x = max_pool(x, (2, 2), (2, 2))
        return x.permute(0, 2, 3, 1).reshape(x.shape[0], -1).float()

    def _stacked(self, canvas, target_feat) -> torch.Tensor:
        return torch.cat([self._video_conv(canvas), target_feat.float()], dim=1)

    def _masked(self, logits, target_idx) -> torch.Tensor:
        idx = target_idx.reshape(-1).long()
        onehot = torch.nn.functional.one_hot(idx, self.num_frames).to(logits.dtype)
        return logits * (1.0 - onehot)

    def masked_logits(self, canvas, target_feat, target_idx) -> torch.Tensor:
        """Standardized logits with the target's own logit zeroed.
        target_idx: int (B,) or (B,1)."""
        if self.is_critic:
            raise ValueError("masked_logits() is for the actor head")
        logits = self.final_fc(self._stacked(canvas, target_feat))
        return standardize(self._masked(logits, target_idx), dim=1, eps=0.1)

    def forward(self, canvas, target_feat, target_idx, greedy: bool = False,
                gumbel: Optional[torch.Tensor] = None,
                generator: Optional[torch.Generator] = None):
        return self.act(canvas, target_feat, target_idx, greedy, gumbel, generator)

    def act(self, canvas, target_feat, target_idx, greedy: bool = False,
            gumbel: Optional[torch.Tensor] = None,
            generator: Optional[torch.Generator] = None):
        """Top-2 context frames. Returns (actions (B,2) int64, logprob (B,)).
        `greedy` drops the Gumbel noise (the deterministic readout serving
        uses); otherwise the noise is `gumbel` (B, num_frames) or is drawn
        from `generator`."""
        logits = self.masked_logits(canvas, target_feat, target_idx)
        if greedy:
            logp = torch.log_softmax(logits / self.temperature, dim=1)
        else:
            logp = gumbel_log_softmax(logits, self.temperature, gumbel, generator)
        # top-2 with ties to the lower index, as lax.top_k breaks them (an
        # all-equal row of logits does occur); torch.topk leaves ties open
        values, indices = torch.sort(logp, dim=1, descending=True, stable=True)
        logprob = values[:, :2].sum(1) / 2 + LN2
        return indices[:, :2].detach(), logprob.detach()

    def logprob(self, canvas, target_feat, target_idx, action,
                gumbel: Optional[torch.Tensor] = None,
                generator: Optional[torch.Generator] = None) -> torch.Tensor:
        """PPO logprob of a stored context pair with fresh Gumbel noise. Like
        the JAX package (and the original), it does NOT re-standardize
        after masking."""
        if self.is_critic:
            raise ValueError("logprob() is for the actor head")
        logits = self._masked(self.final_fc(self._stacked(canvas, target_feat)),
                              target_idx)
        logp = gumbel_log_softmax(logits, self.temperature, gumbel, generator)
        lp = logp.gather(1, action.long())
        return (lp[:, 0] + lp[:, 1]) / 2 + LN2

    def value(self, canvas, target_feat) -> torch.Tensor:
        """Critic: batch-standardize the stacked feature (over the global
        batch inside `collectives.global_batch(mesh)`), then final_fc."""
        if not self.is_critic:
            raise ValueError("value() is for the critic head")
        stacked = standardize(self._stacked(canvas, target_feat), dim=0, eps=0.001,
                              mesh=collectives.current_mesh())
        return self.final_fc(stacked)[:, 0]


def convert_torch_state_dict(state_dict) -> dict:
    """A reference PolicyNetwork2UNet checkpoint (policy_net_2.py:41-69) ->
    this module's state dict: video_conv's convs (Sequential indices 0, 4,
    8, 12) -> convs.0-3, its BatchNorms (1, 5, 9, 13) -> norms.0-3 (running
    statistics dropped: the norms use the batch's), final_fc.0-4 as they are.

    One layout differs: torch flattens the conv trunk (B, 512, 1, 2)
    channel-major, this module NHWC (B, 1, 2, 512), so the first 1024
    input columns of final_fc.0 are permuted (the target feature's columns
    1024.. map through unchanged)."""
    out = {}
    for j, seq in enumerate((0, 4, 8, 12)):
        for leaf in ("weight", "bias"):
            out[f"convs.{j}.{leaf}"] = reference_tensor(state_dict, f"video_conv.{seq}.{leaf}")
            out[f"norms.{j}.{leaf}"] = reference_tensor(state_dict,
                                                        f"video_conv.{seq + 1}.{leaf}")
    for j in range(5):
        for leaf in ("weight", "bias"):
            out[f"final_fc.{j}.{leaf}"] = reference_tensor(state_dict, f"final_fc.{j}.{leaf}")
    # NHWC column w * 512 + c reads torch's column c * 2 + w
    c, w = torch.meshgrid(torch.arange(512), torch.arange(2), indexing="xy")
    perm = (c * 2 + w).reshape(-1)
    fc0 = out["final_fc.0.weight"]
    out["final_fc.0.weight"] = torch.cat([fc0[:, :1024][:, perm], fc0[:, 1024:]], dim=1)
    return out
