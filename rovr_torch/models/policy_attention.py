"""Attention context policy (rovr_tpu/models/policy_attention.py): the
pi2-compatible actor/critic over per-frame feature tokens.

obs: feats (B, S, feature_dim). Each frame becomes `patch_tokens` tokens
(`tokenize`, a DenseGeneral to (P, hidden)), plus a learned frame and patch
position and, at the target frame, a learned target embedding; `depth`
EncoderBlocks contextualize the S*P tokens (attention through K2-K4 on
CUDA); patch tokens are mean-pooled back to frames.

  * actor: per-frame logits (`head`), the target's own logit zeroed, then
    standardized (eps 0.1); top-2 of the Gumbel (or greedy) log-softmax at
    temperature tau; joint logprob (log p_a + log p_b)/2 + LN2;
  * critic: `value_head` on the frame embeddings' mean.

As in the JAX package, the actor has no `value_head` and the critic no
`head` (flax creates only the parameters its init call reaches). The noise
is an input: a (B, S) tensor or a `torch.Generator`. With moe_experts > 0
each block's FFN is the switch-routed mixture of experts (models/moe.py,
capacity factor `moe_capacity`); its `moe_aux` is on `block{i}.moe_ff`
after a call.

On a mesh (`mesh`, this rank's batch shard in every call): ring attention
(attn_impl="ring") over `seq_axis`; the MoE routed over the global batch,
its experts split over the model axis; `tensor_parallel` splits the
blocks' heads and FFN columns over the model axis; and pp_microbatches > 0
pipelines the encoder stack over the model axis (parallel/pp.py: depth
blocks in model_size stages, that many microbatches), where inside a stage
the attention is "jnp" when the policy's is "ring" and the MoE is local to
its microbatch (its capacity from the microbatch's tokens), as in the JAX
`_apply_blocks_pipelined`. Ring attention and the pipeline need a mesh;
the pipeline and tensor parallelism cannot share the one model axis.
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn

from rovr_torch.models.attention import EncoderBlock
from rovr_torch.models.layers import DenseGeneral, standardize
from rovr_torch.models.policy_net_1 import gumbel_log_softmax
from rovr_torch.models.policy_net_2 import LN2
from rovr_torch.parallel.mesh import MODEL_AXIS
from rovr_torch.parallel.pp import pipeline_layers


class AttentionContextPolicy(nn.Module):
    normal_init = {"frame_pos": 0.02, "patch_pos": 0.02, "target_emb": 0.02}

    def __init__(self, num_frames: int = 64, feature_dim: int = 1024,
                 hidden_dim: int = 256, num_heads: int = 4, depth: int = 2,
                 patch_tokens: int = 1, temperature: float = 0.7,
                 is_critic: bool = False, dtype: torch.dtype = torch.bfloat16,
                 attn_impl: str = "auto", pp_microbatches: int = 0,
                 moe_experts: int = 0, moe_capacity: float = 1.25, mesh=None,
                 seq_axis=None, tensor_parallel: bool = False):
        super().__init__()
        if (attn_impl == "ring" or pp_microbatches > 0) and mesh is None:
            raise ValueError("attn_impl='ring' / pp_microbatches>0 need a mesh")
        if pp_microbatches > 0 and tensor_parallel:
            raise ValueError("pipeline and tensor parallelism on the one model axis: the "
                             "stages and the heads cannot both split it")
        self.mesh = mesh
        self.pp_microbatches = pp_microbatches
        # pipelined: each stage applies whole blocks to its microbatches
        self.pipelined = pp_microbatches > 0 and mesh.model_size > 1
        if self.pipelined:
            attn_impl = "jnp" if attn_impl == "ring" else attn_impl
            mesh = seq_axis = None
        self.num_frames = num_frames
        self.hidden_dim = hidden_dim
        self.patch_tokens = p = patch_tokens
        self.temperature = temperature
        self.is_critic = is_critic
        self.dtype = dtype
        self.tokenize = DenseGeneral((feature_dim,), (p, hidden_dim))
        self.frame_pos = nn.Parameter(torch.empty(num_frames, 1, hidden_dim))
        self.patch_pos = nn.Parameter(torch.empty(1, p, hidden_dim))
        self.target_emb = nn.Parameter(torch.empty(hidden_dim))
        for name, std in self.normal_init.items():
            nn.init.normal_(getattr(self, name), 0.0, std)
        self.depth = depth
        for i in range(depth):
            self.add_module(f"block{i}", EncoderBlock(
                hidden_dim, num_heads, dtype, attn_impl, moe_experts, moe_capacity,
                mesh, seq_axis, tensor_parallel))
        if is_critic:
            self.value_head = nn.Linear(hidden_dim, 1)
        else:
            self.head = nn.Linear(hidden_dim, 1)

    def _encode(self, feats: torch.Tensor, target_idx: torch.Tensor) -> torch.Tensor:
        """feats (B, S, feature_dim), target_idx (B,) -> (B, S, hidden) f32."""
        b, s, _ = feats.shape
        p = self.patch_tokens
        tok = self.tokenize(feats.float())  # (B, S, P, H)
        tok = tok + self.frame_pos[:s] + self.patch_pos
        mark = F.one_hot(target_idx.reshape(-1).long(), s).float()
        tok = tok + mark[:, :, None, None] * self.target_emb
        x = tok.reshape(b, s * p, self.hidden_dim).to(self.dtype)
        blocks = [getattr(self, f"block{i}") for i in range(self.depth)]
        if self.pipelined:
            x = pipeline_layers(
                lambda params, a: torch.func.functional_call(blocks[0], params, (a,)),
                [dict(blk.named_parameters()) for blk in blocks], x, self.mesh,
                MODEL_AXIS, self.pp_microbatches)
        else:
            for blk in blocks:
                x = blk(x)
        return x.reshape(b, s, p, self.hidden_dim).mean(2).float()

    def _masked(self, x: torch.Tensor, target_idx: torch.Tensor) -> torch.Tensor:
        logits = self.head(x)[..., 0]  # (B, S)
        onehot = F.one_hot(target_idx.reshape(-1).long(), logits.shape[1])
        return logits * (1.0 - onehot.to(logits.dtype))

    def masked_logits(self, feats, target_idx) -> torch.Tensor:
        """Per-frame logits, the target's own zeroed, then standardized."""
        if self.is_critic:
            raise ValueError("masked_logits() is for the actor head")
        return standardize(self._masked(self._encode(feats, target_idx), target_idx),
                           dim=1, eps=0.1)

    def forward(self, feats, target_idx, greedy: bool = False,
                gumbel: Optional[torch.Tensor] = None,
                generator: Optional[torch.Generator] = None):
        return self.act(feats, target_idx, greedy, gumbel, generator)

    def act(self, feats, target_idx, greedy: bool = False,
            gumbel: Optional[torch.Tensor] = None,
            generator: Optional[torch.Generator] = None):
        """Top-2 context frames: (actions (B,2) int64, logprob (B,))."""
        logits = self.masked_logits(feats, target_idx)
        if greedy:
            logp = torch.log_softmax(logits / self.temperature, dim=1)
        else:
            logp = gumbel_log_softmax(logits, self.temperature, gumbel, generator)
        # ties to the lower index, as lax.top_k breaks them
        values, indices = torch.sort(logp, dim=1, descending=True, stable=True)
        logprob = values[:, :2].sum(1) / 2 + LN2
        return indices[:, :2].detach(), logprob.detach()

    def logprob(self, feats, target_idx, action,
                gumbel: Optional[torch.Tensor] = None,
                generator: Optional[torch.Generator] = None) -> torch.Tensor:
        """PPO logprob of a stored context pair with fresh Gumbel noise (no
        re-standardization after masking, as in the JAX package)."""
        if self.is_critic:
            raise ValueError("logprob() is for the actor head")
        logits = self._masked(self._encode(feats, target_idx), target_idx)
        logp = gumbel_log_softmax(logits, self.temperature, gumbel, generator)
        lp = logp.gather(1, action.long())
        return (lp[:, 0] + lp[:, 1]) / 2 + LN2

    def value(self, feats, target_idx) -> torch.Tensor:
        """Critic: mean-pooled frame embeddings -> scalar."""
        if not self.is_critic:
            raise ValueError("value() is for the critic head")
        return self.value_head(self._encode(feats, target_idx).mean(1))[:, 0]
