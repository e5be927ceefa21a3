"""Ring attention: sequence-parallel attention over a mesh axis
(rovr_tpu/parallel/ring_attention.py).

Each rank holds a chunk of the sequence. It computes its queries against
the key/value chunk it holds, passes that chunk to the next rank around the
ring (`collectives.ppermute_ring`, differentiable), and merges each block
into the online-softmax triple (max, sum, accumulator): n blocks over n
ranks, O(L/n) memory per rank. As in JAX, the blocks are plain products
(logits from f32 q against k with f32 accumulation), not the flash kernel:
the JAX ring is `jnp`, outside any Pallas kernel.

  * `ring_attention(q, k, v, mesh, axis_name)`: local chunks in, the local
    output chunk out;
  * `ring_attend(q, k, v, mesh, axis_name)`: tensors every rank of the axis
    holds whole (the rank's batch shard with the whole sequence, as the
    attention policy has them): split the sequence, run the ring, gather it;
  * `ring_self_attention_sharded(mesh, q, k, v, seq_axis)`: the JAX entry's
    global view: the batch split over the other axis, the sequence over
    `seq_axis`, the whole output on every rank.
Each raises where the sequence does not split over the axis (and the last
where the batch does not split over the other); none falls back to local
attention.
"""

from __future__ import annotations

import torch

from rovr_torch.parallel import collectives
from rovr_torch.parallel.mesh import DATA_AXIS, MODEL_AXIS, Mesh

_NEG_INF = -1e30


def _block_merge(m_prev, s_prev, acc, q, k, v, scale):
    """Merge one k/v block into the running online-softmax state.

    q (B,H,Lq,D) f32; k, v (B,H,Lk,D); m/s (B,H,Lq,1); acc (B,H,Lq,D) f32."""
    logits = torch.einsum("bhqd,bhkd->bhqk", q, k.float()) * scale
    m_cur = logits.amax(-1, keepdim=True)
    m_new = torch.maximum(m_prev, m_cur)
    alpha = torch.exp(m_prev - m_new)
    p = torch.exp(logits - m_new)
    s_new = s_prev * alpha + p.sum(-1, keepdim=True)
    acc_new = acc * alpha + torch.einsum("bhqk,bhkd->bhqd", p, v.float())
    return m_new, s_new, acc_new


def _check_split(n: int, parts: int, what: str, axis_name: str) -> None:
    if n % parts:
        raise ValueError(f"attn_impl='ring': {what} {n} must divide over the mesh's "
                         f"{axis_name!r} axis ({parts}); refusing to fall back to local "
                         "attention")


def ring_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, mesh: Mesh,
                   axis_name: str = MODEL_AXIS) -> torch.Tensor:
    """Full (non-causal) attention with k/v passed around `axis_name`.
    q, k, v: this rank's sequence chunks (B, H, L/n, D); returns its output
    chunk (B, H, L/n, D) in q's dtype."""
    n = mesh.axis(axis_name).size
    scale = q.shape[-1] ** -0.5
    qf = q.float()
    m = torch.full_like(qf[..., :1], _NEG_INF)
    s = torch.zeros_like(qf[..., :1])
    acc = torch.zeros_like(qf)
    kk, vv = k, v
    for i in range(n):
        m, s, acc = _block_merge(m, s, acc, qf, kk, vv, scale)
        if i < n - 1:   # the last block's k/v go nowhere
            kk, vv = collectives.ppermute_ring((kk, vv), mesh, axis_name, 1)
    return (acc / s).to(q.dtype)


def ring_attend(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, mesh: Mesh,
                axis_name: str = MODEL_AXIS) -> torch.Tensor:
    """Ring attention of (B, H, L, D) tensors that every rank of the axis
    holds whole: each rank takes its sequence chunk, the ring runs, the
    output chunks are gathered back (differentiably: the gradient of a
    whole input comes back whole on every rank)."""
    n = mesh.axis(axis_name).size
    _check_split(q.shape[2], n, "query length", axis_name)
    _check_split(k.shape[2], n, "key length", axis_name)
    q, k, v = (collectives.split(t, mesh, axis_name, 2) for t in (q, k, v))
    return collectives.gather(ring_attention(q, k, v, mesh, axis_name), mesh, axis_name, 2)


def ring_self_attention_sharded(mesh: Mesh, q: torch.Tensor, k: torch.Tensor,
                                v: torch.Tensor, seq_axis: str = MODEL_AXIS) -> torch.Tensor:
    """The JAX entry's global view: q, k, v (B, H, L, D) the same on every
    rank; the batch split over the other axis, L over `seq_axis`; returns
    the whole output on every rank."""
    batch_axis = DATA_AXIS if seq_axis == MODEL_AXIS else MODEL_AXIS
    _check_split(q.shape[0], mesh.axis(batch_axis).size, "batch", batch_axis)
    q, k, v = (collectives.split(t, mesh, batch_axis, 0) for t in (q, k, v))
    return collectives.gather(ring_attend(q, k, v, mesh, seq_axis), mesh, batch_axis, 0)
