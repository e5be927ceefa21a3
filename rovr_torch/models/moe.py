"""Switch-routed mixture-of-experts FFN (rovr_tpu/models/moe.py), on one
device.

`MoEFeedForward` is the drop-in for `attention.FeedForwardBlock` that
`EncoderBlock(moe_experts > 0)` builds under the flax name `moe_ff`:

  * LayerNorm (f32 params) -> the f32 `router` Dense -> softmax;
  * top-1 routing: expert = argmax (the first maximum), gate = max prob;
  * capacity cap = max(1, int(N / E * capacity_factor + 0.999)) over the
    N = B*L tokens (literally that expression, not math.ceil);
  * slot = sum over experts of (cumsum(onehot) - 1) * onehot: the token's
    place in its expert's queue in flat token order. The * onehot comes
    before the row sum: the other order leaks -1 from the E-1 unrouted
    columns and drops each expert's first E-1 tokens;
  * keep = slot < cap; the per-expert MLP gelu_tanh(xe @ w1 + b1) @ w2 + b2
    with the f32 params cast to the compute dtype; the combine scaled by the
    gate in the compute dtype. A dropped token's delta is exactly 0.

Dispatch. The JAX module builds a dense (N, E, C) one-hot and contracts it
twice. At config 5's PPO batch (N = 131,072 tokens, E = 4, C = 40,960) that
tensor has 2.15e10 entries, 85.9 GB in f32. The port dispatches by index
instead: each kept token is copied into its (expert, slot) row of an
(E*C + 1, d) buffer (row E*C takes the dropped tokens and is never read),
and the combine gathers the rows back. Each output row of the JAX einsum has
exactly one non-zero term, so this is the same function. `dispatch="onehot"`
keeps the einsum form as the plain version for the tests; no driver path
uses it. The expert products are batched matmuls, as XLA's einsums are in
JAX: no Pallas kernel is involved.

The Switch load-balance term E * sum_e f_e * P_e (JAX sows it under
("intermediates", "moe_aux")) is kept on the module as `moe_aux` after each
call. The PPO losses do not use it, as in JAX.

On a mesh (`mesh=`, each rank holding its data shard's tokens, the same on
every rank of the model axis) the module computes what the JAX module
computes on the global batch under GSPMD:
  * routing is global over the data axis: the capacity comes from the
    global N, and a token's slot is its place in its expert's queue in the
    global token order (the data shards in rank order), from the per-expert
    counts of the earlier data ranks (one all-gather of E counts and E
    probability sums, which also make `moe_aux` global);
  * expert parallelism: model rank m owns experts [m E/mp, (m+1) E/mp),
    their w1/b1/w2/b2 (and so their Adam moments; parallel/tp.py
    `EXPERT_RULES`). Each runs its experts on the kept tokens of its data
    shard routed to them, in a buffer of min(cap, N_local) rows per expert,
    and the combine is summed over the model axis (`reduce_from_model`: each
    token's output comes from one rank, the others add exact zeros). The
    tokens are replicated over the model axis, so nothing is sent to an
    expert: no all-to-all.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from rovr_torch.models.layers import LayerNorm, Linear, lecun_normal_
from rovr_torch.parallel import collectives, tp

DISPATCH = ("index", "onehot")


def capacity(n: int, num_experts: int, capacity_factor: float) -> int:
    """Slots per expert for n tokens, as the JAX module computes them."""
    return max(1, int(n / num_experts * capacity_factor + 0.999))


class MoEFeedForward(nn.Module):
    """Parameters in flax's layout: `LayerNorm_0`, `router` (a Linear, so
    weight (E, d)), w1 (E, d, d/4), b1 (E, d/4), w2 (E, d/4, d), b2 (E, d);
    on a mesh with a model axis, this rank's E/mp experts of the last four."""

    def __init__(self, hidden_dim: int, num_experts: int = 4,
                 capacity_factor: float = 1.25, dtype: torch.dtype = torch.bfloat16,
                 dispatch: str = "index", mesh=None):
        super().__init__()
        if dispatch not in DISPATCH:
            raise ValueError(f"dispatch must be one of {DISPATCH}, got {dispatch!r}")
        if mesh is not None and dispatch != "index":
            raise ValueError("the one-hot dispatch is the single-device twin: no mesh")
        d, e, f = hidden_dim, num_experts, hidden_dim // 4
        self.num_experts = e
        self.capacity_factor = capacity_factor
        self.dtype = dtype
        self.dispatch = dispatch
        self.mesh = mesh
        el = e if mesh is None else tp.part(e, mesh, "num_experts")
        self.first_expert = 0 if mesh is None else mesh.model_rank * el
        self.LayerNorm_0 = LayerNorm(d)
        self.router = Linear(d, e, compute_dtype=torch.float32)
        self.w1 = nn.Parameter(torch.empty(el, d, f))
        self.b1 = nn.Parameter(torch.zeros(el, f))
        self.w2 = nn.Parameter(torch.empty(el, f, d))
        self.b2 = nn.Parameter(torch.zeros(el, d))
        if mesh is not None and mesh.model_size > 1:
            self.model_shards = {name: (dim, mesh.model_size, mesh.model_rank)
                                 for name, dim in tp.EXPERT_RULES.items()}
        # flax_init_state: lecun-normal with the expert axis as batch axis
        self.lecun_init = {"w1": d, "w2": f}
        self.zero_init = ("b1", "b2")
        for name, fan_in in self.lecun_init.items():
            lecun_normal_(getattr(self, name), fan_in)
        self.moe_aux = None

    def route(self, tokens: torch.Tensor):
        """(N, d) f32 tokens -> (expert, gate, slot, keep, cap), each (N,)
        but cap; sets `moe_aux`. On a mesh the capacity and `keep` are the
        global ones, and `slot` is the place among this data shard's tokens
        (the global slot less the earlier shards' count)."""
        n, e = tokens.shape[0], self.num_experts
        probs = torch.softmax(self.router(tokens), dim=-1)       # (N, E) f32
        expert = torch.argmax(probs, dim=-1)
        gate = probs.gather(1, expert[:, None])[:, 0]
        # expert-major (E, N), so the running count is a scan along the
        # innermost axis (a scan down an (N, E) column walks N rows in one
        # thread per column on CUDA); built by scatter, as F.one_hot checks
        # its indices on the host, a device sync per call
        onehot = torch.zeros(e, n, dtype=torch.long, device=tokens.device)
        onehot.scatter_(0, expert[None], 1)                      # (E, N) int64
        slot = ((onehot.cumsum(1) - 1) * onehot).sum(0)
        if self.mesh is None:
            self.moe_aux = e * (onehot.float().mean(1) * probs.mean(0)).sum()
            cap = capacity(n, e, self.capacity_factor)
            return expert, gate, slot, slot < cap, cap
        # every data shard's per-expert counts and probability sums
        stats = collectives.all_gather(
            torch.cat([onehot.sum(1).float(), probs.detach().sum(0)]), self.mesh,
            tiled=False)                                         # (dp, 2E)
        n_all = n * self.mesh.size
        counts = stats[:, :e].sum(0)
        self.moe_aux = e * ((counts / n_all) * (stats[:, e:].sum(0) / n_all)).sum()
        offset = stats[:self.mesh.rank, :e].sum(0).long()        # earlier shards'
        cap = capacity(n_all, e, self.capacity_factor)
        return expert, gate, slot, slot + offset[expert] < cap, cap

    def experts(self, xe: torch.Tensor) -> torch.Tensor:
        """The per-expert MLP on (E, C, d) in the compute dtype."""
        cdt = self.dtype
        h = torch.bmm(xe, self.w1.to(cdt)) + self.b1[:, None].to(cdt)
        h = F.gelu(h, approximate="tanh")
        return torch.bmm(h, self.w2.to(cdt)) + self.b2[:, None].to(cdt)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        b, l, d = x.shape
        e, cdt = self.num_experts, self.dtype
        tokens = self.LayerNorm_0(x).reshape(b * l, d)           # f32
        expert, gate, slot, keep, cap = self.route(tokens)
        tok_c = tokens.to(cdt)
        if self.dispatch == "onehot":
            slot_oh = F.one_hot(torch.where(keep, slot, cap), cap + 1)[:, None, :cap]
            dispatch = (F.one_hot(expert, e)[:, :, None] * slot_oh).to(cdt)  # (N, E, C)
            out = self.experts(torch.einsum("nec,nd->ecd", dispatch, tok_c))
            y = torch.einsum("nec,ecd->nd", dispatch, out)
        elif self.mesh is None:
            row = torch.where(keep, expert * cap + slot, e * cap)
            buf = tok_c.new_zeros(e * cap + 1, d).index_copy(0, row, tok_c)
            out = self.experts(buf[:e * cap].view(e, cap, d)).reshape(e * cap, d)
            y = torch.cat([out, out.new_zeros(1, d)])[row]
        else:
            # this rank's experts on this data shard's kept tokens: a kept
            # token's place among the shard's is below min(cap, N_local)
            el, c = self.w1.shape[0], min(cap, b * l)
            mine = expert - self.first_expert
            own = keep & (mine >= 0) & (mine < el)
            row = torch.where(own, mine * c + slot, el * c)
            tok_c = collectives.copy_to_model(tok_c, self.mesh)
            buf = tok_c.new_zeros(el * c + 1, d).index_copy(0, row, tok_c)
            out = self.experts(buf[:el * c].view(el, c, d)).reshape(el * c, d)
            y = collectives.reduce_from_model(torch.cat([out, out.new_zeros(1, d)])[row],
                                              self.mesh)
        return (y * gate[:, None].to(cdt)).reshape(b, l, d)
