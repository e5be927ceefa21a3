"""ActionLSTM (rovr_tpu/models/action_lstm.py): encodes the running
(target, context, context) action history into a canvas-shaped token for
the frame-selection policy pi1.

One LSTM cell over cat(action indices / 48, the flattened canvas tiles of
the three chosen frames), then a linear head to token_size^2, reshaped to
(B, C, C, 1). Always float32, as the JAX package builds it.

The cell is flax's OptimizedLSTMCell: the carry is (c, h), in that order;
gates i, f, g, o (sigmoid, sigmoid, tanh, sigmoid); the input kernels
`ii`..`io` have no bias and the recurrent ones `hi`..`ho` carry it. The
submodules keep those names, so JAX weights map by rule, and the cell
computes as flax does: one product on the concatenated input kernels, one
on the concatenated recurrent kernels. The state is an explicit carry:
`init_carry` gives zeros.
"""

from __future__ import annotations

from typing import Tuple

import torch
import torch.nn.functional as F
from torch import nn

from rovr_torch.models.layers import RecurrentLinear

GATES = ("i", "f", "g", "o")


class OptimizedLSTMCell(nn.Module):
    def __init__(self, in_features: int, hidden: int):
        super().__init__()
        self.hidden = hidden
        for g in GATES:
            # "if" is a keyword: the names are set, and read, by string
            self.add_module(f"i{g}", nn.Linear(in_features, hidden, bias=False))
            self.add_module(f"h{g}", RecurrentLinear(hidden, hidden))

    def forward(self, carry: Tuple[torch.Tensor, torch.Tensor], x: torch.Tensor
                ) -> Tuple[Tuple[torch.Tensor, torch.Tensor], torch.Tensor]:
        c, h = carry
        w_i = torch.cat([getattr(self, f"i{g}").weight for g in GATES])
        w_h = torch.cat([getattr(self, f"h{g}").weight for g in GATES])
        b_h = torch.cat([getattr(self, f"h{g}").bias for g in GATES])
        y = F.linear(x, w_i) + F.linear(h, w_h, b_h)
        i, f, g, o = y.split(self.hidden, -1)
        new_c = torch.sigmoid(f) * c + torch.sigmoid(i) * torch.tanh(g)
        new_h = torch.sigmoid(o) * torch.tanh(new_c)
        return (new_c, new_h), new_h


class ActionLSTM(nn.Module):
    def __init__(self, hidden_dim: int = 1024, token_size: int = 160, tile: int = 32):
        super().__init__()
        self.hidden_dim = hidden_dim
        self.token_size = token_size
        self.tile = tile
        self.cell = OptimizedLSTMCell(3 + 3 * tile * tile, hidden_dim)
        self.fc = nn.Linear(hidden_dim, token_size * token_size)

    def init_carry(self, batch_size: int) -> Tuple[torch.Tensor, torch.Tensor]:
        """Zero (c, h) on the module's device."""
        dev = self.fc.weight.device
        shape = (batch_size, self.hidden_dim)
        return (torch.zeros(shape, device=dev), torch.zeros(shape, device=dev))

    def forward(self, carry: Tuple[torch.Tensor, torch.Tensor], actions: torch.Tensor,
                patches: torch.Tensor
                ) -> Tuple[Tuple[torch.Tensor, torch.Tensor], torch.Tensor]:
        """carry (c, h); actions (B, 3) indices; patches (B, 3, tile, tile).
        Returns (new carry, token (B, token_size, token_size, 1))."""
        b = actions.shape[0]
        x = torch.cat([actions.float() / 48.0, patches.reshape(b, -1).float()], 1)
        carry, h = self.cell(carry, x)
        token = self.fc(h).reshape(b, self.token_size, self.token_size, 1)
        return carry, token


def convert_torch_lstm_cell(state_dict, prefix: str = "lstm") -> dict:
    """A torch nn.LSTMCell state dict (the reference's recurrence,
    action_lstm.py:13) -> OptimizedLSTMCell's state dict: torch packs the
    gates row-wise as [i, f, g, o] in weight_ih (4H, In) and weight_hh
    (4H, H) with two bias vectors; here each gate has its own `i*` (no bias)
    and `h*` (bias b_ih + b_hh) linear."""
    def t(name):
        return torch.as_tensor(state_dict[f"{prefix}.{name}"], dtype=torch.float32)

    w_ih, w_hh, b = t("weight_ih"), t("weight_hh"), t("bias_ih") + t("bias_hh")
    hidden = w_hh.shape[1]
    out = {}
    for j, g in enumerate(GATES):
        rows = slice(j * hidden, (j + 1) * hidden)
        out[f"i{g}.weight"] = w_ih[rows].clone()
        out[f"h{g}.weight"] = w_hh[rows].clone()
        out[f"h{g}.bias"] = b[rows].clone()
    return out
