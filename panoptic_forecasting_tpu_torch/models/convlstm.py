"""ConvLSTM (NCHW): cell + stacked layers, one time step per call.

Counterpart of ``panoptic_forecasting_tpu/models/convlstm.py``
(reference ``models/fg/convlstm.py``): a cell is one 3×3 conv over
concat([x, h]) producing the 4 gates in (i, f, o, g) order; layer l of
the stack takes layer l−1's output. The caller rolls time with a loop.
Names follow the reference ``state_dict`` (``cell_list.{i}.conv``).
"""

from __future__ import annotations

from typing import List, Tuple

import torch
import torch.nn as nn

State = Tuple[torch.Tensor, torch.Tensor]


class ConvLSTMCell(nn.Module):
    def __init__(self, in_ch: int, hidden: int, kernel: int = 3):
        super().__init__()
        self.hidden = hidden
        self.conv = nn.Conv2d(in_ch + hidden, 4 * hidden, kernel,
                              padding=kernel // 2, bias=True)

    def forward(self, state: State, x: torch.Tensor):
        h, c = state
        z = self.conv(torch.cat([x, h], 1))
        i, f, o, g = torch.split(z, self.hidden, 1)
        c_next = torch.sigmoid(f) * c + torch.sigmoid(i) * torch.tanh(g)
        h_next = torch.sigmoid(o) * torch.tanh(c_next)
        return (h_next, c_next), h_next


class ConvLSTMStack(nn.Module):
    """num_layers stacked cells over ``in_ch``-channel input, one step."""

    def __init__(self, in_ch: int, hidden: int, num_layers: int,
                 kernel: int = 3):
        super().__init__()
        self.cell_list = nn.ModuleList(
            ConvLSTMCell(in_ch if l == 0 else hidden, hidden, kernel)
            for l in range(num_layers)
        )

    def forward(self, states: List[State], x: torch.Tensor):
        new_states = []
        out = x
        for cell, state in zip(self.cell_list, states):
            state, out = cell(state, out)
            new_states.append(state)
        return new_states, out

    def init_state(self, batch: int, height: int, width: int,
                   like: torch.Tensor) -> List[State]:
        hidden = self.cell_list[0].hidden
        z = like.new_zeros((batch, hidden, height, width))
        return [(z, z) for _ in self.cell_list]
