"""ConvLSTM (NCHW): cell + stacked layers, one time step per call.

Counterpart of ``panoptic_forecasting_tpu/models/convlstm.py``
(reference ``models/fg/convlstm.py``): a cell is one 3×3 conv over
concat([x, h]) producing the 4 gates in (i, f, o, g) order; layer l of
the stack takes layer l−1's output. The caller rolls time with a loop.
Names follow the reference ``state_dict`` (``cell_list.{i}.conv``).

``dtype=torch.bfloat16`` is JAX's ``ConvLSTMCell(dtype=jnp.bfloat16)``
(JAX convlstm.py:25-57): the conv runs in bf16 over ``concat([x,
h]).astype(bf16)`` with the f32 weight cast to bf16 and the bias added
in bf16, and the gates are computed in bf16. The state is not cast: the
cell ``c`` starts f32 (from the features' dtype), so ``f * c + i * g``
promotes to f32 and ``h = o * tanh(c)`` is f32, as in JAX. The bf16
gates round where XLA rounds them (``_gates_bf16``): its bf16 logistic
is ``1 / (1 + exp(-z))`` with ``exp(-z)`` and the sum rounded to bf16;
``i``, ``f`` and ``tanh(g)`` are rounded to bf16, ``o`` enters ``h`` at
f32, and ``i * g`` is the exact f32 product. Its gradient (``_CellBF16``)
follows JAX's VJP of those bf16 ops: the cotangents of the bf16 values
are rounded to bf16, and the logistic's and tanh's derivatives are
``(d·s)·(1 − s)`` and ``(d + d·t)·(1 − t)`` in bf16 steps.
"""

from __future__ import annotations

from typing import List, Tuple

import torch
import torch.nn as nn
import torch.nn.functional as F


State = Tuple[torch.Tensor, torch.Tensor]


def _bf16(t: torch.Tensor) -> torch.Tensor:
    """f32 -> the nearest bf16 value, held in f32."""
    return t.to(torch.bfloat16).to(torch.float32)


def _sigmoid_bf16(z: torch.Tensor) -> torch.Tensor:
    """XLA's bf16 logistic before its final rounding: ``1 / (1 + e)`` with
    ``e = exp(-z)`` and ``1 + e`` rounded to bf16, the quotient f32."""
    return 1.0 / _bf16(1.0 + _bf16(torch.exp(-z.to(torch.float32))))


class _CellBF16(torch.autograd.Function):
    """One bf16 cell step: (f32 input ``concat([x, h])``, conv weight and
    bias, f32 cell c) -> (h, c_next), f32."""

    @staticmethod
    def forward(ctx, inp, weight, bias, c, hidden: int, padding):
        xb, wb = inp.to(torch.bfloat16), weight.to(torch.bfloat16)
        z = F.conv2d(xb, wb, None, 1, padding) + bias.to(torch.bfloat16)[:, None, None]
        i, f, o, g = torch.split(z, hidden, 1)
        i, f = _bf16(_sigmoid_bf16(i)), _bf16(_sigmoid_bf16(f))
        o, g = _sigmoid_bf16(o), _bf16(torch.tanh(g.to(torch.float32)))
        c_next = f * c + i * g
        t = torch.tanh(c_next)
        ctx.save_for_backward(xb, wb, i, f, o, g, c, t)
        ctx.padding = padding
        return o * t, c_next

    @staticmethod
    def backward(ctx, dh, dc_next):
        xb, wb, i, f, o, g, c, t = ctx.saved_tensors
        dc = dc_next + dh * o * (1 - t * t)
        d_ig = _bf16(dc)

        def dsigmoid(d, s):
            return _bf16(_bf16(d * s) * _bf16(1 - s))

        dz = torch.cat([
            dsigmoid(_bf16(d_ig * g), i),
            dsigmoid(_bf16(dc * c), f),
            dsigmoid(_bf16(dh * t), _bf16(o)),
            _bf16(_bf16(_bf16(d_ig * i) * (1 + g)) * _bf16(1 - g)),
        ], 1)
        dx = torch.nn.grad.conv2d_input(xb.shape, wb.to(torch.float32), dz, 1,
                                        ctx.padding)
        dw = torch.nn.grad.conv2d_weight(xb.to(torch.float32), wb.shape, dz, 1,
                                         ctx.padding)
        return dx, dw, dz.sum((0, 2, 3)), dc * f, None, None


class ConvLSTMCell(nn.Module):
    def __init__(self, in_ch: int, hidden: int, kernel: int = 3,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.hidden = hidden
        self.dtype = dtype
        self.conv = nn.Conv2d(in_ch + hidden, 4 * hidden, kernel,
                              padding=kernel // 2, bias=True)

    def forward(self, state: State, x: torch.Tensor):
        h, c = state
        inp = torch.cat([x, h], 1)
        if self.dtype == torch.bfloat16:
            h_next, c_next = _CellBF16.apply(inp, self.conv.weight, self.conv.bias,
                                             c, self.hidden, self.conv.padding)
            return (h_next, c_next), h_next
        i, f, o, g = torch.split(self.conv(inp), self.hidden, 1)
        c_next = torch.sigmoid(f) * c + torch.sigmoid(i) * torch.tanh(g)
        h_next = torch.sigmoid(o) * torch.tanh(c_next)
        return (h_next, c_next), h_next


class ConvLSTMStack(nn.Module):
    """num_layers stacked cells over ``in_ch``-channel input, one step."""

    def __init__(self, in_ch: int, hidden: int, num_layers: int,
                 kernel: int = 3, dtype: torch.dtype = torch.float32):
        super().__init__()
        self.cell_list = nn.ModuleList(
            ConvLSTMCell(in_ch if l == 0 else hidden, hidden, kernel, dtype)
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
