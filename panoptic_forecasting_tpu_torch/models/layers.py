"""Shared NN building blocks: the MLP stack, one GRU and one LSTM layer.

Counterpart of ``panoptic_forecasting_tpu/models/layers.py``. All keep
the reference PyTorch ``state_dict`` names: an MLP is an
``nn.Sequential`` with its Linears at even indices (``out.0``,
``out.2``, ..., odom_model.py:31-52), a GRU or LSTM layer holds
``nn.GRU``'s or ``nn.LSTM``'s ``weight_ih_l0``/``weight_hh_l0``/
``bias_ih_l0``/``bias_hh_l0``.
"""

from __future__ import annotations

from typing import Sequence

import torch
import torch.nn as nn
import torch.nn.functional as F


class MLP(nn.Sequential):
    """Linear stack from ``in_features`` through ``features``.
    ``relu_first`` puts a ReLU between consecutive layers (the reference's
    output-head pattern, odom_model.py:46-52); ``relu_last`` puts one
    after every layer (the input-embedding pattern, odom_model.py:31-35)."""

    def __init__(self, in_features: int, features: Sequence[int],
                 relu_first: bool = False, relu_last: bool = False):
        mods = []
        for i, f in enumerate(features):
            if relu_first and i > 0:
                mods.append(nn.ReLU())
            mods.append(nn.Linear(in_features, f))
            if relu_last:
                mods.append(nn.ReLU())
            in_features = f
        super().__init__(*mods)


class GRUCell(nn.Module):
    """One torch ``nn.GRU`` layer (gate rows r | z | n), stepped by hand.

    The JAX package's flax cell has no hidden-side r/z biases: its r/z
    bias is one vector (``bias_ih_l0[:2H]`` here, ``models/convert.py``).
    So ``bias_hh_l0[:2H]`` gets a zero gradient (a hook on the parameter)
    and is kept out of every update (``frozen``, ``train/optim.py``); a
    non-zero value from a reference ``.pt`` stays a constant, and the sum
    JAX trains moves through ``bias_ih_l0`` alone.
    """

    def __init__(self, in_features: int, hidden: int):
        super().__init__()
        self.hidden = hidden
        self.weight_ih_l0 = nn.Parameter(torch.empty(3 * hidden, in_features))
        self.weight_hh_l0 = nn.Parameter(torch.empty(3 * hidden, hidden))
        self.bias_ih_l0 = nn.Parameter(torch.zeros(3 * hidden))
        self.bias_hh_l0 = nn.Parameter(torch.zeros(3 * hidden))
        bound = hidden ** -0.5
        for w in (self.weight_ih_l0, self.weight_hh_l0):
            nn.init.uniform_(w, -bound, bound)
        self.bias_hh_l0.register_hook(self._no_rz_grad)

    def _no_rz_grad(self, grad: torch.Tensor) -> torch.Tensor:
        return torch.cat([grad.new_zeros(2 * self.hidden), grad[2 * self.hidden:]])

    def frozen(self):
        """[(parameter, slice)] that training leaves as it is: the
        hidden-side r/z biases."""
        return [(self.bias_hh_l0, slice(0, 2 * self.hidden))]

    def forward(self, h: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
        i_r, i_z, i_n = F.linear(x, self.weight_ih_l0, self.bias_ih_l0).chunk(3, -1)
        h_r, h_z, h_n = F.linear(h, self.weight_hh_l0, self.bias_hh_l0).chunk(3, -1)
        r = torch.sigmoid(i_r + h_r)
        z = torch.sigmoid(i_z + h_z)
        n = torch.tanh(i_n + r * h_n)
        return (1.0 - z) * n + z * h


class LSTMCell(nn.Module):
    """One torch ``nn.LSTM`` layer (gate rows i | f | g | o), stepped by
    hand as flax's ``nn.OptimizedLSTMCell``: the carry is ``(c, h)`` and
    the output ``h``.

    The flax cell's input kernels ``ii/if/ig/io`` have no bias and its
    hidden kernels ``hi/hf/hg/ho`` carry it, so the bias lives in
    ``bias_hh_l0`` and ``bias_ih_l0`` is 0: it gets a zero gradient (a
    hook) and is kept out of every update (``frozen``,
    ``train/optim.py``), so Adam and weight decay move the one bias JAX
    trains. The gates add as flax adds them, ``(h·W_hh + b_hh) + x·W_ih``.
    """

    def __init__(self, in_features: int, hidden: int):
        super().__init__()
        self.hidden = hidden
        self.weight_ih_l0 = nn.Parameter(torch.empty(4 * hidden, in_features))
        self.weight_hh_l0 = nn.Parameter(torch.empty(4 * hidden, hidden))
        self.bias_ih_l0 = nn.Parameter(torch.zeros(4 * hidden))
        self.bias_hh_l0 = nn.Parameter(torch.zeros(4 * hidden))
        bound = hidden ** -0.5
        for w in (self.weight_ih_l0, self.weight_hh_l0):
            nn.init.uniform_(w, -bound, bound)
        self.bias_ih_l0.register_hook(torch.zeros_like)

    def frozen(self):
        """[(parameter, slice)] that training leaves as it is: the
        input-side bias."""
        return [(self.bias_ih_l0, slice(None))]

    def forward(self, carry, x: torch.Tensor):
        """-> ((c, h), h)."""
        c, h = carry
        gates = (F.linear(h, self.weight_hh_l0, self.bias_hh_l0)
                 + F.linear(x, self.weight_ih_l0, self.bias_ih_l0))
        i, f, g, o = gates.chunk(4, -1)
        c = torch.sigmoid(f) * c + torch.sigmoid(i) * torch.tanh(g)
        h = torch.sigmoid(o) * torch.tanh(c)
        return (c, h), h
