"""Seeded weights, drawn on the device in two large calls.

Convolutions and linears get He-normal weights and small biases;
BatchNorm gets non-trivial affine parameters and running statistics (so
the program's BN fold is exercised); a GRU cell's tensors are uniform in
±1/√hidden. One ``randn`` and one ``rand`` over all leaves, sliced.
"""

from __future__ import annotations

from typing import Dict, List, Tuple

import torch
import torch.nn as nn

from .traffic import generator


def _plan(module: nn.Module) -> Tuple[List, List]:
    """[(tensor, std, mean)] drawn normal and [(tensor, lo, hi)] uniform."""
    normal, uniform = [], []
    for m in module.modules():
        if isinstance(m, (nn.Conv2d, nn.ConvTranspose2d, nn.Linear)):
            w = m.weight
            fan_in = m.in_channels if isinstance(m, nn.ConvTranspose2d) else w[0].numel()
            normal.append((w, (2.0 / fan_in) ** 0.5, 0.0))
            if m.bias is not None:
                normal.append((m.bias, 0.01, 0.0))
        elif isinstance(m, nn.BatchNorm2d):
            uniform.append((m.weight, 0.8, 1.2))
            normal.append((m.bias, 0.05, 0.0))
            normal.append((m.running_mean, 0.1, 0.0))
            uniform.append((m.running_var, 0.5, 1.5))
        elif hasattr(m, "weight_ih_l0") and hasattr(m, "hidden"):  # a GRU cell
            bound = m.hidden ** -0.5
            for p in (m.weight_ih_l0, m.weight_hh_l0, m.bias_ih_l0, m.bias_hh_l0):
                uniform.append((p, -bound, bound))
    return normal, uniform


@torch.no_grad()
def seed_(module: nn.Module, seed: int, stream: int) -> nn.Module:
    """Fill ``module``'s weights (on its device) from ``seed``."""
    dev = next(module.parameters()).device
    g = generator(seed, stream, dev)
    normal, uniform = _plan(module)
    z = torch.randn(sum(t.numel() for t, _, _ in normal), generator=g, device=dev)
    r = torch.rand(sum(t.numel() for t, _, _ in uniform), generator=g, device=dev)
    o = 0
    for t, std, mean in normal:
        t.copy_(z[o:o + t.numel()].view_as(t) * std + mean)
        o += t.numel()
    o = 0
    for t, lo, hi in uniform:
        t.copy_(r[o:o + t.numel()].view_as(t) * (hi - lo) + lo)
        o += t.numel()
    return module


def host_state(module: nn.Module) -> Dict[str, torch.Tensor]:
    """A host copy of ``module``'s state, for the reference."""
    return {k: v.detach().to("cpu", copy=True) for k, v in module.state_dict().items()}
