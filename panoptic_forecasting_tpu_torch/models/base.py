"""Seeded random weights for the port's models, and the elementwise
losses of the training objectives.

Every tensor is drawn on the CPU from an explicit ``torch.Generator``
and copied to the module's device, so one seed gives the same weights
on the CPU and on the GPU. Convolutions and linears get He-normal
weights and small biases; BatchNorm gets non-trivial affine parameters
and running statistics, so folding them into the convs is exercised.

``smooth_l1``, ``mse`` and ``LOSS_FNS`` are the JAX package's
``models/base.py:65-76``.
"""

from __future__ import annotations

import torch
import torch.nn as nn

from .layers import GRUCell


def _draw(g: torch.Generator, shape, std: float = 1.0, mean: float = 0.0):
    return torch.randn(tuple(shape), generator=g) * std + mean


def _uniform(g: torch.Generator, shape, lo: float, hi: float):
    return torch.rand(tuple(shape), generator=g) * (hi - lo) + lo


@torch.no_grad()
def seeded_init_(module: nn.Module, seed: int) -> nn.Module:
    """Fill every parameter and BN statistic of ``module`` from ``seed``."""
    g = torch.Generator().manual_seed(int(seed))
    for m in module.modules():
        if isinstance(m, (nn.Conv2d, nn.ConvTranspose2d, nn.Linear)):
            w = m.weight
            if isinstance(m, nn.ConvTranspose2d):
                fan_in = m.in_channels  # kernel == stride: one tap per output
            else:
                fan_in = w[0].numel()
            w.copy_(_draw(g, w.shape, (2.0 / fan_in) ** 0.5))
            if m.bias is not None:
                m.bias.copy_(_draw(g, m.bias.shape, 0.01))
        elif isinstance(m, nn.BatchNorm2d):
            m.weight.copy_(_uniform(g, m.weight.shape, 0.8, 1.2))
            m.bias.copy_(_draw(g, m.bias.shape, 0.05))
            m.running_mean.copy_(_draw(g, m.running_mean.shape, 0.1))
            m.running_var.copy_(_uniform(g, m.running_var.shape, 0.5, 1.5))
        elif isinstance(m, GRUCell):
            bound = m.hidden ** -0.5
            for p in m.parameters():
                p.copy_(_uniform(g, p.shape, -bound, bound))
    return module


def init_weights(module: nn.Module, seed: int) -> nn.Module:
    """Seeded weights, then the pretrained ones the model's config names
    (the fg mask head's detectron2 weights): what the JAX package's
    ``init`` gives a model before any checkpoint is restored."""
    seeded_init_(module, seed)
    load = getattr(module, "load_pretrained", None)
    if load is not None:
        load()
    return module


def smooth_l1(pred: torch.Tensor, target: torch.Tensor) -> torch.Tensor:
    """Elementwise SmoothL1 (beta 1), as torch.nn.SmoothL1Loss."""
    d = (pred - target).abs()
    return torch.where(d < 1.0, 0.5 * d * d, d - 0.5)


def mse(pred: torch.Tensor, target: torch.Tensor) -> torch.Tensor:
    d = pred - target
    return d * d


LOSS_FNS = {"smooth_l1": smooth_l1, "mse": mse}
