"""TF32, the precision the control computes in: float32 operands rounded
to a 10-bit mantissa (round to nearest, ties away) before each
convolution and matrix product, products accumulated in float32. On the
card the control sets cuDNN's and cuBLAS's TF32 switches instead; these
stand-ins give the CPU the same rounding of the operands."""

from __future__ import annotations

import torch
import torch.nn.functional as F


def tf32(x: torch.Tensor) -> torch.Tensor:
    """``x`` rounded to TF32; the gradient passes through unchanged."""
    if x is None or x.dtype != torch.float32:
        return x
    bits = x.detach().contiguous().view(torch.int32)
    rounded = ((bits + 0x1000) & ~0x1FFF).view(torch.float32)
    return x + (rounded - x).detach() if x.requires_grad else rounded


def conv(x, w, b=None, stride=1, padding=0):
    return F.conv2d(tf32(x), tf32(w), b, stride, padding)


def linear(x, w, b=None):
    return F.linear(tf32(x), tf32(w), b)


def deconv(x, w, b=None, stride=1):
    return F.conv_transpose2d(tf32(x), tf32(w), b, stride)
