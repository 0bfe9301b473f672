"""TF32, the precision the control computes in: float32 operands rounded
to a 10-bit mantissa (round to nearest, ties away) before each
convolution and matrix product, products accumulated in float32. On the
card the control sets cuDNN's and cuBLAS's TF32 switches instead; these
stand-ins give the CPU the same rounding of the operands."""

from __future__ import annotations

import contextlib

import torch
import torch.nn.functional as F


@contextlib.contextmanager
def card_tf32(on: bool):
    """cuDNN's and cuBLAS's TF32 switches set to ``on`` inside, off after
    (the configurations state float32)."""
    for flags in (torch.backends.cudnn, torch.backends.cuda.matmul):
        flags.allow_tf32 = on
    try:
        yield
    finally:
        for flags in (torch.backends.cudnn, torch.backends.cuda.matmul):
            flags.allow_tf32 = False


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
