"""K2: fused one-hot assembly + HarDNet stem conv, never materialising
the one-hot input.

Counterpart of ``panoptic_forecasting_tpu/kernels/stem.py::
onehot_stem_conv``. For CUDA tensors ``onehot_stem_conv`` launches the
hand-written kernel ``csrc/stem.cu`` (input tiles staged in shared
memory, a gather of one padded weight row per tap, no one-hot tensor, no
GEMM, f32 arithmetic; the output f32, or rounded to bf16 by the
``onehot_stem_conv_bf16`` entry when ``out_dtype=torch.bfloat16``); for
CPU tensors it runs ``onehot_stem_conv_plain``, ``F.one_hot`` +
``F.conv2d`` in plain PyTorch, cast to ``out_dtype``. Layouts are the JAX package's: seg/depth (B, T, H, W), kernel
HWIO (3, 3, C_in, c_out), output NHWC (B, H/2, W/2, c_out).
"""

from __future__ import annotations

import ctypes
from typing import Optional

import torch
import torch.nn.functional as F

from . import build

_KERNEL_COUT = 16  # csrc/stem.cu computes 16 channels per thread
_SMEM_LIMIT = 227 * 1024  # shared memory a CTA can opt into on the H100
_SIGNATURE = [ctypes.c_void_p] * 5 + [ctypes.c_int] * 7 + [ctypes.c_void_p]
# The C entry point of each output dtype; both take the same arguments.
_ENTRIES = {torch.float32: "onehot_stem_conv",
            torch.bfloat16: "onehot_stem_conv_bf16"}
_SIGNATURES = {name: _SIGNATURE for name in _ENTRIES.values()}


def assemble_onehot(seg: torch.Tensor, num_classes: int) -> torch.Tensor:
    """(B, T, H, W) int -> (B, T·C, H, W) f32, t-major channels; ids
    outside [0, C) give an all-zero row (bg_model.py:53-59)."""
    b, t, h, w = seg.shape
    mask = (seg >= 0) & (seg < num_classes)
    oh = F.one_hot(torch.where(mask, seg, 0).long(), num_classes)
    oh = oh.to(torch.float32) * mask[..., None]
    return oh.permute(0, 1, 4, 2, 3).reshape(b, t * num_classes, h, w)


def onehot_stem_conv_plain(seg: torch.Tensor, depth: Optional[torch.Tensor],
                           kernel: torch.Tensor, bias: torch.Tensor, *,
                           num_classes: int) -> torch.Tensor:
    """Plain PyTorch version of K2 (JAX ``stem_reference``).

    The JAX reference pads ((1, 0), (1, 0)); for even H and W a stride-2
    3x3 conv never reads the bottom/right pad, so torch's symmetric
    ``padding=1`` computes the same outputs.
    """
    x = assemble_onehot(seg, num_classes)
    if depth is not None:
        x = torch.cat([x, depth.to(torch.float32)], dim=1)
    w = kernel.to(torch.float32).permute(3, 2, 0, 1)  # HWIO -> OIHW
    y = F.conv2d(x, w, bias.to(torch.float32), stride=2, padding=1)
    return torch.relu(y).permute(0, 2, 3, 1)


def smem_bytes(frames: int, num_classes: int) -> int:
    """Dynamic shared memory of ``csrc/stem.cu`` for T frames and C
    classes: depth rows (9, T, 16), class rows (9, T·C + 1, 17) padded to
    16 bytes, and per frame a 17-row window of four 34-entry planes."""
    class_floats = (9 * (frames * num_classes + 1) * 17 + 3) & ~3
    return 4 * (9 * frames * 16 + class_floats + frames * 17 * 4 * 34)


def _check(seg, depth, kernel, bias, num_classes):
    if seg.dim() != 4:
        raise ValueError(f"seg must be (B, T, H, W), got {tuple(seg.shape)}")
    b, t, h, w = seg.shape
    if h % 2 or w % 2:
        raise ValueError(f"H and W must be even, got {h}x{w}")
    c_in = t * num_classes + (t if depth is not None else 0)
    if kernel.dim() != 4 or tuple(kernel.shape[:3]) != (3, 3, c_in):
        raise ValueError(
            f"kernel must be (3, 3, {c_in}, c_out), got {tuple(kernel.shape)}"
        )
    if tuple(bias.shape) != (kernel.shape[3],):
        raise ValueError(f"bias must be ({kernel.shape[3]},), got "
                         f"{tuple(bias.shape)}")
    if depth is not None and depth.shape != seg.shape:
        raise ValueError(f"depth {tuple(depth.shape)} != seg {tuple(seg.shape)}")
    tensors = [seg, kernel, bias] + ([depth] if depth is not None else [])
    if len({x.device for x in tensors}) != 1:
        raise ValueError("seg, depth, kernel and bias lie on different devices")


def onehot_stem_conv(seg: torch.Tensor, depth: Optional[torch.Tensor],
                     kernel: torch.Tensor, bias: torch.Tensor, *,
                     num_classes: int,
                     out_dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """relu(conv3x3_stride2_pad1(onehot(seg) ++ depth) + bias), NHWC, in
    ``out_dtype`` (f32, or bf16: the f32 result rounded to nearest even).

    seg (B, T, H, W) int; depth (B, T, H, W) f32 already normalised and
    masked, or None; kernel (3, 3, T·C [+T], c_out); bias (c_out,).
    CUDA tensors run the CUDA kernel (int32 seg, f32 rest, c_out = 16;
    it raises on anything else) and count a launch; CPU tensors run
    ``onehot_stem_conv_plain`` and cast its result.
    """
    _check(seg, depth, kernel, bias, num_classes)
    if out_dtype not in _ENTRIES:
        raise TypeError(f"out_dtype must be float32 or bfloat16, got {out_dtype}")
    if seg.device.type == "cpu":
        return onehot_stem_conv_plain(seg, depth, kernel, bias,
                                      num_classes=num_classes).to(out_dtype)
    if seg.device.type != "cuda":
        raise ValueError(f"unsupported device {seg.device}")
    if seg.dtype != torch.int32:
        raise TypeError(f"seg must be int32 on CUDA, got {seg.dtype}")
    for name, x in (("depth", depth), ("kernel", kernel), ("bias", bias)):
        if x is not None and x.dtype != torch.float32:
            raise TypeError(f"{name} must be float32 on CUDA, got {x.dtype}")
    c_out = kernel.shape[3]
    if c_out != _KERNEL_COUT:
        raise NotImplementedError(
            f"the CUDA stem computes {_KERNEL_COUT} channels, got {c_out}"
        )
    b, t, h, w = seg.shape
    if h * w >= 2**31:
        raise ValueError(f"a {h}x{w} plane overflows the kernel's int32 index")
    if smem_bytes(t, num_classes) > _SMEM_LIMIT:
        raise ValueError(
            f"T = {t} frames of C = {num_classes} classes need "
            f"{smem_bytes(t, num_classes)} B of shared memory; the CUDA stem "
            f"has {_SMEM_LIMIT} (C <= 110 at T = 3)")
    seg = seg.contiguous()
    kernel = kernel.contiguous()
    bias = bias.contiguous()
    dep = depth.contiguous() if depth is not None else None
    out = torch.empty((b, h // 2, w // 2, c_out), dtype=out_dtype,
                      device=seg.device)
    build.launch(
        getattr(build.load("stem", _SIGNATURES), _ENTRIES[out_dtype]), seg.device,
        seg.data_ptr(), dep.data_ptr() if dep is not None else None,
        kernel.data_ptr(), bias.data_ptr(), out.data_ptr(),
        b, t, h, w, int(num_classes), c_out, int(dep is not None),
    )
    onehot_stem_conv.launches += 1
    if out_dtype == torch.bfloat16:
        onehot_stem_conv.bf16_launches += 1
    return out


# Launches of the kernel in either dtype; of the bf16 entry alone.
onehot_stem_conv.launches = 0
onehot_stem_conv.bf16_launches = 0

