"""K4: the strided-load probes, f32[R, C] -> f32[R, C/2] (every other lane).

Counterpart of the three Pallas probe bodies of
``scripts/prof_strided_load.py`` (``k_strided_ref``, ``k_strided_val``,
``k_dyn_row_strided``). Each is a hand-written CUDA kernel in
``csrc/strided_load.cu`` that probes one access pattern: a read straight
from global memory, two 16-byte loads and one 16-byte store a thread
with rows from the grid (``strided_ref``), the value loaded whole with
one 16-byte load per four input floats and its kept lanes stored from
registers (``strided_val``), and the same vector loads with the row index
taken in a runtime grid-stride loop (``dyn_row_strided``, the fused stem
kernel's pattern). Inputs that are not 16-byte aligned or have
C % 4 == 2 (C % 8 != 0 for ``strided_ref``) take a scalar path inside the
same kernels. For a CUDA tensor each wrapper launches its kernel once and
counts it; for a CPU tensor it runs ``strided_plain``, ``x[:, start::2]``
in plain PyTorch.
"""

from __future__ import annotations

import ctypes

import torch

from . import build

PROBES = ("strided_ref", "strided_val", "dyn_row_strided")
_SIGNATURES = {
    name: (ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int64, ctypes.c_int64,
           ctypes.c_int, ctypes.c_void_p)
    for name in PROBES
}


def strided_plain(x: torch.Tensor, start: int) -> torch.Tensor:
    """Plain PyTorch version of every probe: lanes start, start+2, ..."""
    return x[:, start::2].contiguous()


def _check(x: torch.Tensor, start: int):
    if x.dtype != torch.float32:
        raise TypeError(f"x must be float32, got {x.dtype}")
    if x.dim() != 2 or x.shape[1] % 2:
        raise ValueError(f"x must be (R, C) with C even, got {tuple(x.shape)}")
    if start not in (0, 1):
        raise ValueError(f"start must be 0 or 1, got {start}")


def _probe(name: str):
    def run(x: torch.Tensor, start: int) -> torch.Tensor:
        _check(x, start)
        if x.device.type == "cpu":
            return strided_plain(x, start)
        if x.device.type != "cuda":
            raise ValueError(f"unsupported device {x.device}")
        x = x.contiguous()
        rows, cols = x.shape
        out = torch.empty((rows, cols // 2), dtype=x.dtype, device=x.device)
        if out.numel() == 0:
            return out
        build.launch(getattr(build.load("strided_load", _SIGNATURES), name),
                     x.device, x.data_ptr(), out.data_ptr(), rows, cols, start)
        run.launches += 1
        return out

    run.__name__ = run.__qualname__ = name
    run.__doc__ = (f"(R, C/2) float32: lanes start, start+2, ... of each row; "
                   f"CUDA tensors launch ``{name}`` in csrc/strided_load.cu.")
    run.launches = 0
    return run


strided_ref = _probe("strided_ref")
strided_val = _probe("strided_val")
dyn_row_strided = _probe("dyn_row_strided")

