"""K1: dense per-group min canvas of int32 keys (the z-buffer placement).

Counterpart of ``panoptic_forecasting_tpu/kernels/placement.py::
place_sorted``. The TPU kernel needs its stream sorted by (group, key);
min does not depend on order, so this one takes the stream as it comes.
For a CUDA tensor ``place_min`` launches the hand-written kernel
``csrc/placement.cu`` (one ``atomicMin`` per entry into an EMPTY-filled
canvas); for a CPU tensor it runs ``place_min_plain``, the same function
in plain PyTorch. The canvas is bit-identical either way.
"""

from __future__ import annotations

import ctypes

import torch

from . import build

EMPTY = 0x7FFFFFFF  # untouched group; a key of 0 is a valid key


def place_min_plain(group: torch.Tensor, key: torch.Tensor,
                    num_groups: int) -> torch.Tensor:
    """Plain PyTorch version of K1: ``scatter_reduce_`` with ``amin``."""
    canvas = torch.full((num_groups,), EMPTY, dtype=torch.int32,
                        device=group.device)
    keep = (group >= 0) & (group < num_groups)
    return canvas.scatter_reduce_(
        0, group[keep].long(), key[keep], "amin", include_self=True
    )


def _check(group: torch.Tensor, key: torch.Tensor, num_groups: int):
    if group.dtype != torch.int32 or key.dtype != torch.int32:
        raise TypeError(f"group/key must be int32, got {group.dtype}/{key.dtype}")
    if group.dim() != 1 or group.shape != key.shape:
        raise ValueError(
            f"group/key must be 1-D of one length, got {tuple(group.shape)}"
            f" and {tuple(key.shape)}"
        )
    if group.device != key.device:
        raise ValueError("group and key lie on different devices")
    if not 0 < num_groups < 2**31:
        raise ValueError(f"num_groups={num_groups} outside (0, 2^31)")


def place_min(group: torch.Tensor, key: torch.Tensor,
              num_groups: int) -> torch.Tensor:
    """(num_groups,) int32: per-group min key, EMPTY where no entry lands.

    ``group``/``key``: (N,) int32 in any order; entries whose group lies
    outside [0, num_groups) are ignored. CUDA tensors run the CUDA kernel
    (and count a launch); CPU tensors run ``place_min_plain``.
    """
    _check(group, key, num_groups)
    if group.device.type == "cpu":
        return place_min_plain(group, key, num_groups)
    if group.device.type != "cuda":
        raise ValueError(f"unsupported device {group.device}")
    group = group.contiguous()
    key = key.contiguous()
    canvas = torch.empty((num_groups,), dtype=torch.int32, device=group.device)
    lib = _lib()
    with torch.cuda.device(group.device):
        err = lib.place_min(
            group.data_ptr(), key.data_ptr(), group.numel(),
            canvas.data_ptr(), num_groups,
            torch.cuda.current_stream().cuda_stream,
        )
    if err != 0:
        raise RuntimeError(f"place_min kernel launch failed: CUDA error {err}")
    place_min.launches += 1
    return canvas


place_min.launches = 0


def _lib() -> ctypes.CDLL:
    lib = build.load("placement")
    fn = lib.place_min
    fn.argtypes = [
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int64,
        ctypes.c_void_p, ctypes.c_int64, ctypes.c_void_p,
    ]
    fn.restype = ctypes.c_int
    return lib
