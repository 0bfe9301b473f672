"""CUDA-event timing shared by the port's profiling scripts and
``chip_smoke.py`` (counterpart of the JAX package's ``bench._timed`` +
``scripts/prof_common.scan_loop``: K calls per measurement, one
synchronisation)."""

from __future__ import annotations

from typing import Callable

import torch

K = 20


def time_ms(fn: Callable[[], object], iters: int = K, warmup: int = 3) -> float:
    """Mean device ms per call of ``fn``: CUDA events around ``iters``
    calls after ``warmup`` calls. Raises without CUDA: a time on the CPU
    is not a device time."""
    if not torch.cuda.is_available():
        raise RuntimeError("time_ms measures on the GPU; CUDA is not available")
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters
