"""Timing shared by the port's profiling scripts and ``chip_smoke.py``:
CUDA events around K calls with one synchronisation (counterpart of the
JAX package's ``bench._timed`` + ``scripts/prof_common.scan_loop``), and
the device time torch.profiler sums over the kernels of K calls."""

from __future__ import annotations

import sys
import time
from typing import Callable, Dict, Optional, Tuple

import torch
from torch.profiler import ProfilerActivity, profile, schedule

K = 20
ATTEMPTS = 5  # profiles device_ms takes before it gives up
EDGE_S = 0.002  # host idle before and after the calls of a profiled step


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


Profile = Dict[str, Tuple[int, float]]  # kernel: (launches, device µs)


def kernel_profile(fn: Callable[[], object], calls: int) -> Profile:
    """Each kernel's launches and summed device µs over ``calls`` calls of
    ``fn``, recorded after a warm-up step of as many calls that the
    profiler traces and drops (CUPTI starts slowly). In each step the
    calls keep ``EDGE_S`` of host idle from its edges: without it the
    records of kernels launched right after a step began were now and
    then lost (most often in a one-call step). The step's own
    ``ProfilerStep*`` range, which the profiler files as a device event
    spanning the step, is left out."""
    kernels: Profile = {}

    def ready(prof):
        for e in prof.key_averages():
            if (str(getattr(e, "device_type", "")).endswith("CUDA") and e.count
                    and not e.key.startswith("ProfilerStep")):
                kernels[e.key] = (e.count, e.self_device_time_total)

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA],
                 schedule=schedule(wait=0, warmup=1, active=1, repeat=1),
                 on_trace_ready=ready) as prof:
        for _ in range(2):
            time.sleep(EDGE_S)
            for _ in range(calls):
                fn()
            torch.cuda.synchronize()
            time.sleep(EDGE_S)
            prof.step()
    return kernels


def whole(once: Profile, window: Profile, iters: int) -> bool:
    """Whether ``window`` (``iters`` calls) holds every record: each
    kernel of one call (``once``) ``iters`` times its launches there, and
    no other kernel. CUPTI now and then drops records, and a lone call's
    profile losing exactly 1/iters of what a window lost is unlikely."""
    return bool(once) and window.keys() == once.keys() and all(
        window[k][0] == iters * n for k, (n, _) in once.items())


def device_ms(fn: Callable[[], object], iters: int = 50,
              per_call: Optional[int] = None) -> float:
    """Mean device time per call of ``fn``: the kernel time torch.profiler
    records over ``iters`` calls, over ``iters``. Unlike ``time_ms`` it
    leaves out the host's time between launches, which bounds a small
    kernel. Only a whole profile counts (``whole``): it is taken again up
    to ``ATTEMPTS`` times, then this raises. ``per_call``: each kernel
    of ``fn`` launches that many times a call, known in advance, so no
    lone call is profiled (a lone call's one small kernel can lose its
    record in attempt after attempt)."""
    if not torch.cuda.is_available():
        raise RuntimeError("device_ms measures on the GPU; CUDA is not available")
    fn()
    torch.cuda.synchronize()
    for attempt in range(ATTEMPTS):
        window = kernel_profile(fn, iters)
        once = ({k: (per_call, 0.0) for k in window} if per_call
                else kernel_profile(fn, 1))
        if whole(once, window, iters):
            return sum(us for _, us in window.values()) / iters / 1e3
        counts = [{k[:48]: n for k, (n, _) in p.items()} for p in (once, window)]
        print(f"[device_ms] attempt {attempt + 1}: not whole; one call "
              f"{counts[0]}, {iters} calls {counts[1]}", file=sys.stderr)
    raise RuntimeError(f"torch.profiler kept no whole profile in {ATTEMPTS} "
                       f"attempts: device time not measured")
