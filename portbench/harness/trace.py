"""The traced windows: ``torch.profiler`` read back from its chrome trace.

A traced run traces twice. The light window records the device's
activity alone (no host operators, whose recording costs the host some
microseconds an operator and so stretches a launch-bound step): the
device is synchronised and a marker kernel launched at each end, and the
window runs from the first marker's end to the last marker's start. Its
busy time and length are the run's ``busy_s``/``window_s``, and its busy
time a step is set against the host-clock time a step of the untraced
steps the run makes before it (even this trace stretches a launch-bound
step, so no metric takes its length as the step's time). The full
window records the host's operators too, around the harness's
``record_function`` ranges named ``pb.*``; it attributes device time to
the stages and shows what the host did in each idle gap.

Device operations are kernels, memsets and memcpys. In the full window
each is tied to the host moment it was launched (its runtime call, by
correlation id); one whose launch the profiler did not record (a kernel
launched by a library's own statically linked runtime) takes the launch
time of the operation before it on its stream, which the stream's order
bounds. A device operation belongs to a range when it was launched in
it. In the light window an operation belongs to it when it started in it;
a light window that lost a marker record is traced again.
"""

from __future__ import annotations

import json
import os
import tempfile
from collections import defaultdict
from typing import Dict, List, Optional, Tuple

import torch

DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
MARKER = "spin_kernel"  # torch.cuda._sleep's kernel
LIGHT_TRIES = 5  # light windows traced until one is whole
HOST_CATS = ("cpu_op", "cuda_runtime", "cuda_driver", "user_annotation")


class Op:
    __slots__ = ("name", "cat", "start", "end", "launch", "stream")

    def __init__(self, name, cat, start, end, launch, stream):
        self.name, self.cat, self.start, self.end = name, cat, start, end
        self.launch, self.stream = launch, stream


class Trace:
    """Device operations, the ``pb.*`` ranges and the host's events of
    one traced window, times in µs on the profiler's clock. The window is
    the ``pb.window`` range where there is one, else the span between
    the marker kernels."""

    def __init__(self, events: List[Dict]):
        runtime: Dict[int, float] = {}
        self.ranges: Dict[str, List[Tuple[float, float]]] = defaultdict(list)
        self.host: List[Tuple[float, float, str, int]] = []
        raw = []
        for e in events:
            if e.get("ph") != "X":
                continue
            cat, ts, dur = e.get("cat", ""), float(e["ts"]), float(e.get("dur", 0.0))
            args = e.get("args", {})
            if cat in DEVICE_CATS:
                raw.append((e["name"], cat, ts, ts + dur, args.get("correlation"),
                            args.get("stream", 0)))
            elif cat in HOST_CATS:
                if cat in ("cuda_runtime", "cuda_driver") and "correlation" in args:
                    runtime[args["correlation"]] = ts
                if cat == "user_annotation" and e["name"].startswith("pb."):
                    self.ranges[e["name"]].append((ts, ts + dur))
                self.host.append((ts, ts + dur, e["name"], e.get("tid", 0)))
        raw.sort(key=lambda r: r[2])
        last: Dict[object, Optional[float]] = {}
        self.ops: List[Op] = []
        for name, cat, s, t, corr, stream in raw:
            launch = runtime.get(corr) if corr is not None else None
            if launch is None:
                launch = last.get(stream)
            if launch is None:
                launch = s
            last[stream] = launch
            self.ops.append(Op(name, cat, s, t, launch, stream))
        self.markers = [o for o in self.ops if o.cat == "kernel" and MARKER in o.name]
        self.ops = [o for o in self.ops if not (o.cat == "kernel" and MARKER in o.name)]
        for v in self.ranges.values():
            v.sort()

    def window(self) -> Tuple[float, float]:
        if "pb.window" in self.ranges:
            (w,) = self.ranges["pb.window"]
            return w
        return self.markers[0].end, self.markers[-1].start

    def whole(self) -> bool:
        """A light window with both markers and a device operation
        between them (CUPTI drops a record now and then)."""
        return (len(self.markers) == 2 and self.markers[0].end < self.markers[1].start
                and bool(self.in_window()))

    def in_window(self) -> List[Op]:
        a, b = self.window()
        by_launch = "pb.window" in self.ranges
        return [o for o in self.ops if a <= (o.launch if by_launch else o.start) <= b]

    def busy_us(self) -> float:
        """Time in the window in which some device operation ran."""
        a, b = self.window()
        total, cur_s, cur_e = 0.0, None, None
        for o in sorted(self.ops, key=lambda o: o.start):
            s, e = max(o.start, a), min(o.end, b)
            if e <= s:
                continue
            if cur_e is None or s > cur_e:
                if cur_e is not None:
                    total += cur_e - cur_s
                cur_s, cur_e = s, e
            else:
                cur_e = max(cur_e, e)
        if cur_e is not None:
            total += cur_e - cur_s
        return total

    def device_ops(self, top: int = 10) -> List[List]:
        """The device operations that took most time, summed by name."""
        by: Dict[str, float] = defaultdict(float)
        for o in self.in_window():
            by[o.name[:160]] += (o.end - o.start) / 1e6
        return [[k, v] for k, v in sorted(by.items(), key=lambda kv: -kv[1])[:top]]

    def idle_gaps(self, top: int = 10) -> List[List]:
        """The device's idle time in the window, summed by what the host
        was doing at each gap's middle: the innermost event there, of the
        thread whose innermost event started last."""
        a, b = self.window()
        spans = sorted((max(o.start, a), min(o.end, b)) for o in self.ops
                       if min(o.end, b) > max(o.start, a))
        gaps, cur = [], a
        for s, e in spans:
            if s > cur:
                gaps.append((cur, s))
            cur = max(cur, e)
        if b > cur:
            gaps.append((cur, b))
        threads: Dict[int, List] = defaultdict(list)
        for s, e, n, tid in self.host:
            threads[tid].append((s, e, n))
        walks = [[sorted(evs), 0, []] for evs in threads.values()]
        by: Dict[str, float] = defaultdict(float)
        for g0, g1 in sorted(gaps, key=lambda g: g[0] + g[1]):
            mid = (g0 + g1) / 2
            best = None
            for walk in walks:  # per thread: its events, next index, open stack
                evs, i, stack = walk
                while i < len(evs) and evs[i][0] <= mid:
                    while stack and stack[-1][1] < evs[i][0]:
                        stack.pop()
                    stack.append(evs[i])
                    i += 1
                walk[1] = i
                while stack and stack[-1][1] < mid:
                    stack.pop()
                if stack and (best is None or stack[-1][0] > best[0]):
                    best = stack[-1]
            by[best[2][:160] if best else "(no host event)"] += (g1 - g0) / 1e6
        return [[k, v] for k, v in sorted(by.items(), key=lambda kv: -kv[1])[:top]]


class Profiler:
    """``torch.profiler``, its chrome trace written to the run's temporary
    directory, read into a ``Trace`` and deleted: over the host and the
    device, or (``light``) over the device alone."""

    def __init__(self, light: bool = False):
        cuda = torch.cuda.is_available()
        acts = [] if light and cuda else [torch.profiler.ProfilerActivity.CPU]
        if cuda:
            acts.append(torch.profiler.ProfilerActivity.CUDA)
        self.prof = torch.profiler.profile(activities=acts)

    def start(self) -> None:
        self.prof.start()

    def stop(self) -> Trace:
        if torch.cuda.is_available():
            torch.cuda.synchronize()
        self.prof.stop()
        fd, path = tempfile.mkstemp(suffix=".json", prefix="portbench_trace_")
        os.close(fd)
        try:
            self.prof.export_chrome_trace(path)
            with open(path) as f:
                events = json.load(f)["traceEvents"]
        finally:
            os.remove(path)
        return Trace(events)


def mark(device) -> None:
    """An end of the light window: the device synchronised, then a marker
    kernel of a few hundred cycles."""
    if device.type == "cuda":
        torch.cuda.synchronize(device)
        torch.cuda._sleep(100)


class Traced:
    """A traced run's two windows: ``light`` (the device alone, between
    markers) and ``full`` (with the host, the ``pb.*`` ranges)."""

    def __init__(self, light: Trace, full: Trace):
        self.light, self.full = light, full


class Range:
    """A ``pb.<name>`` range opened and closed by hand (module hooks)."""

    def __init__(self, name: str):
        self.name = f"pb.{name}"
        self.rf = None

    def open(self, *_):
        self.rf = torch.profiler.record_function(self.name)
        self.rf.__enter__()

    def close(self, *_):
        if self.rf is not None:
            self.rf.__exit__(None, None, None)
            self.rf = None


def hook_ranges(module: torch.nn.Module, name: str) -> List:
    """Open ``pb.<name>`` before ``module``'s forward and close it after;
    returns the hook handles."""
    r = Range(name)
    return [module.register_forward_pre_hook(lambda m, a: r.open()),
            module.register_forward_hook(lambda m, a, o: r.close())]
