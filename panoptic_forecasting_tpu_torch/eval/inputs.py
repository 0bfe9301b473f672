"""The forecast step's inputs on its device, each host input read once.

On a CUDA device each host input (a numpy array or a CPU tensor) is
copied once into its own page-locked tensor, ``depth`` cast to f32 in
that pass as the step always has, and moved to the card in one piece by
a non-blocking copy on the step's copy stream. Each pc map's
(``seg``, ``depth``, ``depth_mask``) DMA runs while the host fills the
next map. The step stages the fg and fusion inputs after it has launched
bg, so their host passes and DMAs overlap bg's kernels.

The host pass is torch's copy, spread over the process's intra-op
threads: on the 8-core host of an H100 machine it ran at 20-62 GB/s, one
thread's numpy copy at 3.6-8.6 GB/s, and the pinned DMA at 44-55 GB/s.
There, at 1024x2048, the pc maps' staging took 2.2-3.4 ms a frame with a
copy a map and 5.6-9.7 ms in 1 MiB pieces: each copy has a fixed cost,
and the DMA outruns the fill, so a map is not split.

The pinned memory comes from torch's caching host allocator, which hands
a block out again only after the copies that read it have finished: a
caller may start a call before the last one's copies are done. Each
input gets a fresh device tensor, allocated on the copy stream and
recorded on the compute stream, which waits for the copy stream before
the first kernel that reads a stage's inputs; nothing the step returns
views pinned memory or a later call's input. A tensor already on the
step's device passes through. On the CPU every input passes through,
converted once.

While a ``torch.profiler`` records, each stage's host pass is the span
``pf.forecast.stage`` (on the CPU: each stage's conversions).
"""

from __future__ import annotations

import contextlib
from typing import Any, Dict, Mapping, Optional

import torch

from ..core.tracing import span

PC_KEYS = ("seg", "depth", "depth_mask")
CASTS = {"depth": torch.float32}  # the pc maps' casts
COUNTERS = ("calls", "bytes_staged", "bytes_passed_through", "htod_copies",
            "reuse_waits")


class Inputs:
    """The inputs of one forecast step (``build_forecast_step``).

    A call is ``pc(pc_in)``, then ``fg(fg_in)``. ``stream`` is the copy
    stream. ``counters``: ``calls``; ``bytes_staged``, moved to the device
    from pinned memory; ``bytes_passed_through``, inputs read where they lay;
    ``htod_copies``; ``reuse_waits``, calls begun while the copy stream
    still ran (the allocator keeps the pinned memory those copies read
    from the new call, so nothing waits on the host).
    """

    def __init__(self, dev: torch.device):
        if dev.type == "cuda" and dev.index is None:
            dev = torch.device("cuda", torch.cuda.current_device())
        self.dev = dev
        self.counters = dict.fromkeys(COUNTERS, 0)
        self.stream = None if dev.type == "cpu" else torch.cuda.Stream(dev)

    def pc(self, pc_in: Mapping[str, Any]):
        """Starts a call: -> (seg, depth as f32, depth_mask) on the device."""
        self.counters["calls"] += 1
        if self.dev.type == "cpu":
            with span("forecast.stage"):
                return tuple(self._resident(pc_in[k], CASTS.get(k)) for k in PC_KEYS)
        if not self.stream.query():
            self.counters["reuse_waits"] += 1
        return tuple(self._on_device({k: pc_in[k] for k in PC_KEYS}, CASTS).values())

    def fg(self, fg_in: Mapping[str, Any]) -> Dict[str, torch.Tensor]:
        """Ends a call: its fg and fusion inputs on the device, in ``fg_in``'s order."""
        if self.dev.type == "cpu":
            with span("forecast.stage"):
                return {k: self._resident(v) for k, v in fg_in.items()}
        return self._on_device(fg_in, {})

    def _on_device(self, src: Mapping[str, Any], casts) -> Dict[str, torch.Tensor]:
        """``src`` on the device, in its order: each input where it lies,
        or staged (cast by ``casts``) in one ``_staging`` block."""
        out = {k: self._resident(v, casts.get(k)) for k, v in src.items()}
        host = [k for k, t in out.items() if t is None]
        if host:
            with self._staging() as compute:
                for k in host:
                    out[k] = self._stage(src[k], casts.get(k), compute)
        return out

    def _resident(self, x, dtype=None) -> Optional[torch.Tensor]:
        """``x`` where it lies, cast to ``dtype``, when the step's device
        reads it there (on the CPU: any input); else None."""
        if self.dev.type == "cpu":
            x = torch.as_tensor(x, device=self.dev)
        elif not (isinstance(x, torch.Tensor) and x.device == self.dev):
            return None
        self.counters["bytes_passed_through"] += x.numel() * x.element_size()
        return x if dtype is None else x.to(dtype)

    @contextlib.contextmanager
    def _staging(self):
        """A stage's host pass and copies, on the copy stream; -> the
        compute stream, which then waits for them."""
        compute = torch.cuda.current_stream(self.dev)
        with span("forecast.stage"), torch.cuda.stream(self.stream):
            yield compute
        compute.wait_stream(self.stream)

    def _stage(self, x, dtype: Optional[torch.dtype], compute) -> torch.Tensor:
        """The host input ``x`` (cast to ``dtype``) through a fresh pinned
        tensor into a fresh device tensor, by a non-blocking copy on the
        current (copy) stream."""
        host = torch.as_tensor(x)
        pinned = torch.empty(host.shape, dtype=dtype or host.dtype, pin_memory=True)
        pinned.copy_(host)
        dev = torch.empty(pinned.shape, dtype=pinned.dtype, device=self.dev)
        dev.copy_(pinned, non_blocking=True)
        dev.record_stream(compute)
        self.counters["htod_copies"] += 1
        self.counters["bytes_staged"] += pinned.numel() * pinned.element_size()
        return dev
