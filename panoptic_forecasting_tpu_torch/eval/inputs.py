"""The forecast step's inputs on its device, each host input read once.

On a CUDA device each host input (a numpy array or a CPU tensor) is
copied once into page-locked memory, ``depth`` cast to f32 in that pass
as the step always has, and moved to the card by a non-blocking copy on
the step's copy stream:

* each pc map (``seg``, ``depth``, ``depth_mask``) from its own pinned
  tensor, in one piece, so that its DMA runs while the host fills the
  next map;
* the fg and fusion inputs packed next to each other in one pinned
  buffer, each at an offset aligned to ``ALIGN`` bytes, in one copy. The
  step stages them after it has launched bg, so their host pass and DMA
  overlap bg's kernels.

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
import math
from typing import Any, Dict, Mapping, NamedTuple, Optional, Sequence, Tuple

import torch

from ..core.tracing import span

ALIGN = 64  # bytes between packed offsets: a cache line, and every dtype's alignment
PC_KEYS = ("seg", "depth", "depth_mask")
COUNTERS = ("calls", "bytes_staged", "bytes_passed_through", "htod_copies",
            "reuse_waits", "arena_grows")


class Slot(NamedTuple):
    """An input's place in a byte buffer."""

    offset: int
    dtype: torch.dtype
    shape: Tuple[int, ...]

    @property
    def nbytes(self) -> int:
        return math.prod(self.shape) * self.dtype.itemsize


def layout(specs: Sequence[Tuple[str, torch.dtype, Sequence[int]]]
           ) -> Tuple[Dict[str, Slot], int]:
    """Slots for ``specs`` (key, dtype, shape) laid one after another, each
    offset a multiple of ``ALIGN``; -> (slots, the end of the last)."""
    slots, end = {}, 0
    for key, dtype, shape in specs:
        slot = Slot(-(-end // ALIGN) * ALIGN, dtype, tuple(int(s) for s in shape))
        slots[key] = slot
        end = slot.offset + slot.nbytes
    return slots, end


def view(buf: torch.Tensor, slot: Slot) -> torch.Tensor:
    """``slot`` of the byte tensor ``buf`` as a typed tensor of its shape."""
    return buf[slot.offset:slot.offset + slot.nbytes].view(slot.dtype).view(slot.shape)


class Inputs:
    """The inputs of one forecast step (``build_forecast_step``).

    A call is ``pc(pc_in)``, then ``fg(fg_in)``. ``stream`` is the copy
    stream. ``counters``: ``calls``; ``bytes_staged``, moved to the device
    from pinned memory; ``bytes_passed_through``, inputs read where they lay;
    ``htod_copies``; ``reuse_waits``, calls begun while the copy stream
    still ran (the allocator keeps the pinned memory those copies read
    from the new call, so nothing waits on the host); ``arena_grows``,
    calls that staged more bytes than any call before them.
    """

    def __init__(self, dev: torch.device):
        if dev.type == "cuda" and dev.index is None:
            dev = torch.device("cuda", torch.cuda.current_device())
        self.dev = dev
        self.counters = dict.fromkeys(COUNTERS, 0)
        self.stream = None if dev.type == "cpu" else torch.cuda.Stream(dev)
        self._call_bytes = self._most_bytes = 0

    def pc(self, pc_in: Mapping[str, Any]):
        """Starts a call: -> (seg, depth as f32, depth_mask) on the device."""
        self.counters["calls"] += 1
        self._call_bytes = 0
        if self.dev.type == "cpu":
            with span("forecast.stage"):
                return tuple(self._resident(pc_in[k], _cast(k)) for k in PC_KEYS)
        if not self.stream.query():
            self.counters["reuse_waits"] += 1
        out = [self._resident(pc_in[k], _cast(k)) for k in PC_KEYS]
        if any(t is None for t in out):
            with self._staging() as compute:
                for i, k in enumerate(PC_KEYS):
                    if out[i] is None:
                        host = torch.as_tensor(pc_in[k])
                        pinned = torch.empty(host.shape, dtype=_cast(k) or host.dtype,
                                             pin_memory=True)
                        out[i] = self._copy(pinned.copy_(host), compute)
        return tuple(out)

    def fg(self, fg_in: Mapping[str, Any]) -> Dict[str, torch.Tensor]:
        """Ends a call: its fg and fusion inputs on the device, in ``fg_in``'s order."""
        if self.dev.type == "cpu":
            with span("forecast.stage"):
                return {k: self._resident(v) for k, v in fg_in.items()}
        out, host = {}, {}
        for k, v in fg_in.items():
            t = self._resident(v)
            if t is None:
                host[k] = torch.as_tensor(v)
            else:
                out[k] = t
        if host:
            slots, end = layout([(k, a.dtype, a.shape) for k, a in host.items()])
            with self._staging() as compute:
                pinned = torch.empty(end, dtype=torch.uint8, pin_memory=True)
                for k, slot in slots.items():
                    view(pinned, slot).copy_(host[k])
                buf = self._copy(pinned, compute)
            out.update({k: view(buf, slot) for k, slot in slots.items()})
        if self._call_bytes > self._most_bytes:
            self._most_bytes = self._call_bytes
            self.counters["arena_grows"] += 1
        return {k: out[k] for k in fg_in}

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

    def _copy(self, pinned: torch.Tensor, compute) -> torch.Tensor:
        """``pinned`` in a fresh device tensor, by a non-blocking copy on
        the current (copy) stream."""
        dev = torch.empty(pinned.shape, dtype=pinned.dtype, device=self.dev)
        dev.copy_(pinned, non_blocking=True)
        dev.record_stream(compute)
        nbytes = pinned.numel() * pinned.element_size()
        self.counters["htod_copies"] += 1
        self.counters["bytes_staged"] += nbytes
        self._call_bytes += nbytes
        return dev


def _cast(key: str) -> Optional[torch.dtype]:
    return torch.float32 if key == "depth" else None
