"""The training step replayed from CUDA graphs.

A fixed-shape step launches thousands of kernels (bg: HarDNet's
hand-rolled BatchNorm passes, the clip's per-parameter kernels), and in
eager mode the device waits on the host's dispatch of each. After the
first optimizer step of a ``train()`` call, which runs eager (it makes
SGD's momentum buffers and cuDNN's plans), the next step is captured
into three CUDA graphs and replayed, and every later step copies its
batch into the graphs' input tensors and replays them. The device work
is the eager step's: the same kernels in the same order, on the same
parameters, BatchNorm statistics and momentum buffers, updated in place.

* ``pf.train.to_device`` moves the batch into the captured inputs in
  three copies, all launched in that span. The host pass copies each
  leaf, with torch's threaded copy, into a pinned host buffer of its own,
  and ends before ``step`` returns: the caller's arrays are not read
  after it. A non-blocking DMA on a copy stream then fills a held device
  staging set from those buffers, and a DtoD on the compute stream
  copies the staging set into the captured inputs right before the
  forward replay. Replays are asynchronous, so the host stages batch
  k + 1 while step k's graphs still run, and its DMA overlaps their
  kernels. The copy stream waits (on the device) for the last DtoD
  before it writes the staging set again; the host waits for the last
  DMA before it writes the pinned buffers again. On a CPU device the same
  copies run in the same order into plain tensors, with no stream.
  ``pf.train.forward`` replays the forward graph (``model.loss``),
  ``pf.train.backward`` the backward graph
  (``(loss / accumulate_steps).backward()``) and ``pf.train.optim`` the
  update graph (the clip, the optimizer step, the frozen slices; one
  process has no gradients to all-reduce). The three graphs share one
  memory pool and are replayed in the order they were captured; the
  buffers, the staging set and the captured inputs are allocated once,
  before the first capture, outside that pool. Eager steps copy their
  batch with ``pf.train.to_device`` (``train/loop.py``).
* the gradients are the backward graph's outputs, written afresh at each
  replay (they were None when it was captured): ``zero_grad``'s effect.
  The update graph reads them.
* the learning rate is a constant of the update graph: a new rate (an
  epoch's ``set_lr``) captures that graph again before the step that
  runs at it.

The graphs engage only where the step can be replayed as it ran: on a
CUDA device, without a process group (DDP's collectives stay eager),
with ``accumulate_steps`` 1, with torch's SGD (Adam keeps its step count
on the host), after the call's first optimizer step, and on a batch
whose arrays have the captured keys, shapes and dtypes. Every other
batch runs the trainer's eager step, counted by its reason.

``counters``: ``steps`` (batches trained), ``captures`` (the three graphs
captured), ``optim_captures`` (the update graph captured again for a new
rate), ``replays`` (batches replayed), ``staged`` (batches moved through
the pinned buffers), ``stage_waits`` (host passes that first waited for a
DMA still reading the pinned buffers), ``eager`` ({reason: batches}).
``capture`` is the seam between the trainer and CUDA: it captures a
function's CUDA work, unrun, into a graph; ``DEVICE_TYPE`` is the device
type it captures on.
"""

from __future__ import annotations

from typing import Any, Callable, Dict, Iterator, Tuple

import torch
import torch.distributed as dist

from ..core.tracing import span

REASONS = ("cpu", "ranks", "accumulate", "optimizer", "first_step", "signature")
DEVICE_TYPE = "cuda"


def capture(fn: Callable[[], None], pool=None) -> Tuple[Callable[[], None], Any]:
    """-> (replay, pool): ``fn``'s CUDA work captured, not run, into a new
    graph that allocates from ``pool`` (a new pool when None)."""
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph, pool=pool):
        fn()
    return graph.replay, graph.pool()


def _leaves(batch: Dict[str, Any], path: Tuple[str, ...] = ()) -> Iterator:
    """(path, tensor where it lies) of each array of ``batch`` in order,
    as ``to_device`` takes them (the top level's ``meta`` left out)."""
    for k, v in batch.items():
        if path or k != "meta":
            if isinstance(v, dict):
                yield from _leaves(v, path + (k,))
            else:
                yield path + (k,), torch.as_tensor(v)


class _Host:
    """A CPU device's copy stream and events: a copy there has ended when
    it returns."""

    def query(self) -> bool:
        return True

    def synchronize(self) -> None:
        pass

    def record(self, stream=None) -> None:
        pass

    def wait_event(self, event) -> None:
        pass


def _nest(items) -> Dict[str, Any]:
    out: Dict[str, Any] = {}
    for path, t in items:
        d = out
        for k in path[:-1]:
            d = d.setdefault(k, {})
        d[path[-1]] = t
    return out


class StepGraphs:
    """The step's graphs for one ``train()`` call over ``model`` and its
    optimizer ``opt`` (``train/optim.py``)."""

    def __init__(self, model: torch.nn.Module, opt, accum: int):
        self.model, self.opt, self.accum = model, opt, accum
        self.device = next(model.parameters()).device
        self.counters = {"steps": 0, "captures": 0, "optim_captures": 0, "replays": 0,
                         "staged": 0, "stage_waits": 0, "eager": dict.fromkeys(REASONS, 0)}
        self.fixed = ("cpu" if self.device.type != DEVICE_TYPE else
                      "ranks" if dist.is_available() and dist.is_initialized() else
                      "accumulate" if accum != 1 else
                      "optimizer" if type(opt.inner) is not torch.optim.SGD else None)
        self.warm = False  # an optimizer step has run in this call
        self.signature = None  # the captured batch's
        self._pending = None  # the accepted batch's leaves
        self._pool = self._fwd = self._bwd = self._upd = None
        self._static = self.inputs = self._out = self._grads = self._rates = None
        self._pinned = self._staging = self._copy = self._dma = self._moved = None

    def replays(self, batch: Dict[str, Any]) -> bool:
        """Whether ``batch`` is replayed (``step`` then trains it) or runs
        eager; counts it either way."""
        self.counters["steps"] += 1
        reason = self.fixed or (None if self.warm else "first_step")
        self.warm = True  # with accumulate_steps 1 every batch steps
        if reason is None:
            leaves = list(_leaves(batch))
            sig = tuple((p, t.shape, t.dtype) for p, t in leaves)
            if self.signature is None:
                self.signature = sig
            elif sig != self.signature:
                reason = "signature"
            self._pending = leaves
        if reason is not None:
            self.counters["eager"][reason] += 1
            return False
        self.counters["replays"] += 1
        return True

    def step(self) -> Dict[str, torch.Tensor]:
        """Trains the batch ``replays`` accepted: -> its metrics (the
        forward graph's outputs, rewritten by the next replay)."""
        first = self._fwd is None
        with span("train.to_device"):
            self._stage()
            self._move()
        if not first and self._rates != self._lrs():
            for p, g in zip(self.opt.params, self._grads):
                p.grad = g  # what the update graph is to read
            self._capture_update()
            self.opt.zero_grad()
            self.counters["optim_captures"] += 1
        with span("train.forward"):
            if first:
                self._fwd = self._capture(self._forward)
                self.counters["captures"] += 1
            self._fwd()
        with span("train.backward"):
            if first:
                self._bwd = self._capture(self._backward)
            self._bwd()
        with span("train.optim"):
            if first:
                self._capture_update()
            self._upd()
            self.opt.zero_grad()
        return self._out[1]

    def _stage(self) -> None:
        """The accepted batch through the pinned buffers (a host pass)
        into the staging set (a DMA on the copy stream)."""
        leaves, self._pending = self._pending, None
        if self._static is None:
            self._allocate(leaves)
        if not self._dma.query():  # the last DMA still reads the buffers
            self.counters["stage_waits"] += 1
            self._dma.synchronize()
        for pinned, (_, src) in zip(self._pinned, leaves):
            pinned.copy_(src)
        cuda = self.device.type == "cuda"
        with torch.cuda.stream(self._copy if cuda else None):
            self._copy.wait_event(self._moved)  # the last DtoD has read the staging set
            for dev, pinned in zip(self._staging, self._pinned):
                dev.copy_(pinned, non_blocking=True)
            self._dma.record(self._copy)
        self.counters["staged"] += 1

    def _move(self) -> None:
        """The staging set into the captured inputs (a DtoD on the compute
        stream, once the DMA has filled it)."""
        compute = (torch.cuda.current_stream(self.device) if self.device.type == "cuda"
                   else self._copy)
        compute.wait_event(self._dma)
        for static, dev in zip(self._static, self._staging):
            static.copy_(dev)
        self._moved.record(compute)

    def _allocate(self, leaves) -> None:
        """A pinned buffer, a staging tensor and a captured input a leaf,
        the copy stream and its two events."""
        cuda = self.device.type == "cuda"
        like = [(t.shape, t.dtype) for _, t in leaves]
        self._pinned = [torch.empty(s, dtype=d, pin_memory=cuda) for s, d in like]
        self._staging, self._static = ([torch.empty(s, dtype=d, device=self.device)
                                        for s, d in like] for _ in range(2))
        self.inputs = _nest((p, s) for (p, _), s in zip(leaves, self._static))
        if cuda:
            self._copy = torch.cuda.Stream(self.device)
            self._dma, self._moved = torch.cuda.Event(), torch.cuda.Event()
        else:
            self._copy = self._dma = self._moved = _Host()

    def _capture(self, fn: Callable[[], None]) -> Callable[[], None]:
        replay, self._pool = capture(fn, self._pool)
        return replay

    def _capture_update(self) -> None:
        self._upd = self._capture(self._update)
        self._rates = self._lrs()

    def _lrs(self) -> Tuple[float, ...]:
        return tuple(g["lr"] for g in self.opt.inner.param_groups)

    # the trainer's eager step (train/loop.py), as the graphs hold it

    def _forward(self) -> None:  # one process: the batch is never a shard
        self._out = self.model.loss(self.inputs)

    def _backward(self) -> None:
        (self._out[0] / self.accum).backward()
        self._grads = [p.grad for p in self.opt.params]

    def _update(self) -> None:
        self.opt.step()
