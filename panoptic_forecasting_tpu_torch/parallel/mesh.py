"""Data parallelism over ``torch.distributed``: the communication layer.

Counterpart of ``panoptic_forecasting_tpu/parallel/mesh.py`` (reference
``utils/dist.py``, the DDP strategy of training/train.py:99-103). JAX
shards the global batch over a 1-D ``data`` mesh inside one jitted step,
so every reduction over the batch (the loss, BatchNorm's statistics, the
metric sums) is global and the gradient is the global loss's. The port
runs one process per card (JAX's one process over several devices maps
to ``torchrun --nproc_per_node N``) and makes the same reductions global
by hand:

* every rank draws the same global batch order and fetches only its rows
  (``shard_rows``); a batch whose size the world does not divide is
  replicated, as ``shard_batch`` replicates it;
* inside ``sharded_batch(True)`` the layers that reduce over the batch
  make their sums global: BatchNorm's statistics (``all_reduce_sum``,
  whose backward all-reduces the incoming gradient) and the bg loss's
  valid-pixel count (``models/bg.py``);
* after backward the trainer all-reduces the gradients once per
  optimizer step (``all_reduce_grads``): summed where a rank's loss is
  its share of the global loss (bg), averaged where it is its shard's
  mean (odom, fg);
* the trainer all-reduces its metric sums and counts once an epoch;
* process 0 alone writes files (checkpoints, metrics, the config, the
  data card) and prints (``_silence_nonmain_prints``).

The backend is NCCL on ``cuda`` and gloo on the CPU. A process group that
is already initialised is kept as it is: gloo can put two ranks on one
card, which NCCL refuses. Without ``distributed`` nothing here runs a
collective: ``rank()`` is 0 and ``world_size()`` 1.
"""

from __future__ import annotations

import contextlib
import contextvars
import os
from typing import Iterable, Sequence

import torch
import torch.distributed as dist

_SHARDED = contextvars.ContextVar("sharded_batch", default=False)


def _initialized() -> bool:
    return dist.is_available() and dist.is_initialized()


def rank() -> int:
    return dist.get_rank() if _initialized() else 0


def world_size() -> int:
    return dist.get_world_size() if _initialized() else 1


def is_main_process() -> bool:
    return rank() == 0


def _local_rank(cfg) -> int:
    """torchrun's ``LOCAL_RANK``; else the rank modulo the host's cards
    (one process per card on one host)."""
    if "LOCAL_RANK" in os.environ:
        return int(os.environ["LOCAL_RANK"])
    if _initialized():
        r = dist.get_rank()
    elif cfg.get("process_id") is not None:
        r = int(cfg["process_id"])
    else:
        r = int(os.environ.get("RANK", 0))
    return r % torch.cuda.device_count()


def init_distributed(cfg) -> bool:
    """Join the process group (reference utils/dist.py:12-32).

    Nothing without ``distributed``. With ``coordinator_address``,
    ``num_processes`` and ``process_id`` it rendezvouses at
    ``tcp://coordinator_address``; without them it reads torchrun's
    ``RANK``, ``WORLD_SIZE``, ``MASTER_ADDR`` and ``MASTER_PORT``. On
    ``cuda`` the process first takes its card (``LOCAL_RANK``) and the
    backend is NCCL; with ``platform: cpu`` it is gloo. A group that is
    already initialised is kept. Returns True when ``distributed`` is
    set."""
    if not cfg.get("distributed"):
        return False
    cuda = cfg.get("platform") != "cpu"
    if cuda:
        torch.cuda.set_device(_local_rank(cfg))
    if not _initialized():
        keys = ("coordinator_address", "num_processes", "process_id")
        given = [k for k in keys if cfg.get(k) is not None]
        if given and len(given) != len(keys):
            raise ValueError(f"--distributed takes all of {keys} or none (torchrun's "
                             f"environment); given: {given}")
        kw = (dict(init_method=f"tcp://{cfg['coordinator_address']}",
                   world_size=int(cfg["num_processes"]), rank=int(cfg["process_id"]))
              if given else dict(init_method="env://"))
        dist.init_process_group("nccl" if cuda else "gloo", **kw)
    _silence_nonmain_prints()
    return True


def _silence_nonmain_prints() -> None:
    """Non-main processes print only with ``print(..., force=True)``: the
    reference's setup_for_distributed (dist.py:35-47), so a run emits one
    progress stream instead of N interleaved."""
    if is_main_process():
        return
    import builtins

    orig = builtins.print

    def quiet_print(*args, **kwargs):
        if kwargs.pop("force", False):
            orig(*args, **kwargs)

    builtins.print = quiet_print


def shard_rows(rows: Sequence) -> Sequence:
    """This rank's rows of a global batch (``shard_batch``): rank r of W
    takes ``rows[r·B/W : (r+1)·B/W]``; when W does not divide B, every
    rank takes the whole batch (JAX replicates such an array)."""
    w = world_size()
    if w == 1 or len(rows) % w:
        return rows
    k = len(rows) // w
    r = rank()
    return rows[r * k: (r + 1) * k]


@contextlib.contextmanager
def sharded_batch(sharded: bool):
    """Within the block the model's batch is this rank's share of the
    global batch (``sharded``) or the whole of it: the layers that
    reduce over the batch read ``batch_is_sharded``."""
    token = _SHARDED.set(bool(sharded))
    try:
        yield
    finally:
        _SHARDED.reset(token)


def batch_is_sharded() -> bool:
    return _SHARDED.get()


class _AllReduceSum(torch.autograd.Function):
    """y = Σ_ranks x on every rank. The global loss is the sum of the
    ranks' losses, each a function of y, so the gradient of x is the sum
    over the ranks of the gradients of y: the backward all-reduces too."""

    @staticmethod
    def forward(ctx, x):
        out = x.clone()
        dist.all_reduce(out)
        return out

    @staticmethod
    def backward(ctx, grad):
        grad = grad.clone(memory_format=torch.contiguous_format)
        dist.all_reduce(grad)
        return grad


def all_reduce_sum(x: torch.Tensor) -> torch.Tensor:
    """The sum of ``x`` over the ranks, differentiable."""
    return _AllReduceSum.apply(x)


@torch.no_grad()
def all_reduce_grads(params: Sequence[torch.nn.Parameter], average: bool) -> None:
    """Every rank's gradients become the global ones, in one all-reduce of
    one flat buffer: the ranks' sum, or with ``average`` their mean. A
    parameter that got no gradient contributes zeros (as the optimizer
    would step it). No-op without a process group."""
    if not _initialized():
        return
    flat = torch.cat([(torch.zeros_like(p) if p.grad is None else p.grad).reshape(-1)
                      for p in params])
    dist.all_reduce(flat)
    if average:
        flat.div_(world_size())
    offset = 0
    for p in params:
        p.grad = flat[offset: offset + p.numel()].view_as(p)
        offset += p.numel()


@torch.no_grad()
def check_replicas_agree(params: Iterable[torch.Tensor]) -> None:
    """Raise unless every rank holds the same tensors: one float64 sum a
    tensor, compared by one all-reduce of the maximum of (s, −s)."""
    if world_size() == 1:
        return
    sums = torch.stack([p.detach().double().sum() for p in params])
    both = torch.cat([sums, -sums])
    dist.all_reduce(both, op=dist.ReduceOp.MAX)
    n = sums.numel()
    if not torch.equal(both[:n], -both[n:]):
        raise RuntimeError("the ranks' parameters differ after init or load: every "
                           "rank must start from the same seed and checkpoint")


def barrier() -> None:
    """Wait for every rank (no-op without a process group)."""
    if _initialized():
        dist.barrier()
