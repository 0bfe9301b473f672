"""Faults planted under the timed path, for the check's tests and for
the readings that set its limits (PERF.md §2): each must make ``correct``
come out false. Each runner names its own in its ``FAULTS``
(``portbench/harness/<kind>.py``).

A forecast fault wraps the step; a training fault patches the model or
the optimizer's steps and returns what undoes it."""

from __future__ import annotations

import importlib
from typing import Callable, Dict

import torch
from torch.optim.optimizer import (register_optimizer_step_post_hook,
                                   register_optimizer_step_pre_hook)


def forecast_altered(step: Callable) -> Callable:
    """An answer altered where it is produced: every instance id off by one."""
    def broken(pc_in, fg_in):
        out = step(pc_in, fg_in)
        out["ids"] = torch.where(out["ids"] > 0, out["ids"] + 1, out["ids"])
        return out
    return broken


def forecast_half_batch(step: Callable) -> Callable:
    """Half of the batch left out: the second half of the instance slots
    dropped (never painted, no id)."""
    def broken(pc_in, fg_in):
        fg_in = dict(fg_in)
        valid = fg_in["valid"].copy()
        valid[:, valid.shape[1] // 2:] = False
        fg_in["valid"] = valid
        return step(pc_in, fg_in)
    return broken


def train_half_batch(model) -> Callable:
    """Half of the batch left out: the loss, its mean and its gradient
    taken over the first half of the rows."""
    loss = model.loss

    def broken(batch: Dict):
        half = {k: ({kk: vv[: len(vv) // 2] for kk, vv in v.items()} if isinstance(v, dict)
                    else v) for k, v in batch.items()}
        return loss(half)

    model.loss = broken
    return lambda: setattr(model, "loss", loss)


def train_altered(model) -> Callable:
    """An answer altered where it is produced: the first parameter's
    gradient doubled as backward produces it."""
    handle = next(model.parameters()).register_hook(lambda g: g * 2)
    return handle.remove


def train_unchanged(model) -> Callable:
    """A step that returns its state unchanged: each optimizer step's
    parameters put back as they were before it."""
    kept = {}

    def pre(opt, args, kwargs):
        kept["p"] = [p.detach().clone() for p in model.parameters()]

    def post(opt, args, kwargs):
        with torch.no_grad():
            for p, v in zip(model.parameters(), kept["p"]):
                p.copy_(v)

    hooks = [register_optimizer_step_pre_hook(pre), register_optimizer_step_post_hook(post)]
    return lambda: [h.remove() for h in hooks]


def sample_altered(model) -> Callable:
    """An answer altered where it is produced: the train dataset's every
    sample with its first GT pixel moved to the next class."""
    from panoptic_forecasting_tpu_torch.data.bg_data import BGDataset

    get = BGDataset.__getitem__

    def broken(self, idx):
        out = get(self, idx)
        gt = out["labels"]["seg"]
        gt[0, 0] = (gt[0, 0] + 1) % 11
        return out

    BGDataset.__getitem__ = broken
    return lambda: setattr(BGDataset, "__getitem__", get)


class _ByKind:
    """``FAULTS[kind]``: the ``FAULTS`` of the runner ``portbench/harness/<kind>.py``."""

    def __getitem__(self, kind: str) -> Dict[str, Callable]:
        return importlib.import_module(f"portbench.harness.{kind}").FAULTS


FAULTS = _ByKind()
# faults of the data layer, for the cells whose traffic is ``files``
DATA_FAULTS = {"sample_altered": sample_altered}
