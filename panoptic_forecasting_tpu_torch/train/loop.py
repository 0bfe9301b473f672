"""Training loop with the reference's epoch protocol.

Counterpart of ``panoptic_forecasting_tpu/train/loop.py::train``
(reference training/train.py:66-305), with its semantics:

* one step = forward, backward, clip and update (``train/optim.py``);
  with ``accumulate_steps`` k the loss is scaled by 1/k, k gradients are
  summed, and the update (clipped there) is applied on the boundary; a
  partial window at an epoch's end is dropped;
* metric sums stay on the device through an epoch and are fetched once
  (a vector loss counts each sample, a scalar one);
* epoch e runs at ``lr_for_epoch(e - 1)`` (torch schedulers step at the
  epoch's end);
* validation, saves and history only when ``(epoch + 1) % val_interval
  == 0`` (the reference's quirk, train.py:231); the best model by val
  ``loss`` (train ``loss`` with no val split), the latest model and the
  trainer state are saved then;
* weights start from the seed (``models/base.py::init_weights``, the
  fg mask head's pretrained file included) or ``load_model``;
  ``continue_training`` resumes from ``working_dir``'s latest model and
  trainer state.

The trainer state also holds the training loader's RandomState, so a
resumed run draws the samples a straight run would (the JAX trainer
starts a fresh loader on resume); a state without it starts the loader
afresh, as JAX does. ``training.profile_dir`` writes a ``torch.profiler``
trace of the first ``profile_steps`` steps; ``training.verbose`` prints
each batch's loss (a host sync a batch). While a profiler records, each
training batch is the span ``pf.train.data`` (the loader's ``next()``),
then ``pf.train.step`` holding ``pf.train.to_device``, ``.forward``,
``.backward`` and, on an optimizer step, ``.optim`` (``core/tracing.py``);
validation has none. Where the step can be replayed (a CUDA device, no
process group, no accumulation, SGD, a batch of the captured shapes), every
step after the first runs from CUDA graphs in those spans
(``train/graph.py``); the result's ``graph`` counts replays and eager
steps by reason.

In a distributed run (``parallel/mesh.py``) every rank trains on its
rows of the JAX mesh's global batch, which ``training.batch_size`` must
divide over the world: the BN statistics and the bg loss's valid count
are global within the step, the gradients are all-reduced once per
optimizer step before the clip (summed for a loss whose shards add up
to it, averaged for a per-sample mean: the model's
``loss_adds_over_shards``), the metric sums and counts once an epoch,
validation shards the same way, and process 0 alone writes; the others
wait at a barrier after each epoch's writes and before a resume reads.
The ranks' parameters are checked equal once, after init or load.
"""

from __future__ import annotations

import os
import time
from typing import Any, Dict, Optional

import numpy as np
import torch

from ..core import checkpoint as ckpt
from ..core.tracing import span, spanned
from ..models.base import init_weights
from ..parallel import mesh
from .graph import StepGraphs
from .optim import build_optimizer, lr_for_epoch


def to_device(batch: Dict[str, Any], device: torch.device) -> Dict[str, Any]:
    """A numpy batch without its host-only ``meta`` as tensors on
    ``device`` (reference train_utils.py:56-61)."""

    def conv(x):
        if isinstance(x, dict):
            return {k: conv(v) for k, v in x.items()}
        return torch.as_tensor(x, device=device)

    return {k: conv(v) for k, v in batch.items() if k != "meta"}


class _Sums:
    """Metric sums over an epoch, on the device until ``means``; the count
    is ``loss``'s samples (1 for a scalar loss).

    Distributed, each rank adds its share and ``means`` all-reduces sums
    and count once: a sharded batch's per-sample vectors add their rows
    and counts; a sharded scalar (bg's) is the rank's share of the batch's
    value and counts once, on process 0; a replicated batch counts once,
    on process 0 (the others add zeros)."""

    def __init__(self):
        self.sums, self.count = None, 0

    def add(self, metrics: Dict[str, torch.Tensor], sharded: bool = False) -> None:
        main = mesh.is_main_process()
        if sharded or main:
            sums = {k: v.detach().sum().float() for k, v in metrics.items()}
            loss = metrics["loss"]
            count = loss.numel() if loss.dim() else int(main)
        else:
            sums = {k: torch.zeros((), device=v.device) for k, v in metrics.items()}
            count = 0
        self.sums = sums if self.sums is None else {
            k: self.sums[k] + v for k, v in sums.items()}
        self.count += count

    def means(self) -> Dict[str, float]:
        if self.sums is None:
            return {}
        sums, count = self.sums, self.count
        if mesh.world_size() > 1:
            keys = list(sums)
            total = torch.stack([sums[k] for k in keys]
                                + [sums[keys[0]].new_tensor(float(count))])
            torch.distributed.all_reduce(total)
            sums, count = dict(zip(keys, total[:-1])), int(total[-1])
        n = float(max(count, 1))
        return {k: float(v) / n for k, v in sums.items()}


def _loader_state(loader) -> Dict[str, Any]:
    name, keys, pos, has_gauss, cached = loader.rng_state
    return {"keys": torch.from_numpy(keys.astype(np.int64)), "pos": int(pos),
            "has_gauss": int(has_gauss), "cached": float(cached)}


def _set_loader_state(loader, state: Dict[str, Any]) -> None:
    loader.rng_state = ("MT19937", state["keys"].numpy().astype(np.uint32),
                        state["pos"], state["has_gauss"], state["cached"])


def _profiler(device: torch.device):
    acts = [torch.profiler.ProfilerActivity.CPU]
    if device.type == "cuda":
        acts.append(torch.profiler.ProfilerActivity.CUDA)
    prof = torch.profiler.profile(activities=acts)
    prof.start()
    return prof


def _stop_profiler(prof, profile_dir: str, device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    prof.stop()
    os.makedirs(profile_dir, exist_ok=True)
    prof.export_chrome_trace(os.path.join(profile_dir, "trace.json"))
    print(f"profiler trace written to {profile_dir}")


def train(model: torch.nn.Module, task_data, cfg: Dict[str, Any],
          writers=None) -> Dict[str, Any]:
    """Train ``model`` (on its device) on ``task_data``; returns the model,
    best val result and epoch, step count, the per-epoch history and the
    step graphs' counters (``graph``)."""
    t = cfg.get("training", {})
    num_epochs = int(t.get("num_epochs", 100))
    val_interval = int(t.get("val_interval", 1))
    accum = int(t.get("accumulate_steps", 1))
    seed = int(cfg.get("seed", 0))
    working_dir = cfg["working_dir"]
    verbose = bool(t.get("verbose"))
    device = next(model.parameters()).device
    batch_size, world = int(t.get("batch_size", 32)), mesh.world_size()
    if batch_size % world:
        raise ValueError(
            f"training.batch_size {batch_size} does not divide over {world} ranks. "
            "JAX sizes its mesh to the largest device count that divides the batch "
            "(train/loop.py), leaving the other devices idle; launch a number of "
            "ranks that divides the batch")

    train_writer = writers[0] if writers else None
    val_writer = writers[1] if writers and len(writers) > 1 else None
    train_loader = task_data.loader("train", cfg, seed=seed, shard=True)
    val_loader = (task_data.loader("val", cfg, seed=seed, shard=True)
                  if "val" in task_data.datasets else None)

    init_weights(model, seed)
    if cfg.get("load_model"):
        ckpt.load_model(cfg["load_model"], model)
    opt = build_optimizer(model, cfg)
    lr_sched = lr_for_epoch(cfg)

    start_epoch, best_val_epoch, best_val_result, step = 1, -1, 1e7, 0
    mesh.barrier()  # a resume reads what the previous run's process 0 wrote
    if cfg.get("continue_training") and ckpt.has_trainer_state(working_dir):
        ckpt.load_model(working_dir, model)
        state = ckpt.load_trainer_state(working_dir)
        start_epoch = int(state["epoch"])
        best_val_result = float(state["best_val_result"])
        best_val_epoch = int(state["best_val_epoch"])
        step = int(state["step"])
        opt.load_state_dict(state["opt_state"])
        if "loader_state" in state:
            _set_loader_state(train_loader, state["loader_state"])
        print(f"RESUMING TRAINING AT EPOCH {start_epoch}")
    mesh.check_replicas_agree(model.state_dict().values())

    def run_val() -> Dict[str, float]:
        model.eval()
        sums = _Sums()
        with torch.no_grad():
            for batch in val_loader:
                sharded = batch.pop("sharded", False)
                with mesh.sharded_batch(sharded):
                    sums.add(model.loss(to_device(batch, device))[1], sharded)
        return sums.means()

    graphs = StepGraphs(model, opt, accum)
    profile_dir = t.get("profile_dir")
    profile_steps = int(t.get("profile_steps", 5))
    prof = None

    history = []
    for epoch in range(start_epoch, num_epochs + 1):
        t0 = time.time()
        train_loader.set_epoch(epoch)
        if profile_dir and epoch == start_epoch:
            prof = _profiler(device)
        opt.set_lr(lr_sched(epoch - 1))
        model.train()
        opt.zero_grad()
        sums, micro = _Sums(), 0
        for batch_ind, batch in enumerate(spanned(train_loader, "train.data")):
            with span("train.step"):
                sharded = batch.pop("sharded", False)
                if graphs.replays(batch):
                    metrics = graphs.step()
                    step += 1
                else:
                    with span("train.to_device"):
                        inputs = to_device(batch, device)
                    with span("train.forward"), mesh.sharded_batch(sharded):
                        mean_loss, metrics = model.loss(inputs)
                    with span("train.backward"):
                        (mean_loss / accum).backward()
                    del mean_loss
                    micro += 1
                    if micro == accum:
                        with span("train.optim"):
                            mesh.all_reduce_grads(opt.params,
                                                  average=not model.loss_adds_over_shards)
                            opt.step()
                            opt.zero_grad()
                        micro = 0
                        step += 1
                sums.add(metrics, sharded)
                if verbose:
                    loss = metrics["loss"].detach()
                    print(f"\tBATCH {batch_ind + 1}: {float(loss.mean()):.6f}")
                # An eager step's autograd graph dies with it: a capture would
                # reuse its gradient accumulators, which launch on the stream
                # they were made on (the default one, which cannot join a capture)
                del metrics
            if prof is not None and batch_ind + 1 >= profile_steps:
                _stop_profiler(prof, profile_dir, device)
                prof = None
        if prof is not None:  # epoch shorter than profile_steps
            _stop_profiler(prof, profile_dir, device)
            prof = None
        train_scalars = sums.means()
        if train_writer is not None:
            train_writer.add_scalars(train_scalars, epoch)

        if (epoch + 1) % val_interval != 0:
            continue

        val_scalars: Optional[Dict[str, float]] = None
        epoch_loss = train_scalars["loss"]
        if val_loader is not None:
            val_scalars = run_val()
            if val_writer is not None:
                val_writer.add_scalars(val_scalars, epoch)
            epoch_loss = val_scalars["loss"]

        if epoch_loss < best_val_result:
            best_val_epoch, best_val_result = epoch, epoch_loss
            ckpt.save_model(working_dir, model, best=True)
        ckpt.save_model(working_dir, model, best=False)
        ckpt.save_trainer_state(working_dir, {
            "epoch": epoch + 1,
            "best_val_result": best_val_result,
            "best_val_epoch": best_val_epoch,
            "step": step,
            "opt_state": opt.state_dict(),
            "loader_state": _loader_state(train_loader),
        })
        mesh.barrier()  # process 0's writes are done before the next epoch
        history.append({"epoch": epoch, "train": train_scalars, "val": val_scalars})
        print(
            f"EPOCH {epoch} ({time.time() - t0:.1f}s): "
            f"train loss {train_scalars['loss']:.6f}"
            + (f", val loss {epoch_loss:.6f}" if val_loader is not None else "")
            + f" (best {best_val_result:.6f} @ {best_val_epoch})"
        )

    return {
        "model": model,
        "best_val_result": best_val_result,
        "best_val_epoch": best_val_epoch,
        "step": step,
        "history": history,
        "graph": graphs.counters,
    }
