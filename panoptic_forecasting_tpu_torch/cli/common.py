"""Shared CLI plumbing: device, seeding, datasets, model restore, host
overlap helpers.

Counterpart of ``panoptic_forecasting_tpu/cli/common.py``. The config's
``platform`` key picks the device: ``cpu`` runs on the CPU, anything else
(or nothing) on ``cuda``, which raises when CUDA is absent. With
``distributed`` the process joins its group first
(``parallel/mesh.py::init_distributed``) and runs on its own card,
``cuda:{LOCAL_RANK}``.
"""

from __future__ import annotations

import os
import random
from typing import Any, Dict, Tuple

import numpy as np
import torch

from ..core import build_dataset, build_model
from ..core import checkpoint as ckpt
from ..core.config import Config
from ..device import resolve_device
from ..parallel.mesh import init_distributed


def seed_everything(seed: int) -> None:
    """Host RNG seeding (reference utils/misc.py:15-19), torch's included."""
    random.seed(seed)
    np.random.seed(seed)
    torch.manual_seed(seed)


def config_device(cfg) -> torch.device:
    """``platform: cpu`` -> the CPU; otherwise ``cuda`` (raises without it),
    with TF32 off: the reference computes in full f32, and cuDNN would
    take TF32 for convolutions by default."""
    if cfg.get("platform") == "cpu":
        return resolve_device("cpu")
    if not torch.cuda.is_available():
        raise RuntimeError("CUDA is not available; set platform to cpu "
                           "(--set platform cpu) to run on the CPU")
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    return resolve_device("cuda")


def setup(cfg: Config, test: bool = False) -> Tuple[Config, Any, Any]:
    """device -> process group (``distributed``) -> seed -> build datasets
    -> build the model on the config's device. Outside ``test`` the train
    split is built and its statistics are on the data card before the
    model reads them. Returns (cfg, task data, model)."""
    device = config_device(cfg)
    if init_distributed(cfg) and device.type == "cuda":
        device = torch.device("cuda", torch.cuda.current_device())
    seed_everything(int(cfg.get("seed", 0)))
    task_data = build_dataset(cfg, test=test)
    if cfg.get("load_torch_model"):
        # Reference *.pt checkpoints carry the normalisation stats: they go
        # into the card BEFORE the model reads it, as in the JAX package.
        for name, (mean, std) in _torch_checkpoint_stats(cfg).items():
            task_data.card.set_stats(name, mean, std)
    model = build_model(cfg, task_data.card, device)
    return cfg, task_data, model


def _load_torch_checkpoint(path: str) -> Dict[str, torch.Tensor]:
    sd = torch.load(path, map_location="cpu", weights_only=False)
    return sd.state_dict() if hasattr(sd, "state_dict") else sd


def _torch_checkpoint_stats(cfg) -> Dict[str, Tuple[np.ndarray, np.ndarray]]:
    """{name: (mean, std)} of the checkpoint's statistics, each 1-D (the
    JAX package's ``reference_import._stat``)."""
    sd = _load_torch_checkpoint(cfg["load_torch_model"])

    def stat(k):
        return sd[k].numpy().reshape(-1)

    return {
        k[: -len("_mean")]: (stat(k), stat(k[: -len("_mean")] + "_std"))
        for k in sd
        if ckpt.is_stat_key(k) and k.endswith("_mean")
    }


def restore_params(cfg, model: torch.nn.Module) -> torch.nn.Module:
    """Restore ``model`` in the JAX package's order (reference
    models/__init__.py:29-41): ``load_torch_model`` (a reference ``.pt``,
    loaded straight in: the port's modules keep the reference's names),
    then an explicit ``load_model``, then ``working_dir/best_model``, then
    ``working_dir/model_checkpoint``; with none of them, seeded weights
    (``seed``) and the pretrained ones the config names. Normalisation
    statistics stay as the data card gave them
    (``core/checkpoint.py``)."""
    from ..models.base import init_weights

    if cfg.get("load_torch_model"):
        return ckpt.load_weights(model, _load_torch_checkpoint(cfg["load_torch_model"]))
    if cfg.get("load_model"):
        return ckpt.load_model(cfg["load_model"], model)
    wd = cfg["working_dir"]
    for name in (ckpt.BEST, ckpt.LATEST):
        path = os.path.join(wd, name)
        if os.path.isfile(path):
            return ckpt.load_model(path, model)
    return init_weights(model, int(cfg.get("seed", 0)))


def export_writer(cfg):
    """AsyncWriter for an export CLI: host-side PNG writes overlap the
    next frame's device step. ``export_write_threads: 0`` makes the
    writes synchronous."""
    from ..data.io import AsyncWriter

    return AsyncWriter(workers=int(cfg.get("export_write_threads", 4)))


def pipelined_map(fn, iterable, depth: int = 2):
    """Yield ``(fn(item), item)`` in order, computing the next items'
    ``fn`` on one background thread.

    ``fn`` is host work (file reads and decodes); the iterable itself is
    advanced on the caller's thread. The fused forecast overlaps the next
    frame's pc input fetch with the device step this way.
    """
    from collections import deque
    from concurrent.futures import ThreadPoolExecutor

    ex = ThreadPoolExecutor(max_workers=1)
    try:
        pending = deque()
        for item in iterable:
            pending.append((ex.submit(fn, item), item))
            while len(pending) >= depth:
                fut, it0 = pending.popleft()
                yield fut.result(), it0
        while pending:
            fut, it0 = pending.popleft()
            yield fut.result(), it0
    finally:
        ex.shutdown(wait=True)
