"""Model and trainer checkpoints in the port's own format.

Counterpart of ``panoptic_forecasting_tpu/core/checkpoint.py`` (reference
train.py:139-141, 275-289): per run ``working_dir/best_model`` (val-best),
``working_dir/model_checkpoint`` (latest) and
``working_dir/training_checkpoint`` (the trainer's state: epoch to resume
at, best val result and epoch, step, optimizer state), the JAX package's
names. Each is one file written by ``torch.save`` and an atomic rename: a
module's ``state_dict`` (CPU tensors), or the trainer's dict of tensors
and plain values, read back with ``weights_only``; in a distributed run
process 0 alone writes them. Orbax directories of
the JAX package are not read (carry JAX weights across with
``models/convert.py``).

Normalisation statistics (top-level ``*_mean``/``*_std`` buffers, such as
odom ``odom_mean``, bg ``depth_mean`` or fg ``traj_std``) are saved but
not restored: the JAX package keeps them out of its checkpoints and
takes them from the data card, so a restored module keeps the statistics
it was built with.
"""

from __future__ import annotations

import os
from typing import Any, Dict, Mapping

import torch

from ..parallel.mesh import is_main_process

BEST = "best_model"
LATEST = "model_checkpoint"
TRAINER = "training_checkpoint"


def is_stat_key(name: str) -> bool:
    """A module's own normalisation statistic (not a BatchNorm buffer)."""
    return "." not in name and name.endswith(("_mean", "_std"))


def load_weights(module: torch.nn.Module, state: Mapping[str, torch.Tensor]
                 ) -> torch.nn.Module:
    """Load every entry of ``state`` but the statistics into ``module``;
    any other missing or unexpected key raises."""
    weights = {k: v for k, v in state.items() if not is_stat_key(k)}
    missing, unexpected = module.load_state_dict(weights, strict=False)
    missing = [k for k in missing if not is_stat_key(k)]
    if missing or unexpected:
        raise KeyError(f"checkpoint does not fit the module: missing "
                       f"{missing}, unexpected {unexpected}")
    return module


def _save(path: str, obj: Any) -> str:
    """``torch.save`` to ``path`` by an atomic replace, process 0 only."""
    if not is_main_process():
        return path
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    tmp = path + ".tmp_new"
    torch.save(obj, tmp)
    os.replace(tmp, path)
    return path


def save_model(working_dir: str, module: torch.nn.Module,
               best: bool = False) -> str:
    """Write ``module``'s state_dict to ``working_dir/{best_model,
    model_checkpoint}`` (atomic replace)."""
    state = {k: v.detach().cpu() for k, v in module.state_dict().items()}
    return _save(os.path.join(working_dir, BEST if best else LATEST), state)


def load_model(path_or_dir: str, module: torch.nn.Module,
               best: bool = False) -> torch.nn.Module:
    """Restore ``module`` from an explicit checkpoint file or from a
    working dir's ``best_model`` (``best``) or ``model_checkpoint``."""
    path = path_or_dir
    if os.path.isdir(path_or_dir):
        path = os.path.join(path_or_dir, BEST if best else LATEST)
    state = torch.load(path, map_location="cpu", weights_only=True)
    return load_weights(module, state)


def save_trainer_state(working_dir: str, state: Dict[str, Any]) -> str:
    """Write the trainer's state (tensors and plain values) to
    ``working_dir/training_checkpoint``."""
    return _save(os.path.join(working_dir, TRAINER), state)


def load_trainer_state(working_dir: str) -> Dict[str, Any]:
    return torch.load(os.path.join(working_dir, TRAINER), map_location="cpu",
                      weights_only=True)


def has_trainer_state(working_dir: str) -> bool:
    return os.path.isfile(os.path.join(working_dir, TRAINER))
