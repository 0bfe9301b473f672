"""Train a task model (reference experiments/train_model.py:16-26).

Counterpart of ``panoptic_forecasting_tpu/cli/train.py``: set up the
config's datasets (the train split's statistics go on the data card
before the model is built) and model, write ``config.yaml`` and the data
card, then ``train/loop.py::train`` with per-split metric writers
(``logs/metrics.jsonl``). It writes ``best_model``, ``model_checkpoint``
and ``training_checkpoint`` in the working dir.

Usage:
    python -m panoptic_forecasting_tpu_torch.cli.train --working_dir DIR \\
        --config_file configs/odom/odom_train.yaml [--continue_training] \\
        [--set a.b v ...] [--set platform cpu]

It runs on ``cuda`` and raises without it, unless ``platform`` is ``cpu``.
Data-parallel over N ranks with the JAX mesh's global-batch semantics
(``parallel/mesh.py``; NCCL on the cards, gloo with ``platform cpu``),
one process per card:

    torchrun --nproc_per_node N -m panoptic_forecasting_tpu_torch.cli.train \
        --distributed --working_dir DIR --config_file ...
    python -m panoptic_forecasting_tpu_torch.cli.train --distributed \
        --coordinator_address HOST:PORT --num_processes N --process_id I ...

Every rank gets the same arguments; process 0 alone writes the files.
"""

from __future__ import annotations

import sys

from ..core.config import load_config, save_config
from ..core.metrics import build_writers
from ..train.loop import train
from .common import setup


def main(argv=None):
    """Returns ``train``'s result."""
    cfg, task_data, model = setup(load_config(argv), test=False)
    save_config(cfg, cfg["working_dir"])
    task_data.card.save(cfg["working_dir"])
    splits = [s for s in ("train", "val") if s in task_data.datasets]
    with build_writers(cfg["working_dir"], splits) as writers:
        return train(model, task_data, cfg, writers)


if __name__ == "__main__":
    main(sys.argv[1:])
