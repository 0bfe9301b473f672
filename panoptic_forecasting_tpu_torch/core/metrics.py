"""Metric logging: ``logs/metrics.jsonl`` always, TensorBoard per split
where tensorboardX imports.

Counterpart of ``panoptic_forecasting_tpu/core/metrics.py`` (reference
``build_writers``, train_utils.py:27-42): one writer per data split; every
key of the model's loss dict becomes an epoch-averaged scalar
(train.py:227-230, 268-271), one JSON line each ``{ts, split, step,
...scalars}`` in ``working_dir/logs/metrics.jsonl``, and, where the
package imports, a TensorBoard event file under ``working_dir/logs/<split>``.
In a distributed run process 0 alone writes (JAX :26, :35).
"""

from __future__ import annotations

import contextlib
import json
import os
import time
from typing import Dict, Iterator, List, Sequence

from ..parallel.mesh import is_main_process


class SplitWriter:
    def __init__(self, working_dir: str, split: str, jsonl_path: str):
        self.split = split
        self._jsonl_path = jsonl_path
        self._tb = None
        if not is_main_process():
            return
        try:
            from tensorboardX import SummaryWriter
        except ImportError:
            pass
        else:
            self._tb = SummaryWriter(os.path.join(working_dir, "logs", split))

    def add_scalars(self, scalars: Dict[str, float], step: int) -> None:
        if not is_main_process():
            return
        if self._tb is not None:
            for k, v in scalars.items():
                self._tb.add_scalar(k, float(v), global_step=step)
        with open(self._jsonl_path, "a") as f:
            f.write(json.dumps({"ts": time.time(), "split": self.split,
                                "step": step,
                                **{k: float(v) for k, v in scalars.items()}})
                    + "\n")

    def close(self) -> None:
        if self._tb is not None:
            self._tb.close()


@contextlib.contextmanager
def build_writers(working_dir: str, splits: Sequence[str]) -> Iterator[List[SplitWriter]]:
    """One ``SplitWriter`` per split, closed on exit."""
    if is_main_process():
        os.makedirs(os.path.join(working_dir, "logs"), exist_ok=True)
    jsonl = os.path.join(working_dir, "logs", "metrics.jsonl")
    writers = [SplitWriter(working_dir, s, jsonl) for s in splits]
    try:
        yield writers
    finally:
        for w in writers:
            w.close()
