"""DataCard: the explicit dataset -> model contract.

Counterpart of ``panoptic_forecasting_tpu/data/cards.py``: the class
count and normalisation statistics a dataset hands to the model builders
(the reference smuggles them through ``params``, bg_dataset.py:63-66,
fg_instance_dataset.py:139-154), JSON round trip included.
"""

from __future__ import annotations

import dataclasses
import json
import os
from typing import Any, Dict, Optional

import numpy as np

from ..parallel.mesh import is_main_process


@dataclasses.dataclass
class DataCard:
    """Normalization statistics and shape metadata handed to model builders.

    All statistics are plain numpy arrays so the card serializes to JSON and
    round-trips through checkpoints (the reference freezes the same stats as
    non-trainable ``nn.Parameter``s, e.g. odom_model.py:17-25,
    fg_model.py:62-116).
    """

    task: str
    num_classes: Optional[int] = None
    # mean/std pairs keyed by stream name, e.g. 'odom', 'traj', 'depth'.
    stats: Dict[str, Dict[str, np.ndarray]] = dataclasses.field(default_factory=dict)
    extras: Dict[str, Any] = dataclasses.field(default_factory=dict)

    def set_stats(self, name: str, mean, std) -> None:
        mean = np.asarray(mean, dtype=np.float32)
        std = np.asarray(std, dtype=np.float32)
        # Guard zero-variance channels the way torch does implicitly via eps.
        std = np.where(std < 1e-6, 1.0, std)
        self.stats[name] = {"mean": mean, "std": std}

    def mean(self, name: str) -> np.ndarray:
        return self.stats[name]["mean"]

    def std(self, name: str) -> np.ndarray:
        return self.stats[name]["std"]

    def to_json(self) -> str:
        def conv(x):
            if isinstance(x, np.ndarray):
                return {"__ndarray__": x.tolist(), "dtype": str(x.dtype)}
            if isinstance(x, dict):
                return {k: conv(v) for k, v in x.items()}
            if isinstance(x, (list, tuple)):
                return [conv(v) for v in x]
            if isinstance(x, (np.integer,)):
                return int(x)
            if isinstance(x, (np.floating,)):
                return float(x)
            return x

        return json.dumps(
            {
                "task": self.task,
                "num_classes": self.num_classes,
                "stats": conv(self.stats),
                "extras": conv(self.extras),
            },
            indent=2,
        )

    @classmethod
    def from_json(cls, text: str) -> "DataCard":
        def unconv(x):
            if isinstance(x, dict):
                if "__ndarray__" in x:
                    return np.asarray(x["__ndarray__"], dtype=x.get("dtype", "float32"))
                return {k: unconv(v) for k, v in x.items()}
            if isinstance(x, list):
                return [unconv(v) for v in x]
            return x

        raw = json.loads(text)
        return cls(
            task=raw["task"],
            num_classes=raw.get("num_classes"),
            stats=unconv(raw.get("stats", {})),
            extras=unconv(raw.get("extras", {})),
        )

    def save(self, working_dir: str) -> str:
        """Write ``working_dir/data_card.json`` (process 0 only)."""
        path = os.path.join(working_dir, "data_card.json")
        if not is_main_process():
            return path
        os.makedirs(working_dir, exist_ok=True)
        with open(path, "w") as f:
            f.write(self.to_json())
        return path

    @classmethod
    def load(cls, working_dir: str) -> "DataCard":
        with open(os.path.join(working_dir, "data_card.json")) as f:
            return cls.from_json(f.read())
