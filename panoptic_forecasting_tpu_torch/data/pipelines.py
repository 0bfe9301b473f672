"""Per-task dataset bundles (registry targets).

Counterpart of ``panoptic_forecasting_tpu/data/pipelines.py`` (reference
``data/__init__.py:14-31``): each builder returns a ``TaskData`` bundle of
split datasets and the DataCard handed to the model builder. Ported
tasks: ``odom``, ``pc_transform``, ``bg`` (test mode, ``bg_data.py``)
and ``fg`` with ``dataset_type: fg_scene``; the fg-instance (training)
dataset is not ported yet and raises.
"""

from __future__ import annotations

import dataclasses
import os
from typing import Any, Callable, Dict

from ..core.registry import register_dataset
from .cards import DataCard
from .loader import Loader, default_collate


@dataclasses.dataclass
class TaskData:
    datasets: Dict[str, Any]
    card: DataCard
    collate_fn: Callable = default_collate

    def loader(self, split: str, cfg: Dict[str, Any],
               test: bool = False) -> Loader:
        """Batches of ``split`` in order (``training.val_batch_size`` or
        ``batch_size``). ``training.num_data_threads`` (default min(8,
        cores)) threads fetch each batch's samples and
        ``training.prefetch_batches`` (default 2 with threads) batches are
        prepared ahead. The training loader (shuffled train split) is not
        ported yet."""
        if split == "train" and not test:
            raise NotImplementedError("the training loader is not ported yet")
        t = cfg.get("training", {})
        bs = int(t.get("val_batch_size") or t.get("batch_size", 32))
        threads = int(t.get("num_data_threads", min(8, os.cpu_count() or 1)))
        prefetch = int(t.get("prefetch_batches", 2 if threads else 0))
        return Loader(self.datasets[split], bs, collate_fn=self.collate_fn,
                      prefetch=prefetch, num_threads=threads)


@register_dataset("odom")
def build_odom_data(cfg, test: bool = False) -> TaskData:
    from .odom_data import OdomDataset

    card = DataCard(task="odom")
    splits = cfg.get("data", {}).get("data_splits", ["train", "val"])
    datasets = {s: OdomDataset(s, cfg, card, test=test) for s in splits}
    return TaskData(datasets=datasets, card=card)


@register_dataset("pc_transform")
def build_pc_transform_data(cfg, test: bool = False) -> TaskData:
    from .pc_data import PCTransformDataset

    card = DataCard(task="pc_transform")
    splits = cfg.get("data", {}).get("data_splits", ["val"])
    datasets = {s: PCTransformDataset(s, cfg, card, test=test) for s in splits}
    return TaskData(datasets=datasets, card=card)


@register_dataset("bg")
def build_bg_data(cfg, test: bool = False) -> TaskData:
    from .bg_data import BGDataset

    card = DataCard(task="bg")
    splits = cfg.get("data", {}).get("data_splits", ["train", "val"])
    datasets = {s: BGDataset(s, cfg, card, test=test) for s in splits}
    return TaskData(datasets=datasets, card=card)


@register_dataset("fg")
def build_fg_data(cfg, test: bool = False) -> TaskData:
    from .fg_data import FGSceneDataset, fg_scene_collate

    d = cfg.get("data", {})
    dataset_type = d.get("dataset_type", "fg_instance")
    if dataset_type != "fg_scene":
        raise NotImplementedError(f"fg dataset_type {dataset_type!r} is not "
                                  "ported yet (only fg_scene)")
    card = DataCard(task="fg")
    splits = d.get("data_splits", ["train", "val"])
    datasets = {s: FGSceneDataset(s, cfg, card, test=test) for s in splits}
    return TaskData(datasets=datasets, card=card, collate_fn=fg_scene_collate)
