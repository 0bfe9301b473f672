"""Per-task dataset bundles (registry targets).

Counterpart of ``panoptic_forecasting_tpu/data/pipelines.py`` (reference
``data/__init__.py:14-31``): each builder returns a ``TaskData`` bundle of
split datasets and the DataCard handed to the model builder. Ported
tasks: ``odom``, ``pc_transform``, ``bg`` (``bg_data.py``: the train
split's depth statistics go on the card) and ``fg`` (``dataset_type`` ``fg_instance``, the training tracks, or
``fg_scene``).
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

    def loader(self, split: str, cfg: Dict[str, Any], test: bool = False,
               seed: int = 0, shard: bool = False) -> Loader:
        """The train split outside ``test``: shuffled batches of
        ``training.batch_size``, the last short one dropped, ``sample_weights``
        (top-level) drawn with replacement, and with
        ``training.steps_per_epoch`` that many × ``accumulate_steps``
        batches an epoch (JAX data/pipelines.py:55-69). Otherwise batches
        in order of ``training.val_batch_size`` or ``batch_size``.
        ``training.num_data_threads`` (default min(8, cores)) threads fetch
        each batch's samples and ``training.prefetch_batches`` (default 2
        with threads) batches are prepared ahead. ``shard``: each rank
        fetches only its rows of a global batch (the trainer's loaders)."""
        t = cfg.get("training", {})
        bs = int(t.get("batch_size", 32))
        threads = int(t.get("num_data_threads", min(8, os.cpu_count() or 1)))
        prefetch = int(t.get("prefetch_batches", 2 if threads else 0))
        kw = dict(collate_fn=self.collate_fn, seed=seed, prefetch=prefetch,
                  num_threads=threads, shard=shard)
        if split != "train" or test:
            return Loader(self.datasets[split], int(t.get("val_batch_size") or bs),
                          **kw)
        steps = t.get("steps_per_epoch")
        accum = int(t.get("accumulate_steps", 1))
        return Loader(self.datasets[split], bs, shuffle=True, drop_last=True,
                      steps_per_epoch=int(steps) * accum if steps else None,
                      weights=cfg.get("sample_weights"), **kw)


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
    from .fg_data import FGInstanceDataset, FGSceneDataset, fg_scene_collate

    card = DataCard(task="fg")
    d = cfg.get("data", {})
    dataset_type = d.get("dataset_type", "fg_instance")
    splits = d.get("data_splits", ["train", "val"])
    if dataset_type == "fg_scene":
        cls, collate = FGSceneDataset, fg_scene_collate
    else:
        cls, collate = FGInstanceDataset, default_collate
    datasets = {s: cls(s, cfg, card, test=test) for s in splits}
    return TaskData(datasets=datasets, card=card, collate_fn=collate)
