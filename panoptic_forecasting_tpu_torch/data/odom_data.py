"""Odometry dataset: (speed, yaw_rate) forecast windows.

Counterpart of ``panoptic_forecasting_tpu/data/odom_data.py`` (reference
``OdomDataset``, datasets/odom_dataset.py:20-171): windows over
per-snippet 30-frame odometry from ``{split}_3d_info.pkl`` (columns
city/seq/frame/odometry (30, 5)) or the ORB-SLAM variant
``orbslam_odom_{split}.pkl`` (speed/yaw_rate columns), both read through
``io.read_table``; ``input_len``-in/``output_len``-out windows over
every start offset (clipped at frame 29), plus two short-history samples
per snippet whose input is left-padded by repeating the first frame; the
train split sets the normalisation statistics on the card.

``load_imgs`` (per-input-frame video images) is set by no shipped config
and raises ``NotImplementedError``.
"""

from __future__ import annotations

import os
from typing import Any, Dict, List, Tuple

import numpy as np

from . import io
from .cards import DataCard


class OdomDataset:
    def __init__(self, split: str, cfg: Dict[str, Any], card: DataCard,
                 test: bool = False):
        d = cfg.get("data", {})
        if d.get("load_imgs"):
            raise NotImplementedError("odom data.load_imgs is not ported")
        self.input_len = int(d.get("input_len", 9))
        self.output_len = int(d.get("output_len", 9))
        self.seq_len = self.input_len + self.output_len
        self.split = split
        self.test = test

        data_dir = d["data_dir"]
        if d.get("use_orbslam_odom"):
            rows = io.read_table(os.path.join(data_dir, f"orbslam_odom_{split}.pkl"))
            odom = np.stack(
                [np.stack([r["speed"] for r in rows]),
                 np.stack([r["yaw_rate"] for r in rows])],
                axis=-1,
            ).astype(np.float32)  # (N, 30, 2)
        else:
            rows = io.read_table(os.path.join(data_dir, f"{split}_3d_info.pkl"))
            odom = np.stack([r["odometry"] for r in rows]).astype(np.float32)[..., :2]
        self.rows = rows
        self.odom = odom  # (N, 30, 2)

        if split == "train":
            flat = odom.reshape(-1, 2)
            card.set_stats("odom", flat.mean(0), flat.std(0))

        # Window index: (row, start_ind, frame indices). start_ind < 0 marks
        # the repeat-padded short-history samples.
        self.index: List[Tuple[int, int, np.ndarray]] = []
        base = np.arange(self.seq_len)
        fr_range = range(30 - (self.input_len if test else self.seq_len) + 1)
        for row in range(len(odom)):
            for start in fr_range:
                self.index.append((row, start, np.clip(start + base, None, 29)))
            self.index.append((row, -1, base[:-1]))
            self.index.append((row, -2, base[:-2]))

    def __len__(self) -> int:
        return len(self.index)

    def __getitem__(self, i: int) -> Dict[str, Any]:
        row, start, inds = self.index[i]
        odom = self.odom[row][inds]
        if start < 0:
            pad = np.repeat(odom[0:1], -start, axis=0)
            inp = np.concatenate([pad, odom[: self.input_len + start]], axis=0)
            out = odom[-self.output_len :]
            start_frame = int(inds[self.input_len - 1 + start])
        else:
            inp = odom[: self.input_len]
            out = odom[self.input_len :]
            start_frame = int(inds[self.input_len - 1])
        rec = self.rows[row]
        return {
            "inputs": {"odometry": inp.astype(np.float32)},
            "labels": {"odometry": out.astype(np.float32)},
            "meta": {
                "city": rec["city"],
                "seq": rec["seq"],
                "frame": int(rec["frame"]),
                "start_frame": start_frame,
            },
        }
