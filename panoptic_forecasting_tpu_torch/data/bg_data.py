"""Background (semantic forecast) dataset, test mode.

Counterpart of ``panoptic_forecasting_tpu/data/bg_data.py`` (reference
``BGDataset``, datasets/bg_dataset.py:25-232). One sample = the 3
reprojected segmentations of a target frame (trainId content under
labelIds names, written by ``cli/prepare_bg_data.py``: PNG, or ``.npy``
when the first sample's file is one), the (H, W, 3) raw uint16 depth
block of ``depth_h5_path % split`` keyed ``city/seq/frame:06d/start_fr``
(read through ``io.open_h5``), and the fg-removed GT
``gt_dir/{split}/{city}/*_labelTrainIds.png`` that lists the samples.
Several ``(data_dir triplet, gap_len)`` groups give one sample each per
GT frame; ``start_fr = int((9 - gap) / 3)``. The class count is 11 stuff
classes with ``only_background`` and 19 otherwise (bg_dataset.py:61-65).

Depth ships raw by default and ``models/bg.py::_prep_inputs`` decodes it
on the device (``d/256 - 1``, 0 invalid, clamped to [min_depth,
max_depth]); ``host_depth_decode`` decodes it here instead and adds the
mask. Depth statistics are set on the card only for the train split
outside test mode, so a test-mode dataset leaves them unset (mean 0,
std 1), as in the JAX package. ``resize_h``/``resize_w`` resize every
array NEAREST (``data/transforms.py::Resize``).

The training split outside test mode (its depth statistics, random
scale crop and flip) is not ported yet and raises
``NotImplementedError``.
"""

from __future__ import annotations

import functools
import glob
import os
from typing import Any, Dict, List, Sequence, Tuple

import numpy as np

from . import io
from .cards import DataCard
from .transforms import Resize


class BGDataset:
    def __init__(self, split: str, cfg: Dict[str, Any], card: DataCard,
                 test: bool = False):
        if split == "train" and not test:
            raise NotImplementedError("the bg training data is not ported yet")
        d = cfg.get("data", {})
        self.split = split
        self.test = test
        self.only_background = bool(d.get("only_background"))
        self.num_classes = 11 if self.only_background else 19
        card.num_classes = self.num_classes
        self.data_inp_size = int(d.get("data_inp_size", 3))
        data_dir = d["data_dir"]
        if isinstance(data_dir, list):
            dirs = [os.path.join(x, split) for x in data_dir]
            self.data_dirs = [dirs[i : i + self.data_inp_size]
                              for i in range(0, len(dirs), self.data_inp_size)]
        else:
            self.data_dirs = [[os.path.join(data_dir, split)] * self.data_inp_size]
        self.gt_dir = os.path.join(d["gt_dir"], split)
        self.gap_len: Sequence[int] = d.get("gap_len", [9])
        if np.isscalar(self.gap_len):
            self.gap_len = [int(self.gap_len)]
        self.use_depths = bool(d.get("use_depths"))
        self.min_depth = d.get("min_depth", 0.1)
        self.max_depth = d.get("max_depth", 200.0)
        self.host_depth_decode = bool(d.get("host_depth_decode"))
        self.depth_h5 = (io.open_h5(d["depth_h5_path"] % split)
                         if self.use_depths else None)
        self.transforms = []
        if d.get("resize_h") is not None:
            self.transforms.append(Resize((int(d["resize_w"]), int(d["resize_h"]))))

    @functools.cached_property
    def samples(self) -> List[Tuple[str, List[str], str, str, int, int, int]]:
        """(gt file, seg files, city, seq, frame, 19, start_fr) per sample.
        Listed on first use, not at construction (the JAX package lists
        them there): a server builds the dataset for its card alone and
        need not hold the bg data."""
        samples = []
        for city in sorted(os.listdir(self.gt_dir)):
            for gt_file in sorted(glob.glob(
                    os.path.join(self.gt_dir, city, "*_labelTrainIds.png"))):
                c, seq, frame = os.path.basename(gt_file).split("_")[:3]
                frame = int(frame)
                seg_name = f"{c}_{seq}_{frame:06d}_gtFine_labelIds.png"
                for dirs, gap in zip(self.data_dirs, self.gap_len):
                    start_fr = int((9 - gap) / 3)
                    files = [os.path.join(x, c, seg_name) for x in dirs]
                    samples.append((gt_file, files, c, seq, frame, 19, start_fr))
        # prepare_bg_data's raw .npy seg format, detected by the first
        # sample (a tree never mixes formats)
        first = samples[0][1][0] if samples else None
        if first and not os.path.exists(first) and os.path.exists(first[:-4] + ".npy"):
            samples = [(gt, [f[:-4] + ".npy" for f in files], c, s, fr, t, sf)
                       for gt, files, c, s, fr, t, sf in samples]
        return samples

    @property
    def seg_npy(self) -> bool:
        """The seg maps are ``.npy`` files (``bg_out_format: npy``)."""
        return bool(self.samples) and self.samples[0][1][0].endswith(".npy")

    def _raw_depth_block(self, city, seq, frame, start_fr) -> np.ndarray:
        """(H, W, T) raw uint16 block."""
        key = f"{city}/{seq}/{frame:06d}/{start_fr}"
        return np.asarray(self.depth_h5.mmap_dataset(key)[:])

    def _load_depth_block(self, city, seq, frame, start_fr) -> np.ndarray:
        """(H, W, T) decoded, clamped depths (-1 invalid)."""
        dep = self._raw_depth_block(city, seq, frame, start_fr).astype(np.float32)
        dep = dep / 256.0 - 1.0
        return np.where(dep > 0, np.clip(dep, self.min_depth, self.max_depth), -1.0)

    def __len__(self) -> int:
        return len(self.samples)

    def __getitem__(self, idx: int) -> Dict[str, Any]:
        gt_file, files, city, seq, frame, fr, start_fr = self.samples[idx]
        gt = io.load_png(gt_file)
        if self.seg_npy:
            segs = [np.load(f, mmap_mode="r") for f in files]
        else:
            segs = list(io.load_png_batch(files))
        arrs = []
        if self.use_depths:
            load = self._load_depth_block if self.host_depth_decode else self._raw_depth_block
            arrs.append(load(city, seq, frame, start_fr))
        for tr in self.transforms:
            segs, gt, arrs = tr(segs, gt, arrs)

        out: Dict[str, Any] = {
            "inputs": {"seg": np.ascontiguousarray(np.stack(segs))},
            "labels": {"seg": gt.astype(np.int32)},
            "meta": {"city": city, "seq": seq, "frame": frame,
                     "start_frame": start_fr, "target_frame": frame - 19 + fr},
        }
        if self.use_depths:
            dep = np.moveaxis(arrs[0], -1, 0)  # (T, H, W)
            if self.host_depth_decode:
                dep = dep.astype(np.float32)
                out["inputs"]["depth"] = dep
                out["inputs"]["depth_mask"] = dep > 0
            else:  # raw uint16, decoded on the device
                out["inputs"]["depth"] = np.ascontiguousarray(dep)
        return out
