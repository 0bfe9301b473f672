"""Background (semantic forecast) dataset.

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
mask. ``resize_h``/``resize_w`` resize every array NEAREST
(``data/transforms.py::Resize``).

The train split outside test mode (JAX :108-155, 203-205):

* depth statistics (mean, std) of the decoded, clamped, valid depths of
  every 5th sample, set on the card (a test-mode dataset leaves them
  unset: mean 0, std 1, as in the JAX package). They are read from
  ``depth_norm_params_file`` when that file exists, else computed and
  written with ``np.save``, which appends ``.npy`` to a name without it:
  the configs' ``depth_norm_params.npz`` is written as
  ``depth_norm_params.npz.npy``, never found again, and recomputed on
  every run, as in the JAX package (in a distributed run process 0
  writes it; every rank computes the same statistics);
* augmentation: ``RandomScaleCrop`` (``crop_size``, ``scale_min``,
  ``scale_max``; off with ``no_resize_crop``) then
  ``RandomHorizontalFlip``, after ``Resize`` when one is configured;
  each sample draws from ``RandomState(hash((idx, epoch)) & 0x7FFFFFFF)``
  with the epoch ``set_epoch`` gave (the loader forwards it), so the
  draws do not depend on threads or processes.
"""

from __future__ import annotations

import functools
import glob
import os
from typing import Any, Dict, List, Sequence, Tuple

import numpy as np

from ..parallel.mesh import is_main_process
from . import io
from .cards import DataCard
from .transforms import RandomHorizontalFlip, RandomScaleCrop, Resize


class BGDataset:
    def __init__(self, split: str, cfg: Dict[str, Any], card: DataCard,
                 test: bool = False):
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
        train = split == "train" and not test
        if train and self.use_depths:
            self._set_depth_stats(d.get("depth_norm_params_file"), card)
        if train:
            if not d.get("no_resize_crop"):
                self.transforms.append(RandomScaleCrop(
                    d.get("crop_size", 800), scale_min=d.get("scale_min", 0.5),
                    scale_max=d.get("scale_max", 2.0), ignore_index=255))
            self.transforms.append(RandomHorizontalFlip())
        if d.get("resize_h") is not None:
            self.transforms.insert(0, Resize((int(d["resize_w"]), int(d["resize_h"]))))
        self._epoch_seed = 0

    def set_epoch(self, epoch: int) -> None:
        """The epoch in each sample's augmentation seed."""
        self._epoch_seed = int(epoch)

    def _set_depth_stats(self, stats_file, card: DataCard) -> None:
        """(mean, std) of the depths onto ``card`` (see the module doc)."""
        if stats_file and os.path.exists(stats_file):
            arr = np.load(stats_file)
            mean, std = float(arr[0]), float(arr[1])
        else:
            vals = []
            for i, (_, _, city, seq, frame, _, start_fr) in enumerate(self.samples):
                if i % 5 != 0:
                    continue
                dep = self._load_depth_block(city, seq, frame, start_fr)
                dep = dep[dep > 0]
                if dep.size:
                    vals.append(dep)
            if vals:
                allv = np.concatenate(vals)
                mean, std = float(allv.mean()), float(allv.std())
            else:
                mean, std = 0.0, 1.0
            if stats_file and is_main_process():
                os.makedirs(os.path.dirname(stats_file) or ".", exist_ok=True)
                np.save(stats_file, np.array([mean, std], np.float32))
        card.set_stats("depth", np.array([mean]), np.array([std]))

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
        rng = np.random.RandomState(hash((idx, self._epoch_seed)) & 0x7FFFFFFF)
        for tr in self.transforms:
            segs, gt, arrs = tr(segs, gt, arrs, rng)

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
