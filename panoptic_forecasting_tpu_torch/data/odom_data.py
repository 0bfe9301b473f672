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

``load_imgs`` adds each sample's input-frame video images
(``{cityscapes_dir}/leftImg8bit_sequence``, odom_dataset.py:130-148) as
``inputs.imgs``, (input_len, h, w, 3) float32 in [0, 1], the short-history
samples repeat-padded at the front; ``min_img_len`` resizes them so the
short side has that length, bilinearly by OpenCV's ``INTER_LINEAR`` rule
(the JAX package resizes with cv2; the port has no cv2). No model reads
them: the odometry model ignores ``imgs``, as JAX's does.
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
        self.input_len = int(d.get("input_len", 9))
        self.output_len = int(d.get("output_len", 9))
        self.seq_len = self.input_len + self.output_len
        self.split = split
        self.test = test
        self.load_imgs = bool(d.get("load_imgs"))
        if self.load_imgs and not d.get("cityscapes_dir"):
            raise ValueError(
                "data.load_imgs requires data.cityscapes_dir (the"
                " leftImg8bit_sequence root) to be configured"
            )
        self.min_img_len = d.get("min_img_len")
        self.cityscapes_dir = d.get("cityscapes_dir")

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
        result = {
            "inputs": {"odometry": inp.astype(np.float32)},
            "labels": {"odometry": out.astype(np.float32)},
            "meta": {
                "city": rec["city"],
                "seq": rec["seq"],
                "frame": int(rec["frame"]),
                "start_frame": start_frame,
            },
        }
        if self.load_imgs:
            result["inputs"]["imgs"] = self._load_imgs(rec, start, inds)
        return result

    def _load_imgs(self, rec, start: int, inds: np.ndarray) -> np.ndarray:
        """The input frames' video images, a short-history sample's
        repeat-padded at the front (odom_dataset.py:130-148)."""
        img_inds = inds[: self.input_len + min(start, 0)]
        city, seq, frame = rec["city"], rec["seq"], int(rec["frame"])
        imgs = []
        for ind in img_inds:
            fr = frame - 19 + int(ind)
            img = io.load_png(os.path.join(
                self.cityscapes_dir, "leftImg8bit_sequence", self.split, city,
                f"{city}_{seq}_{fr:06d}_leftImg8bit.png")).astype(np.float32) / 255.0
            if self.min_img_len:
                img = resize_short_side(img, int(self.min_img_len))
            imgs.append(img)
        if start < 0:
            imgs = [imgs[0]] * (-start) + imgs
        return np.stack(imgs)


def resize_short_side(img: np.ndarray, min_len: int) -> np.ndarray:
    """Bilinear resize of an (H, W[, C]) float32 image so its short side
    is ``min_len``, the long side ``round`` of its scaled length (the JAX
    package's torchvision ``Resize(int)`` size rule)."""
    h, w = img.shape[:2]
    if h <= w:
        nh, nw = min_len, max(1, round(w * min_len / h))
    else:
        nh, nw = max(1, round(h * min_len / w)), min_len
    if (nh, nw) == (h, w):
        return img
    return resize_linear(img, nh, nw)


def _linear_taps(src: int, dst: int):
    """OpenCV's ``INTER_LINEAR`` taps along one axis: the source of
    ``dst`` index ``i`` is ``(i + 0.5)·scale − 0.5`` in float64, a
    negative source clamped to 0 and one at or past the last index
    clamped to it, each then with weight 0 on its neighbour; the weights
    ``1 − frac`` and ``frac`` rounded to float32. -> (index, next index,
    weight, next weight)."""
    scale = 1.0 / (dst / src)
    pos = (np.arange(dst) + 0.5) * scale - 0.5
    i0 = np.floor(pos).astype(np.int64)
    frac = pos - i0
    edge = (i0 < 0) | (i0 >= src - 1)
    frac[edge] = 0
    i0 = np.clip(i0, 0, src - 1)
    return (i0, np.minimum(i0 + 1, src - 1), (1 - frac).astype(np.float32),
            frac.astype(np.float32))


def resize_linear(img: np.ndarray, dh: int, dw: int) -> np.ndarray:
    """``cv2.resize(img, (dw, dh), interpolation=cv2.INTER_LINEAR)`` of a
    float32 (H, W[, C]) image, in numpy and float32: each row along x
    first, then the rows along y, as OpenCV does."""
    h, w = img.shape[:2]
    x0, x1, ax0, ax1 = _linear_taps(w, dw)
    y0, y1, ay0, ay1 = _linear_taps(h, dh)
    ax = (None, slice(None)) + (None,) * (img.ndim - 2)

    def along_x(rows):
        return rows[:, x0] * ax0[ax] + rows[:, x1] * ax1[ax]

    ay = (slice(None),) + (None,) * (img.ndim - 1)
    return (along_x(img[y0]) * ay0[ay] + along_x(img[y1]) * ay1[ay]).astype(np.float32)
