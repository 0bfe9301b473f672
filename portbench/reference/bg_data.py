"""Plain bg train samples (the public bg dataset's train split,
datasets/bg_dataset.py, with the public ``RandomSizeAndCropMasks_Faster``
and horizontal flip), read from the files the benchmark wrote.

A sample is the three reprojected segs and the GT (8-bit grey PNGs) and
the (H, W, 3) raw uint16 depth block. The train split scales by
s ∈ [scale_min, scale_max), pads a window larger than the frame
(labels 255, depth 0; ``(crop·s − size) // 2 + 1`` a side), cuts it at a
random offset, resizes it NEAREST to the crop size (OpenCV's
``INTER_NEAREST`` index ``min(floor(i · src / dst), src − 1)``, the
ratio taken as ``1 / (dst / src)`` in float64) and mirrors it with
probability 1/2. The draws, in that order (s; x1 and y1 only where the
window moves; the flip), come from ``RandomState(hash((index, epoch)) &
0x7FFFFFFF)``: this is the port's own protocol (``data/bg_data.py``),
which the reference has to follow to draw the same crops. The depth
statistics are the mean and standard deviation, in float64, of the
decoded (``raw/256 − 1``), clamped, valid depths of every fifth sample.
"""

from __future__ import annotations

import glob
import os
import struct
import zlib
from typing import Dict, List, Sequence, Tuple

import numpy as np


def read_png(path: str) -> np.ndarray:
    """An 8-bit grey PNG whose rows are all unfiltered -> (H, W) uint8."""
    with open(path, "rb") as f:
        data = f.read()
    if data[:8] != b"\x89PNG\r\n\x1a\n":
        raise ValueError(f"{path}: not a PNG")
    pos, idat, size = 8, [], None
    while pos < len(data):
        (n,) = struct.unpack(">I", data[pos:pos + 4])
        tag, body = data[pos + 4:pos + 8], data[pos + 8:pos + 8 + n]
        if tag == b"IHDR":
            w, h, depth, colour = struct.unpack(">IIBB", body[:10])
            if (depth, colour) != (8, 0):
                raise ValueError(f"{path}: not 8-bit grey")
            size = (h, w)
        elif tag == b"IDAT":
            idat.append(body)
        pos += 12 + n
    rows = np.frombuffer(zlib.decompress(b"".join(idat)), np.uint8).reshape(size[0], size[1] + 1)
    if rows[:, 0].any():
        raise ValueError(f"{path}: filtered rows")
    return rows[:, 1:].copy()


def listing(gt_dir: str) -> List[Tuple[str, str, str]]:
    """(gt file, city, '<city>_<seq>_<frame>_gtFine') of every sample, in
    the split's order: cities sorted, files sorted."""
    out = []
    for city in sorted(os.listdir(gt_dir)):
        for path in sorted(glob.glob(os.path.join(gt_dir, city, "*_labelTrainIds.png"))):
            out.append((path, city, os.path.basename(path)[:-len("_labelTrainIds.png")]))
    return out


def decode_depth(raw: np.ndarray, lo: float, hi: float) -> np.ndarray:
    """Raw uint16 -> depth in metres clamped to [lo, hi], -1 invalid."""
    d = raw.astype(np.float64) / 256.0 - 1.0
    return np.where(d > 0, np.clip(d, lo, hi), -1.0)


def depth_stats(blocks: Sequence[np.ndarray], lo: float, hi: float) -> Tuple[float, float]:
    """(mean, std) of the valid depths of every fifth block."""
    vals = [d[d > 0] for d in (decode_depth(b, lo, hi) for b in blocks[::5])]
    allv = np.concatenate(vals) if vals else np.zeros(0)
    return (float(allv.mean()), float(allv.std())) if allv.size else (0.0, 1.0)


def _nearest(dst: int, src: int) -> np.ndarray:
    return np.minimum(np.floor(np.arange(dst) * (1.0 / (dst / src))).astype(np.int64), src - 1)


def augment(segs: np.ndarray, depth: np.ndarray, gt: np.ndarray, index: int, epoch: int,
            size: int, scale: Tuple[float, float]):
    """segs (T, H, W), depth (H, W, T), gt (H, W) -> the train sample:
    segs (T, size, size), depth (T, size, size), gt (size, size)."""
    rng = np.random.RandomState(hash((index, epoch)) & 0x7FFFFFFF)
    s = rng.uniform(scale[0], scale[1])
    cw = ch = int(size * s)
    h, w = gt.shape
    ph = (ch - h) // 2 + 1 if ch > h else 0
    pw = (cw - w) // 2 + 1 if cw > w else 0
    if ph or pw:
        segs = np.pad(segs, [(0, 0), (ph, ph), (pw, pw)], constant_values=255)
        gt = np.pad(gt, [(ph, ph), (pw, pw)], constant_values=255)
        depth = np.pad(depth, [(ph, ph), (pw, pw), (0, 0)], constant_values=0)
        h, w = gt.shape
    x1 = 0 if w == cw else rng.randint(0, w - cw + 1)
    y1 = 0 if h == ch else rng.randint(0, h - ch + 1)
    ys, xs = y1 + _nearest(size, ch), x1 + _nearest(size, cw)
    segs, gt = segs[:, ys][:, :, xs], gt[ys][:, xs]
    depth = depth[ys][:, xs]
    if rng.rand() < 0.5:
        segs, gt, depth = segs[:, :, ::-1], gt[:, ::-1], depth[:, ::-1]
    return (np.ascontiguousarray(segs), np.ascontiguousarray(np.moveaxis(depth, -1, 0)),
            np.ascontiguousarray(gt))


def batch(rows: Sequence[Dict], indices: Sequence[int], epoch: int, size: int,
          scale: Tuple[float, float]) -> Dict:
    """A train batch in the loader's format from in-memory samples
    (``rows[i]``: segs, depth, gt) at the split's ``indices``."""
    out = [augment(rows[i]["segs"], rows[i]["depth"], rows[i]["gt"], i, epoch, size, scale)
           for i in indices]
    return {"inputs": {"seg": np.stack([o[0] for o in out]),
                       "depth": np.stack([o[1] for o in out])},
            "labels": {"seg": np.stack([o[2] for o in out]).astype(np.int32)}}


def read_sample(data: Dict, split: str, entry: Tuple[str, str, str], depth) -> Dict:
    """One sample of the written split: its PNGs decoded and its depth
    block read from the flat file (``depth(key)``)."""
    gt_file, city, stem = entry
    segs = np.stack([read_png(os.path.join(d, split, city, stem + "_labelIds.png"))
                     for d in data["data_dir"]])
    _, seq, frame = stem.split("_")[:3]
    return {"segs": segs, "gt": read_png(gt_file), "depth": depth(f"{city}/{seq}/{frame}/0")}
