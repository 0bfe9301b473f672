"""Joint spatial transforms of segmentation samples.

Counterpart of ``panoptic_forecasting_tpu/data/transforms.py`` (reference
data/transforms.py): ``RandomScaleCrop`` (:43-80; reference
``RandomSizeAndCropMasks_Faster``, :169-274), ``RandomHorizontalFlip``
(:83-89; reference :276-293) and ``Resize`` (:94-104; reference
:296-324), on numpy arrays. Label maps and the auxiliary arrays (depth)
take NEAREST sampling.

The JAX package resizes with OpenCV's ``INTER_NEAREST`` where OpenCV
imports, and its own numpy fallback is not OpenCV's rule (the fallback
computes ``i · src / dst``, which rounds otherwise for some sizes, e.g.
1688 -> 128 at columns 16, 32 and 48). The port has no OpenCV and
computes OpenCV's index map: ``min(floor(i · (1 / (dst / src))), src -
1)`` in float64, per axis.

A transform takes (segs, gt, arrs, rng) and returns (segs, gt, arrs):
``segs`` a list of (H, W) arrays, ``gt`` (H, W), ``arrs`` a list of
(H, W, C) arrays; ``rng`` is the sample's ``np.random.RandomState``.
"""

from __future__ import annotations

from typing import Tuple

import numpy as np


def _nearest_index(dst: int, src: int) -> np.ndarray:
    """OpenCV ``INTER_NEAREST``'s source index of each of ``dst`` outputs."""
    inv = 1.0 / (dst / src)
    return np.minimum(np.floor(np.arange(dst) * inv).astype(np.int64), src - 1)


def _resize_nearest(arr: np.ndarray, w: int, h: int) -> np.ndarray:
    """NEAREST resize of the first two axes of ``arr`` to (h, w); a
    (H, W, 1) array stays 3-D."""
    if arr.shape[:2] == (h, w):
        return arr
    ys = _nearest_index(h, arr.shape[0])
    xs = _nearest_index(w, arr.shape[1])
    return arr[np.ix_(ys, xs)]


class RandomScaleCrop:
    """Scale-jittered random crop: s ∈ [scale_min, scale_max), a (crop·s)
    window (the image padded with ``ignore_index`` for labels and 0 for
    the arrays when the window is larger), resized NEAREST back to the
    crop size. The draws: s, then x1, then y1, each only when needed."""

    def __init__(self, size, scale_min=0.5, scale_max=2.0, ignore_index=255):
        self.size = (int(size), int(size)) if np.isscalar(size) else tuple(size)
        self.scale_min = scale_min
        self.scale_max = scale_max
        self.ignore_index = ignore_index

    def __call__(self, segs, gt, arrs, rng: np.random.RandomState):
        s = rng.uniform(self.scale_min, self.scale_max)
        crop_w = int(self.size[0] * s)
        crop_h = int(self.size[1] * s)
        h, w = segs[0].shape[:2]
        pad_h = (crop_h - h) // 2 + 1 if crop_h > h else 0
        pad_w = (crop_w - w) // 2 + 1 if crop_w > w else 0
        if pad_h or pad_w:
            pw = [(pad_h, pad_h), (pad_w, pad_w)]
            segs = [np.pad(x, pw, constant_values=self.ignore_index) for x in segs]
            gt = np.pad(gt, pw, constant_values=self.ignore_index)
            arrs = [np.pad(a, pw + [(0, 0)] * (a.ndim - 2), constant_values=0)
                    for a in arrs]
            h, w = segs[0].shape[:2]
        x1 = 0 if w == crop_w else rng.randint(0, w - crop_w + 1)
        y1 = 0 if h == crop_h else rng.randint(0, h - crop_h + 1)
        segs = [x[y1: y1 + crop_h, x1: x1 + crop_w] for x in segs]
        gt = gt[y1: y1 + crop_h, x1: x1 + crop_w]
        arrs = [a[y1: y1 + crop_h, x1: x1 + crop_w] for a in arrs]
        tw, th = self.size
        segs = [_resize_nearest(x, tw, th) for x in segs]
        gt = _resize_nearest(gt, tw, th)
        arrs = [_resize_nearest(a, tw, th) for a in arrs]
        return segs, gt, arrs


class RandomHorizontalFlip:
    """Mirror every array left-right with probability 1/2 (one draw)."""

    def __call__(self, segs, gt, arrs, rng: np.random.RandomState):
        if rng.rand() < 0.5:
            segs = [np.ascontiguousarray(np.fliplr(x)) for x in segs]
            gt = np.ascontiguousarray(np.fliplr(gt))
            arrs = [np.ascontiguousarray(np.fliplr(a)) for a in arrs]
        return segs, gt, arrs


class Resize:
    """Exact NEAREST resize to (w, h)."""

    def __init__(self, size: Tuple[int, int]):
        self.w, self.h = size

    def __call__(self, segs, gt, arrs, rng=None):
        segs = [_resize_nearest(x, self.w, self.h) for x in segs]
        gt = _resize_nearest(gt, self.w, self.h)
        arrs = [_resize_nearest(a, self.w, self.h) for a in arrs]
        return segs, gt, arrs
