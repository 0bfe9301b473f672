"""Spatial transforms of segmentation samples: the test-mode resize.

Counterpart of ``Resize`` in ``panoptic_forecasting_tpu/data/transforms.py``
(:94-104; reference data/transforms.py:296-324), on numpy arrays: label
maps and the auxiliary arrays (depth) take NEAREST sampling, the index
map of OpenCV's ``INTER_NEAREST`` (source index ``floor(i · src / dst)``).
The training augmentations (``RandomScaleCrop``, ``RandomHorizontalFlip``)
are not ported yet.

A transform takes (segs, gt, arrs, rng) and returns (segs, gt, arrs):
``segs`` a list of (H, W) arrays, ``gt`` (H, W), ``arrs`` a list of
(H, W, C) arrays.
"""

from __future__ import annotations

from typing import Tuple

import numpy as np


def _resize_nearest(arr: np.ndarray, w: int, h: int) -> np.ndarray:
    """NEAREST resize of the first two axes of ``arr`` to (h, w)."""
    if arr.shape[:2] == (h, w):
        return arr
    ys = np.minimum((np.arange(h) * arr.shape[0] / h).astype(int), arr.shape[0] - 1)
    xs = np.minimum((np.arange(w) * arr.shape[1] / w).astype(int), arr.shape[1] - 1)
    return arr[np.ix_(ys, xs)]


class Resize:
    """Exact NEAREST resize to (w, h)."""

    def __init__(self, size: Tuple[int, int]):
        self.w, self.h = size

    def __call__(self, segs, gt, arrs, rng=None):
        segs = [_resize_nearest(x, self.w, self.h) for x in segs]
        gt = _resize_nearest(gt, self.w, self.h)
        arrs = [_resize_nearest(a, self.w, self.h) for a in arrs]
        return segs, gt, arrs
