"""COCO-panoptic PNG encoding of segment ids.

Counterpart of the file-protocol part of
``panoptic_forecasting_tpu/eval/pq.py`` (:204-215): a segment id is
written as R + 256·G + 65536·B. The PQ scorer itself is not ported yet.
"""

from __future__ import annotations

import numpy as np


def decode_panoptic_png(rgb: np.ndarray) -> np.ndarray:
    """(H, W, 3) uint8 -> (H, W) int64 ids; a 2-D array is already ids."""
    if rgb.ndim == 2:
        return rgb.astype(np.int64)
    rgb = rgb.astype(np.int64)
    return rgb[..., 0] + 256 * rgb[..., 1] + 256 * 256 * rgb[..., 2]


def encode_panoptic_png(seg: np.ndarray) -> np.ndarray:
    seg = seg.astype(np.int64)
    return np.stack(
        [seg % 256, (seg // 256) % 256, (seg // 65536) % 256], axis=-1
    ).astype(np.uint8)
