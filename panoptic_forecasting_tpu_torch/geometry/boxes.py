"""Bounding-box format conversion on torch tensors.

Counterpart of ``panoptic_forecasting_tpu/geometry/boxes.py``
(reference ``data_utils.convert_bbox_cwh_ulbr``).
"""

from __future__ import annotations

import torch


def bbox_cwh_to_ulbr(boxes: torch.Tensor) -> torch.Tensor:
    """(cx, cy, w, h) -> (x0, y0, x1, y1) along the last axis."""
    cx, cy, w, h = boxes.unbind(-1)
    return torch.stack([cx - w / 2, cy - h / 2, cx + w / 2, cy + h / 2], -1)
