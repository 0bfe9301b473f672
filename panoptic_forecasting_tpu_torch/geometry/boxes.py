"""Bounding-box format conversion on torch tensors.

Counterpart of ``panoptic_forecasting_tpu/geometry/boxes.py``
(reference ``data_utils.convert_bbox_ulbr_cwh`` /
``convert_bbox_cwh_ulbr``, data_utils.py:19-49): the forecast converts
torch tensors, the fg datasets numpy arrays, the fg metrics under
``use_bbox_ulbr`` torch tensors.
"""

from __future__ import annotations

import numpy as np
import torch


def bbox_cwh_to_ulbr(boxes: torch.Tensor) -> torch.Tensor:
    """(cx, cy, w, h) -> (x0, y0, x1, y1) along the last axis."""
    cx, cy, w, h = boxes.unbind(-1)
    return torch.stack([cx - w / 2, cy - h / 2, cx + w / 2, cy + h / 2], -1)


def bbox_ulbr_to_cwh(boxes):
    """(x0, y0, x1, y1) -> (cx, cy, w, h) along the last axis (a numpy
    array or a torch tensor)."""
    x0, y0, x1, y1 = boxes[..., 0], boxes[..., 1], boxes[..., 2], boxes[..., 3]
    stack = torch.stack if isinstance(boxes, torch.Tensor) else np.stack
    return stack([(x0 + x1) / 2, (y0 + y1) / 2, x1 - x0, y1 - y0], -1)
