"""Camera frames (host-side numpy, float64).

Counterpart of ``panoptic_forecasting_tpu/geometry/camera.py``: the
FLU -> RDF frame change the forecast's extrinsics are built with
(reference ``data_utils.py:100-105``).

Frames:
  RDF — camera optical frame: x-right, y-down, z-forward (OpenCV).
  FLU — vehicle frame: x-front, y-left, z-up.
"""

from __future__ import annotations

import numpy as np


def rdf_T_flu() -> np.ndarray:
    """FLU point -> RDF coords (same origin)."""
    T = np.eye(4, dtype=np.float64)
    T[:3, :3] = [[0, -1, 0], [0, 0, -1], [1, 0, 0]]
    return T
