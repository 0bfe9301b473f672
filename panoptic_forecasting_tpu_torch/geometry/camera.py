"""Camera frames (host-side numpy, float64).

Counterpart of ``panoptic_forecasting_tpu/geometry/camera.py``: the
FLU <-> RDF frame changes (reference ``data_utils.py:100-114``) and the
Cityscapes ``camera.json`` parsing into the intrinsics and the
vehicle <- camera extrinsics (``data_utils.py:52-78, 170-203``).

Frames:
  RDF — camera optical frame: x-right, y-down, z-forward (OpenCV).
  FLU — vehicle frame: x-front, y-left, z-up.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np


class Intrinsics(NamedTuple):
    """Pinhole intrinsics (fx, fy, u0, v0); all floats."""

    fx: float
    fy: float
    u0: float
    v0: float


def intrinsics_from_cityscapes_camera(camera: dict) -> Intrinsics:
    """Parse a Cityscapes ``camera.json`` dict. Ref: data_utils.py:52-71."""
    k = camera["intrinsic"]
    fx, fy, u0, v0 = float(k["fx"]), float(k["fy"]), float(k["u0"]), float(k["v0"])
    if fx <= 0.0 or fy <= 0.0:
        raise ValueError(f"non-positive focal length in camera intrinsics: {k}")
    return Intrinsics(fx, fy, u0, v0)


def intrinsics_matrix(intr) -> np.ndarray:
    """[fx, fy, u0, v0] -> 3x3 K. Ref: data_utils.build_intrinsics_mat:207."""
    fx, fy, u0, v0 = (float(x) for x in tuple(intr))
    return np.array(
        [[fx, 0.0, u0], [0.0, fy, v0], [0.0, 0.0, 1.0]], dtype=np.float64
    )


def _affine(R=None, t=None) -> np.ndarray:
    T = np.eye(4, dtype=np.float64)
    if R is not None:
        T[:3, :3] = R
    if t is not None:
        T[:3, 3] = t
    return T


def rdf_T_flu() -> np.ndarray:
    """FLU point -> RDF coords (same origin)."""
    return _affine(R=np.array([[0, -1, 0], [0, 0, -1], [1, 0, 0]], dtype=np.float64))


def flu_T_rdf() -> np.ndarray:
    """RDF point -> FLU coords (same origin). Ref: data_utils.py:109-114."""
    return _affine(R=np.array([[0, 0, 1], [-1, 0, 0], [0, -1, 0]], dtype=np.float64))


def _vehicle_T_camera_flu(camera: dict) -> np.ndarray:
    """FLU-camera -> vehicle transform from yaw/pitch/roll + xyz, ZYX
    Euler as in the Cityscapes calibration doc (data_utils.py:170-203)."""
    e = camera["extrinsic"]
    sy, cy = np.sin(e["yaw"]), np.cos(e["yaw"])
    sp, cp = np.sin(e["pitch"]), np.cos(e["pitch"])
    sr, cr = np.sin(e["roll"]), np.cos(e["roll"])
    R = np.array(
        [
            [cy * cp, cy * sp * sr - sy * cr, cy * sp * cr + sy * sr],
            [sy * cp, sy * sp * sr + cy * cr, sy * sp * cr - cy * sr],
            [-sp, cp * sr, cp * cr],
        ],
        dtype=np.float64,
    )
    t = np.array([e["x"], e["y"], e["z"]], dtype=np.float64)
    return _affine(R=R, t=t)


def extrinsics_from_cityscapes_camera(camera: dict) -> np.ndarray:
    """vehicle_T_camera for an RDF camera. Ref: data_utils.py:74-78."""
    return _vehicle_T_camera_flu(camera) @ flu_T_rdf()
