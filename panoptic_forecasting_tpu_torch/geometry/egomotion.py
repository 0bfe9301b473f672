"""Unicycle ego-motion model on torch tensors.

Counterpart of ``panoptic_forecasting_tpu/geometry/egomotion.py``
(reference ``data_utils.get_vehicle_now_T_prev``, data_utils.py:117-165):
planar constant-twist motion, composed in closed form (rigid inverse
Rᵀ, −Rᵀt) with the straight-line branch selected elementwise; and the
host-side numpy scalar twins the datasets build their transforms with.
"""

from __future__ import annotations

import numpy as np
import torch

# Reference threshold for "driving straight" (~0.01 deg): data_utils.py:137.
_ANGLE_EPS = 0.000175


def unicycle_pose_delta(speed, yaw_rate, delta_t):
    """(x, y, theta) of the vehicle now in the previous vehicle frame."""
    speed = torch.as_tensor(speed, dtype=torch.float32)
    yaw_rate = torch.as_tensor(yaw_rate, dtype=torch.float32)
    delta_t = torch.as_tensor(delta_t, dtype=torch.float32)
    straight = yaw_rate.abs() < _ANGLE_EPS
    w = torch.where(straight, torch.ones_like(yaw_rate), yaw_rate)
    r = speed / w
    wt = yaw_rate * delta_t
    zero = torch.zeros_like(wt)
    x = torch.where(straight, delta_t * speed, r * torch.sin(wt))
    y = torch.where(straight, zero, r * (1.0 - torch.cos(wt)))
    theta = torch.where(straight, zero, wt)
    return x, y, theta


def unicycle_now_T_prev(speed, yaw_rate, delta_t) -> torch.Tensor:
    """SE(3) mapping previous-frame points into the current vehicle frame.

    Broadcasts over leading dims: scalars give (4, 4), (N,) give (N, 4, 4).
    """
    x, y, theta = unicycle_pose_delta(speed, yaw_rate, delta_t)
    x, y, theta = torch.broadcast_tensors(x, y, theta)
    c, s = torch.cos(theta), torch.sin(theta)
    zero = torch.zeros_like(c)
    one = torch.ones_like(c)
    tx = -(c * x + s * y)
    ty = -(-s * x + c * y)
    rows = [
        torch.stack([c, s, zero, tx], -1),
        torch.stack([-s, c, zero, ty], -1),
        torch.stack([zero, zero, one, zero], -1),
        torch.stack([zero, zero, zero, one], -1),
    ]
    return torch.stack(rows, -2)


# Host-side (numpy, float64) scalar twins for the dataset code.


def unicycle_pose_delta_np(speed: float, yaw_rate: float, dt: float):
    """(dx, dy, dθ) of the vehicle over dt."""
    if abs(yaw_rate) < _ANGLE_EPS:
        return dt * speed, 0.0, 0.0
    r = speed / yaw_rate
    wt = yaw_rate * dt
    return r * np.sin(wt), r * (1 - np.cos(wt)), wt


def unicycle_now_T_prev_np(speed: float, yaw_rate: float, dt: float) -> np.ndarray:
    """4x4 now_T_prev (float64) of one step."""
    x, y, th = unicycle_pose_delta_np(speed, yaw_rate, dt)
    c, s = np.cos(th), np.sin(th)
    T = np.eye(4)
    T[:2, :2] = [[c, s], [-s, c]]
    T[0, 3] = -(c * x + s * y)
    T[1, 3] = -(-s * x + c * y)
    return T
