"""Unicycle ego-motion model on torch tensors.

Counterpart of ``panoptic_forecasting_tpu/geometry/egomotion.py``
(reference ``data_utils.get_vehicle_now_T_prev``, data_utils.py:117-165):
planar constant-twist motion, composed in closed form (rigid inverse
Rᵀ, −Rᵀt) with the straight-line branch selected elementwise.
"""

from __future__ import annotations

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
