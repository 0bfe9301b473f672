"""Model registry wiring (reference: models/__init__.py:16-41).

Counterpart of ``panoptic_forecasting_tpu/models/factory.py``. Each
registered function reads what the JAX model reads from the data card:
the odometry statistics, the bg class count and depth statistics, the fg
trajectory/depth/odometry statistics (absent statistics default to mean
0, std 1, as in JAX).
"""

from __future__ import annotations

from ..core.registry import register_model
from .bg import BGModel
from .fg import FGModel
from .odom import OdomModel
from .pc_transform import PCTransformModel


def card_stats(card, names):
    """{name: (mean, std)} of the statistics ``card`` holds among ``names``."""
    stats = getattr(card, "stats", {}) if card is not None else {}
    return {n: (card.mean(n), card.std(n)) for n in names if n in stats}


@register_model("odom")
def build_odom_model(cfg, data_card=None, device=None):
    return OdomModel(cfg, stats=card_stats(data_card, ("odom",)).get("odom"),
                     device=device)


@register_model("pc_transform")
def build_pc_transform_model(cfg, data_card=None, device=None):
    return PCTransformModel(cfg, device=device)


@register_model("bg")
def build_bg_model(cfg, data_card=None, device=None):
    data = dict(cfg.get("data", {}))
    if data_card is not None and data_card.num_classes:
        data["num_classes"] = data_card.num_classes
    depth = card_stats(data_card, ("depth",)).get("depth")
    depth_stats = (float(depth[0][0]), float(depth[1][0])) if depth else None
    return BGModel(dict(cfg, data=data), depth_stats=depth_stats, device=device)


@register_model("fg")
def build_fg_model(cfg, data_card=None, device=None):
    return FGModel(cfg, stats=card_stats(data_card, ("traj", "depth", "odom")),
                   device=device)
