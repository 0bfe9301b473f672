from .base import seeded_init_
from .bg import BGModel
from .fg import FGModel
from .hardnet import HarDNet, fold_batchnorm_
from .odom import OdomModel
from .pc_transform import PCTransformModel, pc_transform_predict

__all__ = [
    "BGModel",
    "FGModel",
    "HarDNet",
    "OdomModel",
    "PCTransformModel",
    "fold_batchnorm_",
    "pc_transform_predict",
    "seeded_init_",
]
