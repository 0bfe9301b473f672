"""detectron2 MaskRCNN mask-head weights for the fg model.

Counterpart of ``maskrcnn_head_params`` and ``load_maskrcnn_head_pickle``
of ``panoptic_forecasting_tpu/models/torch_import.py`` (reference
mask_rcnn_conv_upsample_head.py:52-61): the pickle's ``model`` dict holds
detectron2's numpy arrays; its ``roi_heads.mask_head.*`` entries are the
port's ``MaskRCNNConvUpsampleHead`` ``state_dict`` as they are (same
names, torch layouts), so nothing is transposed here.
"""

from __future__ import annotations

import pickle
from typing import Any, Dict, Mapping

import numpy as np
import torch

PREFIX = "roi_heads.mask_head."
HEAD_LAYERS = ("mask_fcn1", "mask_fcn2", "mask_fcn3", "mask_fcn4", "deconv",
               "predictor")


def maskrcnn_head_params(model_dict: Mapping[str, Any]) -> Dict[str, torch.Tensor]:
    """detectron2 ``model`` dict -> the mask head's ``state_dict``."""
    return {f"{layer}.{kind}": torch.from_numpy(
                np.array(model_dict[f"{PREFIX}{layer}.{kind}"], np.float32))
            for layer in HEAD_LAYERS for kind in ("weight", "bias")}


def load_maskrcnn_head_pickle(path: str) -> Dict[str, torch.Tensor]:
    """mask_rcnn_pretrain.pkl (detectron2's pickle of numpy arrays) -> the
    mask head's ``state_dict``."""
    with open(path, "rb") as f:
        data = pickle.load(f, encoding="latin1")
    return maskrcnn_head_params(data["model"])
