"""Pretrained weights in the reference's files.

Counterpart of ``panoptic_forecasting_tpu/models/torch_import.py``:

* ``load_hardnet_pickle`` (JAX :146-196; reference hardnet.py:390-404):
  the FCHarDNet-70 Cityscapes file, ``torch.load(path)['model_state']``
  (or the whole file when it has no such key) with its ``module.``
  prefixes stripped. Its names are the port's ``HarDNet`` ``state_dict``
  names (the port keeps the reference's module tree), so nothing is
  renamed or transposed here.
* ``maskrcnn_head_params`` and ``load_maskrcnn_head_pickle`` (reference
  mask_rcnn_conv_upsample_head.py:52-61): the pickle's ``model`` dict
  holds detectron2's numpy arrays; its ``roi_heads.mask_head.*`` entries
  are the port's ``MaskRCNNConvUpsampleHead`` ``state_dict`` as they are.
"""

from __future__ import annotations

import pickle
from typing import Any, Dict, Mapping

import numpy as np
import torch

PREFIX = "roi_heads.mask_head."
HEAD_LAYERS = ("mask_fcn1", "mask_fcn2", "mask_fcn3", "mask_fcn4", "deconv",
               "predictor")


def load_hardnet_pickle(path: str) -> Dict[str, torch.Tensor]:
    """hardnet70_cityscapes_model.pkl -> the reference FCHarDNet's
    ``state_dict`` (``base.*``, ``conv1x1_up.*``, ``denseBlocksUp.*``,
    ``finalConv.*``), tensors on the CPU."""
    sd = torch.load(path, map_location="cpu", weights_only=False)
    if isinstance(sd, dict) and "model_state" in sd:
        sd = sd["model_state"]
    if any(k.startswith("module.") for k in sd):
        sd = {k[len("module."):]: v for k, v in sd.items() if k.startswith("module.")}
    return {k: torch.as_tensor(v).detach().cpu() for k, v in sd.items()}


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
