"""MaskRCNN conv-upsample head (detectron2 architecture), NCHW.

Counterpart of ``panoptic_forecasting_tpu/models/mask_head.py``
(reference ``MaskRCNNConvUpsampleHead``): 4×(3×3 conv + ReLU) → 2×2
stride-2 transposed conv + ReLU → 1×1 predictor to the 8 thing classes
at 28×28. Names follow detectron2's ``roi_heads.mask_head.*``.
"""

from __future__ import annotations

import torch
import torch.nn as nn
import torch.nn.functional as F


class MaskRCNNConvUpsampleHead(nn.Module):
    def __init__(self, in_ch: int, conv_dim: int = 256, num_classes: int = 8):
        super().__init__()
        for k in range(4):
            setattr(self, f"mask_fcn{k + 1}",
                    nn.Conv2d(in_ch if k == 0 else conv_dim, conv_dim, 3,
                              padding=1))
        self.deconv = nn.ConvTranspose2d(conv_dim, conv_dim, 2, stride=2)
        self.predictor = nn.Conv2d(conv_dim, num_classes, 1)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        """x (B, C, 14, 14) -> logits (B, num_classes, 28, 28)."""
        for k in range(4):
            x = F.relu(getattr(self, f"mask_fcn{k + 1}")(x))
        return self.predictor(F.relu(self.deconv(x)))
