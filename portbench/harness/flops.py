"""Operations and bytes of the measured work, from the configuration's
shapes: the reference networks walked on the ``meta`` device with a
counting convolution, linear and transposed convolution (2 operations a
multiply-add). Convolutions are counted dense, and the bg network's
one-hot input as dense channels, whatever a kernel skips.
"""

from __future__ import annotations

from typing import Dict

import torch
import torch.nn.functional as F

from portbench.reference.fg import FG, state_shapes as fg_shapes
from portbench.reference.hardnet import Net, state_shapes as bg_shapes

META = torch.device("meta")


class Counter:
    """Stand-ins for F.conv2d, F.linear and F.conv_transpose2d that add
    up the operations of each call."""

    def __init__(self):
        self.flops = 0
        self.first_conv = None  # the operations of the first convolution

    def conv(self, x, w, b=None, stride=1, padding=0):
        y = F.conv2d(x, w, b, stride, padding)
        n = 2 * y.numel() * w.shape[1] * w.shape[2] * w.shape[3]
        if self.first_conv is None:
            self.first_conv = n
        self.flops += n
        return y

    def linear(self, x, w, b=None):
        y = F.linear(x, w, b)
        self.flops += 2 * y.numel() * w.shape[1]
        return y

    def deconv(self, x, w, b=None, stride=1):
        y = F.conv_transpose2d(x, w, b, stride)
        self.flops += 2 * x.numel() * w.shape[1] * w.shape[2] * w.shape[3]
        return y


def _meta_state(shapes) -> Dict[str, torch.Tensor]:
    return {k: torch.empty(s, device=META) for k, s in shapes.items()}


def hardnet_forward(batch: int, in_ch: int, n_classes: int, h: int, w: int,
                    train: bool = False) -> Counter:
    c = Counter()
    net = Net(_meta_state(bg_shapes(in_ch, n_classes)), train=train, conv=c.conv)
    net(torch.empty((batch, in_ch, h, w), device=META))
    return c


def fg_forward(model_cfg: Dict, n: int, t_in: int, out_t: int) -> int:
    c = Counter()
    m = model_cfg
    ch, hw = int(m.get("mask_feat_channels", 256)), int(m.get("mask_feat_hw", 14))
    inp = {
        "trajectories": torch.empty((n, t_in, 8), device=META),
        "bbox_masks": torch.empty((n, t_in + out_t), device=META),
        "bbox_vel_masks": torch.empty((n, t_in + out_t), device=META),
        "depths": torch.empty((n, t_in, 2), device=META),
        "depth_masks": torch.empty((n, t_in, 1), device=META),
        "feats": torch.empty((n, t_in, ch, hw, hw), device=META),
        "odometry": torch.empty((n, t_in + out_t, 5), device=META),
        "output_inds": torch.zeros((n,), dtype=torch.long, device=META),
        "classes": torch.zeros((n,), dtype=torch.long, device=META),
    }
    FG(_meta_state(fg_shapes(m)), m, linear=c.linear, conv=c.conv, deconv=c.deconv)(inp, out_t)
    return c.flops


def bg_in_channels(bg_cfg: Dict) -> int:
    m, d = bg_cfg["model"], bg_cfg["data"]
    return int(m["num_inputs"]) * (int(d["num_classes"]) + int(bool(m.get("use_depth_inps"))))


def forecast(cfg: Dict, slots: int) -> int:
    """Operations of one forecast at batch 1: FCHarDNet-70 on the one-hot
    + depth stack, and the fg model over ``slots`` instances."""
    bg = cfg["bg"]
    c = hardnet_forward(1, bg_in_channels(bg), int(bg["data"]["num_classes"]),
                        cfg["height"], cfg["width"])
    return c.flops + fg_forward(cfg["fg"]["model"], slots, cfg["num_inputs"], cfg["out_t"])


def train_step(cfg: Dict, batch: int) -> int:
    """Operations of one bg training step: the forward's convolutions,
    and twice them backward (input and weight gradients) but for the
    first convolution, whose input takes no gradient."""
    size = int(cfg["data"]["crop_size"])
    c = hardnet_forward(batch, bg_in_channels(cfg), int(cfg["data"]["num_classes"]),
                        size, size, train=True)
    return 3 * c.flops - c.first_conv


def k1_bytes(frames: int, h: int, w: int) -> int:
    """K1 (the packed z-buffer's placement + corner fold): the stream of
    one (group, key) int32 pair a point read once, and one int32 canvas a
    frame written once."""
    return frames * h * w * 8 + frames * h * w * 4


def k2_bytes(frames: int, h: int, w: int, out_ch: int) -> int:
    """K2 (the one-hot stem): int32 ids and f32 depth a pixel a frame read
    once, the stride-2 stem output (f32, ``out_ch`` a pixel) written once."""
    return frames * h * w * 8 + (h // 2) * (w // 2) * out_ch * 4


def k2_flops(frames: int, h: int, w: int, out_ch: int) -> int:
    """K2's operations on ids all in range: an add a stem channel a
    one-hot tap, a multiply-add a channel a depth tap, bias and ReLU."""
    taps = frames * (3 * (h // 2) - 1) * (3 * (w // 2) - 1)
    return out_ch * taps + 2 * out_ch * taps + 2 * out_ch * (h // 2) * (w // 2)
