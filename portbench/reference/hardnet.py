"""Plain FCHarDNet-70 over a state dict: the published network (Chao et
al., "HarDNet: A Low Memory Traffic Network", ICCV 2019; the public
FCHarDNet code), written from its description with torch's stock
operators and nothing of the program.

Stem of four 3x3 ConvLayers (strides 2, 1, 2, 1), five HarDBlocks each
followed by a 1x1 transition, a 2x2 average pool between them, a decoder
of four stages (align-corners bilinear upsample, skip concat, 1x1
halving ConvLayer, HarDBlock), a 1x1 class head and a bilinear resize.
A ConvLayer is conv (no bias) -> BatchNorm -> ReLU. Eval mode uses the
running statistics; train mode normalises by the batch's mean and
flax's one-pass biased variance ``max(0, E[x²] - E[x]²)`` (the port's
trainer keeps flax's semantics), eps 1e-5.

The state dict keys are the public code's: ``base.{i}.conv.weight``,
``base.{i}.norm.*``, ``base.{i}.layers.{j}.*``, ``conv1x1_up.{j}.*``,
``denseBlocksUp.{j}.layers.{k}.*``, ``finalConv.*``.
"""

from __future__ import annotations

from typing import Callable, Dict, List, Optional, Tuple

import torch
import torch.nn.functional as F

FIRST_CH = (16, 24, 32, 48)
CH_LIST = (64, 96, 160, 224, 320)
GRMUL = 1.7
GR = (10, 16, 18, 24, 32)
N_LAYERS = (4, 4, 8, 8, 8)
EPS = 1e-5


def block_spec(n_layers: int, base_ch: int, growth: int):
    """HarDBlock wiring: per layer (out_ch, in_ch, links), and the
    block's output channels (odd layers and the last)."""
    spec: List[Tuple[int, int, List[int]]] = [(base_ch, 0, [])]
    for layer in range(1, n_layers + 1):
        links, out = [], float(growth)
        for i in range(10):
            if layer % (2 ** i) == 0:
                links.append(layer - 2 ** i)
                if i > 0:
                    out *= GRMUL
        out_ch = int(int(out + 1) / 2) * 2
        spec.append((out_ch, sum(spec[k][0] for k in links), links))
    layers = spec[1:]
    out_ch = sum(oc for i, (oc, _, _) in enumerate(layers)
                 if i % 2 == 0 or i == n_layers - 1)
    return layers, out_ch


class Net:
    """FCHarDNet-70 as a walk over the state dict. ``conv`` is the
    convolution to use (``F.conv2d`` by default; a counter or a
    lower-precision copy stands in for it)."""

    def __init__(self, state: Dict[str, torch.Tensor], train: bool = False,
                 conv: Optional[Callable] = None):
        self.s, self.train = state, train
        self.conv = conv or F.conv2d

    def layer(self, name: str, x, stride: int = 1):
        w = self.s[f"{name}.conv.weight"]
        y = self.conv(x, w, None, stride, w.shape[-1] // 2)
        g, b = self.s[f"{name}.norm.weight"], self.s[f"{name}.norm.bias"]
        if self.train:
            mean = y.mean((0, 2, 3))
            var = torch.clamp((y * y).mean((0, 2, 3)) - mean * mean, min=0.0)
        else:
            mean, var = self.s[f"{name}.norm.running_mean"], self.s[f"{name}.norm.running_var"]
        shape = (1, -1, 1, 1)
        y = (y - mean.view(shape)) * (torch.rsqrt(var + EPS) * g).view(shape) + b.view(shape)
        return torch.relu(y)

    def block(self, name: str, x, n_layers: int, growth: int):
        layers, _ = block_spec(n_layers, x.shape[1], growth)
        outs = [x]
        for j, (_, _, links) in enumerate(layers):
            inp = torch.cat([outs[k] for k in links], 1) if len(links) > 1 else outs[links[0]]
            outs.append(self.layer(f"{name}.layers.{j}", inp))
        t = len(outs)
        return torch.cat([outs[i] for i in range(t) if i == t - 1 or i % 2 == 1], 1)

    def __call__(self, x, out_size: Optional[Tuple[int, int]] = None):
        """x (B, C, H, W) -> logits (B, classes, *out_size or (H, W))."""
        size = out_size or tuple(x.shape[-2:])
        i = 0
        for stride in (2, 1, 2, 1):
            x = self.layer(f"base.{i}", x, stride)
            i += 1
        skips = []
        for k in range(5):
            x = self.block(f"base.{i}", x, N_LAYERS[k], GR[k])
            if k < 4:
                skips.append(x)
            x = self.layer(f"base.{i + 1}", x)
            i += 2
            if k < 4:
                x = F.avg_pool2d(x, 2, 2)
                i += 1
        for j in range(4):
            skip = skips.pop()
            x = F.interpolate(x, size=skip.shape[-2:], mode="bilinear", align_corners=True)
            x = self.layer(f"conv1x1_up.{j}", torch.cat([x, skip], 1))
            x = self.block(f"denseBlocksUp.{j}", x, N_LAYERS[3 - j], GR[3 - j])
        x = self.conv(x, self.s["finalConv.weight"], self.s["finalConv.bias"], 1, 0)
        return F.interpolate(x, size=size, mode="bilinear", align_corners=True)


def bg_input(seg, depth, dmask, num_classes: int, mean: float, std: float):
    """The bg network's input: per frame a one-hot of the trainIds (ids
    outside [0, C) an all-zero row), t-major, then the normalised depth of
    each frame, 0 where invalid. seg/depth/dmask (B, T, H, W)."""
    b, t, h, w = seg.shape
    seg = seg.long()
    ok = (seg >= 0) & (seg < num_classes)
    oh = F.one_hot(torch.where(ok, seg, 0), num_classes).float() * ok[..., None]
    oh = oh.permute(0, 1, 4, 2, 3).reshape(b, t * num_classes, h, w)
    dep = (depth.float() - mean) / std * dmask.float()
    return torch.cat([oh, dep], 1)


def decode_raw_depth(raw, min_depth: float, max_depth: float):
    """A raw uint16 depth block ``(d + 1)·256`` (0 invalid) -> (depth
    clamped to [min, max], -1 where invalid; valid mask)."""
    d = raw.float() / 256.0 - 1.0
    ok = d > 0
    return torch.where(ok, d.clamp(min_depth, max_depth), -1.0), ok


def state_shapes(in_ch: int, n_classes: int) -> Dict[str, Tuple[int, ...]]:
    """Every state dict entry of FCHarDNet-70 over ``in_ch`` inputs, by
    its shape (the running statistics and the BN counters included)."""
    out: Dict[str, Tuple[int, ...]] = {}

    def layer(name, cin, cout, k):
        out[f"{name}.conv.weight"] = (cout, cin, k, k)
        for s in ("weight", "bias", "running_mean", "running_var"):
            out[f"{name}.norm.{s}"] = (cout,)
        out[f"{name}.norm.num_batches_tracked"] = ()

    def block(name, cin, n_layers, growth):
        layers, cout = block_spec(n_layers, cin, growth)
        for j, (oc, ic, _) in enumerate(layers):
            layer(f"{name}.layers.{j}", ic, oc, 3)
        return cout

    chans = (in_ch,) + FIRST_CH
    for i in range(4):
        layer(f"base.{i}", chans[i], chans[i + 1], 3)
    i, ch, skips = 4, FIRST_CH[3], []
    for k in range(5):
        ch = block(f"base.{i}", ch, N_LAYERS[k], GR[k])
        if k < 4:
            skips.append(ch)
        layer(f"base.{i + 1}", ch, CH_LIST[k], 1)
        ch = CH_LIST[k]
        i += 3 if k < 4 else 2
    for j in range(4):
        cur = ch + skips.pop()
        layer(f"conv1x1_up.{j}", cur, cur // 2, 1)
        ch = block(f"denseBlocksUp.{j}", cur // 2, N_LAYERS[3 - j], GR[3 - j])
    out["finalConv.weight"] = (n_classes, ch, 1, 1)
    out["finalConv.bias"] = (n_classes,)
    return out
