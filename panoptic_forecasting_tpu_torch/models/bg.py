"""Background semantic forecaster: FCHarDNet over one-hot reprojected segs.

Counterpart of ``panoptic_forecasting_tpu/models/bg.py`` (reference
``BGModel``, bg_model.py:15-102): ``num_inputs`` past segmentations
one-hot encoded to ``num_classes`` channels each (t-major), plus the
normalised, masked depth channels, through FCHarDNet-70.

Two routes, as in the JAX package: the unfolded model runs the BN graph
on the assembled input (batch statistics in train mode, running ones in
eval mode); the folded model (``maybe_fold``, the serving default) in
eval mode computes the assembly and the first conv in one fused step,
``kernels/stem.py::onehot_stem_conv`` (K2 on the GPU), and runs the rest
of the network from its output (JAX ``_stem_kernel_on``: never while
training). ``predict`` gives the class map the bg export writes;
``loss`` the training objective (JAX :278-309).

Training starts from the seeded init and, when ``model.hardnet.
pretrain_path`` names a file that exists, the reference's FCHarDNet-70
Cityscapes pickle (``load_pretrained``; JAX ``_load_pretrained``); a
missing file is warned about and the seeded weights are kept.

``model.compute_dtype: bfloat16`` (or ``bf16``) runs HarDNet in bf16
with f32 parameters, at JAX's cast points (``models/hardnet.py``); the
logits come back f32, so the loss and the argmax are f32. The folded
route keeps JAX's TPU semantics: K2 computes the stem in f32 and writes
it rounded to bf16 (``onehot_stem_conv(..., out_dtype=bf16)``), which
is what JAX's next op, the cast to bf16, makes of its f32 output.
``convert2onehot: false`` feeds the raw ids as one float channel per
frame (JAX :136-147) and never takes K2. Every ``model.*`` key the JAX
model reads is honoured; ``packed_train``/``packed_stem``/
``packed_levels``/``stem_kernel`` select TPU layouts of the same graph
and are accepted and ignored (the folded route always takes K2).
"""

from __future__ import annotations

import copy
import os
import warnings
from typing import Any, Dict, Optional, Tuple

import torch
import torch.nn as nn
import torch.distributed as dist
import torch.nn.functional as F

from ..device import DeviceLike, resolve_device
from ..kernels.stem import assemble_onehot, onehot_stem_conv
from ..parallel.mesh import batch_is_sharded
from .hardnet import HarDNet, fold_batchnorm_


class BGModel(nn.Module):
    """cfg is the JAX package's bg config dict ({"model": ..., "data": ...});
    ``depth_stats`` = (mean, std) of the depth inputs (default 0, 1)."""

    def __init__(self, cfg: Dict[str, Any],
                 depth_stats: Optional[Tuple[float, float]] = None,
                 device: DeviceLike = None):
        super().__init__()
        m = cfg.get("model", {})
        d = cfg.get("data", {})
        self.num_classes = int(d.get("num_classes", 19))
        self.use_depth_inps = bool(m.get("use_depth_inps"))
        self.num_inputs = int(m.get("num_inputs", 1))
        self.convert2onehot = bool(m.get("convert2onehot"))
        self.compute_dtype = (torch.bfloat16 if m.get("compute_dtype")
                              in ("bfloat16", "bf16") else torch.float32)
        self.min_depth = float(d.get("min_depth", 0.1))
        self.max_depth = float(d.get("max_depth", 200.0))
        fw, fh = m.get("final_w"), m.get("final_h")
        self.final_size = (int(fh), int(fw)) if fw and fh else None
        self.fold_bn = bool(m.get("fold_bn", True))
        self.pretrain_path = (m.get("hardnet", {}) or {}).get("pretrain_path")
        if self.pretrain_path and not os.path.exists(self.pretrain_path):
            warnings.warn(f"hardnet pretrain {self.pretrain_path} not found; "
                          "seeded init")
            self.pretrain_path = None
        per_frame = self.num_classes if self.convert2onehot else 1
        in_ch = self.num_inputs * (per_frame + int(self.use_depth_inps))
        mean, std = depth_stats if depth_stats is not None else (0.0, 1.0)
        self.register_buffer("depth_mean", torch.tensor([float(mean)]))
        self.register_buffer("depth_std", torch.tensor([float(std)]))
        self.model = HarDNet(in_ch, n_classes=self.num_classes,
                             dtype=self.compute_dtype)
        self.eval()
        self.to(resolve_device(device))

    @property
    def folded(self) -> bool:
        return self.model.folded

    def maybe_fold(self) -> "BGModel":
        """The folded (BN-free) copy that serving runs, unless
        ``model.fold_bn: false`` or already folded (JAX ``maybe_fold``)."""
        if not self.fold_bn or self.folded:
            return self
        out = copy.deepcopy(self)
        fold_batchnorm_(out.model)
        return out

    def _prep_inputs(self, inp):
        """-> (seg int32, depth f32 | None, depth_mask | None); a raw uint16
        depth block decodes as ``d/256 - 1`` (0 = invalid), clamped."""
        dev = self.depth_mean.device
        seg = torch.as_tensor(inp["seg"], device=dev).to(torch.int32)
        depth = inp.get("depth")
        dmask = inp.get("depth_mask")
        depth = torch.as_tensor(depth, device=dev) if depth is not None else None
        dmask = torch.as_tensor(dmask, device=dev) if dmask is not None else None
        if depth is not None and depth.dtype == torch.uint16:
            dep = depth.to(torch.float32) / 256.0 - 1.0
            dmask = dep > 0
            depth = torch.where(
                dmask, dep.clamp(self.min_depth, self.max_depth), -1.0
            )
        return seg, depth, dmask

    def _depth_channels(self, depth, dmask):
        dep = (depth.to(torch.float32) - self.depth_mean) / self.depth_std
        if dmask is not None:
            dep = dep * dmask.to(dep.dtype)
        return dep

    def _assemble(self, seg, depth, dmask) -> torch.Tensor:
        """-> (B, T·C [+T], H, W) network input, t-major channels; without
        ``convert2onehot`` (B, T [+T], H, W), the ids as floats."""
        if self.convert2onehot:
            x = assemble_onehot(seg, self.num_classes)
        else:
            x = seg.to(torch.float32)
        if self.use_depth_inps:
            # in the ids' dtype, f32, as JAX (dep.astype(x.dtype))
            x = torch.cat([x, self._depth_channels(depth, dmask).to(x.dtype)], 1)
        return x

    def stem_inputs(self, inputs: Dict[str, Any]):
        """-> (seg int32, depth channels f32 | None): what the fused stem
        (``onehot_stem_conv``) takes for these inputs."""
        seg, depth, dmask = self._prep_inputs(inputs)
        dep = self._depth_channels(depth, dmask) if self.use_depth_inps else None
        return seg, dep

    def load_pretrained(self) -> None:
        """The FCHarDNet-70 pickle ``pretrain_path`` names, when it exists:
        the stem conv mean-replicated across this model's input channels
        (``expand_first_layer``), the class head kept fresh unless the
        file's has this model's class count (``expand_last_layer``),
        every other entry loaded (JAX ``_load_pretrained``)."""
        if not self.pretrain_path:
            return
        from .torch_import import load_hardnet_pickle

        own = self.model.state_dict()
        state = {}
        for name, v in load_hardnet_pickle(self.pretrain_path).items():
            if name not in own:
                continue
            if name == "base.0.conv.weight" and v.shape[1] != own[name].shape[1]:
                v = v.mean(1, keepdim=True).expand(own[name].shape)
            if name.startswith("finalConv.") and v.shape[0] != own[name].shape[0]:
                continue
            state[name] = v
        self.model.load_state_dict(state, strict=False)

    def forward(self, inputs: Dict[str, Any], return_argmax: bool = False):
        """inputs: seg (B, T, H, W) int, depth/depth_mask (B, T, H, W).
        Returns logits (B, C, H', W') at ``final_size`` (or the input size),
        or with ``return_argmax`` the (B, H', W') int32 class map. In
        train mode the graph keeps its gradients and moves the BN
        statistics; in eval mode it runs without autograd."""
        with torch.set_grad_enabled(self.training and torch.is_grad_enabled()):
            return self._forward(inputs, return_argmax)

    def _forward(self, inputs, return_argmax):
        seg, depth, dmask = self._prep_inputs(inputs)
        kw = dict(final_size=self.final_size, return_argmax=return_argmax)
        h, w = seg.shape[-2:]
        if (self.folded and not self.training and self.convert2onehot
                and h % 2 == 0 and w % 2 == 0
                and (depth is not None) == self.use_depth_inps):
            # assembly + base.0 in one fused step, written in the
            # network's compute dtype
            dep = self._depth_channels(depth, dmask) if self.use_depth_inps else None
            conv = self.model.base[0].conv
            y0 = onehot_stem_conv(
                seg, dep, conv.weight.permute(2, 3, 1, 0), conv.bias,
                num_classes=self.num_classes, out_dtype=self.compute_dtype,
            )
            return self.model(y0.permute(0, 3, 1, 2), skip_stem0=True, **kw)
        return self.model(self._assemble(seg, depth, dmask), **kw)

    def predict(self, batch: Dict[str, Any]) -> Dict[str, torch.Tensor]:
        """{"seg": (B, H', W') class map}: the argmax at ``final_size``
        (or the input size) of ``batch["inputs"]`` (JAX ``predict``)."""
        return {"seg": self(batch["inputs"], return_argmax=True)}

    # A shard's loss is its share of the global batch's: the ranks' losses
    # add up to it, and the trainer sums their gradients.
    loss_adds_over_shards = True

    def loss(self, batch: Dict[str, Any]):
        """-> (mean CE, {"loss", "accuracy"}): the cross entropy of the
        logits against ``labels.seg`` over the pixels not 255, and the
        pixel accuracy there, each divided by max(valid pixels, 1), so an
        all-ignored batch gives 0 (JAX ``loss``).

        The mean is over the valid pixels of the whole global batch (JAX
        :305-306). On a sharded batch the denominator is therefore the
        global valid count (all-reduced, no gradient) and the numerator
        stays this rank's: shards with different ignore-255 counts must
        not average their own means, which would weight pixels unequally.
        Both values are then this rank's shares (``loss_adds_over_shards``)."""
        logits = self(batch["inputs"])
        labels = torch.as_tensor(batch["labels"]["seg"],
                                 device=logits.device).long()
        valid = labels != 255
        total = valid.sum()
        if batch_is_sharded():
            dist.all_reduce(total)
        total = total.clamp(min=1)
        ce = F.cross_entropy(logits, labels, ignore_index=255, reduction="none")
        loss = ce.sum() / total
        hits = valid & (logits.detach().argmax(1) == labels)
        acc = hits.sum() / total
        return loss, {"loss": loss, "accuracy": acc}
