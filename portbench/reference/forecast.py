"""Plain single-call panoptic forecast (the public
``scripts/fg/run_fg_eval_panoptic.sh`` chain in one call): reprojection
of each past frame (``pc``), FCHarDNet-70 on the one-hot + depth stack
and its argmax (``hardnet``), the foreground rollout and mask head
(``fg``), then the fusion of the public ``FGModel`` (fg_model.py:
557-588): instances painted far to near over the stuff canvas, each
pixel whose pasted mask probability is >= the threshold taking the
instance's id ``(class + 11)·1000 + rank``, the rank counting earlier
valid instances of its class in paint order. Masks are pasted with
``F.grid_sample`` (bilinear, ``align_corners=False``, zeros outside)
over each box, as the public ``paste_mask`` does.
"""

from __future__ import annotations

from typing import Callable, Dict, Optional

import numpy as np
import torch
import torch.nn.functional as F

from .fg import FG
from .hardnet import Net, bg_input
from .pc import splat

N_STUFF = 11


def paste(mask, box, height: int, width: int):
    """(28, 28) probabilities at an ulbr box -> (H, W)."""
    x0, y0, x1, y1 = (float(b) for b in box)
    if abs(x1 - x0) < 1e-6 or abs(y1 - y0) < 1e-6:
        return mask.new_zeros((height, width))
    dev = mask.device
    gx = ((torch.arange(width, device=dev, dtype=torch.float32) + 0.5) - x0) / (x1 - x0) * 2 - 1
    gy = ((torch.arange(height, device=dev, dtype=torch.float32) + 0.5) - y0) / (y1 - y0) * 2 - 1
    grid = torch.stack([gx[None, :].expand(height, width),
                        gy[:, None].expand(height, width)], -1)
    return F.grid_sample(mask[None, None], grid[None], mode="bilinear",
                         padding_mode="zeros", align_corners=False)[0, 0]


def fuse(canvas, masks, boxes, depths, classes, valid, threshold: float):
    """Paint order far to near (stable), ids, and the panoptic map."""
    n = len(classes)
    key = np.where(valid, -depths.astype(np.float64), np.inf)
    order = np.argsort(key, kind="stable")
    ids = np.zeros(n, np.int32)
    seen: Dict[int, int] = {}
    pan = canvas.clone()
    h, w = canvas.shape
    for k in order:
        if not valid[k]:
            continue
        c = int(classes[k])
        ids[k] = (c + N_STUFF) * 1000 + seen.get(c, 0)
        seen[c] = seen.get(c, 0) + 1
        hit = paste(masks[k], boxes[k], h, w) >= threshold
        pan = torch.where(hit, int(ids[k]), pan)
    return pan, ids


def forecast(bg_state, fg_state, cfg: Dict, pc_in: Dict, fg_in: Dict, dev,
             conv: Optional[Callable] = None, linear: Optional[Callable] = None,
             deconv: Optional[Callable] = None):
    """One scene (batch 1) -> {panoptic, ids, bg_seg, bbox, depths}, each
    a host numpy array. ``conv``, ``linear`` and ``deconv`` replace
    ``F.conv2d``, ``F.linear`` and ``F.conv_transpose2d`` everywhere (a
    lower precision)."""
    h, w, t_in = cfg["height"], cfg["width"], cfg["num_inputs"]
    segs, deps = [], []
    for t in range(t_in):
        lab, dep = splat(torch.as_tensor(pc_in["seg"][0, t], device=dev),
                         torch.as_tensor(pc_in["depth"][0, t], device=dev),
                         torch.as_tensor(pc_in["depth_mask"][0, t], device=dev),
                         pc_in["intrinsics"][0], pc_in["extrinsics"][0],
                         pc_in["target_T"][0, t], h, w)
        segs.append(lab)
        deps.append(dep)
    seg, dep = torch.stack(segs)[None], torch.stack(deps)[None]
    mean, std = cfg["depth_stats"]
    ncls = int(cfg["bg"]["data"]["num_classes"])
    x = bg_input(seg, dep.clamp(min=0.0), dep > 0, ncls, mean, std)
    with torch.no_grad():
        logits = Net({k: v.to(dev) for k, v in bg_state.items()}, conv=conv)(x, (h, w))
        bg_seg = logits.argmax(1)[0].to(torch.int32)
        del logits, x
        inp = {k: torch.as_tensor(v[0], device=dev) for k, v in fg_in.items()}
        out_t = int(cfg["out_t"])
        net = FG({k: v.to(dev) for k, v in fg_state.items()}, cfg["fg"]["model"],
                 linear=linear, conv=conv, deconv=deconv)
        traj, mask_logits = net(inp, out_t)
    n = traj.shape[0]
    rows = torch.arange(n, device=dev)
    sel = traj[:, -out_t:][rows, inp["output_inds"].long()]
    cx, cy, bw, bh = sel[:, :4].unbind(-1)
    boxes = torch.stack([cx - bw / 2, cy - bh / 2, cx + bw / 2, cy + bh / 2], -1)
    depths = sel[:, 8]
    canvas = torch.where(bg_seg >= N_STUFF, 255, bg_seg)
    pan, ids = fuse(canvas, torch.sigmoid(mask_logits), boxes.cpu().numpy(),
                    depths.cpu().numpy(), fg_in["classes"][0], fg_in["valid"][0].astype(bool),
                    float(cfg["threshold"]))
    return {"panoptic": pan.cpu().numpy(), "ids": ids, "bg_seg": bg_seg.cpu().numpy(),
            "bbox": boxes.cpu().numpy(), "depths": depths.cpu().numpy()}
