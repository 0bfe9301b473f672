"""Plain bg training steps (the public bg trainer, training/train.py with
bg_model.py's loss): FCHarDNet-70 in train mode on the one-hot + depth
input, the cross entropy over the GT pixels that are not 255 divided by
their count, the gradient by autograd, clipping by the global norm as
optax's ``clip_by_global_norm`` (scaled by max/‖g‖ only when ‖g‖ >= max)
and SGD with momentum and L2 weight decay added to the clipped gradient
(``buf = mom·buf + g + wd·p``, the first step ``buf = g + wd·p``;
``p -= lr·buf``).
"""

from __future__ import annotations

from typing import Callable, Dict, List, Optional

import torch
import torch.nn.functional as F

from .hardnet import Net, bg_input, decode_raw_depth


def loss_fn(params: Dict[str, torch.Tensor], batch: Dict, cfg: Dict, dev,
            conv: Optional[Callable] = None):
    d, m = cfg["data"], cfg["model"]
    seg = torch.as_tensor(batch["inputs"]["seg"], device=dev)
    depth, ok = decode_raw_depth(torch.as_tensor(batch["inputs"]["depth"], device=dev),
                                 float(d["min_depth"]), float(d["max_depth"]))
    mean, std = cfg["depth_stats"]
    x = bg_input(seg, depth, ok, int(d["num_classes"]), mean, std)
    logits = Net(params, train=True, conv=conv)(x)
    labels = torch.as_tensor(batch["labels"]["seg"], device=dev).long()
    count = (labels != 255).sum().clamp(min=1)
    return F.cross_entropy(logits, labels, ignore_index=255, reduction="sum") / count


def train_steps(state: Dict[str, torch.Tensor], batches: List[Dict], cfg: Dict, dev,
                conv: Optional[Callable] = None):
    """Steps over ``batches`` from ``state``. Returns (losses, the first
    step's clipped gradient + decay (the momentum buffer after one step),
    the first step's clipped gradient, the parameters after the last
    step), each per leaf of the trainable parameters (BN running
    statistics are not parameters)."""
    t = cfg["training"]
    lr, mom, wd = float(t["lr"]), float(t["mom"]), float(t["wd"])
    max_norm = float(t["clip_grad_norm"])
    names = [k for k in state if not k.endswith(("running_mean", "running_var",
                                                  "num_batches_tracked"))]
    params = {k: state[k].to(dev).clone() for k in names}
    stats = {k: v.to(dev) for k, v in state.items() if k not in params}
    buf, losses, first = None, [], None
    for batch in batches:
        live = {k: v.requires_grad_(True) for k, v in params.items()}
        loss = loss_fn({**live, **stats}, batch, cfg, dev, conv)
        grads = torch.autograd.grad(loss, [live[k] for k in names])
        losses.append(float(loss.detach()))
        with torch.no_grad():
            norm = torch.sqrt(sum((g.double() ** 2).sum() for g in grads))
            scale = max_norm / float(norm) if float(norm) >= max_norm else 1.0
            grads = [g * scale for g in grads]
            step = [g + wd * params[k] for k, g in zip(names, grads)]
            buf = step if buf is None else [mom * b + s for b, s in zip(buf, step)]
            if first is None:
                first = (dict(zip(names, [b.clone() for b in buf])), dict(zip(names, grads)))
            params = {k: (params[k] - lr * b).detach() for k, b in zip(names, buf)}
    return losses, first[0], first[1], params
