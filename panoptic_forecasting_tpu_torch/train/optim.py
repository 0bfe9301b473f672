"""Optimizer and per-epoch learning rate.

Counterpart of ``panoptic_forecasting_tpu/train/optim.py`` (reference
training/train.py:124-136 and train_utils.py:13-24), with its semantics:

* the gradient is clipped first, by value (``clip_grad``, taking
  precedence) or by global norm (``clip_grad_norm``) as optax does: scaled
  by ``max_norm / ‖g‖`` only when ``‖g‖ ≥ max_norm``, with no epsilon
  (``torch.nn.utils.clip_grad_norm_`` divides by ``‖g‖ + 1e-6`` always);
* then ``use_adam`` (taking precedence), ``use_adamw`` or SGD with
  momentum ``mom``; ``wd`` is L2 decay added to the clipped gradient for
  Adam and SGD (torch's ``weight_decay`` of those), decoupled for AdamW;
* every parameter takes part in every step, as in the optax tree: one
  that got no gradient (the fg mask head) steps with zeros, so its
  Adam state and decay are JAX's; the slices a module names ``frozen``
  (a GRU's hidden-side r/z biases, which JAX does not have) are put back
  after each step.

The schedule keeps the reference's quirk: ``lr_scheduler_type`` is never
read (warned about); ``lr_decay_type`` ``step`` and ``poly`` are real
schedules, ``poly`` a cumulative product as torch's MultiplicativeLR.
"""

from __future__ import annotations

import warnings
from typing import Any, Callable, Dict

import torch


def lr_for_epoch(cfg: Dict[str, Any]) -> Callable[[int], float]:
    """epoch -> learning rate. ``step``: lr·γ^(epoch // step_size);
    ``poly``: lr·Π_{e=1..epoch} max(0, 1 − e/N); none: constant."""
    t = cfg.get("training", {})
    base_lr = float(t["lr"])
    decay_type = t.get("lr_decay_type")
    if t.get("lr_scheduler_type") and not decay_type:
        warnings.warn(
            "config sets 'lr_scheduler_type', which the reference trainer "
            "never reads (train_utils.py:14) — using constant LR for parity; "
            "set 'lr_decay_type' to activate a schedule"
        )
    if decay_type == "step":
        gamma = float(t.get("lr_decay_factor", 0.1))
        step_size = int(t.get("lr_decay_steps", 30))
        return lambda epoch: base_lr * gamma ** (epoch // step_size)
    if decay_type == "poly":
        num_epochs = int(t["num_epochs"])

        def sched(epoch: int) -> float:
            m = 1.0
            for e in range(1, epoch + 1):
                m *= max(0.0, 1.0 - e / num_epochs)
            return base_lr * m

        return sched
    if decay_type is None:
        return lambda epoch: base_lr
    raise ValueError(f"unknown lr_decay_type: {decay_type!r}")


class Optimizer:
    """Clip, then Adam / AdamW / SGD over all of ``model``'s parameters
    (in ``model.parameters()`` order), frozen slices restored."""

    def __init__(self, model: torch.nn.Module, cfg: Dict[str, Any]):
        t = cfg.get("training", {})
        lr = float(t["lr"])
        wd = float(t.get("wd", 0.0))
        self.params = list(model.parameters())
        self.frozen = [fs for m in model.modules() if hasattr(m, "frozen")
                       for fs in m.frozen()]
        self.clip_value = t.get("clip_grad")
        self.clip_norm = None if self.clip_value is not None else t.get("clip_grad_norm")
        if t.get("use_adam", False):
            self.inner = torch.optim.Adam(self.params, lr=lr, weight_decay=wd)
        elif t.get("use_adamw", False):
            self.inner = torch.optim.AdamW(self.params, lr=lr, weight_decay=wd)
        else:
            self.inner = torch.optim.SGD(self.params, lr=lr,
                                         momentum=float(t.get("mom", 0.0)),
                                         weight_decay=wd)

    def zero_grad(self) -> None:
        for p in self.params:
            p.grad = None

    def set_lr(self, lr: float) -> None:
        for group in self.inner.param_groups:
            group["lr"] = lr

    @torch.no_grad()
    def _clip(self) -> None:
        grads = [p.grad for p in self.params]
        if self.clip_value is not None:
            c = float(self.clip_value)
            for g in grads:
                g.clamp_(-c, c)
        elif self.clip_norm is not None:
            max_norm = float(self.clip_norm)
            norm = torch.stack([g.square().sum() for g in grads]).sum().sqrt()
            over = norm >= max_norm  # on the device: no host sync
            one = torch.ones_like(norm)
            div = torch.where(over, norm, one)
            mul = torch.where(over, torch.full_like(norm, max_norm), one)
            for g in grads:
                g.div_(div).mul_(mul)

    @torch.no_grad()
    def step(self) -> None:
        for p in self.params:
            if p.grad is None:
                p.grad = torch.zeros_like(p)
        self._clip()
        kept = [p[sl].clone() for p, sl in self.frozen]
        self.inner.step()
        for (p, sl), v in zip(self.frozen, kept):
            p[sl] = v

    def state_dict(self) -> Dict[str, Any]:
        return self.inner.state_dict()

    def load_state_dict(self, state: Dict[str, Any]) -> None:
        self.inner.load_state_dict(state)


def build_optimizer(model: torch.nn.Module, cfg: Dict[str, Any]) -> Optimizer:
    """The optimizer of ``cfg["training"]`` over ``model`` (JAX's name)."""
    return Optimizer(model, cfg)
