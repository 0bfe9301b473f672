"""Egomotion (odometry) forecaster: GRU encoder + autoregressive decoder.

Counterpart of ``panoptic_forecasting_tpu/models/odom.py`` (reference
``OdomModel``, models/odom/odom_model.py:12-121): an optional MLP input
embedding, one GRU layer, an MLP head to a 2-d (speed, yaw_rate) output.
The first T−1 observations are encoded; then ``output_len`` steps are
rolled from the last one, each step's new hidden state through the head
(the flax cell returns ``(h, h)``), feeding back the prediction
(``direct``) or the accumulated value (``offset``). Python loops stand
in for the JAX ``nn.scan``s.

Submodule and buffer names follow the reference ``state_dict``: ``rnn.*``
(the GRU layer), ``out.{k}.*`` (the head), ``inp_emb.{k}.*`` (the
embedding), ``odom_mean``/``odom_std`` (the statistics, mean 0 and std 1
when the data card has none, as in JAX). ``loss`` is JAX's
(models/odom.py:151-160): the per-sample mean of ``loss_fn`` (mse or
smooth-l1), in normalised space with ``use_normalized_loss``.
"""

from __future__ import annotations

from typing import Any, Dict, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.nn as nn

from ..device import DeviceLike, resolve_device
from .base import LOSS_FNS
from .layers import MLP, GRUCell


class OdomModel(nn.Module):
    """cfg is the JAX package's odom config dict; ``stats`` = (mean, std)
    of the (speed, yaw_rate) odometry (default 0 and 1)."""

    def __init__(self, cfg: Dict[str, Any],
                 stats: Optional[Tuple[Sequence[float], Sequence[float]]] = None,
                 device: DeviceLike = None):
        super().__init__()
        m = cfg.get("model", {})
        self.predict_type = m.get("predict_type", "direct")
        if self.predict_type not in ("direct", "offset"):
            raise ValueError(f"predict_type not recognized: {self.predict_type}")
        self.normalize_input = bool(m.get("normalize_input"))
        self.use_normalized_loss = bool(m.get("use_normalized_loss"))
        loss_type = m.get("loss_fn", "mse")
        if loss_type not in LOSS_FNS:
            raise ValueError(f"loss_fn not recognized: {loss_type}")
        self.loss_fn = LOSS_FNS[loss_type]
        self.output_len = int(cfg.get("data", {}).get("output_len", 9))
        hidden = int(m.get("rnn_hidden", 128))
        emb = list(m.get("inp_emb_layers") or [])
        self.inp_emb = MLP(2, emb, relu_last=True) if emb else None
        self.rnn = GRUCell(emb[-1] if emb else 2, hidden)
        self.out = MLP(hidden, list(m.get("out_layers", [])) + [2], relu_first=True)

        mean, std = stats if stats is not None else (np.zeros(2), np.ones(2))
        self.register_buffer("odom_mean", torch.tensor(
            np.asarray(mean, np.float32).reshape(-1)))
        self.register_buffer("odom_std", torch.tensor(
            np.asarray(std, np.float32).reshape(-1)))
        self.eval()
        self.to(resolve_device(device))

    def _embed(self, x: torch.Tensor) -> torch.Tensor:
        return self.inp_emb(x) if self.inp_emb is not None else x

    def _normalize(self, x):
        return (x - self.odom_mean) / self.odom_std

    def _unnormalize(self, x):
        return x * self.odom_std + self.odom_mean

    def rollout(self, inps: torch.Tensor) -> torch.Tensor:
        """(B, T, 2) history -> (B, output_len, 2) forecasts, in the
        history's space."""
        h = inps.new_zeros((inps.shape[0], self.rnn.hidden))
        for t in range(inps.shape[1] - 1):
            h = self.rnn(h, self._embed(inps[:, t]))
        cur, ys = inps[:, -1], []
        for _ in range(self.output_len):
            h = self.rnn(h, self._embed(cur))
            out = self.out(h)
            cur = cur + out if self.predict_type == "offset" else out
            ys.append(cur)
        return torch.stack(ys, 1)

    def _tensor(self, x) -> torch.Tensor:
        return torch.as_tensor(x, device=self.odom_mean.device).to(torch.float32)

    def _forecast(self, inp_odom) -> Tuple[torch.Tensor, torch.Tensor]:
        x = self._tensor(inp_odom)
        if self.normalize_input:
            y = self.rollout(self._normalize(x))
            return self._unnormalize(y), y
        y = self.rollout(x)
        return y, self._normalize(y)

    @torch.no_grad()
    def forward(self, inp_odom) -> Tuple[torch.Tensor, torch.Tensor]:
        """(B, T, 2) raw odometry -> (unnormalised, normalised) forecasts,
        each (B, output_len, 2)."""
        return self._forecast(inp_odom)

    # The loss is the mean of per-sample losses (JAX models/odom.py:159-160):
    # on equal shards the mean of the ranks' means is the global mean, so
    # the trainer averages the ranks' gradients.
    loss_adds_over_shards = False

    def loss(self, batch: Dict[str, Any]):
        """-> (mean loss, {"loss": per-sample loss (B,)}), differentiable."""
        preds, normalized = self._forecast(batch["inputs"]["odometry"])
        lab = self._tensor(batch["labels"]["odometry"])
        if self.use_normalized_loss:
            per_elem = self.loss_fn(normalized, self._normalize(lab))
        else:
            per_elem = self.loss_fn(preds, lab)
        per_sample = per_elem.reshape(per_elem.shape[0], -1).mean(1)
        return per_sample.mean(), {"loss": per_sample}

    def predict(self, batch: Dict[str, Any]) -> Dict[str, torch.Tensor]:
        preds, _ = self(batch["inputs"]["odometry"])
        return {"odometry": preds}
