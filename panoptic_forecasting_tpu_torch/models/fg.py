"""Foreground forecaster: coupled GRU + ConvLSTM rollouts over MaskRCNN
ROI features, then the mask head; its training losses.

Counterpart of ``panoptic_forecasting_tpu/models/fg.py`` (reference
``FGModel``, fg_model.py:21-746): a trajectory GRU encoder over
[normalised box state ⊕ depth ⊕ compressed instance features ⊕ validity
⊕ odometry]; a ConvLSTM encoder over the ROI features ⊕ a broadcast
trajectory feature; re-anchoring at the last input frame; a coupled
decoder of ``out_t`` steps (Python loops in place of the JAX ``nn.scan``)
in which each branch feeds the other; the mask head at the requested
output step, its class channel selected.

``loss`` is JAX's (models/fg.py:446-541, reference losses.py): per sample
``traj_coef`` × the masked smooth-l1 (or mse) of the unnormalised
trajectory and depth over the last input frame and the ``out_t`` outputs,
plus ``mask_distill_coef`` × the masked mse of the predicted ROI features
against the future ones; with the metrics ``traj_2d_loss``,
``center_pixel_l2``, ``center_pixel_fde``, ``size_pixel_l1``,
``depth_l2`` and ``mask_distill_loss``. The mask head takes no part in it
(no gradient reaches it, as in JAX). ``model.mask_head.
maskrcnn_pretrain_path`` names detectron2 mask-head weights, loaded by
``load_pretrained`` (JAX: ``init``); a missing file is warned about and
the seeded weights stay.

Every model option of the JAX model is honoured and none is refused:
``rnn_type`` ``gru`` or ``lstm`` (flax's ``OptimizedLSTMCell``, carry
``(c, h)``; ``layers.LSTMCell``); ``compute_dtype: bfloat16`` runs the
ConvLSTM branch in bf16 (``convlstm.py``) while the trajectory RNNs,
heads and ``mask_{en,de}coder_out`` stay f32 (JAX :99-101); the
ablations ``only_loc_feats`` (4-d boxes, 1-d depth, no velocity mask),
``no_traj_inst_feats`` and ``no_mask_traj_feats`` (the submodules they
drop are not built, as flax creates no parameters for them) and
``only_input_odometry`` (odometry on the encoder only); and
``use_bbox_ulbr`` (boxes are ulbr; the metrics convert them to cwh).
An unknown ``rnn_type`` or ``loss_type`` raises ``ValueError`` as in JAX.

Submodule and buffer names follow the reference ``state_dict``
(``traj_encoder.weight_ih_l0``, ``mask_encoder.cell_list.{i}.conv``,
``mask_head.*``, ``traj_mean``, ...). Layout is NCHW inside; ROI feats
arrive NCHW (or NHWC, moved), and ``instance_feat_model`` flattens them
c-major as the reference does.
"""

from __future__ import annotations

import os
import warnings
from typing import Any, Dict, Mapping, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.nn as nn
import torch.nn.functional as F

from ..device import DeviceLike, resolve_device
from ..geometry.boxes import bbox_ulbr_to_cwh
from .base import LOSS_FNS
from .convlstm import ConvLSTMStack
from .layers import MLP, GRUCell, LSTMCell
from .mask_head import MaskRCNNConvUpsampleHead

ODOM_DIM = 5
Stats = Mapping[str, Tuple[Sequence[float], Sequence[float]]]


def expand_traj_mask(mask, vel_mask=None, result_size: int = 4,
                     no_vel: bool = False) -> torch.Tensor:
    """(B, T) validity -> (B, T, 2·result_size) loc + velocity mask
    (``no_vel``: the loc mask alone); velocity needs both adjacent frames
    valid and is invalid at t = 0."""
    mask = mask.to(torch.float32)
    loc = mask[..., None].expand(mask.shape + (result_size,))
    if no_vel:
        return loc
    if vel_mask is None:
        vel_mask = torch.cat(
            [torch.zeros_like(mask[:, :1]), mask[:, 1:] * mask[:, :-1]], 1
        )
    vel = vel_mask.to(torch.float32)[..., None].expand(mask.shape + (result_size,))
    return torch.cat([loc, vel], -1)


def _traj_out_head(in_f: int, hidden: int, out_size: int,
                   num_layers: int) -> nn.Module:
    """Linear, or Sequential[(Linear, ReLU) * (n-1), Linear] (fg_model.py:
    118-132)."""
    if num_layers == 1:
        return nn.Linear(in_f, out_size)
    return MLP(in_f, (hidden,) * (num_layers - 1) + (out_size,), relu_first=True)


class FGModel(nn.Module):
    """cfg is the JAX package's fg config dict; ``stats`` maps "traj"
    (8-d), "depth" (2-d) and "odom" (5-d) to (mean, std), the data card's
    normalisation statistics (defaults 0 and 1)."""

    def __init__(self, cfg: Dict[str, Any], stats: Optional[Stats] = None,
                 device: DeviceLike = None):
        super().__init__()
        m = cfg.get("model", {})
        mh = m.get("mask_head", {}) or {}
        self.rnn_type = m.get("rnn_type", "gru")
        cells = {"gru": GRUCell, "lstm": LSTMCell}
        if self.rnn_type not in cells:
            raise ValueError(f"rnn_type not recognized: {self.rnn_type}")
        self.compute_dtype = (torch.bfloat16 if m.get("compute_dtype")
                              in ("bfloat16", "bf16") else torch.float32)
        self.use_bbox_ulbr = bool(cfg.get("use_bbox_ulbr"))
        self.only_loc_feats = bool(m.get("only_loc_feats"))
        self.only_input_odometry = bool(m.get("only_input_odometry"))
        self.use_traj_inst_feats = not m.get("no_traj_inst_feats", False)
        self.use_mask_traj_feats = not m.get("no_mask_traj_feats", False)
        self.traj_coef = float(m.get("traj_coef", 1.0))
        self.mask_distill_coef = float(m.get("mask_distill_coef", 1.0))
        loss_type = m.get("loss_type", "smoothl1")
        key = {"smoothl1": "smooth_l1", "mse": "mse"}.get(loss_type)
        if key is None:
            raise ValueError(f"loss_type not recognized: {loss_type}")
        self.loss_fn = LOSS_FNS[key]
        self.maskrcnn_pretrain_path = mh.get("maskrcnn_pretrain_path")
        if self.maskrcnn_pretrain_path and not os.path.exists(
                self.maskrcnn_pretrain_path):
            warnings.warn(f"mask head pretrain {self.maskrcnn_pretrain_path} "
                          "not found; seeded init")
            self.maskrcnn_pretrain_path = None
        self.use_odometry = bool(m.get("use_odometry"))
        self.use_depth_inp = bool(m.get("use_depth_inp"))
        self.use_depth_sorting = bool(m.get("use_depth_sorting"))
        self.traj_dim = 4 if self.only_loc_feats else 8
        self.depth_dim = ((1 if self.only_loc_feats else 2)
                          if self.use_depth_inp else 0)
        out_size = self.traj_dim + self.depth_dim
        rnn_hidden = int(m.get("rnn_hidden", 128))
        inst_ch = int(m.get("instance_feat_channels", 8))
        inst_hidden = int(m.get("instance_feat_hidden", 64))
        tf_ch = int(m.get("traj_feat_channels", 16))
        n_lstm = int(m.get("num_convlstm_layers", 1))
        n_out = int(m.get("num_traj_out_layers", 1))
        c = self.mask_feat_channels = int(m.get("mask_feat_channels", 256))
        hw = self.mask_feat_hw = int(m.get("mask_feat_hw", 14))
        conv_dim = int(mh.get("conv_dim", c))

        odom = ODOM_DIM if self.use_odometry else 0
        dec_odom = 0 if self.only_input_odometry else odom
        inst = inst_hidden if self.use_traj_inst_feats else 0
        cell = cells[self.rnn_type]
        self.traj_encoder = cell(out_size + inst + 1 + odom, rnn_hidden)
        self.traj_decoder = cell(out_size + inst + dec_odom, rnn_hidden)
        self.traj_encoder_out = _traj_out_head(rnn_hidden, rnn_hidden,
                                               out_size, n_out)
        self.traj_decoder_out = _traj_out_head(rnn_hidden, rnn_hidden,
                                               out_size, n_out)
        # flax builds no parameters for a submodule an ablation leaves
        # unused; neither does the port.
        self.traj_feat_out = (nn.Linear(rnn_hidden, tf_ch)
                              if self.use_mask_traj_feats else None)
        self.instance_compressor = self.instance_feat_model = None
        if self.use_traj_inst_feats:
            self.instance_compressor = nn.Conv2d(c, inst_ch, 1)
            self.instance_feat_model = nn.Linear(inst_ch * hw * hw, inst_hidden)
        mask_in = c + (tf_ch if self.use_mask_traj_feats else 0)
        dt = self.compute_dtype
        self.mask_encoder = ConvLSTMStack(mask_in, c, n_lstm, dtype=dt)
        self.mask_decoder = ConvLSTMStack(mask_in, c, n_lstm, dtype=dt)
        self.mask_encoder_out = nn.Conv2d(c, c, 1)
        self.mask_decoder_out = nn.Conv2d(c, c, 1)
        self.mask_head = MaskRCNNConvUpsampleHead(c, conv_dim)

        stats = dict(stats or {})
        for name, dim in (("traj", 8), ("depth", 2), ("odom", ODOM_DIM)):
            mean, std = stats.get(name, (np.zeros(dim), np.ones(dim)))
            self.register_buffer(f"{name}_mean", torch.tensor(
                np.asarray(mean, np.float32).reshape(-1)))
            self.register_buffer(f"{name}_std", torch.tensor(
                np.asarray(std, np.float32).reshape(-1)))
        self.eval()
        self.to(resolve_device(device))

    def load_pretrained(self) -> None:
        """detectron2 ``roi_heads.mask_head.*`` weights into the mask head,
        when the config names a file that exists."""
        if self.maskrcnn_pretrain_path:
            from .torch_import import load_maskrcnn_head_pickle

            self.mask_head.load_state_dict(
                load_maskrcnn_head_pickle(self.maskrcnn_pretrain_path))

    # -- normalisation -----------------------------------------------------
    def _full_stats(self):
        mean, std = self.traj_mean[:self.traj_dim], self.traj_std[:self.traj_dim]
        if self.use_depth_inp:
            mean = torch.cat([mean, self.depth_mean[:self.depth_dim]])
            std = torch.cat([std, self.depth_std[:self.depth_dim]])
        return mean, torch.where(std == 0, torch.ones_like(std), std)

    def _norm_traj(self, trajs, depths):
        x = torch.cat([trajs, depths], -1) if self.use_depth_inp else trajs
        mean, std = self._full_stats()
        return (x - mean) / std

    def _unnorm_traj(self, x):
        mean, std = self._full_stats()
        return x * std + mean

    # -- submodule steps ---------------------------------------------------
    def compress_inst_feats(self, feats, mask):
        """(..., C, hw, hw) -> (..., instance_feat_hidden), masked."""
        lead = feats.shape[:-3]
        x = F.relu(self.instance_compressor(feats.reshape((-1,) + feats.shape[-3:])))
        x = self.instance_feat_model(x.reshape(x.shape[0], -1))
        return x.reshape(lead + (-1,)) * mask

    def _with_traj_feat(self, hidden, feats):
        """concat([broadcast traj_feat_out(hidden), feats]) on channels, or
        feats alone under ``no_mask_traj_feats``."""
        if not self.use_mask_traj_feats:
            return feats
        tf = self.traj_feat_out(hidden)
        hw = self.mask_feat_hw
        tf = tf[..., None, None].expand(tf.shape + (hw, hw))
        return torch.cat([tf, feats], -3)

    def _rollout(self, enc_traj_inp, feats, odom_out, out_t: int):
        """enc_traj_inp (B, T, D); feats (B, T, C, hw, hw); odom_out
        (B, out_t, 5) or None -> (traj_preds (B, out_t+1, out_size),
        feat_preds (B, out_t+1, C, hw, hw))."""
        b, t_in = enc_traj_inp.shape[:2]
        carry = self._rnn_init(enc_traj_inp[:, 0])
        enc_outs = []
        for t in range(t_in):
            carry, h = self._rnn_step(self.traj_encoder, carry, enc_traj_inp[:, t])
            enc_outs.append(h)
        enc_mask_inp = self._with_traj_feat(torch.stack(enc_outs, 1), feats)
        hw = self.mask_feat_hw
        states = self.mask_encoder.init_state(b, hw, hw, feats)
        for t in range(t_in):
            states, mask_out = self.mask_encoder(states, enc_mask_inp[:, t])

        # Re-anchor at the most recent input frame (fg_model.py:279-283).
        cur_traj = self.traj_encoder_out(enc_outs[-1])
        cur_feats = self.mask_encoder_out(mask_out)
        trajs, feat_steps = [cur_traj], [cur_feats]
        ones = cur_traj.new_ones((b, 1))
        for t in range(out_t):
            inp = [cur_traj]
            if self.use_traj_inst_feats:
                inp.append(self.compress_inst_feats(cur_feats, ones))
            if odom_out is not None:
                inp.append(odom_out[:, t])
            carry, h = self._rnn_step(self.traj_decoder, carry, torch.cat(inp, -1))
            cur_traj = cur_traj + self.traj_decoder_out(h)
            states, h_last = self.mask_decoder(
                states, self._with_traj_feat(h, cur_feats)
            )
            cur_feats = self.mask_decoder_out(h_last)
            trajs.append(cur_traj)
            feat_steps.append(cur_feats)
        return torch.stack(trajs, 1), torch.stack(feat_steps, 1)

    def _rnn_init(self, like):
        """The zero carry: h, or (c, h) for the LSTM (JAX ``_rnn_init``)."""
        z = like.new_zeros(like.shape[:1] + (self.traj_encoder.hidden,))
        return z if self.rnn_type == "gru" else (z, z)

    def _rnn_step(self, cell, carry, x):
        """-> (carry, output) of one trajectory RNN step."""
        if self.rnn_type == "gru":
            h = cell(carry, x)
            return h, h
        return cell(carry, x)

    def _tensor(self, batch, name) -> torch.Tensor:
        """A float input in the model's dtype (f32; float64 after
        ``.double()``)."""
        return torch.as_tensor(batch[name], device=self.traj_mean.device).to(
            self.traj_mean.dtype)

    def _feats(self, batch, name) -> torch.Tensor:
        """ROI feats (..., C, hw, hw) f32; an NHWC array is moved."""
        feats = self._tensor(batch, name)
        c = self.mask_feat_channels
        if feats.shape[-3] != c and feats.shape[-1] == c:
            feats = feats.movedim(-1, -3)
        return feats

    def _run(self, inputs: Dict[str, Any], out_t: int, heads: bool = True
             ) -> Dict[str, torch.Tensor]:
        """The rollout, differentiable: trajectories (N, out_t+1, D) and
        feats (N, out_t+1, C, hw, hw); with ``heads`` the mask head at
        ``output_inds`` too."""
        dev = self.traj_mean.device
        trajs = self._tensor(inputs, "trajectories")[..., :self.traj_dim]
        feats = self._feats(inputs, "feats")
        inp_t = trajs.shape[1]
        bbox_masks = self._tensor(inputs, "bbox_masks")[:, :inp_t]
        vel_masks = self._tensor(inputs, "bbox_vel_masks")[:, :inp_t]
        depths = (self._tensor(inputs, "depths")[..., : self.depth_dim]
                  if self.use_depth_inp else None)
        normalized = self._norm_traj(trajs, depths)
        no_vel = self.only_loc_feats
        emask = expand_traj_mask(bbox_masks, vel_mask=vel_masks, no_vel=no_vel)
        if self.use_depth_inp:
            dmask = self._tensor(inputs, "depth_masks")
            dmask = dmask.reshape(dmask.shape[0], dmask.shape[1])
            emask = torch.cat([emask, expand_traj_mask(
                dmask, result_size=1, no_vel=no_vel)], -1)
        normalized = normalized * emask

        enc = [normalized]
        if self.use_traj_inst_feats:
            enc.append(self.compress_inst_feats(feats, bbox_masks[..., None]))
        enc.append(bbox_masks[..., None])
        odom_out = None
        if self.use_odometry:
            odom = self._tensor(inputs, "odometry")
            odom = (odom - self.odom_mean) / torch.where(
                self.odom_std == 0, torch.ones_like(self.odom_std),
                self.odom_std)
            enc.append(odom[:, :inp_t])
            if not self.only_input_odometry:
                odom_out = odom[:, inp_t: inp_t + out_t]
        traj_preds, feat_preds = self._rollout(
            torch.cat(enc, -1), feats, odom_out, int(out_t)
        )
        out = {"normalized_trajectory": traj_preds,
               "unnormalized_trajectory": self._unnorm_traj(traj_preds),
               "feats": feat_preds}
        if heads:
            out_inds = torch.as_tensor(inputs["output_inds"], device=dev).reshape(-1).long()
            rows = torch.arange(traj_preds.shape[0], device=dev)
            out["output_feats"] = feat_preds[:, -out_t:][rows, out_inds]
            mask_logits = self.mask_head(out["output_feats"])
            classes = torch.as_tensor(inputs["classes"], device=dev).reshape(-1).long()
            out["masks"] = mask_logits[rows, classes.clamp(0, 7)]
        return out

    @torch.no_grad()
    def forward(self, inputs: Dict[str, Any], out_t: int) -> Dict[str, torch.Tensor]:
        """inputs: the dense fg batch with a leading instance axis
        (trajectories, bbox_masks, bbox_vel_masks, depths, depth_masks,
        feats, odometry, classes, output_inds). Returns JAX layouts:
        trajectories (N, out_t+1, D), mask feats NHWC, masks (N, 28, 28)."""
        out = self._run(inputs, out_t)
        return {
            "normalized_trajectory": out["normalized_trajectory"],
            "unnormalized_trajectory": out["unnormalized_trajectory"],
            "mask_feats": out["feats"].permute(0, 1, 3, 4, 2),
            "output_feats": out["output_feats"].permute(0, 2, 3, 1),
            "masks": out["masks"],
        }

    # -- losses (JAX models/fg.py:446-541) ---------------------------------
    # The loss is the mean of per-sample losses (JAX :459-461): on equal
    # shards the mean of the ranks' means is the global mean, so the
    # trainer averages the ranks' gradients.
    loss_adds_over_shards = False

    def loss(self, batch: Dict[str, Any]):
        """A dense instance batch ``(B, T, ...)`` -> (mean loss, metrics of
        per-sample (B,) vectors, ``loss`` among them), differentiable."""
        inputs, labels = batch["inputs"], batch["labels"]
        out_t = int(np.shape(labels["trajectories"])[1])
        preds = self._run({**inputs, "output_inds": labels["output_inds"]},
                          out_t, heads=False)
        traj_loss, metrics = self._traj_loss(
            inputs, labels, preds["unnormalized_trajectory"], out_t)
        distill = self._mask_loss(inputs, labels, preds["feats"], out_t)
        metrics["mask_distill_loss"] = distill
        per_sample = self.traj_coef * traj_loss + self.mask_distill_coef * distill
        metrics["loss"] = per_sample
        return per_sample.mean(), metrics

    def _traj_loss(self, inputs, labels, upreds, out_t):
        bbox_masks = self._tensor(inputs, "bbox_masks")
        vel_masks = self._tensor(inputs, "bbox_vel_masks")
        inp_tr = self._tensor(inputs, "trajectories")[..., :self.traj_dim]
        lab_tr = self._tensor(labels, "trajectories")[..., :self.traj_dim]
        b = upreds.shape[0]

        tmask = expand_traj_mask(bbox_masks, vel_mask=vel_masks)[:, -(out_t + 1):]
        if self.only_loc_feats:
            tmask = tmask[..., :4]
        gt = torch.cat([inp_tr[:, -1:], lab_tr], 1)
        if self.use_depth_inp:
            dd = self.depth_dim
            inp_d = self._tensor(inputs, "depths")[..., :dd]
            lab_d = self._tensor(labels, "depths")[..., :dd]
            gt_d = torch.cat([inp_d[:, -1:], lab_d], 1)
            dm = torch.cat([self._tensor(inputs, "depth_masks"),
                            self._tensor(labels, "depth_masks")], 1)
            dm = dm.reshape(dm.shape[0], dm.shape[1], -1)[..., 0]
            gt_dm = expand_traj_mask(dm, result_size=1)[:, -(out_t + 1):, :dd]
            gt = torch.cat([gt, gt_d], -1)
            tmask = torch.cat([tmask, gt_dm], -1)

        per_elem = self.loss_fn(upreds, gt) * tmask
        msum = tmask.reshape(b, -1).sum(-1)
        traj_loss = per_elem.reshape(b, -1).sum(-1) / (msum + 1e-8)

        # metrics (losses.py:119-147)
        bm = bbox_masks[:, -(out_t + 1):]
        bm_n = bm.sum(-1) + 1e-8
        pred_cwh, gt_cwh = upreds[..., :4], gt[..., :4]
        if self.use_bbox_ulbr:
            pred_cwh, gt_cwh = bbox_ulbr_to_cwh(pred_cwh), bbox_ulbr_to_cwh(gt_cwh)
        center_l2 = torch.linalg.vector_norm(pred_cwh[..., :2] - gt_cwh[..., :2], dim=-1)
        fde = torch.linalg.vector_norm(pred_cwh[:, -1, :2] - gt_cwh[:, -1, :2], dim=-1)
        size_l1 = (pred_cwh[..., 2:4] - gt_cwh[..., 2:4]).abs() * bm[..., None]
        out = {
            "traj_2d_loss": traj_loss,
            "center_pixel_l2": (center_l2 * bm).sum(-1) / bm_n,
            "center_pixel_fde": fde * bm[:, -1],
            "size_pixel_l1": size_l1.reshape(b, -1).sum(-1) / bm_n,
        }
        if self.use_depth_inp:
            dcol = self.traj_dim
            depth_l2 = torch.linalg.vector_norm(
                upreds[..., dcol:dcol + 1] - gt_d[..., :1], dim=-1)
            dmm = gt_dm[..., 0]
            n = dmm.sum(-1)
            out["depth_l2"] = (depth_l2 * dmm).sum(-1) / torch.where(
                n == 0, torch.ones_like(n), n)
        return traj_loss, out

    def _mask_loss(self, inputs, labels, feat_preds, out_t):
        feat_masks = self._tensor(inputs, "feat_masks")[:, -(out_t + 1):]
        target = torch.cat([self._feats(inputs, "feats")[:, -1:],
                            self._feats(labels, "feats")], 1)
        diff = (feat_preds - target) ** 2
        b, t = diff.shape[:2]
        per_t = diff.reshape(b, t, -1).sum(-1) * feat_masks
        denom = feat_masks.sum(-1) * float(np.prod(diff.shape[2:])) + 1e-8
        return per_t.sum(-1) / denom
