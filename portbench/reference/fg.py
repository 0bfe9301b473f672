"""Plain foreground forecaster over a state dict (Graber et al., "Panoptic
Segmentation Forecasting", CVPR 2021, the public ``FGModel``), with
torch's stock operators and nothing of the program.

Per instance: a GRU encoder over [normalised box + depth state (masked),
compressed ROI features, validity, normalised odometry]; a two-layer
ConvLSTM encoder over [broadcast trajectory feature, ROI features]; the
state re-anchored at the last input frame by the output heads; a
coupled decoder of ``out_t`` steps (box residuals from the GRU, ROI
features from the ConvLSTM, each fed the other's output); the MaskRCNN
mask head at the requested output step, its class channel chosen.
Trajectories are (cx, cy, w, h, vx, vy, vw, vh) in pixels; depth (z, vz).
"""

from __future__ import annotations

from typing import Callable, Dict, Optional

import torch
import torch.nn.functional as F


class FG:
    """``linear``, ``conv`` and ``deconv`` stand in for ``F.linear``,
    ``F.conv2d`` and ``F.conv_transpose2d`` (a counter or a
    lower-precision copy)."""

    def __init__(self, state: Dict[str, torch.Tensor], model_cfg: Dict,
                 linear: Optional[Callable] = None, conv: Optional[Callable] = None,
                 deconv: Optional[Callable] = None):
        self.s, self.m = state, model_cfg
        self.linear = linear or F.linear
        self.conv = conv or F.conv2d
        self.deconv = deconv or F.conv_transpose2d
        self.hidden = int(model_cfg.get("rnn_hidden", 128))
        self.n_out = int(model_cfg.get("num_traj_out_layers", 1))
        self.n_lstm = int(model_cfg.get("num_convlstm_layers", 1))

    def lin(self, name, x):
        return self.linear(x, self.s[f"{name}.weight"], self.s[f"{name}.bias"])

    def c2d(self, name, x, padding=0):
        return self.conv(x, self.s[f"{name}.weight"], self.s[f"{name}.bias"], 1, padding)

    def head(self, name, x):
        """The trajectory output head: Linear, or Linear-ReLU-...-Linear."""
        if self.n_out == 1:
            return self.lin(name, x)
        for k in range(self.n_out):
            if k:
                x = torch.relu(x)
            x = self.lin(f"{name}.{2 * k}", x)
        return x

    def gru(self, name, h, x):
        gi = self.linear(x, self.s[f"{name}.weight_ih_l0"], self.s[f"{name}.bias_ih_l0"])
        gh = self.linear(h, self.s[f"{name}.weight_hh_l0"], self.s[f"{name}.bias_hh_l0"])
        ir, iz, inn = gi.chunk(3, -1)
        hr, hz, hn = gh.chunk(3, -1)
        r, z = torch.sigmoid(ir + hr), torch.sigmoid(iz + hz)
        n = torch.tanh(inn + r * hn)
        return (1 - z) * n + z * h

    def convlstm(self, name, states, x):
        new = []
        for layer, (h, c) in enumerate(states):
            gates = self.c2d(f"{name}.cell_list.{layer}.conv", torch.cat([x, h], 1), 1)
            i, f, o, g = gates.chunk(4, 1)
            c = torch.sigmoid(f) * c + torch.sigmoid(i) * torch.tanh(g)
            h = torch.sigmoid(o) * torch.tanh(c)
            new.append((h, c))
            x = h
        return new, x

    def compress(self, feats, mask):
        lead = feats.shape[:-3]
        x = torch.relu(self.c2d("instance_compressor", feats.reshape((-1,) + feats.shape[-3:])))
        x = self.lin("instance_feat_model", x.reshape(x.shape[0], -1))
        return x.reshape(lead + (-1,)) * mask

    def with_traj_feat(self, h, feats):
        tf = self.lin("traj_feat_out", h)
        hw = feats.shape[-1]
        return torch.cat([tf[..., None, None].expand(tf.shape + (hw, hw)), feats], -3)

    def mask_head(self, x):
        for k in range(1, 5):
            x = torch.relu(self.c2d(f"mask_head.mask_fcn{k}", x, 1))
        x = torch.relu(self.deconv(x, self.s["mask_head.deconv.weight"],
                                   self.s["mask_head.deconv.bias"], 2))
        return self.c2d("mask_head.predictor", x)

    def stats(self):
        s = self.s
        mean = torch.cat([s["traj_mean"][:8], s["depth_mean"][:2]])
        std = torch.cat([s["traj_std"][:8], s["depth_std"][:2]])
        return mean, torch.where(std == 0, torch.ones_like(std), std)

    def __call__(self, inp: Dict[str, torch.Tensor], out_t: int):
        """inp: the fg inputs of N instances (leading axis N). Returns
        the unnormalised trajectories (N, out_t + 1, 10) and the mask
        logits (N, 28, 28) of each instance's class."""
        s = self.s
        f32 = torch.float32
        traj = inp["trajectories"][..., :8].to(f32)
        feats = inp["feats"].to(f32)
        n, t_in = traj.shape[:2]
        bm = inp["bbox_masks"][:, :t_in].to(f32)
        vm = inp["bbox_vel_masks"][:, :t_in].to(f32)
        dm = inp["depth_masks"].to(f32).reshape(n, t_in)
        dm_vel = torch.cat([torch.zeros_like(dm[:, :1]), dm[:, 1:] * dm[:, :-1]], 1)
        mask = torch.cat([bm[..., None].expand(n, t_in, 4), vm[..., None].expand(n, t_in, 4),
                          dm[..., None], dm_vel[..., None]], -1)
        mean, std = self.stats()
        x = (torch.cat([traj, inp["depths"][..., :2].to(f32)], -1) - mean) / std * mask
        ostd = torch.where(s["odom_std"] == 0, torch.ones_like(s["odom_std"]), s["odom_std"])
        odom = (inp["odometry"].to(f32) - s["odom_mean"]) / ostd
        enc = torch.cat([x, self.compress(feats, bm[..., None]), bm[..., None], odom[:, :t_in]], -1)

        h = enc.new_zeros((n, self.hidden))
        outs = []
        for t in range(t_in):
            h = self.gru("traj_encoder", h, enc[:, t])
            outs.append(h)
        mask_in = self.with_traj_feat(torch.stack(outs, 1), feats)
        hw = feats.shape[-1]
        ch = feats.shape[-3]
        zeros = feats.new_zeros((n, ch, hw, hw))
        states = [(zeros, zeros)] * self.n_lstm
        for t in range(t_in):
            states, m_out = self.convlstm("mask_encoder", states, mask_in[:, t])
        cur = self.head("traj_encoder_out", outs[-1])
        cur_f = self.c2d("mask_encoder_out", m_out)
        trajs, fsteps = [cur], [cur_f]
        ones = cur.new_ones((n, 1))
        for t in range(out_t):
            x = torch.cat([cur, self.compress(cur_f, ones), odom[:, t_in + t]], -1)
            h = self.gru("traj_decoder", h, x)
            cur = cur + self.head("traj_decoder_out", h)
            states, m_out = self.convlstm("mask_decoder", states, self.with_traj_feat(h, cur_f))
            cur_f = self.c2d("mask_decoder_out", m_out)
            trajs.append(cur)
            fsteps.append(cur_f)
        traj_out = torch.stack(trajs, 1) * std + mean
        rows = torch.arange(n, device=traj.device)
        feat_out = torch.stack(fsteps, 1)[:, -out_t:][rows, inp["output_inds"].long()]
        logits = self.mask_head(feat_out)
        return traj_out, logits[rows, inp["classes"].long().clamp(0, 7)]


def state_shapes(m: Dict) -> Dict[str, tuple]:
    """Every parameter and statistic of the fg model of ``m`` (the
    ``model`` section), by its shape."""
    c, hw = int(m.get("mask_feat_channels", 256)), int(m.get("mask_feat_hw", 14))
    hid, inst = int(m.get("rnn_hidden", 128)), int(m.get("instance_feat_hidden", 64))
    ich, tf = int(m.get("instance_feat_channels", 8)), int(m.get("traj_feat_channels", 16))
    conv_dim = int((m.get("mask_head") or {}).get("conv_dim", c))
    n_out, n_lstm = int(m.get("num_traj_out_layers", 1)), int(m.get("num_convlstm_layers", 1))
    out_size, odom = 10, 5
    s: Dict[str, tuple] = {}

    def lin(name, i, o):
        s[f"{name}.weight"], s[f"{name}.bias"] = (o, i), (o,)

    def conv(name, i, o, k):
        s[f"{name}.weight"], s[f"{name}.bias"] = (o, i, k, k), (o,)

    for name, i in (("traj_encoder", out_size + inst + 1 + odom),
                    ("traj_decoder", out_size + inst + odom)):
        s[f"{name}.weight_ih_l0"], s[f"{name}.weight_hh_l0"] = (3 * hid, i), (3 * hid, hid)
        s[f"{name}.bias_ih_l0"], s[f"{name}.bias_hh_l0"] = (3 * hid,), (3 * hid,)
    for name in ("traj_encoder_out", "traj_decoder_out"):
        if n_out == 1:
            lin(name, hid, out_size)
        for k in range(n_out if n_out > 1 else 0):
            lin(f"{name}.{2 * k}", hid, out_size if k == n_out - 1 else hid)
    lin("traj_feat_out", hid, tf)
    conv("instance_compressor", c, ich, 1)
    lin("instance_feat_model", ich * hw * hw, inst)
    for name in ("mask_encoder", "mask_decoder"):
        for layer in range(n_lstm):
            conv(f"{name}.cell_list.{layer}.conv", (c + tf if layer == 0 else c) + c, 4 * c, 3)
    conv("mask_encoder_out", c, c, 1)
    conv("mask_decoder_out", c, c, 1)
    for k in range(4):
        conv(f"mask_head.mask_fcn{k + 1}", c if k == 0 else conv_dim, conv_dim, 3)
    s["mask_head.deconv.weight"], s["mask_head.deconv.bias"] = (conv_dim, conv_dim, 2, 2), (conv_dim,)
    conv("mask_head.predictor", conv_dim, 8, 1)
    for name, dim in (("traj", 8), ("depth", 2), ("odom", odom)):
        s[f"{name}_mean"], s[f"{name}_std"] = (dim,), (dim,)
    return s
