"""Weight bridge: the JAX package's parameters -> the port's ``state_dict``.

The JAX package keeps its weights as nested dicts of arrays (Flax trees,
HWIO conv kernels, (in, out) dense kernels). These functions turn them
into ``state_dict``s of the port's modules, which use the reference
PyTorch names and layouts (OIHW convs, (out, in) linears, ``nn.GRU`` gate
rows r | z | n). Pass numpy arrays (``np.asarray`` of each leaf).

They are the exact inverse of the JAX package's
``models/reference_import.py::{odom,bg,fg}_from_reference``: converting
back reproduces the JAX variables bit for bit. The JAX package has no
LSTM importer; ``lstm_cell_params`` is the inverse of the LSTM's bridge.
The bridges are dtype-agnostic: the parameters are f32 whatever
``compute_dtype`` the model runs in, in both packages. ``opt_state_from_jax``
carries an optax Adam or SGD state the same way, so a JAX training run
resumes in the port.
"""

from __future__ import annotations

import math
from typing import Any, Callable, Dict, Iterator, Mapping, Optional, Sequence, Tuple

import numpy as np
import torch

Tree = Mapping[str, Any]


def _t(x) -> torch.Tensor:
    return torch.from_numpy(np.array(x, copy=True, order="C"))


def _conv(k) -> torch.Tensor:
    """HWIO -> OIHW."""
    return _t(np.asarray(k).transpose(3, 2, 0, 1))


def _dense(p: Tree, prefix: str, out: Dict[str, torch.Tensor]):
    out[f"{prefix}.weight"] = _t(np.asarray(p["kernel"]).T)
    if "bias" in p:
        out[f"{prefix}.bias"] = _t(p["bias"])


def _conv_params(p: Tree, prefix: str, out: Dict[str, torch.Tensor]):
    out[f"{prefix}.weight"] = _conv(p["kernel"])
    if "bias" in p:
        out[f"{prefix}.bias"] = _t(p["bias"])


def _convlayer(p: Tree, s: Optional[Tree], prefix: str, out):
    _conv_params(p["conv"], f"{prefix}.conv", out)
    if "norm" in p:
        out[f"{prefix}.norm.weight"] = _t(p["norm"]["scale"])
        out[f"{prefix}.norm.bias"] = _t(p["norm"]["bias"])
        if s is not None:
            out[f"{prefix}.norm.running_mean"] = _t(s["norm"]["mean"])
            out[f"{prefix}.norm.running_var"] = _t(s["norm"]["var"])
            out[f"{prefix}.norm.num_batches_tracked"] = torch.tensor(0)


def _hardnet_stage(p: Tree, s: Optional[Tree], prefix: str, out):
    """A ConvLayer ({conv[, norm]}) or a HarDBlock ({layer_j: ...})."""
    if "conv" in p:
        _convlayer(p, s, prefix, out)
        return
    for name, lp in p.items():
        j = int(name.split("_")[-1])
        _convlayer(lp, (s or {}).get(name), f"{prefix}.layers.{j}", out)


def bg_state_dict_from_jax(variables: Tree,
                           depth_stats: Optional[Tuple[float, float]] = None
                           ) -> Dict[str, torch.Tensor]:
    """BGModel variables -> ``BGModel`` state_dict (``model.*`` +
    ``depth_mean``/``depth_std``). Takes unfolded ``{params,
    batch_stats}``, as training holds them (load into an unfolded
    BGModel: the BN ``running_mean``/``running_var`` from the batch
    statistics, ``num_batches_tracked`` 0), or folded ``{params}`` (load
    into ``BGModel.maybe_fold()``'s result). Unfolded ``{params}`` alone,
    a tree shaped as the parameters (gradients, SGD's momentum), gives
    the parameters' entries only."""
    params = variables["params"]
    stats = variables.get("batch_stats", {})
    out: Dict[str, torch.Tensor] = {}
    for name, p in params.items():
        s = stats.get(name)
        if name == "finalConv":
            _conv_params(p, "model.finalConv", out)
        elif name.startswith("base_"):
            _hardnet_stage(p, s, f"model.base.{name[5:]}", out)
        elif name.startswith("conv1x1_up_"):
            _convlayer(p, s, f"model.conv1x1_up.{name[11:]}", out)
        elif name.startswith("denseBlocksUp_"):
            _hardnet_stage(p, s, f"model.denseBlocksUp.{name[14:]}", out)
        else:
            raise KeyError(f"unknown HarDNet parameter group {name!r}")
    mean, std = depth_stats if depth_stats is not None else (0.0, 1.0)
    out["depth_mean"] = torch.tensor([float(mean)], dtype=torch.float32)
    out["depth_std"] = torch.tensor([float(std)], dtype=torch.float32)
    return out


def _gru(p: Tree, prefix: str, out):
    """Flax GRUCell {ir, iz, in, hr, hz, hn} -> nn.GRU layer 0. The flax
    cell keeps the r/z biases on the input side only (``b_ir + b_hr``):
    they go to ``bias_ih`` and the hidden r/z biases are 0."""
    k = {g: np.asarray(p[g]["kernel"]) for g in ("ir", "iz", "in", "hr", "hz", "hn")}
    out[f"{prefix}.weight_ih_l0"] = _t(np.concatenate([k["ir"].T, k["iz"].T, k["in"].T]))
    out[f"{prefix}.weight_hh_l0"] = _t(np.concatenate([k["hr"].T, k["hz"].T, k["hn"].T]))
    out[f"{prefix}.bias_ih_l0"] = _t(np.concatenate(
        [np.asarray(p[g]["bias"]) for g in ("ir", "iz", "in")]))
    hn_b = np.asarray(p["hn"]["bias"])
    out[f"{prefix}.bias_hh_l0"] = _t(np.concatenate(
        [np.zeros_like(hn_b), np.zeros_like(hn_b), hn_b]))


_LSTM_GATES = ("i", "f", "g", "o")


def _lstm(p: Tree, prefix: str, out):
    """Flax OptimizedLSTMCell {ii, if, ig, io (no bias), hi, hf, hg, ho}
    -> nn.LSTM layer 0 (gate rows i | f | g | o): the bias goes to
    ``bias_hh_l0`` and ``bias_ih_l0`` is 0 (``layers.LSTMCell``)."""
    out[f"{prefix}.weight_ih_l0"] = _t(np.concatenate(
        [np.asarray(p[f"i{g}"]["kernel"]).T for g in _LSTM_GATES]))
    out[f"{prefix}.weight_hh_l0"] = _t(np.concatenate(
        [np.asarray(p[f"h{g}"]["kernel"]).T for g in _LSTM_GATES]))
    b = np.concatenate([np.asarray(p[f"h{g}"]["bias"]) for g in _LSTM_GATES])
    out[f"{prefix}.bias_hh_l0"] = _t(b)
    out[f"{prefix}.bias_ih_l0"] = _t(np.zeros_like(b))


def lstm_cell_params(sd: Mapping[str, Any], prefix: str) -> Dict[str, Any]:
    """An ``nn.LSTM`` layer 0 of ``sd`` -> flax OptimizedLSTMCell params
    (numpy): the inverse of ``_lstm``. The two biases add up into the
    hidden-side one, as torch adds them."""
    w_ih = np.asarray(sd[f"{prefix}.weight_ih_l0"])
    w_hh = np.asarray(sd[f"{prefix}.weight_hh_l0"])
    b = np.asarray(sd[f"{prefix}.bias_hh_l0"]) + np.asarray(sd[f"{prefix}.bias_ih_l0"])
    h = w_hh.shape[1]
    out: Dict[str, Any] = {}
    for k, g in enumerate(_LSTM_GATES):
        rows = slice(k * h, (k + 1) * h)
        out[f"i{g}"] = {"kernel": w_ih[rows].T}
        out[f"h{g}"] = {"kernel": w_hh[rows].T, "bias": b[rows]}
    return out


def _mlp(p: Tree, prefix: str, out):
    """MLP {dense_i} -> Sequential with the Linears at even indices."""
    for i in range(len(p)):
        _dense(p[f"dense_{i}"], f"{prefix}.{2 * i}", out)


def odom_state_dict_from_jax(params: Tree,
                             stats: Optional[Tuple[Sequence[float], Sequence[float]]] = None
                             ) -> Dict[str, torch.Tensor]:
    """OdomNet params (``{"core": {cell, head[, emb]}}``) + the (mean, std)
    of the odometry -> ``OdomModel`` state_dict (``rnn.*``, ``out.*``,
    ``inp_emb.*``, ``odom_mean``/``odom_std``)."""
    core = params["core"]
    out: Dict[str, torch.Tensor] = {}
    _gru(core["cell"], "rnn", out)
    _mlp(core["head"], "out", out)
    if "emb" in core:
        _mlp(core["emb"], "inp_emb", out)
    mean, std = stats if stats is not None else (np.zeros(2), np.ones(2))
    out["odom_mean"] = _t(np.asarray(mean, np.float32).reshape(-1))
    out["odom_std"] = _t(np.asarray(std, np.float32).reshape(-1))
    return out


def _traj_head(p: Tree, prefix: str, out):
    """_TrajOutHead {hidden_i, out} -> Linear or Sequential (Linear at
    even indices)."""
    n_hidden = sum(1 for k in p if k.startswith("hidden_"))
    if n_hidden == 0:
        _dense(p["out"], prefix, out)
        return
    for i in range(n_hidden):
        _dense(p[f"hidden_{i}"], f"{prefix}.{2 * i}", out)
    _dense(p["out"], f"{prefix}.{2 * n_hidden}", out)


def fg_state_dict_from_jax(params: Tree,
                           stats: Optional[Mapping[str, Tuple[Sequence[float], Sequence[float]]]] = None
                           ) -> Dict[str, torch.Tensor]:
    """FGCore params (+ {"traj"|"depth"|"odom": (mean, std)}) -> ``FGModel``
    state_dict, for a GRU or LSTM (``rnn_type``) trajectory RNN. The
    instance-feature dense is reordered from the JAX (h, w, c) flattening
    to the reference's c-major one. Submodules an ablation leaves unused
    (``traj_feat_out``; ``instance_compressor`` and
    ``instance_feat_model``) have no parameters in JAX and no entries
    here."""
    out: Dict[str, torch.Tensor] = {}
    for side in ("traj_encoder", "traj_decoder"):
        (_lstm if "ii" in params[side] else _gru)(params[side], side, out)
    for side in ("traj_encoder_out", "traj_decoder_out"):
        _traj_head(params[side], side, out)
    if "traj_feat_out" in params:
        _dense(params["traj_feat_out"], "traj_feat_out", out)
    for name in ("mask_encoder_out", "mask_decoder_out"):
        _conv_params(params[name], name, out)
    if "instance_compressor" in params:
        _conv_params(params["instance_compressor"], "instance_compressor", out)
        c = np.asarray(params["instance_compressor"]["kernel"]).shape[-1]
        k = np.asarray(params["instance_feat_model"]["kernel"])
        hw = math.isqrt(k.shape[0] // c)
        k = k.reshape(hw, hw, c, -1).transpose(2, 0, 1, 3).reshape(c * hw * hw, -1)
        _dense(dict(params["instance_feat_model"], kernel=k),
               "instance_feat_model", out)
    for side in ("mask_encoder", "mask_decoder"):
        for cell, p in params[side].items():
            i = int(cell.split("_")[-1])
            _conv_params(p["conv"], f"{side}.cell_list.{i}.conv", out)
    mh = params["mask_head"]
    for k_ in range(1, 5):
        _conv_params(mh[f"mask_fcn{k_}"], f"mask_head.mask_fcn{k_}", out)
    # flax ConvTranspose kernel (kh, kw, I, O), spatially flipped against
    # torch's (I, O, kh, kw) (torch_import.deconv_kernel).
    dk = np.asarray(mh["deconv"]["kernel"])
    out["mask_head.deconv.weight"] = _t(dk.transpose(2, 3, 0, 1)[:, :, ::-1, ::-1])
    out["mask_head.deconv.bias"] = _t(mh["deconv"]["bias"])
    _conv_params(mh["predictor"], "mask_head.predictor", out)
    stats = dict(stats or {})
    for name, dim in (("traj", 8), ("depth", 2), ("odom", 5)):
        mean, std = stats.get(name, (np.zeros(dim), np.ones(dim)))
        out[f"{name}_mean"] = _t(np.asarray(mean, np.float32).reshape(-1))
        out[f"{name}_std"] = _t(np.asarray(std, np.float32).reshape(-1))
    return out


def _optax_states(state) -> Iterator[Any]:
    """Every NamedTuple inside an optax state (chains and
    ``inject_hyperparams`` nest them in tuples)."""
    if hasattr(state, "_fields"):
        yield state
        children = [getattr(state, f) for f in state._fields]
    elif isinstance(state, (tuple, list)):
        children = state
    else:
        return
    for c in children:
        yield from _optax_states(c)


def opt_state_from_jax(opt_state: Any,
                       to_state_dict: Callable[[Tree], Dict[str, torch.Tensor]],
                       names: Sequence[str],
                       param_groups: Sequence[Dict[str, Any]]) -> Dict[str, Any]:
    """An optax state -> the ``state_dict`` of the port's optimizer
    (``train/optim.py``: torch Adam, AdamW or SGD over the parameters
    ``names``, in ``model.named_parameters()`` order).

    Adam's ``mu``/``nu``/``count`` become ``exp_avg``/``exp_avg_sq``/
    ``step`` and SGD's momentum ``trace`` the ``momentum_buffer``; each
    tree goes through ``to_state_dict`` (``odom_state_dict_from_jax`` or
    ``fg_state_dict_from_jax``, permutations of the entries; for bg
    ``lambda t: bg_state_dict_from_jax({"params": t})``), so the GRU's
    hidden-side r/z entries, which JAX does not have, are 0.
    ``param_groups`` is the optimizer's own (``state_dict()["param_groups"]``).
    """
    found = list(_optax_states(opt_state))
    adam = [s for s in found if {"mu", "nu", "count"} <= set(s._fields)]
    trace = [s for s in found if "trace" in s._fields]
    state: Dict[int, Dict[str, torch.Tensor]] = {}
    if adam:
        s = adam[0]
        mu, nu = to_state_dict(s.mu), to_state_dict(s.nu)
        step = torch.tensor(float(np.asarray(s.count)))
        for i, n in enumerate(names):
            state[i] = {"step": step.clone(), "exp_avg": mu[n], "exp_avg_sq": nu[n]}
    elif trace:
        buf = to_state_dict(trace[0].trace)
        for i, n in enumerate(names):
            state[i] = {"momentum_buffer": buf[n]}
    return {"state": state, "param_groups": [dict(g) for g in param_groups]}
