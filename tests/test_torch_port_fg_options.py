"""Port parity of the fg model options in f32: ``rnn_type: lstm``, the
ablations ``only_loc_feats`` (alone and with ``use_depth_inp``),
``no_traj_inst_feats``, ``no_mask_traj_feats`` and
``only_input_odometry``, and ``use_bbox_ulbr``.

Each option goes through the same fixture and weights in both packages
(the JAX ``FGModel`` initialised from a seed, carried over by
``models/convert.py``), held as ``tests/test_torch_port_fg.py`` and
``tests/test_torch_port_train_fg.py`` hold the GRU: the forecast's
trajectories to rtol 1e-5 and atol 1e-5, masks and mask features to
atol 1e-4; the loss and every metric of a training batch to rtol 2e-5;
for the LSTM one step's gradients to 1e-4 of each tensor's largest
entry, and its input-side bias ``bias_ih_l0`` 0 through Adam with
weight decay. ``use_bbox_ulbr`` and ``only_loc_feats`` also go through
the track dataset, fusion's box and depth selection and the forecast
step (boxes within 1e-4, ids equal, panoptic maps off on < 1e-3 of
pixels).

JAX's own ``FGCore`` cannot run a decoder without odometry under this
JAX: its decoder ``nn.scan`` gets ``in_axes=None`` and ``xs=None`` and
raises "Expected None, got (None,)" (JAX models/fg.py:224-233). So this
module hands the JAX decoder an odometry stream of width 0 where it
would get none (``_jax_decoder_without_odometry``): the concat then adds
nothing, which is the function JAX's code describes. The port has no
such fault.
"""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from panoptic_forecasting_tpu.core import build_dataset as jax_build_dataset
from panoptic_forecasting_tpu.core import build_model as jax_build_model
from panoptic_forecasting_tpu.eval import fusion as jax_fusion
from panoptic_forecasting_tpu.eval.forecast import build_forecast_step as jax_step
from panoptic_forecasting_tpu.models.bg import BGModel as JaxBGModel
from panoptic_forecasting_tpu.models.reference_import import fg_from_reference
from panoptic_forecasting_tpu.train.optim import build_optimizer as jax_build_optimizer
from panoptic_forecasting_tpu_torch.core import build_dataset, build_model
from panoptic_forecasting_tpu_torch.core import checkpoint as ckpt
from panoptic_forecasting_tpu_torch.eval import fusion
from panoptic_forecasting_tpu_torch.eval.forecast import build_forecast_step
from panoptic_forecasting_tpu_torch.models.bg import BGModel
from panoptic_forecasting_tpu_torch.models.convert import (
    bg_state_dict_from_jax,
    fg_state_dict_from_jax,
    lstm_cell_params,
)
from panoptic_forecasting_tpu_torch.train.loop import to_device
from panoptic_forecasting_tpu_torch.train.optim import build_optimizer
from test_torch_port_common import fg_fixture, port_fg
from test_torch_port_forecast import BG_CFG, slice_inputs
from test_torch_port_train_fg import METRICS, _jax_grads, fg_train_cfg, roots  # noqa: F401

torch.set_num_threads(2)

# {name: (model overrides, top-level overrides)}
OPTIONS = {
    "lstm": ({"rnn_type": "lstm"}, {}),
    "only_loc_feats": ({"only_loc_feats": True, "use_depth_inp": False}, {}),
    "only_loc_feats_depth": ({"only_loc_feats": True}, {}),
    "no_traj_inst_feats": ({"no_traj_inst_feats": True}, {}),
    "no_mask_traj_feats": ({"no_mask_traj_feats": True}, {}),
    "only_input_odometry": ({"only_input_odometry": True}, {}),
    "use_bbox_ulbr": ({}, {"use_bbox_ulbr": True}),
}
# Options the box and depth selection of fusion and the step read.
BOX_OPTIONS = ("use_bbox_ulbr", "only_loc_feats_depth")


@pytest.fixture(scope="module", autouse=True)
def _jax_decoder_without_odometry():
    from panoptic_forecasting_tpu.models.fg import FGCore

    call = FGCore.__call__

    def patched(self, enc_traj_inp, feats, odom_out, out_t):
        if odom_out is None:
            odom_out = jnp.zeros((enc_traj_inp.shape[0], out_t, 0), enc_traj_inp.dtype)
        return call(self, enc_traj_inp, feats, odom_out, out_t)

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(FGCore, "__call__", patched)
        yield


@pytest.fixture(scope="module", params=sorted(OPTIONS))
def option(request, tmp_path_factory):
    model, top = OPTIONS[request.param]
    root = str(tmp_path_factory.mktemp("fgopt"))
    return request.param, fg_fixture(root, model, top)


def _flat_inputs(batch):
    def f(x):
        x = np.asarray(x)
        return x.reshape((-1,) + x.shape[2:])

    inputs = {k: f(v) for k, v in batch["inputs"].items()
              if k not in ("background", "valid")}
    inputs["output_inds"] = f(batch["labels"]["output_inds"])
    return inputs, int(np.asarray(batch["labels"]["trajectories"]).shape[2])


def test_fg_option_forward_matches_jax(option):
    name, (cfg, jax_model, variables, batch) = option
    inputs, out_t = _flat_inputs(batch)
    ref = jax.jit(lambda v, i: jax_model.forward(v, i, out_t))(
        variables, {k: jnp.asarray(v) for k, v in inputs.items()})
    model = port_fg(cfg, jax_model, variables)
    out = model(inputs, out_t)
    d = model.traj_dim + model.depth_dim
    assert out["unnormalized_trajectory"].shape[-1] == d
    np.testing.assert_allclose(out["unnormalized_trajectory"].numpy(),
                               np.asarray(ref["unnormalized_trajectory"]),
                               rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(out["normalized_trajectory"].numpy(),
                               np.asarray(ref["normalized_trajectory"]),
                               rtol=0, atol=1e-5)
    np.testing.assert_allclose(out["masks"].numpy(), np.asarray(ref["masks"]),
                               rtol=0, atol=1e-4)
    np.testing.assert_allclose(out["mask_feats"].numpy(),
                               np.asarray(ref["mask_feats"]), rtol=0, atol=1e-4)


def test_fg_option_bridge_carries_every_parameter(option):
    """The port holds exactly the parameters JAX creates for the option
    (an ablation's unused submodules have none), and for the LSTM
    ``lstm_cell_params`` inverts the bridge bit for bit; the rest goes
    back through the JAX package's importer."""
    name, (cfg, jax_model, variables, _) = option
    params = variables["params"]
    model = port_fg(cfg, jax_model, variables)
    sd = model.state_dict()
    n_jax = sum(np.asarray(x).size for x in jax.tree_util.tree_leaves(params))
    # the frozen biases (a GRU's hidden r/z, an LSTM's input side) have
    # no counterpart in flax
    frozen = sum(p[sl].numel() for cell in (model.traj_encoder, model.traj_decoder)
                 for p, sl in cell.frozen())
    assert sum(p.numel() for p in model.parameters()) == n_jax + frozen
    if name != "lstm":
        return
    for side in ("traj_encoder", "traj_decoder"):
        back = lstm_cell_params(sd, side)
        assert sorted(back) == sorted(params[side])
        for gate, p in params[side].items():
            assert sorted(back[gate]) == sorted(p)
            for k, v in p.items():
                np.testing.assert_array_equal(back[gate][k], v, err_msg=f"{side}.{gate}")
    # The JAX importer reads a GRU: hand it zeros of a GRU's shapes in the
    # two RNN slots and compare everything else.
    gru_free = dict(sd)
    h = model.traj_encoder.hidden
    for side in ("traj_encoder", "traj_decoder"):
        n_in = sd[f"{side}.weight_ih_l0"].shape[1]
        for k, shape in (("weight_ih_l0", (3 * h, n_in)), ("weight_hh_l0", (3 * h, h)),
                         ("bias_ih_l0", (3 * h,)), ("bias_hh_l0", (3 * h,))):
            gru_free[f"{side}.{k}"] = torch.zeros(shape)
    back, _ = fg_from_reference(gru_free, instance_feat_channels=8, feat_hw=7)
    for path, leaf in jax.tree_util.tree_leaves_with_path(params):
        if path[0].key in ("traj_encoder", "traj_decoder"):
            continue
        got = back
        for p in path:
            got = got[p.key]
        np.testing.assert_array_equal(np.asarray(got), leaf, err_msg=str(path))


def _option_train_cfg(root, name):
    model, top = OPTIONS[name]
    cfg = fg_train_cfg(root)
    cfg["model"].update(model)
    cfg.update(top)
    return cfg


def _first_batches(roots, name):
    jax_root, port_root = roots
    jcfg, cfg = _option_train_cfg(jax_root, name), _option_train_cfg(port_root, name)
    jax_data, data = jax_build_dataset(jcfg), build_dataset(cfg)
    jbatch = next(iter(jax_data.loader("train", jcfg, seed=0)))
    batch = next(iter(data.loader("train", cfg, seed=0)))
    return jcfg, cfg, jax_data, data, jbatch, batch


@pytest.mark.parametrize("name", sorted(OPTIONS))
def test_fg_option_loss_and_metrics_match_jax(roots, name):
    """The track dataset's first training batch (equal in both packages,
    ulbr boxes too) and the loss and metrics on it, from JAX's init."""
    jcfg, cfg, jax_data, data, jbatch, batch = _first_batches(roots, name)
    for part in ("inputs", "labels"):
        for k, v in batch[part].items():
            np.testing.assert_array_equal(v, jbatch[part][k], err_msg=k)
    jax_model = jax_build_model(jcfg, jax_data.card)
    params = jax.tree_util.tree_map(np.asarray, jax.jit(
        lambda r: jax_model.init(r, jbatch))(jax.random.PRNGKey(0))["params"])
    jbatch = {k: v for k, v in jbatch.items() if k != "meta"}
    jloss, jmetrics = jax.jit(lambda p: jax_model.loss(p, {}, jbatch, None)[:2])(params)
    model = build_model(cfg, data.card, "cpu")
    ckpt.load_weights(model, fg_state_dict_from_jax(params))
    with torch.no_grad():
        loss, metrics = model.loss(to_device(batch, torch.device("cpu")))
    want = METRICS if cfg["model"].get("use_depth_inp") else METRICS[:4] + METRICS[5:]
    assert sorted(metrics) == sorted(jmetrics) == sorted(want)
    np.testing.assert_allclose(float(loss), float(jloss), rtol=2e-5)
    for k in want:
        np.testing.assert_allclose(metrics[k].numpy(), np.asarray(jmetrics[k]),
                                   rtol=2e-5, atol=1e-7, err_msg=k)


def test_lstm_train_step_matches_jax(roots):
    """One LSTM step from JAX's init: the gradients, ``bias_ih_l0``'s
    exactly 0, the parameters after one Adam step (the bound of
    ``tests/test_torch_port_train_fg.py``); then Adam with weight decay
    for more steps leaves ``bias_ih_l0`` at 0."""
    jcfg, cfg, jax_data, data, jbatch, batch = _first_batches(roots, "lstm")
    jax_model = jax_build_model(jcfg, jax_data.card)
    params = jax.tree_util.tree_map(np.asarray, jax.jit(
        lambda r: jax_model.init(r, jbatch))(jax.random.PRNGKey(0))["params"])
    jbatch = {k: v for k, v in jbatch.items() if k != "meta"}
    _, jgrads = _jax_grads(jax_model, params, jbatch)
    opt = jax_build_optimizer(jcfg)
    updates, _ = jax.jit(opt.update)(jgrads, opt.init(params), params)
    jnew = fg_state_dict_from_jax(jax.tree_util.tree_map(
        np.asarray, optax.apply_updates(params, updates)))
    jgrads = fg_state_dict_from_jax(jax.tree_util.tree_map(np.asarray, jgrads))

    model = build_model(cfg, data.card, "cpu").train()
    ckpt.load_weights(model, fg_state_dict_from_jax(params))
    before = {k: v.clone() for k, v in model.state_dict().items()}
    loss, _ = model.loss(to_device(batch, torch.device("cpu")))
    loss.backward()
    for n, p in model.named_parameters():
        if n.startswith("mask_head."):
            assert p.grad is None, n
            continue
        if n.endswith("bias_ih_l0"):
            assert not p.grad.any(), n
            continue
        want = jgrads[n].numpy()
        scale = float(np.abs(want).max())
        np.testing.assert_allclose(p.grad.numpy(), want, rtol=0,
                                   atol=1e-4 * scale + 1e-12, err_msg=n)
    opt = build_optimizer(model, cfg)
    opt.step()
    lr, eps = float(cfg["training"]["lr"]), 1e-8
    for n, p in model.named_parameters():
        if n.endswith("bias_ih_l0"):
            assert not p.any(), n
            continue
        g = jgrads[n].numpy()
        dg = np.abs((p.grad.numpy() if p.grad is not None else 0) - g)
        ulp = 4 * np.spacing(np.maximum(np.abs(before[n].numpy()), lr).astype(np.float32))
        assert np.all(np.abs(p.detach().numpy() - jnew[n].numpy())
                      <= lr * dg / eps + ulp), n

    cfg = dict(cfg, training=dict(cfg["training"], wd=1e-2))
    opt = build_optimizer(model, cfg)
    for _ in range(3):
        opt.zero_grad()
        loss, _ = model.loss(to_device(batch, torch.device("cpu")))
        loss.backward()
        opt.step()
    for cell in (model.traj_encoder, model.traj_decoder):
        assert not cell.bias_ih_l0.any() and cell.bias_hh_l0.any()


@pytest.mark.parametrize("name", BOX_OPTIONS)
def test_fusion_boxes_and_depths_match_jax(tmp_path, name):
    """Fusion's per-instance box (cwh -> ulbr unless ulbr) and depth
    column (4 under ``only_loc_feats``) on the same forecast."""
    model_o, top = OPTIONS[name]
    cfg, jax_model, variables, batch = fg_fixture(str(tmp_path), model_o, top)
    model = port_fg(cfg, jax_model, variables)
    preds = fusion.run_scene_forward(model, batch)
    out_t = int(np.asarray(batch["labels"]["trajectories"]).shape[2])
    inds = batch["labels"]["output_inds"]
    boxes, depths = fusion._pred_boxes_depths(model, preds, inds, out_t)
    jpreds = {k: v.numpy() for k, v in preds.items()}
    jboxes, jdepths = jax_fusion._pred_boxes_depths(jax_model, jpreds, inds, out_t)
    np.testing.assert_array_equal(boxes.numpy(), jboxes)
    np.testing.assert_array_equal(depths.numpy(), jdepths)
    assert depths.abs().sum() > 0


@pytest.mark.parametrize("name", BOX_OPTIONS)
def test_forecast_step_with_box_options_matches_jax(tmp_path, name):
    model_o, top = OPTIONS[name]
    cfg, fg_model, fg_vars, scene_batch = fg_fixture(str(tmp_path), model_o, top)
    pc_in, fg_in, out_t, (h, w) = slice_inputs(scene_batch)
    bg_model = JaxBGModel(BG_CFG)
    init = {"inputs": {k: jnp.asarray(pc_in[k][:1]) for k in ("seg", "depth", "depth_mask")}}
    bg_vars = jax.tree_util.tree_map(np.asarray, jax.jit(
        lambda r: bg_model.init(r, init))(jax.random.PRNGKey(1)))
    ref = jax_step(bg_model, fg_model, height=h, width=w, out_t=out_t)(
        bg_vars, fg_vars, pc_in, fg_in)
    port_bg = BGModel(BG_CFG, device="cpu")
    port_bg.load_state_dict(bg_state_dict_from_jax(bg_vars))
    out = build_forecast_step(port_bg, port_fg(cfg, fg_model, fg_vars), height=h,
                              width=w, out_t=out_t, device="cpu")(pc_in, fg_in)
    np.testing.assert_array_equal(out["ids"].numpy(), np.asarray(ref["ids"]))
    np.testing.assert_allclose(out["bbox"].numpy(), np.asarray(ref["bbox"]),
                               rtol=1e-6, atol=1e-4)
    np.testing.assert_allclose(out["depths"].numpy(), np.asarray(ref["depths"]),
                               rtol=1e-5, atol=1e-5)
    assert np.abs(out["depths"].numpy()).sum() > 0
    mismatch = float((out["panoptic"].numpy() != np.asarray(ref["panoptic"])).mean())
    assert mismatch < 1e-3, f"{mismatch:.2%} pixels differ"
