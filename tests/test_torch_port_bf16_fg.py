"""Port parity: the fg model with ``model.compute_dtype: bfloat16``.

JAX runs the ConvLSTM branch in bf16 (f32 parameters; the conv over
``concat([x, h]).astype(bf16)`` with its bias in bf16, bf16 gates, the
f32 cell state) and keeps the trajectory GRUs, the heads and
``mask_{en,de}coder_out`` in f32; so does the port. The yardstick is the
one of ``tests/test_torch_port_bf16_bg.py``: the relative L2 distance of
the port's bf16 result from JAX's bf16 result must not pass that of
JAX's bf16 result from JAX's f32 one. It holds the forecast's
trajectories, masks and mask features (the scene fixture of
``tests/test_torch_port_fg.py``, narrow widths, both depths), and the
loss and the weight gradients of one training step (the track batch of
``tests/test_torch_port_train_fg.py``); the bias gradients, which ReLU
flips at bf16 rounding move, are held as the test states. The
parameters and their gradients stay f32.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from panoptic_forecasting_tpu.core import build_dataset as jax_build_dataset
from panoptic_forecasting_tpu.core import build_model as jax_build_model
from panoptic_forecasting_tpu_torch.core import build_dataset, build_model
from panoptic_forecasting_tpu_torch.core import checkpoint as ckpt
from panoptic_forecasting_tpu_torch.models.convert import fg_state_dict_from_jax
from panoptic_forecasting_tpu_torch.train.loop import to_device
from test_torch_port_common import fg_fixture, port_fg
from test_torch_port_fg_options import _flat_inputs
from test_torch_port_train_fg import METRICS, _jax_grads, fg_train_cfg, roots  # noqa: F401

torch.set_num_threads(2)

BF16 = {"compute_dtype": "bfloat16"}
DEPTHS = {"narrow": {}, "deep": {"num_convlstm_layers": 2, "num_traj_out_layers": 2}}


def _rel(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.linalg.norm(a - b) / np.linalg.norm(b))


def _yardstick(what, port, j16, j32):
    d_port, d_jax = _rel(port, j16), _rel(j16, j32)
    assert d_port <= d_jax, f"{what}: port-jax bf16 {d_port} > jax bf16-f32 {d_jax}"


@pytest.mark.parametrize("depth", sorted(DEPTHS))
def test_bf16_fg_forward_matches_jax(tmp_path, depth):
    cfg, j16, variables, batch = fg_fixture(str(tmp_path), dict(DEPTHS[depth], **BF16))
    cfg32 = dict(cfg, model={k: v for k, v in cfg["model"].items()
                             if k != "compute_dtype"})
    j32 = jax_build_model(cfg32, None)
    j32.__dict__.update({k: v for k, v in j16.__dict__.items() if k.endswith(("_mean", "_std"))})
    inputs, out_t = _flat_inputs(batch)
    jin = {k: jnp.asarray(v) for k, v in inputs.items()}
    ref16 = jax.jit(lambda v, i: j16.forward(v, i, out_t))(variables, jin)
    ref32 = jax.jit(lambda v, i: j32.forward(v, i, out_t))(variables, jin)

    model = port_fg(cfg, j16, variables)
    out = model(inputs, out_t)
    assert all(cell.dtype == torch.bfloat16 for m in (model.mask_encoder, model.mask_decoder)
               for cell in m.cell_list)
    assert {p.dtype for p in model.parameters()} == {torch.float32}
    for key in ("unnormalized_trajectory", "masks", "mask_feats"):
        assert out[key].dtype == torch.float32
        _yardstick(key, out[key].numpy(), ref16[key], ref32[key])
    f32 = port_fg(cfg32, j32, variables)(inputs, out_t)
    assert (out["mask_feats"] - f32["mask_feats"]).abs().max() > 1e-4


def test_bf16_fg_train_step_matches_jax(roots):
    """One training step from JAX's init: the loss and every metric, and
    the gradients of every parameter the loss reaches, taken together."""
    jax_root, port_root = roots
    steps = {}
    for dtype in ("bf16", "f32"):
        jcfg = fg_train_cfg(jax_root)
        if dtype == "bf16":
            jcfg["model"].update(BF16)
        jax_data = jax_build_dataset(jcfg)
        jax_model = jax_build_model(jcfg, jax_data.card)
        jbatch = next(iter(jax_data.loader("train", jcfg, seed=0)))
        if dtype == "bf16":  # the one init both dtypes start from
            params = jax.tree_util.tree_map(np.asarray, jax.jit(
                lambda r: jax_model.init(r, jbatch))(jax.random.PRNGKey(0))["params"])
        jbatch = {k: v for k, v in jbatch.items() if k != "meta"}
        (loss, metrics), grads = _jax_grads(jax_model, params, jbatch)
        steps[dtype] = (float(loss), jax.tree_util.tree_map(np.asarray, metrics),
                        fg_state_dict_from_jax(jax.tree_util.tree_map(np.asarray, grads)))

    cfg = fg_train_cfg(port_root)
    cfg["model"].update(BF16)
    data = build_dataset(cfg)
    batch = next(iter(data.loader("train", cfg, seed=0)))
    model = build_model(cfg, data.card, "cpu").train()
    ckpt.load_weights(model, fg_state_dict_from_jax(params))
    loss, metrics = model.loss(to_device(batch, torch.device("cpu")))
    loss.backward()

    (l16, m16, g16), (l32, m32, g32) = steps["bf16"], steps["f32"]
    _yardstick("loss", float(loss.detach()), l16, l32)
    for k in ("loss", "mask_distill_loss"):
        _yardstick(k, metrics[k].detach().numpy(), m16[k], m32[k])
    # The trajectory metrics see bf16 only through the instance features
    # (JAX's bf16 moves them ~1e-5 relative, as far as f32 rounding in
    # another order does), so they are held to f32 tolerances.
    for k in METRICS:
        np.testing.assert_allclose(metrics[k].detach().numpy(), m16[k],
                                   rtol=1e-4, atol=1e-6, err_msg=k)
    names = [n for n, p in model.named_parameters() if p.grad is not None]
    assert all(model.get_parameter(n).grad.dtype == torch.float32 for n in names)
    assert not any(n.startswith("mask_head.") for n in names)
    weights = [n for n in names if not n.endswith("bias")]

    def stacked(grads, keys):
        return np.concatenate([np.asarray(grads[k]).ravel() for k in keys])

    port = {n: model.get_parameter(n).grad.numpy() for n in names}
    _yardstick("weight gradients", stacked(port, weights),
               stacked({n: g16[n].numpy() for n in weights}, weights),
               stacked({n: g32[n].numpy() for n in weights}, weights))
    # A bias gradient is a sum over positions with much cancellation, and
    # a ReLU whose input lies within bf16 rounding of 0 flips with the
    # rounding (4 of the 1568 inputs of the decoder's instance compressor
    # here; with the f32 run's ReLU masks forced, the port's bf16 bias
    # gradients are within 6e-3 of its f32 ones): the port's bf16 and
    # JAX's bf16 flip different ones, which moves a bias gradient by up to
    # 12 %. So each bias gradient is held within 0.15 of JAX's bf16 one
    # (relative L2).
    for n in names:
        if n.endswith("bias"):
            assert _rel(port[n], g16[n].numpy()) < 0.15, n
