"""Port parity: the bg model with ``convert2onehot: false`` (raw ids).

JAX feeds each frame's ids as one float channel (then the depth
channels), so the stem conv takes T (+T) channels, and never routes
through the one-hot stem kernel (JAX ``_stem_kernel_on``). The same
seeded variables go to both packages. Inference (eval mode, unfolded
and folded) is held as ``tests/test_torch_port_bg.py`` holds the one-hot
model: logits within 1e-4, the argmax equal where the top-2 gap passes
1e-4; the folded port must not call ``onehot_stem_conv``. One training
step is held as ``tests/test_torch_port_train_bg.py`` holds it, in
float64 on both sides: the loss to rtol 1e-6, each gradient within 1e-4
of its tensor's largest entry, the moved BN statistics to atol 1e-6.
``load_pretrained`` widens a 3-channel stem to the raw-id input as JAX's
``_load_pretrained`` does. Inputs are 64x128, batch 2, from a numpy seed.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from panoptic_forecasting_tpu.models.bg import BGModel as JaxBGModel
from panoptic_forecasting_tpu.models.hardnet import HarDNet as JaxHarDNet
from panoptic_forecasting_tpu_torch.models import bg as bg_module
from panoptic_forecasting_tpu_torch.models import seeded_init_
from panoptic_forecasting_tpu_torch.models.base import init_weights
from panoptic_forecasting_tpu_torch.models.bg import BGModel
from panoptic_forecasting_tpu_torch.models.convert import bg_state_dict_from_jax
from panoptic_forecasting_tpu_torch.models.hardnet import HarDNet
from test_torch_port_bg import _check_logits, _jax_logits, _perturb_stats

torch.set_num_threads(2)

H, W, T, C = 64, 128, 3, 11
MODEL = {"num_inputs": T, "convert2onehot": False, "use_depth_inps": True,
         "stem_kernel": True}
CFG = {"model": MODEL, "data": {"num_classes": C}}
DEPTH_STATS = (20.0, 12.0)


def _jax_model():
    model = JaxBGModel(CFG)
    model.depth_mean, model.depth_std = DEPTH_STATS
    return model


@pytest.fixture(scope="module")
def case():
    rng = np.random.RandomState(0)
    seg = rng.randint(0, C + 2, size=(2, T, H, W)).astype(np.int32)
    depth = (rng.rand(2, T, H, W) * 40).astype(np.float32)
    depth_mask = rng.rand(2, T, H, W) > 0.2
    inputs = {"seg": seg, "depth": depth, "depth_mask": depth_mask}
    jax_model = _jax_model()
    init = {"inputs": {k: jnp.asarray(v[:1]) for k, v in inputs.items()}}
    variables = jax.jit(lambda r: jax_model.init(r, init))(jax.random.PRNGKey(1))
    assert variables["params"]["base_0"]["conv"]["kernel"].shape[2] == 2 * T
    return jax_model, _perturb_stats(variables, rng), inputs


def _port(variables):
    model = BGModel(CFG, depth_stats=DEPTH_STATS, device="cpu")
    model.load_state_dict(bg_state_dict_from_jax(variables, DEPTH_STATS))
    return model


def test_rawid_unfolded_matches_jax(case):
    jax_model, variables, inputs = case
    model = _port(variables)
    assert model.model.base[0].conv.in_channels == 2 * T
    _check_logits(model(inputs).numpy(), _jax_logits(jax_model, variables, inputs))


def test_rawid_folded_matches_jax_without_the_stem_kernel(case, monkeypatch):
    jax_model, variables, inputs = case
    folded_vars = jax.tree_util.tree_map(np.asarray, jax.jit(jax_model.maybe_fold)(variables))

    def refuse(*a, **k):
        raise AssertionError("raw ids must not reach the one-hot stem")

    monkeypatch.setattr(bg_module, "onehot_stem_conv", refuse)
    folded = _port(variables).maybe_fold()
    assert folded.folded
    _check_logits(folded(inputs).numpy(), _jax_logits(jax_model, folded_vars, inputs))


def test_rawid_train_step_matches_jax_float64(case):
    _, variables, inputs = case
    rng = np.random.RandomState(4)
    labels = rng.randint(0, C, (2, H, W)).astype(np.int32)
    labels[:, -5:] = 255
    batch = {"inputs": inputs, "labels": {"seg": labels}}
    with jax.enable_x64(True):
        jax_model = _jax_model()
        jax_model.module = JaxHarDNet(n_classes=C, dtype=jnp.float64)
        v64 = jax.tree_util.tree_map(lambda a: np.asarray(a, np.float64), variables)

        def loss_fn(p, s):
            loss, _, new_s = jax_model.loss(p, s, batch, train=True)
            return loss, new_s

        (loss, new_s), grads = jax.jit(jax.value_and_grad(loss_fn, has_aux=True))(
            v64["params"], {"batch_stats": v64["batch_stats"]})
        grads = jax.tree_util.tree_map(np.asarray, grads)
        new_s = jax.tree_util.tree_map(np.asarray, new_s["batch_stats"])
    model = _port(variables).to(torch.float64).train()
    got, _ = model.loss(batch)
    got.backward()
    np.testing.assert_allclose(float(got.detach()), float(loss), rtol=1e-6)
    want = bg_state_dict_from_jax({"params": grads})
    for n, p in model.named_parameters():
        w = want[n].numpy()
        err = np.abs(p.grad.numpy() - w).max() / np.abs(w).max()
        assert err < 1e-4, (n, err)
    after = bg_state_dict_from_jax({"params": v64["params"], "batch_stats": new_s})
    for k, v in model.state_dict().items():
        if k.endswith(("running_mean", "running_var")):
            np.testing.assert_allclose(v.numpy(), after[k].numpy(), rtol=0,
                                       atol=1e-6, err_msg=k)


def test_rawid_pretrained_stem_widens_as_jax(case, tmp_path):
    """A 3-channel FCHarDNet-70 file: the stem mean-replicated to the
    2·T raw-id and depth inputs, as JAX's ``_load_pretrained``."""
    jax_model, variables, _ = case
    ref = seeded_init_(HarDNet(3, n_classes=C), 5)
    path = str(tmp_path / "hardnet70_cityscapes_model.pkl")
    torch.save({"model_state": {f"module.{k}": v for k, v in ref.state_dict().items()}},
               path)
    jax_model.pretrain_path = path
    try:
        want = bg_state_dict_from_jax(jax.tree_util.tree_map(
            np.asarray, jax_model._load_pretrained(variables)), DEPTH_STATS)
    finally:
        jax_model.pretrain_path = None
    cfg = dict(CFG, model=dict(MODEL, hardnet={"pretrain_path": path}))
    got = init_weights(BGModel(cfg, depth_stats=DEPTH_STATS, device="cpu"), 0).state_dict()
    key = "model.base.0.conv.weight"
    assert got[key].shape == (16, 2 * T, 3, 3)
    np.testing.assert_allclose(got[key].numpy(), want[key].numpy(), rtol=1e-6)
    np.testing.assert_array_equal(got["model.base.1.conv.weight"].numpy(),
                                  want["model.base.1.conv.weight"].numpy())
