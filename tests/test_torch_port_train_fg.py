"""Port parity of fg training: the fixture's track tables, the track
dataset ``FGInstanceDataset`` and its card, fg ``loss`` with its metrics,
the gradients of one step from JAX's init and the parameters after one
Adam step, and the detectron2 mask-head loader.

Both packages' ``data/synthetic.py::write_fg_fixture`` write the fixture
(narrow: 32 channels of 7x7 features); the JAX ``FGModel`` initialises
the weights from a seed (under ``jax.jit``) and ``models/convert.py``
carries them across. Tolerances: tables, samples, batches and card
statistics exactly; the loss and each metric to rtol 2e-5 (f32 sums of
a recurrent rollout in another order); each gradient to rtol 1e-4 of the
largest entry of its tensor; the GRUs' hidden-side r/z bias gradients
exactly 0; after one Adam step each parameter within
lr · |Δg| / eps + 4 ulp of max(|p|, lr) of JAX's (an Adam first step is
lr · g / (|g| + eps), whose slope in g is at most 1/eps), and the mask
head, which no gradient reaches, bit-unchanged.
"""

import os
import pickle

import jax
import numpy as np
import optax
import pandas as pd
import pytest
import torch

from panoptic_forecasting_tpu.core import build_dataset as jax_build_dataset
from panoptic_forecasting_tpu.core import build_model as jax_build_model
from panoptic_forecasting_tpu.data.synthetic import write_fg_fixture as jax_write_fg_fixture
from panoptic_forecasting_tpu.models.reference_import import fg_from_reference
from panoptic_forecasting_tpu.models.torch_import import (
    load_maskrcnn_head_pickle as jax_load_maskrcnn_head_pickle,
)
from panoptic_forecasting_tpu.train.optim import build_optimizer as jax_build_optimizer
from panoptic_forecasting_tpu_torch.core import build_dataset, build_model
from panoptic_forecasting_tpu_torch.core import checkpoint as ckpt
from panoptic_forecasting_tpu_torch.data import synthetic
from panoptic_forecasting_tpu_torch.models.base import init_weights
from panoptic_forecasting_tpu_torch.models.convert import fg_state_dict_from_jax
from panoptic_forecasting_tpu_torch.models.torch_import import load_maskrcnn_head_pickle
from panoptic_forecasting_tpu_torch.train.loop import to_device
from panoptic_forecasting_tpu_torch.train.optim import build_optimizer

from test_torch_port_common import FG_MODEL

torch.set_num_threads(2)

FG_TRAIN_MODEL = dict(FG_MODEL, num_convlstm_layers=2, num_traj_out_layers=2,
                      traj_coef=0.1, mask_distill_coef=1.0)
METRICS = ("traj_2d_loss", "center_pixel_l2", "center_pixel_fde",
           "size_pixel_l1", "depth_l2", "mask_distill_loss", "loss")
SCENE_TABLES = ("seq_meta", "depth_seq_info", "3d_info")


def fg_train_cfg(root, **data):
    """configs/fg/fg_train.yaml's data and training keys on a fixture at
    ``root``, narrow model widths, batch 4."""
    return {
        "task": "fg", "seed": 0, "working_dir": os.path.join(root, "run"),
        "data": dict({
            "dataset_type": "fg_instance", "data_splits": ["train", "val"],
            "data_dir": root, "depth_dir": root, "feats_dir": root,
            "info_3d_dir": root, "expand_train": True,
            "add_car_offscreen_loc": True, "filter_car_gap": 20,
            "filter_car_gap_borderdist": 250, "input_len": 3,
            "max_depth": 200, "require_most_recent": True, "use_3d_info": True,
        }, **data),
        "model": dict(FG_TRAIN_MODEL),
        "training": {"batch_size": 4, "clip_grad_norm": 5.0, "lr": 1e-3,
                     "use_adam": True, "steps_per_epoch": 2, "num_epochs": 1,
                     "num_data_threads": 0},
    }


@pytest.fixture(scope="module")
def roots(tmp_path_factory):
    """(JAX fixture dir, port fixture dir), the same content."""
    jax_root = str(tmp_path_factory.mktemp("fg_jax"))
    port_root = str(tmp_path_factory.mktemp("fg_port"))
    kw = dict(n_scenes=3, max_instances=3, feat_channels=32, feat_hw=7)
    jax_write_fg_fixture(jax_root, **kw)
    synthetic.write_fg_fixture(port_root, **kw)
    return jax_root, port_root


def _rows(path):
    return pd.read_pickle(path).to_dict("records")


def _assert_rows_equal(got, want, what):
    assert len(got) == len(want), what
    for a, b in zip(got, want):
        assert sorted(a) == sorted(b), what
        for k in a:
            np.testing.assert_array_equal(np.asarray(a[k]), np.asarray(b[k]),
                                          err_msg=f"{what}: {k}")


def test_fixture_track_tables_match_jax(roots):
    jax_root, port_root = roots
    for split in ("train", "val"):
        for name in ("instance_meta", "depth_instance_info") + SCENE_TABLES:
            f = f"{split}_{name}.pkl"
            _assert_rows_equal(_rows(os.path.join(port_root, f)),
                               _rows(os.path.join(jax_root, f)), f)
        import h5py

        with h5py.File(os.path.join(port_root, f"{split}_feats.h5")) as a, \
                h5py.File(os.path.join(jax_root, f"{split}_feats.h5")) as b:
            keys = []
            a.visit(lambda k: keys.append(k) if isinstance(a[k], h5py.Dataset) else None)
            assert keys and len(keys) == len(b["synthcity"])
            for k in keys:
                np.testing.assert_array_equal(a[k][()], b[k][()])


@pytest.mark.parametrize("expand_train", [True, False])
def test_instance_dataset_matches_jax(roots, expand_train):
    jax_root, port_root = roots
    jax_data = jax_build_dataset(fg_train_cfg(jax_root, expand_train=expand_train))
    data = build_dataset(fg_train_cfg(port_root, expand_train=expand_train))
    for name in ("traj", "depth", "odom"):
        for kind in ("mean", "std"):
            np.testing.assert_array_equal(data.card.stats[name][kind],
                                          jax_data.card.stats[name][kind])
    assert data.card.num_classes == jax_data.card.num_classes
    for split in ("train", "val"):
        ds, ref = data.datasets[split], jax_data.datasets[split]
        assert len(ds) == len(ref) > 0
        for i in range(len(ds)):
            a, b = ds[i], ref[i]
            for part in ("inputs", "labels"):
                assert sorted(a[part]) == sorted(b[part])
                for k in a[part]:
                    assert a[part][k].dtype == b[part][k].dtype, k
                    np.testing.assert_array_equal(a[part][k], b[part][k], err_msg=k)
            assert {k: v for k, v in a["meta"].items()} == dict(b["meta"])


def test_instance_dataset_rejects_condensed_feats(tmp_path):
    """``use_condensed_feats`` is read, no longer refused: the track
    dataset on the condensed copies equals JAX's and its plain self."""
    root = str(tmp_path / "fg")
    store = synthetic.write_fg_fixture(root, n_scenes=3, max_instances=3,
                                       feat_channels=32, feat_hw=7)
    synthetic.write_condensed_feats(root, store)
    cfg = fg_train_cfg(root, use_condensed_feats=True)
    got, want = build_dataset(cfg), jax_build_dataset(cfg)
    plain = build_dataset(fg_train_cfg(root))
    for split in ("train", "val"):
        ds, ref, base = (d.datasets[split] for d in (got, want, plain))
        assert len(ds) == len(ref) == len(base) > 0
        for i in range(len(ds)):
            np.testing.assert_array_equal(ds[i]["inputs"]["feats"], ref[i]["inputs"]["feats"])
            np.testing.assert_array_equal(ds[i]["inputs"]["feats"], base[i]["inputs"]["feats"])


def _jax_grads(model, params, batch):
    def loss_fn(p):
        mean, metrics, _ = model.loss(p, {}, batch, None, train=True)
        return mean, metrics

    return jax.jit(jax.value_and_grad(loss_fn, has_aux=True))(params)


@pytest.fixture(scope="module")
def one_step(roots):
    """The first training batch of both packages, one step from JAX's
    init in each: JAX (loss, metrics, grads, params after Adam) and the
    port's (loss, metrics, {name: grad}, model after Adam, before)."""
    jax_root, port_root = roots
    jcfg, cfg = fg_train_cfg(jax_root), fg_train_cfg(port_root)
    jax_data = jax_build_dataset(jcfg)
    jax_model = jax_build_model(jcfg, jax_data.card)
    jbatch = next(iter(jax_data.loader("train", jcfg, seed=0)))
    data = build_dataset(cfg)
    batch = next(iter(data.loader("train", cfg, seed=0)))
    variables = jax.jit(lambda r: jax_model.init(r, jbatch))(jax.random.PRNGKey(0))
    params = jax.tree_util.tree_map(np.asarray, variables["params"])

    jbatch = {k: v for k, v in jbatch.items() if k != "meta"}
    (jloss, jmetrics), jgrads = _jax_grads(jax_model, params, jbatch)
    opt = jax_build_optimizer(jcfg)
    updates, _ = jax.jit(opt.update)(jgrads, opt.init(params), params)
    jnew = optax.apply_updates(params, updates)

    model = build_model(cfg, data.card, "cpu")
    ckpt.load_weights(model, fg_state_dict_from_jax(params))
    before = {k: v.clone() for k, v in model.state_dict().items()}
    model.train()
    loss, metrics = model.loss(to_device(batch, torch.device("cpu")))
    loss.backward()
    grads = {n: None if p.grad is None else p.grad.clone()
             for n, p in model.named_parameters()}
    build_optimizer(model, cfg).step()
    return {
        "batches": (jbatch, batch),
        "jax": (float(jloss), jax.tree_util.tree_map(np.asarray, jmetrics),
                fg_state_dict_from_jax(jax.tree_util.tree_map(np.asarray, jgrads)),
                fg_state_dict_from_jax(jax.tree_util.tree_map(np.asarray, jnew))),
        "port": (float(loss.detach()), {k: v.detach().numpy() for k, v in metrics.items()},
                 grads, model, before),
    }


def test_first_training_batch_matches_jax(one_step):
    jbatch, batch = one_step["batches"]
    for part in ("inputs", "labels"):
        assert sorted(jbatch[part]) == sorted(batch[part])
        for k, v in batch[part].items():
            np.testing.assert_array_equal(v, jbatch[part][k], err_msg=k)


def test_fg_loss_and_metrics_match_jax(one_step):
    jloss, jmetrics = one_step["jax"][:2]
    loss, metrics = one_step["port"][:2]
    assert sorted(metrics) == sorted(METRICS) == sorted(jmetrics)
    np.testing.assert_allclose(loss, jloss, rtol=2e-5)
    for k in METRICS:
        assert metrics[k].shape == (4,), k
        np.testing.assert_allclose(metrics[k], jmetrics[k], rtol=2e-5, atol=1e-7,
                                   err_msg=k)


def test_fg_gradients_match_jax(one_step):
    jgrads = one_step["jax"][2]
    grads, model = one_step["port"][2], one_step["port"][3]
    names = [n for n, _ in model.named_parameters()]
    assert set(names) <= set(jgrads)
    for n in names:
        g = grads[n]
        if n.startswith("mask_head."):  # the loss does not reach the mask head
            assert g is None, n
            assert not np.any(jgrads[n].numpy()), n
            continue
        want = jgrads[n].numpy()
        scale = float(np.abs(want).max())
        np.testing.assert_allclose(g.numpy(), want, rtol=0, atol=1e-4 * scale + 1e-12,
                                   err_msg=n)
    for gru in ("traj_encoder", "traj_decoder"):
        h = getattr(model, gru).hidden
        g = grads[f"{gru}.bias_hh_l0"]
        assert torch.count_nonzero(g[: 2 * h]) == 0, gru
        assert torch.count_nonzero(g[2 * h:]) > 0, gru


def test_fg_adam_step_matches_jax(one_step):
    jgrads, jnew = one_step["jax"][2:]
    grads, model, before = one_step["port"][2:]
    lr, eps = 1e-3, 1e-8
    after = model.state_dict()
    for n, _ in model.named_parameters():
        got, want = after[n].numpy(), jnew[n].numpy()
        if n.startswith("mask_head."):
            assert torch.equal(after[n], before[n]), n
            continue
        dg = np.abs(grads[n].numpy() - jgrads[n].numpy())
        # rounding: of p − lr·u, each term up to the larger of |p| and lr
        ulp = 4 * np.spacing(np.maximum(np.abs(before[n].numpy()), np.float32(lr)))
        assert np.all(np.abs(got - want) <= lr * dg / eps + ulp), n
        moved = np.abs(jgrads[n].numpy()) > 1e-4  # Adam's first step: lr·sign(g)
        np.testing.assert_allclose(np.abs(got - before[n].numpy())[moved], lr,
                                   rtol=1e-3, err_msg=n)


def _head_pickle(path, channels, seed=0):
    """A detectron2-format pickle: numpy arrays under ``model``, the mask
    head's among other keys."""
    rng = np.random.RandomState(seed)
    shapes = {f"mask_fcn{k}": (channels, channels, 3, 3) for k in range(1, 5)}
    shapes.update(deconv=(channels, channels, 2, 2), predictor=(8, channels, 1, 1))
    model = {"backbone.stem.weight": rng.randn(4, 3).astype(np.float32)}
    for name, shape in shapes.items():
        out = shape[1] if name == "deconv" else shape[0]
        model[f"roi_heads.mask_head.{name}.weight"] = rng.randn(*shape).astype(np.float32)
        model[f"roi_heads.mask_head.{name}.bias"] = rng.randn(out).astype(np.float32)
    with open(path, "wb") as f:
        pickle.dump({"model": model}, f)
    return model


def test_mask_head_pretrain_loads_as_jax(roots, tmp_path):
    """The port's head state equals the pickle's arrays and JAX's loaded
    flax head carried across by ``fg_state_dict_from_jax``; ``init_weights``
    loads it, and a missing file warns and keeps the seeded head."""
    path = str(tmp_path / "mask_rcnn_pretrain.pkl")
    raw = _head_pickle(path, 32)
    state = load_maskrcnn_head_pickle(path)
    cfg = fg_train_cfg(roots[1])
    params, _ = fg_from_reference(build_model(cfg, None, "cpu").state_dict(),
                                  instance_feat_channels=8, feat_hw=7)
    params["mask_head"] = jax_load_maskrcnn_head_pickle(path)
    ref = {k[len("mask_head."):]: v for k, v in fg_state_dict_from_jax(params).items()
           if k.startswith("mask_head.")}
    assert sorted(state) == sorted(ref)
    for k, v in state.items():
        assert torch.equal(v, ref[k]), k
        assert torch.equal(v, torch.from_numpy(raw[f"roi_heads.mask_head.{k}"])), k

    cfg["model"]["mask_head"] = dict(cfg["model"]["mask_head"],
                                     maskrcnn_pretrain_path=path)
    loaded = init_weights(build_model(cfg, None, "cpu"), 0)
    for k, v in state.items():
        assert torch.equal(loaded.mask_head.state_dict()[k], v), k
    cfg["model"]["mask_head"]["maskrcnn_pretrain_path"] = str(tmp_path / "missing.pkl")
    with pytest.warns(UserWarning, match="not found"):
        seeded = init_weights(build_model(cfg, None, "cpu"), 0)
    assert not torch.equal(seeded.mask_head.mask_fcn1.weight,
                           loaded.mask_head.mask_fcn1.weight)
