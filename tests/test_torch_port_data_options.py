"""Port parity of the odometry and fg data options: odom ``load_imgs``
(with ``min_img_len`` and ``cityscapes_dir``) against JAX's
``OdomDataset``, whose images cv2 resizes (the port has no cv2: its
``resize_linear`` follows OpenCV's ``INTER_LINEAR`` rule), and fg
``use_condensed_feats`` in both fg datasets against JAX's; then one
``cli.train`` step of each with the option on the CPU.

Fixtures come from the port's ``data/synthetic.py`` (odometry tables
and their video frames, the fg tree and its condensed files) and both
packages read them. Budgets: windows, meta and features exactly; the
images to atol 1e-6 of JAX's (OpenCV's float32 sums round in another
order: 1-2 ulp); the training losses with and without the option equal.
"""

import json
import os

import cv2
import numpy as np
import pytest
import torch

from panoptic_forecasting_tpu.core import build_dataset as jax_build_dataset
from panoptic_forecasting_tpu.data.odom_data import _resize_short_side as jax_resize
from panoptic_forecasting_tpu_torch.cli import train as train_cli
from panoptic_forecasting_tpu_torch.core import build_dataset
from panoptic_forecasting_tpu_torch.data import io, synthetic
from panoptic_forecasting_tpu_torch.data.odom_data import resize_linear, resize_short_side

torch.set_num_threads(2)
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.mark.parametrize("shape", [(32, 64, 16, 32), (37, 53, 20, 29), (20, 30, 45, 61),
                                   (64, 128, 48, 96), (10, 10, 10, 23), (96, 64, 7, 5)])
def test_resize_linear_is_opencvs(shape):
    """``resize_linear`` against ``cv2.resize(INTER_LINEAR)`` on float32:
    down, up, odd ratios, one axis, a portrait image."""
    h, w, dh, dw = shape
    img = np.random.RandomState(h * w).rand(h, w, 3).astype(np.float32)
    want = cv2.resize(img, (dw, dh), interpolation=cv2.INTER_LINEAR)
    np.testing.assert_allclose(resize_linear(img, dh, dw), want, rtol=0, atol=1e-6)
    np.testing.assert_allclose(resize_linear(img[..., 0], dh, dw), want[..., 0],
                               rtol=0, atol=1e-6)


@pytest.mark.parametrize("min_len", [16, 23, 64])
def test_resize_short_side_matches_jax(min_len):
    img = np.random.RandomState(min_len).rand(48, 100, 3).astype(np.float32)
    for x in (img, img.transpose(1, 0, 2)):
        want = jax_resize(x, min_len)
        got = resize_short_side(x, min_len)
        assert got.shape == want.shape and got.dtype == want.dtype
        np.testing.assert_allclose(got, want, rtol=0, atol=1e-6)


@pytest.fixture(scope="module")
def odom_world(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("odom_imgs"))
    data, cs = os.path.join(root, "data"), os.path.join(root, "cs")
    store = synthetic.write_odom_fixture(data, n_snippets=2)
    for split in ("train", "val"):
        synthetic.write_odom_images(
            cs, store["tables"][os.path.join(data, f"{split}_3d_info.pkl")], split,
            height=40, width=72, seed=len(split))
    return {"data": data, "cs": cs}


@pytest.mark.parametrize("test_mode", [False, True], ids=["train", "test"])
def test_odom_load_imgs_matches_jax(odom_world, test_mode):
    """Every window's images against JAX's: the short side resized to
    ``min_img_len`` (40x72 -> 16x29: not a whole ratio), short-history
    samples repeat-padded at the front."""
    cfg = {"task": "odom", "data": {
        "data_dir": odom_world["data"], "data_splits": ["train", "val"],
        "load_imgs": True, "min_img_len": 16, "cityscapes_dir": odom_world["cs"]}}
    want = jax_build_dataset(cfg, test=test_mode).datasets
    got = build_dataset(cfg, test=test_mode).datasets
    for split in ("train", "val"):
        a, b = want[split], got[split]
        assert len(a) == len(b) > 0
        for i in range(len(a)):
            ra, rb = a[i], b[i]
            assert ra["meta"] == rb["meta"]
            np.testing.assert_array_equal(rb["inputs"]["odometry"], ra["inputs"]["odometry"])
            ia, ib = ra["inputs"]["imgs"], rb["inputs"]["imgs"]
            assert ib.shape == ia.shape == (9, 16, 29, 3) and ib.dtype == np.float32
            np.testing.assert_allclose(ib, ia, rtol=0, atol=1e-6, err_msg=f"{split}[{i}]")
    short = [s for s in (got["val"][i] for i in range(len(got["val"])))
             if s["meta"]["start_frame"] < 8]
    assert short and all(np.array_equal(s["inputs"]["imgs"][0], s["inputs"]["imgs"][1])
                         for s in short)


def test_odom_load_imgs_full_size_images(odom_world):
    """Without ``min_img_len`` the frames come at their size, ``png / 255``."""
    cfg = {"task": "odom", "data": {
        "data_dir": odom_world["data"], "data_splits": ["val"],
        "load_imgs": True, "cityscapes_dir": odom_world["cs"]}}
    a = jax_build_dataset(cfg, test=True).datasets["val"][0]["inputs"]["imgs"]
    b = build_dataset(cfg, test=True).datasets["val"][0]["inputs"]["imgs"]
    assert b.shape == (9, 40, 72, 3)
    np.testing.assert_array_equal(b, a)


def _losses(wd):
    """The run's logged metrics, without their time stamps."""
    with open(os.path.join(wd, "logs", "metrics.jsonl")) as f:
        return [{k: v for k, v in json.loads(line).items() if k != "ts"} for line in f]


def test_cli_train_odom_with_load_imgs(odom_world, tmp_path):
    """``cli.train`` on odom_train.yaml with ``load_imgs``: the loader
    carries the images to the device and the model ignores them, so the
    run's losses equal the run without them."""
    base = ["--config_file", os.path.join(REPO, "configs", "odom", "odom_train.yaml"),
            "--set", "platform", "cpu", "--set", "data.data_dir", odom_world["data"],
            "--set", "training.batch_size", "4", "--set", "training.steps_per_epoch", "2",
            "--set", "training.num_epochs", "1", "--set", "model.rnn_hidden", "16"]
    imgs = ["--set", "data.load_imgs", "true", "--set", "data.min_img_len", "16",
            "--set", "data.cityscapes_dir", odom_world["cs"]]
    runs = {}
    for name, extra in (("plain", []), ("imgs", imgs)):
        wd = str(tmp_path / name)
        with pytest.warns(UserWarning):  # lr_scheduler_type
            result = train_cli.main(["--working_dir", wd] + base + extra)
        assert result["step"] == 2
        runs[name] = _losses(wd)
    assert runs["imgs"] == runs["plain"] and runs["plain"]


def test_odom_load_imgs_needs_cityscapes_dir(odom_world):
    with pytest.raises(ValueError, match="cityscapes_dir"):
        build_dataset({"task": "odom", "data": {
            "data_dir": odom_world["data"], "load_imgs": True}}, test=True)


# ---- fg condensed feats ---------------------------------------------------------


@pytest.fixture(scope="module")
def fg_world(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("fg_condensed"))
    store = synthetic.write_fg_fixture(root, n_scenes=3, max_instances=3,
                                       feat_channels=32, feat_hw=7)
    synthetic.write_condensed_feats(root, store)
    return root


def _fg_cfg(root, dstype, **data):
    return {"task": "fg", "seed": 0, "working_dir": os.path.join(root, "run"),
            "data": dict({"dataset_type": dstype, "data_splits": ["train", "val"],
                          "data_dir": root, "depth_dir": root, "feats_dir": root,
                          "info_3d_dir": root, "use_3d_info": True, "max_depth": 200,
                          "instance_pad_multiple": 4}, **data),
            "model": {"mask_head": {}}, "training": {"batch_size": 1}}


@pytest.mark.parametrize("dstype", ["fg_instance", "fg_scene"])
def test_condensed_feats_match_jax(fg_world, dstype):
    """Both fg datasets with ``use_condensed_feats`` against JAX's, and
    against their plain selves (the condensed files are copies, as in the
    JAX package's own test): every array of every sample equal."""
    cfg = _fg_cfg(fg_world, dstype, use_condensed_feats=True)
    want = jax_build_dataset(cfg, test=True).datasets
    got = build_dataset(cfg, test=True).datasets
    plain = build_dataset(_fg_cfg(fg_world, dstype), test=True).datasets
    for split in ("train", "val"):
        a, b, c = want[split], got[split], plain[split]
        assert len(a) == len(b) == len(c) > 0
        for i in range(len(a)):
            for part in ("inputs", "labels"):
                assert sorted(a[i][part]) == sorted(b[i][part])
                for k in a[i][part]:
                    np.testing.assert_array_equal(b[i][part][k], a[i][part][k], err_msg=k)
                    np.testing.assert_array_equal(b[i][part][k], c[i][part][k], err_msg=k)
        assert np.abs(b[0]["inputs"]["feats"]).sum() > 0


def test_condensed_feats_read_their_own_files(fg_world, tmp_path):
    """The condensed h5 and ``feat_ind`` column are what is read: with
    the condensed features scaled by 2 and their indices shifted, the
    track dataset's features are the scaled rows of the shifted indices."""
    import shutil

    root = str(tmp_path / "fg")
    shutil.copytree(fg_world, root)
    feats = io.open_h5(os.path.join(root, "val_condensed_feats.h5"))
    try:
        arrays = {k: np.concatenate([np.zeros_like(v[()][:1]), 2 * v[()]])
                  for k, v in ((k, feats[k]) for k in _h5_keys(feats))}
    finally:
        feats.close()
    io.write_h5(os.path.join(root, "val_condensed_feats.h5"), arrays)
    meta = io.read_table(os.path.join(root, "val_instance_condensed_feat_info.pkl"))
    import pandas as pd

    pd.DataFrame([{"feat_ind": np.where(np.asarray(r["feat_ind"]) >= 0,
                                        np.asarray(r["feat_ind"]) + 1, -1)}
                  for r in meta]).to_pickle(
        os.path.join(root, "val_instance_condensed_feat_info.pkl"))
    cfg = _fg_cfg(root, "fg_instance", data_splits=["val"], use_condensed_feats=True)
    got = build_dataset(cfg, test=True).datasets["val"]
    plain = build_dataset(_fg_cfg(root, "fg_instance", data_splits=["val"]),
                          test=True).datasets["val"]
    want = jax_build_dataset(cfg, test=True).datasets["val"]
    for i in range(len(got)):
        np.testing.assert_array_equal(got[i]["inputs"]["feats"],
                                      2 * plain[i]["inputs"]["feats"])
        np.testing.assert_array_equal(got[i]["inputs"]["feats"], want[i]["inputs"]["feats"])


def _h5_keys(h5):
    keys = []
    h5.handle().visit(lambda k: keys.append(k) if hasattr(h5[k], "shape") else None)
    return keys


def test_cli_train_fg_track_dataset_with_condensed_feats(fg_world, tmp_path):
    """``cli.train`` on fg_train.yaml (the track dataset) with
    ``use_condensed_feats``: the same losses as the plain run."""
    base = ["--config_file", os.path.join(REPO, "configs", "fg", "fg_train.yaml"),
            "--set", "platform", "cpu", "--set", "training.batch_size", "4",
            "--set", "training.steps_per_epoch", "2", "--set", "training.num_epochs", "1",
            "--set", "model.rnn_hidden", "16", "--set", "model.mask_feat_channels", "32",
            "--set", "model.mask_feat_hw", "7", "--set", "model.mask_head.conv_dim", "32"]
    for key in ("data_dir", "depth_dir", "feats_dir", "info_3d_dir"):
        base += ["--set", f"data.{key}", fg_world]
    runs = {}
    for name, extra in (("plain", []), ("condensed",
                                         ["--set", "data.use_condensed_feats", "true"])):
        wd = str(tmp_path / name)
        with pytest.warns(UserWarning):  # no pretrain file
            result = train_cli.main(["--working_dir", wd] + base + extra)
        assert result["step"] == 2
        runs[name] = _losses(wd)
    assert runs["condensed"] == runs["plain"] and runs["plain"]
