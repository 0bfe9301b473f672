"""Port parity of the pc data options: the depth sources (cascade and
mono disparities, ``disparity_dir``, the ``use_mono``/``use_mono_disps``
precedence), the target lists (``use_all_targets``, ``expand_test``, with
ground-truth and predicted odometry), ``cities``, ``check_output_dir``
and ``use_imgs``; then ``use_imgs`` through ``PCTransformModel`` and
``export_segmentation`` with ``is_img``, and ``prepare_bg_data`` under a
mono config (at 1024x2048: the mono depth is resized to full resolution
whatever the fixture's size) and under an ``expand_test`` config.

The fixture is the port's ``data/synthetic.py`` at 64x128 with every
option's files; both packages' datasets and CLIs read the same tree.
Budgets as ``test_torch_port_data.py``'s pc test: ids and masks equal,
depth and ``target_T`` to rtol 1e-6; the CLIs' files equal byte for
byte, their depth h5 blocks equal.
"""

import glob
import os

import numpy as np
import pytest
import torch
import yaml

from panoptic_forecasting_tpu.cli import (
    export_segmentation as jax_export_segmentation,
    prepare_bg_data as jax_prepare_bg_data,
)
from panoptic_forecasting_tpu.core import build_dataset as jax_build_dataset
from panoptic_forecasting_tpu.core import build_model as jax_build_model
from panoptic_forecasting_tpu.data.loader import default_collate as jax_collate
from panoptic_forecasting_tpu_torch.cli import export_segmentation, prepare_bg_data
from panoptic_forecasting_tpu_torch.core import build_dataset, build_model
from panoptic_forecasting_tpu_torch.data import io, synthetic
from panoptic_forecasting_tpu_torch.data.loader import default_collate

torch.set_num_threads(2)

H, W, GAP = 64, 128, 9
SPLITS = ("train", "val")
MONO = (16, 32)  # the .npy disparities, below the fixture's resolution


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("pcopts"))
    cs, disp, odom = (os.path.join(root, d) for d in ("cs", "disp", "odom"))
    for split in SPLITS:
        kw = dict(split=split, n_snippets=2, height=H, width=W, gap_len=GAP,
                  all_targets=True, cascade=True, mono_size=MONO)
        store = synthetic.write_cityscapes_fixture(cs, images=True, **kw)
        synthetic.write_cityscapes_fixture(cs, disparity_dir=disp, **kw)
        synthetic.write_odom_predictions(
            os.path.join(odom, f"odometry_{split}.h5"),
            store["tables"][os.path.join(cs, f"{split}_3d_info.pkl")],
            starts=range(6, 30 - GAP), seed=3)
    return {"root": root, "cs": cs, "disp": disp, "odom": odom}


def _cfg(world, **data):
    base = {"cityscapes_dir": world["cs"], "data_dir": world["cs"],
            "seg_dir": os.path.join(world["cs"], "seg"), "gap_len": GAP,
            "no_moving_objects": True, "data_splits": list(SPLITS)}
    return {"task": "pc_transform", "data": dict(base, **data)}


def _assert_samples_equal(ra, rb, what):
    assert ra["meta"] == rb["meta"], what
    ia, ib = ra["inputs"], rb["inputs"]
    assert sorted(ia) == sorted(ib), what
    for k in ("seg", "depth_mask", "intrinsics", "extrinsics"):
        assert ia[k].dtype == ib[k].dtype and ia[k].shape == ib[k].shape, (what, k)
        np.testing.assert_array_equal(ia[k], ib[k], err_msg=f"{what} {k}")
    for k in ("depth", "target_T"):
        assert ia[k].shape == ib[k].shape, (what, k)
        np.testing.assert_allclose(ib[k], ia[k], rtol=1e-6, atol=0, err_msg=f"{what} {k}")


def _both(cfg):
    ref = jax_build_dataset(cfg, test=True)
    got = build_dataset(cfg, test=True)
    return ref.datasets, got.datasets


CASES = {
    # name: (data options, items per split (train, val))
    "use_all_targets": ({"use_all_targets": True}, (30, 2)),
    "expand_test": ({"expand_test": True}, (30, 30)),
    "expand_test_pred_odom": ({"expand_test": True, "odom_pred_dir": "odom"}, (30, 30)),
    "all_targets_pred_odom": ({"use_all_targets": True, "odom_pred_dir": "odom"},
                              (30, 2)),
    "cascade": ({"use_cascade_disps": True}, (2, 2)),
    "cascade_disparity_dir": ({"use_cascade_disps": True, "disparity_dir": "disp"},
                              (2, 2)),
    # (the mono depth is 1024x2048 whatever the labels' size: a 64x128
    # fixture masks no moving objects under it, in either package)
    "mono": ({"use_mono": True, "no_moving_objects": False}, (2, 2)),
    "mono_disps_disparity_dir": ({"use_mono_disps": True, "disparity_dir": "disp",
                                  "monodepth_factor": 3.0, "no_moving_objects": False},
                                 (2, 2)),
    "cities_kept": ({"cities": [synthetic.CITY]}, (2, 2)),
    "cities_dropped": ({"cities": ["elsewhere"]}, (0, 0)),
    "use_imgs": ({"use_imgs": True, "no_moving_objects": False}, (2, 2)),
    "use_imgs_no_moving": ({"use_imgs": True}, (2, 2)),
}


@pytest.mark.parametrize("case", list(CASES))
def test_pc_option_matches_jax(world, case):
    opts, counts = CASES[case]
    opts = {k: (world[v] if k in ("odom_pred_dir", "disparity_dir") else v)
            for k, v in opts.items()}
    ref, got = _both(_cfg(world, **opts))
    for split, n in zip(SPLITS, counts):
        a, b = ref[split], got[split]
        assert len(a) == len(b) == n, (split, len(a), len(b))
        for i in range(n):
            _assert_samples_equal(a[i], b[i], f"{case} {split}[{i}]")
    if not counts[1]:
        return
    s = got["val"][0]["inputs"]
    if opts.get("use_imgs"):  # the RGB payload of the video frames
        assert s["seg"].shape == (3, H, W, 3)
        assert s["depth_mask"].all() != bool(opts.get("no_moving_objects", True))
    if "use_mono" in opts or "use_mono_disps" in opts:
        assert s["depth"].shape == (3, 1024, 2048) and s["depth_mask"].all()
    if "expand_test" in opts:
        assert [got["val"][i]["meta"]["target_frame"] for i in range(15)] == list(
            range(6 + GAP, 30))


def test_use_mono_false_overrides_use_mono_disps(world):
    """JAX reads ``d.get("use_mono", d.get("use_mono_disps"))``: an
    explicit ``use_mono: false`` wins over ``use_mono_disps: true``, so
    the depth is the stereo one."""
    ref, got = _both(_cfg(world, use_mono=False, use_mono_disps=True))
    _, stereo = _both(_cfg(world))
    for i in range(2):
        _assert_samples_equal(ref["val"][i], got["val"][i], f"precedence [{i}]")
        np.testing.assert_array_equal(got["val"][i]["inputs"]["depth"],
                                      stereo["val"][i]["inputs"]["depth"])


def test_check_output_dir_skips_exported_targets(world, tmp_path):
    """A target whose labelIds PNG is in ``check_output_dir`` is skipped,
    with ``fr = frame - 19 + target``."""
    done = str(tmp_path / "done")
    for seq, fr in (("000000", 15), ("000000", 22), ("000001", 29)):
        p = os.path.join(done, "val", synthetic.CITY,
                         f"{synthetic.CITY}_{seq}_{fr:06d}_gtFine_labelIds.png")
        os.makedirs(os.path.dirname(p), exist_ok=True)
        open(p, "wb").close()
    ref, got = _both(_cfg(world, expand_test=True, check_output_dir=done))
    a, b = ref["val"], got["val"]
    assert len(a) == len(b) == 27
    frames = {(b[i]["meta"]["seq"], b[i]["meta"]["target_frame"]) for i in range(len(b))}
    assert not frames & {("000000", 15), ("000000", 22), ("000001", 29)}
    for i in (0, 13, 26):
        _assert_samples_equal(a[i], b[i], f"check_output_dir [{i}]")


def test_use_imgs_through_pc_transform_model(world):
    """RGB payloads through ``PCTransformModel`` (the exact z-buffer's RGB
    path) equal JAX's on the same batch."""
    cfg = _cfg(world, use_imgs=True)
    cfg["model"] = {"is_img": True}
    ref, got = _both(cfg)
    jb = jax_collate([ref["val"][i] for i in range(2)])
    pb = default_collate([got["val"][i] for i in range(2)])
    want = jax_build_model(cfg, None).predict(None, {"inputs": jb["inputs"]})
    have = build_model(cfg, None, "cpu").predict(pb)
    assert have["seg"].shape == (2, H, W, 3) and int(have["seg"].max()) > 0
    np.testing.assert_array_equal(have["seg"].numpy(), np.asarray(want["seg"]))
    np.testing.assert_allclose(have["depth"].numpy(), np.asarray(want["depth"]),
                               rtol=1e-6, atol=0)


def _dump(path, cfg):
    os.makedirs(os.path.dirname(path), exist_ok=True)
    with open(path, "w") as f:
        yaml.safe_dump(cfg, f)
    return path


def _files(root):
    return {os.path.relpath(p, root): p for p in sorted(
        glob.glob(os.path.join(root, "**", "*.*"), recursive=True))}


def _same_tree(a_root, b_root, expect):
    a, b = _files(a_root), _files(b_root)
    assert sorted(a) == sorted(b) and len(a) == expect, (sorted(a), sorted(b))
    for rel in a:
        if rel.endswith(".h5"):
            import h5py

            with h5py.File(a[rel], "r") as fa, h5py.File(b[rel], "r") as fb:
                keys = []
                fa.visit(lambda k: keys.append(k) if isinstance(fa[k], h5py.Dataset)
                         else None)
                assert keys and keys == sorted(keys)
                for k in keys:
                    np.testing.assert_array_equal(fa[k][()], fb[k][()], err_msg=k)
            continue
        with open(a[rel], "rb") as fa, open(b[rel], "rb") as fb:
            assert fa.read() == fb.read(), rel


def _run(mod, side, argv):
    extra = ["--set", "platform", "cpu"] if side == "port" else []
    return mod.main(argv + extra)


def test_use_imgs_export_matches_jax(world, tmp_path):
    """``export_segmentation`` of a ``use_imgs`` config with ``is_img``
    writes each target's reprojected RGB frame as ``_leftImg8bit.png``,
    the JAX CLI's files byte for byte."""
    cfg = _cfg(world, use_imgs=True, data_splits=["val"])
    cfg.update(is_img=True, model={"is_img": True},
               training={"batch_size": 2, "num_data_threads": 0})
    for side, mod in (("jax", jax_export_segmentation), ("port", export_segmentation)):
        path = _dump(str(tmp_path / side / "pc.yaml"), cfg)
        _run(mod, side, ["--working_dir", str(tmp_path / side / "run"),
                         "--config_file", path])
    _same_tree(str(tmp_path / "jax" / "run"), str(tmp_path / "port" / "run"), 2)
    assert all(p.endswith("_leftImg8bit.png") for p in _files(str(tmp_path / "port" / "run")))


def _prepare_both(tmp_path, cfg):
    for side, mod in (("jax", jax_prepare_bg_data), ("port", prepare_bg_data)):
        path = _dump(str(tmp_path / side / "pc.yaml"), cfg)
        _run(mod, side, ["--working_dir", str(tmp_path / side / "run"),
                         "--config_file", path, "--set", "bg_out",
                         str(tmp_path / side / "bg_data")])


def test_prepare_bg_data_expand_test_matches_jax(world, tmp_path):
    """``prepare_bg_data`` over every target of each snippet (15 a
    snippet at gap 9) with predicted odometry: the three seg trees and
    the depth h5 equal JAX's (the h5 key holds the snippet's last
    target's block, in both)."""
    cfg = _cfg(world, expand_test=True, odom_pred_dir=world["odom"], data_splits=["val"])
    cfg["training"] = {"batch_size": 4, "num_data_threads": 0}
    _prepare_both(tmp_path, cfg)
    _same_tree(str(tmp_path / "jax" / "bg_data"), str(tmp_path / "port" / "bg_data"),
               3 * 30 + 1)


def test_prepare_bg_data_mono_matches_jax(tmp_path):
    """``prepare_bg_data`` under ``use_mono`` at 1024x2048, one snippet:
    the mono depth is resized to full resolution whatever the input's
    size, so only a full-size fixture runs the model."""
    cs = str(tmp_path / "cs")
    synthetic.write_cityscapes_fixture(cs, "val", n_snippets=1, height=1024, width=2048,
                                       gap_len=GAP, mono_size=(192, 640))
    cfg = {"task": "pc_transform",
           "data": {"cityscapes_dir": cs, "data_dir": cs, "seg_dir": cs + "/seg",
                    "gap_len": GAP, "no_moving_objects": True, "use_mono": True,
                    "data_splits": ["val"]},
           "training": {"batch_size": 1, "num_data_threads": 0}}
    _prepare_both(tmp_path, cfg)
    _same_tree(str(tmp_path / "jax" / "bg_data"), str(tmp_path / "port" / "bg_data"), 4)
    h5 = io.open_h5(str(tmp_path / "port" / "bg_data" / "depths_decompressed_val.h5"))
    try:
        block = np.asarray(h5[f"{synthetic.CITY}/000000/000019/0"][()])
    finally:
        h5.close()
    assert block.shape == (1024, 2048, 3) and (block > 0).mean() > 0.5


@pytest.mark.parametrize("frames", [1, 3])
@pytest.mark.parametrize("batch", [1, 2])
def test_projection_rounds_as_jax_for_one_and_three_frames(batch, frames):
    """The projected points are JAX's to the bit for one input frame
    (``only_this_ind``: ``prepare_bg_data``'s index models) as for the
    three every pc config reads: with one frame XLA sums the camera
    chain in order with fused multiply-adds, and rounds the x and y
    rows' pixel products and sums one by one. Before the port followed
    it, 39 depths and 14 labels of one 1024x2048 index map differed."""
    import jax

    from panoptic_forecasting_tpu.models import pc_transform as jax_pc
    from panoptic_forecasting_tpu_torch.models import pc_transform as port_pc

    rng = np.random.RandomState(10 * batch + frames)

    def pose():
        e = np.eye(4, dtype=np.float32)
        e[:3, :3] = np.linalg.qr(rng.randn(3, 3))[0]
        e[:3, 3] = rng.randn(3)
        return e

    h, w = 16, 32
    K = np.tile(np.array([[2262.52, 0, 1096.98], [0, 2265.3, 513.137], [0, 0, 1]],
                         np.float32), (batch, 1, 1))
    E = np.stack([pose() for _ in range(batch)])
    T = np.stack([np.stack([pose() for _ in range(frames)]) for _ in range(batch)])
    depth = (rng.rand(batch, frames, h, w) * 50 + 1).astype(np.float32)
    want = jax.jit(jax.vmap(lambda d, k, e, t: jax_pc._reproject_points(d, k, e, t, h, w)))(
        depth, K, E, T)
    got = port_pc._reproject_points(*(torch.from_numpy(x) for x in (depth, K, E, T)), h, w)
    for g, x, name in zip(got, want, ("uv", "z")):
        np.testing.assert_array_equal(g.numpy(), np.asarray(x), err_msg=name)
