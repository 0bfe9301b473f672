"""Port parity of the data layer: the PNG codec, the pc and fg-scene
readers, the data cards, the config loader and the checkpoints.

Inputs come from a seed through the JAX package's ``data/synthetic.py``
at 64x128 (its PNGs written by Pillow with adaptive row filters), plus
predicted-odometry h5 files from the port's writer. Integer maps, masks,
fg arrays and cards must be bit-equal; pc depths and transforms equal
to rtol 1e-6 (float32 from the same float64 arithmetic, so in practice
exact).
"""

import io
import os
import zlib

import numpy as np
import pytest
import torch
import yaml
from PIL import Image

from panoptic_forecasting_tpu.core import build_dataset as jax_build_dataset
from panoptic_forecasting_tpu.core.config import load_config as jax_load_config
from panoptic_forecasting_tpu.data import fg_data as jax_fg_data
from panoptic_forecasting_tpu.data.synthetic import (
    write_bg_fixture,
    write_cityscapes_fixture,
    write_fg_fixture,
)
from panoptic_forecasting_tpu.models.bg import BGModel as JaxBGModel
from panoptic_forecasting_tpu_torch.cli.common import restore_params
from panoptic_forecasting_tpu_torch.core import build_dataset, build_model, load_config
from panoptic_forecasting_tpu_torch.core import checkpoint as ckpt
from panoptic_forecasting_tpu_torch.data import fg_data, png, synthetic
from panoptic_forecasting_tpu_torch.models import seeded_init_
from test_torch_port_common import FG_MODEL

H, W = 64, 128
SPLITS = ("train", "val")


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("portdata"))
    cs, fg, odom = (os.path.join(root, d) for d in ("cs", "fg", "odom"))
    os.makedirs(odom)
    for split in SPLITS:
        write_cityscapes_fixture(cs, split=split, n_snippets=2, height=H, width=W)
    write_fg_fixture(fg, splits=SPLITS, n_scenes=3, max_instances=3,
                     feat_channels=32, feat_hw=7)
    import pandas as pd

    for split in SPLITS:
        rows = pd.read_pickle(os.path.join(cs, f"{split}_3d_info.pkl")).to_dict("records")
        synthetic.write_odom_predictions(
            os.path.join(odom, f"odometry_{split}.h5"), rows, seed=1)
        rows = pd.read_pickle(os.path.join(fg, f"{split}_3d_info.pkl")).to_dict("records")
        synthetic.write_odom_predictions(
            os.path.join(odom, f"predicted_odometry_{split}.h5"), rows, seed=2)
    # bg canvases of the fg scenes' target frames (trainId content)
    bg_dir = os.path.join(root, "bg_export")
    rng = np.random.RandomState(5)
    for split in SPLITS:
        for s in range(3):
            p = os.path.join(bg_dir, split, "synthcity",
                             f"synthcity_{s:06d}_000019_gtFine_labelIds.png")
            os.makedirs(os.path.dirname(p), exist_ok=True)
            Image.fromarray(rng.randint(0, 11, (H, W)).astype(np.uint8)).save(p)
    return {"root": root, "cs": cs, "fg": fg, "odom": odom, "bg_export": bg_dir}


# ---- PNG codec ---------------------------------------------------------------

KINDS = {
    "gray8": ((24, 40), np.uint8),
    "rgb8": ((24, 40, 3), np.uint8),
    "rgba8": ((24, 40, 4), np.uint8),
    "gray16": ((24, 40), np.uint16),
    "rgb16": ((12, 9, 3), np.uint16),
}


def _image(kind, seed=0):
    shape, dtype = KINDS[kind]
    rng = np.random.RandomState(seed)
    return rng.randint(0, np.iinfo(dtype).max + 1, shape).astype(dtype)


def _row_filters(data: bytes):
    """The filter byte of every row of a PNG file."""
    hdr = png._header(data)
    h, ch = hdr["height"], png.CHANNELS[hdr["ctype"]]
    stride = hdr["width"] * ch * hdr["depth"] // 8 + 1
    raw = zlib.decompress(hdr["idat"])
    return {raw[r * stride] for r in range(h)}


@pytest.mark.parametrize("kind", ["gray8", "rgb8", "rgba8", "gray16"])
def test_png_reads_pillow_files(kind):
    """Pillow's adaptive filters (with ``optimize`` it also tries
    Average) decode bit-exact; over the four kinds every filter occurs."""
    seen = set()
    for seed in range(3):
        arr = _image(kind, seed)
        buf = io.BytesIO()
        Image.fromarray(arr).save(buf, format="PNG", optimize=True)
        got = png.decode_png(buf.getvalue())
        assert got.dtype == arr.dtype
        np.testing.assert_array_equal(got, arr)
        seen |= _row_filters(buf.getvalue())
    assert seen >= {png.FILTER_NONE, png.FILTER_SUB, png.FILTER_UP,
                    png.FILTER_AVERAGE}
    if kind != "gray8":  # Pillow never picks Paeth on this gray noise
        assert png.FILTER_PAETH in seen


@pytest.mark.parametrize("filter_type", range(5),
                         ids=["none", "sub", "up", "average", "paeth"])
def test_png_written_reads_in_pillow(filter_type):
    for kind in KINDS:
        arr = _image(kind, 7)
        data = png.encode_png(arr, 1, filter_type)
        assert _row_filters(data) == {filter_type}
        np.testing.assert_array_equal(png.decode_png(data), arr)
        if kind != "rgb16":  # Pillow reads 16-bit RGB as 8 bits
            np.testing.assert_array_equal(np.array(Image.open(io.BytesIO(data))), arr)


@pytest.mark.parametrize("profile", ["ids", "smooth16", "default"])
def test_png_writes_libpngs_bytes(tmp_path, profile):
    """``save_png`` writes, byte for byte, the file the JAX package's
    native libpng writer writes for each of its profiles (unfiltered
    level 1, adaptive level 1, adaptive level 6), whose settings are the
    JAX package's: small images (the smaller deflate window), images past
    one 8192-byte IDAT, one-row and one-column images, smooth 16-bit depth,
    every channel count, an int32 id map (written as 16 bits)."""
    from panoptic_forecasting_tpu import native
    from panoptic_forecasting_tpu.data import io as jax_io
    from panoptic_forecasting_tpu_torch.data import io as port_io

    if not native.available():
        pytest.skip("the JAX package's libpng writer is not built here")
    kw = {"ids": (jax_io.PNG_IDS, port_io.PNG_IDS),
          "smooth16": (jax_io.PNG_SMOOTH16, port_io.PNG_SMOOTH16),
          "default": ({}, {})}[profile]
    assert kw[1] == kw[0]
    yy, xx = np.mgrid[:96, :160]
    smooth = ((np.sin(xx / 17.0) + np.cos(yy / 11.0)) * 15000 + 32000).astype(np.uint16)
    arrays = [_image(k, 3) for k in KINDS] + [
        smooth, smooth[:1], smooth[:, :1], _image("gray8", 4)[:1, :7],
        np.random.RandomState(5).randint(0, 12, (256, 512)).astype(np.uint8),
        np.random.RandomState(6).randint(0, 34000, (64, 96)).astype(np.int32)]
    for i, arr in enumerate(arrays):
        jax_io.save_png(str(tmp_path / f"j{i}.png"), arr, **kw[0])
        port_io.save_png(str(tmp_path / f"p{i}.png"), arr, **kw[1])
        want = (tmp_path / f"j{i}.png").read_bytes()
        assert (tmp_path / f"p{i}.png").read_bytes() == want, (i, arr.shape, arr.dtype)
        np.testing.assert_array_equal(png.decode_png(want), arr)


def test_png_rejects_unsupported_files():
    # a palette file is read as libpng expands it (RGB), no longer refused
    buf = io.BytesIO()
    pal = Image.fromarray(_image("gray8")).convert("P")
    pal.save(buf, format="PNG")
    np.testing.assert_array_equal(png.decode_png(buf.getvalue()),
                                  np.array(pal.convert("RGB")))
    with pytest.raises(ValueError, match="not a PNG"):
        png.decode_png(b"GIF89a" + bytes(20))
    with pytest.raises(TypeError):
        png.encode_png(np.zeros((4, 4), np.int32))


@pytest.mark.parametrize("source", ["stereo_png", "cascade_png", "npy"])
def test_depth_decoding_matches_jax(tmp_path, source):
    """load_depth and the depth PNG payload codec equal the JAX package's."""
    from panoptic_forecasting_tpu.data import io as jax_io
    from panoptic_forecasting_tpu_torch.data import io

    rng = np.random.RandomState(1)
    disp = rng.randint(0, 40000, (16, 24)).astype(np.uint16)
    disp[::5] = 0
    path = str(tmp_path / ("d.npy" if source == "npy" else "d.png"))
    if source == "npy":
        np.save(path, disp.astype(np.float32) / 256.0)
    else:
        Image.fromarray(disp).save(path)
    kw = dict(baseline=0.21, fx=2262.5, use_cascade=source == "cascade_png")
    _assert_tree_equal(list(jax_io.load_depth(path, **kw)),
                       list(io.load_depth(path, **kw)), source)
    depth = rng.rand(16, 24).astype(np.float32) * 300 - 5
    png_payload = io.encode_depth_png(depth)
    np.testing.assert_array_equal(png_payload, jax_io.encode_depth_png(depth))
    _assert_tree_equal(list(jax_io.decode_depth_png(png_payload)),
                       list(io.decode_depth_png(png_payload)), "depth png")


# ---- readers -------------------------------------------------------------------


def _pc_cfg(world, predicted):
    data = {"cityscapes_dir": world["cs"], "data_dir": world["cs"],
            "seg_dir": os.path.join(world["cs"], "seg"), "gap_len": 9,
            "no_moving_objects": True, "data_splits": list(SPLITS)}
    if predicted:
        data["odom_pred_dir"] = world["odom"]
    return {"task": "pc_transform", "data": data}


@pytest.mark.parametrize("predicted", [False, True], ids=["gt_odom", "pred_odom"])
def test_pc_dataset_matches_jax(world, predicted):
    cfg = _pc_cfg(world, predicted)
    ref = jax_build_dataset(cfg, test=True)
    got = build_dataset(cfg, test=True)
    for split in SPLITS:
        a, b = ref.datasets[split], got.datasets[split]
        assert len(a) == len(b) == 2
        for i in range(len(a)):
            ra, rb = a[i], b[i]
            assert ra["meta"] == rb["meta"]
            ia, ib = ra["inputs"], rb["inputs"]
            for k in ("seg", "depth_mask", "intrinsics", "extrinsics"):
                assert ia[k].dtype == ib[k].dtype, k
                np.testing.assert_array_equal(ia[k], ib[k], err_msg=k)
            for k in ("depth", "target_T"):
                np.testing.assert_allclose(ib[k], ia[k], rtol=1e-6, atol=0, err_msg=k)
            assert ib["depth_mask"].sum() < ib["depth_mask"].size  # cars removed


def _fg_cfg(world, variant):
    data = {"dataset_type": "fg_scene", "data_splits": list(SPLITS),
            "data_dir": world["fg"], "depth_dir": world["fg"],
            "feats_dir": world["fg"], "info_3d_dir": world["fg"],
            "use_3d_info": True, "max_depth": 200,
            "require_most_recent": True, "instance_pad_multiple": 4}
    if variant == "short_pred_bg":  # configs/fg/fg_val_short.yaml's options
        data.update(data_splits=["val"], output_ind=0, odom_pred_dir=world["odom"],
                    background_dir=world["bg_export"], filter_car_gap=30,
                    add_car_offscreen_loc=True)
    return {"task": "fg", "data": data}


def _assert_tree_equal(a, b, path=""):
    if isinstance(a, dict):
        assert set(a) == set(b), path
        for k in a:
            _assert_tree_equal(a[k], b[k], f"{path}.{k}")
    elif isinstance(a, np.ndarray):
        assert isinstance(b, np.ndarray) and a.dtype == b.dtype, path
        np.testing.assert_array_equal(a, b, err_msg=path)
    elif isinstance(a, list):
        assert len(a) == len(b), path
        for i, (x, y) in enumerate(zip(a, b)):
            _assert_tree_equal(x, y, f"{path}[{i}]")
    else:
        assert a == b, path


@pytest.mark.parametrize("variant", ["gt_odom", "short_pred_bg"])
def test_fg_scene_dataset_matches_jax(world, variant):
    cfg = _fg_cfg(world, variant)
    for test in (False, True):
        ref = jax_build_dataset(cfg, test=test)
        got = build_dataset(cfg, test=test)
        for split in cfg["data"]["data_splits"]:
            a, b = ref.datasets[split], got.datasets[split]
            assert len(a) == len(b) > 0
            samples = [b[i] for i in range(len(b))]
            for i, s in enumerate(samples):
                _assert_tree_equal(a[i], s, f"{split}[{i}]")
            _assert_tree_equal(
                jax_fg_data.fg_scene_collate([a[i] for i in range(len(a))]),
                fg_data.fg_scene_collate(samples), f"{split} collate")
    if variant == "short_pred_bg":
        assert "background" in samples[0]["inputs"]


def test_data_cards_match_jax(world, tmp_path):
    """fg: the train split's statistics (compute_fg_stats), none on val;
    bg in test mode: the class count, and no depth statistics even with
    a stats file on disk (the JAX package sets them only for a training
    train split)."""
    cfg = _fg_cfg(world, "gt_odom")
    ref, got = jax_build_dataset(cfg), build_dataset(cfg)
    assert got.card.to_json() == ref.card.to_json()
    assert set(got.card.stats) == {"traj", "depth", "odom"}
    val = dict(cfg, data=dict(cfg["data"], data_splits=["val"]))
    assert jax_build_dataset(val, test=True).card.stats == {}
    assert build_dataset(val, test=True).card.stats == {}

    bg_data = write_bg_fixture(str(tmp_path / "bg"), splits=("val",))
    stats_file = str(tmp_path / "depth_stats.npy")
    np.save(stats_file, np.array([20.0, 12.0], np.float32))
    bg_cfg = {"task": "bg", "data": dict(bg_data, data_splits=["val"],
                                          only_background=True, use_depths=True,
                                          depth_norm_params_file=stats_file)}
    ref, got = jax_build_dataset(bg_cfg, test=True), build_dataset(bg_cfg, test=True)
    assert got.card.to_json() == ref.card.to_json()
    assert got.card.num_classes == 11 and got.card.stats == {}


def test_load_config_matches_jax(world, tmp_path):
    path = str(tmp_path / "cfg.yaml")
    with open(path, "w") as f:
        yaml.safe_dump({"task": "fg", "data": {"gap_len": [9], "max_depth": 200},
                        "model": {"rnn_hidden": 128}}, f)
    argv = ["--working_dir", str(tmp_path / "run"), "--config_file", path,
            "--seed", "3", "--platform", "cpu",
            "--set", "fused.bg_dir", "/some/dir", "--set", "data.gap_len", "[9,3]",
            "--set", "model.rnn_hidden", "64", "--set", "training.lr", "2e-3",
            "--set", "fused.use_x", "true", "--set", "export_name", "none"]
    ref, got = jax_load_config(argv), load_config(argv)
    assert dict(got) == dict(ref)
    assert got["data"]["gap_len"] == [9, 3] and got["export_name"] is None


# ---- checkpoints ---------------------------------------------------------------

BG_CFG = {"task": "bg", "data": {"only_background": True},
          "model": {"num_inputs": 3, "use_depth_inps": True, "convert2onehot": True}}


@pytest.mark.parametrize("where", ["best", "latest", "load_model"])
def test_checkpoint_round_trip(tmp_path, where):
    """restore_params finds the saved weights (explicit load_model, then
    best_model, then model_checkpoint) and leaves the card's statistics;
    with no checkpoint it gives the seeded weights."""
    wd = str(tmp_path / "run")
    fg_cfg = {"task": "fg", "model": FG_MODEL, "seed": 4}
    for cfg, stat in ((BG_CFG, "depth_mean"), (fg_cfg, "traj_std")):
        cfg = dict(cfg, working_dir=wd)
        saved = seeded_init_(build_model(cfg, None, "cpu"), 11)
        getattr(saved, stat).fill_(7.0)
        path = ckpt.save_model(wd, saved, best=where == "best")
        if where == "load_model":
            cfg["load_model"] = path
        fresh = build_model(cfg, None, "cpu")
        want = getattr(fresh, stat).clone()
        restored = restore_params(cfg, fresh)
        for k, v in saved.state_dict().items():
            if ckpt.is_stat_key(k):
                continue
            torch.testing.assert_close(restored.state_dict()[k], v, rtol=0, atol=0)
        torch.testing.assert_close(getattr(restored, stat), want, rtol=0, atol=0)
        os.remove(path)
        if where != "best":
            continue
        seeded = restore_params(dict(cfg, load_model=None), build_model(cfg, None, "cpu"))
        ref = seeded_init_(build_model(cfg, None, "cpu"), cfg.get("seed", 0))
        for k, v in ref.state_dict().items():
            torch.testing.assert_close(seeded.state_dict()[k], v, rtol=0, atol=0)


def test_bg_serving_depth_stats_are_identity(world, tmp_path):
    """The JAX package's fused CLI serves its bg model with depth mean 0,
    std 1 (its test-mode card has none, and checkpoints do not hold
    them); the port's bg model built and restored the same way does too,
    even from a checkpoint saved with other statistics."""
    bg_data = write_bg_fixture(str(tmp_path / "bg"), splits=("val",))
    np.save(str(tmp_path / "stats.npy"), np.array([20.0, 12.0], np.float32))
    cfg = dict(BG_CFG, working_dir=str(tmp_path / "run"),
               data=dict(bg_data, data_splits=["val"], only_background=True,
                         use_depths=True,
                         depth_norm_params_file=str(tmp_path / "stats.npy")))
    jax_model = JaxBGModel(cfg, jax_build_dataset(cfg, test=True).card)
    assert (jax_model.depth_mean, jax_model.depth_std) == (0.0, 1.0)
    card = build_dataset(cfg, test=True).card
    trained = build_model(cfg, card, "cpu")
    trained.depth_mean.fill_(20.0)
    trained.depth_std.fill_(12.0)
    ckpt.save_model(cfg["working_dir"], trained, best=True)
    model = restore_params(cfg, build_model(cfg, card, "cpu"))
    assert (float(model.depth_mean), float(model.depth_std)) == (0.0, 1.0)
    assert model.num_classes == jax_model.num_classes == 11


JAX_CACHE_KEYS = ("jax_compilation_cache_dir",
                  "jax_persistent_cache_min_compile_time_secs",
                  "jax_persistent_cache_min_entry_size_bytes")


def test_reference_bg_pt_with_0d_stats_sets_up_as_jax(tmp_path):
    """A reference-format bg ``.pt`` whose depth statistics are 0-d
    tensors goes through both packages' ``setup`` (``--load_torch_model``)
    and gives the bg model the same depth statistics: each statistic is
    read as 1-D, as the JAX package's importer reads it."""
    import jax

    from panoptic_forecasting_tpu.cli.common import setup as jax_setup
    from panoptic_forecasting_tpu_torch.cli.common import setup

    bg_data = write_bg_fixture(str(tmp_path / "bg"), splits=("val",))
    cfg = dict(BG_CFG, data=dict(bg_data, data_splits=["val"],
                                 only_background=True, use_depths=True))
    card = build_dataset(cfg, test=True).card
    sd = seeded_init_(build_model(cfg, card, "cpu"), 5).state_dict()
    sd["depth_mean"], sd["depth_std"] = torch.tensor(20.0), torch.tensor(12.0)
    pt = str(tmp_path / "bg_reference.pt")
    torch.save(sd, pt)
    cfg_path = str(tmp_path / "bg.yaml")
    with open(cfg_path, "w") as f:
        yaml.safe_dump(cfg, f)
    argv = ["--working_dir", str(tmp_path / "run"), "--config_file", cfg_path,
            "--load_torch_model", pt]

    saved = {k: getattr(jax.config, k) for k in JAX_CACHE_KEYS}
    try:
        _, jax_data, jax_model = jax_setup(
            argv + ["--set", "compilation_cache_dir",
                    saved["jax_compilation_cache_dir"]], test=True)
    finally:
        for k, v in saved.items():
            jax.config.update(k, v)
    _, data, model = setup(load_config(argv + ["--set", "platform", "cpu"]), test=True)
    assert (jax_model.depth_mean, jax_model.depth_std) == (20.0, 12.0)
    assert (float(model.depth_mean), float(model.depth_std)) == (20.0, 12.0)
    for stat in ("mean", "std"):
        np.testing.assert_array_equal(data.card.stats["depth"][stat],
                                      jax_data.card.stats["depth"][stat])
        assert data.card.stats["depth"][stat].shape == (1,)


# ---- the port's fixtures ---------------------------------------------------------


def test_port_synthetic_matches_jax_fixture(world, tmp_path):
    """The port's fixture writers give the JAX fixture's data: the fg
    tables and features equal, the pc samples of its cityscapes tree
    equal to those of the JAX one (the port writes only the PNGs the
    reader opens)."""
    import h5py
    import pandas as pd

    store = synthetic.write_fg_fixture(str(tmp_path / "fg"), splits=SPLITS,
                                       n_scenes=3, max_instances=3,
                                       feat_channels=32, feat_hw=7)
    for split in SPLITS:
        for name in (f"{split}_seq_meta.pkl", f"{split}_depth_seq_info.pkl",
                     f"{split}_3d_info.pkl"):
            ref = pd.read_pickle(os.path.join(world["fg"], name)).to_dict("records")
            path = str(tmp_path / "fg" / name)
            _assert_tree_equal(ref, pd.read_pickle(path).to_dict("records"), name)
            _assert_tree_equal(ref, store["tables"][path], name)
        name = f"{split}_feats.h5"
        with h5py.File(os.path.join(world["fg"], name)) as a, \
                h5py.File(str(tmp_path / "fg" / name)) as b:
            for city in a:
                for seq in a[city]:
                    key = f"{city}/{seq}/19"
                    np.testing.assert_array_equal(a[key][:], b[key][:])
    cs = str(tmp_path / "cs")
    synthetic.write_cityscapes_fixture(cs, "val", n_snippets=2, height=H, width=W)
    cfg = _pc_cfg(world, False)
    ref = build_dataset(dict(cfg, data=dict(cfg["data"], data_splits=["val"])),
                        test=True).datasets["val"]
    got = build_dataset({"task": "pc_transform", "data": dict(
        cfg["data"], cityscapes_dir=cs, data_dir=cs, seg_dir=cs + "/seg",
        data_splits=["val"])}, test=True).datasets["val"]
    for i in range(len(ref)):
        _assert_tree_equal(ref[i], got[i], f"pc[{i}]")


def test_readers_from_store_match_files(world, tmp_path):
    """The in-memory seam (a machine without pandas or h5py): the pc and
    fg-scene datasets built from the tables and arrays the port's writers
    return equal the datasets read from the written files."""
    cs, fg = str(tmp_path / "cs"), str(tmp_path / "fg")
    odom = str(tmp_path / "odom")
    store = synthetic.write_cityscapes_fixture(cs, "val", n_snippets=2, height=H,
                                               width=W, gap_len=3)
    synthetic.write_fg_fixture(fg, splits=("val",), n_scenes=2, feat_channels=32,
                               feat_hw=7, store=store)
    synthetic.write_odom_predictions(
        os.path.join(odom, "odometry_val.h5"),
        store["tables"][os.path.join(cs, "val_3d_info.pkl")], starts=(16,),
        store=store)
    synthetic.write_odom_predictions(
        os.path.join(odom, "predicted_odometry_val.h5"),
        store["tables"][os.path.join(fg, "val_3d_info.pkl")], starts=(16,),
        store=store)
    cfgs = [
        {"task": "pc_transform", "data": {
            "cityscapes_dir": cs, "data_dir": cs, "seg_dir": cs + "/seg",
            "gap_len": 3, "no_moving_objects": True, "odom_pred_dir": odom,
            "data_splits": ["val"]}},
        {"task": "fg", "data": dict(
            _fg_cfg({"fg": fg, "odom": odom, "bg_export": None}, "gt_odom")["data"],
            data_splits=["val"], output_ind=0, odom_pred_dir=odom)},
    ]
    for cfg in cfgs:
        want = build_dataset(cfg, test=True).datasets["val"]
        with synthetic.readers_from_store(store):
            got = build_dataset(cfg, test=True).datasets["val"]
        assert len(got) == len(want) == 2
        for i in range(len(want)):
            _assert_tree_equal(want[i], got[i], f"{cfg['task']}[{i}]")
