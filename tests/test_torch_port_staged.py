"""Port parity of the staged evaluation chain: the pc export, the bg data
(``prepare_bg_data``, ``prepare_gt_nofg``), the bg canvases
(``export_segmentation``), the panoptic and instance exports over them,
and instance AP, each CLI of both packages on one fixture.

The fixture is the JAX package's ``data/synthetic.py`` at 64x128 (3
Cityscapes snippets, 2 fg scenes) with predicted odometry, gap 9 (the
bg config's ``gap_len: [9]``). Weights are seeded by the JAX models and
carried over through ``models/convert.py`` (bg: the JAX checkpoint and
the port's; fg: one reference-format ``.pt`` for both). Each chain runs
once (module fixture); the JAX models run jitted
(``test_torch_port_common.jit_jax_models``).

Budgets: the pc export, the bg data and gt_nofg are the JAX package's
files byte for byte (PNG through the port's libpng-exact encoder, the
depth ``.npy``), and the depth h5 holds equal blocks; the canvases are
equal wherever the top-2 logit gap is > 1e-4 (argmax of f32 sums taken
in another order); panoptic maps on the same canvases have equal ids and
differ on < 1e-3 of pixels, with equal json; instance manifests are
equal. The port's staged chain against its fused CLI: equal id sets and
< 2 % of pixels (the JAX package's own budget, tests/test_e2e_pipeline.py:
216-224: depth passes through (depth+1)·256 uint16 and PNG), differing
where the JAX package's staged chain and fused CLI differ.
"""

import glob
import json
import os

import jax
import numpy as np
import pytest
import torch
import yaml

from panoptic_forecasting_tpu.cli import (
    evaluate_instances as jax_evaluate_instances,
    export_instances as jax_export_instances,
    export_panoptic as jax_export_panoptic,
    export_segmentation as jax_export_segmentation,
    forecast_fused as jax_forecast_fused,
    prepare_bg_data as jax_prepare_bg_data,
    prepare_gt_nofg as jax_prepare_gt_nofg,
)
from panoptic_forecasting_tpu.core import build_dataset as jax_build_dataset
from panoptic_forecasting_tpu.core import build_model as jax_build_model
from panoptic_forecasting_tpu.core import checkpoint as jax_ckpt
from panoptic_forecasting_tpu.data.cards import DataCard as JaxDataCard
from panoptic_forecasting_tpu.data.synthetic import (
    write_cityscapes_fixture,
    write_fg_fixture,
)
from panoptic_forecasting_tpu_torch.cli import (
    evaluate_instances,
    export_instances,
    export_panoptic,
    export_segmentation,
    forecast_fused,
    prepare_bg_data,
    prepare_gt_nofg,
)
from panoptic_forecasting_tpu_torch.core import build_dataset, build_model, load_config
from panoptic_forecasting_tpu_torch.core import checkpoint as ckpt
from panoptic_forecasting_tpu_torch.data import io, synthetic
from panoptic_forecasting_tpu_torch.data.cards import DataCard
from panoptic_forecasting_tpu_torch.eval.pq import decode_panoptic_png
from panoptic_forecasting_tpu_torch.models.convert import (
    bg_state_dict_from_jax,
    fg_state_dict_from_jax,
)
from test_torch_port_common import FG_MODEL, jit_jax_models

torch.set_num_threads(2)

H, W = 64, 128
PANOPTIC = "exported_panoptics_val"
FG_STATS = {  # (mean, std) of boxes/velocities in a 128-wide frame
    "traj": ([64, 32, 16, 16, 0, 0, 0, 0], [30, 12, 6, 6, 2, 1, 1, 1]),
    "depth": ([20.0, 0.0], [10.0, 1.0]),
    "odom": ([8.2, 0.0, 0.5, 0.0, 0.0], [0.3, 0.01, 0.02, 1.0, 1.0]),
}
JAX_CACHE_KEYS = ("jax_compilation_cache_dir",
                  "jax_persistent_cache_min_compile_time_secs",
                  "jax_persistent_cache_min_entry_size_bytes")


def _dump(path, cfg):
    with open(path, "w") as f:
        yaml.safe_dump(cfg, f)
    return path


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    saved = {k: getattr(jax.config, k) for k in JAX_CACHE_KEYS}
    try:
        with pytest.MonkeyPatch.context() as mp:
            jit_jax_models(mp)
            return _world(str(tmp_path_factory.mktemp("staged")))
    finally:
        for k, v in saved.items():
            jax.config.update(k, v)


def _configs(root, side, cs, fg, odom):
    """The side's pc, bg and fg configs (each side reads its own bg data)."""
    d = os.path.join(root, side)
    os.makedirs(d)
    bg_data = os.path.join(d, "bg_data")
    pc = _dump(os.path.join(d, "pc.yaml"), {
        "task": "pc_transform", "save_depth": True,
        "data": {"dataset_type": "pc_transform", "data_splits": ["val"],
                 "cityscapes_dir": cs, "data_dir": cs, "seg_dir": cs + "/seg",
                 "gap_len": 9, "no_moving_objects": True, "odom_pred_dir": odom},
        "training": {"batch_size": 2, "num_data_threads": 0},
    })
    bg = _dump(os.path.join(d, "bg.yaml"), {
        "task": "bg",
        "data": {"data_splits": ["val"], "cityscapes_dir": cs, "data_inp_size": 3,
                 "data_dir": [os.path.join(bg_data, f"point_cloud_static_ind{i}_all",
                                           "exported_predictions") for i in range(3)],
                 "gap_len": [9], "gt_dir": os.path.join(d, "nofg"),
                 "depth_h5_path": os.path.join(bg_data, "depths_decompressed_%s.h5"),
                 "only_background": True, "use_depths": True, "load_depths": True,
                 "min_depth": 0.1, "max_depth": 200, "no_resize_crop": True},
        "model": {"num_inputs": 3, "use_depth_inps": True, "convert2onehot": True},
        "training": {"batch_size": 2, "num_data_threads": 0},
    })
    fg_cfg = {"task": "fg",
              "data": {"dataset_type": "fg_scene", "data_splits": ["val"],
                       "data_dir": fg, "depth_dir": fg, "feats_dir": fg,
                       "info_3d_dir": fg, "cityscapes_dir": cs,
                       "odom_pred_dir": odom, "output_ind": 0,
                       "require_most_recent": True, "use_3d_info": True,
                       "max_depth": 200, "instance_pad_multiple": 4,
                       # the JAX canvases: both panoptic exports fuse over them
                       "background_dir": os.path.join(root, "jax", "bg_run",
                                                      "bg_export")},
              "model": FG_MODEL,
              "training": {"batch_size": 2}}
    return {"dir": d, "pc": pc, "bg": bg, "fg": _dump(os.path.join(d, "fg.yaml"), fg_cfg),
            "fg_cfg": fg_cfg, "bg_data": bg_data}


def _run_chain(side, c, cs, fg_pt, cache_dir):
    """Every CLI of the chain on one side; returns the reports of
    ``prepare_bg_data`` and of the canvas export (None in JAX)."""
    if side == "jax":
        mods = (jax_export_segmentation, jax_prepare_bg_data, jax_prepare_gt_nofg,
                jax_export_panoptic, jax_export_instances)
        extra = ["--set", "compilation_cache_dir", cache_dir]
    else:
        mods = (export_segmentation, prepare_bg_data, prepare_gt_nofg,
                export_panoptic, export_instances)
        extra = ["--set", "platform", "cpu"]
    seg, bgdata, nofg, panoptic, instances = mods
    d = c["dir"]
    seg.main(["--working_dir", os.path.join(d, "pc_run"), "--config_file", c["pc"]]
             + extra)
    report = bgdata.main(["--working_dir", os.path.join(d, "pc_run"),
                          "--config_file", c["pc"], "--set", "bg_out", c["bg_data"]]
                         + extra)
    nofg.main(["--cityscapes_dir", cs, "--splits", "val", "--out_dir",
               os.path.join(d, "nofg")])
    canvases = seg.main(["--working_dir", os.path.join(d, "bg_run"),
                         "--config_file", c["bg"], "--set", "no_convert", "true",
                         "--set", "export_name", "bg_export"] + extra)
    fg_argv = ["--working_dir", os.path.join(d, "fg_run"), "--config_file", c["fg"],
               "--load_torch_model", fg_pt] + extra
    panoptic.main(fg_argv)
    instances.main(fg_argv)
    return report, canvases


def _world(root):
    cs, fg, odom = (os.path.join(root, k) for k in ("cs", "fg", "odom"))
    os.makedirs(odom)
    write_cityscapes_fixture(cs, split="val", n_snippets=3, height=H, width=W)
    write_fg_fixture(fg, splits=("val",), n_scenes=2, max_instances=3,
                     feat_channels=32, feat_hw=7)
    for name, table, start in (("odometry", cs, 10), ("predicted_odometry", fg, 16)):
        rows = io.read_table(os.path.join(table, "val_3d_info.pkl"))
        synthetic.write_odom_predictions(os.path.join(odom, f"{name}_val.h5"),
                                         rows, starts=(start,), seed=start)
    cfgs = {side: _configs(root, side, cs, fg, odom) for side in ("jax", "port")}

    # seeded JAX bg weights in both packages' checkpoints (the JAX bg
    # model's example batch is the port's, from the same files)
    with open(cfgs["jax"]["bg"]) as f:
        bg_cfg = yaml.safe_load(f)
    jax_bg = jax_build_model(bg_cfg, JaxDataCard(task="bg", num_classes=11))
    seg_in = np.zeros((1, 3, H, W), np.uint8)
    dep_in = np.zeros((1, 3, H, W), np.uint16)
    bg_vars = jax.tree_util.tree_map(np.asarray, jax_bg.init(
        jax.random.PRNGKey(1), {"inputs": {"seg": seg_in, "depth": dep_in}}))
    jax_ckpt.save_model(os.path.join(cfgs["jax"]["dir"], "bg_run"), bg_vars, best=True)
    port_bg = build_model(bg_cfg, DataCard(task="bg", num_classes=11), "cpu")
    port_bg.load_state_dict(bg_state_dict_from_jax(bg_vars))
    ckpt.save_model(os.path.join(cfgs["port"]["dir"], "bg_run"), port_bg, best=True)
    # fg: a reference-format .pt (the port's names) both CLIs load
    fg_cfg = cfgs["jax"]["fg_cfg"]  # (its example batch without the canvases)
    fg_cfg = dict(fg_cfg, data=dict(fg_cfg["data"], background_dir=None))
    fg_data = jax_build_dataset(fg_cfg, test=True)
    batch = next(iter(fg_data.loader("val", fg_cfg, test=True)))
    fg_vars = jax.tree_util.tree_map(np.asarray, jax_build_model(
        fg_cfg, fg_data.card).init(jax.random.PRNGKey(0), batch))
    fg_pt = os.path.join(root, "fg_reference.pt")
    torch.save(fg_state_dict_from_jax(fg_vars["params"], FG_STATS), fg_pt)

    cache_dir = jax.config.jax_compilation_cache_dir
    reports = {side: _run_chain(side, cfgs[side], cs, fg_pt, cache_dir)
               for side in ("jax", "port")}

    # the port's own staged chain: panoptic over its canvases, and the
    # fused CLI on the same models and inputs
    port = cfgs["port"]
    own = dict(port["fg_cfg"], data=dict(
        port["fg_cfg"]["data"],
        background_dir=os.path.join(port["dir"], "bg_run", "bg_export")))
    own_fg = _dump(os.path.join(port["dir"], "fg_own.yaml"), own)
    fg_argv = ["--working_dir", os.path.join(port["dir"], "fg_run"),
               "--config_file", own_fg, "--load_torch_model", fg_pt,
               "--set", "platform", "cpu"]
    staged = export_panoptic.main(fg_argv + ["--set", "export_name", "staged"])
    forecast_fused.main(fg_argv + [
        "--set", "fused.bg_config", port["bg"],
        "--set", "fused.bg_dir", os.path.join(port["dir"], "bg_run"),
        "--set", "fused.pc_config", port["pc"],
        "--set", "fused.height", str(H), "--set", "fused.width", str(W)])
    # the JAX package's fused CLI, against its staged chain (its panoptic
    # export fuses over its own canvases)
    jx = cfgs["jax"]
    jax_forecast_fused.main([
        "--working_dir", os.path.join(jx["dir"], "fg_run"), "--config_file", jx["fg"],
        "--load_torch_model", fg_pt, "--set", "compilation_cache_dir", cache_dir,
        "--set", "fused.bg_config", jx["bg"],
        "--set", "fused.bg_dir", os.path.join(jx["dir"], "bg_run"),
        "--set", "fused.pc_config", jx["pc"],
        "--set", "fused.height", str(H), "--set", "fused.width", str(W)])
    return {"root": root, "cs": cs, "cfgs": cfgs, "reports": reports,
            "staged_report": staged, "bg_vars": bg_vars}


def _files(root, pattern):
    return {os.path.relpath(p, root): p
            for p in sorted(glob.glob(os.path.join(root, pattern), recursive=True))}


def _same_bytes(a_root, b_root, pattern, expect):
    a, b = _files(a_root, pattern), _files(b_root, pattern)
    assert sorted(a) == sorted(b) and len(a) == expect, (sorted(a), sorted(b))
    for rel in a:
        with open(a[rel], "rb") as fa, open(b[rel], "rb") as fb:
            assert fa.read() == fb.read(), rel


def _side(world, side, *parts):
    return os.path.join(world["cfgs"][side]["dir"], *parts)


def test_pc_export_is_jax_byte_for_byte(world):
    """The reprojected segmentations (labelIds) and depths (.npy) of the
    pc export (configs/pc_transform/pc_export.yaml's ``save_depth``)."""
    a, b = (_side(world, s, "pc_run", "exported_predictions") for s in ("jax", "port"))
    _same_bytes(a, b, "**/*.png", 3)
    _same_bytes(a, b, "**/*_depths.npy", 3)


def test_prepare_bg_data_is_jax_byte_for_byte(world):
    """Three seg trees (one per input index) and the depth h5: one
    (H, W, 3) uint16 block per frame, equal to JAX's, read through the
    port's ``io.open_h5``; the pc fetch is paid once a batch."""
    a, b = (_side(world, s, "bg_data") for s in ("jax", "port"))
    _same_bytes(a, b, "point_cloud_static_ind*_all/**/*.png", 9)
    key = "synthcity/{:06d}/000019/0"
    ha, hb = (io.open_h5(os.path.join(r, "depths_decompressed_val.h5")) for r in (a, b))
    for s in range(3):
        want, got = np.asarray(ha[key.format(s)][:]), np.asarray(hb[key.format(s)][:])
        assert got.dtype == np.uint16 and got.shape == (H, W, 3)
        np.testing.assert_array_equal(got, want)
        assert (got > 0).any(axis=(0, 1)).all()  # every index splatted depth
    rep = world["reports"]["port"][0]["val"]
    assert rep["frames"] == 3 and len(rep["predict_ms"]) == 3


def test_gt_nofg_is_jax_byte_for_byte(world):
    a, b = (_side(world, s, "nofg") for s in ("jax", "port"))
    _same_bytes(a, b, "**/*.png", 3)
    got = io.load_png(next(iter(_files(b, "**/*.png").values())))
    assert got.max() == 255 and not ((got >= 11) & (got < 255)).any()


def test_bg_canvases_match_jax_off_near_ties(world):
    """The bg export (folded, K2's plain version on the CPU) against
    JAX's: equal class ids wherever the top-2 logit gap is > 1e-4; its
    ``main`` reports the export's dir, frames and seconds."""
    a, b = (_side(world, s, "bg_run", "bg_export") for s in ("jax", "port"))
    rep = world["reports"]["port"][1]["val"]
    assert rep["dir"] == os.path.join(b, "val") and rep["frames"] == 3
    assert rep["seconds"] > 0
    ja, pb = _files(a, "**/*.png"), _files(b, "**/*.png")
    assert sorted(ja) == sorted(pb) and len(ja) == 3
    bg_cfg = load_config(["--working_dir", _side(world, "port", "bg_run"),
                          "--config_file", world["cfgs"]["port"]["bg"]])
    data = build_dataset(bg_cfg, test=True)
    model = build_model(bg_cfg, data.card, "cpu")
    model.load_state_dict(bg_state_dict_from_jax(world["bg_vars"]))
    checked = 0
    for sample in data.datasets["val"]:
        batch = {k: np.asarray(v)[None] for k, v in sample["inputs"].items()}
        top2 = torch.topk(model(batch)[0], 2, dim=0).values
        sure = (top2[0] - top2[1] > 1e-4).numpy()
        meta = sample["meta"]
        rel = os.path.join("val", meta["city"], f"{meta['city']}_{meta['seq']}_"
                           f"{meta['target_frame']:06d}_gtFine_labelIds.png")
        want, got = io.load_png(ja[rel]), io.load_png(pb[rel])
        np.testing.assert_array_equal(got[sure], want[sure])
        assert got.max() < 11 and sure.mean() > 0.99
        checked += 1
    assert checked == 3


def _panoptic(run_dir, name=PANOPTIC):
    with open(os.path.join(run_dir, name, f"{name}.json")) as f:
        anns = json.load(f)["annotations"]
    maps = {a["image_id"]: decode_panoptic_png(io.load_png(
        os.path.join(run_dir, name, name, a["file_name"]))) for a in anns}
    return maps, anns


def test_export_panoptic_matches_jax(world):
    """Both exports over the JAX canvases: the same frames (2 fused, 1
    backfilled from its canvas), equal ids, < 1e-3 of pixels apart,
    equal json."""
    want, want_anns = _panoptic(_side(world, "jax", "fg_run"))
    got, anns = _panoptic(_side(world, "port", "fg_run"))
    assert list(got) == list(want) == [f"synthcity_{s:06d}_000019" for s in range(3)]
    for name, pan in got.items():
        assert set(np.unique(pan)) == set(np.unique(want[name])), name
        assert (pan != want[name]).mean() < 1e-3, name
    assert sum(int((m >= 1000).sum()) for m in got.values()) > 0
    assert anns == want_anns


def test_export_instances_matches_jax(world):
    """Manifests name for name and line for line; each mask within the
    panoptic budget; a manifest (empty where none) for every gt frame."""
    a, b = (_side(world, s, "fg_run", "exported_instances_val") for s in ("jax", "port"))
    ta, tb = _files(a, "*.txt"), _files(b, "*.txt")
    assert sorted(ta) == sorted(tb) and len(ta) == 3
    for rel in ta:
        assert open(tb[rel]).read() == open(ta[rel]).read(), rel
    ma, mb = _files(a, "*.png"), _files(b, "*.png")
    assert sorted(ma) == sorted(mb) and len(ma) > 0
    for rel in ma:
        got, want = io.load_png(mb[rel]), io.load_png(ma[rel])
        assert got.shape == (H, W) and set(np.unique(got)) <= {0, 255}
        assert (got != want).mean() < 1e-3, rel
    assert open(tb["synthcity_000002_000019.txt"]).read() == ""


def test_evaluate_instances_matches_jax(world, tmp_path):
    """Both scorers on both exports give JAX's results; the fixture's GT
    has no thing instance: allAp 0 and NaN (null in the json) per class."""
    cs = world["cs"]
    for side in ("jax", "port"):
        argv = ["--pred_dir", _side(world, side, "fg_run", "exported_instances_val"),
                "--cityscapes_dir", cs, "--split", "val"]
        want = jax_evaluate_instances.main(argv)
        out = str(tmp_path / f"{side}.json")
        got = evaluate_instances.main(argv + ["--results_json", out])
        assert json.dumps(got) == json.dumps(want)
        assert got["allAp"] == 0.0
        assert all(np.isnan(v["ap"]) for v in got["per_class"].values())
        with open(out) as f:
            assert all(v["ap"] is None for v in json.load(f)["per_class"].values())


def test_staged_chain_matches_fused(world):
    """The port's staged chain (its own pc export, bg data, canvases and
    panoptic export) against its fused CLI on the same models: equal
    segment id sets, < 2 % of pixels apart. ``export_panoptic.main``
    reports the export's dir, its fused frames and its seconds."""
    run = _side(world, "port", "fg_run")
    rep = world["staged_report"]["val"]
    assert rep["dir"] == os.path.join(run, "staged_val")
    assert rep["frames"] == 2 and rep["seconds"] > 0
    staged, _ = _panoptic(run, "staged_val")
    fused, _ = _panoptic(run, "fused_panoptics_val")
    assert list(fused) == list(staged)
    for name, pan in fused.items():
        assert set(np.unique(pan)) == set(np.unique(staged[name])), name
        assert (pan != staged[name]).mean() < 0.02, name


def test_staged_against_fused_as_jax(world):
    """The JAX package's staged chain against its own fused CLI differs
    on the pixels where the port's does (within the panoptic budget),
    with the same segment ids in one map only: the gap between the two
    chains (the fused step reads the z-buffer's label 0 as road, the
    staged chain as void; the staged depth's uint16 code) is the
    reference's."""
    def gaps(side, staged_name):
        run = _side(world, side, "fg_run")
        staged, _ = _panoptic(run, staged_name)
        fused, _ = _panoptic(run, "fused_panoptics_val")
        assert list(fused) == list(staged)
        return {name: (staged[name] != f, set(np.unique(staged[name])) ^ set(np.unique(f)))
                for name, f in fused.items()}

    want, got = gaps("jax", PANOPTIC), gaps("port", "staged_val")
    assert list(got) == list(want) and sum(int(m.sum()) for m, _ in want.values()) > 0
    for name, (differ, ids) in got.items():
        assert ids == want[name][1], name
        assert (differ != want[name][0]).mean() < 1e-3, name


@pytest.mark.parametrize("variant", ["raw_depth", "host_depth_decode", "resize", "npy"])
def test_bg_dataset_matches_jax(world, variant, tmp_path):
    """The test-mode BGDataset of both packages on the port's bg data:
    the same samples (GT frames x gap groups) and the same items (seg
    triplet, raw or host-decoded depth block, labels, meta). ``npy``:
    the data as ``prepare_bg_data --set bg_out_format npy`` writes it (the
    seg maps equal to the PNG tree's), detected from the first sample."""
    from panoptic_forecasting_tpu.data.bg_data import BGDataset as JaxBGDataset
    from panoptic_forecasting_tpu_torch.data.bg_data import BGDataset

    with open(world["cfgs"]["port"]["bg"]) as f:
        cfg = yaml.safe_load(f)
    d = cfg["data"]
    if variant == "host_depth_decode":
        d["host_depth_decode"] = True
    elif variant == "resize":
        d.update(resize_h=32, resize_w=48)
    elif variant == "npy":
        out = str(tmp_path / "bg_npy")
        prepare_bg_data.main(["--working_dir", str(tmp_path / "pc_run"),
                              "--config_file", world["cfgs"]["port"]["pc"],
                              "--set", "bg_out", out, "--set", "bg_out_format", "npy",
                              "--set", "platform", "cpu"])
        pngs = _files(world["cfgs"]["port"]["bg_data"], "point_cloud_static_ind*_all/**/*.png")
        for rel, path in pngs.items():
            np.testing.assert_array_equal(np.load(os.path.join(out, rel[:-4] + ".npy")),
                                          io.load_png(path))
        d["data_dir"] = [p.replace(world["cfgs"]["port"]["bg_data"], out)
                         for p in d["data_dir"]]
        d["depth_h5_path"] = os.path.join(out, "depths_decompressed_%s.h5")
    want = JaxBGDataset("val", cfg, JaxDataCard(task="bg"), test=True)
    got = BGDataset("val", cfg, DataCard(task="bg"), test=True)
    assert got.samples == want.samples and len(got) == 3
    assert got.seg_npy == want.seg_npy == (variant == "npy")
    for i in range(len(got)):
        g, w = got[i], want[i]
        assert g["meta"] == w["meta"] and g["meta"]["target_frame"] == 19
        for part in ("inputs", "labels"):
            assert g[part].keys() == w[part].keys()
            for k in w[part]:
                assert g[part][k].dtype == w[part][k].dtype, k
                np.testing.assert_array_equal(g[part][k], w[part][k])


def test_prepare_bg_data_into_the_store(world, tmp_path):
    """On a machine without h5py the depth blocks go into the fixture's
    memory (``readers_from_store``: ``io.append_h5``), equal to the file's,
    and ``BGDataset`` reads them back through ``io.open_h5``."""
    from panoptic_forecasting_tpu_torch.data.bg_data import BGDataset

    out = str(tmp_path / "bg_mem")
    store = synthetic.new_store()
    with synthetic.readers_from_store(store, tables=False, arrays=True):
        prepare_bg_data.main(["--working_dir", str(tmp_path / "pc_run"),
                              "--config_file", world["cfgs"]["port"]["pc"],
                              "--set", "bg_out", out, "--set", "platform", "cpu"])
        h5_path = os.path.join(out, "depths_decompressed_val.h5")
        assert not os.path.exists(h5_path)
        with open(world["cfgs"]["port"]["bg"]) as f:
            cfg = yaml.safe_load(f)
        cfg["data"]["depth_h5_path"] = os.path.join(out, "depths_decompressed_%s.h5")
        ds = BGDataset("val", cfg, DataCard(task="bg"), test=True)
        depth = ds[0]["inputs"]["depth"]
    blocks = store["arrays"][h5_path]
    ref = io.open_h5(os.path.join(world["cfgs"]["port"]["bg_data"],
                                  "depths_decompressed_val.h5"))
    assert sorted(blocks) == [f"synthcity/{s:06d}/000019/0" for s in range(3)]
    for key, block in blocks.items():
        np.testing.assert_array_equal(block, np.asarray(ref[key][:]))
    np.testing.assert_array_equal(depth, np.moveaxis(blocks["synthcity/000000/000019/0"], -1, 0))
