"""Port parity of the serving CLI: ``forecast_fused`` of both packages on
one fixture with the same weights.

The fixture comes from the JAX package's ``data/synthetic.py`` at 64x128
(3 Cityscapes snippets, 2 fg scenes, so one gt frame is backfilled from
its bg canvas), with predicted odometry for the pc and fg readers.
Weights are initialised by the JAX models from a seed and carried
across through ``models/convert.py``: the bg model's saved through the
JAX package's checkpointer and, converted, in the port's checkpoint
format; the fg model's as one reference-format ``.pt`` both CLIs load
with ``--load_torch_model`` (which also brings its normalisation
statistics). Each CLI runs once (module fixture). The outputs must have the same PNG names and segment id sets;
panoptic maps may differ on < 1e-3 of pixels (threshold-boundary flips,
the budget of tests/test_torch_port_forecast.py); the json
``segments_info`` must be equal.
"""

import glob
import json
import os

import jax
import numpy as np
import pytest
import torch
import yaml
from PIL import Image

from panoptic_forecasting_tpu.cli import forecast_fused as jax_cli
from panoptic_forecasting_tpu.core import build_dataset as jax_build_dataset
from panoptic_forecasting_tpu.core import build_model as jax_build_model
from panoptic_forecasting_tpu.core import checkpoint as jax_ckpt
from panoptic_forecasting_tpu.models.bg import BGModel as JaxBGModel
from panoptic_forecasting_tpu.models.fg import FGModel as JaxFGModel
from panoptic_forecasting_tpu.data.synthetic import (
    write_bg_fixture,
    write_cityscapes_fixture,
    write_fg_fixture,
)
from panoptic_forecasting_tpu_torch.cli import forecast_fused
from panoptic_forecasting_tpu_torch.core import build_model, load_config
from panoptic_forecasting_tpu_torch.core import checkpoint as ckpt
from panoptic_forecasting_tpu_torch.data import synthetic
from panoptic_forecasting_tpu_torch.data.io import load_png
from panoptic_forecasting_tpu_torch.eval.pq import decode_panoptic_png
from panoptic_forecasting_tpu_torch.models.convert import (
    bg_state_dict_from_jax,
    fg_state_dict_from_jax,
)
from test_torch_port_common import FG_MODEL

torch.set_num_threads(2)

H, W = 64, 128
EXPORT = "fused_panoptics_val"
FG_STATS = {  # (mean, std) of boxes/velocities in a 128-wide frame
    "traj": ([64, 32, 16, 16, 0, 0, 0, 0], [30, 12, 6, 6, 2, 1, 1, 1]),
    "depth": ([20.0, 0.0], [10.0, 1.0]),
    "odom": ([8.2, 0.0, 0.5, 0.0, 0.0], [0.3, 0.01, 0.02, 1.0, 1.0]),
}


def _dump(path, cfg):
    with open(path, "w") as f:
        yaml.safe_dump(cfg, f)
    return path


def _jitted_inits(mp):
    """The JAX models' ``init`` under ``jax.jit``. The JAX CLI initialises
    each model (eagerly, op by op: minutes for HarDNet on the CPU) before
    it restores the checkpoint over it; jitted, the structure and values
    are the same."""
    for cls in (JaxBGModel, JaxFGModel):
        def init(self, rng, batch, _orig=cls.init):
            if isinstance(self, JaxBGModel):  # the bg init reads inputs only
                return jax.jit(lambda r, x: _orig(self, r, {"inputs": x}))(
                    rng, batch["inputs"])
            return jax.jit(lambda r: _orig(self, r, batch))(rng)
        mp.setattr(cls, "init", init)


# JAX settings the JAX CLI changes for its process (cli/common.py)
JAX_CACHE_KEYS = ("jax_compilation_cache_dir",
                  "jax_persistent_cache_min_compile_time_secs",
                  "jax_persistent_cache_min_entry_size_bytes")


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    saved = {k: getattr(jax.config, k) for k in JAX_CACHE_KEYS}
    try:
        with pytest.MonkeyPatch.context() as mp:
            _jitted_inits(mp)
            return _world(str(tmp_path_factory.mktemp("portcli")))
    finally:
        for k, v in saved.items():
            jax.config.update(k, v)


def _world(root):
    cs, fg, odom, canvases = (os.path.join(root, d)
                              for d in ("cs", "fg", "odom", "bg_export"))
    os.makedirs(odom)
    write_cityscapes_fixture(cs, split="val", n_snippets=3, height=H, width=W)
    write_fg_fixture(fg, splits=("val",), n_scenes=2, max_instances=3,
                     feat_channels=32, feat_hw=7)
    bg_data = write_bg_fixture(os.path.join(root, "bgdata"), splits=("val",),
                               n_snippets=1, height=H, width=W)
    import pandas as pd

    rows = pd.read_pickle(os.path.join(cs, "val_3d_info.pkl")).to_dict("records")
    synthetic.write_odom_predictions(os.path.join(odom, "odometry_val.h5"), rows,
                                     starts=(10,), seed=1)
    rows = pd.read_pickle(os.path.join(fg, "val_3d_info.pkl")).to_dict("records")
    synthetic.write_odom_predictions(os.path.join(odom, "predicted_odometry_val.h5"),
                                     rows, starts=(16,), seed=2)
    rng = np.random.RandomState(3)
    for s in range(3):  # bg canvases (trainIds) of every target frame
        p = os.path.join(canvases, "val", "synthcity",
                         f"synthcity_{s:06d}_000019_gtFine_labelIds.png")
        os.makedirs(os.path.dirname(p), exist_ok=True)
        Image.fromarray(rng.randint(0, 11, (H, W)).astype(np.uint8)).save(p)

    pc_cfg = _dump(os.path.join(root, "pc.yaml"), {
        "task": "pc_transform",
        "data": {"cityscapes_dir": cs, "data_dir": cs, "seg_dir": cs + "/seg",
                 "gap_len": 9, "no_moving_objects": True, "odom_pred_dir": odom},
        "training": {"batch_size": 1},
    })
    bg = {"task": "bg",
          "data": dict(bg_data, data_splits=["val"], only_background=True,
                       use_depths=True, min_depth=0.1, max_depth=200,
                       no_resize_crop=True),
          "model": {"num_inputs": 3, "use_depth_inps": True,
                    "convert2onehot": True},
          "training": {"batch_size": 1, "num_data_threads": 0}}
    bg_cfg = _dump(os.path.join(root, "bg.yaml"), bg)
    fg_cfg = {"task": "fg",
              "data": {"dataset_type": "fg_scene", "data_splits": ["val"],
                       "data_dir": fg, "depth_dir": fg, "feats_dir": fg,
                       "info_3d_dir": fg, "cityscapes_dir": cs,
                       "odom_pred_dir": odom, "background_dir": canvases,
                       "output_ind": 0, "require_most_recent": True,
                       "use_3d_info": True, "max_depth": 200,
                       "instance_pad_multiple": 4},
              "model": FG_MODEL,
              "training": {"batch_size": 2}}
    fg_cfg_path = _dump(os.path.join(root, "fg.yaml"), fg_cfg)

    # seeded JAX weights, in the JAX package's checkpoints and the port's
    dirs = {k: os.path.join(root, k) for k in ("jax_bg", "jax_fg", "port_bg", "port_fg")}
    bg_data_j = jax_build_dataset(dict(bg, working_dir=dirs["jax_bg"]), test=True)
    bg_model = jax_build_model(bg, bg_data_j.card)
    batch = next(iter(bg_data_j.loader("val", bg, test=True)))
    bg_vars = jax.tree_util.tree_map(
        np.asarray, bg_model.init(jax.random.PRNGKey(1), batch))
    jax_ckpt.save_model(dirs["jax_bg"], bg_vars, best=True)
    port_bg = build_model(bg, bg_data_j.card, "cpu")
    port_bg.load_state_dict(bg_state_dict_from_jax(bg_vars))
    ckpt.save_model(dirs["port_bg"], port_bg, best=True)

    fg_data_j = jax_build_dataset(fg_cfg, test=True)
    fg_model = jax_build_model(fg_cfg, fg_data_j.card)
    batch = next(iter(fg_data_j.loader("val", fg_cfg, test=True)))
    fg_vars = jax.tree_util.tree_map(
        np.asarray, fg_model.init(jax.random.PRNGKey(0), batch))
    # fg: a reference-format .pt (the port's names) with statistics that
    # put the forecast boxes inside the 64x128 frame
    fg_pt = os.path.join(root, "fg_reference.pt")
    torch.save(fg_state_dict_from_jax(fg_vars["params"], FG_STATS), fg_pt)

    def argv(side):
        return ["--working_dir", dirs[f"{side}_fg"], "--config_file", fg_cfg_path,
                "--load_torch_model", fg_pt,
                "--set", "fused.bg_config", bg_cfg,
                "--set", "fused.bg_dir", dirs[f"{side}_bg"],
                "--set", "fused.pc_config", pc_cfg,
                "--set", "fused.height", str(H), "--set", "fused.width", str(W)]

    # the JAX CLI keeps the tests' compilation cache (tests/conftest.py)
    jax_cli.main(argv("jax") + ["--set", "compilation_cache_dir",
                                jax.config.jax_compilation_cache_dir])
    report = forecast_fused.run(load_config(argv("port") + ["--set", "platform", "cpu"]))
    return {"dirs": dirs, "argv": argv, "report": report, "bg_cfg": bg_cfg}


def _outputs(run_dir):
    pngs = sorted(glob.glob(os.path.join(run_dir, EXPORT, EXPORT, "*.png")))
    with open(os.path.join(run_dir, EXPORT, f"{EXPORT}.json")) as f:
        anns = json.load(f)["annotations"]
    return pngs, anns


def test_cli_writes_the_same_files(world):
    jax_pngs, jax_anns = _outputs(world["dirs"]["jax_fg"])
    pngs, anns = _outputs(world["dirs"]["port_fg"])
    names = [os.path.basename(p) for p in pngs]
    assert names == [os.path.basename(p) for p in jax_pngs]
    assert names == [f"synthcity_{s:06d}_000019_pred_panoptic.png" for s in range(3)]
    assert [a["file_name"] for a in anns] == [a["file_name"] for a in jax_anns]
    assert [a["image_id"] for a in anns] == [a["image_id"] for a in jax_anns]


def test_cli_panoptic_maps_match_jax(world):
    jax_pngs, _ = _outputs(world["dirs"]["jax_fg"])
    pngs, _ = _outputs(world["dirs"]["port_fg"])
    things = 0
    for path, ref_path in zip(pngs, jax_pngs):
        got = decode_panoptic_png(load_png(path))
        want = decode_panoptic_png(np.array(Image.open(ref_path)))
        assert got.shape == want.shape
        assert set(np.unique(got)) == set(np.unique(want)), path
        mismatch = float((got != want).mean())
        assert mismatch < 1e-3, f"{path}: {mismatch:.2%} pixels differ"
        things += int((got >= 1000).sum())
    assert things > 0  # instances were painted


def test_cli_segments_info_match_jax(world):
    _, jax_anns = _outputs(world["dirs"]["jax_fg"])
    _, anns = _outputs(world["dirs"]["port_fg"])
    assert anns == jax_anns


def test_cli_backfills_and_reports(world):
    """Two frames forecast, the third gt frame backfilled from its bg
    canvas; the run reports each stage's host time per frame."""
    rep = world["report"]["val"]
    assert (rep["frames"], rep["skipped"]) == (2, 0)
    _, anns = _outputs(world["dirs"]["port_fg"])
    assert len(anns) == 3 and anns[2]["image_id"] == "synthcity_000002_000019"
    assert all(s["id"] < 1000 for s in anns[2]["segments_info"])
    ms = rep["ms"]
    for stage in ("pc_fetch", "step", "annotate", "png_write"):
        assert len(ms[stage]) == 2, stage
    assert len(ms["fg_batch"]) == 1 and rep["seconds"] > 0


def test_cli_bg_depth_stats_as_jax(world, monkeypatch):
    """Both CLIs serve the bg model with depth mean 0, std 1, although the
    bg run holds a data card with other statistics (the JAX package writes
    one at training, cli/train.py:21, and never reads it back)."""
    from panoptic_forecasting_tpu.data.cards import DataCard

    _jitted_inits(monkeypatch)
    for side in ("jax", "port"):
        card = DataCard(task="bg", num_classes=11)
        card.set_stats("depth", [20.0], [12.0])
        card.save(world["dirs"][f"{side}_bg"])
    fused = {"bg_config": world["bg_cfg"]}
    jax_model, _ = jax_cli._build_bg(dict(fused, bg_dir=world["dirs"]["jax_bg"]))
    port_model = forecast_fused._build_bg(
        dict(fused, bg_dir=world["dirs"]["port_bg"]), torch.device("cpu"))
    assert (jax_model.depth_mean, jax_model.depth_std) == (0.0, 1.0)
    assert (float(port_model.depth_mean), float(port_model.depth_std)) == (0.0, 1.0)
    assert port_model.folded


def test_cli_device_rule(world, monkeypatch):
    """Without ``platform cpu`` the CLI wants CUDA and raises without it;
    a missing ``fused`` key stops it before anything runs."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        forecast_fused.main(world["argv"]("port"))
    argv = world["argv"]("port")
    i = argv.index("fused.pc_config")
    with pytest.raises(SystemExit, match="fused.pc_config"):
        forecast_fused.main(argv[:i - 1] + argv[i + 2:])


def test_cli_scores_match_jax(world, tmp_path):
    """Both ``evaluate_panoptic`` CLIs score each package's export of the
    module fixture against its GT (converted from gtFine on the fly, each
    package into its own directory) and give equal results; the port's
    ``--results_json`` holds what its ``main`` returns."""
    from panoptic_forecasting_tpu.cli import evaluate_panoptic as jax_evaluate
    from panoptic_forecasting_tpu_torch.cli import evaluate_panoptic

    cs = os.path.join(os.path.dirname(world["dirs"]["jax_fg"]), "cs")
    for side in ("jax", "port"):
        export = os.path.join(world["dirs"][f"{side}_fg"], EXPORT)
        argv = ["--pred_json", os.path.join(export, f"{EXPORT}.json"),
                "--pred_dir", os.path.join(export, EXPORT),
                "--cityscapes_dir", cs, "--split", "val"]
        want = jax_evaluate.main(argv + ["--gt_out", str(tmp_path / f"jax_{side}")])
        results = str(tmp_path / f"{side}.json")
        got = evaluate_panoptic.main(argv + ["--gt_out", str(tmp_path / f"port_{side}"),
                                             "--results_json", results])
        assert got == want, side
        with open(results) as f:
            assert json.load(f) == json.loads(json.dumps(got))
        assert got["Stuff"]["n"] > 1  # classes with FP or FN were scored
