"""Export segmentation predictions (pc_transform or bg) as Cityscapes PNGs.

Counterpart of ``panoptic_forecasting_tpu/cli/export_segmentation.py``
(reference experiments/export_cityscapes_segmentation_results.py): per
target frame ``{city}_{seq}_{frame:06d}_gtFine_labelIds.png``
(trainId -> labelId unless ``no_convert``; labelId -> trainId with
``convert_to_trainid``), or a colour map with ``viz``, or the raw map as
``*_leftImg8bit.png`` with ``is_img``; with ``save_depth`` the depth as
``.npy``, a depth PNG (``save_depth_as_png``) or a disparity PNG
(``save_disp_as_png``, ``disp_factor``); then the gt frames with no
prediction backfilled from ``data.background_dir`` (or zeros, 255 with
``no_convert``).

Layout: ``working_dir/{export_name|exported_predictions}/{split}/{city}/``.
The bg task restores its weights (``working_dir/best_model`` and the
rest of ``cli/common.py::restore_params``) and runs folded (K2
``onehot_stem_conv`` on the GPU); pc_transform has no weights (K1
``place_min_fold`` on the GPU). Both run on ``cuda`` and raise without
it, unless ``platform`` is ``cpu``.

Usage:
    python -m panoptic_forecasting_tpu_torch.cli.export_segmentation \\
        --working_dir DIR --config_file CFG [--set export_name NAME] \\
        [--set no_convert true] [--set platform cpu]
"""

from __future__ import annotations

import glob
import os
import sys
import time
from typing import Any, Dict

import numpy as np

from ..core.config import load_config
from ..data.cityscapes import ID_TO_LABEL, train_id_color_palette, train_id_to_id_lut
from ..data.io import (
    PNG_IDS,
    PNG_SMOOTH16,
    encode_depth_png,
    encode_disparity_from_depth,
    load_png,
    save_png,
)
from .common import export_writer, restore_params, setup


def export_split(model, task_data, split, cfg) -> str:
    wd = cfg["working_dir"]
    export_name = cfg.get("export_name")
    viz = bool(cfg.get("viz"))
    if export_name:
        base = os.path.join(wd, export_name, split)
    elif viz:
        base = os.path.join(wd, "exported_predictions_viz", split)
    else:
        base = os.path.join(wd, "exported_predictions", split)
    no_convert = bool(cfg.get("no_convert"))
    convert_to_trainid = bool(cfg.get("convert_to_trainid"))
    is_img = bool(cfg.get("is_img"))
    save_depth = bool(cfg.get("save_depth"))
    save_disp_as_png = bool(cfg.get("save_disp_as_png"))
    save_depth_as_png = bool(cfg.get("save_depth_as_png"))
    disp_factor = float(cfg.get("disp_factor") or 0.0)
    lut = train_id_to_id_lut()
    # labelId -> trainId with the reference's edge behaviour: ids outside
    # the label table -> 0, trainId -1 wraps to 255 (uint8)
    id_lut = np.zeros(256, np.uint8)
    for i, lbl in ID_TO_LABEL.items():
        if 0 <= i < 256:
            id_lut[i] = np.uint8(lbl.train_id % 256)
    palette = train_id_color_palette()

    with export_writer(cfg) as w:
        for batch in task_data.loader(split, cfg, test=True):
            preds = model.predict(batch)
            segs = preds["seg"].cpu().numpy()
            depths = preds["depth"].cpu().numpy() if "depth" in preds else None
            meta = batch["meta"]
            for i in range(len(segs)):
                city, seq = meta["city"][i], meta["seq"][i]
                tgt = int(meta["target_frame"][i] if "target_frame" in meta
                          else meta["frame"][i])
                name = f"{city}_{seq}_{tgt:06d}"
                out_dir = os.path.join(base, city)
                # per-frame copies: a view would pin the batch in the queue
                seg = segs[i].copy()
                if viz:
                    w.submit(save_png, os.path.join(out_dir, f"{name}_gtFine_color.png"),
                             palette[np.clip(seg, 0, 255)])
                elif is_img:
                    w.submit(save_png, os.path.join(out_dir, f"{name}_leftImg8bit.png"),
                             seg.astype(np.uint8))
                else:
                    if not no_convert:
                        seg = lut[np.clip(seg, 0, 255)]
                    elif convert_to_trainid:
                        seg = id_lut[np.clip(seg, 0, 255)]
                    w.submit(save_png, os.path.join(out_dir, f"{name}_gtFine_labelIds.png"),
                             seg.astype(np.uint8), **PNG_IDS)
                if save_depth and depths is not None:
                    d = depths[i].copy()
                    if save_disp_as_png:
                        w.submit(save_png, os.path.join(out_dir, f"{name}_disps.png"),
                                 encode_disparity_from_depth(d, disp_factor),
                                 **PNG_SMOOTH16)
                    elif save_depth_as_png:
                        w.submit(save_png, os.path.join(out_dir, f"{name}_depths.png"),
                                 encode_depth_png(d), **PNG_SMOOTH16)
                    else:
                        os.makedirs(out_dir, exist_ok=True)
                        w.submit(np.save, os.path.join(out_dir, f"{name}_depths.npy"), d)
    if not (viz or is_img):
        backfill_missing(base, split, cfg)
    return base


def backfill_missing(base: str, split: str, cfg) -> int:
    """Fill gt frames with no prediction: the background export if there
    is one, else zeros (255 with ``no_convert``). Returns the count."""
    cs_dir = cfg.get("data", {}).get("cityscapes_dir")
    if not cs_dir:
        return 0
    bg_dir = cfg.get("data", {}).get("background_dir")
    fill = 255 if cfg.get("no_convert") else 0
    lut = train_id_to_id_lut()
    gt_dir = os.path.join(cs_dir, "gtFine", split)
    if not os.path.isdir(gt_dir):
        return 0
    cities = cfg.get("data", {}).get("cities")
    count = 0
    with export_writer(cfg) as w:
        for city in os.listdir(gt_dir):
            if cities is not None and city not in cities:
                continue
            for path in glob.glob(os.path.join(gt_dir, city, "*_gtFine_labelIds.png")):
                fname = os.path.basename(path)
                out = os.path.join(base, city, fname)
                if os.path.exists(out):
                    continue
                count += 1
                bg_path = os.path.join(bg_dir, city, fname) if bg_dir else None
                if bg_path and os.path.exists(bg_path):
                    arr = lut[np.clip(load_png(bg_path), 0, 255)]
                else:
                    arr = np.full(load_png(path).shape, fill, np.uint8)
                w.submit(save_png, out, arr.astype(np.uint8), **PNG_IDS)
    return count


def main(argv=None) -> Dict[str, Dict[str, Any]]:
    """Export every split of the config; returns per split the export
    dir, its frames and the host ``seconds`` of its ``export_split``."""
    cfg, task_data, model = setup(load_config(argv), test=True)
    if cfg["task"] != "pc_transform":
        model = restore_params(cfg, model)
    # bg serves folded (model.fold_bn: false keeps BN); pc_transform has none
    if hasattr(model, "maybe_fold"):
        model = model.maybe_fold()
    report = {}
    for split in task_data.datasets:
        ts = time.perf_counter()
        out = export_split(model, task_data, split, cfg)
        report[split] = {"dir": out, "frames": len(task_data.datasets[split]),
                         "seconds": time.perf_counter() - ts}
        print(f"exported {split} -> {out}")
    return report


if __name__ == "__main__":
    main(sys.argv[1:])
