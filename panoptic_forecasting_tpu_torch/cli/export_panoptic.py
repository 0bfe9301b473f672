"""Export forecast panoptic segmentations as COCO-panoptic PNGs + json.

Counterpart of ``panoptic_forecasting_tpu/cli/export_panoptic.py``
(reference experiments/export_cityscapes_panoptic_results.py): per target
frame ``{city}_{seq}_{frame:06d}_pred_panoptic.png`` (labelId-space ids,
base-256 RGB; trainId space with ``no_convert``) from
``eval/fusion.py::predict_panoptic`` over the scene's bg canvas
(``data.background_dir``), the COCO annotations in ``{export_name}.json``,
and the gt frames the scene dataset skipped backfilled with their bg
canvas (or zeros) against the gtFine listing.

Layout: ``working_dir/{export_name|exported_panoptics}_{split}/`` holding
the json and a directory of the same name with the PNGs. The fg weights
come as in ``cli/common.py::restore_params``. It runs on ``cuda`` and
raises without it, unless ``platform`` is ``cpu``.

Usage:
    python -m panoptic_forecasting_tpu_torch.cli.export_panoptic \\
        --working_dir DIR --config_file cfg.yaml [--set export_name NAME] \\
        [--set no_convert true] [--set platform cpu]
"""

from __future__ import annotations

import glob
import json
import os
import sys
import time
from typing import Any, Dict

import numpy as np

from ..core.config import load_config
from ..data.io import load_png
from ..eval import fusion
from ..eval.panoptic_protocol import (
    relabel_panoptic_trainid_to_labelid,
    segments_info_from_labelid_seg,
    write_panoptic_png,
)
from .common import export_writer, restore_params, setup


def export_split(model, task_data, split, cfg) -> str:
    """Fuse and write every frame of ``split``; returns the result dir."""
    export_name = f"{cfg.get('export_name') or 'exported_panoptics'}_{split}"
    result_dir = os.path.join(cfg["working_dir"], export_name)
    seg_dir = os.path.join(result_dir, export_name)
    os.makedirs(seg_dir, exist_ok=True)
    no_convert = bool(cfg.get("no_convert"))

    annotations = []
    exported = set()
    # PNG encode + write overlaps the next batch's device work
    with export_writer(cfg) as w:
        for batch in task_data.loader(split, cfg, test=True):
            segs = fusion.predict_panoptic(model, batch)["seg"]
            meta = batch["meta"]
            for i in range(len(segs)):
                name = (f"{meta['city'][i]}_{meta['seq'][i]}_"
                        f"{int(meta['target_frame'][i]):06d}")
                # a copy: a batch view would pin the batch in the queue
                seg = (segs[i].copy() if no_convert
                       else relabel_panoptic_trainid_to_labelid(segs[i]))
                file_name = f"{name}_pred_panoptic.png"
                w.submit(write_panoptic_png, os.path.join(seg_dir, file_name), seg)
                annotations.append({
                    "image_id": name,
                    "file_name": file_name,
                    "segments_info": segments_info_from_labelid_seg(seg),
                })
                exported.add(name)

    backfill_missing(cfg, split, seg_dir, exported, annotations)

    with open(os.path.join(result_dir, f"{export_name}.json"), "w",
              encoding="utf-8") as f:
        json.dump({"annotations": annotations}, f, ensure_ascii=False, indent=4)
    print(f"[{split}] exported {len(exported)} frames -> {seg_dir}")
    return result_dir


def backfill_missing(cfg, split, seg_dir, exported, annotations):
    """Fill frames missing from the export with the bg canvas / zeros so
    the PQ tool sees every gt frame; appends to ``annotations``."""
    cityscapes_dir = cfg.get("data", {}).get("cityscapes_dir")
    if not cityscapes_dir:
        print("DID NOT RECEIVE CITYSCAPES DIR. SKIPPING BACKFILL.")
        return
    background_dir = cfg.get("data", {}).get("background_dir")
    gt_dir = os.path.join(cityscapes_dir, "gtFine", split)
    count = 0
    with export_writer(cfg) as w:
        for path in sorted(
            glob.glob(os.path.join(gt_dir, "*", "*_gtFine_labelIds.png"))
        ):
            parts = os.path.basename(path).split("_")
            name = f"{parts[0]}_{parts[1]}_{parts[2]}"
            if name in exported:
                continue
            count += 1
            seg = None
            if background_dir:
                # canvases live under background_dir/{split}/{city}/, in
                # trainId space under labelIds names: a pure-stuff canvas
                bg_path = os.path.join(
                    background_dir, split, parts[0], os.path.basename(path)
                )
                if os.path.exists(bg_path):
                    seg = relabel_panoptic_trainid_to_labelid(
                        load_png(bg_path).astype(np.int64)
                    )
            if seg is None:
                seg = np.zeros((fusion.IMG_H, fusion.IMG_W), np.int64)
            file_name = f"{name}_pred_panoptic.png"
            w.submit(
                write_panoptic_png, os.path.join(seg_dir, file_name), seg
            )
            annotations.append({
                "image_id": name,
                "file_name": file_name,
                "segments_info": segments_info_from_labelid_seg(seg),
            })
    print("NUM MISSING:", count)


def main(argv=None) -> Dict[str, Dict[str, Any]]:
    """Export every split of the config; returns per split the result
    dir, its fused frames and the host ``seconds`` of its
    ``export_split``."""
    cfg, task_data, model = setup(load_config(argv), test=True)
    model = restore_params(cfg, model)
    report = {}
    for split in task_data.datasets:
        ts = time.perf_counter()
        out = export_split(model, task_data, split, cfg)
        report[split] = {"dir": out, "frames": len(task_data.datasets[split]),
                         "seconds": time.perf_counter() - ts}
    return report


if __name__ == "__main__":
    main(sys.argv[1:])
