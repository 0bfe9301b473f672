"""The backfill of the COCO-panoptic export.

Counterpart of ``backfill_missing`` in
``panoptic_forecasting_tpu/cli/export_panoptic.py`` (:89-135; reference
experiments/export_cityscapes_panoptic_results.py:124-168): every gt
frame the export did not forecast gets the bg canvas (or zeros), so the
PQ tool sees every frame. The staged export itself (``export_split``,
through ``eval/fusion.py``) is not ported yet.
"""

from __future__ import annotations

import glob
import os

import numpy as np

from ..data.io import load_png
from ..eval.panoptic_protocol import (
    relabel_panoptic_trainid_to_labelid,
    segments_info_from_labelid_seg,
    write_panoptic_png,
)
from .common import export_writer

IMG_H, IMG_W = 1024, 2048  # Cityscapes frames (the JAX eval/fusion.py's)


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
                seg = np.zeros((IMG_H, IMG_W), np.int64)
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
