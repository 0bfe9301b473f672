"""Visualize exported panoptic predictions as colour overlays.

Counterpart of ``panoptic_forecasting_tpu/cli/viz_panoptic.py``
(reference experiments/viz_cityscapes_panoptic.py): decode the panoptic
PNGs, colour each segment by its category, blend 50/50 with the
(grayscale) camera image, and mark thing-instance boundaries in inverted
colour. Boundaries come from a 4-neighbour label-difference test in
numpy (the reference uses cv2 contours; cv2 stays out, as in JAX). Host
numpy.

Blanking options: ``--gt_dir`` blacks out pixels that are void in the GT
panoptic below row 800 (the ego-vehicle band); ``--mask_path`` /
``--mask_dir`` black out pixels whose gt labelIds value is unlabeled,
ego vehicle or rectification border (ids 0-2), ``--mask_dir`` searching
the 30-frame snippet for the annotated frame.

Usage:
    python -m panoptic_forecasting_tpu_torch.cli.viz_panoptic \\
        --annotations EXPORT.json --label_dir PNG_DIR --output_dir OUT \\
        [--rgb_dir LEFTIMG8BIT_DIR] [--gt_dir GT_PAN_DIR]
        [--mask_path LABELIDS.png | --mask_dir LABELIDS_DIR]
"""

from __future__ import annotations

import argparse
import json
import os
import sys

import numpy as np

from ..data.cityscapes import ID_TO_LABEL
from ..data.io import load_png, save_png
from ..eval.pq import decode_panoptic_png


def color_panoptic(seg: np.ndarray, segments_info) -> np.ndarray:
    """(H, W, 3) uint8: each segment painted its category color."""
    img = np.zeros(seg.shape + (3,), np.uint8)
    for s in segments_info:
        label = ID_TO_LABEL.get(int(s["category_id"]))
        if label is None:
            continue
        img[seg == int(s["id"])] = label.color
    return img


def instance_boundaries(seg: np.ndarray, segments_info) -> np.ndarray:
    """Boolean mask of thing-instance boundary pixels (4-neighbor)."""
    thing_ids = {
        int(s["id"])
        for s in segments_info
        if ID_TO_LABEL.get(int(s["category_id"]), None) is not None
        and ID_TO_LABEL[int(s["category_id"])].has_instances
    }
    if not thing_ids:
        return np.zeros(seg.shape, bool)
    is_thing = np.isin(seg, np.array(sorted(thing_ids)))
    edge = np.zeros(seg.shape, bool)
    edge[:, 1:] |= (seg[:, 1:] != seg[:, :-1]) & is_thing[:, 1:]
    edge[:, :-1] |= (seg[:, :-1] != seg[:, 1:]) & is_thing[:, :-1]
    edge[1:, :] |= (seg[1:] != seg[:-1]) & is_thing[1:]
    edge[:-1, :] |= (seg[:-1] != seg[1:]) & is_thing[:-1]
    return edge


def ignore_mask_from_labelids(label_ids: np.ndarray) -> np.ndarray:
    """Pixels to blank: unlabeled (0), ego vehicle (1), rectification
    border (2) — the reference's read_mask (:43-46)."""
    return label_ids <= 2


def find_snippet_labelids(mask_dir: str, image_id: str) -> np.ndarray:
    """Locate the annotated labelIds frame within the 30-frame snippet of
    ``image_id`` (reference get_mask_from_dir, :48-59)."""
    city, seq, frame = image_id.split("_")
    for fr in range(int(frame) - 19, int(frame) + 11):
        path = os.path.join(
            mask_dir, city, f"{city}_{seq}_{fr:06d}_gtFine_labelIds.png"
        )
        if os.path.exists(path):
            return load_png(path)
    raise ValueError(f"no gt labelIds in snippet range of {image_id}")


def visualize_one(seg: np.ndarray, segments_info, rgb: np.ndarray = None,
                  gt_pan: np.ndarray = None,
                  ignore: np.ndarray = None) -> np.ndarray:
    color = color_panoptic(seg, segments_info)
    if rgb is None:
        overlay = color
    else:
        gray = rgb.mean(axis=-1, keepdims=True).astype(np.uint8)
        overlay = (0.5 * gray + 0.5 * color).astype(np.uint8)
    edges = instance_boundaries(seg, segments_info)
    overlay[edges] = 255 - color[edges]
    # Blanking parity (reference visualize_one_frame :166-171): gt void
    # below row 800 (ego-vehicle band) wins over an explicit ignore mask.
    if gt_pan is not None:
        overlay[800:][gt_pan[800:] == 0] = 0
    elif ignore is not None:
        overlay[ignore] = 0
    return overlay


def main(argv=None) -> None:
    p = argparse.ArgumentParser()
    p.add_argument("--annotations", required=True)
    p.add_argument("--label_dir", required=True)
    p.add_argument("--output_dir", required=True)
    p.add_argument("--rgb_dir")
    p.add_argument("--gt_dir", help="GT panoptic PNG dir: blank gt-void "
                                    "pixels below row 800 (ego vehicle)")
    p.add_argument("--mask_path", help="one gt labelIds PNG whose ids 0-2 "
                                       "blank every frame")
    p.add_argument("--mask_dir", help="gtFine labelIds root searched per "
                                      "frame over the 30-frame snippet")
    args = p.parse_args(argv)

    with open(args.annotations) as f:
        data = json.load(f)
    anns = data["annotations"] if isinstance(data, dict) else data
    os.makedirs(args.output_dir, exist_ok=True)
    shared_ignore = (
        ignore_mask_from_labelids(load_png(args.mask_path))
        if args.mask_path else None
    )
    for a in anns:
        seg = decode_panoptic_png(
            load_png(os.path.join(args.label_dir, a["file_name"]))
        )
        rgb = None
        if args.rgb_dir:
            city = a["image_id"].split("_")[0]
            path = os.path.join(
                args.rgb_dir, city, a["image_id"] + "_leftImg8bit.png"
            )
            if os.path.exists(path):
                rgb = load_png(path)
        gt_pan = None
        if args.gt_dir:
            gt_path = os.path.join(
                args.gt_dir, a["image_id"] + "_gtFine_panoptic.png"
            )
            if os.path.exists(gt_path):
                gt_pan = decode_panoptic_png(load_png(gt_path))
        ignore = shared_ignore
        if ignore is None and args.mask_dir:
            ignore = ignore_mask_from_labelids(
                find_snippet_labelids(args.mask_dir, a["image_id"])
            )
        out = visualize_one(seg, a["segments_info"], rgb, gt_pan, ignore)
        save_png(
            os.path.join(args.output_dir, a["image_id"] + "_viz.png"), out
        )
    print(f"wrote {len(anns)} overlays -> {args.output_dir}")


if __name__ == "__main__":
    main(sys.argv[1:])
