"""Cityscapes panoptic file protocol: relabeling, segments_info, PNG
write, GT preparation.

Counterpart of ``panoptic_forecasting_tpu/eval/panoptic_protocol.py``
(reference experiments/export_cityscapes_panoptic_results.py:27-68; the
GT conversion of ``cityscapesscripts preparation/createPanopticImgs.py``,
in-tree there and here). Forecast panoptic maps live in trainId space:
stuff pixels hold a trainId (0..10), things ``trainId*1000 + instance``
(trainId 11..18), void 255. The exported COCO-panoptic files live in
labelId space: stuff = labelId, things = ``labelId*1000 + instance``,
void/ignored = 0.
"""

from __future__ import annotations

import glob
import json
import os
from typing import Any, Dict, List, Tuple

import numpy as np

from ..data.cityscapes import ID_TO_LABEL, train_id_to_id_lut
from ..data.io import PNG_IDS, load_png, save_png
from .pq import encode_panoptic_png


def relabel_panoptic_trainid_to_labelid(seg: np.ndarray) -> np.ndarray:
    """255 -> 0; stuff trainId -> labelId; ``trainId*1000+inst`` ->
    ``labelId*1000+inst`` (the reference's ``> 100`` threshold means any
    thing-encoded value)."""
    seg = seg.astype(np.int64)
    lut = train_id_to_id_lut(void_id=0).astype(np.int64)
    is_thing = (seg > 100) & (seg != 255)
    cat = np.where(is_thing, seg // 1000, np.where(seg == 255, 255, seg))
    inst = np.where(is_thing, seg % 1000, 0)
    new_cat = lut[np.clip(cat, 0, 255)]
    return np.where(is_thing, new_cat * 1000 + inst, new_cat)


def segments_info_from_labelid_seg(seg: np.ndarray) -> List[Dict[str, Any]]:
    """One entry per non-zero segment id; category = id//1000 for thing
    encodings (> 100), else the id itself."""
    out: List[Dict[str, Any]] = []
    ids, areas = np.unique(seg, return_counts=True)
    for sid, area in zip(ids.tolist(), areas.tolist()):
        if sid == 0:
            continue
        cat = sid // 1000 if sid > 100 else sid
        out.append({"id": int(sid), "category_id": int(cat),
                    "area": int(area)})
    return out


def write_panoptic_png(path: str, seg_labelid: np.ndarray) -> None:
    save_png(path, encode_panoptic_png(seg_labelid), **PNG_IDS)


# ---------------------------------------------------------------------------
# GT conversion: gtFine *_instanceIds.png -> COCO panoptic (PNG + json).
# Same semantics as cityscapesscripts/preparation/createPanopticImgs.py:
# pixel < 1000 holds a plain labelId (a thing labelId there means a crowd
# region), >= 1000 holds labelId*1000+instance; only eval categories are
# kept, everything else becomes void 0.
# ---------------------------------------------------------------------------

def gt_panoptic_from_instance_ids(inst_ids: np.ndarray
                                  ) -> Tuple[np.ndarray, List[Dict[str, Any]]]:
    inst_ids = inst_ids.astype(np.int64)
    out = np.zeros_like(inst_ids)
    segments: List[Dict[str, Any]] = []
    for sid in np.unique(inst_ids):
        label_id = int(sid // 1000) if sid >= 1000 else int(sid)
        label = ID_TO_LABEL.get(label_id)
        if label is None or label.ignore_in_eval:
            continue
        mask = inst_ids == sid
        out[mask] = int(sid)
        segments.append({
            "id": int(sid),
            "category_id": label_id,
            "area": int(mask.sum()),
            "iscrowd": int(sid < 1000 and label.has_instances),
        })
    return out, segments


def _image_id(path: str) -> str:
    return "_".join(os.path.basename(path).split("_")[:3])


def convert_gt_split(cityscapes_dir: str, split: str, out_dir: str) -> str:
    """Convert a gtFine split to COCO panoptic files under ``out_dir``.

    Returns the json path. An earlier conversion that covers exactly the
    split's frames, every PNG present, is reused.
    """
    png_dir = os.path.join(out_dir, f"cityscapes_panoptic_{split}")
    os.makedirs(png_dir, exist_ok=True)
    paths = sorted(glob.glob(os.path.join(cityscapes_dir, "gtFine", split, "*",
                                          "*_gtFine_instanceIds.png")))
    json_path = os.path.join(out_dir, f"cityscapes_panoptic_{split}.json")
    wanted = {_image_id(p) for p in paths}
    if os.path.exists(json_path):
        try:
            with open(json_path) as f:
                prev = json.load(f)["annotations"]
            if {a["image_id"] for a in prev} == wanted and all(
                os.path.exists(os.path.join(png_dir, a["file_name"]))
                for a in prev
            ):
                return json_path
        except (ValueError, KeyError, OSError):
            pass  # corrupt/partial previous conversion: redo it

    annotations = []
    for path in paths:
        image_id = _image_id(path)
        seg, segments = gt_panoptic_from_instance_ids(load_png(path))
        file_name = f"{image_id}_gtFine_panoptic.png"
        write_panoptic_png(os.path.join(png_dir, file_name), seg)
        annotations.append({
            "image_id": image_id,
            "file_name": file_name,
            "segments_info": segments,
        })
    with open(json_path, "w") as f:
        json.dump({"annotations": annotations}, f)
    return json_path
