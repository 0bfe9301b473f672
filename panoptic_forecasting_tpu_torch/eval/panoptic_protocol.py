"""Cityscapes panoptic file protocol: relabeling, segments_info, PNG write.

Counterpart of ``panoptic_forecasting_tpu/eval/panoptic_protocol.py``
(:37-77; reference experiments/export_cityscapes_panoptic_results.py:
27-68). Forecast panoptic maps live in trainId space: stuff pixels hold
a trainId (0..10), things ``trainId*1000 + instance`` (trainId 11..18),
void 255. The exported COCO-panoptic files live in labelId space: stuff
= labelId, things = ``labelId*1000 + instance``, void/ignored = 0.
"""

from __future__ import annotations

from typing import Any, Dict, List

import numpy as np

from ..data.cityscapes import train_id_to_id_lut
from ..data.io import PNG_IDS, save_png
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
