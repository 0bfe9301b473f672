"""Cityscapes label taxonomy, in-tree.

Counterpart of ``panoptic_forecasting_tpu/data/cityscapes.py`` (the
public, fixed Cityscapes label definitions the reference imports from
``cityscapesscripts.helpers.labels``). trainId layout: 0-10 are "stuff"
(the 11 classes the BG model predicts with ``only_background: True``),
11-18 are "things" (the 8 FG classes; FG class index = trainId - 11).
"""

from __future__ import annotations

from typing import Dict, List, NamedTuple, Tuple

import numpy as np


class Label(NamedTuple):
    name: str
    id: int
    train_id: int
    category: str
    has_instances: bool
    ignore_in_eval: bool
    color: Tuple[int, int, int]


_L = Label
LABELS: List[Label] = [
    _L("unlabeled",            0, 255, "void",         False, True,  (0, 0, 0)),
    _L("ego vehicle",          1, 255, "void",         False, True,  (0, 0, 0)),
    _L("rectification border", 2, 255, "void",         False, True,  (0, 0, 0)),
    _L("out of roi",           3, 255, "void",         False, True,  (0, 0, 0)),
    _L("static",               4, 255, "void",         False, True,  (0, 0, 0)),
    _L("dynamic",              5, 255, "void",         False, True,  (111, 74, 0)),
    _L("ground",               6, 255, "void",         False, True,  (81, 0, 81)),
    _L("road",                 7, 0,   "flat",         False, False, (128, 64, 128)),
    _L("sidewalk",             8, 1,   "flat",         False, False, (244, 35, 232)),
    _L("parking",              9, 255, "flat",         False, True,  (250, 170, 160)),
    _L("rail track",          10, 255, "flat",         False, True,  (230, 150, 140)),
    _L("building",            11, 2,   "construction", False, False, (70, 70, 70)),
    _L("wall",                12, 3,   "construction", False, False, (102, 102, 156)),
    _L("fence",               13, 4,   "construction", False, False, (190, 153, 153)),
    _L("guard rail",          14, 255, "construction", False, True,  (180, 165, 180)),
    _L("bridge",              15, 255, "construction", False, True,  (150, 100, 100)),
    _L("tunnel",              16, 255, "construction", False, True,  (150, 120, 90)),
    _L("pole",                17, 5,   "object",       False, False, (153, 153, 153)),
    _L("polegroup",           18, 255, "object",       False, True,  (153, 153, 153)),
    _L("traffic light",       19, 6,   "object",       False, False, (250, 170, 30)),
    _L("traffic sign",        20, 7,   "object",       False, False, (220, 220, 0)),
    _L("vegetation",          21, 8,   "nature",       False, False, (107, 142, 35)),
    _L("terrain",             22, 9,   "nature",       False, False, (152, 251, 152)),
    _L("sky",                 23, 10,  "sky",          False, False, (70, 130, 180)),
    _L("person",              24, 11,  "human",        True,  False, (220, 20, 60)),
    _L("rider",               25, 12,  "human",        True,  False, (255, 0, 0)),
    _L("car",                 26, 13,  "vehicle",      True,  False, (0, 0, 142)),
    _L("truck",               27, 14,  "vehicle",      True,  False, (0, 0, 70)),
    _L("bus",                 28, 15,  "vehicle",      True,  False, (0, 60, 100)),
    _L("caravan",             29, 255, "vehicle",      True,  True,  (0, 0, 90)),
    _L("trailer",             30, 255, "vehicle",      True,  True,  (0, 0, 110)),
    _L("train",               31, 16,  "vehicle",      True,  False, (0, 80, 100)),
    _L("motorcycle",          32, 17,  "vehicle",      True,  False, (0, 0, 230)),
    _L("bicycle",             33, 18,  "vehicle",      True,  False, (119, 11, 32)),
    _L("license plate",       -1, -1,  "vehicle",      False, True,  (0, 0, 142)),
]

NUM_TRAIN_CLASSES = 19
NUM_STUFF_CLASSES = 11   # trainIds 0..10
NUM_THING_CLASSES = 8    # trainIds 11..18

# trainId -> labelId for the 19 evaluated classes (+255 -> 0 "unlabeled").
TRAIN_ID_TO_ID: Dict[int, int] = {
    l.train_id: l.id for l in LABELS if l.train_id not in (255, -1)
}
ID_TO_TRAIN_ID: Dict[int, int] = {l.id: l.train_id for l in LABELS if l.id >= 0}
ID_TO_LABEL: Dict[int, Label] = {l.id: l for l in LABELS}


def train_id_to_id_lut(void_id: int = 0) -> np.ndarray:
    """256-entry LUT mapping trainId maps -> labelId maps.

    Mirrors the conversion loops at export_cityscapes_segmentation_results.py:27-32
    and export_cityscapes_panoptic_results.py:27-41 (255/void -> ``void_id``).
    """
    lut = np.full(256, void_id, dtype=np.uint8)
    for t, i in TRAIN_ID_TO_ID.items():
        lut[t] = i
    return lut


def id_to_train_id_lut() -> np.ndarray:
    """LUT mapping labelId maps -> trainId maps (ignored classes -> 255)."""
    lut = np.full(256, 255, dtype=np.uint8)
    for i, t in ID_TO_TRAIN_ID.items():
        if 0 <= i < 256:
            lut[i] = t if t != -1 else 255
    return lut


def train_id_color_palette() -> np.ndarray:
    """(256, 3) uint8 palette indexed by trainId (255 -> black)."""
    pal = np.zeros((256, 3), dtype=np.uint8)
    for l in LABELS:
        if l.train_id not in (255, -1):
            pal[l.train_id] = l.color
    return pal
