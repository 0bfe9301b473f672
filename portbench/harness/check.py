"""The comparison that decides ``correct``: each number compared beside
its limit. The limits of a cell are in ``portbench/limits/<cell>.json``
(each set from the program's readings over a dozen seeds and the
control's, PERF.md §2); a number above its limit, or missing, fails.
"""

from __future__ import annotations

import json
import os
from typing import Dict, List, Sequence, Tuple

import numpy as np

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def limits(cell: str) -> Dict[str, float]:
    with open(os.path.join(HERE, "limits", f"{cell}.json")) as f:
        return {k: float(v) for k, v in json.load(f)["limits"].items()}


def forecast_numbers(got: Sequence[Dict], want: Sequence[Dict]) -> Dict[str, float]:
    """Program against reference over the frames compared: the worst
    frame's share of panoptic and of bg pixels that differ, the slots
    whose id differs, the largest box corner gap in pixels and the
    largest relative gap of an instance's depth (valid slots only)."""
    pan = bg = box = dep = 0.0
    ids = 0
    for g, w in zip(got, want):
        valid = w["valid"]
        pan = max(pan, float(np.mean(g["panoptic"] != w["panoptic"])))
        bg = max(bg, float(np.mean(g["bg_seg"] != w["bg_seg"])))
        ids += int(np.sum((g["ids"] != w["ids"]) & valid))
        if valid.any():
            box = max(box, float(np.abs(g["bbox"][valid] - w["bbox"][valid]).max()))
            rel = np.abs(g["depths"][valid] - w["depths"][valid]) / np.abs(w["depths"][valid])
            dep = max(dep, float(rel.max()))
    return {"pan_px": pan, "bg_px": bg, "ids_off": float(ids), "box_px": box,
            "depth_rel": dep}


def _leaf_gaps(got: Dict[str, float], want: Dict[str, float], keys) -> np.ndarray:
    """Per leaf |‖got‖ − ‖want‖| / max(‖want‖, the median leaf's)."""
    med = float(np.median([want[k] for k in keys]))
    return np.array([abs(got[k] - want[k]) / max(want[k], med) for k in keys])


def train_numbers(got: Dict, want: Dict) -> Dict[str, float]:
    """Program against reference over the first steps: the relative gap
    of the first step's loss; of the first gradient as the optimizer got
    it (its momentum buffer after one step), by the worst leaf; and of
    the parameters' change over the steps, by the worst leaf, leaving out
    leaves whose reference gradient is under a thousandth of the median
    leaf's (moved by round-off alone). The later steps' losses are not
    compared: float32 rounding alone moves them as far as TF32 does
    (PERF.md §2)."""
    loss = abs(got["losses"][0] - want["losses"][0]) / abs(want["losses"][0])
    keys = list(want["grad"])
    grad = float(_leaf_gaps(got["grad"], want["grad"], keys).max())
    med = float(np.median([want["raw_grad"][k] for k in keys]))
    moved = [k for k in keys if want["raw_grad"][k] >= 1e-3 * med]
    change = float(_leaf_gaps(got["change"], want["change"], moved).max())
    return {"loss1_rel": loss, "grad_rel": grad, "change_rel": change}


def batch_off(got: Sequence[Dict], want: Sequence[Dict]) -> float:
    """Elements of the batches' inputs and labels that differ (all of an
    array whose shape or type differs)."""
    off = 0
    for g, w in zip(got, want):
        for part, key in (("inputs", "seg"), ("inputs", "depth"), ("labels", "seg")):
            a, b = np.asarray(g[part][key]), np.asarray(w[part][key])
            same = a.shape == b.shape and a.dtype == b.dtype
            off += int(np.sum(a != b)) if same else max(a.size, b.size)
    return float(off + abs(len(got) - len(want)))


def judge(numbers: Dict[str, float], lims: Dict[str, float]) -> Tuple[bool, List[Dict]]:
    """(every number within its limit, [{name, value, limit}])."""
    rows, ok = [], True
    for name, lim in lims.items():
        v = numbers.get(name)
        good = v is not None and np.isfinite(v) and v <= lim
        ok = ok and bool(good)
        rows.append({"name": name, "value": v, "limit": lim})
    return ok, rows
