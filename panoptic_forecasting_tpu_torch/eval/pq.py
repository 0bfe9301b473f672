"""Panoptic Quality (PQ/SQ/RQ) evaluation, Cityscapes protocol.

Counterpart of ``panoptic_forecasting_tpu/eval/pq.py`` (the in-tree
version of the panopticapi matching that the reference's external
``cityscapesscripts.evaluation.evalPanopticSemanticLabeling`` runs,
scripts/fg/run_fg_eval_panoptic.sh:28-33), host numpy in the same
operation order, so its float sums come out bit-equal to the JAX
package's:

* segments are matched greedily by IoU > 0.5 within the same category
  (at most one pred can overlap a gt with IoU > 0.5);
* ``union = gt_area + pred_area - inter - |pred ∩ VOID|``;
* crowd gt segments (``iscrowd=1``) never match and never count as FN;
* unmatched preds whose overlap with VOID + same-category crowd exceeds
  half their area are discarded rather than counted FP;
* PQ = ΣIoU / (TP + ½FP + ½FN), SQ = ΣIoU / TP, RQ = TP / (TP + ½FP + ½FN).

Categories follow Cityscapes: the 19 eval classes keyed by **labelId**
with ``has_instances`` marking things (``data/cityscapes.py`` LABELS).
The COCO-panoptic file protocol writes a segment id as R + 256·G +
65536·B.
"""

from __future__ import annotations

import json
import os
from dataclasses import dataclass, field
from typing import Any, Dict, Optional, Sequence, Tuple

import numpy as np

from ..data.cityscapes import LABELS

VOID = 0
_OFFSET = np.int64(1) << 32


def eval_categories() -> Dict[int, Dict[str, Any]]:
    """labelId -> {name, isthing} for the 19 Cityscapes eval classes."""
    return {
        l.id: {"name": l.name, "isthing": l.has_instances}
        for l in LABELS
        if l.id >= 0 and not l.ignore_in_eval
    }


@dataclass
class PQStatCat:
    iou: float = 0.0
    tp: int = 0
    fp: int = 0
    fn: int = 0

    def __iadd__(self, other: "PQStatCat") -> "PQStatCat":
        self.iou += other.iou
        self.tp += other.tp
        self.fp += other.fp
        self.fn += other.fn
        return self


@dataclass
class PQStat:
    per_cat: Dict[int, PQStatCat] = field(default_factory=dict)

    def cat(self, c: int) -> PQStatCat:
        return self.per_cat.setdefault(int(c), PQStatCat())

    def __iadd__(self, other: "PQStat") -> "PQStat":
        for c, s in other.per_cat.items():
            self.cat(c).__iadd__(s)
        return self

    def average(self, categories: Dict[int, Dict[str, Any]],
                isthing: Optional[bool] = None) -> Dict[str, Any]:
        """Mean PQ/SQ/RQ over the categories (of one kind) with
        TP + FP + FN > 0, and each category's own values."""
        pq = sq = rq = 0.0
        n = 0
        per_class = {}
        for c, info in categories.items():
            if isthing is not None and bool(info["isthing"]) != isthing:
                continue
            s = self.per_cat.get(c, PQStatCat())
            denom = s.tp + 0.5 * s.fp + 0.5 * s.fn
            if denom == 0:
                per_class[c] = {"pq": 0.0, "sq": 0.0, "rq": 0.0, "valid": False}
                continue
            pq_c = s.iou / denom
            sq_c = s.iou / s.tp if s.tp else 0.0
            rq_c = s.tp / denom
            per_class[c] = {"pq": pq_c, "sq": sq_c, "rq": rq_c, "valid": True}
            pq += pq_c
            sq += sq_c
            rq += rq_c
            n += 1
        n = max(n, 1)
        return {"pq": pq / n, "sq": sq / n, "rq": rq / n, "n": n,
                "per_class": per_class}


def _segment_table(seg_ids: np.ndarray, areas: np.ndarray,
                   segments_info: Sequence[Dict[str, Any]],
                   categories: Dict[int, Dict[str, Any]],
                   source: str) -> Dict[int, Dict[str, Any]]:
    """Validate segments_info against the PNG contents; returns id->info."""
    info_by_id = {int(s["id"]): s for s in segments_info}
    present = {int(i): int(a) for i, a in zip(seg_ids, areas) if i != VOID}
    table: Dict[int, Dict[str, Any]] = {}
    for sid, area in present.items():
        if sid not in info_by_id:
            raise ValueError(
                f"segment id {sid} in {source} PNG has no segments_info entry"
            )
        s = info_by_id[sid]
        cat = int(s["category_id"])
        if cat not in categories:
            # Not an eval category (e.g. void-ish exports): treat as VOID.
            continue
        table[sid] = {
            "category_id": cat,
            "area": area,
            "iscrowd": int(s.get("iscrowd", 0)),
        }
    return table


def pq_compute_single_image(
    gt_seg: np.ndarray,
    gt_segments: Sequence[Dict[str, Any]],
    pred_seg: np.ndarray,
    pred_segments: Sequence[Dict[str, Any]],
    categories: Optional[Dict[int, Dict[str, Any]]] = None,
) -> PQStat:
    """Accumulate PQ stats for one image pair of dense segment-id maps."""
    categories = categories or eval_categories()
    if gt_seg.shape != pred_seg.shape:
        raise ValueError(f"shape mismatch {gt_seg.shape} vs {pred_seg.shape}")
    gt_seg = gt_seg.astype(np.int64, copy=False)
    pred_seg = pred_seg.astype(np.int64, copy=False)

    gt_ids, gt_areas = np.unique(gt_seg, return_counts=True)
    pr_ids, pr_areas = np.unique(pred_seg, return_counts=True)
    gt_tab = _segment_table(gt_ids, gt_areas, gt_segments, categories, "gt")
    pr_tab = _segment_table(pr_ids, pr_areas, pred_segments, categories,
                            "pred")

    # Everything not in the table acts as VOID for matching purposes.
    gt_void_mask = ~np.isin(gt_seg, np.array(list(gt_tab) or [VOID]))
    pr_void_mask = ~np.isin(pred_seg, np.array(list(pr_tab) or [VOID]))
    g = np.where(gt_void_mask, VOID, gt_seg)
    p = np.where(pr_void_mask, VOID, pred_seg)

    pairs, counts = np.unique(g * _OFFSET + p, return_counts=True)
    inter: Dict[Tuple[int, int], int] = {
        (int(k // _OFFSET), int(k % _OFFSET)): int(v)
        for k, v in zip(pairs, counts)
    }

    stat = PQStat()
    matched_gt, matched_pr = set(), set()
    for (gid, pid), n in inter.items():
        if gid == VOID or pid == VOID:
            continue
        gi, pi = gt_tab[gid], pr_tab[pid]
        if gi["category_id"] != pi["category_id"] or gi["iscrowd"]:
            continue
        union = (gi["area"] + pi["area"] - n
                 - inter.get((VOID, pid), 0))
        iou = n / union if union > 0 else 0.0
        if iou > 0.5:
            c = stat.cat(gi["category_id"])
            c.tp += 1
            c.iou += iou
            matched_gt.add(gid)
            matched_pr.add(pid)

    crowd_by_cat: Dict[int, int] = {
        info["category_id"]: gid
        for gid, info in gt_tab.items()
        if info["iscrowd"]
    }
    for gid, info in gt_tab.items():
        if info["iscrowd"] or gid in matched_gt:
            continue
        stat.cat(info["category_id"]).fn += 1
    for pid, info in pr_tab.items():
        if pid in matched_pr:
            continue
        ignore = inter.get((VOID, pid), 0)
        crowd_gid = crowd_by_cat.get(info["category_id"])
        if crowd_gid is not None:
            ignore += inter.get((crowd_gid, pid), 0)
        if ignore / info["area"] > 0.5:
            continue
        stat.cat(info["category_id"]).fp += 1
    return stat


def decode_panoptic_png(rgb: np.ndarray) -> np.ndarray:
    """(H, W, 3) uint8 -> (H, W) int64 ids; a 2-D array is already ids."""
    if rgb.ndim == 2:
        return rgb.astype(np.int64)
    rgb = rgb.astype(np.int64)
    return rgb[..., 0] + 256 * rgb[..., 1] + 256 * 256 * rgb[..., 2]


def encode_panoptic_png(seg: np.ndarray) -> np.ndarray:
    seg = seg.astype(np.int64)
    return np.stack(
        [seg % 256, (seg // 256) % 256, (seg // 65536) % 256], axis=-1
    ).astype(np.uint8)


def _load_annotations(json_path: str) -> Dict[str, Dict[str, Any]]:
    with open(json_path) as f:
        data = json.load(f)
    anns = data["annotations"] if isinstance(data, dict) else data
    return {str(a["image_id"]): a for a in anns}


def pq_compute_folders(
    gt_json: str,
    gt_dir: str,
    pred_json: str,
    pred_dir: str,
    categories: Optional[Dict[int, Dict[str, Any]]] = None,
) -> Dict[str, Any]:
    """Score a prediction export against a gt export, both COCO-panoptic.

    Every gt annotation must have a matching pred annotation (by
    image_id), as in evalPanopticSemanticLabeling's directory protocol.
    Frames are scored one after another, in image_id order.
    """
    from ..data.io import load_png

    categories = categories or eval_categories()
    gt_anns = _load_annotations(gt_json)
    pred_anns = _load_annotations(pred_json)
    items = sorted(gt_anns.items())
    for image_id, _ in items:
        if image_id not in pred_anns:
            raise ValueError(f"no prediction for image {image_id}")

    stat = PQStat()
    for image_id, ga in items:
        pa = pred_anns[image_id]
        gt_png = load_png(os.path.join(gt_dir, ga["file_name"]))
        pr_png = load_png(os.path.join(pred_dir, pa["file_name"]))
        stat += pq_compute_single_image(
            decode_panoptic_png(gt_png),
            ga["segments_info"],
            decode_panoptic_png(pr_png),
            pa["segments_info"],
            categories,
        )
    return summarize(stat, categories)


def summarize(stat: PQStat,
              categories: Optional[Dict[int, Dict[str, Any]]] = None
              ) -> Dict[str, Any]:
    """{"All", "Things", "Stuff": {pq, sq, rq, n}, "per_class": {name:
    {pq, sq, rq, valid}}}."""
    categories = categories or eval_categories()
    res = {
        "All": stat.average(categories),
        "Things": stat.average(categories, isthing=True),
        "Stuff": stat.average(categories, isthing=False),
    }
    res["per_class"] = {
        categories[c]["name"]: v
        for c, v in res["All"].pop("per_class").items()
    }
    res["Things"].pop("per_class")
    res["Stuff"].pop("per_class")
    return res


def format_results(res: Dict[str, Any]) -> str:
    lines = [f"{'':18s} {'PQ':>7s} {'SQ':>7s} {'RQ':>7s} {'N':>4s}"]
    for k in ("All", "Things", "Stuff"):
        r = res[k]
        lines.append(
            f"{k:18s} {100 * r['pq']:7.2f} {100 * r['sq']:7.2f} "
            f"{100 * r['rq']:7.2f} {r['n']:4d}"
        )
    for name, r in res["per_class"].items():
        lines.append(
            f"  {name:16s} {100 * r['pq']:7.2f} {100 * r['sq']:7.2f} "
            f"{100 * r['rq']:7.2f}"
        )
    return "\n".join(lines)
