"""Cityscapes instance-level average precision (AP), in-tree.

Counterpart of ``panoptic_forecasting_tpu/eval/instance_ap.py`` (host
numpy, the same arithmetic in the same order): the matching and
precision-recall protocol of ``cityscapesscripts.evaluation.
evalInstanceLevelSemanticLabeling``, which the reference's instance
export (experiments/export_cityscapes_instance_results.py:61-92) is
scored with:

* eval classes = the 8 Cityscapes thing classes (``has_instances`` and not
  ``ignore_in_eval``), keyed by labelId;
* gt instances = ids ``labelId*1000 + k`` in the
  ``*_gtFine_instanceIds.png`` map; a bare thing labelId (< 1000) is a
  crowd/group region, matchable for suppression but never a true
  positive or false negative;
* "void" pixels are those whose map value is an ``ignore_in_eval``
  labelId;
* a prediction matches a gt instance of the same class when
  ``inter / (gt_area + pred_area - inter) > overlap_threshold`` for
  thresholds 0.50, 0.55, ..., 0.95 (strict >);
* gt instances smaller than ``min_region_size`` (100 px) and group
  regions are neither matchable-for-TP nor false negatives; their overlap
  (and void overlap) discounts unmatched predictions: an unmatched
  prediction is a false positive only when its ignored-pixel fraction is
  ``<= threshold`` (group and too-small overlaps accumulate through the
  tool's two independent checks, as the tool does);
* duplicate detections of one gt instance keep the highest-confidence hit
  as the true positive and demote the rest to false positives; unmatched
  gt instances are false negatives at every confidence;
* AP integrates the confidence-swept precision-recall curve with the
  protocol's centered-difference step widths; ``AP`` averages the 10
  thresholds, ``AP50`` reports threshold 0.5 alone. Classes with no gt
  anywhere are excluded from the averages.

The distance-limited variants (AP within 100 m / 50 m) need per-instance
disparities that the export does not carry, as in JAX.
"""

from __future__ import annotations

import glob
import os
from dataclasses import dataclass, field
from typing import Any, Dict, Iterable, List, Optional, Sequence, Tuple

import numpy as np

from ..data.cityscapes import LABELS
from ..data.io import load_png

OVERLAPS = tuple(np.arange(0.5, 1.0, 0.05).round(2).tolist())
MIN_REGION_SIZE = 100


def eval_label_ids() -> List[int]:
    """The 8 thing labelIds scored by the Cityscapes instance benchmark."""
    return [l.id for l in LABELS if l.has_instances and not l.ignore_in_eval
            and l.id >= 0]


def void_label_ids() -> List[int]:
    """labelIds whose raw map value marks void (``ignore_in_eval``)."""
    return [l.id for l in LABELS if l.ignore_in_eval and l.id >= 0]


@dataclass
class _GtInstance:
    inst_id: int
    area: int
    group: bool                        # bare labelId region (crowd/group)
    small: bool                        # below min_region_size
    # (confidence, inter, pred_area) per overlapping prediction
    matched: List[Tuple[float, int, int]] = field(default_factory=list)

    @property
    def ignored(self) -> bool:
        return self.group or self.small


@dataclass
class _Prediction:
    score: float
    area: int
    void_inter: int
    # (gt_area, inter, gt_group, gt_small) per overlapped gt instance
    matched: List[Tuple[int, int, bool, bool]] = field(default_factory=list)


@dataclass
class APStat:
    """Per-(class, image) match lists, accumulated across a dataset."""

    gts: Dict[int, List[List[_GtInstance]]] = field(default_factory=dict)
    preds: Dict[int, List[List[_Prediction]]] = field(default_factory=dict)

    def add_image(self, label_id: int, gts: List[_GtInstance],
                  preds: List[_Prediction]) -> None:
        self.gts.setdefault(label_id, []).append(gts)
        self.preds.setdefault(label_id, []).append(preds)

    def __iadd__(self, other: "APStat") -> "APStat":
        for c, imgs in other.gts.items():
            self.gts.setdefault(c, []).extend(imgs)
        for c, imgs in other.preds.items():
            self.preds.setdefault(c, []).extend(imgs)
        return self


def match_single_image(
    gt_instance_map: np.ndarray,
    predictions: Sequence[Tuple[np.ndarray, int, float]],
    label_ids: Optional[Sequence[int]] = None,
    min_region_size: int = MIN_REGION_SIZE,
) -> APStat:
    """Match one image's predictions against its gt instance-id map.

    ``predictions`` is a sequence of ``(mask, label_id, score)`` where
    ``mask`` is any array whose nonzero pixels form the instance.
    """
    label_ids = list(label_ids) if label_ids is not None else eval_label_ids()
    gt = np.asarray(gt_instance_map)
    void = np.isin(gt, void_label_ids())

    gt_ids, gt_areas = np.unique(gt, return_counts=True)
    by_class: Dict[int, List[_GtInstance]] = {c: [] for c in label_ids}
    inst_index: Dict[int, _GtInstance] = {}
    for iid, area in zip(gt_ids.tolist(), gt_areas.tolist()):
        cls = iid // 1000 if iid >= 1000 else iid
        if cls not in by_class:
            continue
        gi = _GtInstance(inst_id=iid, area=int(area), group=iid < 1000,
                         small=area < min_region_size)
        by_class[cls].append(gi)
        inst_index[iid] = gi

    preds_by_class: Dict[int, List[_Prediction]] = {c: [] for c in label_ids}
    for mask, label_id, score in predictions:
        if label_id not in preds_by_class:
            continue
        m = np.asarray(mask) != 0
        if m.shape != gt.shape:
            raise ValueError(f"mask shape {m.shape} != gt shape {gt.shape}")
        area = int(np.count_nonzero(m))
        if area == 0:
            continue
        covered = gt[m]
        p = _Prediction(score=float(score), area=area,
                        void_inter=int(np.count_nonzero(void[m])))
        ids, inters = np.unique(covered, return_counts=True)
        for iid, inter in zip(ids.tolist(), inters.tolist()):
            cls = iid // 1000 if iid >= 1000 else iid
            if cls != label_id:
                continue
            gi = inst_index.get(iid)
            if gi is None:
                continue
            if not gi.ignored:
                gi.matched.append((float(score), int(inter), area))
            p.matched.append((gi.area, int(inter), gi.group, gi.small))
        preds_by_class[label_id].append(p)

    stat = APStat()
    for c in label_ids:
        stat.add_image(c, by_class[c], preds_by_class[c])
    return stat


def _curve_ap(y_true: np.ndarray, y_score: np.ndarray, hard_fns: int) -> float:
    """AP of one (class, overlap) confidence sweep, protocol integration."""
    order = np.argsort(y_score, kind="stable")
    y_score = y_score[order]
    y_true = y_true[order]
    cumsum = np.append(np.cumsum(y_true), 0.0)

    _, unique_idx = np.unique(y_score, return_index=True)
    n = len(y_score)
    n_true = cumsum[-2] if n else 0.0

    precision = np.zeros(len(unique_idx) + 1)
    recall = np.zeros(len(unique_idx) + 1)
    for out_i, idx in enumerate(unique_idx):
        below = cumsum[idx - 1]          # true positives lost below cutoff
        tp = n_true - below
        fp = n - idx - tp
        fn = below + hard_fns
        precision[out_i] = tp / (tp + fp)
        recall[out_i] = tp / (tp + fn) if (tp + fn) else 0.0
    precision[-1] = 1.0
    recall[-1] = 0.0

    r = np.concatenate([[recall[0]], recall, [0.0]])
    step = np.convolve(r, [-0.5, 0.0, 0.5], "valid")
    return float(np.dot(precision, step))


def _class_overlap_ap(gt_imgs: List[List[_GtInstance]],
                      pred_imgs: List[List[_Prediction]],
                      th: float) -> float:
    have_gt = any(not g.ignored for gts in gt_imgs for g in gts)
    have_pred = any(len(ps) for ps in pred_imgs)
    if not have_gt:
        return float("nan")
    if not have_pred:
        return 0.0

    trues: List[float] = []
    scores: List[float] = []
    hard_fns = 0
    for gts, preds in zip(gt_imgs, pred_imgs):
        for g in gts:
            if g.ignored:
                continue
            matched_scores = [
                score for score, inter, pred_area in g.matched
                if inter / (g.area + pred_area - inter) > th
            ]
            if matched_scores:
                matched_scores.sort(reverse=True)
                trues.append(1.0)
                scores.append(matched_scores[0])
                for s in matched_scores[1:]:       # duplicate detections
                    trues.append(0.0)
                    scores.append(s)
            else:
                hard_fns += 1
        for p in preds:
            # ANY overlapping gt (group/small included) above threshold
            # suppresses the prediction -- the tool's foundGt loop.
            found_gt = any(
                inter / (ga + p.area - inter) > th
                for ga, inter, _grp, _sml in p.matched
            )
            if found_gt:
                continue
            # Group and too-small overlaps accumulate via two independent
            # checks in the tool; a region that is both counts twice.
            ignore = p.void_inter
            for _ga, inter, grp, sml in p.matched:
                if grp:
                    ignore += inter
                if sml:
                    ignore += inter
            if ignore / p.area <= th:
                trues.append(0.0)
                scores.append(p.score)
    return _curve_ap(np.asarray(trues), np.asarray(scores), hard_fns)


def summarize(stat: APStat,
              overlaps: Sequence[float] = OVERLAPS) -> Dict[str, Any]:
    """Dataset-level AP / AP50 plus per-class values, Cityscapes layout."""
    names = {l.id: l.name for l in LABELS}
    per_class: Dict[str, Dict[str, float]] = {}
    all_aps: List[float] = []
    all_ap50: List[float] = []
    for c in sorted(stat.gts):
        aps = [_class_overlap_ap(stat.gts[c], stat.preds[c], th)
               for th in overlaps]
        ap = float(np.nanmean(aps)) if not all(np.isnan(aps)) else float("nan")
        ap50 = aps[0]
        per_class[names.get(c, str(c))] = {"ap": ap, "ap50": ap50}
        if not np.isnan(ap):
            all_aps.append(ap)
            all_ap50.append(ap50)
    return {
        "allAp": float(np.mean(all_aps)) if all_aps else 0.0,
        "allAp50": float(np.mean(all_ap50)) if all_ap50 else 0.0,
        "per_class": per_class,
    }


# ---------------------------------------------------------------------------
# File protocol: the export layout written by cli/export_instances.py —
# per frame a "{name}.txt" of "maskfile labelId score" lines next to the
# binary mask PNGs, scored against "*_gtFine_instanceIds.png".
# ---------------------------------------------------------------------------

def ap_compute_folders(pred_dir: str, gt_dir: str,
                       min_region_size: int = MIN_REGION_SIZE
                       ) -> Dict[str, Any]:
    gt_paths = {
        "_".join(os.path.basename(p).split("_")[:3]): p
        for p in glob.glob(
            os.path.join(gt_dir, "**", "*_gtFine_instanceIds.png"),
            recursive=True,
        )
    }
    if not gt_paths:
        raise ValueError(
            f"no gt instanceIds maps (*_gtFine_instanceIds.png) in {gt_dir}"
        )
    # Drive the sweep from the GT list, like evalInstanceLevelSemantic-
    # Labeling (and pq_compute_folders): every gt frame must have a
    # prediction manifest — a missing one is an error, never a silent
    # skip (which would drop that frame's gt instances from the FN pool
    # and inflate AP). Extra manifests without gt are ignored, matching
    # the external tool.
    names = sorted(gt_paths)
    for name in names:
        txt = os.path.join(pred_dir, name + ".txt")
        if not os.path.exists(txt):
            raise ValueError(
                f"no prediction manifest for gt frame {name}: {txt}"
            )

    def one(name) -> APStat:
        gt_map = load_png(gt_paths[name]).astype(np.int64)
        preds = []
        with open(os.path.join(pred_dir, name + ".txt")) as f:
            for line in f:
                parts = line.split()
                if not parts:
                    continue
                mask_file, label_id, score = \
                    parts[0], int(parts[1]), float(parts[2])
                mask = load_png(os.path.join(pred_dir, mask_file))
                preds.append((mask, label_id, score))
        return match_single_image(gt_map, preds,
                                  min_region_size=min_region_size)

    # Serial sweep, as in JAX: the matching is GIL-bound.
    stat = APStat()
    for name in names:
        stat += one(name)
    return summarize(stat)


def format_results(res: Dict[str, Any]) -> str:
    lines = [f"{'':14s} {'AP':>7s} {'AP50%':>7s}"]
    lines.append(f"{'all':14s} {100 * res['allAp']:7.2f} "
                 f"{100 * res['allAp50']:7.2f}")
    for name, r in res["per_class"].items():
        ap = r["ap"]
        ap50 = r["ap50"]
        lines.append(
            f"  {name:12s} "
            + (f"{100 * ap:7.2f}" if not np.isnan(ap) else "    nan")
            + " "
            + (f"{100 * ap50:7.2f}" if not np.isnan(ap50) else "    nan")
        )
    return "\n".join(lines)
