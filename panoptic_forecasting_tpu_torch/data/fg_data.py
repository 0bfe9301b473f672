"""Foreground datasets: per-instance tracks (training) and per-scene
instance sets (eval/export), and the fg data helpers.

Counterpart of ``panoptic_forecasting_tpu/data/fg_data.py`` (reference
datasets/fg_scene_dataset.py, fg_instance_dataset.py). Artifacts:

* ``{split}_instance_meta.pkl`` / ``{split}_seq_meta.pkl`` — per track
  (30, ...) or per scene (N, 30, ...): track_id, class, bboxes (ULBR),
  feat_mask, feat_ind (and inst_ind per track);
* ``{split}_depth_instance_info.pkl`` / ``{split}_depth_seq_info.pkl`` —
  per-frame instance depths (−1 / 1000000 = invalid);
* ``{split}_feats.h5`` keyed ``city/seq/frame`` → (K, 256, 14, 14) MaskRCNN
  ROI features, indexed by ``feat_ind``;
* ``{split}_3d_info.pkl`` — odometry (30, 5) + times (30);
* a predicted-odometry h5 keyed ``city/seq/frame/start`` → (K, 2)
  (speed, yaw rate), expanded through the unicycle model with the mean
  input Δt (fg_instance_dataset.py:384-412);
* ``background_dir/{split}/{city}/*_gtFine_labelIds.png`` bg canvases.

Frames are sampled every 3: training windows start at {4, 7, 10} (every
start with ``expand_train``), the val track window at 19 − 3·(in+out−1)
(fg_instance_dataset.py:159-165); scene eval takes inds [4..19] (+6 for
short-term ``output_ind == 0``, fg_scene_dataset.py:206-211). The train
split's statistics (``compute_fg_stats``) go on the card. Each scene's
instances are dense arrays padded to a multiple of
``instance_pad_multiple`` with a ``valid`` mask.
Cityscapes heuristics kept: ``filter_car_gap``
(fg_instance_dataset.py:184-217), ``add_car_offscreen_loc`` (219-286).

Tables are read through ``io.read_table`` (rows as dicts) and h5 files
through ``io.open_h5``. With ``use_condensed_feats`` both datasets read
the features from ``{split}_condensed_feats.h5``, indexed by the
``feat_ind`` column of ``{split}_instance_condensed_feat_info.pkl`` (per
track) or ``{split}_seq_condensed_feat_info.pkl`` (per scene), whose rows
align with the meta tables' (fg_instance_dataset.py:64-68, 371-375;
fg_scene_dataset.py:68-72).
"""

from __future__ import annotations

import os
from typing import Any, Dict, List, Optional, Tuple

import numpy as np

from ..geometry.boxes import bbox_ulbr_to_cwh
from ..geometry.egomotion import unicycle_pose_delta_np
from .cards import DataCard
from . import io
from .io import load_png

IMG_SIZE = (2048, 1024)
INVALID_DEPTHS = (-1.0, 1000000.0)


def expand_predicted_odom(odom_preds: np.ndarray, avg_dt: float) -> np.ndarray:
    """(K, 2) predicted (speed, yaw) -> (K, 5) with unicycle (dx, dy, dθ)."""
    out = np.zeros((len(odom_preds), 5), np.float32)
    for i, (speed, yaw) in enumerate(odom_preds):
        dx, dy, dth = unicycle_pose_delta_np(
            float(speed), float(yaw), float(avg_dt)
        )
        out[i] = [speed, yaw, dx, dy, dth]
    return out


def filter_car_gap(bboxes_ulbr, bbox_mask, feat_mask, gap: float,
                   border_dist: float, seq_len: int,
                   img_w: float = IMG_SIZE[0]):
    """Zero a car track after an implausible border jump
    (fg_instance_dataset.py:184-217). Arrays are modified copies."""
    bboxes = bboxes_ulbr.copy()
    bm = bbox_mask.copy()
    fm = feat_mask.copy()
    past_loc = None
    found_x0 = found_x1 = zero_rest = False
    for t in range(seq_len):
        if not zero_rest:
            if not bm[t]:
                continue
            x0, y0, x1, y1 = bboxes[t]
            if x0 < border_dist:
                found_x0 = True
            if x1 > img_w - border_dist:
                found_x1 = True
            if found_x0:
                if past_loc is not None and x1 > past_loc + gap:
                    zero_rest = True
                past_loc = x1
            if found_x1:
                if past_loc is not None and x0 < past_loc - gap:
                    zero_rest = True
                past_loc = x0
        if zero_rest:
            bm[t] = False
            fm[t] = False
            bboxes[t] = 0
    return bboxes, bm, fm


def add_car_offscreen_loc(cl: int, bboxes_ulbr, bbox_mask, input_len: int,
                          output_len: int, img_size=IMG_SIZE):
    """Extrapolate a car that left the frame (fg_instance_dataset.py:219-286)."""
    if cl != 13:
        return bboxes_ulbr, bbox_mask
    bboxes = bboxes_ulbr.copy()
    bm = bbox_mask.copy()
    seq_len = input_len + output_len
    completed = False
    for out_t in range(1, seq_len):
        if completed:
            break
        if not bm[out_t] and bm[out_t - 1]:
            if out_t < input_len - output_len - 1 and np.any(bm[out_t + 1 :]):
                continue
            x0, y0, x1, y1 = bboxes[out_t - 1]
            if x0 < 200:
                if out_t > 1 and bm[out_t - 2]:
                    o = bboxes[out_t - 2]
                    vx, vy0, vy1 = x1 - o[2], y0 - o[1], y1 - o[3]
                    if vx > 0:
                        break
                    for t in range(out_t, seq_len):
                        x0 = max(x0 + vx, -20)
                        x1 = max(x1 + vx, -10)
                        y0 = min(y0 + vy0, img_size[1] + 10)
                        y1 = min(y1 + vy1, img_size[1] + 20)
                        bboxes[t] = [x0, y0, x1, y1]
                        bm[t] = True
                    completed = True
            elif x1 > img_size[0] - 200:
                if out_t > 1 and bm[out_t - 2]:
                    o = bboxes[out_t - 2]
                    vx, vy0, vy1 = x0 - o[0], y0 - o[1], y1 - o[3]
                    if vx < 0:
                        break
                    for t in range(out_t, seq_len):
                        x0 = min(x0 + vx, img_size[0] + 10)
                        x1 = min(x1 + vx, img_size[0] + 10)
                        y0 = min(y0 + vy0, img_size[1] + 10)
                        y1 = min(y1 + vy1, img_size[1] + 20)
                        bboxes[t] = [x0, y0, x1, y1]
                        bm[t] = True
                    completed = True
    return bboxes, bm


def _depth_valid(depths, max_depth):
    ok = (depths != INVALID_DEPTHS[0]) & (depths != INVALID_DEPTHS[1])
    if max_depth is not None:
        ok = ok & (depths <= max_depth)
    return ok


def compute_fg_stats(all_bboxes, all_feat_masks, all_depths, max_depth,
                     use_ulbr: bool, input_len: int, output_len: int,
                     expand_train: bool, card: DataCard, odometry=None):
    """Masked mean/std of locations, velocities, depths, depth velocities
    over the training windows (fg_instance_dataset.py:86-154)."""
    if not use_ulbr:
        all_bboxes = bbox_ulbr_to_cwh(all_bboxes)
    all_depth_masks = _depth_valid(all_depths, max_depth)
    inds = np.arange(0, 3 * (input_len + output_len), 3)
    if expand_train:
        start_inds = range(30 - 3 * (input_len + output_len - 1))
    else:
        start_inds = [1, 4, 7, 10]
    locs, loc_masks, deps, dep_masks = [], [], [], []
    for s in start_inds:
        locs.append(all_bboxes[:, inds + s])
        loc_masks.append(all_feat_masks[:, inds + s])
        deps.append(all_depths[:, inds + s])
        dep_masks.append(all_depth_masks[:, inds + s])
    locs = np.concatenate(locs)
    loc_masks = np.concatenate(loc_masks).astype(bool)
    deps = np.concatenate(deps)
    dep_masks = np.concatenate(dep_masks).astype(bool)

    flat = locs.reshape(-1, 4)[loc_masks.reshape(-1)]
    mean_loc, std_loc = flat.mean(0), flat.std(0)
    vel_masks = loc_masks[:, 1:] & loc_masks[:, :-1]
    vels = (locs[:, 1:] - locs[:, :-1]).reshape(-1, 4)[vel_masks.reshape(-1)]
    mean_vel, std_vel = vels.mean(0), vels.std(0)
    card.set_stats(
        "traj",
        np.concatenate([mean_loc, mean_vel]),
        np.concatenate([std_loc, std_vel]),
    )
    fd = deps.reshape(-1)[dep_masks.reshape(-1)]
    dvm = dep_masks[:, 1:] & dep_masks[:, :-1]
    dv = (deps[:, 1:] - deps[:, :-1]).reshape(-1)[dvm.reshape(-1)]
    card.set_stats(
        "depth", np.array([fd.mean(), dv.mean()]), np.array([fd.std(), dv.std()])
    )
    if odometry is not None:
        flat_o = odometry.reshape(-1, 5)
        card.set_stats("odom", flat_o.mean(0), flat_o.std(0))
        card.extras["odom_size"] = 5


class FGInstanceDataset:
    """One sample = one instance track over ``input_len`` + 3 frames
    (training; JAX data/fg_data.py:194-457)."""

    def __init__(self, split: str, cfg: Dict[str, Any], card: DataCard,
                 test: bool = False):
        d = cfg.get("data", {})
        self.split = split
        self.test = test
        self.input_len = int(d.get("input_len", 3))
        self.output_len = 3
        self.seq_len = self.input_len + self.output_len
        self.use_ulbr = bool(cfg.get("use_bbox_ulbr"))
        self.max_depth = d.get("max_depth")
        self.expand_train = bool(d.get("expand_train"))
        self.require_most_recent = bool(d.get("require_most_recent"))
        self.filter_car_gap = d.get("filter_car_gap")
        self.filter_car_gap_borderdist = d.get(
            "filter_car_gap_borderdist", self.filter_car_gap
        )
        self.add_car_offscreen = bool(d.get("add_car_offscreen_loc"))
        self.no_feats = bool(d.get("no_feats"))
        self.use_3d_info = bool(d.get("use_3d_info"))
        card.num_classes = 19
        card.extras.setdefault("img_size", list(IMG_SIZE))

        data_dir = d["data_dir"]
        self.rows = io.read_table(os.path.join(data_dir, f"{split}_instance_meta.pkl"))
        # Depth-source variants (fg_instance_dataset.py:30-31, 58-62).
        depth_stem = "cascadedepth" if d.get("use_cascade_depths") else "depth"
        depth_rows = io.read_table(os.path.join(
            d.get("depth_dir", data_dir), f"{split}_{depth_stem}_instance_info.pkl"))
        self.depths = [np.asarray(r["depth"]) for r in depth_rows]
        feats_dir = d.get("feats_dir", data_dir)
        # condensed-feats variant: another h5 and a feat_ind column whose
        # rows align with the meta table's (fg_instance_dataset.py:64-68)
        condensed = bool(d.get("use_condensed_feats"))
        self.feat_inds = None
        if condensed and not self.no_feats:
            self.feat_inds = [np.asarray(r["feat_ind"]) for r in io.read_table(
                os.path.join(feats_dir, f"{split}_instance_condensed_feat_info.pkl"))]
        feats_name = f"{split}_condensed_feats.h5" if condensed else f"{split}_feats.h5"
        self.feats_h5 = None if self.no_feats else io.open_h5(
            os.path.join(feats_dir, feats_name))
        self._dsets: Dict[Tuple[str, str, int], Any] = {}
        self.data3d = None
        if self.use_3d_info:
            self.data3d = io.read_table(
                os.path.join(d.get("info_3d_dir", data_dir), f"{split}_3d_info.pkl"))
            self._d3_index = {(r["city"], r["seq"], int(r["frame"])): i
                              for i, r in enumerate(self.data3d)}
        self.odom_h5 = None
        if d.get("odom_pred_dir"):
            self.odom_h5 = io.open_h5(
                os.path.join(d["odom_pred_dir"], f"odometry_{split}.h5"))

        if split == "train":
            compute_fg_stats(
                np.stack([r["bboxes"] for r in self.rows]),
                np.stack([r["feat_mask"] for r in self.rows]),
                np.stack(self.depths), self.max_depth, self.use_ulbr,
                self.input_len, self.output_len, self.expand_train, card,
                odometry=(np.stack([r["odometry"] for r in self.data3d])
                          if self.use_3d_info else None),
            )

        base = np.arange(0, 3 * self.seq_len, 3)
        if split == "train" and self.expand_train:
            start_inds = range(30 - 3 * (self.seq_len - 1))
        elif split == "train":
            start_inds = [4, 7, 10]
        else:
            start_inds = [19 - 3 * (self.seq_len - 1)]
        self.index: List[Tuple[int, int, np.ndarray]] = []
        for idx, rec in enumerate(self.rows):
            fm = np.asarray(rec["feat_mask"])
            for s in start_inds:
                inds = base + s
                if np.any(fm[inds[: self.input_len]]) and np.any(
                        fm[inds[self.input_len:]]):
                    if self.require_most_recent and not fm[inds[self.input_len - 1]]:
                        continue
                    self.index.append((idx, s, inds))

    def __len__(self) -> int:
        return len(self.index)

    def _load_feats(self, city, seq, frame, feat_inds) -> np.ndarray:
        if self.feats_h5 is None:
            return np.zeros((len(feat_inds), 256, 14, 14), np.float32)
        key = (city, seq, int(frame))
        dset = self._dsets.get(key)
        if dset is None:
            dset = self._dsets[key] = self.feats_h5.mmap_dataset(f"{city}/{seq}/{frame}")
        feats = np.zeros((len(feat_inds),) + dset.shape[1:], np.float32)
        valid = feat_inds != -1
        if valid.any():
            vi = feat_inds[valid]
            if len(vi) > 1 and np.all(np.diff(vi) == 1):
                block = dset[int(vi[0]): int(vi[-1]) + 1]
            else:
                block = dset[list(vi)]
            feats[valid] = np.asarray(block, np.float32)
        return feats

    def _load_odometry(self, city, seq, frame, inds) -> Optional[np.ndarray]:
        if not self.use_3d_info:
            return None
        rec3d = self.data3d[self._d3_index[(city, seq, int(frame))]]
        odom = np.asarray(rec3d["odometry"], np.float32)
        if self.odom_h5 is None:
            return odom[inds]
        start_fr = int(inds[self.input_len - 1])
        times = np.asarray(rec3d["times"], np.float64)[int(inds[0]): start_fr + 1]
        avg_dt = float(np.mean(times[1:] - times[:-1]))
        preds = np.asarray(self.odom_h5[f"{city}/{seq}/{frame}/{start_fr}"][:])
        expanded = expand_predicted_odom(preds, avg_dt)
        return np.concatenate([odom[inds[: self.input_len]],
                               expanded[[2, 5, 8]]]).astype(np.float32)

    def __getitem__(self, i: int) -> Dict[str, Any]:
        idx, start_fr, inds = self.index[i]
        rec = self.rows[idx]
        city, seq, frame = rec["city"], rec["seq"], int(rec["frame"])
        cl = int(rec["class"])

        bboxes = np.asarray(rec["bboxes"], np.float32)[inds]
        bbox_mask = np.asarray(rec["feat_mask"])[inds].astype(bool)
        feat_mask = bbox_mask.copy()
        if self.filter_car_gap is not None and cl == 13:
            bboxes, bbox_mask, feat_mask = filter_car_gap(
                bboxes, bbox_mask, feat_mask, self.filter_car_gap,
                self.filter_car_gap_borderdist, self.seq_len,
            )
        if self.add_car_offscreen:
            bboxes, bbox_mask = add_car_offscreen_loc(
                cl, bboxes, bbox_mask, self.input_len, self.output_len
            )
        if not self.use_ulbr:
            bboxes = bbox_ulbr_to_cwh(bboxes)

        bm = bbox_mask.astype(np.float32)
        vel = np.concatenate([np.zeros((1, 4), np.float32), bboxes[1:] - bboxes[:-1]])
        vel[1:] *= (bm[:-1] * bm[1:])[:, None]
        vel_mask = np.concatenate([np.zeros(1, bool), bbox_mask[1:] & bbox_mask[:-1]])
        traj = np.concatenate([bboxes, vel], axis=-1)

        depths = np.asarray(self.depths[idx], np.float32)[inds][:, None]
        depth_mask = _depth_valid(depths, self.max_depth)
        dvel = np.concatenate([np.zeros((1, 1), np.float32), depths[1:] - depths[:-1]])
        depths = np.concatenate([depths, dvel], axis=-1)

        feat_inds = (np.asarray(rec["feat_ind"]) if self.feat_inds is None
                     else self.feat_inds[idx])
        feats = self._load_feats(city, seq, frame, feat_inds[inds])
        one_hot = np.zeros(8, np.float32)
        one_hot[cl - 11] = 1
        n_in = self.input_len
        out: Dict[str, Any] = {
            "inputs": {
                "feat_masks": feat_mask,
                "bbox_masks": bbox_mask,
                "bbox_vel_masks": vel_mask,
                "trajectories": traj[:n_in],
                "classes": np.array(cl - 11, np.int64),
                "one_hot_classes": one_hot,
                "depths": depths[:n_in],
                "depth_masks": depth_mask[:n_in],
                "feats": feats[:n_in],
            },
            "labels": {
                "trajectories": traj[n_in:],
                "output_inds": np.array(self.output_len - 1, np.int64),
                "depths": depths[n_in:],
                "depth_masks": depth_mask[n_in:],
                "feats": feats[n_in:],
            },
            "meta": {
                "city": city,
                "seq": seq,
                "frame": frame,
                "track_id": rec["track_id"],
                "instance_ind": rec.get("inst_ind", idx),
            },
        }
        odom = self._load_odometry(city, seq, frame, inds)
        if odom is not None:
            out["inputs"]["odometry"] = odom
        return out


def fg_scene_collate(samples: List[Dict[str, Any]]) -> Dict[str, Any]:
    """Collate FGSceneDataset samples whose instance buckets differ.

    Each scene pads its instance axis independently to a multiple of
    ``pad_multiple`` (see ``FGSceneDataset.__getitem__``), so two scenes in
    one batch may land in different buckets (e.g. 8 vs 16 instances). The
    reference side-steps this with a list collate
    (fg_scene_dataset.py:514-528); as in the JAX package every scene is
    re-padded to the **batch max** bucket here, so ``np.stack`` succeeds.
    """
    from .loader import default_collate

    pad_n = max(s["inputs"]["valid"].shape[0] for s in samples)

    def repad(x, fill=0):
        if not isinstance(x, np.ndarray) or x.shape[0] == pad_n:
            return x
        padding = np.full((pad_n - x.shape[0],) + x.shape[1:], fill, x.dtype)
        return np.concatenate([x, padding])

    padded = []
    for s in samples:
        ns = dict(s)
        # 'background' is the (H, W) canvas, not an instance-axis array.
        ns["inputs"] = {
            k: (v if k == "background" else repad(v))
            for k, v in s["inputs"].items()
        }
        # output_inds is constant per scene; extend with its own value so
        # padded rows still select a valid decode step.
        ns["labels"] = {
            k: repad(v, fill=v.flat[-1] if k == "output_inds" else 0)
            for k, v in s["labels"].items()
        }
        padded.append(ns)
    return default_collate(padded)


class FGSceneDataset:
    """One sample = all instances of a scene, padded to ``pad_multiple``."""

    def __init__(self, split: str, cfg: Dict[str, Any], card: DataCard,
                 test: bool = False):
        d = cfg.get("data", {})
        self.split = split
        self.test = test
        self.input_len = int(d.get("input_len", 3))
        self.output_len = 3
        self.seq_len = self.input_len
        self.use_ulbr = bool(cfg.get("use_bbox_ulbr"))
        self.max_depth = d.get("max_depth")
        self.require_most_recent = bool(d.get("require_most_recent"))
        self.filter_car_gap = d.get("filter_car_gap")
        self.filter_car_gap_borderdist = d.get(
            "filter_car_gap_borderdist", self.filter_car_gap
        )
        self.add_car_offscreen = bool(d.get("add_car_offscreen_loc"))
        self.output_ind = d.get("output_ind")
        self.no_feats = bool(d.get("no_feats"))
        self.use_3d_info = bool(d.get("use_3d_info"))
        self.pad_multiple = int(d.get("instance_pad_multiple", 8))
        self.background_dir = (
            os.path.join(d["background_dir"], split)
            if d.get("background_dir")
            else None
        )
        card.num_classes = 19
        card.extras.setdefault("img_size", list(IMG_SIZE))
        card.extras["odom_size"] = 5

        data_dir = d["data_dir"]
        self.data = io.read_table(os.path.join(data_dir, f"{split}_seq_meta.pkl"))
        # Depth-source variants (fg_scene_dataset.py:28-29, 60-66).
        if d.get("use_cascade_depths"):
            depth_stem = "cascadedepth"
        elif d.get("use_monodepth"):
            depth_stem = "monodepth"
        else:
            depth_stem = "depth"
        self.depth_data = io.read_table(
            os.path.join(
                d.get("depth_dir", data_dir),
                f"{split}_{depth_stem}_seq_info.pkl",
            )
        )
        feats_dir = d.get("feats_dir", data_dir)
        # Condensed-feats variant (fg_scene_dataset.py:68-72, 352).
        self.use_condensed_feats = bool(d.get("use_condensed_feats"))
        feats_name = (
            f"{split}_condensed_feats.h5"
            if self.use_condensed_feats
            else f"{split}_feats.h5"
        )
        self.feats_meta = (
            io.read_table(
                os.path.join(
                    feats_dir, f"{split}_seq_condensed_feat_info.pkl"
                )
            )
            if self.use_condensed_feats and not self.no_feats
            else None
        )
        self.feats_h5 = (
            None if self.no_feats else io.open_h5(os.path.join(feats_dir, feats_name))
        )
        self.data3d = None
        if self.use_3d_info:
            self.data3d = io.read_table(
                os.path.join(d.get("info_3d_dir", data_dir), f"{split}_3d_info.pkl")
            )
            self._d3_index = {
                (r["city"], r["seq"], int(r["frame"])): i
                for i, r in enumerate(self.data3d)
            }
        self.odom_pred_path = None
        if d.get("odom_pred_dir"):
            odom_name = d.get("odom_name", "predicted_odometry")
            self.odom_pred_path = os.path.join(
                d["odom_pred_dir"], f"{odom_name}_{split}.h5"
            )
            self.odom_h5 = io.open_h5(self.odom_pred_path)

        if split == "train":
            all_bboxes = np.concatenate([r["bboxes"] for r in self.data])
            all_masks = np.concatenate([r["feat_mask"] for r in self.data])
            all_depths = np.concatenate([r["depth"] for r in self.depth_data])
            odom = (
                np.stack([r["odometry"] for r in self.data3d])
                if self.use_3d_info
                else None
            )
            compute_fg_stats(
                all_bboxes, all_masks, all_depths, self.max_depth,
                self.use_ulbr, self.input_len, self.output_len,
                False, card, odometry=odom,
            )

        # Windows per scene (fg_scene_dataset.py:185-211): val/export takes
        # the single eval window; train (or expand_test) enumerates start
        # offsets, keeping windows where any instance has a feature at the
        # required input frames (last input when require_most_recent).
        self.index: List[Tuple[int, np.ndarray]] = []
        in_l, out_l = self.input_len, self.output_len
        base_inds = np.arange(0, 3 * (in_l + out_l), 3)
        expand_train = bool(d.get("expand_train"))
        expand_test = bool(d.get("expand_test"))
        train_windows = split == "train" or (test and expand_test)
        if (split == "train" and expand_train) or (test and expand_test):
            start_inds = list(range(30 - 3 * (in_l + out_l - 1)))
        elif split == "train":
            start_inds = [4, 7, 10]
        else:
            start_inds = [19 - 3 * (in_l + out_l - 1)]
        inds = np.array([4, 7, 10, 13, 16, 19])
        for idx in range(len(self.data)):
            if train_windows:
                feat_mask = np.asarray(self.data[idx]["feat_mask"])
                for start in start_inds:
                    cur = start + base_inds
                    fm = feat_mask[:, cur][:, :in_l]
                    if self.require_most_recent:
                        fm = fm[:, -1]
                    if np.any(fm):
                        self.index.append((idx, cur))
            elif self.output_ind == 0:
                self.index.append((idx, inds + 6))
            else:
                self.index.append((idx, inds))

    def __len__(self) -> int:
        return len(self.index)

    def __getitem__(self, i: int) -> Dict[str, Any]:
        idx, fr_inds = self.index[i]
        rec = self.data[idx]
        drec = self.depth_data[idx]
        city, seq, frame = rec["city"], rec["seq"], int(rec["frame"])
        in_l, out_l = self.input_len, self.output_len

        feat_mask_all = np.asarray(rec["feat_mask"])[:, fr_inds]
        if self.feats_meta is not None:
            feat_inds_all = np.asarray(
                self.feats_meta[idx]["feat_ind"]
            )[:, fr_inds]
        else:
            feat_inds_all = np.asarray(rec["feat_ind"])[:, fr_inds]
        if self.require_most_recent:
            has_gt = feat_mask_all[:, in_l - 1].astype(bool)
        else:
            has_gt = feat_mask_all[:, :in_l].sum(1) > 0
        feat_masks = feat_mask_all[has_gt].astype(bool)
        feat_inds = feat_inds_all[has_gt]
        track_ids = np.asarray(rec["track_id"])[has_gt]
        classes = np.asarray(rec["class"])[has_gt].astype(np.int64)
        n = len(track_ids)

        bboxes = np.asarray(rec["bboxes"], np.float32)[has_gt][:, fr_inds]
        bbox_mask = feat_mask_all[has_gt].astype(bool)
        depths = np.asarray(drec["depth"], np.float32)[has_gt][:, fr_inds]

        out_sel = self.output_ind if self.output_ind is not None else out_l - 1
        target_frame = frame - 19 + int(fr_inds[in_l:][out_sel])

        # per-instance heuristics (ULBR space)
        for k in range(n):
            if self.filter_car_gap is not None and classes[k] == 13:
                bboxes[k], bbox_mask[k], feat_masks[k] = filter_car_gap(
                    bboxes[k], bbox_mask[k], feat_masks[k],
                    self.filter_car_gap, self.filter_car_gap_borderdist,
                    in_l + out_l,
                )
            if self.add_car_offscreen and not self.test:
                bboxes[k], bbox_mask[k] = add_car_offscreen_loc(
                    int(classes[k]), bboxes[k], bbox_mask[k], in_l, out_l
                )
        if not self.use_ulbr:
            bboxes = bbox_ulbr_to_cwh(bboxes)

        bm = bbox_mask.astype(np.float32)
        vel = np.concatenate(
            [np.zeros((n, 1, 4), np.float32), bboxes[:, 1:] - bboxes[:, :-1]],
            axis=1,
        )
        vel[:, 1:] *= (bm[:, :-1] * bm[:, 1:])[..., None]
        vel_mask = np.concatenate(
            [np.zeros((n, 1), bool), bbox_mask[:, 1:] & bbox_mask[:, :-1]], axis=1
        )
        traj = np.concatenate([bboxes, vel], axis=-1)

        depths = depths[..., None]
        depth_mask = _depth_valid(depths, self.max_depth)
        dvel = np.concatenate(
            [np.zeros((n, 1, 1), np.float32), depths[:, 1:] - depths[:, :-1]],
            axis=1,
        )
        dvel[:, 1:] *= depth_mask[:, :-1] & depth_mask[:, 1:]
        depths = np.concatenate([depths, dvel], axis=-1)

        if self.feats_h5 is not None and n > 0:
            # memmap when contiguous: lock-free page-cache reads (same
            # fast path as FGInstanceDataset._load_feats)
            dset = self.feats_h5.mmap_dataset(f"{city}/{seq}/{frame}")
            feats = np.zeros((n, len(fr_inds)) + dset.shape[1:], np.float32)
            for k in range(n):
                valid = feat_inds[k] != -1
                if valid.any():
                    vi = feat_inds[k][valid]
                    if len(vi) > 1 and np.all(np.diff(vi) == 1):
                        block = dset[int(vi[0]) : int(vi[-1]) + 1]
                    else:
                        block = dset[list(vi)]
                    feats[k][valid] = np.asarray(block, np.float32)
        else:
            feats = np.zeros((n, len(fr_inds), 256, 14, 14), np.float32)

        odometry = None
        if self.use_3d_info:
            rec3d = self.data3d[self._d3_index[(city, seq, frame)]]
            if self.odom_pred_path is not None:
                inp_odom = np.asarray(rec3d["odometry"], np.float32)[
                    fr_inds[:in_l]
                ]
                start_fr = int(fr_inds[in_l - 1])
                times = np.asarray(rec3d["times"], np.float64)[
                    int(fr_inds[0]) : start_fr + 1
                ]
                avg_dt = float(np.mean(times[1:] - times[:-1]))
                preds = np.asarray(
                    self.odom_h5[f"{city}/{seq}/{frame}/{start_fr}"][:])
                expanded = expand_predicted_odom(preds, avg_dt)[[2, 5, 8]]
                odometry = np.concatenate([inp_odom, expanded]).astype(np.float32)
            else:
                odometry = np.asarray(rec3d["odometry"], np.float32)[fr_inds]

        # ---- pad to bucket ----
        pad_n = max(
            self.pad_multiple,
            -(-max(n, 1) // self.pad_multiple) * self.pad_multiple,
        )

        def pad(x, fill=0):
            if x.shape[0] == pad_n:
                return x
            padding = np.full((pad_n - x.shape[0],) + x.shape[1:], fill, x.dtype)
            return np.concatenate([x, padding])

        one_hot = np.zeros((n, 8), np.float32)
        if n:
            one_hot[np.arange(n), classes - 11] = 1

        out: Dict[str, Any] = {
            "inputs": {
                "valid": pad(np.ones(n, bool)),
                "feat_masks": pad(feat_masks),
                "bbox_masks": pad(bbox_mask),
                "bbox_vel_masks": pad(vel_mask),
                "trajectories": pad(traj[:, :in_l].astype(np.float32)),
                "depths": pad(depths[:, :in_l].astype(np.float32)),
                "depth_masks": pad(depth_mask[:, :in_l]),
                "classes": pad(classes - 11),
                "one_hot_classes": pad(one_hot),
                "feats": pad(feats[:, :in_l]),
            },
            "labels": {
                "output_inds": pad(
                    np.full(n, out_sel, np.int64), fill=out_sel
                ),
                "trajectories": pad(traj[:, in_l:].astype(np.float32)),
                "depths": pad(depths[:, in_l:].astype(np.float32)),
                "depth_masks": pad(depth_mask[:, in_l:]),
                "feats": pad(feats[:, in_l:]),
            },
            "meta": {
                "city": city,
                "seq": seq,
                "frame": frame,
                "track_ids": track_ids,
                "num_instances": n,
                "target_frame": target_frame,
                "fr_inds": fr_inds,
            },
        }
        if odometry is not None:
            out["inputs"]["odometry"] = np.broadcast_to(
                odometry[None], (pad_n,) + odometry.shape
            ).copy()
        if self.background_dir is not None:
            bg = load_png(
                os.path.join(
                    self.background_dir, city,
                    f"{city}_{seq}_{target_frame:06d}_gtFine_labelIds.png",
                )
            )
            out["inputs"]["background"] = bg.astype(np.int32)
        return out
