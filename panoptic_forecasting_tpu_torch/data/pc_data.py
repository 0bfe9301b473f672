"""PC-transform dataset: frames, depths, cameras, cumulative ego transforms.

Counterpart of ``panoptic_forecasting_tpu/data/pc_data.py`` (reference
``PCTransformDataset``, datasets/pc_transform_dataset.py:22-317). Per
sample: 3 input segmentation PNGs (``pred_mask_*``, labelId space) or,
with ``use_imgs``, the 3 ``leftImg8bit_sequence`` RGB frames, + a
disparity -> metric depth + camera intrinsics/extrinsics + the
cumulative ego-motion transform mapping each input frame into the target
frame's vehicle coordinates. Ego motion comes from GT
``vehicle_sequence`` JSONs + ``timestamp_sequence`` (per-frame unicycle
transforms composed backward from the target), or from a
predicted-odometry h5 keyed ``city/seq/frame/start`` whose future steps
extrapolate with the mean past Δt (pc_transform_dataset.py:146-186).
``no_moving_objects`` drops pixels whose labelId has instances from the
depth mask (with ``use_imgs``, the labels of the ``pred_mask`` PNG).

Depth sources: stereo ``disparity_sequence`` PNGs (the default), cascade
disparity PNGs (``use_cascade_disps``: a flat layout, ``disp·256``), or
monodepth ``.npy`` disparities (``use_mono``, read as JAX reads it:
``use_mono`` if set, else ``use_mono_disps``) resized bilinearly to
1024x2048 and turned into ``monodepth_factor / disp``. ``disparity_dir``
moves the disparities (flat under cascade, else per split).

Frame convention: annotated frame = index 19 of the 30-frame snippet;
inputs are [0, 3, 6] + target − (6 + gap_len). The target is 19, or
every frame from 6 + gap_len to 29 with ``use_all_targets`` (train
split) or ``expand_test``. ``cities`` keeps the snippets of those cities;
``check_output_dir`` skips a target whose exported labelIds PNG exists
there (resumable exports).
"""

from __future__ import annotations

import os
from typing import Any, Dict, List, Tuple

import numpy as np

from ..geometry.camera import (
    extrinsics_from_cityscapes_camera,
    intrinsics_from_cityscapes_camera,
    intrinsics_matrix,
)
from ..geometry.egomotion import unicycle_now_T_prev_np
from . import io
from .cards import DataCard
from .cityscapes import LABELS
from .io import (
    decode_disparity_png,
    disparity_to_depth,
    load_depth,
    load_png_batch,
    read_json_file,
)

MOVING_LABEL_IDS = np.array(
    [l.id for l in LABELS if l.has_instances and l.id >= 0], np.int64
)


def compose_cumulative(ego_transforms: np.ndarray, target: int) -> np.ndarray:
    """cumulative[k] = T(target ← k) for k = 0..target.

    ``ego_transforms[f]`` maps frame f → f+1 (backward composition,
    pc_transform_dataset.py:221-228).
    """
    out = [np.eye(4)]
    cur = np.eye(4)
    for f in range(target - 1, -1, -1):
        cur = cur @ ego_transforms[f]
        out.append(cur)
    out.reverse()
    return np.stack(out)


class PCTransformDataset:
    def __init__(self, split: str, cfg: Dict[str, Any], card: DataCard,
                 test: bool = False):
        d = cfg.get("data", {})
        self.split = split
        self.cityscapes_dir = d["cityscapes_dir"]
        self.seg_dir = os.path.join(d["seg_dir"], split)
        self.gap_len = int(d.get("gap_len", 9))
        self.no_moving_objects = bool(d.get("no_moving_objects"))
        self.use_all_targets = bool(d.get("use_all_targets"))
        self.expand_test = bool(d.get("expand_test"))
        self.cities = d.get("cities")
        self.odom_pred_dir = d.get("odom_pred_dir")
        odom_name = d.get("odom_name", "odometry")
        if self.odom_pred_dir is not None:
            self.odom_pred_path = os.path.join(
                self.odom_pred_dir, f"{odom_name}_{split}.h5"
            )
        self.cam_dir = os.path.join(self.cityscapes_dir, "camera", split)
        self.timestamp_dir = os.path.join(
            self.cityscapes_dir, "timestamp_sequence", split
        )
        self.vehicle_dir = os.path.join(
            self.cityscapes_dir, "vehicle_sequence", split
        )
        # depth sources (pc_transform_dataset.py:46-53, 246-292); JAX reads
        # use_mono first and use_mono_disps only where use_mono is absent
        self.use_imgs = bool(d.get("use_imgs"))
        self.use_cascade_disps = bool(d.get("use_cascade_disps"))
        self.use_mono = bool(d.get("use_mono", d.get("use_mono_disps")))
        self.monodepth_factor = float(d.get("monodepth_factor", 5.405405405405405))
        if d.get("disparity_dir"):
            # cascade exports use a flat (split-less) layout
            self.disparity_dir = (d["disparity_dir"] if self.use_cascade_disps
                                  else os.path.join(d["disparity_dir"], split))
        else:
            self.disparity_dir = os.path.join(
                self.cityscapes_dir, "disparity_sequence", split
            )
        self.check_output_dir = d.get("check_output_dir")
        card.num_classes = 19

        self.data = io.read_table(
            os.path.join(d["data_dir"], f"{split}_3d_info.pkl")
        )
        if (split == "train" and self.use_all_targets) or self.expand_test:
            targets = list(range(6 + self.gap_len, 30))
        else:
            targets = [19]
        base_input_inds = np.array([0, 3, 6])

        self.items: List[Tuple[int, np.ndarray, int]] = []
        self.ego_transforms: Dict[Any, np.ndarray] = {}
        preds_h5 = (io.open_h5(self.odom_pred_path)
                    if self.odom_pred_dir is not None else None)
        try:
            for idx, rec in enumerate(self.data):
                city, seq, frame = rec["city"], rec["seq"], int(rec["frame"])
                if self.cities is not None and city not in self.cities:
                    continue
                for target in targets:
                    if not self._exported(city, seq, frame - 19 + target):
                        self.items.append(
                            (idx, base_input_inds + target - (6 + self.gap_len), target))
                times = self._read_times(city, seq, frame)
                speeds, yaws = self._read_gt_odom(city, seq, frame)
                if preds_h5 is None:
                    # per-frame transforms f -> f+1 for f = 0..28, from the
                    # odometry at the later frame (pc_transform_dataset.py:
                    # 107-123)
                    self.ego_transforms[(city, seq, frame)] = np.stack([
                        unicycle_now_T_prev_np(speeds[f + 1], yaws[f + 1],
                                               times[f + 1] - times[f])
                        for f in range(29)
                    ])
                    continue
                # one transform per start = the last input frame
                for target in targets:
                    input_inds = base_input_inds + target - (6 + self.gap_len)
                    start = int(input_inds[-1])
                    past_times = np.array(times[input_inds[0] : start + 1])
                    past_speeds = list(speeds[input_inds[0] + 1 : start + 1])
                    past_yaws = list(yaws[input_inds[0] + 1 : start + 1])
                    preds = np.asarray(preds_h5[f"{city}/{seq}/{frame}/{start}"][:])
                    all_speeds = past_speeds + list(preds[: self.gap_len, 0])
                    all_yaws = past_yaws + list(preds[: self.gap_len, 1])
                    dts = list(past_times[1:] - past_times[:-1])
                    dts += [float(np.mean(dts))] * (len(all_speeds) - len(dts))
                    egos = np.stack([
                        unicycle_now_T_prev_np(all_speeds[i], all_yaws[i], dts[i])
                        for i in range(len(all_speeds))
                    ])
                    cum = compose_cumulative(egos, len(egos))
                    self.ego_transforms[(city, seq, frame, start)] = cum[
                        base_input_inds
                    ]
        finally:
            if preds_h5 is not None:
                preds_h5.close()

    def _exported(self, city, seq, fr) -> bool:
        """Whether ``check_output_dir`` holds frame ``fr``'s labelIds PNG
        (pc_transform_dataset.py:95-100)."""
        return self.check_output_dir is not None and os.path.exists(os.path.join(
            self.check_output_dir, self.split, city,
            f"{city}_{seq}_{fr:06d}_gtFine_labelIds.png"))

    # -- readers -----------------------------------------------------------
    def _read_times(self, city, seq, frame) -> List[float]:
        out = []
        for fr in range(frame - 19, frame + 11):
            p = os.path.join(
                self.timestamp_dir, city, f"{city}_{seq}_{fr:06d}_timestamp.txt"
            )
            with open(p) as f:
                out.append(float(f.read()) / 1e9)
        return out

    def _read_gt_odom(self, city, seq, frame):
        speeds, yaws = [], []
        for fr in range(frame - 19, frame + 11):
            p = os.path.join(
                self.vehicle_dir, city, f"{city}_{seq}_{fr:06d}_vehicle.json"
            )
            o = read_json_file(p)
            speeds.append(float(o["speed"]))
            yaws.append(float(o["yawRate"]))
        return speeds, yaws

    def __len__(self) -> int:
        return len(self.items)

    def __getitem__(self, i: int) -> Dict[str, Any]:
        idx, input_inds, target = self.items[i]
        rec = self.data[idx]
        city, seq, frame = rec["city"], rec["seq"], int(rec["frame"])

        camera = read_json_file(
            os.path.join(self.cam_dir, city, f"{city}_{seq}_{frame:06d}_camera.json")
        )
        intr = intrinsics_from_cityscapes_camera(camera)
        K = intrinsics_matrix(intr).astype(np.float32)
        E = extrinsics_from_cityscapes_camera(camera).astype(np.float32)
        baseline = float(camera["extrinsic"]["baseline"])

        if self.odom_pred_dir is None:
            egos = self.ego_transforms[(city, seq, frame)]
            cum = compose_cumulative(egos, target)[input_inds]
        else:
            cum = self.ego_transforms[(city, seq, frame, int(input_inds[-1]))]

        frames = [frame - (19 - int(ind)) for ind in input_inds]
        # one batched decode of each kind of PNG, as JAX batches them
        labels = None
        if not self.use_imgs or self.no_moving_objects:
            labels = load_png_batch([
                os.path.join(self.seg_dir, city,
                             f"pred_mask_{city}_{seq}_{fr:06d}_leftImg8bit.png")
                for fr in frames
            ])
        if self.use_imgs:
            # RGB reprojection (pc_transform_dataset.py:237-242): the payload
            # is the video frame; the labels only mask moving objects
            segs = load_png_batch([
                os.path.join(self.cityscapes_dir, "leftImg8bit_sequence", self.split,
                             city, f"{city}_{seq}_{fr:06d}_leftImg8bit.png")
                for fr in frames
            ])
        else:
            segs = labels
        depths, masks = [], []
        if self.use_cascade_disps:
            for fr in frames:
                depth, mask = load_depth(
                    os.path.join(self.disparity_dir,
                                 f"{city}_{seq}_{fr:06d}_leftImg8bit.png"),
                    baseline, float(intr.fx), use_cascade=True)
                depths.append(depth)
                masks.append(mask)
        elif self.use_mono:
            for fr in frames:
                disp = np.load(os.path.join(
                    self.disparity_dir, city,
                    f"{city}_{seq}_{fr:06d}_leftImg8bit_disp.npy"))[0, 0]
                disp = _resize_bilinear(disp, 1024, 2048)
                depth = (self.monodepth_factor / np.maximum(disp, 1e-9)).astype(np.float32)
                depths.append(depth)
                masks.append(np.ones_like(depth, bool))
        else:
            disps = load_png_batch([
                os.path.join(self.disparity_dir, city,
                             f"{city}_{seq}_{fr:06d}_disparity.png")
                for fr in frames
            ])
            for disp_png in disps:
                disp, dvalid = decode_disparity_png(disp_png)
                depth, mask = disparity_to_depth(disp, dvalid, baseline,
                                                 float(intr.fx))
                depths.append(depth)
                masks.append(mask)
        if self.no_moving_objects:
            masks = [m & ~np.isin(lab, MOVING_LABEL_IDS) for m, lab in zip(masks, labels)]

        return {
            "inputs": {
                "seg": np.asarray(segs).astype(np.int32),
                "depth": np.stack(depths).astype(np.float32),
                "depth_mask": np.stack(masks),
                "intrinsics": K,
                "extrinsics": E,
                "target_T": cum.astype(np.float32),
            },
            "labels": {},
            "meta": {
                "city": city,
                "seq": seq,
                "frame": frame,
                "target_frame": frame - 19 + target,
            },
        }


def _resize_bilinear(arr: np.ndarray, dh: int, dw: int) -> np.ndarray:
    """The monodepth disparities' bilinear resize to (dh, dw) (JAX
    ``data/pc_data.py::_resize_bilinear``, pc_transform_dataset.py:269):
    half-pixel centres, edges clamped, in numpy."""
    sh, sw = arr.shape
    if (sh, sw) == (dh, dw):
        return arr
    ys = (np.arange(dh) + 0.5) * sh / dh - 0.5
    xs = (np.arange(dw) + 0.5) * sw / dw - 0.5
    y0 = np.clip(np.floor(ys).astype(np.int64), 0, sh - 1)
    x0 = np.clip(np.floor(xs).astype(np.int64), 0, sw - 1)
    y1 = np.minimum(y0 + 1, sh - 1)
    x1 = np.minimum(x0 + 1, sw - 1)
    wy = np.clip(ys - y0, 0.0, 1.0)[:, None]
    wx = np.clip(xs - x0, 0.0, 1.0)[None, :]
    a = arr[y0[:, None], x0[None, :]]
    b = arr[y0[:, None], x1[None, :]]
    c = arr[y1[:, None], x0[None, :]]
    d = arr[y1[:, None], x1[None, :]]
    return (
        a * (1 - wy) * (1 - wx) + b * (1 - wy) * wx
        + c * wy * (1 - wx) + d * wy * wx
    ).astype(arr.dtype)
