"""Synthetic micro-Cityscapes fixtures for tests and chip runs.

Counterpart of ``panoptic_forecasting_tpu/data/synthetic.py``: the same
generators (a toy street scene sequence, moving instance boxes with
low-rank ROI features), writing only what the port's readers open:

* ``write_cityscapes_fixture``: camera, timestamp and vehicle files of
  all 30 frames of each snippet; disparity and ``pred_mask`` seg PNGs of
  the three input frames of target 19 (``gap_len``), or of every frame
  a multi-target index opens (``all_targets``); as options, the
  ``leftImg8bit_sequence`` RGB frames of those frames (``images``),
  flat cascade disparity PNGs (``cascade``) and monodepth ``.npy``
  disparities below full resolution (``mono_size``); the annotated
  frame's ``gtFine`` labelIds, labelTrainIds and instanceIds PNGs;
  ``{split}_3d_info.pkl``;
* ``write_fg_fixture``: the scene tables, depth tables, ROI feature h5
  and ``{split}_3d_info.pkl`` of the fg-scene dataset;
* ``write_bg_fixture``: the bg-training tree (reprojected segs, the
  fg-removed GT, a depth h5), one or several gap groups;
* ``write_odom_predictions``: a predicted-odometry h5 (speed, yaw rate
  per future step) keyed ``city/seq/frame/start``;
* ``write_odom_fixture``: the odometry dataset's ``{split}_3d_info.pkl``
  tables (``make_odom_table``); ``write_odom_images``: the
  ``leftImg8bit_sequence`` frames of such a table (``data.load_imgs``);
* ``write_condensed_feats``: the fg condensed-feats files, copied from
  the plain ones (``data.use_condensed_feats``).

PNGs go through the port's codec. Tables are pickled pandas frames and
feature/odometry files HDF5; each writer also returns them in memory
(``{path: rows}`` and ``{path: {key: array}}``), and writes a format only
where its package (pandas, h5py) imports. On a machine without one of
them, ``readers_from_store`` serves that format's reader function
(``io.read_table``, ``io.open_h5``) from the returned store, and takes
the h5 writes (``io.write_h5``, ``io.append_h5``) into it, so the
datasets, the exports and everything after them run unchanged.
"""

from __future__ import annotations

import contextlib
import json
import os
from typing import Any, Dict, List, Optional, Tuple

import numpy as np

from .. import native
from . import io
from .cityscapes import train_id_to_id_lut
from .io import PNG_IDS, save_png

CITY = "synthcity"


def make_odom_table(n_snippets: int, seed: int) -> List[Dict]:
    """Rows of ``{split}_3d_info.pkl`` with the JAX fixture's content:
    city, seq, frame, odometry (30, 5) float32 — [speed, yaw_rate,
    *unused]."""
    rng = np.random.RandomState(seed)
    rows = []
    for i in range(n_snippets):
        t = np.linspace(0, 1, 30)
        speed = 8.0 + 4.0 * np.sin(2 * np.pi * (t + rng.rand())) + rng.randn() * 0.5
        yaw = 0.1 * np.sin(2 * np.pi * (t * 2 + rng.rand())) + rng.randn() * 0.01
        odom = np.zeros((30, 5), np.float32)
        odom[:, 0] = np.maximum(speed, 0.0)
        odom[:, 1] = yaw
        rows.append({"city": CITY, "seq": f"{i:06d}", "frame": 19, "odometry": odom})
    return rows


def write_odom_fixture(data_dir: str, n_snippets: int = 6) -> Dict[str, Any]:
    """The odometry dataset's train and val tables, split k from seed k.
    Returns the store that holds them."""
    store = new_store()
    for k, split in enumerate(("train", "val")):
        _store_table(store, os.path.join(data_dir, f"{split}_3d_info.pkl"),
                     make_odom_table(n_snippets, seed=k))
    return store


def make_camera_json(height: int = 128, width: int = 256) -> Dict:
    """A Cityscapes-style camera scaled to a small image."""
    s = width / 2048.0
    return {
        "intrinsic": {
            "fx": 2262.52 * s,
            "fy": 2265.30 * s,
            "u0": 1096.98 * s,
            "v0": 513.137 * s,
        },
        "extrinsic": {
            "baseline": 0.209313,
            "pitch": 0.038,
            "roll": 0.0,
            "yaw": -0.0195,
            "x": 1.7,
            "y": 0.1,
            "z": 1.22,
        },
    }


def make_scene_sequence(
    n_frames: int,
    height: int = 64,
    width: int = 128,
    seed: int = 0,
) -> Tuple[np.ndarray, np.ndarray]:
    """(T, H, W) int32 trainId maps + (T, H, W) float32 depth, a toy street:
    road at the bottom, buildings left/right, sky top, a moving car blob."""
    segs = np.zeros((n_frames, height, width), np.int32)
    depths = np.zeros((n_frames, height, width), np.float32)
    horizon = height // 2
    for t in range(n_frames):
        seg = np.full((height, width), 10, np.int32)  # sky
        dep = np.full((height, width), 200.0, np.float32)
        # road: lower half, depth grows toward horizon
        rows = np.arange(horizon, height)
        seg[horizon:, :] = 0
        dep[horizon:, :] = (1.5 * height / (rows - horizon + 2))[:, None]
        # buildings: left/right vertical bands above horizon
        bw = width // 6
        seg[:horizon, :bw] = 2
        dep[:horizon, :bw] = 12.0
        seg[:horizon, -bw:] = 2
        dep[:horizon, -bw:] = 15.0
        # a car (trainId 13) sliding right as frames advance
        cw, ch = width // 8, height // 8
        cx = width // 3 + t * 2
        cy = horizon + height // 8
        seg[cy : cy + ch, cx : cx + cw] = 13
        dep[cy : cy + ch, cx : cx + cw] = 9.0 - 0.2 * t
        segs[t] = seg
        depths[t] = dep
    return segs, depths


def _store_table(store: Dict[str, Any], path: str, rows: List[Dict]) -> None:
    store["tables"][path] = rows
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    try:
        import pandas as pd
    except ImportError:
        return
    pd.DataFrame(rows).to_pickle(path)


def _store_arrays(store: Dict[str, Any], path: str,
                  arrays: Dict[str, np.ndarray]) -> None:
    store["arrays"][path] = arrays
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    try:
        io.write_h5(path, arrays)
    except ImportError:  # no h5py here: the store holds the arrays
        pass


def new_store() -> Dict[str, Any]:
    """The in-memory record of what the writers write."""
    return {"tables": {}, "arrays": {}}


def _dump(path: str, text: str) -> None:
    os.makedirs(os.path.dirname(path), exist_ok=True)
    with open(path, "w") as f:
        f.write(text)


def rgb_frame(seg_ids: np.ndarray) -> np.ndarray:
    """The JAX fixture's ``leftImg8bit`` content of a labelId map."""
    sid = seg_ids.astype(np.int32)
    return np.stack([sid * 7 % 256, sid * 13 % 256, sid * 29 % 256],
                    axis=-1).astype(np.uint8)


def write_cityscapes_fixture(
    root: str,
    split: str = "val",
    n_snippets: int = 2,
    height: int = 64,
    width: int = 128,
    seed: int = 0,
    gap_len: int = 9,
    store: Dict[str, Any] = None,
    all_targets: bool = False,
    images: bool = False,
    cascade: bool = False,
    mono_size: Optional[Tuple[int, int]] = None,
    disparity_dir: Optional[str] = None,
) -> Dict[str, Any]:
    """A miniature Cityscapes tree + ``{split}_3d_info.pkl``, with the
    JAX package's fixture content; PNGs only of the frames
    ``PCTransformDataset`` opens at ``gap_len`` for target 19, or for
    every target with ``all_targets`` (frames 0 to 29 - gap_len), and the
    gt frame. Options for the pc data options, each file where the
    dataset looks for it with ``disparity_dir`` (or without it, in
    ``disparity_sequence/{split}``): ``images`` the RGB frames,
    ``cascade`` flat 16-bit cascade disparity PNGs (``disp·256``),
    ``mono_size`` (h, w) monodepth disparities ``(1, 1, h, w)`` float32
    (``5.4054 / depth``, JAX's default ``monodepth_factor``) under
    ``{split}/{city}``. Returns ``store`` (tables and arrays written)."""
    store = store if store is not None else new_store()
    rng = np.random.RandomState(seed)
    cam = make_camera_json(height, width)
    fx = cam["intrinsic"]["fx"]
    baseline = cam["extrinsic"]["baseline"]
    lut = train_id_to_id_lut()
    if all_targets:
        png_frames = set(range(30 - gap_len))
    else:
        png_frames = set((np.array([0, 3, 6]) + 19 - (6 + gap_len)).tolist())
    if disparity_dir is None:
        flat_dir = os.path.join(root, "disparity_sequence", split)
        mono_dir = flat_dir
    else:
        flat_dir, mono_dir = disparity_dir, os.path.join(disparity_dir, split)
    rows = []
    for snip in range(n_snippets):
        seq = f"{snip:06d}"
        frame = 19
        segs, depths = make_scene_sequence(30, height, width, seed=seed + snip)
        speed = 8.0 + rng.rand()
        yaw = 0.02 * rng.randn()
        odom = np.zeros((30, 5), np.float32)
        odom[:, 0] = speed
        odom[:, 1] = yaw
        rows.append({"city": CITY, "seq": seq, "frame": frame, "odometry": odom})
        for ind in range(30):
            name = f"{CITY}_{seq}_{frame - 19 + ind:06d}"

            def path(kind, suffix, prefix=""):
                return os.path.join(root, kind, split, CITY,
                                    f"{prefix}{name}_{suffix}")

            _dump(path("camera", "camera.json"), json.dumps(cam))
            _dump(path("timestamp_sequence", "timestamp.txt"),
                  str(int(ind * 0.0589 * 1e9)))
            _dump(path("vehicle_sequence", "vehicle.json"),
                  json.dumps({"speed": float(speed), "yawRate": float(yaw)}))
            if ind not in png_frames:
                continue
            # disparity: official encoding p = d*256 + 1 (0 = invalid)
            disp = baseline * fx / np.maximum(depths[ind], 0.5)
            code = (disp * 256 + 1).astype(np.uint16)
            code[depths[ind] <= 0] = 0
            save_png(path("disparity_sequence", "disparity.png"), code, **PNG_IDS)
            # predicted-seg input (labelId space)
            seg_id = lut[segs[ind]]
            save_png(path("seg", "leftImg8bit.png", "pred_mask_"), seg_id, **PNG_IDS)
            if images:
                save_png(path("leftImg8bit_sequence", "leftImg8bit.png"),
                         rgb_frame(seg_id), **PNG_IDS)
            if cascade:  # cascade stereo: disparity in pixels, times 256
                code = np.clip(np.round(disp * 256), 0, 65535).astype(np.uint16)
                code[depths[ind] <= 0] = 0
                save_png(os.path.join(flat_dir, f"{name}_leftImg8bit.png"), code,
                         **PNG_IDS)
            if mono_size is not None:
                mh, mw = mono_size
                sub = depths[ind][np.arange(mh) * height // mh][:, np.arange(mw) * width // mw]
                out = os.path.join(mono_dir, CITY, f"{name}_leftImg8bit_disp.npy")
                os.makedirs(os.path.dirname(out), exist_ok=True)
                np.save(out, (5.405405405405405 / np.maximum(sub, 0.5))[None, None]
                        .astype(np.float32))
        name = f"{CITY}_{seq}_{frame:06d}"
        gt = os.path.join(root, "gtFine", split, CITY, name)
        save_png(f"{gt}_gtFine_labelIds.png", lut[segs[19]], **PNG_IDS)
        save_png(f"{gt}_gtFine_labelTrainIds.png", segs[19].astype(np.uint8),
                 **PNG_IDS)
        # instanceIds: the stuff scene's labelIds (no thing instances), the
        # PQ evaluator's GT
        save_png(f"{gt}_gtFine_instanceIds.png",
                 lut[segs[19]].astype(np.uint16), **PNG_IDS)
    _store_table(store, os.path.join(root, f"{split}_3d_info.pkl"), rows)
    return store


def write_fg_fixture(
    root: str,
    splits=("train", "val"),
    n_scenes: int = 3,
    max_instances: int = 4,
    seed: int = 0,
    feat_channels: int = 256,
    feat_hw: int = 14,
    store: Dict[str, Any] = None,
) -> Dict[str, Any]:
    """FG artifacts (instance and seq meta, their depth info, feats h5, 3d
    info) with the JAX package's fixture content: moving boxes with smooth
    trajectories, low-rank random features. Returns ``store``."""
    store = store if store is not None else new_store()
    os.makedirs(root, exist_ok=True)
    rng = np.random.RandomState(seed)
    for split in splits:
        inst_rows, inst_depth_rows = [], []
        scene_rows, scene_depth_rows, d3_rows = [], [], []
        feats: Dict[str, np.ndarray] = {}
        for s in range(n_scenes):
            seq = f"{s:06d}"
            frame = 19
            n_inst = rng.randint(2, max_instances + 1)
            boxes_all, masks, finds, depths, classes = [], [], [], [], []
            all_feats = []
            feat_counter = 0
            for k in range(n_inst):
                cls = int(rng.choice([11, 13, 13, 14]))  # person/car/truck
                cx = rng.rand() * 1500 + 200
                cy = rng.rand() * 300 + 400
                vx = rng.randn() * 15
                vy = rng.randn() * 3
                w = rng.rand() * 150 + 60
                h = rng.rand() * 120 + 60
                boxes = np.zeros((30, 4), np.float32)
                mask = np.zeros(30, bool)
                fi = np.full(30, -1, np.int64)
                depth = np.full(30, -1.0, np.float32)
                d0 = rng.rand() * 30 + 8
                for t in range(30):
                    x = cx + vx * t
                    y = cy + vy * t
                    boxes[t] = [x - w / 2, y - h / 2, x + w / 2, y + h / 2]
                    visible = 0 < x < 2048 and rng.rand() > 0.1
                    mask[t] = visible
                    if visible:
                        depth[t] = max(d0 - 0.2 * t, 1.0)
                        fi[t] = feat_counter
                        feat_counter += 1
                # low-rank features per instance, drifting over time
                u = rng.randn(feat_hw, 1, 8) * 0.5
                v = rng.randn(1, feat_hw, 8) * 0.5
                base_feat = np.moveaxis(np.einsum("hxc,xwc->hwc", u, v), -1, 0)
                for t in range(30):
                    if mask[t]:
                        f = np.zeros((feat_channels, feat_hw, feat_hw), np.float32)
                        f[:8] = base_feat * (1 + 0.02 * t)
                        all_feats.append(f)
                inst_rows.append({
                    "city": CITY, "seq": seq, "frame": frame,
                    "track_id": 1000 + k, "class": cls, "bboxes": boxes,
                    "feat_mask": mask, "feat_ind": fi, "inst_ind": k,
                })
                inst_depth_rows.append({"depth": depth})
                boxes_all.append(boxes)
                masks.append(mask)
                finds.append(fi)
                depths.append(depth)
                classes.append(cls)
            feats[f"{CITY}/{seq}/{frame}"] = (
                np.stack(all_feats) if all_feats else
                np.zeros((1, feat_channels, feat_hw, feat_hw), np.float32))
            scene_rows.append({
                "city": CITY, "seq": seq, "frame": frame,
                "track_id": 1000 + np.arange(n_inst),
                "class": np.asarray(classes),
                "bboxes": np.stack(boxes_all),
                "feat_mask": np.stack(masks),
                "feat_ind": np.stack(finds),
            })
            scene_depth_rows.append({"depth": np.stack(depths)})
            odom = np.zeros((30, 5), np.float32)
            odom[:, 0] = 8.0 + rng.rand()
            odom[:, 1] = 0.01 * rng.randn()
            odom[:, 2] = odom[:, 0] * 0.059
            d3_rows.append({"city": CITY, "seq": seq, "frame": frame,
                            "odometry": odom, "times": np.arange(30) * 0.0589})
        _store_arrays(store, os.path.join(root, f"{split}_feats.h5"), feats)
        _store_table(store, os.path.join(root, f"{split}_instance_meta.pkl"),
                     inst_rows)
        _store_table(store, os.path.join(root, f"{split}_depth_instance_info.pkl"),
                     inst_depth_rows)
        _store_table(store, os.path.join(root, f"{split}_seq_meta.pkl"), scene_rows)
        _store_table(store, os.path.join(root, f"{split}_depth_seq_info.pkl"),
                     scene_depth_rows)
        _store_table(store, os.path.join(root, f"{split}_3d_info.pkl"), d3_rows)
    return store


def write_bg_fixture(
    root: str,
    splits=("train", "val"),
    n_snippets: int = 2,
    height: int = 64,
    width: int = 128,
    seed: int = 0,
    gap_lens: Tuple[int, ...] = (9,),
    store: Dict[str, Any] = None,
) -> Tuple[Dict[str, Any], Dict[str, Any]]:
    """A bg-training tree with the JAX package's fixture content: per
    ``(data_dirs, gap_len)`` group three reprojected-seg dirs (trainId
    content under the reference's labelIds names, things set to 255),
    the fg-removed GT labelTrainIds (things 255) and a depth h5 per split
    keyed ``city/seq/frame:06d/start_fr`` (raw uint16 ``(d + 1)·256``
    blocks of the group's three input frames, ``19 - gap - 6 + (0, 3,
    6)``; ``start_fr = int((9 - gap) / 3)``). Gap 9 writes JAX's dirs
    ``pc_ind{0,1,2}``; any other gap ``pc_gap{g}_ind{0,1,2}``.
    ``configs/bg/bg_train.yaml`` joins gaps (9, 3).

    Returns (the config ``data`` fragment pointing at the tree, ``store``
    with the depth arrays).
    """
    store = store if store is not None else new_store()
    os.makedirs(root, exist_ok=True)
    groups = []
    for gap in gap_lens:
        tag = "" if gap == 9 else f"_gap{gap}"
        dirs = [os.path.join(root, f"pc{tag}_ind{i}") for i in range(3)]
        frames = (np.array([0, 3, 6]) + 19 - gap - 6).tolist()
        groups.append((dirs, frames, int((9 - gap) / 3)))
    gt_dir = os.path.join(root, "gtFine_nofg")
    for split in splits:
        arrays = {}
        for snip in range(n_snippets):
            seq = f"{snip:06d}"
            frame = 19
            segs, depths = make_scene_sequence(
                30, height, width, seed=seed + snip + splits.index(split) * 100)
            name = f"{CITY}_{seq}_{frame:06d}"
            gt = segs[19].copy()
            gt[gt >= 11] = 255  # things removed (remove_fg_from_gt.py:15-33)
            save_png(os.path.join(gt_dir, split, CITY,
                                  f"{name}_gtFine_labelTrainIds.png"),
                     gt.astype(np.uint8), **PNG_IDS)
            for dirs, frames, start_fr in groups:
                block = np.zeros((height, width, 3), np.uint16)
                for i, fr in enumerate(frames):
                    arr = segs[fr].copy()
                    arr[arr >= 11] = 255  # reprojections are fg-free
                    save_png(os.path.join(dirs[i], split, CITY,
                                          f"{name}_gtFine_labelIds.png"),
                             arr.astype(np.uint8), **PNG_IDS)
                    block[:, :, i] = (np.clip(depths[fr] + 1.0, 0, 255)
                                      * 256).astype(np.uint16)
                arrays[f"{CITY}/{seq}/{frame:06d}/{start_fr}"] = block
        _store_arrays(store, os.path.join(root, f"depths_{split}.h5"), arrays)
    data = {
        "data_dir": [d for dirs, _, _ in groups for d in dirs],
        "gap_len": list(gap_lens),
        "gt_dir": gt_dir,
        "depth_h5_path": os.path.join(root, "depths_%s.h5"),
        "cityscapes_dir": root,
    }
    return data, store


def write_odom_predictions(path: str, rows: List[Dict], starts=(10, 16),
                           horizon: int = 9, seed: int = 0,
                           store: Dict[str, Any] = None) -> Dict[str, Any]:
    """A predicted-odometry h5: for each snippet row (city, seq, frame,
    odometry (30, 5)) and each start index, (horizon, 2) float32 (speed,
    yaw rate) — the row's odometry after ``start`` plus noise. Returns
    ``store``."""
    store = store if store is not None else new_store()
    rng = np.random.RandomState(seed)
    arrays = {}
    for r in rows:
        odom = np.asarray(r["odometry"], np.float32)
        for start in starts:
            steps = odom[start + 1 : start + 1 + horizon, :2]
            steps = np.concatenate(
                [steps, np.repeat(odom[-1:, :2], horizon - len(steps), 0)])
            noise = rng.randn(horizon, 2) * np.array([0.2, 0.002])
            arrays[f"{r['city']}/{r['seq']}/{int(r['frame'])}/{start}"] = (
                steps + noise).astype(np.float32)
    _store_arrays(store, path, arrays)
    return store


def write_odom_images(root: str, rows: List[Dict], split: str, height: int,
                      width: int, seed: int = 0) -> None:
    """The ``leftImg8bit_sequence`` frames of every row (city, seq, frame)
    of an odometry table, frames ``frame - 19`` to ``frame + 10``: the
    JAX fixture's RGB content of a toy street (``make_scene_sequence``
    from ``seed``), one PNG encoded once and written at every path."""
    seg = make_scene_sequence(1, height, width, seed=seed)[0][0]
    data = native.encode_png(rgb_frame(train_id_to_id_lut()[seg]), **PNG_IDS)
    for r in rows:
        city, seq, frame = r["city"], r["seq"], int(r["frame"])
        out = os.path.join(root, "leftImg8bit_sequence", split, city)
        os.makedirs(out, exist_ok=True)
        for fr in range(frame - 19, frame + 11):
            with open(os.path.join(out, f"{city}_{seq}_{fr:06d}_leftImg8bit.png"),
                      "wb") as f:
                f.write(data)


def write_condensed_feats(root: str, store: Dict[str, Any],
                          splits=("train", "val")) -> None:
    """The condensed-feats files of a ``write_fg_fixture`` tree, as the
    JAX package's own test makes them: ``{split}_condensed_feats.h5`` a
    copy of the plain feature h5, and the ``feat_ind`` columns of the
    instance and scene meta tables as
    ``{split}_{instance,seq}_condensed_feat_info.pkl``."""
    for split in splits:
        _store_arrays(store, os.path.join(root, f"{split}_condensed_feats.h5"),
                      store["arrays"][os.path.join(root, f"{split}_feats.h5")])
        for kind in ("instance", "seq"):
            meta = store["tables"][os.path.join(root, f"{split}_{kind}_meta.pkl")]
            _store_table(store, os.path.join(
                root, f"{split}_{kind}_condensed_feat_info.pkl"),
                [{"feat_ind": r["feat_ind"]} for r in meta])


class ArrayFile(dict):
    """An h5 file's datasets held in memory: ``{key: array}`` with the
    reads ``io.LazyH5`` offers."""

    def mmap_dataset(self, key):
        return self[key]

    def close(self) -> None:
        pass


@contextlib.contextmanager
def readers_from_store(store: Dict[str, Any], tables: bool = True,
                       arrays: bool = True):
    """Within the block, ``io.read_table`` (``tables``) and ``io.open_h5``
    (``arrays``) answer the paths ``store`` holds from memory; other paths
    still go to the files. With ``arrays``, ``io.write_h5`` and
    ``io.append_h5`` write into ``store`` and not to a file."""
    saved = io.read_table, io.open_h5, io.write_h5, io.append_h5

    def read_table(path):
        rows = store["tables"].get(path)
        return saved[0](path) if rows is None else rows

    def open_h5(path):
        data = store["arrays"].get(path)
        return saved[1](path) if data is None else ArrayFile(data)

    def write_h5(path, data):
        store["arrays"][path] = dict(data)

    def append_h5(path, data, compression=None):
        store["arrays"].setdefault(path, {}).update(data)

    if tables:
        io.read_table = read_table
    if arrays:
        io.open_h5, io.write_h5, io.append_h5 = open_h5, write_h5, append_h5
    try:
        yield store
    finally:
        io.read_table, io.open_h5, io.write_h5, io.append_h5 = saved
