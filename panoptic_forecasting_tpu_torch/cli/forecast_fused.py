"""Serve panoptic forecasts through the single-call forecast step.

Counterpart of ``panoptic_forecasting_tpu/cli/forecast_fused.py``. Per
target frame one call of ``eval/forecast.py::build_forecast_step`` runs
pc reprojection (K1 ``place_min_fold`` on the GPU) -> bg refinement (K2
``onehot_stem_conv``) -> fg rollout -> fusion, and the CLI writes the
COCO-panoptic PNG/json protocol of the staged export
(``fused_panoptics_{split}/fused_panoptics_{split}/*_pred_panoptic.png``
+ ``fused_panoptics_{split}.json``), gt frames it did not forecast
backfilled.

Usage (config keys under ``fused.``):
    python -m panoptic_forecasting_tpu_torch.cli.forecast_fused \\
        --working_dir FG_RUN --config_file fg_scene.yaml \\
        --set fused.bg_config bg.yaml --set fused.bg_dir BG_RUN \\
        --set fused.pc_config pc.yaml [--set export_name NAME] \\
        [--set platform cpu]

The main config is the fg-scene eval config; ``fused.bg_config`` /
``fused.bg_dir`` locate the trained background model, ``fused.pc_config``
(with ``fused.pc_dir``, default ``bg_dir``) the point-cloud inputs
(Cityscapes seg/disparity/camera sequences + odometry). ``fused.height``
/ ``fused.width`` (default 1024 x 2048) give the frame size. Models are
restored from the port's checkpoints (``core/checkpoint.py``). It runs
on ``cuda`` and raises without it, unless ``platform`` is ``cpu``.

Two host-side overlaps around the device step: the next frame's pc
input fetch (six PNG decodes and the disparity -> depth step) on
``pipelined_map``'s worker, and the previous frames' panoptic PNG encode
and write on the ``AsyncWriter`` pool.
"""

from __future__ import annotations

import json
import os
import sys
import time
from typing import Any, Dict

import numpy as np

from ..core import build_dataset, build_model
from ..core.config import Config, load_config
from ..data.cityscapes import id_to_train_id_lut
from ..eval.forecast import build_forecast_step
from ..eval.panoptic_protocol import (
    relabel_panoptic_trainid_to_labelid,
    segments_info_from_labelid_seg,
    write_panoptic_png,
)
from .common import config_device, export_writer, pipelined_map, restore_params, setup
from .export_panoptic import backfill_missing

FG_KEYS = ("trajectories", "bbox_masks", "bbox_vel_masks", "depths",
           "depth_masks", "feats", "odometry", "classes", "valid")


def _load_sub_cfg(path: str, working_dir: str) -> dict:
    import yaml

    with open(path) as f:
        cfg = yaml.safe_load(f)
    cfg["working_dir"] = working_dir
    return cfg


def _build_bg(fused_cfg, device):
    """The trained bg model of ``fused.bg_config``/``fused.bg_dir``,
    folded for serving (unless its config sets ``fold_bn: false``)."""
    cfg = _load_sub_cfg(fused_cfg["bg_config"], fused_cfg["bg_dir"])
    data = build_dataset(cfg, test=True)
    model = build_model(cfg, data.card, device)
    return restore_params(cfg, model).maybe_fold()


def _pc_index(fused_cfg, split):
    """(dataset, {frame_name: item_index}) for lazy per-frame fetch."""
    cfg = _load_sub_cfg(
        fused_cfg["pc_config"],
        fused_cfg.get("pc_dir") or fused_cfg["bg_dir"],
    )
    cfg.setdefault("data", {})["data_splits"] = [split]
    ds = build_dataset(cfg, test=True).datasets[split]
    index = {}
    for i, (idx, _inds, target) in enumerate(ds.items):
        rec = ds.data[idx]
        name = (f"{rec['city']}_{rec['seq']}_"
                f"{int(rec['frame']) - 19 + target:06d}")
        index[name] = i
    return ds, index


def _pc_inputs(ds, i, lut):
    """One pc sample -> the step's pc_in (B = 1), seg converted to trainIds
    (the staged chain reprojects labelIds and converts after,
    cli/prepare_bg_data; reprojecting trainIds directly is equivalent)."""
    s = ds[i]
    inp = s["inputs"]
    return {
        "seg": lut[np.clip(np.asarray(inp["seg"])[None], 0, 255)].astype(
            np.int32
        ),
        "depth": np.asarray(inp["depth"], np.float32)[None],
        "depth_mask": np.asarray(inp["depth_mask"])[None],
        "intrinsics": np.asarray(inp["intrinsics"], np.float32)[None],
        "extrinsics": np.asarray(inp["extrinsics"], np.float32)[None],
        "target_T": np.asarray(inp["target_T"], np.float32)[None],
    }


def _fg_inputs(batch, i) -> Dict[str, np.ndarray]:
    """Scene ``i`` of an fg-scene batch -> the step's fg_in (B = 1)."""
    fg_in = {k: np.asarray(batch["inputs"][k])[i : i + 1] for k in FG_KEYS}
    fg_in["output_inds"] = np.asarray(batch["labels"]["output_inds"])[i : i + 1]
    return fg_in


def _timed(times, fn):
    """``fn`` wrapped to append its host-clock ms to ``times``."""
    def run(*args, **kwargs):
        t0 = time.perf_counter()
        try:
            return fn(*args, **kwargs)
        finally:
            times.append((time.perf_counter() - t0) * 1e3)

    return run


def export_split(fg_model, bg_model, task_data, split, cfg) -> Dict[str, Any]:
    """Forecast and write every frame of ``split``. Returns the result dir,
    the frame counts, ``seconds`` from the first batch to the last PNG
    written, and the host-clock ms of each stage per frame (``ms``):
    ``pc_fetch`` (PNG decodes + disparity -> depth, on the worker
    thread), ``fg_batch`` (the wait for each fg-scene batch), ``step``
    (the forecast step until its panoptic map is on the host),
    ``annotate`` (relabel to labelIds and ``segments_info``, on this
    thread) and ``png_write`` (PNG encode + write, on the writer pool)."""
    fused_cfg = cfg.get("fused", {})
    wd = cfg["working_dir"]
    export_name = f"{cfg.get('export_name') or 'fused_panoptics'}_{split}"
    result_dir = os.path.join(wd, export_name)
    seg_dir = os.path.join(result_dir, export_name)
    os.makedirs(seg_dir, exist_ok=True)

    pc_ds, pc_idx = _pc_index(fused_cfg, split)
    lut = id_to_train_id_lut()
    height = int(fused_cfg.get("height", 1024))
    width = int(fused_cfg.get("width", 2048))
    device = next(fg_model.parameters()).device

    times = {"pc_fetch": [], "fg_batch": [], "step": [], "annotate": [],
             "png_write": []}
    fetch = _timed(times["pc_fetch"], lambda t: _pc_inputs(pc_ds, pc_idx[t[2]], lut))
    write = _timed(times["png_write"], write_panoptic_png)
    step = None
    annotations = []
    exported = set()
    n_done = n_skipped = 0
    loader = task_data.loader(split, cfg, test=True)

    def frame_stream():
        """(batch, i, name) per forecastable frame; builds the step on
        first use. Advanced on the caller's thread by pipelined_map."""
        nonlocal step, n_skipped
        batches = iter(loader)
        while True:
            t0 = time.perf_counter()
            batch = next(batches, None)
            times["fg_batch"].append((time.perf_counter() - t0) * 1e3)
            if batch is None:
                return
            meta = batch["meta"]
            if step is None:
                out_t = int(np.asarray(batch["labels"]["trajectories"]).shape[2])
                step = build_forecast_step(
                    bg_model, fg_model, height=height, width=width,
                    out_t=out_t, device=device,
                )
            for i in range(len(meta["city"])):
                name = (f"{meta['city'][i]}_{meta['seq'][i]}_"
                        f"{int(meta['target_frame'][i]):06d}")
                if name not in pc_idx:
                    n_skipped += 1
                    continue
                yield batch, i, name

    t_start = time.perf_counter()
    with export_writer(cfg) as w:
        for pc_in, (batch, i, name) in pipelined_map(fetch, frame_stream(),
                                                     depth=2):
            t0 = time.perf_counter()
            fused = step(pc_in, _fg_inputs(batch, i))
            pan = fused["panoptic"][0].cpu().numpy()
            t1 = time.perf_counter()
            seg = relabel_panoptic_trainid_to_labelid(pan.astype(np.int64))
            file_name = f"{name}_pred_panoptic.png"
            w.submit(write, os.path.join(seg_dir, file_name), seg)
            annotations.append({
                "image_id": name,
                "file_name": file_name,
                "segments_info": segments_info_from_labelid_seg(seg),
            })
            times["step"].append((t1 - t0) * 1e3)
            times["annotate"].append((time.perf_counter() - t1) * 1e3)
            exported.add(name)
            n_done += 1
    seconds = time.perf_counter() - t_start
    times["fg_batch"].pop()  # the wait that found the loader empty

    # Frames without pc inputs (or filtered from the fg loader) get the
    # staged exporter's backfill: the PQ scorer fails on a missing frame.
    backfill_missing(cfg, split, seg_dir, exported, annotations)

    with open(os.path.join(result_dir, f"{export_name}.json"), "w",
              encoding="utf-8") as f:
        json.dump({"annotations": annotations}, f, ensure_ascii=False,
                  indent=4)
    print(f"[{split}] fused-forecast {n_done} frames "
          f"({n_skipped} without pc inputs) -> {seg_dir}")
    return {"result_dir": result_dir, "frames": n_done, "skipped": n_skipped,
            "seconds": seconds, "ms": times}


def run(cfg) -> Dict[str, Dict[str, Any]]:
    """Restore both models and export every split of ``cfg``; returns
    ``export_split``'s report per split."""
    cfg = Config(cfg)
    fused_cfg = cfg.get("fused", {})
    for key in ("bg_config", "bg_dir", "pc_config"):
        if not fused_cfg.get(key):
            raise SystemExit(
                f"missing --set fused.{key} (see module docstring)"
            )
    cfg, task_data, fg_model = setup(cfg, test=True)
    fg_model = restore_params(cfg, fg_model)
    bg_model = _build_bg(fused_cfg, config_device(cfg))
    return {
        split: export_split(fg_model, bg_model, task_data, split, cfg)
        for split in task_data.datasets
    }


def main(argv=None) -> None:
    run(load_config(argv))


if __name__ == "__main__":
    main(sys.argv[1:])
