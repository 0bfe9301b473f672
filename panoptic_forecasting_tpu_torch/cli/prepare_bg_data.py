"""Build the bg model's data from point-cloud reprojections.

Counterpart of ``panoptic_forecasting_tpu/cli/prepare_bg_data.py``: runs
the point-cloud transform once per input frame index (the reference's
``only_this_ind`` exports, pc_transform_model.py:21,33-37) and writes

    {out_dir}/point_cloud_static_ind{i}_all/exported_predictions/{split}/
        {city}/{city}_{seq}_{frame:06d}_gtFine_labelIds.png   (trainId content)
    {out_dir}/depths_decompressed_{split}.h5                  (H, W, 3) uint16
        keyed city/seq/frame:06d/start_fr, encoded (depth+1)*256, 0 invalid

which ``data/bg_data.py`` reads. ``bg_out_format: npy`` writes the seg
maps as ``.npy``; ``bg_depth_compression`` (e.g. ``gzip``) compresses the
h5 datasets.

The JAX CLI passes over the loader three times, once per index. The pc
dataset reads nothing of the model's ``only_this_ind``, so here one pass
feeds each batch to the three index models (``PCTransformModel``, K1
``place_min_fold`` on the GPU, once per batch and index) and each
frame's depth block is written whole through ``io.append_h5``, one batch
at a time: the pc fetch is paid once, and a split's blocks never sit in
memory together. The files are the JAX CLI's, byte for byte (the h5
datasets equal).

Usage:
    python -m panoptic_forecasting_tpu_torch.cli.prepare_bg_data \\
        --working_dir DIR --config_file configs/pc_transform/pc_export.yaml \\
        --set bg_out DIR [--set data.gap_len 3] [--set bg_out_format npy] \\
        [--set platform cpu]

It runs on ``cuda`` and raises without it, unless ``platform`` is ``cpu``.
"""

from __future__ import annotations

import os
import sys
import time
from typing import Any, Dict

import numpy as np

from ..core import build_model
from ..core.config import load_config
from ..data import io
from ..data.cityscapes import id_to_train_id_lut
from ..data.io import PNG_IDS, save_png
from .common import config_device, setup


def staged_maps(seg, depth):
    """The staged bg inputs of reprojected labelIds and depths (any
    shape): trainIds as uint8, and the depth code ``(depth + 1)·256`` as
    uint16, 0 where no point landed (depth <= 0)."""
    seg_train = id_to_train_id_lut()[np.clip(seg, 0, 255)].astype(np.uint8)
    code = np.where(depth > 0, np.clip((depth + 1.0) * 256.0, 0, 65535), 0)
    return seg_train, code.astype(np.uint16)


def prepare_split(task_data, split, cfg, out_dir: str) -> Dict[str, Any]:
    """Write ``split``'s three seg trees and its depth h5. Returns the
    frames written, ``seconds`` for the split and, per index, the host ms
    of its predicts (to the maps on the host) summed over the split."""
    gap = int(cfg.get("data", {}).get("gap_len", 9))
    start_fr = int((9 - gap) / 3)
    fmt = cfg.get("bg_out_format", "png")
    comp = cfg.get("bg_depth_compression", "none")
    comp = None if comp in ("none", None, False) else comp
    h5_path = os.path.join(out_dir, f"depths_decompressed_{split}.h5")
    device = config_device(cfg)
    models = [build_model(dict(cfg, model=dict(cfg.get("model", {}), only_this_ind=i)),
                          task_data.card, device) for i in range(3)]
    seg_roots = [os.path.join(out_dir, f"point_cloud_static_ind{i}_all",
                              "exported_predictions", split) for i in range(3)]
    predict_ms = [0.0, 0.0, 0.0]
    n = 0
    t0 = time.perf_counter()
    for batch in task_data.loader(split, cfg, test=True):
        meta = batch["meta"]
        blocks = {}
        for ind, model in enumerate(models):
            ts = time.perf_counter()
            preds = model.predict(batch)
            segs = preds["seg"].cpu().numpy()
            deps = preds["depth"].cpu().numpy()
            predict_ms[ind] += (time.perf_counter() - ts) * 1e3
            for i in range(len(segs)):
                city, seq = meta["city"][i], meta["seq"][i]
                frame = int(meta["frame"][i])
                tgt = int(meta["target_frame"][i])
                seg_train, code = staged_maps(segs[i], deps[i])
                base = os.path.join(seg_roots[ind], city,
                                    f"{city}_{seq}_{tgt:06d}_gtFine_labelIds")
                if fmt == "npy":
                    os.makedirs(os.path.dirname(base), exist_ok=True)
                    np.save(base + ".npy", seg_train)
                else:
                    save_png(base + ".png", seg_train, **PNG_IDS)
                key = f"{city}/{seq}/{frame:06d}/{start_fr}"
                if key not in blocks:
                    blocks[key] = np.zeros(deps[i].shape + (3,), np.uint16)
                blocks[key][:, :, ind] = code
        io.append_h5(h5_path, blocks, compression=comp)
        n += len(meta["city"])
    for ind, root in enumerate(seg_roots):
        print(f"[{split}] ind{ind}: {n} frames -> {root}")
    print(f"depth h5 -> {h5_path}")
    return {"frames": n, "seconds": time.perf_counter() - t0,
            "predict_ms": predict_ms}


def main(argv=None) -> Dict[str, Dict[str, Any]]:
    """Prepare every split of the config; returns ``prepare_split``'s
    report per split."""
    cfg, task_data, _ = setup(load_config(argv), test=True)
    out_dir = cfg.get("bg_out") or os.path.join(cfg["working_dir"], "bg_data")
    return {split: prepare_split(task_data, split, cfg, out_dir)
            for split in task_data.datasets}


if __name__ == "__main__":
    main(sys.argv[1:])
