"""Export per-instance forecast masks in Cityscapes AP format.

Counterpart of ``panoptic_forecasting_tpu/cli/export_instances.py``
(reference experiments/export_cityscapes_instance_results.py): per
instance of ``eval/fusion.py::predict_instances`` a binary mask PNG
``{city}_{seq}_{frame:06d}_{labelId}_{k}.png`` (mask·255), per frame a
``.txt`` manifest of ``name labelId score`` lines, and an empty manifest
for every gt frame with no instance, in
``working_dir/{export_name|exported_instances}_{split}/``.

Usage:
    python -m panoptic_forecasting_tpu_torch.cli.export_instances \\
        --working_dir DIR --config_file cfg.yaml [--set export_name NAME] \\
        [--set platform cpu]

It runs on ``cuda`` and raises without it, unless ``platform`` is ``cpu``.
"""

from __future__ import annotations

import glob
import os
import sys
from collections import defaultdict

import numpy as np

from ..core.config import load_config
from ..data.cityscapes import TRAIN_ID_TO_ID
from ..data.io import PNG_IDS, save_png
from ..eval import fusion
from .common import export_writer, restore_params, setup


def export_split(model, task_data, split, cfg) -> str:
    export_name = cfg.get("export_name") or "exported_instances"
    base = os.path.join(cfg["working_dir"], f"{export_name}_{split}")
    os.makedirs(base, exist_ok=True)

    entries = defaultdict(lambda: defaultdict(list))  # name -> cl -> scores
    # mask PNG writes overlap the next batch's device work
    with export_writer(cfg) as w:
        for batch in task_data.loader(split, cfg, test=True):
            preds = fusion.predict_instances(model, batch)
            meta = batch["meta"]
            for i, insts in enumerate(preds["instances"]):
                name = (f"{meta['city'][i]}_{meta['seq'][i]}_"
                        f"{int(meta['target_frame'][i]):06d}")
                for inst in insts:
                    cl = TRAIN_ID_TO_ID[inst["class_train_id"]]
                    k = len(entries[name][cl])
                    entries[name][cl].append(float(inst["score"]))
                    w.submit(save_png, os.path.join(base, f"{name}_{cl}_{k}.png"),
                             inst["mask"].astype(np.uint8) * 255, **PNG_IDS)

    for name, by_class in entries.items():
        with open(os.path.join(base, f"{name}.txt"), "w") as f:
            for cl, scores in by_class.items():
                for k, score in enumerate(scores):
                    f.write(f"{name}_{cl}_{k}.png {cl} {score:f}\n")

    cityscapes_dir = cfg.get("data", {}).get("cityscapes_dir")
    if cityscapes_dir:
        gt_dir = os.path.join(cityscapes_dir, "gtFine", split)
        missing = 0
        for path in glob.glob(os.path.join(gt_dir, "*", "*_gtFine_labelIds.png")):
            name = "_".join(os.path.basename(path).split("_")[:3])
            if name not in entries:
                missing += 1
                open(os.path.join(base, f"{name}.txt"), "w").close()
        print("NUM MISSING:", missing)
    print(f"[{split}] exported instance masks for {len(entries)} frames")
    return base


def main(argv=None) -> None:
    cfg, task_data, model = setup(load_config(argv), test=True)
    model = restore_params(cfg, model)
    for split in task_data.datasets:
        export_split(model, task_data, split, cfg)


if __name__ == "__main__":
    main(sys.argv[1:])
