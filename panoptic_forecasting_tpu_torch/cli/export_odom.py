"""Export forecast odometry to HDF5.

Counterpart of ``panoptic_forecasting_tpu/cli/export_odom.py``
(reference experiments/export_cityscapes_odom.py:30-54): one dataset per
key ``city/seq/frame/start_frame`` holding the (output_len, 2) forecast
(the first window of a key wins), file ``{export_name|odometry}_{split}.h5``
in the working dir, written through ``data/io.py::write_h5``. The pc and
fg readers take it as their predicted odometry (``odom_pred_dir``).

Usage:
    python -m panoptic_forecasting_tpu_torch.cli.export_odom \\
        --working_dir RUN --config_file configs/odom/odom_val.yaml \\
        [--set export_name NAME] [--set platform cpu]

The model is restored from the port's checkpoints (``RUN/best_model``,
``core/checkpoint.py``) or ``--load_torch_model``. It runs on ``cuda``
and raises without it, unless ``platform`` is ``cpu``.
"""

from __future__ import annotations

import os
import sys

from ..core.config import load_config
from ..data import io
from .common import restore_params, setup


def export_split(model, task_data, split, cfg) -> str:
    """Forecast every window of ``split`` and write the h5; returns its
    path."""
    export_name = cfg.get("export_name") or "odometry"
    out_file = os.path.join(cfg["working_dir"], f"{export_name}_{split}.h5")
    arrays = {}
    for batch in task_data.loader(split, cfg, test=True):
        odom = model.predict(batch)["odometry"].cpu().numpy()
        meta = batch["meta"]
        for i in range(len(odom)):
            key = (f"{meta['city'][i]}/{meta['seq'][i]}/"
                   f"{int(meta['frame'][i])}/{int(meta['start_frame'][i])}")
            arrays.setdefault(key, odom[i])
    io.write_h5(out_file, arrays)
    return out_file


def main(argv=None) -> None:
    cfg, task_data, model = setup(load_config(argv), test=True)
    model = restore_params(cfg, model)
    for split in task_data.datasets:
        out = export_split(model, task_data, split, cfg)
        print(f"exported {split} -> {out}")


if __name__ == "__main__":
    main(sys.argv[1:])
