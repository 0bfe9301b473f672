"""Score an instance-mask export with Cityscapes instance AP (in-tree).

Counterpart of ``panoptic_forecasting_tpu/cli/evaluate_instances.py``:
scores the layout ``cli/export_instances.py`` writes (``{name}.txt``
manifests beside the mask PNGs) against ``*_gtFine_instanceIds.png``
maps with ``eval/instance_ap.py``. Host numpy.

Usage:
    python -m panoptic_forecasting_tpu_torch.cli.evaluate_instances \\
        --pred_dir EXPORT_DIR \\
        (--gt_dir INSTANCE_ID_DIR | --cityscapes_dir DIR --split val) \\
        [--results_json OUT.json]
"""

from __future__ import annotations

import argparse
import json
import os
import sys

from ..eval import instance_ap


def main(argv=None) -> dict:
    p = argparse.ArgumentParser()
    p.add_argument("--pred_dir", required=True,
                   help="export dir of {name}.txt manifests + mask PNGs")
    p.add_argument("--gt_dir",
                   help="dir searched recursively for *_gtFine_instanceIds.png")
    p.add_argument("--cityscapes_dir")
    p.add_argument("--split", default="val")
    p.add_argument("--results_json")
    args = p.parse_args(argv)

    gt_dir = args.gt_dir
    if gt_dir is None:
        if not args.cityscapes_dir:
            p.error("need --gt_dir or --cityscapes_dir")
        gt_dir = os.path.join(args.cityscapes_dir, "gtFine", args.split)

    results = instance_ap.ap_compute_folders(args.pred_dir, gt_dir)
    print(instance_ap.format_results(results))
    if args.results_json:
        # NaN (a class with no gt instance) is not JSON: written as null
        def denan(x):
            if isinstance(x, dict):
                return {k: denan(v) for k, v in x.items()}
            if isinstance(x, float) and x != x:
                return None
            return x

        with open(args.results_json, "w") as f:
            json.dump(denan(results), f, indent=2)
    return results


if __name__ == "__main__":
    main(sys.argv[1:])
