"""Score a panoptic export against Cityscapes GT (in-tree PQ).

Counterpart of ``panoptic_forecasting_tpu/cli/evaluate_panoptic.py``
(reference: the external
``cityscapesscripts.evaluation.evalPanopticSemanticLabeling`` call of
scripts/fg/run_fg_eval_panoptic.sh:28-33), with the same flags. Host
numpy only (``eval/pq.py``); GT panoptic files are produced from
``gtFine`` when ``--gt_json`` is not given.

Usage:
    python -m panoptic_forecasting_tpu_torch.cli.evaluate_panoptic \\
        --pred_json PRED.json --pred_dir PRED_DIR \\
        (--gt_json GT.json --gt_dir GT_DIR |
         --cityscapes_dir DIR --split val [--gt_out DIR]) \\
        [--results_json OUT.json]
"""

from __future__ import annotations

import argparse
import json
import os
import sys

from ..eval import pq
from ..eval.panoptic_protocol import convert_gt_split


def main(argv=None) -> dict:
    """Score and print; returns the results dict of ``pq.summarize``."""
    p = argparse.ArgumentParser()
    p.add_argument("--pred_json", required=True)
    p.add_argument("--pred_dir", required=True)
    p.add_argument("--gt_json")
    p.add_argument("--gt_dir")
    p.add_argument("--cityscapes_dir")
    p.add_argument("--split", default="val")
    p.add_argument("--gt_out")
    p.add_argument("--results_json")
    args = p.parse_args(argv)

    gt_json, gt_dir = args.gt_json, args.gt_dir
    if gt_json is None:
        if not args.cityscapes_dir:
            p.error("need --gt_json/--gt_dir or --cityscapes_dir")
        out = args.gt_out or os.path.join(
            os.path.dirname(args.pred_json), "gt_panoptic"
        )
        gt_json = convert_gt_split(args.cityscapes_dir, args.split, out)
        gt_dir = os.path.join(out, f"cityscapes_panoptic_{args.split}")

    results = pq.pq_compute_folders(
        gt_json, gt_dir, args.pred_json, args.pred_dir
    )
    print(pq.format_results(results))
    if args.results_json:
        with open(args.results_json, "w") as f:
            json.dump(results, f, indent=2)
    return results


def cli_main(argv=None) -> None:
    """Console-script wrapper: ``main`` returns the results dict (useful
    in-process), which would read as a nonzero exit status here."""
    main(argv)


if __name__ == "__main__":
    cli_main(sys.argv[1:])
