"""Build gtFine_nofg: GT labelTrainIds with thing pixels set to void.

Counterpart of ``panoptic_forecasting_tpu/cli/prepare_gt_nofg.py``
(reference scripts/preprocessing/remove_fg_from_gt.py): copies every
``*_labelTrainIds.png`` with each thing-class trainId (>= 11) replaced by
255, the background model's target. Host numpy; the files are the JAX
package's, byte for byte.

Usage:
    python -m panoptic_forecasting_tpu_torch.cli.prepare_gt_nofg \\
        --cityscapes_dir DIR [--splits train val] [--out_dir DIR]
"""

from __future__ import annotations

import argparse
import glob
import os
import sys

import numpy as np

from ..data.cityscapes import NUM_STUFF_CLASSES
from ..data.io import PNG_IDS, load_png, save_png


def remove_fg(seg: np.ndarray) -> np.ndarray:
    return np.where(seg >= NUM_STUFF_CLASSES, 255, seg).astype(np.uint8)


def main(argv=None) -> None:
    p = argparse.ArgumentParser()
    p.add_argument("--cityscapes_dir", required=True)
    p.add_argument("--splits", nargs="+", default=["train", "val"])
    p.add_argument("--out_dir")
    args = p.parse_args(argv)

    out_root = args.out_dir or os.path.join(args.cityscapes_dir, "gtFine_nofg")
    n = 0
    for split in args.splits:
        pattern = os.path.join(args.cityscapes_dir, "gtFine", split, "*",
                               "*_labelTrainIds.png")
        for path in sorted(glob.glob(pattern)):
            city = os.path.basename(os.path.dirname(path))
            save_png(os.path.join(out_root, split, city, os.path.basename(path)),
                     remove_fg(load_png(path)), **PNG_IDS)
            n += 1
    print(f"wrote {n} nofg label maps -> {out_root}")


if __name__ == "__main__":
    main(sys.argv[1:])
