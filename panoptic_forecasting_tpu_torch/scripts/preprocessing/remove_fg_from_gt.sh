#!/bin/bash
# Build gtFine_nofg (thing pixels -> void) for bg supervision with the
# port's prepare_gt_nofg (host only). Reference: scripts/preprocessing/remove_fg_from_gt.sh
set -e
python -m panoptic_forecasting_tpu_torch.cli.prepare_gt_nofg \
    --cityscapes_dir "${1:-data/cityscapes}" "${@:2}"
