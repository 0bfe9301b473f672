#!/bin/bash
# Export bg predictions (mid + short term) for panoptic fusion, with the
# port's export_segmentation (K2 on the card; --set platform cpu for the CPU).
# Reference: scripts/bg/run_export_bg_val.sh (--no_convert keeps trainIds).
set -e
WORKING_DIR=${1:-runs/bg}
python -m panoptic_forecasting_tpu_torch.cli.export_segmentation \
    --working_dir "$WORKING_DIR" \
    --config_file configs/bg/bg_val_mid.yaml \
    --set no_convert true --set export_name bg_export_mid "${@:2}"
python -m panoptic_forecasting_tpu_torch.cli.export_segmentation \
    --working_dir "$WORKING_DIR" \
    --config_file configs/bg/bg_val_short.yaml \
    --set no_convert true --set export_name bg_export_short "${@:2}"
