#!/bin/bash
# Train the foreground forecaster (the port's cli.train; add --set platform
# cpu to run on the CPU). Reference: scripts/fg/run_fg_train.sh
set -e
WORKING_DIR=${1:-runs/fg}
mkdir -p "$WORKING_DIR"
python -m panoptic_forecasting_tpu_torch.cli.train \
    --working_dir "$WORKING_DIR" \
    --config_file configs/fg/fg_train.yaml "${@:2}" \
    | tee "$WORKING_DIR/results.txt"
