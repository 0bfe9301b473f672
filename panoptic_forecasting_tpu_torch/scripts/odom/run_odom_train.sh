#!/bin/bash
# Train the egomotion forecaster (the port's cli.train; add --set platform
# cpu to run on the CPU). Reference: scripts/odom/run_odom_train.sh
set -e
WORKING_DIR=${1:-runs/odom}
mkdir -p "$WORKING_DIR"
python -m panoptic_forecasting_tpu_torch.cli.train \
    --working_dir "$WORKING_DIR" \
    --config_file configs/odom/odom_train.yaml "${@:2}" \
    | tee "$WORKING_DIR/results.txt"
