#!/bin/bash
# Train the background model (the port's cli.train; add --set platform cpu
# to run on the CPU). Reference: scripts/bg/run_bg_train.sh
set -e
WORKING_DIR=${1:-runs/bg}
mkdir -p "$WORKING_DIR"
python -m panoptic_forecasting_tpu_torch.cli.train \
    --working_dir "$WORKING_DIR" \
    --config_file configs/bg/bg_train.yaml "${@:2}" \
    | tee "$WORKING_DIR/results.txt"
