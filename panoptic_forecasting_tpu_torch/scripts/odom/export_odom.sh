#!/bin/bash
# Export predicted odometry h5s for train+val (the port's export_odom;
# add --set platform cpu to run on the CPU). Reference: scripts/odom/export_odom.sh
set -e
WORKING_DIR=${1:-runs/odom}
python -m panoptic_forecasting_tpu_torch.cli.export_odom \
    --working_dir "$WORKING_DIR" \
    --config_file configs/odom/odom_train.yaml \
    --set data.data_splits "[train,val]" "${@:2}"
