#!/bin/bash
# Export per-instance forecast masks and score Cityscapes instance AP with
# the port's export_instances and its in-tree evaluator (extra arguments,
# e.g. --set platform cpu, go to the export). Reference capability:
# experiments/export_cityscapes_instance_results.py + the external
# evalInstanceLevelSemanticLabeling tool.
set -e
WORKING_DIR=${1:-runs/fg}
TERM_CFG=${2:-configs/fg/fg_val_mid.yaml}   # or fg_val_short.yaml
CITYSCAPES_DIR=${CITYSCAPES_DIR:-data/cityscapes}
python -m panoptic_forecasting_tpu_torch.cli.export_instances \
    --working_dir "$WORKING_DIR" --config_file "$TERM_CFG" \
    --load_best_model "${@:3}"
python -m panoptic_forecasting_tpu_torch.cli.evaluate_instances \
    --pred_dir "$WORKING_DIR/exported_instances_val" \
    --cityscapes_dir "$CITYSCAPES_DIR" --split val \
    --results_json "$WORKING_DIR/ap_results.json"
