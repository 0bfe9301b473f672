#!/bin/bash
# Export panoptic forecasts and score PQ with the port's export_panoptic and
# its in-tree evaluator (extra arguments, e.g. --set platform cpu, go to the
# export). Reference: scripts/fg/run_fg_eval_panoptic.sh
set -e
WORKING_DIR=${1:-runs/fg}
TERM_CFG=${2:-configs/fg/fg_val_mid.yaml}   # or fg_val_short.yaml
CITYSCAPES_DIR=${CITYSCAPES_DIR:-data/cityscapes}
python -m panoptic_forecasting_tpu_torch.cli.export_panoptic \
    --working_dir "$WORKING_DIR" --config_file "$TERM_CFG" \
    --load_best_model "${@:3}"
python -m panoptic_forecasting_tpu_torch.cli.evaluate_panoptic \
    --pred_json "$WORKING_DIR/exported_panoptics_val/exported_panoptics_val.json" \
    --pred_dir "$WORKING_DIR/exported_panoptics_val/exported_panoptics_val" \
    --cityscapes_dir "$CITYSCAPES_DIR" --split val \
    --gt_out "$WORKING_DIR/gt_panoptic" \
    --results_json "$WORKING_DIR/pq_results.json"
