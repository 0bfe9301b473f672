#!/bin/bash
# Fused-serving alternative to run_fg_eval_panoptic.sh: the port's
# cli/forecast_fused.py runs one step per target frame (pc reprojection
# through K1 -> bg through K2 -> fg rollout -> fusion) with no
# intermediate bg/pc export files, then scores PQ with the in-tree
# evaluator. It writes the same COCO-panoptic protocol as the staged
# chain. Extra arguments (e.g. --set platform cpu) go to the forecast.
set -e
WORKING_DIR=${1:-runs/fg}           # trained fg run
BG_DIR=${2:-runs/bg}                # trained bg run
TERM_CFG=${3:-configs/fg/fg_val_mid.yaml}   # or fg_val_short.yaml
BG_CFG=${BG_CFG:-configs/bg/bg_train.yaml}
PC_CFG=${PC_CFG:-configs/pc_transform/pc_export.yaml}
CITYSCAPES_DIR=${CITYSCAPES_DIR:-data/cityscapes}
python -m panoptic_forecasting_tpu_torch.cli.forecast_fused \
    --working_dir "$WORKING_DIR" --config_file "$TERM_CFG" \
    --load_best_model \
    --set fused.bg_config "$BG_CFG" --set fused.bg_dir "$BG_DIR" \
    --set fused.pc_config "$PC_CFG" --set export_name fused_panoptics \
    "${@:4}"
python -m panoptic_forecasting_tpu_torch.cli.evaluate_panoptic \
    --pred_json "$WORKING_DIR/fused_panoptics_val/fused_panoptics_val.json" \
    --pred_dir "$WORKING_DIR/fused_panoptics_val/fused_panoptics_val" \
    --cityscapes_dir "$CITYSCAPES_DIR" --split val \
    --gt_out "$WORKING_DIR/gt_panoptic" \
    --results_json "$WORKING_DIR/pq_results_fused.json"
