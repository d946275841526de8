#!/bin/sh
# Usage: sh run_eval_torch.sh <DEVICE_ID> <LOG_DIR> <DATASET> <LABELED_LIST> <CKPT>
# The PyTorch port's twin of run_eval.sh: IoU-guided NMS, on the card
# CUDA_VISIBLE_DEVICES names.
mkdir -p "$2"
CUDA_VISIBLE_DEVICES="$1" python -m iou3dmatch_tpu_torch.cli.train \
  --log_dir "$2" --dataset "$3" --labeled_sample_list "$4" \
  --detector_checkpoint "$5" --eval --use_iou_for_nms \
  2>&1 | tee -a "$2/log_eval.txt"
