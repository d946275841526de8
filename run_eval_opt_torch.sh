#!/bin/sh
# Usage: sh run_eval_opt_torch.sh <DEVICE_ID> <LOG_DIR> <DATASET> <LABELED_LIST> <CKPT> <OPT_RATE>
# The PyTorch port's twin of run_eval_opt.sh: IoU-guided NMS and 10 steps
# of test-time IoU optimisation (gradient ascent of the predicted IoU in the
# box centre and size), on the card CUDA_VISIBLE_DEVICES names.
mkdir -p "$2"
CUDA_VISIBLE_DEVICES="$1" python -m iou3dmatch_tpu_torch.cli.train \
  --log_dir "$2" --dataset "$3" --labeled_sample_list "$4" \
  --detector_checkpoint "$5" --eval --use_iou_for_nms \
  --opt_step 10 --opt_rate "$6" \
  2>&1 | tee -a "$2/log_eval_opt.txt"
