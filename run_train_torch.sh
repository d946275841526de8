#!/bin/sh
# Usage: sh run_train_torch.sh <DEVICE_ID> <LOG_DIR> <DATASET> <LABELED_LIST> <PRETRAIN_CKPT>
# The PyTorch port's twin of run_train.sh (reference run_train.sh,
# README.md:141-160): mean-teacher SSL with the reference-exact step (the
# teacher on the full mixed batch, every scene's jittered GridConv pass,
# train.py:334-337 of the reference) on the card CUDA_VISIBLE_DEVICES names.
mkdir -p "$2"
CUDA_VISIBLE_DEVICES="$1" python -m iou3dmatch_tpu_torch.cli.train \
  --log_dir "$2" --dataset "$3" --labeled_sample_list "$4" \
  --detector_checkpoint "$5" --view_stats --reference_exact_step \
  2>&1 | tee -a "$2/log_train.txt"
