#!/bin/sh
# Usage: sh run_train_fast_torch.sh <DEVICE_ID> <LOG_DIR> <DATASET> <LABELED_LIST> <PRETRAIN_CKPT>
# The PyTorch port's twin of run_train_fast.sh: SSL with the pruned
# --fast_step, which skips compute whose outputs the reference discards
# (teacher labeled rows, teacher jitter IoU, unlabeled student jitter).
# Per-box numerics are identical; only the train-mode BatchNorm batch
# composition differs from run_train_torch.sh, the parity recipe. Its speed
# on the card is not measured yet (PERF.md).
mkdir -p "$2"
CUDA_VISIBLE_DEVICES="$1" python -m iou3dmatch_tpu_torch.cli.train \
  --log_dir "$2" --dataset "$3" --labeled_sample_list "$4" \
  --detector_checkpoint "$5" --view_stats --fast_step \
  2>&1 | tee -a "$2/log_train.txt"
