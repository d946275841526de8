#!/bin/sh
# Usage: sh run_pretrain_torch.sh <DEVICE_ID> <LOG_DIR> <DATASET> <LABELED_LIST>
# The PyTorch port's twin of run_pretrain.sh (reference run_pretrain.sh,
# README.md:125-140): stage-1 pretraining on the card CUDA_VISIBLE_DEVICES
# names.
mkdir -p "$2"
CUDA_VISIBLE_DEVICES="$1" python -m iou3dmatch_tpu_torch.cli.pretrain \
  --log_dir "$2" --dataset "$3" --labeled_sample_list "$4" \
  2>&1 | tee -a "$2/log_pretrain.txt"
