#!/usr/bin/env python3
"""Drives the PyTorch port's detection forward, eval, pretrain step, SSL step, training input path, drivers, SUN RGB-D end to end, the library modules, data parallelism and bf16 mixed precision on one NVIDIA GPU.

Run from the repository root: ``python3 chip_smoke.py``. It needs one CUDA
card and the CUDA toolkit (``nvcc``); it builds the kernels from
``iou3dmatch_tpu_torch/csrc/`` into ``build/kernels/`` itself. Phases, each
reported on its own line; a failed check raises and the exit code is not 0:

1. the card (``nvidia-smi`` name and power limit), versions, TF32 flags;
2. the kernels' build, one ``nvcc`` per source, all in parallel, and every
   kernel's registers, stack frame and spills from the compiler output kept
   beside its library;
3. each kernel against its plain PyTorch version on the card, at every shape
   the full-width ScanNet forward and pretrain step launch it at, and at the
   SSL step's: FPS at its 24 clouds, the ball query at a forward's 12, the
   gather's backward at SA2 of the student's 12 scenes, LHS at (8, 64)
   clustered boxes (with the cycles of each step, ``lhs_phases``),
   three_nn at GridConv's grids of serving, the pretrain step and the SSL
   step and at FP1 and FP2 of 8 and 12 scenes, three_interpolate's forward
   with FP's skip features and without (bit for bit; ``embedding_bag``
   beside the latter) and backward on FP's strided cotangent (bit for bit
   the plain version on the CPU, the same over two runs, and the f64 gate)
   at FP1 and FP2 of 8 and 12 scenes, FP1 and FP2 profiled for a
   concatenation or copy (``fp_no_copy``, there must be none), greedy NMS
   at serving's
   (8, 128) class-aware boxes in float64 (off every path: its float32 3D
   and 2D branches, tied scores, K = 256, 512 and 1,024 and matrix mode on
   a rotated BEV IoU, each with its planned cluster size and its cycles a
   step for the leader block and the others, and the overlaps computed and
   skipped; class-aware float64 and matrix mode at K = 2,048 and 4,096
   and class-aware with one class holding 40 % of 4,096, the global-matrix
   path, each with its device time a launch (torch.profiler,
   ``nms_launch_split``), and class-aware its segments and largest
   segment; the ball query on surface scenes, the rotated
   IoU on rotated boxes), FPS also at ``--cluster_sampling vote_fps``'s shapes (over
   1,024 and 2,048 votes) and at ``fps_prefix=False``'s (SA2-SA4 and
   ``seed_fps`` over FPS-ordered sets, which must give back their
   prefixes), and the shapes of phase 11 and of ``query_feats="vote"``
   (the ball query at r 0.4 ns 128 over SA1 and the LFP's r 0.4 ns 16, the
   gather and its backward there, the gather's backward at ns 64 with
   C = 4, GridConv's gather and three_nn over the votes), and bf16's
   (phase 13: the bitcast-packed bf16 gather of SA3, SA4 and GridConv as
   131 f32 words, bit for bit its plain bf16 gather, its backward at C =
   256 and through the wrapper within one bf16 ulp), rows marked off
   the main path,
   with CUDA-event timings of kernel, plain version and library call, the
   launch floor (a one-element ``zero_()`` timed the same way), and the
   launch plans of FPS, the ball query, the gather's backward, three_nn
   and three_interpolate's backward; FPS, the
   ball query, the gather, LHS, three_nn, three_interpolate (both ways)
   and NMS must be exactly equal, the gather's backward within 1e-5 x the
   sum of |g| of each element of an f64 sum, the IoU within atol 1e-5; it
   fails if a planned FPS variant spills, or three_nn, LHS, NMS,
   three_interpolate (forward or backward) or the gather backward's sum
   kernel spills;
4. the whole forward on the card against the CPU on one 40,000-point scene,
   for the default model, two built with the samplings the drivers'
   ``--cluster_sampling`` reaches (FORWARD_KNOBS: vote_fps; random at given
   indices) and, after phase 5b, three with the knobs no driver sets
   (MODEL_KNOBS: ``fps_prefix=False``; ``query_feats`` "vote" and
   "seed+vote"), every index equal, FPS launched once for each layer that
   runs it (5 without the prefix path, whose every output must equal the
   default model's bit for bit);
5. serving: 3 requests of 8 scenes x 40,000 points through the eval forward
   and ``parse_predictions``' two halves with IoU-guided class-aware NMS on
   the card, each request's picks equal to the host NumPy parse of the same
   outputs, which is timed beside it (parse ms, host list ms, old host
   parse ms), with the kernels' launch counts (three_interpolate's plain
   version never running on the card, ``plain_watch``, here and in the
   timed steps of phases 6, 7 and 13); then the first request
   parsed again at IoU SERVE_CHECK_NMS_IOU in each NMS branch, where the
   NMS must drop boxes, its picks equal to the NumPy parse's;
5b. eval: ``cli/common.py::evaluate`` as run_eval.sh and run_eval_opt.sh run
   it, 3 requests of 8 scenes x 40,000 points with 8-16 GT boxes a scene
   near the model's proposals, AP at 0.25 and 0.5, without and with
   test-time IoU optimisation (10 steps at 5e-4): ``iou_optimize`` on one
   scene on the card against the CPU, launches a request of ``evaluate``
   (the gather's backward never) and its ms a request; then the same
   requests through evaluate's parts in a plain loop, each request's
   picks and the mAP and AR equal to those of the host NumPy parse and to
   evaluate's, ms a request of the forward, the optimisation and the
   parse's halves, and the AP's wall time;
6. training: one pretrain step of 2 scenes on the card against the CPU,
   with GT boxes at the random model's own vote centres (the loss within
   rtol 2e-3, the gradient with cosine > 0.999 and relative L2 < 0.05, FPS
   indices equal, at least MIN_POS_RATIO positives), then 2 warm-up and 5
   timed steps of 8 scenes x 40,000 points (ms a step, scenes/s, peak
   memory, launches a step), one step's forward, backward and optimizer
   spans and its profile, and train-mode BatchNorm at that step's inputs
   in the card's form and in the CPU's; then for each of TRAIN_KNOBS
   (``fps_prefix=False`` with ``query_feats="seed+vote"``; "vote") the
   same card-against-CPU step and 5 timed steps beside the default's
   (launches a step as the default's, FPS 5 without the prefix path);
7. SSL: one mean-teacher step of 1 labeled + 1 unlabeled scene on the card
   against the CPU, ``reference_exact`` with view-stats and thresholds low
   enough for pseudo labels (the gates of phase 6, pseudo labels on both
   sides, LHS's keep masks equal between the card, the CPU and its plain
   version), then 2 warm-up and 5 timed steps at run_train.sh's settings,
   4 + 8 scenes x 40,000 points (ms a step, scenes/s, peak memory, launches
   a step), one step's spans (the shared FPS, teacher, student, loss and
   backward, Adam, EMA), its three_nn and LHS time beside their plain
   versions', and its profile;
8. data, the training input path: DUMP_SCANS ScanNet-format scans of
   DUMP_VERTICES vertices (data/prep_scannet.py's size: floor and walls as
   ``make_surface_scenes`` spreads them, 10-30 boxes of ScanNet classes a
   scan, rgb, instance and nyu40 labels, fitted boxes; DUMP_TRAIN train, the
   rest val, DUMP_LABELED labeled) written in a temporary directory, removed
   at the end, with their bytes and seconds; (b) the first loader batch's
   ``stage_batch`` equal bit for bit to a copy of each leaf to the card,
   and so 6 batches staged back to back in the prefetch thread behind a
   0.5 s spin, with staging's bytes, wall ms and copy ms; (c) the loader
   alone, ``ScannetDetectionDataset(train, augment, height, 40,000
   points)`` through ``DataLoader(batch_size=8)``, scenes/s with 1, 2, 4
   and min(8, cores) process workers (1 warm-up batch, 6 timed), one
   ``__getitem__`` in this process and a sample's pickle round trip; (d)
   pretrain fed by ``build_supervised_datasets`` at cli/pretrain.py's
   defaults through ``DataLoader(8)``, ``prefetch`` and ``stage_batch``,
   LOADER_WORKERS workers, 2 warm-up and 5 timed steps (CUDA-event ms a
   step, wall ms a step, the wait on the prefetch queue, scenes/s,
   launches a step equal to phase 6's) beside phase 6's resident batch;
   (e) SSL fed by ``build_ssl_datasets`` with view-stats, ``SSLBatcher`` of
   4 labeled and 8 unlabeled, the same numbers beside phase 7's; (f) the
   state after (d) saved with ``train/checkpoint.py`` and loaded into a
   fresh model and state on the card: every tensor of the model and of
   Adam's state, the step count, the generator and one eval forward equal
   bit for bit; ``load_pretrain_into_ssl`` of the file gives a student and
   a teacher equal to the saved model in tensors of their own, and an
   empty Adam state;
9. the drivers at full width (``phase_drivers``), on dumps written again as
   phase 8's: (a) ``cli/pretrain.main`` in this process, 3 epochs of one
   step of 8 scenes on the 8-scan labeled list and one eval, (b)
   ``cli/train.main`` with run_train.sh's flags from (a)'s checkpoint, 2
   epochs of 2 steps of 4 + 8 scenes and one eval, (c) its ``--resume`` for
   a third epoch, which must continue at epoch 2, (d) the eval entry point
   with 10 steps of IoU optimisation at 5e-4 as a subprocess
   ``python3 -m iou3dmatch_tpu_torch.cli.train`` with no device flag, which
   must log the card as its device and whose mAP and AR lines and dumps
   must equal those of ``evaluate`` in this process on the same checkpoint
   and batches, (e) one pretrain epoch with ``--cluster_sampling
   vote_fps``, (g) the eval entry point with (d)'s flags in this process at
   ``--cluster_sampling vote_fps --vote_factor 2 --num_target 2048``, past
   the NMS cluster path, the first request's picks held to the plain NMS
   on the same proposals, (f) 2 epochs of each driver without eval on more scans
   (pretrain on the 40 train scans, 5 steps an epoch; SSL with 24 labeled,
   6 steps an epoch), steps 2-4 of each traced by ``--profile_steps 3``
   and the trace read back: the device's idle share and the host's wait
   for the card a step. Each run's epoch times, its wait for each epoch's
   first batch, a step's queuing, wait and loop time on the host clock,
   ms and scenes/s a step, launches (counted around it: steps x phase 6's
   or 7's a step, plus phase 5b's a request for each eval batch; FPS 2 a
   step in (e)) and the files written;
10. SUN RGB-D end to end (``phase_sunrgbd``) at the full width of its
   VoteNet (10 classes, 12 heading bins, 10 size clusters): (a) SUN_TRAIN +
   SUN_VAL synthetic frames of SUN_POINTS points (a floor, 3-4 walls, 3-8
   boxes of the 10 classes near their mean sizes with headings uniform in
   [-pi, pi), half extents in the label files) written in the
   ``sunrgbd_trainval`` layout, ``python -m
   iou3dmatch_tpu_torch.data.prep_sunrgbd`` to the 50k v1 dumps (in
   SUN_PREP_PROCESSES processes) and ``gen_split sunrgbd 0.05`` (8 labeled
   frames covering the 10 classes), with the frame, box and vote counts and
   the seconds; ``prep_scannet`` on RAW_SCANS raw ScanNet scans, read back
   by ``ScannetDetectionDataset``; (b) the forward on one 40,000-point
   frame on the card against the CPU, every index equal; one pretrain step
   of 2 frames on the card against the CPU with its IoU labels on rotated
   GT (atol IOU_LABEL_ATOL) and the card's IoU on those inputs against its
   plain version; the first SSL step (1 + 1 frames, ``trans_angle`` on) on
   the card against the CPU at phase 7's gates; the rotated IoU, class-aware
   NMS and LHS at SUN RGB-D's shapes (kernel rows marked ``dataset``); (c)
   ``cli/pretrain.main`` (3 one-step epochs and one eval), ``cli/train.main``
   with run_train.sh's flags from its checkpoint (2 epochs of 2 steps and
   one eval), the eval entry point with 10 steps of IoU optimisation as a
   subprocess, its AP lines and dumps equal to an in-process ``evaluate``'s;
   (d) each run's ms and scenes/s a step and launches a step beside the
   card's name and power limit, and the cuts of the recipe under ``reduced``.
   Its temporary directory stays under 1 GB and is removed;
11. the PointNet++ modules VoteNet leaves unused (``phase_library``), on
   rooms of 40,000 points: ``PointnetSAModuleMSGVotes`` at SA1 (npoint
   2,048, height channel, r 0.2 ns 64 and r 0.4 ns 128, mlps (1, 64, 64,
   128)), ``PointnetSAModuleVotes`` at SA1 with avg and rbf pooling,
   ``QueryAndGroup`` at SA1's radius, ``PointnetLFPModuleMSG`` from SA2's
   1,024 points (256 channels) to SA1's 2,048 (128 channels) and
   ``PointnetSAModule(npoint=None)`` (GroupAll) over SA4's 256 points x 256
   channels, each in train mode on one scene card against the CPU (indices
   equal, outputs within atol and rtol 1e-3, gradients of the inputs and
   the parameters with cosine > 0.999), then forward and backward at 8
   scenes timed and its launches counted; the MSG module with
   ``sample_uniformly`` (the card's resampling equal to the CPU core on the
   card's indices and draws), and ``RandomDropout(0.5)`` on (8, 2,048,
   128), whole channels zeroed, kept values unscaled, equal to the CPU core
   on the card's draws;
12. data parallelism (``phase_parallel``), run after phase 9 on its dumps,
   every rank a subprocess with torchrun's environment (``run_ranks``: a
   time limit, each rank's exit code and ``done`` line checked, so no
   process group outlives it here): (a) a 1-rank NCCL group, the SSL step
   of phase 7 (4 + 8 rooms, run_train.sh's settings) through
   ``shard_train_step`` against the plain step from the same weights,
   batch and generator (loss rtol 2e-3, gradient cosine > 0.999, FPS
   indices equal, the ball query's equal wherever its inputs are: SA1-SA4
   always), 5 turns of a timed step of each (ms, collectives and launches
   a step, the launches phase 7's), one step of each profiled (wall and
   device ms, the host's top ops), an all-reduce's host and wall time, and
   train-mode BN at the student's 28 BN
   inputs in the native, written-out, group-native and group-written-out
   forms; (b) two ranks sharing the card over gloo, each on 2 + 4 rooms of
   phase 7's batch and on 4 of 8 pretrain rooms, 3 steps of each through
   ``shard_train_step``, the first held to one process on the whole batch
   (``PAR_GATES``), the ranks' parameters equal after the last, and each
   rank's ms, collectives and launches a step (phases 6's and 7's) and an
   all-reduce's time over gloo; (c)
   ``python -m torch.distributed.run --standalone --nproc_per_node 2 -m
   iou3dmatch_tpu_torch.cli.train`` with phase 9 (b)'s flags at
   ``--batch_size 2,4`` from phase 9 (a)'s checkpoint: its log's
   data-parallel and group lines, its first step's logged metrics equal to
   9 (b)'s to the log's 4 decimals, the step, epoch and generator state
   equal to (b)'s, the checkpoint finite, its change against (b)'s
   reported, and the epochs' ms;
13. bf16 mixed precision (``phase_bf16``), after phase 12 on phase 9's
   dumps, for ``compute_dtype="bfloat16"`` and with ``f32_gridconv``: (a)
   the forward on one scene against the CPU (indices equal; heads within
   1e-2 of scale or twice the card's own change for clouds moved by 1e-5);
   (b) serving's 3 requests in turns with f32 (picks held to the NumPy
   parse; device ms, scenes/s, peak memory, launches); (c) phase 6's and
   7's card-vs-CPU steps (``step_gate``: FPS equal, SA1 within 4 bf16
   ulps, loss rtol 0.15, gradient cosine > 0.3, beside the card's own
   distance with the CPU's BatchNorm form), then 2 warm-up and 5 timed steps of each precision
   in turns, twice; (d) one profiled pretrain and SSL step in f32 and in
   bf16 (the GEMMs', BatchNorm's and other kernels' device ms, busy
   share), and bf16 BatchNorm's native form against the CPU's cast form at
   a step's 19 bf16 inputs; (e) the drivers with ``--bf16`` and ``--bf16
   --f32_gridconv``: a pretrain epoch, an SSL epoch and ``--eval
   --use_iou_for_nms --opt_step 10``, each logging bf16, every checkpoint
   float32. (b) and the timed steps run first, (a) and (c)'s long CPU
   sides after them.

``--kernels-only`` stops after phase 3 and prints neither of the last two
lines. It also runs from the root of another checkout that has the SSL
step, so that two versions of the kernels are timed on one card in one call.
``--fps-sweep`` adds FPS over every cluster x block size of FPS_SWEEP at
the serving shape to phase 3; ``--bq-sweep`` adds the ball query over every
(C, T) of BQ_SWEEP at each of its shapes; ``--gbwd-sweep`` the gather's
backward over every count of sum blocks of GBWD_SWEEP at each of its
shapes; ``--nn-sweep`` three_nn over every (S, Q) of NN_LAUNCHES at each
of its seven shapes; ``--nn-counts`` three_nn's counters (a build with
-DTHREE_NN_COUNTS: 4-seed group steps, those that took the insert path,
cycles staging, scanning, merging and writing, means a warp) at its seven
shapes, with the planned launch and with a thread a query (S = Q = 1);
``--nms-sweep`` NMS at every cluster size of NMS_CLUSTERS at each of its
cluster-path rows, and past 1,024 boxes at every tile-block count of
GLOBAL_TILE_BLOCKS (box modes) or rows a block of GLOBAL_ROWS_PER_BLOCK
(matrix mode); ``--nms-only`` builds csrc/nms.cu alone and runs only the
NMS rows of phase 3 (no spill check), also from the root of another
checkout, so that two versions of NMS are timed in turns on one card;
``--ibwd-sweep`` three_interpolate's backward at every (ranges,
slices) of IBWD_SWEEP at each of its shapes.

The model is the full-width ScanNet VoteNet (128 proposals, height channel,
SA 2048/1024/512/256) with random weights from a fixed seed. Scenes are
uniform points in a [-3, 3]^2 x [0, 2.5] room with the height channel
z - min z, made from a NumPy seed; a training scene adds 8-16 boxes of
ScanNet classes with vote labels on the points inside them; an SSL
student sees its scenes flipped, turned and scaled. The surface scenes spread their points
uniformly by area over the floor and four walls of a 4 x 4 x 2.5 m room, as
a scan sees it, so that most balls of r 0.2 fill their 64 slots. The last
two lines are the kernels' JSON and the device JSON.
"""
import argparse
import contextlib
import functools
import itertools
import json
import os
import pickle
import re
import shutil
import socket
import subprocess
import sys
import tempfile
import time
import types
from pathlib import Path

import numpy as np
import torch
import torch.nn.functional as F

from iou3dmatch_tpu_torch.cli import common as cli_common
from iou3dmatch_tpu_torch.cli import pretrain as cli_pretrain
from iou3dmatch_tpu_torch.cli import train as cli_train
from iou3dmatch_tpu_torch.data.config import get_config
from iou3dmatch_tpu_torch.data import gen_split, prep_scannet
from iou3dmatch_tpu_torch.data.loader import DataLoader, SSLBatcher, collate, prefetch
from iou3dmatch_tpu_torch.data.pc_util import rotz
from iou3dmatch_tpu_torch.data.scannet import ScannetDetectionDataset
from iou3dmatch_tpu_torch.data.staging import layout as staging_layout
from iou3dmatch_tpu_torch.data.staging import stage_batch
from iou3dmatch_tpu_torch.eval import ap_helper
from iou3dmatch_tpu_torch.eval.ap_helper import (APCalculator, decode_corners, eval_config_dict,
                                                 nms_scores, pack_predictions,
                                                 parse_groundtruths, parse_predictions,
                                                 parse_predictions_np, proposal_lists)
from iou3dmatch_tpu_torch.eval.iou_opt import iou_optimize
from iou3dmatch_tpu_torch.geometry.iou3d import (bev_candidates, box_pairs, box_pairs_plain,
                                                 pairs_apart)
from iou3dmatch_tpu_torch.geometry.nms import (box_overlaps, lhs_3d_samecls_plain,
                                               nms_boxes_plain, nms_masked_plain,
                                               samecls_iou_aabb)
from iou3dmatch_tpu_torch.losses import iou_labels as iou_labels_mod
from iou3dmatch_tpu_torch.losses import labeled as labeled_loss
from iou3dmatch_tpu_torch.losses import unlabeled
from iou3dmatch_tpu_torch.models.factory import build_votenet
from iou3dmatch_tpu_torch.models import grid_conv, pointnet2
from iou3dmatch_tpu_torch.models.mlp import BatchNorm, RandomDropout, set_bn_momentum
from iou3dmatch_tpu_torch.ops import _build
from iou3dmatch_tpu_torch.ops.ball_query import (BallQueryLaunch, GatherBwdLaunch, ball_query,
                                                 ball_query_plain, ball_query_plan,
                                                 gather_bwd_plan, group_points,
                                                 group_points_backward,
                                                 group_points_backward_plain,
                                                 group_points_bitcast, group_points_bitcast_plain,
                                                 group_points_plain)
from iou3dmatch_tpu_torch.ops.fps import (fps_plan, fps_variant, furthest_point_sample,
                                          furthest_point_sample_plain)
from iou3dmatch_tpu_torch.ops import interpolate as interpolate_mod
from iou3dmatch_tpu_torch.ops.interpolate import (NN_LAUNCHES, InterpBwdLaunch, NnLaunch,
                                                  check_interp_bwd_launch, interp_bwd_plan,
                                                  three_interpolate,
                                                  three_interpolate_backward,
                                                  three_interpolate_backward_plain,
                                                  three_interpolate_plain, three_nn, three_nn_plain,
                                                  three_nn_plan)
from iou3dmatch_tpu_torch.ops.lhs import SMALL_BOXES, lhs_3d_samecls
from iou3dmatch_tpu_torch.ops.nms import MAX_BOXES as NMS_MAX_BOXES
from iou3dmatch_tpu_torch.ops.nms import MODE_IDS as NMS_MODE_IDS
from iou3dmatch_tpu_torch.ops.nms import NMS_CLUSTERS, nms_boxes, nms_masked, planned_cluster
from iou3dmatch_tpu_torch.ops.nms import max_active_clusters as nms_max_active
from iou3dmatch_tpu_torch.parallel import collectives, distributed, shard_batch, shard_train_step
from iou3dmatch_tpu_torch.train import checkpoint
from iou3dmatch_tpu_torch.train.schedules import get_bn_momentum
from iou3dmatch_tpu_torch.train.state import create_train_state
from iou3dmatch_tpu_torch.train.steps import (make_eval_forward, make_eval_loss,
                                              make_pretrain_step, make_ssl_step)

B, N, NPOINT = 8, 40_000, 2048
K, G = 128, 64  # proposals; GT slots a scene (max_num_obj)
LR = 1e-3  # pretrain.py's base lr; the BN momentum is epoch 0's
MIN_POS_RATIO = 0.05  # the card-vs-CPU step's positives: >= 8 of a scene's 128 proposals sit at a GT center
SSL_B = 12  # the SSL step's teacher and student forwards each take 12 clouds
HBM_BYTES_PER_S = 3.35e12  # H100 SXM, NVIDIA data sheet
# Operation bounds count instructions issued at SMs x 128 lanes x the top SM
# clock (issue_rate). FPS and the ball query round every product and sum on
# its own, so each of their operations is one instruction; the data sheet's
# 67 TFLOP/s float32 counts a fused multiply-add as two and fits neither.
LANES_PER_SM = 128
PAIR_OPS = 9  # a distance test: 3 sub, 3 mul, 2 add, 1 compare
BIN_OPS = 12  # a point's r-cell and its count: 3 sub, 3 mul, 3 cvt, 2 mad, 1 atomic
REPS = 20
PLAIN_FPS_REPS = 3  # the plain FPS is a Python loop of npoint steps, ~0.35 s a call
FPS_SWEEP = [(s, t) for s in (8, 16) for t in (128, 256, 512, 1024)]  # (cluster, threads)
BQ_SWEEP = [(c, t) for c in (1, 2, 4, 8) for t in (512, 1024, 2048)]  # (centers a warp, tile)
# The rotated IoU's operations, counted from csrc/iou3d.cu as in the plain
# version, each product and sum one instruction. What the function needs:
# each box's corners (44 with a sine and a cosine) and its x, y and z
# extents (19, grown by their reach), once a box; a reject test a pair (6
# compares, 5 ors, 1 select), which gives 0 where ``pairs_apart`` holds;
# for a pair whose extents meet, 16 edge intersections (94 each), 8
# containment tests (118 in all) and the z overlap and union (21); for one
# with n > 0 candidates the centroid (98), per candidate an angle (3) and a
# fan term (6), and a sort of n ceil(log2 n) compares. scan_bound_ms counts
# the full pair work, corners included, for every pair.
IOU_BOX_OPS = 44 + 19
IOU_REJECT_OPS = 12
IOU_PAIR_OPS = 16 * 94 + 118 + 21
IOU_HIT_OPS = 98
IOU_VERTEX_OPS = 9
GBWD_SWEEP = (4, 8, 16, 32, 64, 128, 256)  # the gather backward's sum blocks a scene, channel group
# LHS's operations, counted from the rounds as csrc/lhs.cu's thread-a-box
# path runs them (the bit-matrix path computes every pair's IoU once, more
# than the rounds need), each product and sum one
# instruction: a box's area once (9); in each round, for each box still
# remaining, its IoU with the winner (3 min, 3 max, 3 sub, 3 clamps, 2 mul,
# add, sub, div, the class gate and the compare: 19) and its share of the
# argmax and the bookkeeping (4); for each suppressed box, its rank over
# its own cluster (4 a cluster box: the flag, two compares, an add). Both
# depend on the input, so they are counted by replaying its rounds
# (lhs_work).
LHS_BOX_OPS = 9
LHS_ROUND_OPS = 19 + 4
LHS_RANK_OPS = 4
# NMS's operations, counted from csrc/nms.cu as the plain version does
# them, each product and sum one instruction: a pair's overlap is, per axis,
# a min, a max, a subtraction and a clamp; the products of the sides; the
# sum of the areas, the union's subtraction and the division; the class
# gate's select and product (3d_cls); the compare. A box's area: its sides'
# subtractions and products. Matrix mode reads a given IoU: a compare a
# pair. The pairs the function needs are each round's winner against the
# boxes still remaining (nms_pairs, a replay of the rounds), in 3d_cls at
# thresh >= 0 only those of the winner's class (the gate zeroes the
# others, which then suppress nothing); ordering K
# keys needs K ceil(log2 K) compares. 3d_cls's float64 operations issue at
# SMs x FP64_LANES_PER_SM x the top clock, half the float32 rate, and are
# counted as two instructions each.
NMS_PAIR_OPS = {"2d": 2 * 4 + 1 + 3 + 1, "3d": 3 * 4 + 2 + 3 + 1, "3d_cls": 3 * 4 + 2 + 3 + 2 + 1,
                "matrix": 1}
NMS_AREA_OPS = {"2d": 2 + 1, "3d": 3 + 2, "3d_cls": 3 + 2, "matrix": 0}
FP64_LANES_PER_SM = 64
OPT_RATE, OPT_STEP = 5e-4, 10  # run_eval_opt.sh's rate (train.py:69) and steps
KERNELS = {
    "fps": furthest_point_sample,
    "ball_query": ball_query,
    "gather": group_points,
    "gather_bwd": group_points_backward,
    "iou3d": box_pairs,
    "lhs": lhs_3d_samecls,
    "three_nn": three_nn,
    "nms": nms_boxes,
    "three_interpolate": three_interpolate,
    "three_interpolate_bwd": three_interpolate_backward,
}
REPLACES = {
    "fps": "iou3dmatch_tpu/ops/fps_pallas.py:46",
    "ball_query": "iou3dmatch_tpu/ops/ball_query.py:35",
    "gather": "iou3dmatch_tpu/ops/gather_pallas.py:35",
    "gather_bwd": "iou3dmatch_tpu/ops/ball_query.py:234",
    "iou3d": "iou3dmatch_tpu/geometry/iou3d.py:94",
    "lhs": "iou3dmatch_tpu/geometry/nms.py:115",
    "three_nn": "iou3dmatch_tpu/ops/interpolate.py:21",
    "nms": "iou3dmatch_tpu/geometry/nms.py:170",
    "three_interpolate": "iou3dmatch_tpu/ops/interpolate.py:111",
    "three_interpolate_bwd": "iou3dmatch_tpu/ops/interpolate.py:137",
}
# the source of a kernel named otherwise: three_interpolate's backward is
# csrc/three_interpolate.cu's backward kernel
KERNEL_SOURCES = {"three_interpolate_bwd": "three_interpolate"}
# three_interpolate's forward is one embedding_bag over the flattened table
# with per-sample weights (its library_ms); FP's fused forward, which also
# writes the skip features after the interpolated ones, takes two calls
INTERP_FUSED_NO_LIBRARY = ("no single PyTorch call writes [interpolated | skip]: "
                           "embedding_bag, then cat")
# the backward's (ranges, slices) that --ibwd-sweep times at each of its shapes
IBWD_SWEEP = [(r, s) for r in (4, 8, 11, 12, 16, 17, 22, 33) for s in (1, 2, 4)]
# three_interpolate's operations: a product a neighbour and a channel, and
# three sums from the identity (forward); a product and a sum a slot and a
# channel (backward)
INTERP_OPS, INTERP_BWD_OPS = 3 + 3, 2
# three_nn's operations: each (query, seed) pair is a distance test of
# PAIR_OPS (3 sub, 3 mul, 2 add, 1 compare; no FMA, csrc/three_nn.cu is
# built with -fmad=false); each query's 3 selected d2 are computed again,
# with their square roots, at about a pair's cost each: (m + 3) PAIR_OPS a
# query.
NN_YARDSTICK = "torch.cdist + topk(3, largest=False): two calls, matmul-form distances, not exact"
# the kernels whose compiler report must list these entries, none spilling
NO_SPILL = {"three_nn": tuple(f"three_nn_kernelILi{s}ELi{q}EE" for s, q in NN_LAUNCHES),
            "lhs": ("lhs_small_kernel", "lhs_kernel"),
            "nms": tuple(f"nms_kernelILi{mode}EE" for mode in range(4))
            + tuple(f"nms_sort_kernelILi{mode}EE" for mode in range(4))
            + tuple(f"nms_tiles_kernelILi{mode}EE" for mode in range(3))
            + ("nms_rows_kernel", "nms_chain_kernelILb0EE", "nms_chain_kernelILb1EE"),
            "three_interpolate": tuple(f"three_interpolate_kernelILi{v}ELb{k}EE"
                                       for v in (1, 4) for k in (0, 1))
            + ("three_interpolate_bwd_kernelILi1EE", "three_interpolate_bwd_kernelILi4EE"),
            "gather_bwd": ("gather_bwd_sum_kernel",)}
NN_COUNTS = ("warps", "group_steps", "insert_steps", "stage_cycles", "scan_cycles",
             "merge_cycles", "write_cycles")  # csrc/three_nn.cu nn_counts
SSL_NL, SSL_NU = 4, 8  # run_train.sh: 4 labeled + 8 unlabeled scenes a step
SSL_LR = 2e-3  # train.py:49
# The card-vs-CPU SSL step's LHS IoU: a random teacher's proposals rarely
# overlap within a class, so at the released 0.25 LHS keeps every box and
# its gate could not tell a kernel that never suppresses; at 0.05 it
# drops some (ssl_check fails otherwise).
SSL_CHECK_NMS_IOU = 0.05
SERVE_CHECK_NMS_IOU = 0.02  # serving's outputs parsed again where the NMS drops boxes
# the kernels' launches a pretrain step and an SSL step
TRAIN_LAUNCHES = {"fps": 1, "ball_query": 5, "gather": 6, "gather_bwd": 4, "iou3d": 2, "lhs": 0,
                  "three_nn": 3, "nms": 0, "three_interpolate": 2, "three_interpolate_bwd": 2}
# the knobs no driver sets, whose pretrain steps phase 6 runs beside the default's
TRAIN_KNOBS = ({"fps_prefix": False, "query_feats": "seed+vote"}, {"query_feats": "vote"})
SSL_LAUNCHES = {"fps": 1, "ball_query": 10, "gather": 12, "gather_bwd": 4, "iou3d": 3, "lhs": 1,
                "three_nn": 6, "nms": 0, "three_interpolate": 4, "three_interpolate_bwd": 2}
# Phase 8's dumps: ScanNet scans as data/prep_scannet.py writes them, at
# its MAX_NUM_POINT of 50,000 vertices (prep_scannet.py:31)
DUMP_SCANS, DUMP_TRAIN, DUMP_LABELED = 48, 40, 8
DUMP_VERTICES = 50_000
LOADER_WORKERS = 4  # the drivers' --num_workers default (cli/pretrain.py:69)
# Phase 10's SUN RGB-D frames, in the sunrgbd_trainval layout data/prep_sunrgbd.py
# reads (a depth .mat of about 52,000 points, label_v1 and calib a frame, the
# index files), and the raw ScanNet scans data/prep_scannet.py reads
SUN_TRAIN, SUN_VAL, SUN_POINTS = 160, 8, 52_000
SUN_RATIO = 0.05  # the SUN RGB-D split of run_train.sh: 5 % of the train frames
SUN_PREP_PROCESSES = 8  # prep_sunrgbd processes a split, each over its share of the indices
RAW_SCANS, RAW_VERTICES = 4, 60_000  # above prep_scannet.py's 50,000 cap, so the cap draws
IOU_LABEL_ATOL = 2e-3  # the card's IoU labels against the CPU's, as the step's loss is held
SUN_DIR_LIMIT = 1 << 30  # phase 10's temporary directory stays under 1 GB
ANCHORED_BOXES = 16  # GT slots phase 10's card-vs-CPU checks fill, as phase 6's 8-16 a scene
BOX_KEYS = ("heading_class_label", "heading_residual_label", "size_class_label",
            "size_residual_label", "sem_cls_label")
# the SUN RGB-D recipe (run_pretrain.sh, run_train.sh; PAPER.md) beside phase 10's cut of it
SUN_REDUCED = ["train frames 5,285 -> 160 (synthetic, the sunrgbd_trainval layout), "
               "val frames 5,050 -> 8",
               "pretrain epochs 180 -> 3 of one step (8 labeled frames), one eval",
               "SSL epochs 1,000 -> 2 of 2 steps (8 labeled + 152 unlabeled frames), one eval",
               "eval: the 8 val frames, one request"]


def say(**kw):
    print(json.dumps(kw), flush=True)


def issue_rate(dev) -> tuple:
    """(instructions a second, top SM clock in MHz): one instruction a lane
    and clock, on every lane of every SM, at ``nvidia-smi``'s clocks.max.sm."""
    smi = subprocess.run(["nvidia-smi", "--query-gpu=clocks.max.sm", "--format=csv,noheader,nounits"],
                         capture_output=True, text=True, timeout=60, check=True)
    mhz = float(smi.stdout.split()[0])
    n_sm = torch.cuda.get_device_properties(dev).multi_processor_count
    return n_sm * LANES_PER_SM * mhz * 1e6, mhz


def make_surface_scenes(seed: int, b: int, n: int) -> np.ndarray:
    """(b, n, 3) points uniform by area over the floor (16 m^2) and the four
    walls (10 m^2 each) of a 4 x 4 x 2.5 m room centred on the origin."""
    rng = np.random.RandomState(seed)
    face = rng.choice(3, size=(b, n), p=[16 / 56, 20 / 56, 20 / 56])  # floor, x walls, y walls
    u, w = rng.uniform(-2.0, 2.0, (2, b, n))
    side = np.where(rng.rand(b, n) < 0.5, -2.0, 2.0)
    xyz = np.empty((b, n, 3), np.float32)
    xyz[..., 0] = np.select([face == 1], [side], u)
    xyz[..., 1] = np.select([face == 0, face == 1], [w, u], side)
    xyz[..., 2] = np.where(face == 0, 0.0, rng.uniform(0.0, 2.5, (b, n)))
    return xyz


def make_scenes(seed: int, b: int, n: int) -> np.ndarray:
    rng = np.random.RandomState(seed)
    pc = np.zeros((b, n, 4), np.float32)
    pc[..., 0:2] = rng.uniform(-3.0, 3.0, (b, n, 2))
    pc[..., 2] = rng.uniform(0.0, 2.5, (b, n))
    pc[..., 3] = pc[..., 2] - pc[..., 2].min(axis=1, keepdims=True)
    return pc


def cuda_ms(fn, inner: int = 1, reps: int = REPS) -> float:
    """Median over ``reps`` CUDA-event timings of ``inner`` back-to-back calls.
    A ~1 ms spin kernel goes first so the calls are queued before the start
    event runs and host launch overhead stays out of the reading."""
    fn()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        torch.cuda._sleep(2_000_000)
        start.record()
        for _ in range(inner):
            fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end) / inner)
    return float(np.median(times))


def max_err(a, b) -> float:
    """The largest difference of two tensors, or of two tuples of them."""
    if isinstance(a, tuple):
        return max(max_err(x, y) for x, y in zip(a, b))
    return float((a.double() - b.double()).abs().max())


def same(a, b) -> bool:
    if isinstance(a, tuple):
        return all(same(x, y) for x, y in zip(a, b))
    return bool(torch.equal(a, b))


def grid_candidates(radius: float, pts: torch.Tensor, ctr: torch.Tensor) -> int:
    """Points a ball query over a grid of r-sized cells must test: those in
    the 27 cells around each center's cell (a ball of radius r reaches no
    other), summed over the centers. Cells start at each cloud's lower
    corner."""
    b = pts.shape[0]
    lo = pts.amin(1, keepdim=True)
    cell = ((pts - lo) / radius).floor().long()
    dims = (cell.amax((0, 1)) + 1).tolist()
    counts = torch.zeros([b] + dims, dtype=torch.long, device=pts.device)
    scene = torch.arange(b, device=pts.device)[:, None].expand(cell.shape[:2])
    counts.index_put_((scene, cell[..., 0], cell[..., 1], cell[..., 2]),
                      torch.ones_like(scene), accumulate=True)
    pad = torch.nn.functional.pad(counts, (2, 2, 2, 2, 2, 2))  # centers up to a cell outside
    x, y, z = (d + 2 for d in dims)
    near = sum(pad[:, i:i + x, j:j + y, k:k + z] for i in range(3) for j in range(3) for k in range(3))
    c = ((ctr - lo) / radius).floor().long() + 1  # near[.., i] sums the cells around cell i - 1
    inside = ((c >= 0) & (c < torch.tensor([x, y, z], device=c.device))).all(-1)
    c = torch.where(inside[..., None], c, 0)
    rows = torch.arange(b, device=pts.device)[:, None]
    return int((near[rows, c[..., 0], c[..., 1], c[..., 2]] * inside).sum())


def ball_query_scanned(idx: torch.Tensor, n: int) -> int:
    """(center, point) pairs an in-order scan tests before it holds nsample
    hits: up to the nsample-th hit where there is one (the slots are then
    strictly rising), else the whole cloud."""
    if idx.shape[-1] < 2:
        return int(idx.numel()) * n
    full = idx[..., -1] > idx[..., -2]
    return int(torch.where(full, idx[..., -1].long() + 1, n).sum())


def check_kernel(name, label, kernel, plain, library, args, nbytes, ops_of, ops_per_s, inner,
                 plain_reps=REPS, main=True, agree=None):
    """Kernel against plain version on ``args``, then timings. ``ops_of``
    counts the instructions the plain result says the work needs, issued at
    ``ops_per_s``; ``main`` marks a shape of the serving forward, the
    pretrain step or the SSL step. ``agree(got, want)`` says whether the kernel's result is
    right; without it, it must equal the plain version's."""
    got, want = kernel(*args), plain(*args)
    torch.cuda.synchronize()
    err = max_err(got, want)
    ok = same(got, want) if agree is None else bool(agree(got, want))
    bytes_s, ops_s = nbytes / HBM_BYTES_PER_S, ops_of(want) / ops_per_s
    row = {
        "shape": label, "ok": ok, "max_abs_err": err,
        "ms": cuda_ms(lambda: kernel(*args), inner),
        "plain_ms": cuda_ms(lambda: plain(*args), 1, plain_reps),
        "bound_ms": max(bytes_s, ops_s) * 1e3,
        "bound_by": "bytes" if bytes_s >= ops_s else "operations",
        "library_ms": None if library is None else cuda_ms(lambda: library(*args), inner),
        "main": main,
    }
    say(phase="kernel", name=name, **row)
    if not ok:
        raise AssertionError(f"{name} at {label} differs from its plain version (max {err})")
    return got, row


def fps_rows(dev, ops_per_s, b, main, xyz=None, npoint=NPOINT, what=""):
    """FPS at (b, N) -> NPOINT, or over ``xyz`` -> ``npoint``, with the
    planned launch, µs per step beside it."""
    if xyz is None:
        xyz = torch.from_numpy(make_scenes(1, b, N)[..., :3].copy()).to(dev)
    n = xyz.shape[1]
    inds, r = check_kernel(
        "fps", f"{what}({b},{n},3)->{npoint}", furthest_point_sample, furthest_point_sample_plain,
        None, (xyz, npoint), b * n * 12 + b * npoint * 4,
        lambda _: (npoint - 1) * b * n * PAIR_OPS,  # per point and step: 3 sub, 3 mul, 2 add, 1 min
        ops_per_s, 3, PLAIN_FPS_REPS, main)
    r["us_per_step"] = r["ms"] * 1e3 / (npoint - 1)
    launch, answers = fps_plan(dev, b, n)
    r.update(variant=launch.variant, launch=launch._asdict(), max_active_clusters=answers)
    say(phase="fps_plan", shape=r["shape"], **{k: r[k] for k in (
        "us_per_step", "variant", "launch", "max_active_clusters")})
    return xyz, inds, r


def fps_sweep(xyz, want):
    """Every (cluster, threads) of FPS_SWEEP at the serving shape, each
    checked equal to the plain result; times only, nothing counted."""
    b = xyz.shape[0]
    rows = []
    for s, t in FPS_SWEEP:
        launch = fps_variant(N, s, t)
        got = furthest_point_sample(xyz, NPOINT, launch)
        ok = bool(torch.equal(got, want))
        ms = cuda_ms(lambda: furthest_point_sample(xyz, NPOINT, launch), 3, 5)
        rows.append({"cluster": s, "threads": launch.threads, "ppt": launch.ppt, "ok": ok,
                     "ms": ms, "us_per_step": ms * 1e3 / (NPOINT - 1)})
        if not ok:
            raise AssertionError(f"FPS with {launch} differs from its plain version")
    say(phase="fps_sweep", shape=f"({b},{N},3)->{NPOINT}", rows=rows)
    return rows


def bq_sweep(label, args, want):
    """Every (C, T) of BQ_SWEEP on one ball query's inputs, each checked
    equal to the plain result; times only, nothing counted."""
    rows = []
    for launch in map(BallQueryLaunch._make, BQ_SWEEP):
        ok = bool(torch.equal(ball_query(*args, launch), want))
        ms = cuda_ms(lambda: ball_query(*args, launch), 3, 5)
        rows.append({"plan": list(launch), "ok": ok, "ms": ms})
        if not ok:
            raise AssertionError(f"ball query at {label} with {launch} differs from its plain version")
    say(phase="bq_sweep", shape=label, rows=rows)


def gbwd_sweep(label, args, agree, lists):
    """The gather backward with every count of sum blocks a scene of
    GBWD_SWEEP, and the planned list blocks, on one set of inputs, each held
    to the f64 sum; times only, nothing counted."""
    g, idx, n = args
    b, c = g.shape[0], g.shape[-1]
    rows = []
    for parts in GBWD_SWEEP:
        launch = GatherBwdLaunch(parts, lists)
        ok = bool(agree(group_points_backward(g, idx, n, launch)))
        ms = cuda_ms(lambda: group_points_backward(g, idx, n, launch), 5, 5)
        rows.append({"plan": list(launch), "blocks": launch.blocks(b, c), "ok": ok, "ms": ms})
        if not ok:
            raise AssertionError(f"gather backward at {label} with {launch} is off the f64 sum")
    say(phase="gbwd_sweep", shape=label, rows=rows)


def launch_floor_ms() -> float:
    """A one-element ``zero_()`` timed as the kernels are: what any launch
    costs, the floor of the shapes whose bound lies under it."""
    z = torch.zeros(1, device="cuda")
    return cuda_ms(lambda: z.zero_(), 5)


def phase_kernels(dev, ops_per_s, fps_sweep_on: bool = False, bq_sweep_on: bool = False,
                  gbwd_sweep_on: bool = False, nn_sweep_on: bool = False,
                  nn_counts_on: bool = False, nms_sweep_on: bool = False,
                  ibwd_sweep_on: bool = False) -> dict:
    pc = torch.from_numpy(make_scenes(1, B, N)).to(dev)
    rows = {}
    floor = launch_floor_ms()
    say(phase="launch_floor", ms=floor, what="a one-element zero_(), cuda_ms inner 5")
    xyz, inds, r = fps_rows(dev, ops_per_s, B, True)
    rows["fps"] = [r]
    if fps_sweep_on:
        fps_sweep(xyz, inds)
    rows["fps"].append(fps_rows(dev, ops_per_s, 2 * SSL_B, True)[2])  # the SSL step's shared SA1 FPS

    def bq(label, radius, ns, pts, ctr, main=True):
        """The bound counts what the function needs: its bytes, or the fewer
        operations of two ways to find the hits, the distance tests of a grid
        of r-cells with the binning of the cloud, or those of an in-order
        scan; scan_bound_ms counts the scan's alone."""
        b, n = pts.shape[:2]
        m = ctr.shape[1]
        nbytes = b * n * 12 + b * m * 12 + b * m * ns * 4
        args = (radius, ns, pts, ctr)
        cands = grid_candidates(radius, pts, ctr)
        got, r = check_kernel(
            "ball_query", label, ball_query, ball_query_plain, None, args, nbytes,
            lambda want: min(cands * PAIR_OPS + b * n * BIN_OPS, ball_query_scanned(want, n) * PAIR_OPS),
            ops_per_s, 5, main=main)
        r["pairs"], r["grid_candidates"] = ball_query_scanned(got, n), cands
        r["scan_bound_ms"] = max(nbytes / HBM_BYTES_PER_S, r["pairs"] * PAIR_OPS / ops_per_s) * 1e3
        n_sm = torch.cuda.get_device_properties(dev).multi_processor_count
        r["plan"] = list(ball_query_plan(b, m, n, n_sm))
        say(phase="bq_plan", shape=label, pairs=r["pairs"], grid_candidates=cands,
            scan_bound_ms=r["scan_bound_ms"], plan=r["plan"])
        rows.setdefault("ball_query", []).append(r)
        if bq_sweep_on:
            bq_sweep(label, args, got)
        return got

    rows_idx = torch.arange(B, device=dev)[:, None]
    gen = torch.Generator(device=dev).manual_seed(8)

    def gather_bwd(label, table, idx, main=True):
        """The gather's backward into a table of ``table``'s shape, at a
        pretrain step's shape: a cotangent like the gather's output; each
        element of the kernel's and of the plain f32 sum within 1e-5 x (the
        sum of |g| added into it) of an f64 sum. The bound counts g, the
        indices and the output once."""
        b, n, c = table.shape
        g = torch.randn(idx.shape + (c,), generator=gen, device=dev)
        flat_rows = (idx.long().clamp(0, n - 1)
                     + n * torch.arange(b, device=dev)[:, None, None]).reshape(-1)
        g2 = g.reshape(-1, c)
        ref = torch.zeros(b * n, c, dtype=torch.float64, device=dev).index_add_(0, flat_rows, g2.double())
        mag = torch.zeros(b * n, c, dtype=torch.float64, device=dev).index_add_(
            0, flat_rows, g2.double().abs())

        def off(t):
            return (t.double().reshape(b * n, c) - ref).abs()

        def holds(t):
            return bool((off(t) <= 1e-5 * mag).all())

        errs = []

        def agree(got, want):
            errs.extend(float(off(t).max()) for t in (got, want))
            return holds(got) and holds(want)

        out = torch.zeros(b * n, c, device=dev)
        library = lambda *_: out.zero_().index_add_(0, flat_rows, g2)  # noqa: E731
        nbytes = (g.numel() + idx.numel() + b * n * c) * 4
        args = (g, idx, n)
        _, r = check_kernel("gather_bwd", label, group_points_backward, group_points_backward_plain,
                            library, args, nbytes, lambda _: g.numel(), ops_per_s, 10,
                            main=main, agree=agree)
        r["max_abs_err_f64"] = {"kernel": errs[0], "plain": errs[1]}
        n_sm = torch.cuda.get_device_properties(dev).multi_processor_count
        plan = gather_bwd_plan(b, idx[0].numel(), n, c, n_sm)
        r["plan"], r["blocks"] = list(plan), plan.blocks(b, c)
        say(phase="gbwd_plan", shape=label, plan=r["plan"], blocks=r.get("blocks"))
        rows.setdefault("gather_bwd", []).append(r)
        if gbwd_sweep_on:
            gbwd_sweep(label, args, holds, r["plan"][1])

    def gather(label, table, idx, main=True):
        b, n, c = table.shape
        q = idx.shape[1] * idx.shape[2]
        flat = idx.long().clamp(0, n - 1)
        # the table rows the indices name, each read once; the indices; the output
        rows_read = sum(int(torch.unique(flat[i]).numel()) for i in range(b))
        nbytes = rows_read * c * 4 + b * q * 4 + b * q * c * 4
        library = lambda t, i: t[rows_idx[:, :, None], flat]  # noqa: E731
        _, r = check_kernel("gather", label, group_points, group_points_plain, library,
                            (table, idx), nbytes, lambda _: 0, ops_per_s, 10, main=main)
        rows.setdefault("gather", []).append(r)

    def bitcast(label, pts, feats, idx, backward=True):
        """bf16 mixed precision's gather (``group_points_bitcast``): the
        (B, N, 6 + C) bf16 table [xyz's f32 bits | bf16 features] as f32
        words through csrc/gather.cu, bit for bit its plain bf16 gather; the
        bound counts the rows read, the indices and the output once. With
        ``backward``, the backward at C feature channels (csrc/gather_bwd.cu,
        the gather_bwd row) and the gradient through the wrapper within one
        bf16 ulp of the plain f32 sum rounded to bf16."""
        b, n, c = feats.shape
        fb = feats.to(torch.bfloat16).contiguous()
        q = idx.shape[1] * idx.shape[2]
        flat = idx.long().clamp(0, n - 1)
        rows_read = sum(int(torch.unique(flat[i]).numel()) for i in range(b))
        width = (6 + c) * 2
        nbytes = rows_read * width + b * q * 4 + b * q * width
        table = torch.cat([pts.contiguous().view(torch.bfloat16), fb], -1)
        library = lambda *_: table[rows_idx[:, :, None], flat]  # noqa: E731
        _, r = check_kernel("gather", label, group_points_bitcast, group_points_bitcast_plain,
                            library, (pts, fb, idx), nbytes, lambda _: 0, ops_per_s, 10,
                            main=False)
        rows["gather"].append(r)
        if backward:
            gather_bwd(label.replace("131 words", f"{c}") + " backward", feats, idx, main=False)
            g = torch.randn(idx.shape + (c,), generator=gen, device=dev).to(torch.bfloat16)
            f = feats.detach().clone().requires_grad_()
            got, = torch.autograd.grad(group_points_bitcast(pts, f.to(torch.bfloat16), idx)[1], f, g)
            want = group_points_backward_plain(g.float(), idx, n).to(torch.bfloat16).float()
            ulp = torch.exp2(torch.floor(torch.log2(want.abs().clamp(min=2.0 ** -126))) - 7)
            ulps = float(((got - want).abs() / ulp).max())
            say(phase="bitcast_bwd", shape=label, max_bf16_ulps=ulps,
                equal_share=float((got == want).float().mean()), tol="1 bf16 ulp")
            if ulps > 1:
                raise AssertionError(f"the bitcast gather's backward at {label}: {ulps} bf16 ulps")
        return r

    # the forward's five ball queries and six gathers, at its shapes: SA2-SA4
    # take FPS-ordered prefixes, vote aggregation the first 128 of 1,024 votes,
    # GridConv 128 boxes x 64 grid points x 3 neighbours among 1,024 seeds
    rng = np.random.RandomState(3)
    sa1_xyz = xyz[rows_idx, inds.long()]  # FPS-ordered, as SA1 gives SA2
    f128 = torch.from_numpy(rng.randn(B, NPOINT, 128).astype(np.float32)).to(dev)
    f256 = torch.from_numpy(rng.randn(B, 1024, 256).astype(np.float32)).to(dev)
    votes = sa1_xyz[:, :1024] + torch.from_numpy(
        np.random.RandomState(2).normal(0, 0.1, (B, 1024, 3)).astype(np.float32)).to(dev)
    idx = bq(f"sa1 r0.2 ns64 ({B},{N})x{NPOINT}", 0.2, 64, xyz, sa1_xyz)
    gather(f"sa1 ({B},{N},4)x({B},{NPOINT},64)", pc, idx)
    idx = bq(f"sa2 r0.4 ns32 ({B},{NPOINT})x1024", 0.4, 32, sa1_xyz, sa1_xyz[:, :1024].contiguous())
    gather(f"sa2 ({B},{NPOINT},131)x({B},1024,32)", torch.cat([sa1_xyz, f128], -1), idx)
    gather_bwd(f"sa2 ({B},{1024 * 32},131)->({B},{NPOINT},131)", torch.cat([sa1_xyz, f128], -1), idx)
    sa2_xyz = sa1_xyz[:, :1024].contiguous()
    idx = bq(f"sa3 r0.8 ns16 ({B},1024)x512", 0.8, 16, sa2_xyz, sa2_xyz[:, :512].contiguous())
    gather(f"sa3 ({B},1024,259)x({B},512,16)", torch.cat([sa2_xyz, f256], -1), idx)
    gather_bwd(f"sa3 ({B},{512 * 16},259)->({B},1024,259)", torch.cat([sa2_xyz, f256], -1), idx)
    bitcast(f"sa3 bf16 ({B},1024,131 words)x({B},512,16)", sa2_xyz, f256, idx)
    sa3_xyz = sa2_xyz[:, :512].contiguous()
    idx = bq(f"sa4 r1.2 ns16 ({B},512)x256", 1.2, 16, sa3_xyz, sa3_xyz[:, :256].contiguous())
    gather(f"sa4 ({B},512,259)x({B},256,16)", torch.cat([sa3_xyz, f256[:, :512]], -1), idx)
    gather_bwd(f"sa4 ({B},{256 * 16},259)->({B},512,259)", torch.cat([sa3_xyz, f256[:, :512]], -1),
               idx)
    bitcast(f"sa4 bf16 ({B},512,131 words)x({B},256,16)", sa3_xyz, f256[:, :512], idx)
    # the FPS shapes of --cluster_sampling vote_fps (off the default path):
    # FPS over the votes at vote_factor 1 and 2
    for what, pts, npoint in (
            ("vote_fps vf1 ", votes.contiguous(), K),
            ("vote_fps vf2 ", (sa1_xyz[:, :1024, None] + torch.from_numpy(
                np.random.RandomState(12).normal(0, 0.1, (B, 1024, 2, 3)).astype(np.float32))
                .to(dev)).reshape(B, 2048, 3).contiguous(), K)):
        rows["fps"].append(fps_rows(dev, ops_per_s, B, False, pts, npoint, what)[2])
    idx = bq(f"vote_agg r0.3 ns16 ({B},1024)x128", 0.3, 16, votes, votes[:, :128].contiguous())
    gather(f"vote_agg ({B},1024,259)x({B},128,16)", torch.cat([votes, f256], -1), idx)
    gather_bwd(f"vote_agg ({B},{128 * 16},259)->({B},1024,259)", torch.cat([votes, f256], -1), idx)
    _, idx = three_nn(grid_queries(sa2_xyz, False, 5), sa2_xyz)
    gather(f"grid_conv ({B},1024,259)x({B},{K * 64},3)", torch.cat([sa2_xyz, f256], -1), idx)
    # GridConv's bf16 interpolation: the packed bf16 table against the f32
    # table of the rounded values (the row above; the same bytes as any f32 table)
    bitcast(f"grid_conv bf16 ({B},1024,131 words)x({B},{K * 64},3)", sa2_xyz, f256, idx,
            backward=False)["f32_table_ms"] = rows["gather"][-2]["ms"]

    # Off the default path, the knobs and library modules of phases 4, 6 and
    # 11. fps_prefix=False: FPS over SA1's, SA2's and SA3's FPS-ordered
    # centres and over the seeds must give back their prefixes.
    sa3_xyz = sa2_xyz[:, :512].contiguous()
    for what, pts, npoint in (("sa2 fps_prefix=False ", sa1_xyz.contiguous(), 1024),
                              ("sa3 fps_prefix=False ", sa2_xyz, 512),
                              ("sa4 fps_prefix=False ", sa3_xyz, 256),
                              ("seed_fps fps_prefix=False ", sa2_xyz, K)):
        _, got, r = fps_rows(dev, ops_per_s, B, False, pts, npoint, what)
        rows["fps"].append(r)
        prefix = torch.arange(npoint, dtype=torch.int32, device=dev).expand(B, -1)
        if not torch.equal(got, prefix):
            raise AssertionError(f"FPS over an FPS-ordered set at {r['shape']} is not its prefix")
    # PointnetSAModuleMSGVotes at SA1: scale 0 is SA1's ball query and gather
    # (rows above), scale 1 r 0.4 ns 128; the backward of both into the
    # packed [xyz | height] table when the input takes a gradient
    gather_bwd(f"msg sa1 ns64 ({B},{NPOINT * 64},4)->({B},{N},4)", pc,
               ball_query(0.2, 64, xyz, sa1_xyz), main=False)
    idx = bq(f"msg sa1 r0.4 ns128 ({B},{N})x{NPOINT}", 0.4, 128, xyz, sa1_xyz, main=False)
    gather(f"msg sa1 ({B},{N},4)x({B},{NPOINT},128)", pc, idx, main=False)
    gather_bwd(f"msg sa1 ns128 ({B},{NPOINT * 128},4)->({B},{N},4)", pc, idx, main=False)
    # PointnetLFPModuleMSG from SA2 (1,024 points, 256 channels) to SA1's 2,048
    idx = bq(f"lfp r0.4 ns16 ({B},1024)x{NPOINT}", 0.4, 16, sa2_xyz, sa1_xyz, main=False)
    gather(f"lfp ({B},1024,259)x({B},{NPOINT},16)", torch.cat([sa2_xyz, f256], -1), idx,
           main=False)
    gather_bwd(f"lfp ({B},{NPOINT * 16},259)->({B},1024,259)", torch.cat([sa2_xyz, f256], -1),
               idx, main=False)
    # GridConv over the votes (query_feats="vote")
    _, idx = three_nn(grid_queries(votes, False, 5), votes.contiguous())
    gather(f"grid_conv query_feats=vote ({B},1024,259)x({B},{K * 64},3)",
           torch.cat([votes, f256], -1), idx, main=False)

    # the SSL step's shapes: SA2's backward at the student's 12 scenes, and
    # SA1 at a forward's 12 clouds; off every path: SA1 on surface scenes,
    # where most balls fill and the early exit acts. Centers by FPS
    pts = torch.from_numpy(make_scenes(7, SSL_B, NPOINT)[..., :3].copy()).to(dev)
    idx = ball_query(0.4, 32, pts, pts[:, :1024].contiguous())
    gather_bwd(f"sa2 ssl ({SSL_B},{1024 * 32},131)->({SSL_B},{NPOINT},131)",
               torch.empty((SSL_B, NPOINT, 131), device=dev), idx)
    for label, pts, main in (
            (f"sa1 surface r0.2 ns64 ({B},{N})x{NPOINT}", make_surface_scenes(6, B, N), False),
            (f"sa1 ssl r0.2 ns64 ({SSL_B},{N})x{NPOINT}", make_scenes(7, SSL_B, N)[..., :3].copy(),
             True)):
        pts = torch.from_numpy(pts).to(dev)
        ctr = pts[torch.arange(pts.shape[0], device=dev)[:, None], furthest_point_sample(pts, NPOINT).long()]
        bq(label, 0.2, 64, pts, ctr, main=main)
    iou_rows(dev, ops_per_s, rows)
    lhs_rows(dev, ops_per_s, rows)
    nms_rows(dev, ops_per_s, rows, floor, nms_sweep_on)
    # ctr: SA1's centers of the SSL step's 12 clouds
    three_nn_rows(ops_per_s, rows, sa1_xyz, ctr, floor, nn_sweep_on, nn_counts_on,
                  votes.contiguous())
    three_interpolate_rows(ops_per_s, rows, sa1_xyz, ctr, ibwd_sweep_on)
    fp_no_copy(sa1_xyz)
    return rows


def grid_queries(seeds: torch.Tensor, jitter: bool, seed: int) -> torch.Tensor:
    """GridConv's queries among ``seeds`` (b, 1,024, 3): the 4 x 4 x 4 grid
    of each of K axis-aligned boxes (ScanNet's headings are 0), centred
    within N(0, 0.1) of the first K seeds, ScanNet class sizes x U(0.8,
    1.2); with ``jitter`` also each box's jittered copy
    (``forward_with_pred_jitter``: center + half * N(0, 1) * 0.3, half +
    half * N(0, 1) * 0.3 clamped at 1e-8), as the training steps run
    GridConv on 2K boxes. Returns (b, K * 64 or 2K * 64, 3)."""
    rng = np.random.RandomState(seed)
    b = seeds.shape[0]
    mean = get_config("scannet").mean_size_arr
    half = mean[rng.randint(0, len(mean), (b, K))] * rng.uniform(0.8, 1.2, (b, K, 3)) / 2
    center = seeds[:, :K].cpu().numpy() + rng.normal(0, 0.1, (b, K, 3))
    if jitter:
        center = np.concatenate([center, center + half * rng.randn(b, K, 3) * 0.3], 1)
        half = np.concatenate([half, np.maximum(half + half * rng.randn(b, K, 3) * 0.3, 1e-8)], 1)
    grid = center[:, :, None] + grid_conv._grid_offsets()[None, None] * half[:, :, None]
    return torch.from_numpy(grid.reshape(b, -1, 3).astype(np.float32)).to(seeds.device)


def nn_sweep(label, args, want):
    """Every (S, Q) of NN_LAUNCHES on one three_nn input, each checked equal
    to the plain result; times only, nothing counted."""
    rows = []
    for launch in map(NnLaunch._make, NN_LAUNCHES):
        ok = same(three_nn(*args, launch), want)
        ms = cuda_ms(lambda: three_nn(*args, launch), 5, 5)
        rows.append({"plan": list(launch), "blocks": launch.blocks(*args[0].shape[:2]), "ok": ok,
                     "ms": ms})
        if not ok:
            raise AssertionError(f"three_nn at {label} with {launch} differs from its plain version")
    say(phase="nn_sweep", shape=label, rows=rows)


def nn_counts(label, args, want, plan) -> dict:
    """csrc/three_nn.cu built with -DTHREE_NN_COUNTS, on one input with a
    thread a query (S = Q = 1) and with ``plan``: each launch's results
    equal to the plain version's, and its counters over the second of two
    launches, as means a warp (the warps as a total). Times only: the
    counters add a vote to every group step."""
    lib = _build.build_variant("three_nn", "THREE_NN_COUNTS")
    fn, read = lib.three_nn_launch, lib.three_nn_counts_read
    fn.argtypes = [_build.VP] * 4 + [_build.INT] * 5 + [_build.VP]
    read.argtypes = [_build.VP]
    unknown, known = args
    b, n, m = unknown.shape[0], unknown.shape[1], known.shape[1]
    out = {}
    for name, launch in (("thread_a_query", NnLaunch(1, 1)), ("plan", plan)):
        dist = torch.empty((b, n, 3), device=unknown.device)
        idx = torch.empty((b, n, 3), dtype=torch.int32, device=unknown.device)
        counts = np.zeros(len(NN_COUNTS), np.uint64)
        for _ in range(2):
            _build.check(read(counts.ctypes.data), "three_nn_counts_read")  # zeroes them
            _build.check(fn(unknown.data_ptr(), known.data_ptr(), dist.data_ptr(), idx.data_ptr(),
                            b, n, m, *launch, _build.stream(unknown)), "three_nn with THREE_NN_COUNTS")
            torch.cuda.synchronize()
        _build.check(read(counts.ctypes.data), "three_nn_counts_read")
        if not same((dist, idx), want):
            raise AssertionError(f"the THREE_NN_COUNTS build at {label} with {launch} differs")
        warps = int(counts[0])
        per = {k: float(v) / warps for k, v in zip(NN_COUNTS[1:], counts[1:])}
        per["insert_share"] = per["insert_steps"] / max(per["group_steps"], 1.0)
        out[name] = {"plan": list(launch), "warps": warps, "per_warp": per}
    say(phase="nn_counts", shape=label, **out)
    return out


def three_nn_rows(ops_per_s, rows, sa1_8, sa1_12, floor: float, sweep_on: bool = False,
                  counts_on: bool = False, votes=None):
    """three_nn at every shape the paths launch it at: GridConv's queries
    among the 1,024 seeds of B scenes (serving, K boxes) and of B and SSL_B
    scenes (the pretrain and SSL steps, 2K boxes with the jittered copies),
    FP1 (512 x 256) and FP2 (1,024 x 512) at B and SSL_B scenes, the seeds
    and FP inputs the FPS-ordered prefixes of SA1's centers ``sa1_8`` (B,
    NPOINT, 3) and ``sa1_12`` (SSL_B, NPOINT, 3), as SA2-SA4 take them.
    Indices and distances bit for bit the plain version's. The bound counts
    the queries, the seeds and the outputs once, and (m + 3) PAIR_OPS a
    query; library_ms is None, as no one PyTorch call computes the function
    exactly, and the yardstick NN_YARDSTICK is timed beside it. Each row
    names its plan (S, Q) and carries the launch floor ``floor``. With
    ``votes`` (B, 1,024, 3), also GridConv's serving queries among them
    (``query_feats="vote"``, off the default path)."""
    n_sm = torch.cuda.get_device_properties(sa1_8.device).multi_processor_count

    def one(label, unknown, known, main=True):
        b, n, m = unknown.shape[0], unknown.shape[1], known.shape[1]
        nbytes = (b * n * 3 + b * m * 3) * 4 + b * n * 3 * (4 + 4)
        got, r = check_kernel("three_nn", label, three_nn, three_nn_plain, None, (unknown, known),
                              nbytes, lambda _: b * n * (m + 3) * PAIR_OPS, ops_per_s, 5,
                              main=main)
        plan = three_nn_plan(b, n, m, n_sm)
        r["plan"], r["blocks"], r["launch_floor_ms"] = list(plan), plan.blocks(b, n), floor
        r["pairs"] = b * n * m
        r["bytes_bound_ms"] = nbytes / HBM_BYTES_PER_S * 1e3
        r["ops_bound_ms"] = b * n * (m + 3) * PAIR_OPS / ops_per_s * 1e3
        r["yardstick_ms"] = cuda_ms(lambda: torch.cdist(unknown, known).topk(3, dim=2, largest=False), 5)
        r["yardstick"] = NN_YARDSTICK
        say(phase="three_nn_bound", shape=label, plan=r["plan"], blocks=r["blocks"],
            pairs=r["pairs"], ops_a_pair=PAIR_OPS, bytes_bound_ms=r["bytes_bound_ms"],
            ops_bound_ms=r["ops_bound_ms"], launch_floor_ms=floor,
            yardstick_ms=r["yardstick_ms"], yardstick=NN_YARDSTICK)
        rows.setdefault("three_nn", []).append(r)
        if sweep_on:
            nn_sweep(label, (unknown, known), got)
        if counts_on:
            r["counts"] = nn_counts(label, (unknown, known), got, plan)

    for pts, jitter, what in ((sa1_8, False, "serving"), (sa1_8, True, "pretrain"),
                              (sa1_12, True, "ssl")):
        seeds = pts[:, :1024].contiguous()
        grid = grid_queries(seeds, jitter, 60 + len(what))
        one(f"grid_conv {what} ({pts.shape[0]},{grid.shape[1]})x1024", grid, seeds)
    for pts in (sa1_8, sa1_12):
        b = pts.shape[0]
        one(f"fp1 ({b},512)x256", pts[:, :512].contiguous(), pts[:, :256].contiguous())
        one(f"fp2 ({b},1024)x512", pts[:, :1024].contiguous(), pts[:, :512].contiguous())
    if votes is not None:
        grid = grid_queries(votes, False, 60 + len("serving"))
        one(f"grid_conv query_feats=vote ({votes.shape[0]},{grid.shape[1]})x1024 votes", grid,
            votes, main=False)


def three_interpolate_rows(ops_per_s, rows, sa1_8, sa1_12, sweep_on: bool = False):
    """three_interpolate's forward and backward at FP1 ((B, 256, 256) onto
    512 queries) and FP2 ((B, 512, 256) onto 1,024) of B and SSL_B scenes,
    the queries and known points the FPS-ordered prefixes of SA1's centres
    as SA2-SA4 give them, the indices and weights FP's (three_nn, inverse
    distances normalised), the features, the skip features and the
    cotangent N(0, 1). The forward, as FP runs it, writes [interpolated |
    skip] (256 + 256 channels); without the skip (off the path, the
    function JAX's three_interpolate computes) it is timed beside
    ``embedding_bag``. Both are
    held to the plain version bit for bit (the sign of zeros included). The
    backward reads the interpolated columns of a (B, n, 512) cotangent in
    place, as FP's gradient gives them, and is held bit for bit to the plain
    version run on the CPU on the same inputs, to itself over a second run,
    and, as the plain version on the card, within 1e-5 x (the sum of |g w|
    added into each element) of an f64 sum. Bounds count the rows the
    indices name, the indices, the weights, the skip rows and the output
    once (forward), and the cotangent's columns, the indices, the weights
    and the output once (backward). library_ms: the forward's
    ``embedding_bag`` over the flattened table with per-sample weights, the
    fused forward's null (INTERP_FUSED_NO_LIBRARY), the backward's
    ``index_add_`` of the precomputed g w rows. Beside them, what FP ran
    without the fusion: the forward without skip then ``torch.cat``
    (``unfused_ms``), and ``g.contiguous()`` before the backward
    (``contiguous_ms``). With ``sweep_on``, the backward at every launch of
    IBWD_SWEEP the kernel takes."""
    dev = sa1_8.device
    gen = torch.Generator(device=dev).manual_seed(17)
    c = 256
    n_sm = torch.cuda.get_device_properties(dev).multi_processor_count
    for pts in (sa1_8, sa1_12):
        b = pts.shape[0]
        for name, n, m in (("fp1", 512, 256), ("fp2", 1024, 512)):
            unknown, known = pts[:, :n].contiguous(), pts[:, :m].contiguous()
            dist, idx = three_nn(unknown, known)
            recip = 1.0 / (dist + 1e-8)
            w = (recip / recip.sum(dim=2, keepdim=True)).contiguous()
            f = torch.randn((b, m, c), generator=gen, device=dev)
            skip = torch.randn((b, n, c), generator=gen, device=dev)
            rows_read = sum(int(torch.unique(idx[i].long()).numel()) for i in range(b))
            bits = lambda got, want: torch.equal(got.view(torch.int32), want.view(torch.int32))  # noqa: E731
            flat = (idx.long() + m * torch.arange(b, device=dev)[:, None, None]).reshape(-1, 3)
            table, per_sample = f.view(-1, c), w.view(-1, 3)
            bag = lambda *_: F.embedding_bag(flat, table, per_sample_weights=per_sample,  # noqa: E731
                                             mode="sum")
            nbytes = rows_read * c * 4 + 2 * b * n * 3 * 4 + b * n * c * 4
            _, r = check_kernel(
                "three_interpolate", f"{name} ({b},{m},{c})->({b},{n},{c})", three_interpolate,
                three_interpolate_plain, bag, (f, idx, w), nbytes,
                lambda _: b * n * c * INTERP_OPS, ops_per_s, 10, main=False, agree=bits)
            r["library"] = "embedding_bag(mode='sum', per_sample_weights=w)"
            r["library_err"] = max_err(bag().view(b, n, c), three_interpolate_plain(f, idx, w))
            rows.setdefault("three_interpolate", []).append(r)
            nbytes += b * n * c * 4 * 2  # the skip rows read, and written after the interpolation
            _, r = check_kernel(
                "three_interpolate", f"{name} +skip ({b},{m},{c})+({b},{n},{c})->({b},{n},{2 * c})",
                three_interpolate, three_interpolate_plain, None, (f, idx, w, skip), nbytes,
                lambda _: b * n * c * INTERP_OPS, ops_per_s, 10, agree=bits)
            r["library_null"] = INTERP_FUSED_NO_LIBRARY
            # what FP ran before the kernel wrote the skip: the interpolation, then a cat
            r["unfused_ms"] = cuda_ms(lambda: torch.cat([three_interpolate(f, idx, w), skip], -1), 10)
            rows.setdefault("three_interpolate", []).append(r)

            g = torch.randn((b, n, 2 * c), generator=gen, device=dev)[..., :c]  # FP's cotangent
            cpu = three_interpolate_backward_plain(g.cpu(), idx.cpu(), w.cpu(), m)
            gw = (g[:, :, None, :] * w[..., None]).reshape(-1, c)
            ref = torch.zeros(b * m, c, dtype=torch.float64, device=dev).index_add_(
                0, flat.reshape(-1), gw.double())
            mag = torch.zeros(b * m, c, dtype=torch.float64, device=dev).index_add_(
                0, flat.reshape(-1), gw.double().abs())
            errs = []

            def agree(got, want, launch=None):
                offs = [(t.double().reshape(b * m, c) - ref).abs() for t in (got, want)]
                errs.extend(float(o.max()) for o in offs)
                again = three_interpolate_backward(g, idx, w, m, launch)
                return (bits(got.cpu(), cpu) and bits(again, got)
                        and all(bool((o <= 1e-5 * mag).all()) for o in offs))

            out = torch.zeros(b * m, c, device=dev)
            library = lambda *_: out.zero_().index_add_(0, flat.reshape(-1), gw)  # noqa: E731
            nbytes = (b * n * c + 2 * b * n * 3 + b * m * c) * 4
            label = f"{name} ({b},{n},{c})->({b},{m},{c})"
            got, r = check_kernel(
                "three_interpolate_bwd", label, three_interpolate_backward,
                three_interpolate_backward_plain, library, (g, idx, w, m), nbytes,
                lambda _: b * n * 3 * c * INTERP_BWD_OPS, ops_per_s, 10, agree=agree)
            r["max_abs_err_f64"] = {"kernel": errs[0], "plain": errs[1]}
            r["bit_for_bit_cpu"] = r["repeatable"] = True  # agree held both
            r["g_strides"] = list(g.stride())
            r["contiguous_ms"] = cuda_ms(lambda: g.contiguous(), 10)  # the copy it reads g without
            r["plan"] = list(interp_bwd_plan(b, n, m, c, n_sm))
            r["blocks"] = InterpBwdLaunch(*r["plan"]).blocks(b)
            rows.setdefault("three_interpolate_bwd", []).append(r)
            if sweep_on:
                ibwd_sweep(label, (g, idx, w, m), lambda t, launch: agree(t, got, launch))


def ibwd_sweep(label, args, agree):
    """The backward at every (ranges, slices) of IBWD_SWEEP the kernel takes
    at this shape, each held to the CPU plain version bit for bit and to a
    second run; times only, nothing counted."""
    g, _, _, m = args
    b, c = g.shape[0], g.shape[2]
    rows = []
    for launch in map(InterpBwdLaunch._make, IBWD_SWEEP):
        try:
            check_interp_bwd_launch(launch, m, c)
        except ValueError:  # a launch the kernel does not take at this shape
            continue
        ok = bool(agree(three_interpolate_backward(*args, launch), launch))
        ms = cuda_ms(lambda: three_interpolate_backward(*args, launch), 10, 5)
        rows.append({"plan": list(launch), "blocks": launch.blocks(b), "ok": ok, "ms": ms})
        if not ok:
            raise AssertionError(f"three_interpolate backward at {label} with {launch} differs")
    say(phase="ibwd_sweep", shape=label, rows=rows)


def fp_no_copy(sa1_8):
    """FP1 and FP2 as the backbone runs them (train mode, 8 scenes, the
    known points and queries prefixes of SA1's centres, 256 + 256 channels)
    forward and backward under torch.profiler: no ``aten::cat`` nor copy
    (``aten::copy_``, ``aten::clone``), and no concatenation or copy kernel
    (``CatArrayBatchedCopy``, ``direct_copy_kernel``) on the card; the
    interpolation's kernels once each. Returns each module's CUDA kernels
    by name and count."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    dev = sa1_8.device
    gen = torch.Generator(device=dev).manual_seed(18)
    out = {}
    for name, n, m in (("fp1", 512, 256), ("fp2", 1024, 512)):
        fp = pointnet2.PointnetFPModule((512, 256, 256), torch.Generator().manual_seed(0)).to(dev)
        fp.train()
        set_bn_momentum(fp, 0.5)
        b = sa1_8.shape[0]
        known_feats = torch.randn((b, m, 256), generator=gen, device=dev, requires_grad=True)
        # the skip features an SA layer's output, as in the backbone: not a
        # leaf, whose gradient autograd would copy into the leaf's layout
        src = torch.randn((b, n, 256), generator=gen, device=dev, requires_grad=True)
        args = (sa1_8[:, :n].contiguous(), sa1_8[:, :m].contiguous(), src * 2.0, known_feats)
        fp(*args).sum().backward()  # warm
        torch.cuda.synchronize()
        known_feats.grad = src.grad = None
        args = args[:2] + (src * 2.0,) + args[3:]
        launches = (three_interpolate.launches, three_interpolate_backward.launches)
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            fp(*args).sum().backward()
            torch.cuda.synchronize()
        counts = (three_interpolate.launches - launches[0],
                  three_interpolate_backward.launches - launches[1])
        ops = prof.key_averages()
        host = {e.key: e.count for e in ops if e.device_type == DeviceType.CPU}
        kern = {e.key[:90]: e.count for e in ops if e.device_type == DeviceType.CUDA}
        copies = {k: v for k, v in host.items() if k in ("aten::cat", "aten::copy_", "aten::clone")}
        copy_kernels = {k: v for k, v in kern.items()
                        if "CatArrayBatchedCopy" in k or "direct_copy_kernel" in k}
        out[name] = {"kernels": kern, "copies": copies, "copy_kernels": copy_kernels,
                     "launches": counts}
        say(phase="fp_no_copy", module=name, **out[name])
        if copies or copy_kernels or counts != (1, 1):
            raise AssertionError(f"{name} concatenates or copies, or misses its kernels: "
                                 f"{copies} {copy_kernels} {counts}")
    return out


@contextlib.contextmanager
def plain_watch(what: str):
    """Counts the calls of three_interpolate's plain versions on CUDA tensors
    while the context lasts, and raises at its end if there was any: on the
    card the main path runs the kernels, and nothing falls back. The
    module's functions are wrapped, not changed: the autograd Function
    reaches them by name."""
    names = ("three_interpolate_plain", "three_interpolate_backward_plain")
    real = {n: getattr(interpolate_mod, n) for n in names}
    calls = dict.fromkeys(names, 0)

    def wrap(name):
        def counted(t, *args, **kw):
            calls[name] += t.is_cuda
            return real[name](t, *args, **kw)
        return counted

    for n in names:
        setattr(interpolate_mod, n, wrap(n))
    try:
        yield calls
    finally:
        for n, f in real.items():
            setattr(interpolate_mod, n, f)
    if any(calls.values()):
        raise AssertionError(f"{what}: three_interpolate's plain versions ran on the card: {calls}")


def make_boxes(rng, b: int, n: int, rotated: bool, cfg=None) -> np.ndarray:
    """(b, n, 7) boxes of ScanNet's (or ``cfg``'s) classes inside the room:
    sizes from the class means x U(0.8, 1.2), headings uniform when
    ``rotated`` (SUN RGB-D has them), else 0."""
    mean = (cfg or get_config("scannet")).mean_size_arr
    size = mean[rng.randint(0, len(mean), (b, n))] * rng.uniform(0.8, 1.2, (b, n, 3))
    center = np.stack([rng.uniform(-3, 3, (b, n)), rng.uniform(-3, 3, (b, n)),
                       size[..., 2] / 2 + rng.uniform(0, 0.5, (b, n))], -1)
    heading = rng.uniform(-np.pi, np.pi, (b, n)) if rotated else np.zeros((b, n))
    return np.concatenate([center, size, heading[..., None]], -1).astype(np.float32)


def iou_ops(a: torch.Tensor, b: torch.Tensor) -> tuple:
    """(operations the 3D IoU of the pairs of a (B, K, 7) x (B, G, 7) needs,
    those of the full work for every pair, pairs that need it)."""
    rows, cols = a[:, :, None], b[:, None]
    px, py, valid = bev_candidates(*torch.broadcast_tensors(rows, cols))
    cnt = valid.sum(-1).double()
    if bool((cnt[pairs_apart(rows, cols, "overlap_bev")] > 0).any()):
        raise AssertionError("an IoU pair the reject test drops has candidate vertices")
    need = ~pairs_apart(rows, cols, "iou3d")  # the z overlap too: without it the 3D IoU is 0
    hits = (need & (cnt > 0)).double()
    hit_ops = float((hits * (IOU_HIT_OPS + IOU_VERTEX_OPS * cnt
                             + cnt * torch.ceil(torch.log2(cnt.clamp(min=1))))).sum())
    n_boxes, n_pairs = a.shape[0] * (a.shape[1] + b.shape[1]), cnt.numel()
    ops = n_boxes * IOU_BOX_OPS + n_pairs * IOU_REJECT_OPS + int(need.sum()) * IOU_PAIR_OPS + hit_ops
    all_hits = float(((cnt > 0) * (IOU_HIT_OPS + IOU_VERTEX_OPS * cnt)).sum()
                     + (cnt * torch.ceil(torch.log2(cnt.clamp(min=1)))).sum())
    scan_ops = n_pairs * (88 + IOU_PAIR_OPS) + all_hits
    return ops, scan_ops, int(need.sum())


def iou_rows(dev, ops_per_s, rows):
    """The rotated IoU at the pretrain step's shape, (B, K, 7) proposals x
    (B, G, 7) GT slots: 8-16 real GT boxes a scene, the other slots at the
    -1000 placeholder, and the proposals jittered copies of the real GT
    boxes, the rest random boxes in the room; axis-aligned as ScanNet's (the
    step's shape), then rotated, off the step's path. Within atol 1e-5 of
    the plain version. The bound counts what the function needs
    (``iou_ops``); scan_bound_ms the kernel's full work for every pair."""
    for label, rotated, main in (("pretrain axis-aligned", False, True),
                                 ("rotated headings", True, False)):
        rng = np.random.RandomState(30 + rotated)
        gt = make_boxes(rng, B, G, rotated)
        pred = make_boxes(rng, B, K, rotated)
        for i in range(B):
            m = rng.randint(8, 17)
            gt[i, m:, 0:3] = -1000.0
            pred[i, :m] = gt[i, :m]
            pred[i, :m, 0:3] += rng.normal(0, 0.1, (m, 3))
            pred[i, :m, 3:6] *= rng.uniform(0.8, 1.2, (m, 3))
        a, b = torch.from_numpy(pred).to(dev), torch.from_numpy(gt).to(dev)
        ops, scan_ops, need = iou_ops(a, b)
        nbytes = (a.numel() + b.numel() + B * K * G) * 4
        _, r = check_kernel(
            "iou3d", f"{label} ({B},{K},7)x({B},{G},7)", box_pairs, box_pairs_plain, None,
            (a, b, "iou3d"), nbytes, lambda _: ops, ops_per_s, 10,
            main=main, agree=lambda got, want: bool(torch.allclose(got, want, rtol=0, atol=1e-5)))
        r["pairs_needing_overlap"] = need
        r["scan_bound_ms"] = max(nbytes / HBM_BYTES_PER_S, scan_ops / ops_per_s) * 1e3
        say(phase="iou_bound", shape=r["shape"], pairs=B * K * G, pairs_needing_overlap=need,
            scan_bound_ms=r["scan_bound_ms"])
        rows.setdefault("iou3d", []).append(r)


def make_lhs_input(seed: int, b: int, k: int, cfg=None, skew: float = 0.0) -> tuple:
    """LHS's input at the SSL step's shape: (b, k) axis-aligned bounds of
    boxes of ScanNet's (or ``cfg``'s) classes in the room, half of them
    copies of others moved by N(0, 0.1) m with the same class, as a
    teacher's clusters of near-duplicate proposals; scores uniform. With
    ``skew`` > 0 each box's class is redrawn as class 2 (ScanNet's chair)
    with that probability, before the copies take their sources' classes."""
    cfg = cfg or get_config("scannet")
    rng = np.random.RandomState(seed)
    box = make_boxes(rng, b, k, False, cfg)
    cls = rng.randint(0, cfg.num_class, (b, k))
    if skew:
        cls = np.where(rng.rand(b, k) < skew, 2, cls)
    src = np.where(rng.rand(b, k) < 0.5, rng.randint(0, k, (b, k)), np.arange(k))
    box = np.take_along_axis(box, src[..., None], 1)
    box[..., 0:3] += rng.normal(0, 0.1, (b, k, 3))
    cls = np.take_along_axis(cls, src, 1)
    mins, maxs = box[..., 0:3] - box[..., 3:6] / 2, box[..., 0:3] + box[..., 3:6] / 2
    return (mins.astype(np.float32), maxs.astype(np.float32),
            rng.rand(b, k).astype(np.float32), cls.astype(np.int64))


def lhs_work(mins, maxs, scores, cls, thresh: float) -> tuple:
    """Replays LHS's rounds on these (B, K) boxes on the host, with the
    plain version's float32 IoU, until no box remains. Returns (keep mask,
    rounds, suppressed boxes, box-rounds: the boxes still remaining summed
    over the rounds, rank pairs: each cluster's size squared summed over
    the rounds, the most rounds of one scene)."""
    mins, maxs, scores, cls = (x.cpu() for x in (mins, maxs, scores, cls))
    thresh = float(np.float32(thresh))
    iou = samecls_iou_aabb(mins, maxs, cls)
    keep = torch.zeros(scores.shape, dtype=torch.bool)
    rounds = suppressed = box_rounds = rank_pairs = most = 0
    for s in range(scores.shape[0]):
        sc, left = scores[s].tolist(), list(range(scores.shape[1]))
        before = rounds
        while left:
            w = max(left, key=lambda i: (sc[i], i))  # ties to the higher index
            supp = [i for i in left if i != w and float(iou[s, w, i]) > thresh]
            for i in supp:  # its rank: the cluster boxes of a higher (score, index)
                keep[s, i] = sum((sc[j], j) > (sc[i], i) for j in supp) < len(supp) // 2
            keep[s, w] = True
            rounds, suppressed = rounds + 1, suppressed + len(supp)
            box_rounds, rank_pairs = box_rounds + len(left), rank_pairs + len(supp) ** 2
            left = [i for i in left if i != w and i not in supp]
        most = max(most, rounds - before)
    return keep, rounds, suppressed, box_rounds, rank_pairs, most


def lhs_rows(dev, ops_per_s, rows, thresh: float = 0.25, cfg=None, seed: int = 40,
             what: str = "", main: bool = True):
    """LHS at the SSL step's (8, 64) boxes (``make_lhs_input``, of ``cfg``'s
    classes): equal to the plain version. The bound counts the work this
    input needs, from a replay of its rounds (``lhs_work``, itself held to
    the kernel's keep mask), and each input byte and output byte once.
    ns_per_round is the kernel's time over the most rounds of one scene, as
    the scenes run in parallel (the launch and the sort included)."""
    b, k = SSL_NU, unlabeled.MAX_NUM_OBJ
    args = [torch.from_numpy(x).to(dev) for x in make_lhs_input(seed, b, k, cfg)] + [thresh]
    replay, nrounds, nsupp, box_rounds, rank_pairs, most = lhs_work(*args)
    ops = b * k * LHS_BOX_OPS + box_rounds * LHS_ROUND_OPS + rank_pairs * LHS_RANK_OPS
    nbytes = b * k * (7 * 4 + 8 + 1)  # bounds and score f32, int64 class, bool keep
    got, r = check_kernel("lhs", f"{what}({b},{k}) boxes, IoU > {thresh}", lhs_3d_samecls,
                          lhs_3d_samecls_plain, None, args, nbytes, lambda _: ops, ops_per_s, 10,
                          main=main)
    if not torch.equal(got.cpu(), replay):
        raise AssertionError("LHS's host replay keeps other boxes than the kernel")
    r.update(rounds=nrounds, most_rounds_a_scene=most, suppressed=nsupp, box_rounds=box_rounds,
             rank_pairs=rank_pairs, kept=int(got.sum()),
             path="bit matrix" if k <= SMALL_BOXES else "a thread a box",
             ns_per_round=r["ms"] * 1e6 / most)
    say(phase="lhs_work", shape=r["shape"], rounds=nrounds, most_rounds_a_scene=most,
        suppressed=nsupp, box_rounds=box_rounds, rank_pairs=rank_pairs, ops=ops, kept=r["kept"],
        path=r["path"], ns_per_round=r["ns_per_round"])
    r["phases"] = lhs_phases(dev, args, thresh)
    rows.setdefault("lhs", []).append(r)


def nms_pairs(over: torch.Tensor, scores: torch.Tensor, higher_index_first: bool,
              cls=None) -> int:
    """The overlaps greedy NMS needs on these inputs: each round's winner
    against the boxes still remaining after it, summed over the rounds and
    scenes, from a replay of the rounds on the host with the plain
    version's suppression matrix ``over`` (B, K, K) and its pick order.
    With ``cls`` (B, K) (class-aware NMS at thresh >= 0) only the remaining
    boxes of the winner's class: the class gate makes every other pair 0,
    which suppresses nothing, so the function needs none of them."""
    over, scores = over.cpu().numpy(), scores.cpu()
    cls = None if cls is None else cls.cpu().numpy()
    total = 0
    for s in range(scores.shape[0]):
        sc = scores[s].tolist()
        order = sorted(range(len(sc)), key=lambda i: (sc[i], i if higher_index_first else -i),
                       reverse=True)
        left = np.array(order, np.int64)
        while left.size:
            w, rest = left[0], left[1:]
            total += rest.size if cls is None else int((cls[s, rest] == cls[s, w]).sum())
            left = rest[~over[s, w, rest]]
    return int(total)


def nms_row(dev, ops_per_s, rows, floor: float, label: str, mode: str, tensors, thresh: float,
            main: bool, sweep_on: bool = False):
    """One row of ``nms_rows``: the kernel against its plain version on
    ``tensors`` (mins, maxs, scores, classes; in matrix mode the boxes
    (B, K, 7) in place of mins), its bound from a replay of the rounds, its
    planned cluster and its cycles a step; past NMS_MAX_BOXES the global
    path, with each launch's device time in place of the last two (and the
    plain version, K rounds each waiting on the card, timed 3 times)."""
    n_sm = torch.cuda.get_device_properties(dev).multi_processor_count
    f64_ratio = LANES_PER_SM / FP64_LANES_PER_SM  # float32 instructions a float64 one costs
    mins, maxs, scores, cls = tensors
    b, k = scores.shape
    if mode == "matrix":
        iou = box_pairs(mins, mins, "iou_bev")  # mins holds (B, K, 7) boxes here
        args = (iou, scores, thresh)
        kernel, plain = nms_masked, nms_masked_plain
        over = iou > torch.tensor(thresh, dtype=torch.float32)
        nbytes = b * k * k * 4 + b * k * (4 + 1)
    else:
        args = (mins, maxs, scores, cls if mode == "3d_cls" else None, None, mode, False, thresh)
        kernel, plain = nms_boxes, nms_boxes_plain
        dtype = torch.float64 if mode == "3d_cls" else torch.float32
        over = box_overlaps(mins, maxs, cls, mode, False) > torch.tensor(thresh, dtype=dtype)
        nbytes = b * k * (12 + 12 + 4 + (8 if mode == "3d_cls" else 0) + 1)
    pairs = nms_pairs(over, scores, mode != "matrix",
                      cls if mode == "3d_cls" and thresh >= 0 else None)
    scale = f64_ratio if mode == "3d_cls" else 1.0
    ops = (pairs * NMS_PAIR_OPS[mode] + b * k * NMS_AREA_OPS[mode]) * scale \
        + b * k * int(np.ceil(np.log2(max(k, 2))))
    glob = k > NMS_MAX_BOXES
    got, r = check_kernel("nms", label, kernel, plain, None, args, nbytes, lambda _: ops,
                          ops_per_s, 10, 3 if glob else REPS, main=main)
    r.update(mode=mode, pairs=pairs, kept=int(got.sum()), launch_floor_ms=floor,
             of_floor=r["ms"] / floor, plain_rounds="K masked rounds in PyTorch")
    rows.setdefault("nms", []).append(r)
    if glob:
        r.update(matrix_bytes=b * (-(-k // 64)) ** 2 * 64 * 8, split=nms_launch_split(kernel, args),
                 cycles=nms_global_phases(args, got))
        if sweep_on:
            nms_global_sweep(label, kernel, args, got, mode == "matrix")
        if mode == "3d_cls":  # the class segments: a class's boxes a scene
            sizes = [np.unique(c, return_counts=True)[1] for c in cls.cpu().numpy()]
            r.update(segments=sum(len(z) for z in sizes) / b,
                     largest_segment=int(max(z.max() for z in sizes)))
        say(phase="nms_work", shape=label, mode=mode, pairs=pairs, ops=ops, kept=r["kept"],
            of_floor=r["of_floor"], matrix_bytes=r["matrix_bytes"], split=r["split"],
            cycles=r["cycles"], segments=r.get("segments"),
            largest_segment=r.get("largest_segment"))
        return
    cluster = planned_cluster(dev, b, k, mode)
    answers = {c: nms_max_active(dev, mode, k, c) for c in NMS_CLUSTERS[1:]}
    r.update(cluster=cluster, max_active_clusters=answers)
    r["phases"] = nms_phases(args, got, cluster)
    say(phase="nms_work", shape=label, mode=mode, pairs=pairs, ops=ops, kept=r["kept"],
        of_floor=r["of_floor"], fp64_lanes_per_sm=FP64_LANES_PER_SM, sms=n_sm,
        cluster=cluster, max_active_clusters=answers, phases=r.get("phases"))
    if sweep_on:
        nms_sweep(label, kernel, args, got)


def nms_rows(dev, ops_per_s, rows, floor: float, sweep_on: bool = False):
    """Greedy NMS (csrc/nms.cu) against its plain versions, exactly: box mode
    at serving's (B, K) class-aware in float64 at IoU 0.25 (the main path's
    shape), the 3D and 2D float32 branches, tied scores, K = 256, 512 and
    1,024 (the most the cluster path takes), and matrix mode on the
    rotated BEV IoU of (B, K) boxes (nms_rotated's); past the cluster path,
    class-aware float64 and matrix mode at K = 2,048 and 4,096, and
    class-aware at 4,096 with 40 % of each scene one class (the global
    matrix). Each cluster-path row names its
    planned cluster size, the card's cudaOccupancyMaxActiveClusters answers
    it was planned from, and its cycles a step (``nms_phases``); each
    global row its device time a launch (``nms_launch_split``), and
    class-aware its segments a scene and its largest; ``sweep_on`` also
    times every cluster size, or the global path's knobs
    (``nms_global_sweep``).
    The boxes are ``make_lhs_input``'s clusters of near-duplicates. The
    bound counts each input and output byte once, the overlaps the rounds
    need (``nms_pairs``, NMS_PAIR_OPS each; class-aware, only pairs of one
    class) with each box's area, and a
    sort of the keys; its time lies under any launch's, so each row also
    gives its time over the launch floor ``floor``."""
    one = functools.partial(nms_row, dev, ops_per_s, rows, floor, sweep_on=sweep_on)

    def boxes(seed, k, tied=False, skew=0.0):
        mins, maxs, scores, cls = make_lhs_input(seed, B, k, skew=skew)
        if tied:
            scores = (np.round(scores * 4) / 4).astype(np.float32)
        return [torch.from_numpy(x).to(dev) for x in (mins, maxs, scores, cls)]

    one(f"serving ({B},{K}) 3d_cls float64, IoU > 0.25", "3d_cls", boxes(70, K), 0.25, True)
    one(f"({B},{K}) 3d float32", "3d", boxes(71, K), 0.25, False)
    one(f"({B},{K}) 2d float32 (x, z)", "2d", boxes(72, K), 0.25, False)
    one(f"({B},{K}) 3d_cls, scores on a quarter grid (ties)", "3d_cls", boxes(73, K, True), 0.25,
        False)
    one(f"({B},256) 3d_cls float64", "3d_cls", boxes(74, 256), 0.25, False)
    one(f"({B},512) 3d_cls float64", "3d_cls", boxes(77, 512), 0.25, False)
    one(f"({B},1024) 3d_cls float64", "3d_cls", boxes(78, 1024), 0.25, False)
    rot = torch.from_numpy(make_boxes(np.random.RandomState(75), B, K, True)).to(dev)
    scores = torch.from_numpy(np.random.RandomState(76).rand(B, K).astype(np.float32)).to(dev)
    one(f"matrix ({B},{K}) rotated BEV IoU, IoU > 0.1", "matrix", (rot, None, scores, None), 0.1,
        False)
    # past the cluster path: the global matrix, K 2,048 (--cluster_sampling
    # vote_fps --vote_factor 2 --num_target 2048) and 4,096
    for k, seed in ((2048, 82), (4096, 84)):
        one(f"({B},{k}) 3d_cls float64, global matrix", "3d_cls", boxes(seed, k), 0.25, False)
        rot = torch.from_numpy(make_boxes(np.random.RandomState(seed + 1), B, k, True)).to(dev)
        scores = torch.from_numpy(np.random.RandomState(seed).rand(B, k).astype(np.float32)).to(dev)
        one(f"matrix ({B},{k}) rotated BEV IoU, IoU > 0.1, global matrix", "matrix",
            (rot, None, scores, None), 0.1, False)
    # one class holding ~40 % of each scene, as chairs do in ScanNet: its
    # segment is past the cluster path's 1,024 boxes
    one(f"({B},4096) 3d_cls float64, 40 % one class, global matrix", "3d_cls",
        boxes(86, 4096, skew=0.4), 0.25, False)


NMS_KERNEL = re.compile(r"nms_(\w+?)_kernel")  # a kernel of csrc/nms.cu, by its step


def nms_launch_split(kernel, args, reps: int = 10) -> dict:
    """Device µs a call of each kernel one NMS call launches (the global
    path's steps apart), from torch.profiler's CUDA kernel records over
    ``reps`` calls, keyed by the name between ``nms_`` and ``_kernel``;
    beside them the kernels' sum and their launches a call. None where
    the profiler records no device time."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    kernel(*args)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            kernel(*args)
        torch.cuda.synchronize()
    us, count = {}, 0
    for e in prof.key_averages():
        m = NMS_KERNEL.search(e.key)
        if e.device_type == DeviceType.CUDA and m:
            us[m.group(1)] = us.get(m.group(1), 0.0) + e.self_device_time_total / reps
            count += e.count
    if not us or not sum(us.values()):
        return None
    return {"us": us, "sum_us": sum(us.values()), "launches_a_call": count / reps}


# csrc/nms.cu's NMS_STAMP 0-8: the steps between them ("order_barrier" and
# "exchange" are nearly nothing up to kLocalOrder boxes, ordered in every block)
NMS_PHASES = ("load", "order", "order_barrier", "exchange", "matrix", "matrix_barrier", "rounds",
              "write")
_variant = functools.lru_cache(maxsize=None)(_build.build_variant)  # one nvcc a variant


def nms_phases(args, want, cluster: int) -> dict:
    """Cycles of each step of csrc/nms.cu on ``args`` (the arguments of
    ``nms_boxes``, or of ``nms_masked``) with clusters of ``cluster`` blocks, from a
    build with -DNMS_PHASES, whose thread 0 of each block stamps clock64()
    at its start and after each step and counts the overlaps its rows
    computed and skipped; its keep mask must equal ``want``. Means over the
    leader blocks (rank 0: the rounds and the write) and over the others of
    the second launch; the overlaps as totals over the scenes. Times only:
    the stamps cost a few instructions."""
    lib = _variant("nms", "NMS_PHASES")
    read = lib.nms_phases_read
    read.argtypes = [_build.VP, _build.INT]
    scores = args[1] if len(args) == 3 else args[2]
    b, k = scores.shape
    keep = torch.empty((b, k), dtype=torch.bool, device=scores.device)
    if len(args) == 3:  # matrix mode
        iou, _, thresh = args
        fn = lib.nms_matrix_launch
        fn.argtypes = [_build.VP] * 4 + [_build.INT] * 2 + [_build.FLOAT, _build.INT, _build.VP]
        launch = lambda: fn(iou.data_ptr(), scores.data_ptr(), 0, keep.data_ptr(), b, k,  # noqa: E731
                            thresh, cluster, _build.stream(keep))
    else:
        mins, maxs, _, cls, _, mode, old_type, thresh = args
        fn = lib.nms_boxes_launch
        fn.argtypes = [_build.VP] * 6 + [_build.INT] * 4 + [_build.DOUBLE, _build.INT, _build.VP]
        launch = lambda: fn(mins.data_ptr(), maxs.data_ptr(), scores.data_ptr(),  # noqa: E731
                            0 if cls is None else cls.data_ptr(), 0, keep.data_ptr(), b, k,
                            NMS_MODE_IDS[mode], int(old_type), thresh, cluster,
                            _build.stream(keep))
    for _ in range(2):
        _build.check(launch(), "nms with NMS_PHASES")
    torch.cuda.synchronize()
    if not torch.equal(keep, want):
        raise AssertionError("the NMS_PHASES build keeps other boxes than the kernel")
    stamps = len(NMS_PHASES) + 1
    out = np.zeros((b * cluster, stamps + 2), np.int64)
    _build.check(read(out.ctypes.data, b * cluster), "nms_phases_read")
    steps = np.diff(out[:, :stamps], axis=1)
    leader = np.arange(b * cluster) % cluster == 0
    roles = {"leader": dict(zip(NMS_PHASES, steps[leader].mean(0).tolist()))}
    if cluster > 1:
        roles["others"] = dict(zip(NMS_PHASES[:-2], steps[~leader, :-2].mean(0).tolist()))
    return {"cluster": cluster, "cycles": roles, "overlaps_computed": int(out[:, stamps].sum()),
            "overlaps_skipped": int(out[:, stamps + 1].sum())}


def nms_global_sweep(label, kernel, args, want, matrix: bool):
    """The global path on one NMS input at every GLOBAL_TILE_BLOCKS (box
    modes) or GLOBAL_ROWS_PER_BLOCK (matrix mode) of ops/nms.py through
    ``global_run``, beside the planned launch, each checked equal to the
    plain result and to itself over two runs; times only, nothing counted."""
    from iou3dmatch_tpu_torch.ops.nms import (GLOBAL_ROWS_PER_BLOCK, GLOBAL_TILE_BLOCKS,
                                              global_blocks, global_run)

    scores = args[1] if matrix else args[2]
    n_sm = torch.cuda.get_device_properties(scores.device).multi_processor_count
    planned = global_blocks(scores.shape[0], n_sm, matrix)
    knob = "rows_per_block" if matrix else "tile_blocks"
    out = []
    for value in (GLOBAL_ROWS_PER_BLOCK if matrix else GLOBAL_TILE_BLOCKS):
        run = functools.partial(global_run, kernel, args, value)
        ok = same(run(), want) and same(run(), want)
        out.append({knob: value, "ok": ok, "ms": cuda_ms(run, 10, 5)})
        if not ok:
            raise AssertionError(f"NMS at {label} with {knob} {value} differs")
    say(phase="nms_global_sweep", shape=label, planned={knob: planned}, rows=out)


NMS_PHASE_BLOCKS = 4096  # csrc/nms.cu kPhaseBlocks
# csrc/nms.cu's global kernels under -DNMS_PHASES: the sort's SORT_STAMP
# 0-5, and the slots the tiles and the chain sum their cycles in
NMS_SORT_STEPS = ("keys_and_runs", "merges", "positions", "segments", "tile_list")
NMS_TILE_STEPS = ("tile_list_staged", "boxes", "overlaps", "wait")  # slot 4: tiles
NMS_CHAIN_STEPS = ("loads", "scan", "fold_next", "barrier")  # slot 4: words, 5: helpers, 6: segments


def nms_global_phases(args, want):
    """Cycles of the global path's steps on ``args`` (the arguments of
    ``nms_boxes``, or of ``nms_masked``) at the planned launch, from a
    build with -DNMS_PHASES launched through ``ops/nms.py::global_run``;
    its keep mask must equal ``want``. The sort's
    steps as means over the scenes; the tiles' steps summed over a block's
    tiles, means over the blocks that had tiles, with their tiles; the
    chain's steps a word (warp 0: the diagonal block's loads, the scan, the
    fold into the next word, the barrier; a helper warp's folds beside
    them), over the blocks that had segments, with the words and segments.
    None where the build has no such stamps (another checkout's csrc/nms.cu
    timed in turns). Times only: the stamps cost a few instructions."""
    lib = _variant("nms", "NMS_PHASES")
    if not hasattr(lib, "nms_global_phases_read"):
        return None
    from iou3dmatch_tpu_torch.ops.nms import global_blocks, global_run
    kernel = nms_masked if len(args) == 3 else nms_boxes
    scores = args[1] if kernel is nms_masked else args[2]
    b = scores.shape[0]
    n_sm = torch.cuda.get_device_properties(scores.device).multi_processor_count
    knob = "rows_per_block" if kernel is nms_masked else "tile_blocks"
    for _ in range(2):
        _build.check(lib.nms_global_phases_clear(), "nms_global_phases_clear")
        keep = global_run(kernel, args, lib=lib)
    torch.cuda.synchronize()
    if not torch.equal(keep, want):
        raise AssertionError("the NMS_PHASES build keeps other boxes than the kernel")
    out = np.zeros((3, NMS_PHASE_BLOCKS, 8), np.int64)
    _build.check(lib.nms_global_phases_read(out.ctypes.data), "nms_global_phases_read")
    sort = dict(zip(NMS_SORT_STEPS, np.diff(out[0, :b, :6], axis=1).mean(0).tolist()))
    res = {"plan": {knob: global_blocks(b, n_sm, kernel is nms_masked)}, "sort": sort}
    tiles = out[1][out[1][:, 4] > 0]
    if len(tiles):
        res["tiles"] = dict(zip(NMS_TILE_STEPS, tiles[:, :4].mean(0).tolist()),
                            blocks=len(tiles), tiles_a_block=float(tiles[:, 4].mean()))
    chain = out[2][out[2][:, 4] > 0]
    n_words = chain[:, 4].sum()
    res["chain_a_word"] = dict(zip(NMS_CHAIN_STEPS, (chain[:, :4].sum(0) / n_words).tolist()),
                               helper=float(chain[:, 5].sum() / n_words), words=int(n_words),
                               segments=int(chain[:, 6].sum()), blocks=len(chain))
    say(phase="nms_global_phases", shape=list(scores.shape), **res)
    return res


def nms_sweep(label, kernel, args, want):
    """Every cluster size of NMS_CLUSTERS on one NMS input, each checked
    equal to the plain result; times only, nothing counted."""
    out = []
    for cluster in NMS_CLUSTERS:
        ok = same(kernel(*args, cluster=cluster), want)
        out.append({"cluster": cluster, "ok": ok,
                    "ms": cuda_ms(lambda: kernel(*args, cluster=cluster), 10)})
        if not ok:
            raise AssertionError(f"NMS at {label} with clusters of {cluster} differs")
    say(phase="nms_sweep", shape=label, rows=out)


LHS_PHASES = ("load", "order", "matrix", "rounds", "write")  # csrc/lhs.cu's LHS_STAMP 0-5


def lhs_phases(dev, args, thresh: float) -> dict:
    """Cycles of each step of csrc/lhs.cu's bit-matrix path on ``args`` (B
    scenes), from a build with -DLHS_PHASES, whose thread 0 of each block
    stamps clock64() at its start and after each step; its keep mask must
    equal the plain version's. Means over the scenes of the second launch.
    Times only: the stamps cost the kernel a few instructions."""
    lib = _build.build_variant("lhs", "LHS_PHASES")
    fn, read = lib.lhs_launch, lib.lhs_phases_read
    fn.argtypes = [_build.VP] * 5 + [_build.INT] * 2 + [_build.FLOAT, _build.VP]
    read.argtypes = [_build.VP, _build.INT]
    b, k = args[2].shape
    keep = torch.empty((b, k), dtype=torch.bool, device=dev)
    for _ in range(2):
        _build.check(fn(*(a.data_ptr() for a in args[:4]), keep.data_ptr(), b, k, thresh,
                        _build.stream(keep)), "lhs with LHS_PHASES")
    torch.cuda.synchronize()
    if not torch.equal(keep, lhs_3d_samecls_plain(*args[:4], thresh)):
        raise AssertionError("the LHS_PHASES build keeps other boxes than the plain version")
    stamps = np.zeros((b, len(LHS_PHASES) + 1), np.int64)
    _build.check(read(stamps.ctypes.data, b), "lhs_phases_read")
    cycles = dict(zip(LHS_PHASES, np.diff(stamps, axis=1).mean(0).tolist()))
    say(phase="lhs_phases", cycles=cycles, total_cycles=sum(cycles.values()))
    return cycles


FPS_ENTRY = re.compile(r"fps_cluster_kernelILi(\d+)ELi(n?\d+)E")


def kernel_name(line: str):
    """The identifier ending in ``_kernel`` of the nested name in a line's
    mangled symbol (``_ZN``, then each identifier as its length in digits and
    its characters), with its integer and bool template arguments as
    mangled, or None."""
    m = re.search(r"_ZN(\w+)", line)
    rest = m[1] if m else ""
    while rest[:1].isdigit():
        digits = re.match(r"\d+", rest)[0]
        ident, rest = rest[len(digits):len(digits) + int(digits)], rest[len(digits) + int(digits):]
        if ident.endswith("_kernel"):
            args = re.match(r"I(?:L[ib]n?\d+E)+E", rest)
            return ident + (args[0] if args else "")
    return None


def ptxas_report(log: str) -> dict:
    """{kernel: {registers, stack, spill_stores, spill_loads}} of every entry
    function in ``nvcc -Xptxas -v`` output, the stack frame and spills in
    bytes; a kernel is named by ``kernel_name``."""
    found, entry, props = {}, None, None
    for ln in log.splitlines():
        name = kernel_name(ln)
        if "Compiling entry function" in ln:
            entry = name
        elif "Function properties for" in ln:
            props = name
        elif "spill stores" in ln and props:
            stack, st, ld = map(int, re.findall(r"(\d+) bytes (?:stack frame|spill)", ln))
            found.setdefault(props, {}).update(stack=stack, spill_stores=st, spill_loads=ld)
        elif "Used" in ln and "registers" in ln and entry:
            found.setdefault(entry, {})["registers"] = int(re.search(r"Used (\d+) registers", ln)[1])
    return {k: v for k, v in found.items() if "registers" in v}


def fps_ptxas(log: str) -> dict:
    """{(threads, ppt): (registers, spill store bytes, spill load bytes)} of
    every FPS instantiation."""
    out = {}
    for name, r in ptxas_report(log).items():
        m = FPS_ENTRY.search(name)
        if m:
            out[(int(m[1]), int(m[2].replace("n", "-")))] = (
                r["registers"], r.get("spill_stores"), r.get("spill_loads"))
    return out


# phase 4's models beside the default: the samplings --cluster_sampling reaches
FORWARD_KNOBS = ({}, {"sampling": "vote_fps"}, {"sampling": "random"})
# the knobs no driver sets; their forwards run after serving and eval, whose
# first request's host time stalled 136-168 ms when they ran before (PERF.md)
MODEL_KNOBS = ({"fps_prefix": False}, {"query_feats": "vote"}, {"query_feats": "seed+vote"})


def phase_forward(model_gpu, dev, knobs: dict, dataset: str = "scannet", pc=None):
    """The forward of the full-width model of ``dataset`` built with
    ``knobs`` on the card against the CPU on one scene (``pc``, or a room of
    ``make_scenes``): every index equal, outputs within atol and rtol 1e-3.
    ``random`` sampling takes the same given indices on both sides, drawn
    on the CPU. With ``fps_prefix=False`` FPS runs 5 times (SA1, SA2-SA4,
    ``seed_fps``) and every output equals the default model's
    (``model_gpu``) on the card bit for bit."""
    default_gpu = model_gpu
    if knobs:
        model_gpu, _ = build_votenet(dataset, device=dev, **knobs)
    model_cpu, _ = build_votenet(dataset, device="cpu", **knobs)  # same seed, same weights
    pc = torch.from_numpy(make_scenes(4, 1, N) if pc is None else pc)
    inds = {}
    if knobs.get("sampling") == "random":
        inds["sample_inds"] = torch.randint(0, 1024, (1, K), generator=torch.Generator().manual_seed(4),
                                            dtype=torch.int32)
    for fn in KERNELS.values():
        fn.launches = 0
    with torch.inference_mode():
        t = time.perf_counter()
        ep_gpu = model_gpu(pc.to(dev), **{k: v.to(dev) for k, v in inds.items()})
        torch.cuda.synchronize()
        gpu_s = time.perf_counter() - t
        t = time.perf_counter()
        ep_cpu = model_cpu(pc, **inds)
        cpu_s = time.perf_counter() - t
    launches = {k: fn.launches for k, fn in KERNELS.items()}
    for k in ("sa1_inds", "sa2_inds", "aggregated_vote_inds"):
        if not torch.equal(ep_gpu[k].cpu(), ep_cpu[k]):
            raise AssertionError(f"{k} differ between the card and the CPU ({knobs})")
    diffs = {}
    for k in ("center", "objectness_scores", "sem_cls_scores", "size_residuals", "iou_scores"):
        a, b = ep_gpu[k].cpu(), ep_cpu[k]
        diffs[k] = max_err(a, b)
        if not torch.isfinite(a).all() or not torch.allclose(a, b, rtol=1e-3, atol=1e-3):
            raise AssertionError(f"{k} differs between the card and the CPU ({knobs}): max {diffs[k]}")
    # FPS: SA1, then vote_fps, or SA2-SA4 and seed_fps without the prefix path
    fps = 1 + (knobs.get("sampling") == "vote_fps") + 4 * (knobs.get("fps_prefix") is False)
    if launches["fps"] != fps:
        raise AssertionError(f"the forward with {knobs} launched FPS {launches['fps']}, not {fps}")
    extra = {}
    if knobs.get("fps_prefix") is False:
        with torch.inference_mode():
            ep_default = default_gpu(pc.to(dev))
        differ = [k for k, v in ep_default.items() if not torch.equal(ep_gpu[k], v)]
        if differ or set(ep_default) != set(ep_gpu):
            raise AssertionError(f"fps_prefix=False differs from the prefix path on the card: {differ}")
        extra["equal_to_default_model"] = f"all {len(ep_default)} outputs bit for bit"
    say(phase="forward_vs_cpu", dataset=dataset, knobs=knobs, scenes=1, points=N, indices_equal=True,
        tol="atol 1e-3 rtol 1e-3", max_abs_diff=diffs, launches=launches, gpu_s=gpu_s,
        cpu_s=cpu_s, **extra)


def same_picks(got, want, what: str) -> float:
    """Raises unless the two parses give the same proposals, scene by scene
    in the same order, with equal classes, corners and scores (the card's
    parse takes the proposals' scores from the copied logits with NumPy);
    returns the largest relative difference of the scores, 0."""
    if [len(g) for g in got] != [len(w) for w in want]:
        raise AssertionError(f"{what}: proposals a scene {[len(g) for g in got]} against "
                             f"{[len(w) for w in want]}")
    worst = 0.0
    for s, (gs, ws) in enumerate(zip(got, want)):
        for (gc, gbox, gscore), (wc, wbox, wscore) in zip(gs, ws):
            if gc != wc or not np.array_equal(gbox, wbox):
                raise AssertionError(f"{what}: scene {s} picks otherwise ({gc} against {wc})")
            worst = max(worst, abs(float(gscore) - float(wscore)) / max(abs(float(wscore)), 1e-30))
    if worst > 0:
        raise AssertionError(f"{what}: scores off by {worst} (relative)")
    return worst


def kept_per_scene(packed: np.ndarray, num_class: int) -> list:
    """The boxes each scene's NMS kept, from ``pack_predictions``' copy."""
    return (packed[..., 26 + num_class] > 0).sum(1).tolist()


def phase_serve(model, cfg, dev) -> dict:
    """3 requests of B scenes: the eval forward, then ``parse_predictions``
    on its CUDA outputs in its two halves, each timed:
    ``pack_predictions`` (decode and IoU-guided class-aware NMS on the card,
    one copy) and ``proposal_lists`` (the per-class lists on the host).
    Each request's picks are held to the host NumPy parse of the same
    outputs (``parse_predictions_np``, the path the card replaces), which is
    timed beside it. scenes/s counts the forward and the parse of each
    request, not the checks. Then ``serve_suppression_check``."""
    forward = make_eval_forward(model)
    config = eval_config_dict(cfg, use_iou_for_nms=True)
    batches = [torch.from_numpy(make_scenes(10 + i, B, N)).to(dev) for i in range(3)]
    parse_predictions(forward(batches[0]), config)  # warm-up, not counted
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats(dev)
    for fn in KERNELS.values():
        fn.launches = 0
    request_s, old_s, outs = [], [], []
    for i, pc in enumerate(batches):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        t0 = time.perf_counter()
        start.record()
        with plain_watch(f"request {i}"):
            out = forward(pc)
        end.record()
        end.synchronize()
        t1 = time.perf_counter()
        packed = pack_predictions(out, config)
        t2 = time.perf_counter()
        picks = proposal_lists(packed, cfg.num_class, config)
        t3 = time.perf_counter()
        host = {k: v.cpu().numpy() for k, v in out.items()}
        t4 = time.perf_counter()
        want = parse_predictions_np(host, config)
        t5 = time.perf_counter()
        worst = same_picks(picks, want, f"request {i}")
        for k, v in out.items():
            if v.shape[0] != B or not torch.isfinite(v).all():
                raise AssertionError(f"request {i}: {k} has shape {tuple(v.shape)} or non-finite values")
        if out["center"].shape != (B, K, 3) or out["iou_scores"].shape != (B, K, 18):
            raise AssertionError(f"request {i}: unexpected output shapes")
        request_s.append(t3 - t0)
        old_s.append(t1 - t0 + t5 - t4)
        outs.append(out)
        say(phase="request", i=i, device_ms=start.elapsed_time(end),
            parse_ms=(t3 - t1) * 1e3, host_list_ms=(t3 - t2) * 1e3,
            decode_nms_copy_ms=(t2 - t1) * 1e3,
            host_numpy_parse_ms=(t5 - t4) * 1e3, copy_to_host_ms=(t4 - t3) * 1e3,
            same_picks_as_numpy=True, max_rel_score_diff=worst,
            boxes_kept_per_scene=kept_per_scene(packed, cfg.num_class))
    launches = {k: fn.launches for k, fn in KERNELS.items()}
    expect = {"fps": 3, "ball_query": 15, "gather": 18, "gather_bwd": 0, "iou3d": 0, "lhs": 0,
              "three_nn": 9, "nms": 3, "three_interpolate": 6, "three_interpolate_bwd": 0}
    say(phase="serve", requests=3, scenes_per_s=3 * B / sum(request_s), wall_s=sum(request_s),
        scenes_per_s_host_numpy_parse=3 * B / sum(old_s),
        max_memory_allocated=torch.cuda.max_memory_allocated(dev), launches=launches,
        launches_per_request={k: v / 3 for k, v in launches.items()})
    if launches != expect:
        raise AssertionError(f"launch counts {launches}, expected {expect}")
    serve_suppression_check(outs[0], cfg)
    phase_profile(model, forward, batches[0])
    return launches


def serve_suppression_check(out, cfg):
    """Serving's first request parsed again at IoU SERVE_CHECK_NMS_IOU in
    each NMS branch (class-aware IoU-guided, 3D, 2D), on the card and by the
    NumPy parse: the same picks, and in each branch the card's NMS drops at
    least one box of some scene. At the released 0.25 it keeps every box of
    the random model, so the picks checked above would also pass a kernel
    that kept all."""
    host = {k: v.cpu().numpy() for k, v in out.items()}
    dropped, largest = {}, {}
    for mode in ("3d_cls", "3d", "2d"):
        config = dict(eval_config_dict(cfg, use_iou_for_nms=True), nms_iou=SERVE_CHECK_NMS_IOU,
                      use_3d_nms=mode != "2d", cls_nms=mode == "3d_cls")
        packed = pack_predictions(out, config)
        same_picks(proposal_lists(packed, cfg.num_class, config), parse_predictions_np(host, config),
                   f"serving at IoU {SERVE_CHECK_NMS_IOU}, {mode}")
        dropped[mode] = [K - n for n in kept_per_scene(packed, cfg.num_class)]
        corners = decode_corners(out, cfg)
        over = box_overlaps(corners.amin(2), corners.amax(2), nms_scores(out, config)[1], mode, False)
        largest[mode] = float(over.masked_fill(torch.eye(K, dtype=torch.bool, device=over.device), 0).max())
    say(phase="serve_suppression", nms_iou=SERVE_CHECK_NMS_IOU, dropped_per_scene=dropped,
        largest_overlap_of_two_boxes=largest, same_picks_as_numpy=True)
    for mode, d in dropped.items():
        if not sum(d) > 0:
            raise AssertionError(f"the NMS dropped no box in branch {mode} at IoU {SERVE_CHECK_NMS_IOU}")


def eval_batches(model, cfg, dev) -> list:
    """3 requests of B rooms (``make_scenes``) with GT: 8-16 boxes a scene of
    ScanNet classes within 0.05 of the random model's own proposal centers
    (``make_train_batch``), so that some proposals match; on the card."""
    forward = make_eval_forward(model)
    batches = []
    for i in range(3):
        pc = make_scenes(80 + i, B, N)
        anchors = forward(torch.from_numpy(pc).to(dev))["center"].cpu().numpy()
        batch = make_train_batch(80 + i, B, cfg, anchors)
        batches.append({k: torch.from_numpy(v).to(dev) for k, v in batch.items()})
    return batches


def iou_opt_check(model, cfg, batch):
    """``iou_optimize`` on one scene on the card against the CPU from the
    same eval outputs and weights (OPT_RATE, OPT_STEP): refined center and
    size within 1e-7 + 1e-2 of the largest move the CPU made, IoU logits
    within atol 1e-3 (the forward's card-vs-CPU tolerance)."""
    labels = {k: v[:1] for k, v in batch.items() if k != "point_clouds"}
    out, _ = make_eval_loss(model, cfg)(batch["point_clouds"][:1], labels)
    got = iou_optimize(model, out, OPT_RATE, OPT_STEP)
    model_cpu, _ = build_votenet("scannet", device="cpu")  # same seed, same weights
    out_cpu = {k: v.detach().cpu() for k, v in out.items()}
    want = iou_optimize(model_cpu, out_cpu, OPT_RATE, OPT_STEP)
    moved = max(float((want[k] - out_cpu[k]).abs().max()) for k in ("center", "size"))
    diffs = {k: max_err(got[k].detach().cpu(), want[k].detach()) for k in
             ("center", "size", "size_residuals", "iou_scores")}
    tol = 1e-7 + 1e-2 * moved
    say(phase="iou_opt_vs_cpu", scenes=1, opt_rate=OPT_RATE, opt_step=OPT_STEP,
        largest_move=moved, max_abs_diff=diffs,
        tol=f"center, size, size_residuals within 1e-7 + 1e-2 x the largest move ({tol}); "
            "iou_scores within 1e-3")
    if not moved > 0:
        raise AssertionError("iou_optimize moved no box on the CPU")
    if max(diffs["center"], diffs["size"], diffs["size_residuals"]) > tol or diffs["iou_scores"] > 1e-3:
        raise AssertionError(f"iou_optimize differs between the card and the CPU: {diffs}")


def phase_eval(model, cfg, dev) -> dict:
    """``cli/common.py::evaluate`` as run_eval.sh and run_eval_opt.sh run it:
    3 requests of B scenes x N points with GT (``eval_batches``), IoU-guided
    class-aware NMS on the card, AP at 0.25 and 0.5; once without and once
    with test-time IoU optimisation (OPT_STEP at OPT_RATE). ``evaluate``
    runs with the kernels' counts set to 0 before it and read after it;
    then the same requests go through evaluate's parts in a plain loop,
    each part timed (``eval_loss``, ``iou_optimize``, ``pack_predictions``,
    ``proposal_lists``, AP), each request's parse held to the host NumPy
    parse of the same outputs, and the mAP and AR of the loop's card parse
    equal (within 1e-12) to those of the NumPy parse and to evaluate's.
    Launches a request: FPS 1, ball query 5, NMS 1, the IoU 1 (the eval
    loss's IoU labels); the gather 6 and three_nn 3 without the
    optimisation, 6 + 12 and 3 + 12 with it (11 ascent steps and one last
    forward of GridConv); the gather's backward never. Returns each run's
    launches."""
    config = eval_config_dict(cfg, use_iou_for_nms=True)
    batches = eval_batches(model, cfg, dev)
    iou_opt_check(model, cfg, batches[0])
    gts = [parse_groundtruths(b, config) for b in batches]
    labels = [{k: v for k, v in b.items() if k != "point_clouds"} for b in batches]
    eval_loss = make_eval_loss(model, cfg)
    results = {}
    for opt_step in (0, OPT_STEP):
        rate = OPT_RATE if opt_step else 0.0
        out, _ = eval_loss(batches[0]["point_clouds"], labels[0])  # warm-up, not counted
        if opt_step:
            iou_optimize(model, out, rate, opt_step)
        torch.cuda.synchronize()
        for fn in KERNELS.values():
            fn.launches = 0
        t = time.perf_counter()
        means, ap, map_sum = cli_common.evaluate(model, cfg, batches, config, lambda _: None,
                                                 eval_loss, opt_rate=rate, opt_step=opt_step)
        evaluate_s = time.perf_counter() - t
        launches = {k: fn.launches for k, fn in KERNELS.items()}

        ms = {k: [] for k in ("forward", "iou_opt", "decode_nms_copy", "host_lists",
                              "host_numpy_parse", "ap")}
        calcs = {(src, t): APCalculator(t, cfg.class2type) for src in ("card", "host")
                 for t in (0.25, 0.5)}
        worst = []
        for i, (batch, gt) in enumerate(zip(batches, gts)):
            t0 = time.perf_counter()
            out, _ = eval_loss(batch["point_clouds"], labels[i])
            torch.cuda.synchronize()
            t1 = time.perf_counter()
            if opt_step:
                out = iou_optimize(model, out, rate, opt_step)
                torch.cuda.synchronize()
            t2 = time.perf_counter()
            packed = pack_predictions(out, config)
            t3 = time.perf_counter()
            picks = proposal_lists(packed, cfg.num_class, config)
            t4 = time.perf_counter()
            host = {k: v.detach().cpu().numpy() for k, v in out.items()}
            t5 = time.perf_counter()
            want = parse_predictions_np(host, config)
            t6 = time.perf_counter()
            worst.append(same_picks(picks, want, f"eval request {i}"))
            for (src, _), calc in calcs.items():
                calc.step(picks if src == "card" else want, gt)
            for k, dt in (("forward", t1 - t0), ("iou_opt", t2 - t1), ("decode_nms_copy", t3 - t2),
                          ("host_lists", t4 - t3), ("host_numpy_parse", t6 - t5)):
                ms[k].append(dt * 1e3)
        metrics = {}
        for key, calc in calcs.items():
            t = time.perf_counter()
            metrics[key] = calc.compute_metrics()
            if key[0] == "card":
                ms["ap"].append((time.perf_counter() - t) * 1e3)
        scores = {t: {"mAP": float(ap[t]["mAP"]), "AR": float(ap[t]["AR"]),
                      **{f"{m}_{src}": float(metrics[src, t][m]) for src in ("card", "host")
                         for m in ("mAP", "AR")}} for t in ap}
        say(phase="eval", opt_step=opt_step, opt_rate=rate, requests=3, scenes=B, points=N,
            evaluate_ms_per_request=evaluate_s * 1e3 / 3, ms=ms, max_rel_score_diff=max(worst),
            ap=scores, ap_of="evaluate; _card: the loop's card parse; _host: its NumPy parse",
            map_sum=float(map_sum), loss=means.get("loss"), launches=launches,
            launches_per_request={k: v / 3 for k, v in launches.items()})
        for t, m in scores.items():
            for key in ("mAP", "AR"):
                if not (abs(m[key] - m[f"{key}_card"]) <= 1e-12
                        and abs(m[f"{key}_card"] - m[f"{key}_host"]) <= 1e-12):
                    raise AssertionError(f"{key} at {t}: evaluate, the card's parse and the host's "
                                         f"differ: {m}")
        if not all(np.isfinite(v) for v in means.values()):
            raise AssertionError(f"non-finite eval metrics {means}")
        grid = 1 + (OPT_STEP + 2 if opt_step else 0)  # GridConv runs a request
        expect = {"fps": 3, "ball_query": 15, "gather": 3 * (5 + grid), "gather_bwd": 0,
                  "iou3d": 3, "lhs": 0, "three_nn": 3 * (2 + grid), "nms": 3,
                  "three_interpolate": 6, "three_interpolate_bwd": 0}
        if launches != expect:
            raise AssertionError(f"eval launches {launches} with opt_step {opt_step}, "
                                 f"expected {expect}")
        results[opt_step] = launches
    return results


def make_train_batch(seed: int, b: int, cfg, anchors=None) -> dict:
    """``b`` rooms of N points (``make_scenes``) with 8-16 boxes of ScanNet
    classes each (sizes the class mean + a residual of up to 10 %, inside
    the room, or centred within 0.05 of distinct rows of ``anchors`` (b, K,
    3) where given), the other slots of ``G`` empty; each point inside a box
    votes for its center, the vote tiled x3 as the ScanNet dataset writes it."""
    rng = np.random.RandomState(seed)
    pc = make_scenes(seed, b, N)
    mean = cfg.mean_size_arr
    lab = {"center_label": np.zeros((b, G, 3), np.float32),
           "box_label_mask": np.zeros((b, G), np.float32),
           "heading_class_label": np.zeros((b, G), np.int64),
           "heading_residual_label": np.zeros((b, G), np.float32),
           "size_class_label": np.zeros((b, G), np.int64),
           "size_residual_label": np.zeros((b, G, 3), np.float32),
           "sem_cls_label": np.zeros((b, G), np.int64),
           "vote_label": np.zeros((b, N, 9), np.float32),
           "vote_label_mask": np.zeros((b, N), np.int64)}
    for i in range(b):
        m = rng.randint(8, 17)
        cls = rng.randint(0, cfg.num_class, m)
        res = mean[cls] * rng.uniform(-0.1, 0.1, (m, 3))
        size = mean[cls] + res
        ctr = np.stack([rng.uniform(-3 + size[:, 0] / 2, 3 - size[:, 0] / 2),
                        rng.uniform(-3 + size[:, 1] / 2, 3 - size[:, 1] / 2),
                        size[:, 2] / 2 + rng.uniform(0, np.maximum(2.5 - size[:, 2], 0))], -1)
        if anchors is not None:
            ctr = anchors[i, rng.choice(anchors.shape[1], m, replace=False)] + rng.uniform(-0.05, 0.05, (m, 3))
        lab["center_label"][i, :m] = ctr
        lab["box_label_mask"][i, :m] = 1
        lab["size_class_label"][i, :m] = cls
        lab["size_residual_label"][i, :m] = res
        lab["sem_cls_label"][i, :m] = cls
        xyz = pc[i, :, :3]
        inside = (np.abs(xyz[:, None] - ctr[None]) <= size[None] / 2).all(-1)  # (N, m)
        hit = inside.any(1)
        vote = ctr[inside.argmax(1)] - xyz
        lab["vote_label"][i, hit] = np.tile(vote[hit], 3)
        lab["vote_label_mask"][i, hit] = 1
    lab["point_clouds"] = pc
    return lab


def _grads(model) -> torch.Tensor:
    return torch.cat([p.grad.detach().double().cpu().ravel() for p in model.parameters()])


def vote_anchors(pc: np.ndarray, dev, dataset: str = "scannet") -> np.ndarray:
    """The random model's (b, K, 3) aggregated_vote_xyz on ``pc`` in train
    mode, where the step's objectness labels are taken; from a model of its
    own, so that no state the step starts from moves."""
    model, _ = build_votenet(dataset, device=dev)
    model.train()
    set_bn_momentum(model, get_bn_momentum(0))
    with torch.no_grad():
        return model.forward_backbone(torch.from_numpy(pc).to(dev))["aggregated_vote_xyz"].cpu().numpy()


def train_check(cfg, dev, batch: dict, dataset: str = "scannet", what: str = "train_vs_cpu",
                iou_labels: bool = False, knobs: dict = None) -> dict:
    """One pretrain step of ``batch`` (2 scenes) on the card and on the CPU
    from the same weights and jitter draws: the loss within rtol 2e-3, the
    gradient with cosine > 0.999 and relative L2 < 0.05, FPS indices equal,
    at least MIN_POS_RATIO positives. With ``iou_labels``, also the step's
    IoU labels (``compute_iou_labels``, the rotated IoU of its proposals and
    GT) within atol IOU_LABEL_ATOL of the CPU's, some above 0.25, and the
    card's IoU kernel on the card's own inputs within atol 1e-5 of its
    plain version. ``knobs`` go to ``build_votenet``. Returns the losses
    and, with ``iou_labels``, the IoU labels' largest difference."""
    momentum = get_bn_momentum(0)
    noise = torch.randn((2, 2, K, 3), generator=torch.Generator().manual_seed(21))
    runs = []
    for where in (dev, torch.device("cpu")):
        model, _ = build_votenet(dataset, device=where, **(knobs or {}))  # seed 0: the same weights
        state = create_train_state(model)
        seen, iou_calls, pair_calls = {}, [], []
        hook = model.backbone_net.register_forward_hook(
            lambda m, a, ep: seen.__setitem__("sa1_inds", ep["sa1_inds"].cpu()))
        patched = [(labeled_loss, "compute_iou_labels", iou_calls),
                   (iou_labels_mod, "boxes_iou3d_paired_rows", pair_calls)] if iou_labels else []
        reals = [recorded(module, name, calls) for module, name, calls in patched]
        try:
            t = time.perf_counter()
            metrics = make_pretrain_step(cfg)(
                state, {k: torch.from_numpy(np.asarray(v)).to(where) for k, v in batch.items()},
                LR, momentum, noise=(noise[0].to(where), noise[1].to(where)))
            loss = float(metrics["loss"])
            seconds = time.perf_counter() - t
        finally:
            for (module, name, _), real in zip(patched, reals):
                setattr(module, name, real)
            hook.remove()
        runs.append((loss, _grads(model), seen["sa1_inds"], seconds, float(metrics["pos_ratio"]),
                     iou_calls, pair_calls))
    (loss_gpu, g_gpu, inds_gpu, gpu_s, pos, iou_gpu, pairs_gpu), \
        (loss_cpu, g_cpu, inds_cpu, cpu_s, pos_cpu, iou_cpu, _) = runs
    cos = float(g_gpu @ g_cpu / (g_gpu.norm() * g_cpu.norm()))
    rel_l2 = float((g_gpu - g_cpu).norm() / g_cpu.norm())
    row = {"loss_gpu": loss_gpu, "loss_cpu": loss_cpu, "grad_cosine": cos, "grad_rel_l2": rel_l2}
    tol = (f"loss rtol 2e-3, gradient cosine > 0.999 and relative L2 < 0.05, "
           f"pos_ratio >= {MIN_POS_RATIO}")
    if iou_labels:
        labels_gpu, labels_cpu = iou_gpu[0][1][0].cpu(), iou_cpu[0][1][0]
        boxes, got = pairs_gpu[0]  # the labels' IoU matrix, the step's first
        args = tuple(x.float().contiguous() for x in boxes) + ("iou3d",)
        row.update(iou_labels_max_diff=max_err(labels_gpu, labels_cpu),
                   iou_labels_above_025=int((labels_gpu > 0.25).sum()),
                   iou_labels=labels_gpu.numel(),
                   iou_kernel_vs_plain=max_err(got, box_pairs_plain(*args)),
                   gt_headings_nonzero=int((args[1][..., 6] != 0).sum()))
        tol += f", IoU labels atol {IOU_LABEL_ATOL}, the card's IoU atol 1e-5 of its plain version"
    say(phase=what, dataset=dataset, knobs=knobs or {}, scenes=len(batch["point_clouds"]),
        points=N, **row, pos_ratio=pos, pos_ratio_cpu=pos_cpu, gpu_s=gpu_s, cpu_s=cpu_s, tol=tol)
    if not torch.equal(inds_gpu, inds_cpu):
        raise AssertionError("the step's FPS indices differ between the card and the CPU")
    if min(pos, pos_cpu) < MIN_POS_RATIO:
        raise AssertionError(f"pos_ratio {pos} on the card, {pos_cpu} on the CPU: too few positives")
    if not (np.isfinite(loss_gpu) and abs(loss_gpu - loss_cpu) <= 2e-3 * abs(loss_cpu)):
        raise AssertionError(f"step loss {loss_gpu} on the card, {loss_cpu} on the CPU")
    if not (cos > 0.999 and rel_l2 < 0.05):
        raise AssertionError(f"step gradient: cosine {cos}, relative L2 {rel_l2}")
    if iou_labels:
        if not row["iou_labels_max_diff"] <= IOU_LABEL_ATOL:
            raise AssertionError(f"IoU labels differ by {row['iou_labels_max_diff']}")
        if not row["iou_labels_above_025"] > 0:
            raise AssertionError("no IoU label above 0.25: the check holds nothing")
        if not (row["iou_kernel_vs_plain"] <= 1e-5 and row["gt_headings_nonzero"] > 0):
            raise AssertionError(f"the card's IoU on rotated GT: {row}")
    return row


def phase_train(cfg, dev) -> tuple:
    """The pretrain step: one step of 2 scenes on the card and on the CPU
    from the same weights, batch and jitter draws, then 2 warm-up and 5
    timed steps of B scenes, one step's spans and its profile. The check's
    GT boxes sit at the random model's own vote centers, so that at least
    MIN_POS_RATIO of its proposals are positives and every box term of the
    loss carries gradient. Returns the kernels' launches over the 5 timed
    steps and the timed steps' ms, wall ms and scenes/s."""
    momentum = get_bn_momentum(0)
    check_batch = make_train_batch(20, 2, cfg, vote_anchors(make_scenes(20, 2, N), dev))
    train_check(cfg, dev, check_batch)
    batch = {k: torch.from_numpy(v).to(dev) for k, v in make_train_batch(22, B, cfg).items()}
    model, state, step, counts, stats = timed_train_steps(cfg, dev, batch, {})
    phase_train_profile(model, state, step, batch, momentum)
    # the knobs no driver sets: the same gates, and their steps' time beside
    # the default one's (the anchors hold: neither knob moves the votes)
    for knobs in TRAIN_KNOBS:
        train_check(cfg, dev, check_batch, knobs=knobs)
        timed_train_steps(cfg, dev, batch, knobs)
    return counts, stats



def timed_train_steps(cfg, dev, batch: dict, knobs: dict) -> tuple:
    """2 warm-up and 5 timed pretrain steps of ``batch`` on the model built
    with ``knobs``; launches a step must be TRAIN_LAUNCHES (FPS 5 without
    the prefix path). Returns the model, its state, the step, the launches
    over the 5 steps and their ms, wall ms and scenes/s."""
    momentum = get_bn_momentum(0)
    model, _ = build_votenet("scannet", device=dev, **knobs)
    state = create_train_state(model)
    step = make_pretrain_step(cfg)
    for _ in range(2):
        step(state, batch, LR, momentum)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats(dev)
    for fn in KERNELS.values():
        fn.launches = 0
    events, losses = [], []
    t = time.perf_counter()
    with plain_watch(f"pretrain steps ({knobs})"):
        for _ in range(5):
            ev = (torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True))
            ev[0].record()
            metrics = step(state, batch, LR, momentum)
            ev[1].record()
            events.append(ev)
            losses.append(metrics["loss"])
    torch.cuda.synchronize()
    wall_s = time.perf_counter() - t
    counts = {k: fn.launches for k, fn in KERNELS.items()}
    launches = {k: v / 5 for k, v in counts.items()}
    losses = torch.stack(losses).cpu()
    step_ms = [a.elapsed_time(e) for a, e in events]
    say(phase="train", knobs=knobs, scenes=B, points=N, steps=5, step_ms=step_ms,
        wall_ms_per_step=wall_s * 200, scenes_per_s=5 * B / wall_s,
        max_memory_allocated=torch.cuda.max_memory_allocated(dev), losses=losses.tolist(),
        launches_per_step=launches, adam="torch.optim.Adam, foreach", lr=LR, bn_momentum=momentum)
    if not torch.isfinite(losses).all():
        raise AssertionError(f"non-finite training loss ({knobs}): {losses.tolist()}")
    expect = dict(TRAIN_LAUNCHES, fps=1 + 4 * (knobs.get("fps_prefix") is False))
    if launches != expect:
        raise AssertionError(f"launches a step {launches} ({knobs}), expected {expect}")
    return model, state, step, counts, {"step_ms": step_ms, "wall_ms_per_step": wall_s * 200,
                                        "scenes_per_s": 5 * B / wall_s,
                                        "max_memory_allocated": torch.cuda.max_memory_allocated(dev)}


def phase_train_profile(model, state, step, batch, momentum):
    """One step's forward (backbone to GridConv), loss and backward, and
    optimizer spans by CUDA events, then one step under torch.profiler."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    marks = {}

    def mark(name):
        ev = torch.cuda.Event(enable_timing=True)
        ev.record()
        marks[name] = ev

    bn_shapes = []
    hooks = [model.backbone_net.register_forward_pre_hook(lambda *a: mark("forward")),
             model.grid_conv.register_forward_hook(lambda *a: mark("backward")),
             state.optimizer.register_step_pre_hook(lambda *a: mark("optimizer")),
             state.optimizer.register_step_post_hook(lambda *a: mark("end"))]
    hooks += [m.register_forward_pre_hook(lambda m, a: bn_shapes.append((a[0].numel() // a[0].shape[-1],
                                                                          a[0].shape[-1])))
              for m in model.modules() if isinstance(m, BatchNorm)]
    try:
        step(state, batch, LR, momentum)
        torch.cuda.synchronize()
    finally:
        for h in hooks:
            h.remove()
    order = ["forward", "backward", "optimizer", "end"]
    span_ms = {a: marks[a].elapsed_time(marks[b]) for a, b in zip(order, order[1:])}

    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        t = time.perf_counter()
        step(state, batch, LR, momentum)
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t) * 1e3
    kern = [e for e in prof.key_averages() if e.device_type == DeviceType.CUDA]
    kern.sort(key=lambda e: e.self_device_time_total, reverse=True)
    busy_ms = sum(e.self_device_time_total for e in kern) / 1e3
    say(phase="train_profile", span_ms=span_ms, profiled_wall_ms=wall_ms, device_busy_ms=busy_ms,
        busy_share=busy_ms / wall_ms,
        top_kernels=[[e.key[:80], e.self_device_time_total / 1e3, e.count] for e in kern[:15]])
    bn_forms(bn_shapes, next(model.parameters()).device)


def bn_forms(shapes, dev, group: bool = False):
    """Train-mode BatchNorm forward and backward at each of one step's BN
    inputs (rows, C), in the card's form (PyTorch's native kernels) and in
    the CPU's (``BatchNorm.two_pass``, written out), and with ``group`` (in a
    process group's active block) in the group's two forms (the card's
    ``global_native``, one all-reduce each way, and the CPU's
    ``global_two_pass``, two); ms a step, summed, and returned."""
    gen = torch.Generator(device=dev).manual_seed(9)
    forms = ("native", "two_pass") + (("global_native", "global_two_pass") if group else ())
    total = dict.fromkeys(forms, 0.0)
    for rows, c in shapes:
        bn = BatchNorm(c).to(dev)
        bn.momentum = get_bn_momentum(0)
        x = torch.randn(rows, c, generator=gen, device=dev, requires_grad=True)
        g = torch.randn(rows, c, generator=gen, device=dev)
        for form in forms:
            fn = {"native": lambda t: F.batch_norm(t, bn.running_mean, bn.running_var, bn.weight,
                                                   bn.bias, True, bn.momentum, bn.eps),
                  "two_pass": bn.two_pass, "global_native": bn.global_native,
                  "global_two_pass": bn.global_two_pass}[form]
            total[form] += cuda_ms(lambda: torch.autograd.grad(fn(x), (x, bn.weight, bn.bias), g), 1, 5)
    say(phase="bn_forms", layers_a_step=len(shapes), forward_backward_ms_a_step=total)
    return total


def augment_view(pc: np.ndarray, seed: int) -> tuple:
    """The student's view of the teacher's clouds ``pc`` (b, N, 4): x and y
    flipped each with probability 1/2, a rotation about z within 5 degrees
    and a scale in [0.9, 1.1]. Returns (clouds, the batch's keys that
    describe it)."""
    rng = np.random.RandomState(seed)
    b = pc.shape[0]
    flip_x, flip_y = rng.randint(0, 2, b), rng.randint(0, 2, b)
    angle = rng.uniform(-np.pi / 36, np.pi / 36, b).astype(np.float32)
    rot = np.zeros((b, 3, 3), np.float32)
    rot[:, 0, 0], rot[:, 0, 1], rot[:, 2, 2] = np.cos(angle), -np.sin(angle), 1.0
    rot[:, 1, 0], rot[:, 1, 1] = np.sin(angle), np.cos(angle)
    scale = np.tile(rng.uniform(0.9, 1.1, (b, 1, 1)), (1, 1, 3)).astype(np.float32)
    sign = np.where(np.stack([flip_x, flip_y, np.zeros(b)], -1) > 0, -1.0, 1.0)[:, None]
    out = pc.copy()
    out[..., 0:3] = np.einsum("bnc,bdc->bnd", pc[..., 0:3] * sign, rot) * scale
    return out.astype(np.float32), {"flip_x_axis": flip_x, "flip_y_axis": flip_y,
                                    "rot_mat": rot, "rot_angle": angle, "scale": scale}


def make_ssl_batch(seed: int, nl: int, nu: int, cfg, anchors=None) -> dict:
    """``nl`` labeled and ``nu`` unlabeled rooms of ``make_train_batch``,
    with labels for every scene (view-stats reads the unlabeled ones'); the
    teacher sees the rooms as made, the student after ``augment_view``.
    The labels stay in the teacher's frame: the checks compare the card
    with the CPU, not the labels with the scene."""
    batch = make_train_batch(seed, nl + nu, cfg, anchors)
    batch["ema_point_clouds"] = batch["point_clouds"]
    batch["point_clouds"], aug = augment_view(batch["ema_point_clouds"], seed + 1)
    batch.update(aug)
    return batch


def teacher_thresholds(pc: np.ndarray, noise, dev, nl: int, dataset: str = "scannet") -> dict:
    """Pseudo-label thresholds at the 0.3, 0.3 and 0.2 quantiles of the
    random teacher's own train-mode objectness, class and IoU scores on the
    unlabeled scenes of ``pc``, the step's teacher forward on a model of
    its own: the released 0.9 / 0.9 / 0.25 pass none of a random model's
    boxes, these pass a share."""
    model, _ = build_votenet(dataset, device=dev)
    model.train()
    set_bn_momentum(model, get_bn_momentum(0))
    with torch.no_grad():
        ep = model.forward_with_pred_jitter(torch.from_numpy(pc).to(dev),
                                            noise=tuple(n.to(dev) for n in noise))
    pos = torch.softmax(ep["objectness_scores"][nl:], -1)[..., 1]
    cls = torch.softmax(ep["sem_cls_scores"][nl:], -1)
    iou = torch.sigmoid(ep["iou_scores"][nl:]).gather(2, cls.argmax(-1, keepdim=True))[..., 0]

    def quantile(x, q):
        return float(torch.quantile(x.flatten().double(), q))

    return dict(obj_threshold=quantile(pos, 0.3), cls_threshold=quantile(cls.amax(-1), 0.3),
                iou_threshold=quantile(iou, 0.2))


def ssl_check(cfg, dev, dataset: str = "scannet", batch=None, what: str = "ssl_vs_cpu") -> dict:
    """One SSL step of 1 labeled + 1 unlabeled scene on the card and on the
    CPU, ``reference_exact`` with view-stats, from the same weights, batch
    (``batch``, or rooms of ``make_ssl_batch``) and jitter draws, with
    thresholds low enough for pseudo labels (``teacher_thresholds``) and
    LHS IoU ``SSL_CHECK_NMS_IOU``: the gates of the pretrain check, FPS
    indices equal, pseudo labels on both sides, LHS dropping boxes, its
    keep masks equal between the card and the CPU, and the card's LHS equal
    to its plain version on the card's inputs. Returns the losses."""
    momentum = get_bn_momentum(0)
    if batch is None:
        student_pc, _ = augment_view(make_scenes(50, 2, N), 51)
        batch = make_ssl_batch(50, 1, 1, cfg, vote_anchors(student_pc, dev))
    noise = torch.randn((4, 2, K, 3), generator=torch.Generator().manual_seed(52))
    thr = teacher_thresholds(batch["ema_point_clouds"], (noise[0], noise[1]), dev, 1, dataset)
    runs = []
    for where in (dev, torch.device("cpu")):
        model, _ = build_votenet(dataset, device=where)  # seed 0: the same weights
        state = create_train_state(model, with_ema=True)
        seen, lhs_calls = {}, []
        hooks = [m.backbone_net.register_forward_hook(
            lambda mod, a, ep, who=who: seen.__setitem__(who, ep["sa1_inds"].cpu()))
            for who, m in (("teacher", state.ema_model), ("student", model))]

        def recording(*args):
            lhs_calls.append((args, lhs_3d_samecls(*args)))
            return lhs_calls[-1][1]

        unlabeled.lhs_3d_samecls = recording
        try:
            t = time.perf_counter()
            metrics = make_ssl_step(cfg, 1, reference_exact=True, view_stats=True,
                                    nms_iou=SSL_CHECK_NMS_IOU, dataset=dataset, **thr)(
                state, {k: torch.from_numpy(np.asarray(v)).to(where) for k, v in batch.items()},
                SSL_LR, momentum, noise=((noise[0].to(where), noise[1].to(where)),
                                         (noise[2].to(where), noise[3].to(where))))
            loss = float(metrics["loss"])
            seconds = time.perf_counter() - t
        finally:
            unlabeled.lhs_3d_samecls = lhs_3d_samecls
            for h in hooks:
                h.remove()
        (lhs_args, keep), = lhs_calls
        runs.append(dict(loss=loss, grads=_grads(model), seconds=seconds, keep=keep.cpu(),
                         inds=torch.cat([seen["teacher"], seen["student"]]), lhs_args=lhs_args,
                         **{k: float(metrics[k]) for k in ("pos_ratio", "pseudo_gt_ratio")}))
    gpu, cpu = runs
    g_gpu, g_cpu = gpu["grads"], cpu["grads"]
    cos = float(g_gpu @ g_cpu / (g_gpu.norm() * g_cpu.norm()))
    rel_l2 = float((g_gpu - g_cpu).norm() / g_cpu.norm())
    lhs_plain = lhs_3d_samecls_plain(*gpu["lhs_args"]).cpu()
    say(phase=what, scenes="1 + 1", points=N, thresholds=thr, nms_iou=SSL_CHECK_NMS_IOU,
        loss_gpu=gpu["loss"], loss_cpu=cpu["loss"], grad_cosine=cos, grad_rel_l2=rel_l2,
        pseudo_gt_ratio=gpu["pseudo_gt_ratio"], pseudo_gt_ratio_cpu=cpu["pseudo_gt_ratio"],
        pos_ratio=gpu["pos_ratio"], pos_ratio_cpu=cpu["pos_ratio"],
        lhs_kept=int(gpu["keep"].sum()), lhs_boxes=gpu["keep"].numel(),
        lhs_equal_cpu=bool(torch.equal(gpu["keep"], cpu["keep"])),
        lhs_equal_plain=bool(torch.equal(gpu["keep"], lhs_plain)), gpu_s=gpu["seconds"],
        cpu_s=cpu["seconds"], tol=f"loss rtol 2e-3, gradient cosine > 0.999 and relative L2 < "
                                 f"0.05, pos_ratio >= {MIN_POS_RATIO}, pseudo_gt_ratio > 0, LHS "
                                 f"drops a box, FPS and LHS equal")
    if not torch.equal(gpu["inds"], cpu["inds"]):
        raise AssertionError("the SSL step's FPS indices differ between the card and the CPU")
    if not (torch.equal(gpu["keep"], cpu["keep"]) and torch.equal(gpu["keep"], lhs_plain)):
        raise AssertionError("LHS's keep mask differs between the card, its plain version and the CPU")
    if not int(gpu["keep"].sum()) < gpu["keep"].numel():
        raise AssertionError("LHS kept every box of the card-vs-CPU step: its gates check nothing")
    if min(gpu["pos_ratio"], cpu["pos_ratio"]) < MIN_POS_RATIO:
        raise AssertionError(f"pos_ratio {gpu['pos_ratio']} / {cpu['pos_ratio']}: too few positives")
    if min(gpu["pseudo_gt_ratio"], cpu["pseudo_gt_ratio"]) <= 0:
        raise AssertionError("no pseudo label passed the thresholds")
    if not (np.isfinite(gpu["loss"]) and abs(gpu["loss"] - cpu["loss"]) <= 2e-3 * abs(cpu["loss"])):
        raise AssertionError(f"SSL step loss {gpu['loss']} on the card, {cpu['loss']} on the CPU")
    if not (cos > 0.999 and rel_l2 < 0.05):
        raise AssertionError(f"SSL step gradient: cosine {cos}, relative L2 {rel_l2}")
    return {"loss_gpu": gpu["loss"], "loss_cpu": cpu["loss"], "grad_cosine": cos,
            "grad_rel_l2": rel_l2}


def phase_ssl(cfg, dev) -> tuple:
    """The SSL step: the card-vs-CPU check (``ssl_check``), then 2 warm-up
    and 5 timed steps at the users' settings (run_train.sh): 4 labeled + 8
    unlabeled scenes, ``reference_exact`` with view-stats, thresholds 0.9 /
    0.9 / 0.25, lr 2e-3, epoch 0's BN momentum, EMA decay 0.999; then one
    step's spans and profile. Returns the kernels' launches over the 5
    timed steps and the timed steps' ms, wall ms and scenes/s."""
    ssl_check(cfg, dev)
    batch = {k: torch.from_numpy(np.asarray(v)).to(dev)
             for k, v in make_ssl_batch(53, SSL_NL, SSL_NU, cfg).items()}
    state, step, counts, stats = timed_ssl_steps(cfg, dev, batch, {})
    phase_ssl_profile(state, step, batch, get_bn_momentum(0))
    return counts, stats


def timed_ssl_steps(cfg, dev, batch: dict, knobs: dict) -> tuple:
    """2 warm-up and 5 timed SSL steps of ``batch`` at run_train.sh's
    settings on the model built with ``knobs``; launches a step must be
    SSL_LAUNCHES. Returns the state, the step, the launches over the 5
    steps and their ms, wall ms and scenes/s."""
    momentum = get_bn_momentum(0)
    model, _ = build_votenet("scannet", device=dev, **knobs)
    state = create_train_state(model, with_ema=True)
    step = make_ssl_step(cfg, SSL_NL, reference_exact=True, view_stats=True)
    for _ in range(2):
        step(state, batch, SSL_LR, momentum)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats(dev)
    for fn in KERNELS.values():
        fn.launches = 0
    events, metrics = [], []
    t = time.perf_counter()
    with plain_watch(f"SSL steps ({knobs})"):
        for _ in range(5):
            ev = (torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True))
            ev[0].record()
            metrics.append(step(state, batch, SSL_LR, momentum))
            ev[1].record()
            events.append(ev)
    torch.cuda.synchronize()
    wall_s = time.perf_counter() - t
    counts = {k: fn.launches for k, fn in KERNELS.items()}
    launches = {k: v / 5 for k, v in counts.items()}
    losses = torch.stack([m["loss"] for m in metrics]).cpu()
    scenes = SSL_NL + SSL_NU
    step_ms = [a.elapsed_time(e) for a, e in events]
    say(phase="ssl", knobs=knobs, scenes=f"{SSL_NL} + {SSL_NU}", points=N, steps=5,
        step_ms=step_ms, wall_ms_per_step=wall_s * 200,
        scenes_per_s=5 * scenes / wall_s, max_memory_allocated=torch.cuda.max_memory_allocated(dev),
        losses=losses.tolist(), pseudo_gt_ratio=[float(m["pseudo_gt_ratio"]) for m in metrics],
        launches_per_step=launches, lr=SSL_LR, bn_momentum=momentum, ema_decay=0.999,
        thresholds="0.9 / 0.9 / 0.25")
    if not torch.isfinite(losses).all():
        raise AssertionError(f"non-finite SSL loss: {losses.tolist()}")
    if launches != SSL_LAUNCHES:
        raise AssertionError(f"SSL launches a step {launches} ({knobs}), expected {SSL_LAUNCHES}")
    return state, step, counts, {"step_ms": step_ms, "wall_ms_per_step": wall_s * 200,
                                 "scenes_per_s": 5 * scenes / wall_s,
                                 "max_memory_allocated": torch.cuda.max_memory_allocated(dev)}


def phase_ssl_profile(state, step, batch, momentum):
    """One SSL step's spans by CUDA events (the shared FPS, the teacher's
    forward, the student's, loss and backward, Adam, the EMA), the device
    time of its three_nn calls and of its LHS, each call timed again on its
    own inputs, the plain versions beside them; then one step under
    torch.profiler."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    marks, nn_calls, lhs_calls = {}, [], []

    def mark(name):
        ev = torch.cuda.Event(enable_timing=True)
        ev.record()
        marks[name] = ev

    def nn_recording(*args):
        nn_calls.append(args)
        return three_nn(*args)

    def lhs_recording(*args):
        lhs_calls.append(args)
        return lhs_3d_samecls(*args)

    model, opt = state.model, state.optimizer
    hooks = [state.ema_model.backbone_net.register_forward_pre_hook(lambda *a: mark("teacher")),
             model.backbone_net.register_forward_pre_hook(lambda *a: mark("student")),
             model.grid_conv.register_forward_hook(lambda *a: mark("loss_backward")),
             opt.register_step_pre_hook(lambda *a: mark("adam")),
             opt.register_step_post_hook(lambda *a: mark("ema"))]
    grid_conv.three_nn = pointnet2.three_nn = nn_recording
    unlabeled.lhs_3d_samecls = lhs_recording
    try:
        mark("fps")
        step(state, batch, SSL_LR, momentum)
        mark("end")
        torch.cuda.synchronize()
    finally:
        grid_conv.three_nn = pointnet2.three_nn = three_nn
        unlabeled.lhs_3d_samecls = lhs_3d_samecls
        for h in hooks:
            h.remove()
    order = ["fps", "teacher", "student", "loss_backward", "adam", "ema", "end"]
    span_ms = {a: marks[a].elapsed_time(marks[b]) for a, b in zip(order, order[1:])}
    nn_ms = [cuda_ms(lambda a=a: three_nn(*a), 1, 5) for a in nn_calls]
    nn_plain_ms = sum(cuda_ms(lambda a=a: three_nn_plain(*a), 1, 5) for a in nn_calls)
    lhs_ms = sum(cuda_ms(lambda a=a: lhs_3d_samecls(*a), 10, 5) for a in lhs_calls)
    lhs_plain_ms = sum(cuda_ms(lambda a=a: lhs_3d_samecls_plain(*a), 1, 5) for a in lhs_calls)

    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        t = time.perf_counter()
        step(state, batch, SSL_LR, momentum)
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t) * 1e3
    kern = [e for e in prof.key_averages() if e.device_type == DeviceType.CUDA]
    kern.sort(key=lambda e: e.self_device_time_total, reverse=True)
    busy_ms = sum(e.self_device_time_total for e in kern) / 1e3
    say(phase="ssl_profile", span_ms=span_ms,
        three_nn=[[list(a[0].shape), list(a[1].shape), ms] for a, ms in zip(nn_calls, nn_ms)],
        three_nn_ms_a_step=sum(nn_ms), three_nn_plain_ms_a_step=nn_plain_ms,
        lhs_ms_a_step=lhs_ms, lhs_plain_ms_a_step=lhs_plain_ms,
        profiled_wall_ms=wall_ms, device_busy_ms=busy_ms, busy_share=busy_ms / wall_ms,
        top_kernels=[[e.key[:80], e.self_device_time_total / 1e3, e.count] for e in kern[:15]])


def scannet_scan(rng, n: int, cfg) -> tuple:
    """One ScanNet-format scan of ``n`` vertices: 10-30 boxes of ScanNet's
    18 classes (their mean sizes within 20 %) standing on the floor of the
    4 x 4 x 2.5 m room of ``make_surface_scenes``, half the points on the
    boxes' faces, the rest on the floor and walls (nyu40 ids 2 and 1, not
    detection classes); rgb in 0-255. Returns (verts (n, 6) float32,
    instance ids, nyu40 ids, boxes (K, 7): center, size, nyu40 id of each
    instance's points)."""
    k = rng.randint(10, 31)
    cls = rng.randint(0, cfg.num_class, k)
    size = np.minimum(cfg.mean_size_arr[cls] * rng.uniform(0.8, 1.2, (k, 3)), 3.5)
    ctr = np.c_[rng.uniform(-2 + size[:, :2] / 2, 2 - size[:, :2] / 2), size[:, 2] / 2]
    on_box = rng.multinomial(n // 2, np.full(k, 1 / k))
    ins_box = np.repeat(np.arange(1, k + 1), on_box)
    face = rng.uniform(-0.5, 0.5, (n // 2, 3))
    axis = rng.randint(0, 3, n // 2)
    face[np.arange(n // 2), axis] = np.where(rng.rand(n // 2) < 0.5, -0.5, 0.5)
    box_xyz = ctr[ins_box - 1] + face * size[ins_box - 1]
    room = make_surface_scenes(rng.randint(2**31), 1, n - n // 2)[0]
    floor = room[:, 2] == 0
    xyz = np.concatenate([box_xyz, room]).astype(np.float32)
    ins = np.concatenate([ins_box, np.where(floor, k + 1, k + 2)])
    sem = np.concatenate([cfg.nyu40ids[cls][ins_box - 1], np.where(floor, 2, 1)])
    perm = rng.permutation(n)
    verts = np.c_[xyz, rng.uniform(0, 255, (n, 3))].astype(np.float32)[perm]
    ins, sem = ins[perm].astype(np.int64), sem[perm].astype(np.int64)
    boxes = np.zeros((k, 7))
    for j in range(k):
        pts = verts[ins == j + 1, :3]
        lo, hi = pts.min(0), pts.max(0)
        boxes[j] = np.r_[(lo + hi) / 2, hi - lo, cfg.nyu40ids[cls[j]]]
    return verts, ins, sem, boxes


def write_dumps(root: Path, cfg, seed: int) -> dict:
    """``DUMP_SCANS`` scans of ``DUMP_VERTICES`` vertices under ``root`` as
    ``data/prep_scannet.py`` writes them, in the layout the drivers read
    (``scannet_train_detection_data/``, ``meta_data/``): DUMP_TRAIN train
    and the rest val scans, the first DUMP_LABELED train scans listed in
    ``meta_data/labeled.txt``. Returns the bytes written and the seconds."""
    t = time.perf_counter()
    rng = np.random.RandomState(seed)
    data, meta = root / "scannet_train_detection_data", root / "meta_data"
    data.mkdir(parents=True)
    meta.mkdir()
    names = [f"scene{i:04d}_00" for i in range(DUMP_SCANS)]
    for name in names:
        for suffix, arr in zip(("vert", "ins_label", "sem_label", "bbox"),
                               scannet_scan(rng, DUMP_VERTICES, cfg)):
            np.save(data / f"{name}_{suffix}.npy", arr)
    (meta / "scannetv2_train.txt").write_text("\n".join(names[:DUMP_TRAIN]) + "\n")
    (meta / "scannetv2_val.txt").write_text("\n".join(names[DUMP_TRAIN:]) + "\n")
    (meta / "labeled.txt").write_text("\n".join(names[:DUMP_LABELED]) + "\n")
    nbytes = sum(f.stat().st_size for f in root.rglob("*") if f.is_file())
    return {"bytes": nbytes, "seconds": time.perf_counter() - t}


def data_args(root: Path, **kw) -> types.SimpleNamespace:
    """The drivers' dataset flags at cli/pretrain.py's defaults (40,000
    points, height on, colour off), with the labeled list."""
    return types.SimpleNamespace(dataset="scannet", data_path=str(root),
                                 labeled_sample_list="labeled.txt", num_point=N, no_height=False,
                                 use_color=False, use_sunrgbd_v2=False, synthetic=False, **kw)


def epochs(loader, n: int):
    """The first ``n`` batches of ``loader``, epoch after epoch."""
    return itertools.islice(itertools.chain.from_iterable(itertools.repeat(loader)), n)


def check_staged(host: dict, staged: dict, dev, what: str) -> None:
    for k, v in host.items():
        want = torch.from_numpy(v).to(dev)
        if staged[k].dtype != want.dtype or not torch.equal(staged[k], want):
            raise AssertionError(f"{what}: staged {k} differs from its host leaf")


def stage_check(loader, dev) -> dict:
    """(b): the first batch's ``stage_batch`` against a copy of each leaf;
    then 6 batches staged back to back in the prefetch thread while a
    0.5 s spin holds the stream, so that every copy is still queued when
    the next batch is packed, each against its host leaves. Returns the
    staging's bytes and times."""
    batches = list(epochs(loader, 6))
    staged = stage_batch(batches[0])
    torch.cuda.synchronize()
    check_staged(batches[0], staged, dev, "the first batch")
    torch.cuda._sleep(1_000_000_000)
    pairs = list(prefetch((b, stage_batch(b)) for b in batches))
    torch.cuda.synchronize()
    for i, (host, dev_batch) in enumerate(pairs):
        check_staged(host, dev_batch, dev, f"batch {i} of 6 staged back to back")
    wall = []
    for b in batches:
        t = time.perf_counter()
        stage_batch(b)
        torch.cuda.synchronize()
        wall.append((time.perf_counter() - t) * 1e3)
    _, nbytes = staging_layout(batches[0])
    pinned = torch.empty(nbytes, dtype=torch.uint8, pin_memory=True)
    copy_ms = cuda_ms(lambda: pinned.to(dev, non_blocking=True), 1, 10)
    return {"bytes_a_batch": nbytes, "leaves": len(batches[0]),
            "stage_ms": [float(x) for x in wall], "copy_ms": copy_ms,
            "copy_gb_per_s": nbytes / copy_ms / 1e6, "equal": "first batch and 6 back to back"}


def loader_rates(ds, workers) -> dict:
    """(c): scenes/s of ``DataLoader(ds, B)`` with W process workers, one
    warm-up batch (it starts the workers) then 6 timed; beside them one
    ``__getitem__`` in this process and a sample's pickle round trip, the
    IPC a worker's sample pays."""
    ds[0]  # loads the native library in this process
    getitem_ms = []
    for i in range(8):
        np.random.seed(i)
        t = time.perf_counter()
        sample = ds[i]
        getitem_ms.append((time.perf_counter() - t) * 1e3)
    t = time.perf_counter()
    blob = pickle.dumps(sample)
    pickle.loads(blob)
    pickle_ms = (time.perf_counter() - t) * 1e3
    rates = {}
    for w in workers:
        loader = DataLoader(ds, B, num_workers=w, seed=w, worker_type="process")
        try:
            it = epochs(loader, 7)
            next(it)
            t = time.perf_counter()
            for _ in range(6):
                next(it)
            rates[w] = 6 * B / (time.perf_counter() - t)
        finally:
            loader.close()
    return {"cpu_count": os.cpu_count(), "scenes_per_s": rates,
            "getitem_ms": getitem_ms, "sample_bytes": len(blob), "pickle_round_trip_ms": pickle_ms}


def loader_fed_steps(step, state, batches, lr, momentum, scenes: int, expect: dict) -> dict:
    """(d), (e): 2 warm-up and 5 timed steps on ``batches``, an iterator of
    staged batches (the loader, ``prefetch`` and ``stage_batch``): each
    step's CUDA-event ms, the wall ms a step, the host's wait on the
    prefetch queue a step, scenes/s and the launches a step, which must be
    ``expect``."""
    for _ in range(2):
        step(state, next(batches), lr, momentum)
    torch.cuda.synchronize()
    for fn in KERNELS.values():
        fn.launches = 0
    events, waits, losses = [], [], []
    t = time.perf_counter()
    for _ in range(5):
        w = time.perf_counter()
        batch = next(batches)
        waits.append((time.perf_counter() - w) * 1e3)
        ev = (torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True))
        ev[0].record()
        losses.append(step(state, batch, lr, momentum)["loss"])
        ev[1].record()
        events.append(ev)
    torch.cuda.synchronize()
    wall_s = time.perf_counter() - t
    counts = {k: fn.launches for k, fn in KERNELS.items()}
    launches = {k: v / 5 for k, v in counts.items()}
    losses = torch.stack(losses).cpu()
    if not torch.isfinite(losses).all():
        raise AssertionError(f"non-finite loader-fed loss: {losses.tolist()}")
    if launches != expect:
        raise AssertionError(f"loader-fed launches a step {launches}, expected {expect}")
    return {"step_ms": [a.elapsed_time(e) for a, e in events], "wall_ms_per_step": wall_s * 200,
            "prefetch_wait_ms": waits, "scenes_per_s": 5 * scenes / wall_s,
            "losses": losses.tolist(), "launches_per_step": launches, "counts": counts}


def same_tensors(a: dict, b: dict, what: str) -> None:
    if a.keys() != b.keys():
        raise AssertionError(f"{what}: the keys differ")
    for k in a:
        x, y = torch.as_tensor(a[k]), torch.as_tensor(b[k])
        if x.dtype != y.dtype or not torch.equal(x, y.to(x.device)):
            raise AssertionError(f"{what}: {k} differs")


def adam_tensors(state) -> dict:
    return {f"{i}.{k}": v for i, s in state.optimizer.state_dict()["state"].items()
            for k, v in s.items()}


def checkpoint_check(state, cfg, dev, path: str, clouds) -> dict:
    """(f): the pretrain state after (d) saved, loaded into a fresh model
    (other weights) and state on the card: every tensor of the model and of
    Adam's state, the step count and the generator equal bit for bit, one
    eval forward on ``clouds`` equal bit for bit; ``load_pretrain_into_ssl``
    of the file: student and teacher equal to the saved model, in tensors
    of their own, and Adam empty."""
    t = time.perf_counter()
    checkpoint.save(path, state, epoch=1, loss=0.0)
    save_s = time.perf_counter() - t
    model, _ = build_votenet("scannet", device=dev, generator=torch.Generator().manual_seed(1))
    fresh = create_train_state(model, seed=1)
    t = time.perf_counter()
    checkpoint.load(path, fresh)
    load_s = time.perf_counter() - t
    same_tensors(fresh.model.state_dict(), state.model.state_dict(), "loaded model")
    same_tensors(adam_tensors(fresh), adam_tensors(state), "loaded Adam state")
    same_tensors({"g": fresh.generator.get_state()}, {"g": state.generator.get_state()},
                 "loaded generator")
    if fresh.step != state.step or not adam_tensors(state):
        raise AssertionError(f"loaded step {fresh.step} of {state.step}, or no Adam state saved")
    got = make_eval_forward(fresh.model)(clouds)
    want = make_eval_forward(state.model)(clouds)
    same_tensors(got, want, "the loaded model's eval forward")
    model, _ = build_votenet("scannet", device=dev, generator=torch.Generator().manual_seed(2))
    ssl = create_train_state(model, seed=2, with_ema=True)
    checkpoint.load_pretrain_into_ssl(path, ssl)
    saved = state.model.state_dict()
    for who, m in (("student", ssl.model), ("teacher", ssl.ema_model)):
        same_tensors(m.state_dict(), saved, f"load_pretrain_into_ssl's {who}")
    student, teacher = ssl.model.state_dict(), ssl.ema_model.state_dict()
    if any(student[k].data_ptr() == teacher[k].data_ptr() for k in student):
        raise AssertionError("load_pretrain_into_ssl's student and teacher share tensors")
    if ssl.optimizer.state_dict()["state"] or ssl.step:
        raise AssertionError("load_pretrain_into_ssl left Adam's state or the step count")
    return {"file_bytes": os.path.getsize(path), "save_s": save_s, "load_s": load_s,
            "tensors": len(saved) + len(adam_tensors(state)),
            "equal": "model, Adam, step, generator, eval forward; pretrain -> SSL student "
                     "and teacher, Adam empty"}


def phase_data(cfg, dev, train_stats: dict, ssl_stats: dict) -> dict:
    """Phase 8, the training input path: ScanNet-format dumps at the prep's
    size in a temporary directory (removed at the end), then (b) staging's
    equality, (c) the loader alone per worker count, (d) pretrain and (e)
    SSL fed by the loader, each beside phase 6's and 7's resident batch, and
    (f) the checkpoint round trip. Returns the kernels' launches over (d)'s
    and (e)'s 5 timed steps."""
    momentum = get_bn_momentum(0)
    root = Path(tempfile.mkdtemp(prefix="chip_smoke_dumps_"))
    loaders = []

    def loader(*args, **kw):
        loaders.append(DataLoader(*args, **kw))
        return loaders[-1]

    try:
        say(phase="data_dumps", scans=DUMP_SCANS, train=DUMP_TRAIN, val=DUMP_SCANS - DUMP_TRAIN,
            labeled=DUMP_LABELED, vertices=DUMP_VERTICES, **write_dumps(root, cfg, 80))
        train_ds, _, _ = cli_common.build_supervised_datasets(data_args(root))
        all_train = ScannetDetectionDataset(str(root / "scannet_train_detection_data"),
                                            str(root / "meta_data"), "train", num_points=N,
                                            use_height=True, augment=True)
        workers = sorted({1, 2, 4, min(8, os.cpu_count() or 1)})
        say(phase="data_staging", **stage_check(loader(all_train, B, num_workers=workers[-1],
                                                       seed=81, worker_type="process"), dev))
        say(phase="data_loader", dataset="ScannetDetectionDataset(train, augment, height)",
            scenes=len(all_train), batch=B, warmup_batches=1, timed_batches=6,
            **loader_rates(all_train, workers))

        model, _ = build_votenet("scannet", device=dev)
        state = create_train_state(model)
        feed = loader(train_ds, B, num_workers=LOADER_WORKERS, seed=82, worker_type="process")
        batches = prefetch(stage_batch(b) for b in epochs(feed, 7))
        pretrain = loader_fed_steps(make_pretrain_step(cfg), state, batches, LR, momentum, B,
                                    TRAIN_LAUNCHES)
        say(phase="data_train", scenes=B, points=N, workers=LOADER_WORKERS,
            train_scenes=len(train_ds), resident=train_stats,
            **{k: v for k, v in pretrain.items() if k != "counts"})

        labeled_ds, unlabeled_ds, _, _ = cli_common.build_ssl_datasets(data_args(root, view_stats=True))
        ssl_model, _ = build_votenet("scannet", device=dev)
        ssl_state = create_train_state(ssl_model, with_ema=True)
        batcher = SSLBatcher(
            loader(labeled_ds, SSL_NL, num_workers=LOADER_WORKERS, seed=83, worker_type="process"),
            loader(unlabeled_ds, SSL_NU, num_workers=LOADER_WORKERS, seed=84, worker_type="process"))
        ssl = loader_fed_steps(make_ssl_step(cfg, SSL_NL, reference_exact=True, view_stats=True),
                               ssl_state, prefetch(stage_batch(b) for b in epochs(batcher, 7)),
                               SSL_LR, momentum, SSL_NL + SSL_NU, SSL_LAUNCHES)
        say(phase="data_ssl", scenes=f"{SSL_NL} + {SSL_NU}", points=N, workers=LOADER_WORKERS,
            labeled_scenes=len(labeled_ds), unlabeled_scenes=len(unlabeled_ds),
            resident=ssl_stats, **{k: v for k, v in ssl.items() if k != "counts"})

        clouds = stage_batch(next(iter(feed)))["point_clouds"]
        say(phase="data_checkpoint",
            **checkpoint_check(state, cfg, dev, str(root / "checkpoint.tar"), clouds))
        return {"train": pretrain["counts"], "ssl": ssl["counts"]}
    finally:
        for ld in loaders:
            ld.close()
        shutil.rmtree(root)


def driver_run(name: str, fn, argv: list, log_dir: Path, steps: int, scenes: int,
               expect: dict) -> dict:
    """One driver ``main(argv)`` in this process with the kernels' counts
    set to 0 just before it and read just after; the launches must be
    ``expect``. The loop is timed on the host clock from outside, with
    nothing of the driver changed: ``cli_common.train_epochs`` is handed a
    logger that marks each epoch's header and ``epoch time:`` line, and a
    step that times its call (the host queuing the step's work), and the
    ``fetch_metrics`` after a step times its wait for the card; the step
    and the wait each open a ``torch.profiler.record_function`` span
    (``driver_step``, ``fetch_metrics``) for ``driver_trace``. Returns its
    wall time, the epochs' ms, each epoch's wait for its first batch, a
    step's ms after the first batch (its queuing, its wait, and the loop's
    own time from a wait's end to the next step or the epoch's end) over
    the epochs after the first (no warm-up, no trace), ms and scenes/s a
    step over all (``steps`` steps of ``scenes`` scenes), its launches and
    the files it wrote."""
    log_path = log_dir / "log_train.txt"
    logged = log_path.stat().st_size if log_path.exists() else 0  # a resume appends
    epochs, calls, pending = [], [], [False]
    real_epochs, real_fetch = cli_common.train_epochs, cli_common.fetch_metrics

    def timed_fetch(metrics):
        if not pending[0]:  # an eval's
            return real_fetch(metrics)
        pending[0] = False
        with torch.profiler.record_function("fetch_metrics"):
            t = time.perf_counter()
            out = real_fetch(metrics)
            calls[-1].extend((t, time.perf_counter()))
        return out

    def timed_epochs(args, state, step, loader, eval_epoch, logger, *rest):
        def timed_step(*a):
            with torch.profiler.record_function("driver_step"):
                t = time.perf_counter()
                out = step(*a)
                calls.append([t, time.perf_counter()])
            pending[0] = True
            return out

        class MarkingLogger:
            def __call__(self, line):
                if line.startswith("**** EPOCH"):
                    epochs.append([time.perf_counter(), len(calls)])
                elif line.startswith("epoch time:"):
                    epochs[-1].extend((time.perf_counter(), len(calls)))
                logger(line)

            def __getattr__(self, name):  # log_best and the rest
                return getattr(logger, name)

        return real_epochs(args, state, timed_step, loader, eval_epoch, MarkingLogger(), *rest)

    torch.cuda.synchronize()
    for k in KERNELS.values():
        k.launches = 0
    cli_common.train_epochs, cli_common.fetch_metrics = timed_epochs, timed_fetch
    t = time.perf_counter()
    try:
        result = fn(argv)
        torch.cuda.synchronize()
    finally:
        cli_common.train_epochs, cli_common.fetch_metrics = real_epochs, real_fetch
    wall_s = time.perf_counter() - t
    launches = {k: f.launches for k, f in KERNELS.items()}
    log = log_path.read_bytes()[logged:].decode()
    files = {str(f.relative_to(log_dir)): f.stat().st_size for f in sorted(log_dir.rglob("*"))
             if f.is_file()}
    epoch_ms = [(e - s) * 1e3 for s, _, e, _ in epochs]
    row = {"wall_s": wall_s, "epoch_ms": epoch_ms,
           "first_batch_ms": [(calls[i][0] - s) * 1e3 for s, i, _, _ in epochs],
           "steps": steps, "launches": launches, "files": files}
    parts = {"enqueue": [], "wait": [], "loop": []}
    for s, i, e, j in epochs[1:]:
        for k in range(i, j):
            nxt = calls[k + 1][0] if k + 1 < j else e
            parts["enqueue"].append(calls[k][1] - calls[k][0])
            parts["wait"].append(calls[k][3] - calls[k][2])
            parts["loop"].append(nxt - calls[k][3])
    if parts["enqueue"]:
        row["steady"] = {f"{k}_ms": float(np.mean(v)) * 1e3 for k, v in parts.items()}
        row["steady"]["step_ms"] = sum(row["steady"].values())
        row["steady"]["steps"] = len(parts["enqueue"])
    if epoch_ms:
        row["ms_per_step"] = sum(epoch_ms) / steps
        row["scenes_per_s"] = steps * scenes * 1e3 / sum(epoch_ms)
    say(phase=f"driver_{name}", **row)
    if launches != expect:
        raise AssertionError(f"driver {name}: launches {launches}, expected {expect}")
    if len(calls) != steps or any(len(c) != 4 for c in calls):
        raise AssertionError(f"driver {name}: {len(calls)} timed steps, expected {steps}")
    return {"row": row, "result": result, "log": log}


def driver_trace(name: str, path: Path) -> dict:
    """A driver's ``--profile_steps`` trace read back: over the window from
    its first ``driver_step`` span's start to its last ``fetch_metrics``
    span's end, the device's busy time (the union of its kernels, copies
    and sets) and idle share, and a step's mean queuing (``driver_step``)
    and wait (``fetch_metrics``) on the host. The profiler's own host work
    slows the queuing, so the trace's step is longer than an untraced
    one."""
    events = [e for e in json.loads(path.read_text())["traceEvents"] if e.get("ph") == "X"]

    def spans(pred):
        return sorted((float(e["ts"]), float(e["ts"]) + float(e.get("dur", 0))) for e in events
                      if pred(e))

    steps = spans(lambda e: e.get("cat") == "user_annotation" and e["name"] == "driver_step")
    waits = spans(lambda e: e.get("cat") == "user_annotation" and e["name"] == "fetch_metrics")
    device = spans(lambda e: e.get("cat") in ("kernel", "gpu_memcpy", "gpu_memset"))
    if not steps or len(steps) != len(waits) or not device:
        raise AssertionError(f"driver {name}: the trace holds {len(steps)} steps, {len(waits)} "
                             f"waits and {len(device)} device events")
    lo, hi = steps[0][0], waits[-1][1]
    busy, end = 0.0, lo
    for a, b in device:
        a, b = max(a, end), min(b, hi)
        if b > a:
            busy += b - a
            end = b
    out = {"steps": len(steps), "window_ms": (hi - lo) / 1e3, "device_busy_ms": busy / 1e3,
           "device_idle_share": 1 - busy / (hi - lo),
           "enqueue_ms": float(np.mean([b - a for a, b in steps])) / 1e3,
           "wait_ms": float(np.mean([b - a for a, b in waits])) / 1e3,
           "device_events": len(device)}
    say(phase=f"driver_trace_{name}", **out)
    return out


def eval_subprocess(root: Path, ckpt: Path, data: list, cfg, dev, dataset: str,
                    what: str) -> dict:
    """The eval entry point as run_eval_opt_torch.sh runs it, ``python3 -m
    iou3dmatch_tpu_torch.cli.train --eval --use_iou_for_nms --opt_step 10
    --opt_rate 5e-4 --dump_results`` on ``ckpt`` with the dataset flags
    ``data``, in a subprocess with no device flag: it must log the card as
    its device, and its mAP and AR lines and its first batch's dumps must
    equal those of ``evaluate`` in this process on the same checkpoint and
    batches. Returns the AP and the kernels' launches of the in-process
    ``evaluate`` (counted around it)."""
    ev, inproc = root / f"{what}_eval", root / f"{what}_inproc_dump"
    cmd = [sys.executable, "-m", "iou3dmatch_tpu_torch.cli.train", "--log_dir", str(ev),
           "--detector_checkpoint", str(ckpt), "--eval", "--use_iou_for_nms",
           "--opt_step", str(OPT_STEP), "--opt_rate", str(OPT_RATE), "--dump_results"] + data
    t = time.perf_counter()
    proc = subprocess.run(cmd, cwd=Path(__file__).resolve().parent, capture_output=True,
                          text=True, timeout=600)
    sub_s = time.perf_counter() - t
    if proc.returncode != 0:
        raise AssertionError(f"the eval subprocess exited {proc.returncode}: {proc.stderr[-3000:]}")
    device_line = [x for x in proc.stdout.splitlines() if x.startswith("device: ")]
    if device_line != [f"device: cuda:0 ({torch.cuda.get_device_name(0)})"]:
        raise AssertionError(f"the eval subprocess did not run on the card: {device_line}")
    args = cli_train.parse_args(cmd[3:])
    _, _, eval_ds, _ = cli_common.build_ssl_datasets(args)
    model, _ = build_votenet(dataset, device=dev)
    state = create_train_state(model, with_ema=True)
    checkpoint.load(str(ckpt), state)
    eval_loader = DataLoader(eval_ds, SSL_NL + SSL_NU, shuffle=False, drop_last=False,
                             num_workers=LOADER_WORKERS)
    lines = []
    torch.cuda.synchronize()
    for k in KERNELS.values():
        k.launches = 0
    try:
        _, ap, _ = cli_common.evaluate(
            model, cfg, cli_common.staged(eval_loader, dev),
            cli_common.make_config_dict(cfg, args), lines.append,
            make_eval_loss(model, cfg, generator=torch.Generator(device=dev).manual_seed(2)),
            opt_rate=OPT_RATE, opt_step=OPT_STEP, dump_dir=str(inproc))
        torch.cuda.synchronize()
    finally:
        eval_loader.close()
    launches = {k: f.launches for k, f in KERNELS.items()}
    want = [x for x in lines if x.startswith("eval mAP@")]
    got = [x for x in proc.stdout.splitlines() if x.startswith("eval mAP@")]
    dumps = sorted(os.listdir(inproc))
    same_dumps = dumps == sorted(os.listdir(ev / "dump")) and all(
        (inproc / f).read_bytes() == (ev / "dump" / f).read_bytes() for f in dumps)
    ap = {t: {"mAP": float(m["mAP"]), "AR": float(m["AR"])} for t, m in ap.items()}
    say(phase=f"{what}_eval_subprocess", cmd=" ".join(cmd[1:]), seconds=sub_s,
        device=device_line[0], ap_lines=got, in_process_ap_lines=want, ap=ap,
        dump_files=len(dumps), dumps_equal=same_dumps, in_process_launches=launches)
    if got != want or len(got) != 2 or not same_dumps:
        raise AssertionError(f"the subprocess eval {got} differs from evaluate's {want}, "
                             f"or its dumps do (equal: {same_dumps})")
    if launches["fps"] == 0 or launches["nms"] == 0:
        raise AssertionError(f"the in-process evaluate launched {launches}")
    return {"ap": ap, "launches": launches}


DRIVER_NUM_TARGET = 2048  # phase 9 (g): past the NMS cluster path's 1,024 proposals


def driver_num_target(root: Path, data: list, dev, opt_request: dict) -> dict:
    """Phase 9 (g): the eval entry point as (d) runs it (``--eval
    --use_iou_for_nms --opt_step 10 --opt_rate 5e-4``), in this process, at
    ``--cluster_sampling vote_fps --vote_factor 2 --num_target 2048``: a
    full-width model of those knobs (random weights, seed 0) saved as a
    pretrain checkpoint and loaded by ``--detector_checkpoint``. NMS takes
    its global-matrix path (K > NMS_MAX_BOXES); the first request's keep
    mask (from ``ap_helper.nms_boxes``, wrapped to keep its arguments) is
    held to ``nms_boxes_plain`` on the same proposals on the card.
    Launches: phase 5b's request with the optimisation, FPS 2."""
    model, _ = build_votenet("scannet", device=dev, sampling="vote_fps", vote_factor=2,
                             num_proposal=DRIVER_NUM_TARGET)
    ckpt = root / "vote_fps_k2048.tar"
    checkpoint.save(str(ckpt), create_train_state(model), epoch=0)
    del model
    log = root / "eval_k2048"
    argv = ["--log_dir", str(log), "--detector_checkpoint", str(ckpt), "--eval",
            "--use_iou_for_nms", "--opt_step", str(OPT_STEP), "--opt_rate", str(OPT_RATE),
            "--cluster_sampling", "vote_fps", "--vote_factor", "2", "--num_target",
            str(DRIVER_NUM_TARGET)] + data
    first, real = [], ap_helper.nms_boxes

    def kept(*args, **kw):
        keep = real(*args, **kw)
        if not first:
            first.append((args, kw, keep))
        return keep

    ap_helper.nms_boxes = kept
    try:
        run = driver_run("eval_k2048", cli_train.main, argv, log, 0, SSL_NL + SSL_NU,
                         {**opt_request, "fps": 2 * opt_request["fps"]})
    finally:
        ap_helper.nms_boxes = real
    (args, kw, keep), = first
    want = nms_boxes_plain(*args)
    k = args[2].shape[1]
    say(phase="driver_eval_k2048_picks", proposals=k, keep_shape=list(keep.shape),
        kept=int(keep.sum()), picks_equal_plain=bool(torch.equal(keep, want)),
        ap={t: {m: float(v[m]) for m in ("mAP", "AR")} for t, v in run["result"][1].items()})
    if k != DRIVER_NUM_TARGET or not keep.is_cuda or not torch.equal(keep, want):
        raise AssertionError(f"phase 9 (g): NMS over {k} proposals on {keep.device} picks "
                             f"otherwise than its plain version")
    return run


def phase_drivers(cfg, dev, eval_request: dict, root: Path, opt_request: dict) -> dict:
    """Phase 9, the drivers at full width on ScanNet-format dumps (written
    again as phase 8 writes them): (a) ``cli/pretrain.main`` of 3 epochs of
    one step on the 8-scan labeled list and one eval, (b) ``cli/train.main``
    with run_train.sh's flags from (a)'s checkpoint, 2 epochs of 2 steps
    and one eval, (c) its ``--resume`` for a third epoch, (d)
    ``python3 -m iou3dmatch_tpu_torch.cli.train --eval --use_iou_for_nms
    --opt_step 10 --opt_rate 5e-4`` on (c)'s checkpoint in a subprocess
    with no device flag, its mAP and AR lines and its first batch's dumps
    equal to those of ``evaluate`` in this process on the same checkpoint
    and batches, (e) one pretrain epoch with ``--cluster_sampling
    vote_fps``, (f) 2 epochs of each driver on more scans without eval
    (pretrain on every train scan; SSL with 24 labeled), the steady cost of
    a driver's step, three steps of each traced and the traces read by
    ``driver_trace``, (g) ``driver_num_target``: (d)'s eval at 2,048
    proposals a scene. Launches: (a) 3 pretrain steps and one eval request of
    phase 5b's, (b) 4 SSL steps and one eval request, (c) 2 SSL steps, (e)
    a pretrain step with FPS 2, (f) their steps, (g) one eval request with
    the optimisation (``opt_request``) and FPS 2. Everything goes under
    ``root``, which phase 12 reads after it: the dumps, (a)'s checkpoint and
    a copy of (b)'s. Returns each run's launches."""
    say(phase="driver_dumps", **write_dumps(root / "data", cfg, 90))
    data = ["--dataset", "scannet", "--data_path", str(root / "data"),
            "--labeled_sample_list", "labeled.txt"]

    def times(launches: dict, n: int) -> dict:
        return {k: v * n for k, v in launches.items()}

    def plus(*parts) -> dict:
        return {k: sum(p[k] for p in parts) for k in KERNELS}

    out = {}
    pre = root / "pretrain"
    out["pretrain"] = driver_run(
        "pretrain", cli_pretrain.main,
        ["--log_dir", str(pre), "--batch_size", str(B), "--max_epoch", "3",
         "--eval_interval", "3", "--print_interval", "1"] + data, pre, 3, B,
        plus(times(TRAIN_LAUNCHES, 3), eval_request))
    if not re.search(r"^eval mAP@0\.5: ", out["pretrain"]["log"], re.M):
        raise AssertionError("the pretrain driver logged no eval")

    ssl = root / "ssl"
    ssl_flags = ["--log_dir", str(ssl), "--batch_size", f"{SSL_NL},{SSL_NU}"] + data
    out["ssl"] = driver_run(
        "ssl", cli_train.main,
        ssl_flags + ["--detector_checkpoint", str(pre / "checkpoint.tar"), "--view_stats",
                     "--reference_exact_step", "--max_epoch", "2", "--eval_interval", "2",
                     "--print_interval", "1"], ssl, 4, SSL_NL + SSL_NU,
        plus(times(SSL_LAUNCHES, 4), eval_request))
    # phase 12 holds its driver run to (b): (c) overwrites the checkpoint and appends to the log
    shutil.copy(ssl / "checkpoint.tar", root / "ssl_b_checkpoint.tar")
    shutil.copy(ssl / "log_train.txt", root / "ssl_b_log.txt")
    out["resume"] = driver_run(
        "resume", cli_train.main,
        ssl_flags + ["--resume", "--view_stats", "--reference_exact_step", "--max_epoch", "3",
                     "--eval_interval", "2", "--print_interval", "1"], ssl, 2,
        SSL_NL + SSL_NU, times(SSL_LAUNCHES, 2))
    resumed = out["resume"]["log"].split("resumed from")[-1]
    saved = checkpoint.read(str(ssl / "checkpoint.tar"))
    if ("at epoch 2" not in resumed.splitlines()[0] or "**** EPOCH 002 ****" not in resumed
            or "**** EPOCH 000 ****" in resumed or saved["epoch"] != 3 or saved["step"] != 6):
        raise AssertionError(f"the resumed run did not continue at epoch 2: checkpoint epoch "
                             f"{saved['epoch']}, step {saved['step']}")

    # (d) the eval entry point as run_eval_opt_torch.sh runs it
    eval_subprocess(root, ssl / "checkpoint.tar", data, cfg, dev, "scannet", "driver")

    # (f) epochs of several steps, no eval: the steady cost of a step
    # through the driver beside phase 8's loader-fed step
    (root / "data" / "meta_data" / "labeled_24.txt").write_text(
        "\n".join(f"scene{i:04d}_00" for i in range(24)) + "\n")
    steady = root / "steady_pretrain"
    out["steady_pretrain"] = driver_run(
        "steady_pretrain", cli_pretrain.main,
        ["--log_dir", str(steady), "--batch_size", str(B), "--max_epoch", "2",
         "--eval_interval", "0", "--print_interval", "5", "--profile_steps", "3",
         "--dataset", "scannet", "--data_path", str(root / "data")], steady,
        2 * (DUMP_TRAIN // B), B, times(TRAIN_LAUNCHES, 2 * (DUMP_TRAIN // B)))
    driver_trace("steady_pretrain", steady / "profile" / "trace.json")
    steady = root / "steady_ssl"
    out["steady_ssl"] = driver_run(
        "steady_ssl", cli_train.main,
        ["--log_dir", str(steady), "--batch_size", f"{SSL_NL},{SSL_NU}", "--max_epoch", "2",
         "--eval_interval", "0", "--print_interval", "6", "--view_stats",
         "--reference_exact_step", "--profile_steps", "3", "--dataset", "scannet",
         "--data_path", str(root / "data"), "--labeled_sample_list", "labeled_24.txt"],
        steady, 2 * (24 // SSL_NL), SSL_NL + SSL_NU, times(SSL_LAUNCHES, 2 * (24 // SSL_NL)))
    driver_trace("steady_ssl", steady / "profile" / "trace.json")

    vote = root / "vote_fps"
    out["vote_fps"] = driver_run(
        "vote_fps", cli_pretrain.main,
        ["--log_dir", str(vote), "--batch_size", str(B), "--max_epoch", "1",
         "--eval_interval", "0", "--cluster_sampling", "vote_fps"] + data, vote, 1, B,
        {**TRAIN_LAUNCHES, "fps": 2})
    out["eval_k2048"] = driver_num_target(root, data, dev, opt_request)
    return {k: v["row"]["launches"] for k, v in out.items()}


def sunrgbd_frame(rng, n: int, cfg) -> tuple:
    """One synthetic SUN RGB-D frame in upright depth coordinates (z up, y
    away from the camera): 3-8 boxes of distinct classes of the 10, sizes
    the class mean x U(0.8, 1.2), headings uniform in [-pi, pi), standing on
    the floor of a room 4-6 m wide and deep; 40 % of the points inside the
    boxes (within 0.95 of their half extents), the rest on the floor and 3
    or 4 walls; rgb in [0, 1]. Returns (points (n, 6) float32, label lines
    ``class x y w h cx cy cz l w h ox oy`` with HALF extents, as the label
    files hold them, and the heading -atan2(oy, ox))."""
    k = rng.randint(3, 9)
    cls = rng.choice(cfg.num_class, k, replace=False)
    size = cfg.mean_size_arr[cls] * rng.uniform(0.8, 1.2, (k, 3))
    heading = rng.uniform(-np.pi, np.pi, k)
    width, depth = rng.uniform(4.0, 6.0, 2)
    ctr = np.c_[rng.uniform(-width / 2 + 0.8, width / 2 - 0.8, k), rng.uniform(1.5, depth, k),
                size[:, 2] / 2]
    owner = np.repeat(np.arange(k), rng.multinomial(n * 2 // 5, np.full(k, 1 / k)))
    local = rng.uniform(-0.95, 0.95, (len(owner), 3)) * size[owner] / 2
    c, s = np.cos(-heading[owner]), np.sin(-heading[owner])  # rotz(-heading), box -> frame
    box_xyz = np.c_[c * local[:, 0] - s * local[:, 1], s * local[:, 0] + c * local[:, 1],
                    local[:, 2]] + ctr[owner]
    m, walls = n - len(owner), rng.randint(3, 5)
    face = rng.choice(1 + walls, m, p=[0.4] + [0.6 / walls] * walls)  # floor, back, left, right, front
    x, y = rng.uniform(-width / 2, width / 2, m), rng.uniform(0.5, 0.5 + depth, m)
    z = rng.uniform(0.0, 2.6, m)
    room = np.c_[np.select([face == 2, face == 3], [-width / 2, width / 2], x),
                 np.select([face == 1, face == 4], [0.5 + depth, 0.5], y), np.where(face == 0, 0.0, z)]
    xyz = np.concatenate([box_xyz, room])[rng.permutation(n)]
    pc = np.c_[xyz, rng.uniform(0, 1, (n, 3))].astype(np.float32)
    lines = [f"{cfg.class2type[c_]} 0 0 1 1 {x_:f} {y_:f} {z_:f} {l / 2:f} {w / 2:f} {h / 2:f} "
             f"{np.cos(t):f} {-np.sin(t):f}"
             for c_, (x_, y_, z_), (l, w, h), t in zip(cls, ctr, size, heading)]
    return pc, lines


def write_sunrgbd_trainval(root: Path, cfg, seed: int, n_train: int, n_val: int, n: int) -> dict:
    """``n_train + n_val`` frames of ``sunrgbd_frame`` under ``root`` in the
    ``sunrgbd_trainval`` layout (``depth/%06d.mat`` with ``instance`` by
    ``scipy.io.savemat``, ``label_v1/``, ``calib/`` of an upright camera,
    ``train_data_idx.txt`` 1..n_train, ``val_data_idx.txt`` the rest).
    Returns the frames, boxes, bytes and seconds."""
    import scipy.io as sio

    t = time.perf_counter()
    rng = np.random.RandomState(seed)
    for sub in ("depth", "label_v1", "calib"):
        (root / sub).mkdir(parents=True, exist_ok=True)
    calib = "1 0 0 0 1 0 0 0 1\n529.5 0 0 0 525.0 0 365.0 265.0 1\n"  # Rtilt, K column-major
    boxes = 0
    for idx in range(1, n_train + n_val + 1):
        pc, lines = sunrgbd_frame(rng, n, cfg)
        sio.savemat(root / "depth" / f"{idx:06d}.mat", {"instance": pc})
        (root / "label_v1" / f"{idx:06d}.txt").write_text("\n".join(lines) + "\n")
        (root / "calib" / f"{idx:06d}.txt").write_text(calib)
        boxes += len(lines)
    (root / "train_data_idx.txt").write_text("".join(f"{i}\n" for i in range(1, n_train + 1)))
    (root / "val_data_idx.txt").write_text(
        "".join(f"{i}\n" for i in range(n_train + 1, n_train + n_val + 1)))
    return {"frames": n_train + n_val, "points": n, "boxes": boxes, "bytes": dir_bytes(root),
            "seconds": time.perf_counter() - t}


def dir_bytes(root: Path) -> int:
    return sum(f.stat().st_size for f in root.rglob("*") if f.is_file())


def prep_sunrgbd_dumps(trainval: Path, data: Path, processes: int) -> dict:
    """``python -m iou3dmatch_tpu_torch.data.prep_sunrgbd --use_v1`` over the
    train and the val index files into the 50k v1 dumps, each file's indices
    cut into ``processes`` shares run at once (a share a seed), then
    ``gen_split sunrgbd 0.05`` into ``trainval``. Returns the frames, boxes
    and voting points written and the seconds of each step."""
    t = time.perf_counter()
    procs = []
    for split in ("train", "val"):
        out = data / f"sunrgbd_pc_bbox_votes_50k_v1_{split}"
        idx = (trainval / f"{split}_data_idx.txt").read_text().split()
        for part in range(processes):
            share = idx[part::processes]
            if not share:
                continue
            f = trainval / f"{split}_idx_{part}.txt"
            f.write_text("\n".join(share) + "\n")
            procs.append(subprocess.Popen(
                [sys.executable, "-m", "iou3dmatch_tpu_torch.data.prep_sunrgbd", "--root",
                 str(trainval), "--idx_file", str(f), "--output_dir", str(out), "--use_v1",
                 "--seed", str(part)], cwd=Path(__file__).resolve().parent,
                stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True))
    outs = [p.communicate(timeout=600) for p in procs]
    for p, (so, se) in zip(procs, outs):
        if p.returncode != 0 or "FAILED" in so:
            raise AssertionError(f"prep_sunrgbd exited {p.returncode}: {so[-2000:]} {se[-2000:]}")
    prep_s = time.perf_counter() - t
    t = time.perf_counter()
    split = gen_split.main(["sunrgbd", str(SUN_RATIO), "0", "--data_path",
                            str(data / "sunrgbd_pc_bbox_votes_50k_v1_train"), "--out_dir",
                            str(trainval), "--seed", "0"])
    split_s = time.perf_counter() - t
    counts = {}
    for s in ("train", "val"):
        d = data / f"sunrgbd_pc_bbox_votes_50k_v1_{s}"
        bboxes = [np.load(f) for f in sorted(d.glob("*_bbox.npy"))]
        votes = 0
        for f in sorted(d.glob("*_votes.npz")):
            with np.load(f) as z:
                votes += int(z["point_votes"][:, 0].sum())
        counts[s] = {"frames": len(bboxes), "boxes": int(sum(len(b) for b in bboxes)),
                     "voting_points": votes}
    labeled = Path(split).read_text().split()
    return {"counts": counts, "labeled": len(labeled), "split": Path(split).name,
            "prep_s": prep_s, "split_s": split_s, "processes": len(procs)}


def write_scannet_raw(root: Path, cfg, seed: int, names, n: int) -> tuple:
    """Raw ScanNet scans as data/prep_scannet.py reads them (a binary PLY of
    ``n`` vertices, the aggregation and segmentation JSON, the meta txt):
    ``scannet_scan``'s rooms turned about z and moved, the meta's
    ``axisAlignment`` the move back; a segment an instance. Returns the
    label map's path and each scan's boxes in the aligned frame."""
    rng = np.random.RandomState(seed)
    label_names = {1: "wall", 2: "floor", **{int(i): f"nyu40_{int(i)}" for i in cfg.nyu40ids}}
    tsv = root / "labels.tsv"
    root.mkdir(parents=True, exist_ok=True)
    tsv.write_text("raw_category\tnyu40id\n"
                   + "".join(f"{v}\t{k}\n" for k, v in label_names.items()))
    vertex = np.dtype([("x", "<f4"), ("y", "<f4"), ("z", "<f4"), ("red", "u1"), ("green", "u1"),
                       ("blue", "u1"), ("alpha", "u1")])
    boxes_of = {}
    for name in names:
        verts, ins, sem, boxes = scannet_scan(rng, n, cfg)
        align = np.eye(4)
        align[:3, :3], align[:3, 3] = rotz(rng.uniform(-np.pi, np.pi)), rng.uniform(-1, 1, 3)
        ply = np.zeros(n, vertex)
        raw = (verts[:, :3] - align[:3, 3]) @ align[:3, :3]  # the inverse move
        for j, c in enumerate(("x", "y", "z")):
            ply[c] = raw[:, j]
        for j, c in enumerate(("red", "green", "blue")):
            ply[c] = verts[:, 3 + j]
        ply["alpha"] = 255
        d = root / name
        d.mkdir()
        header = ("ply\nformat binary_little_endian 1.0\n"
                  f"element vertex {n}\n"
                  "property float x\nproperty float y\nproperty float z\n"
                  "property uchar red\nproperty uchar green\nproperty uchar blue\n"
                  "property uchar alpha\nend_header\n")
        (d / f"{name}_vh_clean_2.ply").write_bytes(header.encode() + ply.tobytes())
        (d / f"{name}_vh_clean_2.0.010000.segs.json").write_text(
            json.dumps({"segIndices": ins.tolist()}))
        groups = [{"objectId": int(j) - 1, "label": label_names[int(sem[ins == j][0])],
                   "segments": [int(j)]} for j in np.unique(ins)]
        (d / f"{name}.aggregation.json").write_text(json.dumps({"segGroups": groups}))
        (d / f"{name}.txt").write_text(
            f"axisAlignment = {' '.join(str(float(v)) for v in align.ravel())}\n")
        boxes_of[name] = boxes
    return tsv, boxes_of


def scannet_raw_check(root: Path, cfg) -> dict:
    """``prep_scannet`` on RAW_SCANS raw scans of RAW_VERTICES vertices, its
    boxes against the scans' own (atol 1e-3: a float32 round trip of the
    alignment), its 50,000-vertex cap, and the dumps read back through
    ``ScannetDetectionDataset`` (train split, height on, 40,000 points)."""
    names = [f"scene{i:04d}_00" for i in range(RAW_SCANS)]
    tsv, want = write_scannet_raw(root / "scans", cfg, 110, names, RAW_VERTICES)
    out, meta = root / "scannet_train_detection_data", root / "meta_data"
    meta.mkdir()
    (meta / "scannetv2_train.txt").write_text("\n".join(names) + "\n")
    t = time.perf_counter()
    prep_scannet.main(["--scannet_dir", str(root / "scans"), "--label_map", str(tsv),
                       "--scan_list", str(meta / "scannetv2_train.txt"), "--output_dir", str(out),
                       "--seed", "0"])
    prep_s = time.perf_counter() - t
    diffs = []
    for name in names:
        got, verts = np.load(out / f"{name}_bbox.npy"), np.load(out / f"{name}_vert.npy")
        if got.shape != want[name].shape or \
                len(verts) != min(RAW_VERTICES, prep_scannet.MAX_NUM_POINT):
            raise AssertionError(f"prep_scannet wrote {got.shape} boxes for {want[name].shape} "
                                 f"and {len(verts)} vertices")
        diffs.append(max_err(torch.from_numpy(got), torch.from_numpy(want[name])))
    ds = ScannetDetectionDataset(str(out), str(meta), "train", num_points=N, use_height=True)
    for i, name in enumerate(ds.scan_names):
        sample = ds[i]
        if sample["point_clouds"].shape != (N, 4) or not np.isfinite(sample["point_clouds"]).all() \
                or int(sample["box_label_mask"].sum()) != len(want[name]):
            raise AssertionError(f"the ScanNet dataset read {name} wrongly")
    out = {"scans": len(names), "vertices": RAW_VERTICES, "prep_s": prep_s,
           "boxes": int(sum(len(b) for b in want.values())), "box_max_diff": max(diffs),
           "dataset_scenes": len(ds)}
    if out["box_max_diff"] > 1e-3:
        raise AssertionError(f"prep_scannet's boxes are off by {out['box_max_diff']}")
    return out


def boxes_at_anchors(batch: dict, i: int, anchor: np.ndarray, rng) -> None:
    """Scene ``i``'s GT as ANCHORED_BOXES boxes within 0.05 of distinct
    proposals of the random model's (``anchor``, (K, 3), ``vote_anchors``),
    each taking the heading, size and class of one of the frame's own boxes
    in turn: a SUN RGB-D frame's 3-8 boxes alone leave too few positives
    for the gates (a step's ``pos_ratio`` read 0.016), and the rotated GT
    stays the data's."""
    m = int(batch["box_label_mask"][i].sum())
    src = np.arange(ANCHORED_BOXES) % m
    for k in BOX_KEYS:
        batch[k][i, :ANCHORED_BOXES] = batch[k][i, src]
    batch["box_label_mask"][i, :ANCHORED_BOXES] = 1
    batch["center_label"][i, :ANCHORED_BOXES] = anchor[rng.choice(K, ANCHORED_BOXES,
                                                                  replace=False)] + \
        rng.uniform(-0.05, 0.05, (ANCHORED_BOXES, 3))


def sunrgbd_train_batch(ds, rows, dev, anchors: bool) -> dict:
    """The scenes ``rows`` of ``ds`` collated; with ``anchors`` each scene's
    GT goes to the random model's proposals (``boxes_at_anchors``), so that
    the step has positives and IoU labels above 0."""
    np.random.seed(5)
    batch = collate([ds[i] for i in rows])
    if anchors:
        anchor = vote_anchors(batch["point_clouds"], dev, "sunrgbd")
        rng = np.random.RandomState(6)
        for i in range(len(rows)):
            boxes_at_anchors(batch, i, anchor[i], rng)
    return batch


def sunrgbd_ssl_batch(labeled, unlabeled, dev) -> dict:
    """One labeled and one unlabeled scene as ``SSLBatcher`` merges them
    (the unlabeled one with its raw-frame GT, flipped in x only, turned by
    up to 30 degrees, scaled), the labeled scene's GT at the random model's
    proposals (``boxes_at_anchors``)."""
    np.random.seed(8)
    loaders = [DataLoader(ds, 1, shuffle=False, num_workers=0) for ds in (labeled, unlabeled)]
    try:
        batch = next(iter(SSLBatcher(*loaders)))
    finally:
        for ld in loaders:
            ld.close()
    # both scenes: train-mode BatchNorm moves the votes with the batch
    anchor = vote_anchors(batch["point_clouds"], dev, "sunrgbd")
    boxes_at_anchors(batch, 0, anchor[0], np.random.RandomState(7))
    return batch


def recorded(module, name: str, calls: list):
    """``module.name`` replaced by a wrapper that appends (args, result) of
    each call to ``calls``; returns the function to restore."""
    real = getattr(module, name)

    def wrapper(*args):
        calls.append((args, real(*args)))
        return calls[-1][1]

    setattr(module, name, wrapper)
    return real


def sunrgbd_kernel_rows(cfg, dev, ops_per_s, rows, train_ds, eval_ds) -> None:
    """Three kernels at SUN RGB-D's shapes, appended to ``rows``: the rotated
    IoU of a pretrain step of 8 frames at its (8, 128, 7) x (8, 64, 7),
    proposals against the frames' rotated GT, on the step's own inputs;
    class-aware NMS at the eval forward's (8, 128) boxes of 10 classes on
    its own inputs; LHS at (8, 64) clustered boxes of the 10 classes."""
    floor = launch_floor_ms()
    model, _ = build_votenet("sunrgbd", device=dev)
    state = create_train_state(model)
    batch = {k: torch.from_numpy(np.asarray(v)).to(dev)
             for k, v in sunrgbd_train_batch(train_ds, range(B), dev, False).items()}
    calls = []
    real = recorded(iou_labels_mod, "boxes_iou3d_paired_rows", calls)
    try:
        make_pretrain_step(cfg)(state, batch, LR, get_bn_momentum(0))
    finally:
        iou_labels_mod.boxes_iou3d_paired_rows = real
    a, b = (x.float().contiguous() for x in calls[0][0])
    ops, scan_ops, need = iou_ops(a, b)
    nbytes = (a.numel() + b.numel() + B * K * G) * 4
    _, r = check_kernel(
        "iou3d", f"sunrgbd pretrain, rotated GT ({B},{K},7)x({B},{G},7)", box_pairs,
        box_pairs_plain, None, (a, b, "iou3d"), nbytes, lambda _: ops, ops_per_s, 10, main=False,
        agree=lambda got, want: bool(torch.allclose(got, want, rtol=0, atol=1e-5)))
    r.update(dataset="sunrgbd", pairs_needing_overlap=need, gt_boxes=int((b[..., 0] > -999).sum()),
             scan_bound_ms=max(nbytes / HBM_BYTES_PER_S, scan_ops / ops_per_s) * 1e3)
    rows["iou3d"].append(r)

    model.eval()
    eval_batch = collate([eval_ds[i] for i in range(B)])
    with torch.no_grad():
        ep = model(torch.from_numpy(eval_batch["point_clouds"]).to(dev))
    calls = []
    real = recorded(ap_helper, "nms_boxes", calls)
    try:
        pack_predictions(ep, eval_config_dict(cfg, use_iou_for_nms=True))
    finally:
        ap_helper.nms_boxes = real
    (mins, maxs, scores, cls, valid, mode, _, thresh), _ = calls[0]
    if mode != "3d_cls" or valid is not None:
        raise AssertionError(f"the eval's NMS ran {mode} with a valid mask {valid is not None}")
    nms_row(dev, ops_per_s, rows, floor, f"sunrgbd eval ({B},{K}) 3d_cls float64, 10 classes, "
            f"IoU > {thresh}", mode, (mins, maxs, scores, cls), thresh, False)
    rows["nms"][-1]["dataset"] = "sunrgbd"
    lhs_rows(dev, ops_per_s, rows, cfg=cfg, seed=41, what="sunrgbd 10 classes ", main=False)
    rows["lhs"][-1]["dataset"] = "sunrgbd"


def phase_sunrgbd(dev, card: str, ops_per_s: float, rows: dict, eval_request: dict) -> dict:
    """Phase 10, SUN RGB-D end to end through the port at full width (10
    classes, 12 heading bins, 10 size clusters; SA 2048/1024/512/256, 128
    proposals, 40,000 points): (a) SUN_TRAIN + SUN_VAL synthetic frames
    written in the ``sunrgbd_trainval`` layout, ``prep_sunrgbd`` to the 50k
    v1 dumps, ``gen_split sunrgbd 0.05``; ``prep_scannet`` on raw ScanNet
    scans read back by its dataset; (b) the forward on one frame on the card
    against the CPU; the pretrain step's IoU labels on rotated GT and the
    first SSL step (``trans_angle`` on) on the card against the CPU; the IoU,
    NMS and LHS at SUN RGB-D's shapes; (c) ``cli/pretrain.main`` (3 one-step
    epochs and one eval), ``cli/train.main`` with run_train.sh's flags from
    its checkpoint (2 epochs of 2 steps and one eval) and the eval entry
    point with IoU optimisation as a subprocess, its AP lines equal to an
    in-process ``evaluate``'s; (d) each run's ms and scenes/s a step and
    launches a step, beside the card's name and power limit. Returns each
    run's launches."""
    cfg = get_config("sunrgbd")
    t0 = time.perf_counter()
    root = Path(tempfile.mkdtemp(prefix="chip_smoke_sunrgbd_"))
    try:
        data, trainval = root / "data", root / "data" / "sunrgbd_trainval"
        frames = write_sunrgbd_trainval(trainval, cfg, 100, SUN_TRAIN, SUN_VAL, SUN_POINTS)
        prep = prep_sunrgbd_dumps(trainval, data, SUN_PREP_PROCESSES)
        say(phase="sunrgbd_prep", frames=frames, **prep,
            dumps_bytes=dir_bytes(data) - frames["bytes"])
        if (prep["counts"]["train"]["frames"], prep["counts"]["val"]["frames"],
                prep["labeled"]) != (SUN_TRAIN, SUN_VAL, int(SUN_RATIO * SUN_TRAIN)):
            raise AssertionError(f"the SUN RGB-D prep wrote {prep}")
        say(phase="sunrgbd_scannet_raw_prep",
            **scannet_raw_check(root / "scannet", get_config("scannet")))

        args = types.SimpleNamespace(dataset="sunrgbd", data_path=str(data),
                                     labeled_sample_list=prep["split"], num_point=N, no_height=False,
                                     use_color=False, use_sunrgbd_v2=False, synthetic=False,
                                     view_stats=True)
        train_ds, eval_ds, _ = cli_common.build_supervised_datasets(args)
        labeled_ds, unlabeled_ds, _, _ = cli_common.build_ssl_datasets(args)
        # the datasets double the half extents on disk: the GT sizes of an
        # unaugmented frame lie within 20 % of their class means, not at half
        sample = eval_ds[0]
        m = int(sample["box_label_mask"].sum())
        rel = np.abs(sample["size_residual_label"][:m]) / \
            cfg.mean_size_arr[sample["size_class_label"][:m]]
        if not (m > 0 and rel.max() < 0.3):
            raise AssertionError(f"{m} GT boxes, sizes off their class means by up to {rel.max()}")

        model, _ = build_votenet("sunrgbd", device=dev)
        phase_forward(model, dev, {}, "sunrgbd", eval_ds[0]["point_clouds"][None])
        train_check(cfg, dev, sunrgbd_train_batch(train_ds, (0, 1), dev, True), "sunrgbd",
                    "sunrgbd_train_vs_cpu", iou_labels=True)
        ssl = ssl_check(cfg, dev, "sunrgbd", sunrgbd_ssl_batch(labeled_ds, unlabeled_ds, dev),
                        "sunrgbd_ssl_vs_cpu")
        sunrgbd_kernel_rows(cfg, dev, ops_per_s, rows, train_ds, eval_ds)

        flags = ["--dataset", "sunrgbd", "--data_path", str(data), "--labeled_sample_list",
                 prep["split"]]

        def plus(*parts) -> dict:
            return {k: sum(p[k] for p in parts) for k in KERNELS}

        def times(launches: dict, n: int) -> dict:
            return {k: v * n for k, v in launches.items()}

        out = {}
        pre = root / "pretrain"
        out["pretrain"] = driver_run(
            "sunrgbd_pretrain", cli_pretrain.main,
            ["--log_dir", str(pre), "--batch_size", str(B), "--max_epoch", "3",
             "--eval_interval", "3", "--print_interval", "1"] + flags, pre, 3, B,
            plus(times(TRAIN_LAUNCHES, 3), eval_request))
        ssl_dir = root / "ssl"
        out["ssl"] = driver_run(
            "sunrgbd_ssl", cli_train.main,
            ["--log_dir", str(ssl_dir), "--batch_size", f"{SSL_NL},{SSL_NU}",
             "--detector_checkpoint", str(pre / "checkpoint.tar"), "--view_stats",
             "--reference_exact_step", "--max_epoch", "2", "--eval_interval", "2",
             "--print_interval", "1"] + flags, ssl_dir, 4, SSL_NL + SSL_NU,
            plus(times(SSL_LAUNCHES, 4), eval_request))
        for run in ("pretrain", "ssl"):
            if not re.search(r"^eval mAP@0\.5: ", out[run]["log"], re.M):
                raise AssertionError(f"the SUN RGB-D {run} driver logged no eval")
        ev = eval_subprocess(root, ssl_dir / "checkpoint.tar", flags, cfg, dev, "sunrgbd",
                             "sunrgbd")
        size = dir_bytes(root)
        steps = {"pretrain": (3, TRAIN_LAUNCHES), "ssl": (4, SSL_LAUNCHES)}
        per_step = {run: {"ms_per_step": out[run]["row"].get("ms_per_step"),
                          "scenes_per_s": out[run]["row"].get("scenes_per_s"),
                          "launches_per_step": {k: (out[run]["row"]["launches"][k]
                                                    - eval_request[k]) / n for k in KERNELS}}
                    for run, (n, _) in steps.items()}
        say(phase="sunrgbd", card=card, seconds=time.perf_counter() - t0, runs=per_step,
            first_ssl_step=ssl, eval_ap=ev["ap"], temp_dir_bytes=size, reduced=SUN_REDUCED)
        for run, (n, want) in steps.items():
            if per_step[run]["launches_per_step"] != {k: float(v) for k, v in want.items()}:
                raise AssertionError(f"SUN RGB-D {run}: launches a step {per_step[run]}")
        if size >= SUN_DIR_LIMIT:
            raise AssertionError(f"phase 10's temporary directory holds {size} bytes")
        launches = {k: v["row"]["launches"] for k, v in out.items()}
        launches["eval"] = ev["launches"]
        return launches
    finally:
        shutil.rmtree(root)


# Phase 11's modules at SA1: PointnetSAModuleMSGVotes' two scales, as the
# reference's MSG backbones group a room (pointnet2_modules.py:506-525)
MSG_SA1 = dict(npoint=NPOINT, radii=(0.2, 0.4), nsamples=(64, 128),
               mlps=((1, 64, 64, 128), (1, 64, 64, 128)))
LIB_REPS = 5


def _cosine(a: torch.Tensor, b: torch.Tensor) -> float:
    a, b = a.double().ravel(), b.double().ravel()
    return float(a @ b / (a.norm() * b.norm()))


def library_check(name: str, make, inputs, dev, n_grad: int, expect: dict, call=None) -> dict:
    """Module ``make()`` (weights from a fixed seed, built on the CPU and
    copied to the card), in train mode at BN momentum 0.1: on the first
    scene of ``inputs(b)`` (a tuple of CPU tensors for b scenes, the first
    ``n_grad`` taking a gradient) card against CPU, the first output (the
    indices, where a module returns them last, equal) within atol and rtol
    1e-3, the gradients of a random projection of the first float output
    with respect to the inputs and to the parameters with cosine > 0.999;
    then forward and backward at B scenes timed by CUDA events, and their
    launches, which must equal ``expect``. ``call(module, *args)`` runs it
    (the module itself by default) and returns its outputs as a tuple."""
    call = call or (lambda m, *a: m(*a))
    mod_cpu = make()
    mod_gpu = make().to(dev)
    for m in (mod_cpu, mod_gpu):
        m.train()
        set_bn_momentum(m, 0.1)

    def run(m, args, where):
        args = [a.to(where).clone(memory_format=torch.contiguous_format).requires_grad_(i < n_grad)
                for i, a in enumerate(args)]
        outs = call(m, *args)
        out = next(o for o in outs if o is not None and o.is_floating_point() and o.requires_grad)
        w = torch.randn(out.shape, generator=torch.Generator().manual_seed(3)).to(where)
        (out * w).sum().backward()
        grads = [a.grad for a in args[:n_grad]]
        params = [p.grad for p in m.parameters()]
        return outs, grads, params

    one = tuple(t[:1] for t in inputs(1))
    (outs_g, grads_g, params_g), (outs_c, grads_c, params_c) = (
        run(mod_gpu, one, dev), run(mod_cpu, one, torch.device("cpu")))
    row = {"module": name, "diffs": [], "grad_cosines": []}
    for a, b in zip(outs_g, outs_c):
        if a is None:
            continue
        a = a.detach().cpu()
        if not a.is_floating_point():
            if not torch.equal(a, b):
                raise AssertionError(f"{name}: indices differ between the card and the CPU")
            continue
        row["diffs"].append(max_err(a, b.detach()))
        if not (torch.isfinite(a).all() and torch.allclose(a, b.detach(), rtol=1e-3, atol=1e-3)):
            raise AssertionError(f"{name}: outputs differ between the card and the CPU: {row}")
    pairs = list(zip(grads_g, grads_c))
    if params_c:
        pairs.append((torch.cat([g.cpu().ravel() for g in params_g]),
                      torch.cat([g.ravel() for g in params_c])))
    for a, b in pairs:
        row["grad_cosines"].append(_cosine(a.cpu(), b))
    if not all(c > 0.999 for c in row["grad_cosines"]):
        raise AssertionError(f"{name}: gradient cosines {row['grad_cosines']}")

    full = [a.to(dev).clone(memory_format=torch.contiguous_format).requires_grad_(i < n_grad)
            for i, a in enumerate(inputs(B))]

    def step():
        mod_gpu.zero_grad(set_to_none=True)
        outs = call(mod_gpu, *full)
        out = next(o for o in outs if o is not None and o.is_floating_point() and o.requires_grad)
        out.sum().backward()

    for fn in KERNELS.values():
        fn.launches = 0
    step()
    torch.cuda.synchronize()
    launches = {k: fn.launches for k, fn in KERNELS.items() if fn.launches}
    row.update(scenes=B, launches=launches, fwd_bwd_ms=cuda_ms(step, 1, LIB_REPS))
    say(phase="library", **row, tol="atol 1e-3 rtol 1e-3, gradient cosine > 0.999")
    if launches != expect:
        raise AssertionError(f"{name}: launches {launches}, expected {expect}")
    return row


def phase_library(dev) -> dict:
    """Phase 11: the PointNet++ modules VoteNet leaves unused, at full width
    on rooms of N points (``make_scenes``): each held card against CPU on
    one scene and timed at B scenes (``library_check``), the resampling and
    RandomDropout on the card against their CPU cores."""
    t0 = time.perf_counter()
    pc = torch.from_numpy(make_scenes(30, B, N))
    xyz, height = pc[..., :3].contiguous(), pc[..., 3:].contiguous()
    gen = lambda: torch.Generator().manual_seed(0)  # noqa: E731
    rng = np.random.RandomState(31)
    sa1 = furthest_point_sample(xyz.to(dev), NPOINT).long().cpu()
    centers = xyz[torch.arange(B)[:, None], sa1].contiguous()  # FPS-ordered, as SA1 gives SA2
    f128 = torch.from_numpy(rng.randn(B, NPOINT, 128).astype(np.float32))
    f256 = torch.from_numpy(rng.randn(B, 1024, 256).astype(np.float32))
    out = {}

    def clouds(b):
        return height[:b], xyz[:b]

    def by_features(m, feats, pts, *rest):
        return m(pts, feats, *rest)

    out["msg_votes"] = library_check(
        "PointnetSAModuleMSGVotes SA1 r0.2 ns64 + r0.4 ns128",
        lambda: pointnet2.PointnetSAModuleMSGVotes(generator=gen(), **MSG_SA1), clouds, dev, 1,
        {"fps": 1, "ball_query": 2, "gather": 2, "gather_bwd": 2}, by_features)

    # sample_uniformly: the card draws its own u; its resampling is held to
    # the CPU core on the card's indices and draws, then the module runs
    g = torch.Generator(device=dev)
    ctr = centers.to(dev)
    for radius, ns in zip(MSG_SA1["radii"], MSG_SA1["nsamples"]):
        idx = ball_query(radius, ns, xyz.to(dev), ctr)
        new, cnt = pointnet2.uniform_resample_idx(idx, g.manual_seed(ns))
        u = torch.rand(idx.shape, generator=g.manual_seed(ns), device=dev)
        want = pointnet2.uniform_resample_from(idx.cpu(), u.cpu())
        if not (torch.equal(new.cpu(), want[0]) and torch.equal(cnt.cpu(), want[1])
                and bool((cnt >= 1).all()) and torch.equal(new[..., 0], idx[..., 0])):
            raise AssertionError(f"uniform resampling at ns {ns} differs from the CPU core")
        say(phase="library_resample", shape=f"({B},{NPOINT},{ns})", equal_to_cpu_core=True,
            unique_cnt_min=float(cnt.min()), unique_cnt_mean=float(cnt.mean()))
    msg_u = pointnet2.PointnetSAModuleMSGVotes(generator=gen(), sample_uniformly=True,
                                               **MSG_SA1).to(dev).train()
    set_bn_momentum(msg_u, 0.1)
    feats_u = height.to(dev, copy=True).requires_grad_(True)

    def uniform_step():
        msg_u.zero_grad(set_to_none=True)
        new_xyz, f, inds = msg_u(xyz.to(dev), feats_u, None, g)
        f.sum().backward()
        return new_xyz, f, inds

    new_xyz, f, inds = uniform_step()
    if not (f.shape == (B, NPOINT, 256) and inds.shape == (B, NPOINT) and new_xyz.shape ==
            (B, NPOINT, 3) and torch.isfinite(f).all() and torch.isfinite(feats_u.grad).all()):
        raise AssertionError(f"sample_uniformly: shapes {f.shape} {inds.shape}")
    out["msg_votes_uniform"] = {"fwd_bwd_ms": cuda_ms(uniform_step, 1, LIB_REPS)}
    say(phase="library", module="PointnetSAModuleMSGVotes sample_uniformly", scenes=B,
        **out["msg_votes_uniform"])

    for pooling in ("avg", "rbf"):
        out[f"sa_{pooling}"] = library_check(
            f"PointnetSAModuleVotes SA1 pooling={pooling}",
            lambda: pointnet2.PointnetSAModuleVotes(mlp=(1, 64, 64, 128), npoint=NPOINT,
                                                    radius=0.2, nsample=64, generator=gen(),
                                                    pooling=pooling),
            clouds, dev, 1, {"fps": 1, "ball_query": 1, "gather": 1, "gather_bwd": 1},
            by_features)
    out["query_and_group"] = library_check(
        "QueryAndGroup r0.2 ns64 normalize_xyz ret_grouped_xyz",
        lambda: pointnet2.QueryAndGroup(0.2, 64, normalize_xyz=True, ret_grouped_xyz=True),
        lambda b: (height[:b], xyz[:b], centers[:b]), dev, 1,
        {"ball_query": 1, "gather": 1, "gather_bwd": 1},
        lambda m, feats, pts, ctr: m(pts, ctr, feats))
    out["lfp"] = library_check(
        "PointnetLFPModuleMSG SA2 (1024, 256) -> SA1 (2048, 128) r0.4 ns16",
        lambda: pointnet2.PointnetLFPModuleMSG(radii=(0.4,), nsamples=(16,), mlps=((256, 256),),
                                               post_mlp=(384, 256), generator=gen()),
        lambda b: (f128[:b], f256[:b], centers[:b], centers[:b, :1024].contiguous()), dev, 2,
        {"ball_query": 1, "gather": 1, "gather_bwd": 1},
        lambda m, f2, f1, xyz2, xyz1: (m(xyz2, xyz1, f2, f1),))
    out["group_all"] = library_check(
        "PointnetSAModule npoint=None (GroupAll) over SA4 (256, 256)",
        lambda: pointnet2.PointnetSAModule(mlp=(256, 256, 512), generator=gen()),
        lambda b: (f256[:b, :256], centers[:b, :256].contiguous()), dev, 1, {}, by_features)

    # RandomDropout: the card's draws, then the CPU core on them
    x = torch.from_numpy(rng.randn(B, NPOINT, 128).astype(np.float32)).to(dev)
    drop = RandomDropout(0.5).train()
    got = drop(x, generator=g.manual_seed(7))
    theta = torch.rand((), generator=g.manual_seed(7), device=dev) * 0.5
    u = torch.rand(128, generator=g, device=dev)
    keep = u >= theta
    whole = bool(((got == 0) | (got == x)).all() and (got[..., ~keep] == 0).all()
                 and torch.equal(got[..., keep], x[..., keep]))
    cpu_equal = torch.equal(drop(x.cpu(), draws=(theta.cpu(), u.cpu())), got.cpu())
    out["dropout"] = {"kept_channels": int(keep.sum()), "theta": float(theta),
                      "fwd_ms": cuda_ms(lambda: drop(x, generator=g), 1, LIB_REPS)}
    say(phase="library", module="RandomDropout p=0.5", shape=f"({B},{NPOINT},128)",
        whole_channels_unscaled=whole, equal_to_cpu_core=cpu_equal, **out["dropout"])
    if not (whole and cpu_equal and 0 < int(keep.sum()) < 128):
        raise AssertionError(f"RandomDropout on the card: {out['dropout']}")
    say(phase="library_done", seconds=time.perf_counter() - t0)
    return out


# ------------------------------------------------------- phase 12: data parallelism
PAR_INIT_S = 120  # a rank's wait for the others at the rendezvous and in a collective
PAR_RANK_S = 300  # a rank subprocess's time limit
PAR_STEPS = 3
PAR_TURNS = 5  # (a)'s timed turns of a group step and a plain one
# Phase 12 (b)'s gates. In float32 a metric over a discrete selection moves
# by more than the loss: an objectness label, an argmax class or a rotated
# IoU label of an argmax-decoded box flips where a box sits within ~1e-6 of
# its threshold (on an H100, IoU-label metrics off by up to 2.6e-3 while
# the loss agreed within 3e-6). Likewise GridConv's grid points
# take their 3 nearest seeds, so a GridConv BN statistic can move by ~1e-4.
PAR_GATES = "loss rtol 1e-4, every metric rtol 1e-2 (atol 1e-6), gradient cosine > 0.9999, BN " \
            "running statistics of student and teacher within relative L2 1e-4, ranks' " \
            "parameters equal after 3 steps"


def free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def run_ranks(which: str, world: int, out: Path) -> list:
    """``world`` ranks of ``python3 chip_smoke.py --parallel-rank which``, each
    a subprocess with torchrun's environment, so that no process group
    outlives them in this process. Each must exit 0 within PAR_RANK_S and
    print its ``done`` line; every rank still running at the limit is
    killed. Returns each rank's results."""
    env = dict(os.environ, MASTER_ADDR="127.0.0.1", MASTER_PORT=str(free_port()),
               WORLD_SIZE=str(world), LOCAL_WORLD_SIZE=str(world))
    cmd = [sys.executable, str(Path(__file__).resolve()), "--parallel-rank", which,
           "--parallel-dir", str(out)]
    logs = [out / f"{which}_rank{r}.log" for r in range(world)]
    procs = []
    for r in range(world):
        with open(logs[r], "w") as log:
            procs.append(subprocess.Popen(cmd, cwd=Path(__file__).resolve().parent,
                                          env=dict(env, RANK=str(r), LOCAL_RANK=str(r)),
                                          stdout=log, stderr=subprocess.STDOUT))
    deadline = time.monotonic() + PAR_RANK_S
    try:
        for p in procs:
            p.wait(timeout=max(deadline - time.monotonic(), 0.1))
    except subprocess.TimeoutExpired:
        pass
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    texts = [log.read_text() for log in logs]
    for r, (p, text) in enumerate(zip(procs, texts)):
        if p.returncode != 0 or f"rank {r} of {world} done" not in text:
            raise AssertionError(f"phase 12 ({which}): rank {r} exited {p.returncode}:\n"
                                 + "\n".join(f"--- rank {i} ---\n{t[-3000:]}"
                                             for i, t in enumerate(texts)))
    return [torch.load(out / f"{which}_rank{r}.pt", weights_only=False) for r in range(world)]


def parallel_rank(which: str, out: Path) -> int:
    """A rank of phase 12, started by ``run_ranks``: joins the group from
    torchrun's environment, runs its part and writes its results."""
    lines = []
    group = distributed.initialize_distributed(device_type="cuda", timeout_s=PAR_INIT_S,
                                               logger=lines.append)
    try:
        result = {"a": rank_nccl, "b": rank_gloo}[which](group)
        result["group_line"] = lines[0]
        torch.save(result, out / f"{which}_rank{group.rank}.pt")
    finally:
        distributed.shutdown()
    print(f"rank {group.rank} of {group.world} done", flush=True)
    return 0


def ssl_batch_on(dev, group=None) -> dict:
    """Phase 7's timed batch (4 + 8 rooms), whole or this rank's rows."""
    batch = {k: torch.from_numpy(np.asarray(v)) for k, v in
             make_ssl_batch(53, SSL_NL, SSL_NU, get_config("scannet")).items()}
    if group is not None:
        batch = shard_batch(batch, group, SSL_NL)
    return {k: v.to(dev) for k, v in batch.items()}


def train_batch_on(dev, group=None) -> dict:
    """A pretrain batch of B rooms, whole or this rank's rows."""
    batch = {k: torch.from_numpy(np.asarray(v)) for k, v in
             make_train_batch(60, B, get_config("scannet")).items()}
    if group is not None:
        batch = shard_batch(batch, group)
    return {k: v.to(dev) for k, v in batch.items()}


def bn_stats(model) -> torch.Tensor:
    return torch.cat([b.detach().double().cpu().ravel() for n, b in model.named_buffers()
                      if "running" in n])


def step_record(state, metrics) -> dict:
    """What phase 12 compares of a step: its metrics, the gradient and both
    models' BN running statistics."""
    return {"metrics": {k: float(v) for k, v in metrics.items()}, "grads": _grads(state.model),
            "bn": bn_stats(state.model),
            "ema_bn": bn_stats(state.ema_model) if state.ema_model is not None else None}


def all_reduce_cost(group, n: int) -> dict:
    """One all-reduce's time on the host clock: ``n`` back to back of a
    257-float tensor on the rank's device (a BN's stack at C = 128), after
    20 to warm up; the host's queuing, and the wall time once the card is
    done."""
    x = torch.zeros(257, device=group.device)
    for _ in range(20):
        collectives.all_reduce_(x, group)
    torch.cuda.synchronize()
    t = time.perf_counter()
    for _ in range(n):
        collectives.all_reduce_(x, group)
    host = time.perf_counter() - t
    torch.cuda.synchronize()
    return {"calls": n, "host_us": host / n * 1e6, "wall_us": (time.perf_counter() - t) / n * 1e6}


def timed_steps(step, state, batch, n: int, lr: float) -> dict:
    """``n`` steps, each between CUDA events, with the kernels' launches and
    the collectives counted over them."""
    momentum = get_bn_momentum(0)
    torch.cuda.synchronize()
    for fn in KERNELS.values():
        fn.launches = 0
    before = dict(collectives.COUNTS)
    events = []
    for _ in range(n):
        ev = (torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True))
        ev[0].record()
        step(state, batch, lr, momentum)
        ev[1].record()
        events.append(ev)
    torch.cuda.synchronize()
    return {"step_ms": [a.elapsed_time(b) for a, b in events],
            "launches_per_step": {k: fn.launches / n for k, fn in KERNELS.items()},
            "collectives_per_step": {k: (v - before[k]) / n
                                     for k, v in collectives.COUNTS.items()}}


def rank_nccl(group) -> dict:
    """Phase 12 (a), rank 0 of a 1-rank NCCL group: the SSL step of phase 7
    (4 + 8 rooms, run_train.sh's settings) through ``shard_train_step`` and
    plain, from the same weights, batch and generator; each step's FPS and
    ball-query indices kept; then PAR_TURNS turns of a timed step of each,
    train-mode BN at the student's BN inputs in the native, written-out and
    group forms, and one step of each profiled."""
    dev, cfg, momentum = group.device, get_config("scannet"), get_bn_momentum(0)
    batch = ssl_batch_on(dev)
    out, steps = {"all_reduce": all_reduce_cost(group, 500)}, {}
    for form in ("plain", "group"):
        model, _ = build_votenet("scannet", device=dev)
        state = create_train_state(model, with_ema=True)
        step = make_ssl_step(cfg, SSL_NL, reference_exact=True, view_stats=True)
        if form == "group":
            step = shard_train_step(step, group)
        fps, calls = {}, []
        hooks = [m.backbone_net.register_forward_hook(
            lambda mod, a, ep, who=who: fps.__setitem__(who, ep["sa1_inds"].cpu()))
            for who, m in (("teacher", state.ema_model), ("student", model))]

        def recording(*args):
            idx = ball_query(*args)
            calls.append([a.cpu() if torch.is_tensor(a) else a for a in args] + [idx.cpu()])
            return idx

        pointnet2.ball_query = recording
        try:
            rec = step_record(state, step(state, batch, SSL_LR, momentum))
        finally:
            pointnet2.ball_query = ball_query
            for h in hooks:
                h.remove()
        rec["fps"] = torch.cat([fps["teacher"], fps["student"]])
        rec["ball_query"] = calls
        out[form] = rec
        steps[form] = (step, state)
    for form in ("group", "plain"):  # one warm-up each
        step, state = steps[form]
        step(state, batch, SSL_LR, momentum)
    # then group and plain steps in turns, one at a time: the host's pace drifts
    runs = [{form: timed_steps(*steps[form], batch, 1, SSL_LR) for form in ("group", "plain")}
            for _ in range(PAR_TURNS)]
    for form in ("group", "plain"):
        out[f"{form}_timed"] = {"step_ms": [r[form]["step_ms"][0] for r in runs],
                                **{k: runs[0][form][k] for k in ("launches_per_step",
                                                                 "collectives_per_step")}}
        if any(r[form]["launches_per_step"] != runs[0][form]["launches_per_step"] for r in runs):
            raise AssertionError(f"phase 12 (a): {form} steps launched unequal kernels")
    shapes = []
    hooks = [m.register_forward_pre_hook(lambda mod, a: shapes.append(
        (int(np.prod(a[0].shape[:-1])), int(a[0].shape[-1]))))
        for m in steps["group"][1].model.modules() if isinstance(m, BatchNorm)]
    try:
        steps["group"][0](steps["group"][1], batch, SSL_LR, momentum)
    finally:
        for h in hooks:
            h.remove()
    with collectives.active(group):
        out["bn_forms"] = bn_forms(shapes, dev, group=True)
    out["profile"] = {form: step_profile(*steps[form], batch, SSL_LR) for form in ("plain", "group")}
    return out


def step_profile(step, state, batch, lr: float) -> dict:
    """One step under torch.profiler: its wall ms, the device's busy ms, the
    NCCL kernels' ms and count, and the top kernels by device time."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t = time.perf_counter()
        step(state, batch, lr, get_bn_momentum(0))
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t) * 1e3
    events = prof.key_averages()
    kern = sorted((e for e in events if e.device_type == DeviceType.CUDA),
                  key=lambda e: e.self_device_time_total, reverse=True)
    nccl = [e for e in kern if "nccl" in e.key.lower()]
    host = sorted((e for e in events if e.device_type == DeviceType.CPU),
                  key=lambda e: e.self_cpu_time_total, reverse=True)
    return {"wall_ms": wall_ms, "device_busy_ms": sum(e.self_device_time_total for e in kern) / 1e3,
            "nccl_ms": sum(e.self_device_time_total for e in nccl) / 1e3,
            "nccl_calls": sum(e.count for e in nccl),
            "top_kernels": [[e.key[:70], e.self_device_time_total / 1e3, e.count] for e in kern[:10]],
            "top_host": [[e.key[:70], e.self_cpu_time_total / 1e3, e.count] for e in host[:12]]}


def rank_gloo(group) -> dict:
    """Phase 12 (b), a rank of 2 sharing the card over gloo: the SSL step on
    its 2 + 4 rows of phase 7's batch and the pretrain step on its 4 of 8
    rooms, each through ``shard_train_step`` for PAR_STEPS steps: the first
    step's metrics, gradient and BN statistics, the steps' ms, launches and
    collectives, and the parameters after the last."""
    dev, cfg = group.device, get_config("scannet")
    out = {"all_reduce": all_reduce_cost(group, 100)}
    for name in ("ssl", "pretrain"):
        ssl = name == "ssl"
        model, _ = build_votenet("scannet", device=dev)
        state = create_train_state(model, with_ema=ssl)
        batch = ssl_batch_on(dev, group) if ssl else train_batch_on(dev, group)
        lr = SSL_LR if ssl else LR
        step = shard_train_step(make_ssl_step(cfg, SSL_NL // group.world, reference_exact=True,
                                              view_stats=True) if ssl else make_pretrain_step(cfg),
                                group)
        rec = step_record(state, step(state, batch, lr, get_bn_momentum(0)))
        rec["timed"] = timed_steps(step, state, batch, PAR_STEPS - 1, lr)
        rec["params"] = torch.cat([p.detach().cpu().ravel() for p in model.parameters()])
        if ssl:
            rec["ema_params"] = torch.cat([p.detach().cpu().ravel()
                                           for p in state.ema_model.parameters()])
        out[name] = rec
    return out


def one_process_reference(dev) -> dict:
    """Phase 12 (b)'s reference: one plain SSL step on the whole 4 + 8 and
    one pretrain step on the whole 8 rooms, from the ranks' weights."""
    cfg, out = get_config("scannet"), {}
    for name in ("ssl", "pretrain"):
        ssl = name == "ssl"
        model, _ = build_votenet("scannet", device=dev)
        state = create_train_state(model, with_ema=ssl)
        step = make_ssl_step(cfg, SSL_NL, reference_exact=True, view_stats=True) if ssl \
            else make_pretrain_step(cfg)
        batch = ssl_batch_on(dev) if ssl else train_batch_on(dev)
        out[name] = step_record(state, step(state, batch, SSL_LR if ssl else LR,
                                            get_bn_momentum(0)))
    return out


def cosine(a: torch.Tensor, b: torch.Tensor) -> float:
    return float(a @ b / (a.norm() * b.norm()))


def hold(got: dict, want: dict, what: str, failed: list) -> dict:
    """A sharded step's first-step record against one process's (PAR_GATES);
    a miss is appended to ``failed``."""
    rel = {k: abs(got["metrics"][k] - v) / max(abs(v), 1e-12) for k, v in want["metrics"].items()}
    bad = [k for k, v in want["metrics"].items()
           if not abs(got["metrics"][k] - v) <= 1e-6 + (1e-4 if k == "loss" else 1e-2) * abs(v)]
    cos = cosine(got["grads"], want["grads"])
    bn_rel = {key: float((got[key] - want[key]).norm() / want[key].norm())
              for key in ("bn", "ema_bn") if want[key] is not None}
    worst = sorted(rel, key=rel.get)[-5:]
    row = {"loss": got["metrics"]["loss"], "loss_one_process": want["metrics"]["loss"],
           "metrics_outside": {k: (got["metrics"][k], want["metrics"][k]) for k in bad},
           "metrics_worst_rel": {k: (rel[k], got["metrics"][k], want["metrics"][k]) for k in worst},
           "metrics_over_rtol_1e-4": sum(r > 1e-4 for r in rel.values()),
           "grad_cosine": cos, "bn_rel_l2": bn_rel}
    if set(got["metrics"]) != set(want["metrics"]) or bad or not cos > 0.9999 \
            or any(v >= 1e-4 for v in bn_rel.values()):
        failed.append(f"{what}: {row}")
    return row


def checkpoint_change(got: dict, want: dict, start: dict) -> dict:
    """Cosine and relative L2 of two checkpoints' change from ``start``, over
    the BN running statistics and over the parameters of each model."""
    out = {}
    for key in ("model_state_dict", "ema_model_state_dict"):
        for part in ("running", "param"):
            names = sorted(k for k in want[key] if ("running" in k) == (part == "running"))
            g = torch.cat([(got[key][k] - start[k]).double().ravel() for k in names])
            w = torch.cat([(want[key][k] - start[k]).double().ravel() for k in names])
            out[f"{key}:{part}"] = (cosine(g, w), float((g - w).norm() / w.norm()))
    return out


def phase_parallel(cfg, dev, root: Path) -> dict:
    """Phase 12, data parallelism over ranks, after phase 9 and on its dumps:
    (a) a 1-rank NCCL group's SSL step against phase 7's plain step, (b) 2
    ranks sharing the card over gloo against one process on the whole batch,
    (c) the SSL driver under ``torch.distributed.run`` with 2 ranks against
    phase 9 (b)."""
    out = root / "parallel"
    out.mkdir()
    failed = []
    t = time.perf_counter()
    (a,) = run_ranks("a", 1, out)
    a_s = time.perf_counter() - t
    plain, grouped = a["plain"], a["group"]
    cos = cosine(grouped["grads"], plain["grads"])
    loss, loss0 = grouped["metrics"]["loss"], plain["metrics"]["loss"]
    bq = [(len(g[-1]), bool(torch.equal(g[-1], p[-1])),
           all(torch.equal(x, y) for x, y in zip(g[2:4], p[2:4])))
          for g, p in zip(grouped["ball_query"], plain["ball_query"])]
    say(phase="parallel_nccl", group=a["group_line"], scenes=f"{SSL_NL} + {SSL_NU}", points=N,
        seconds=a_s, loss=loss, loss_plain=loss0, grad_cosine=cos,
        fps_equal=bool(torch.equal(grouped["fps"], plain["fps"])),
        ball_query_equal=[e for _, e, _ in bq], ball_query_inputs_equal=[i for _, _, i in bq],
        all_reduce=a["all_reduce"],
        step_ms=a["group_timed"]["step_ms"], plain_step_ms=a["plain_timed"]["step_ms"],
        collectives_per_step=a["group_timed"]["collectives_per_step"],
        launches_per_step=a["group_timed"]["launches_per_step"], bn_forms=a["bn_forms"],
        profile=a["profile"],
        tol="loss rtol 2e-3, gradient cosine > 0.999, FPS equal, ball query equal wherever "
            "its inputs are (SA1-SA4 always)")
    if not (abs(loss - loss0) <= 2e-3 * abs(loss0) and cos > 0.999):
        failed.append(f"(a): loss {loss} against {loss0}, gradient cosine {cos}")
    if not torch.equal(grouped["fps"], plain["fps"]) or len(bq) != 10 \
            or not all(e for _, e, i in bq if i) or not all(i for _, _, i in bq[:4] + bq[5:9]):
        failed.append(f"(a): FPS or ball-query indices differ: {bq}")
    if a["group_timed"]["launches_per_step"] != SSL_LAUNCHES:
        failed.append(f"(a): launches {a['group_timed']['launches_per_step']}")

    want = one_process_reference(dev)
    t = time.perf_counter()
    ranks = run_ranks("b", 2, out)
    b_s = time.perf_counter() - t
    rows = {}
    for name, launches in (("ssl", SSL_LAUNCHES), ("pretrain", TRAIN_LAUNCHES)):
        rows[name] = [hold(r[name], want[name], f"(b) {name} rank {i}", failed)
                      for i, r in enumerate(ranks)]
        same = all(torch.equal(ranks[0][name][k], ranks[1][name][k])
                   for k in ("params", "ema_params") if k in ranks[0][name])
        say(phase=f"parallel_gloo_{name}", group=[r["group_line"] for r in ranks],
            scenes=f"{SSL_NL // 2} + {SSL_NU // 2} a rank" if name == "ssl" else f"{B // 2} a rank",
            seconds=b_s, checks=rows[name], ranks_equal_after_steps=same,
            all_reduce=[r["all_reduce"] for r in ranks],
            step_ms=[r[name]["timed"]["step_ms"] for r in ranks],
            collectives_per_step=[r[name]["timed"]["collectives_per_step"] for r in ranks],
            launches_per_step=[r[name]["timed"]["launches_per_step"] for r in ranks],
            tol=PAR_GATES)
        if not same:
            failed.append(f"(b) {name}: the ranks' parameters differ")
        for r in ranks:
            if r[name]["timed"]["launches_per_step"] != launches:
                failed.append(f"(b) {name}: launches {r[name]['timed']['launches_per_step']}")

    # (c) the SSL driver under torchrun, as phase 9 (b) from (a)'s checkpoint
    dp = root / "ssl_dp"
    cmd = [sys.executable, "-m", "torch.distributed.run", "--standalone", "--nproc_per_node",
           "2", "-m", "iou3dmatch_tpu_torch.cli.train", "--log_dir", str(dp), "--batch_size",
           f"{SSL_NL // 2},{SSL_NU // 2}", "--detector_checkpoint",
           str(root / "pretrain" / "checkpoint.tar"), "--view_stats", "--reference_exact_step",
           "--max_epoch", "2", "--eval_interval", "2", "--print_interval", "1", "--dataset",
           "scannet", "--data_path", str(root / "data"), "--labeled_sample_list", "labeled.txt"]
    env = {k: v for k, v in os.environ.items()
           if k not in ("RANK", "WORLD_SIZE", "LOCAL_RANK", "LOCAL_WORLD_SIZE", "MASTER_ADDR",
                        "MASTER_PORT")}
    t = time.perf_counter()
    proc = subprocess.run(cmd, cwd=Path(__file__).resolve().parent, env=env, capture_output=True,
                          text=True, timeout=PAR_RANK_S)
    c_s = time.perf_counter() - t
    if proc.returncode != 0:
        raise AssertionError(f"phase 12 (c): torchrun exited {proc.returncode}:\n"
                             f"{proc.stdout[-3000:]}\n{proc.stderr[-3000:]}\n" + "\n".join(failed))
    log = (dp / "log_train.txt").read_text()
    dp_line = f"data-parallel over 2 devices: per-device batch {SSL_NL // 2}+{SSL_NU // 2}, " \
              f"global {SSL_NL}+{SSL_NU}"
    group_line = [x for x in log.splitlines() if x.startswith("distributed: rank 0 of 2")]
    got = checkpoint.read(str(dp / "checkpoint.tar"))
    base = checkpoint.read(str(root / "ssl_b_checkpoint.tar"))
    start = checkpoint.read(str(root / "pretrain" / "checkpoint.tar"))["model_state_dict"]
    first, first_base = (first_step_metrics(x) for x in (log, (root / "ssl_b_log.txt").read_text()))
    off = {k: (v, first_base.get(k)) for k, v in first.items()
           if not (k in first_base and abs(v - first_base[k])
                   <= 1e-4 + (1e-4 if k == "loss" else 5e-2) * abs(first_base[k]))}
    over = sum(abs(v - first_base.get(k, np.inf)) > 1e-4 + 1e-4 * abs(first_base.get(k, 0))
               for k, v in first.items())
    finite = all(bool(torch.isfinite(v).all()) for key in ("model_state_dict", "ema_model_state_dict")
                 for v in got[key].values() if v.is_floating_point())
    epoch_s = [float(x.split(":")[1].rstrip("s")) for x in log.splitlines()
               if x.startswith("epoch time:")]
    say(phase="parallel_driver", cmd=" ".join(cmd[1:]), seconds=c_s,
        epoch_ms=[s * 1e3 for s in epoch_s], data_parallel_line=dp_line in log,
        group_line=group_line, step=got["step"], epoch=got["epoch"],
        first_step_metrics=len(first), first_step_outside=off, first_step_over_rounding=over,
        change_cosine_rel_l2=checkpoint_change(got, base, start),
        eval_lines=[x for x in log.splitlines() if x.startswith("eval mAP@")],
        tol="the first step's logged loss (4 decimals) within 1e-4 + 1e-4 x phase 9 (b)'s, every "
            "other logged metric within 1e-4 + 5e-2 x (b)'s (a teacher objectness label flips "
            "a view-stats mean over ~40 positives by ~3 %); step, epoch and generator state "
            "equal to (b)'s; the checkpoint finite. Its change "
            "from (a)'s checkpoint against (b)'s is reported, not held: in float32, Adam at eps "
            "1e-8 makes later steps chaotic (PERF.md, Findings)")
    if dp_line not in log or len(group_line) != 1 or "backend gloo" not in group_line[0]:
        failed.append("(c): the log lacks the data-parallel or the group line")
    if not first or set(first) != set(first_base) or off or not finite:
        failed.append(f"(c): first step's metrics {off} ({len(first)} logged), finite "
                      f"checkpoint {finite}")
    if (got["step"], got["epoch"]) != (base["step"], base["epoch"]) \
            or not torch.equal(got["generator_state"], base["generator_state"]):
        failed.append(f"(c): step {got['step']} epoch {got['epoch']} against {base['step']} "
                      f"{base['epoch']}, or the generators differ")
    say(phase="parallel", seconds={"a": a_s, "b": b_s, "c": c_s}, failed=failed)
    if failed:
        raise AssertionError("phase 12: " + "\n".join(failed))
    return {"a_s": a_s, "b_s": b_s, "c_s": c_s}


# ----------------------------------------------------------- phase 13: bf16
# the precisions phase 13 runs in turns: f32 first, then --bf16 and --bf16 --f32_gridconv
PRECISIONS = ({}, {"compute_dtype": "bfloat16"}, {"compute_dtype": "bfloat16", "f32_gridconv": True})
BF16_FLAGS = (["--bf16"], ["--bf16", "--f32_gridconv"])
# The bf16 train-mode step is chaotic: random weights leave channels of
# tiny spread, whose train-mode normalisation turns one-ulp bf16 flips into
# O(1) changes (a 1e-5 move of the clouds, which also moves FPS's picks,
# changes the forward's every layer; tests/test_torch_bf16_steps.py). The
# forward is held within twice the change such a move makes on the card.
ENVELOPE_EPS = 1e-5
BF16_FORWARD_REL = 1e-2  # eval forward, card vs CPU: a head's max |diff| over its max |value|
# the bf16 steps, card vs CPU (phase 13 (c)), set from an H100 run's data
# (PERF.md): SA1 1 ulp apart; the losses 2.9 % (pretrain) and 7.1 %
# (SSL) apart at gradient cosine 0.62 and 0.65, as far as the card stands
# from itself with the CPU's BatchNorm form (3.0 % and 5.1 %, 0.61 and 0.48)
BF16_SA1_ULPS = 4
BF16_LOSS_RTOL = 0.15
BF16_MIN_COSINE = 0.3
BF16_TURNS = 2
REQUEST_LAUNCHES = {"fps": 1, "ball_query": 5, "gather": 6, "gather_bwd": 0, "iou3d": 0, "lhs": 0,
                    "three_nn": 3, "nms": 1, "three_interpolate": 2,
                    "three_interpolate_bwd": 0}  # a serving request's, phase 5b's
GEMM_KERNEL = re.compile(r"gemm|xmma|cutlass|nvjet|cublas", re.I)
BN_KERNEL = re.compile(r"batch_norm|batchnorm|bn_fw|bn_bw|welford", re.I)


def precision_name(knobs: dict) -> str:
    if not knobs:
        return "f32"
    return "bf16+f32_gridconv" if knobs.get("f32_gridconv") else "bf16"


def bf16_forward(dev, knobs: dict) -> dict:
    """Phase 13 (a): the bf16 eval forward of one scene on the card against
    the CPU: every index before the heads equal (FPS, the ball queries and
    three_nn read f32 xyz); each head within the larger of
    BF16_FORWARD_REL of its largest magnitude and twice the card's own
    change for clouds moved by ENVELOPE_EPS (the IoU logits move by ~2e-2
    so on the CPU); the objectness logits' correlation > 0.999; and the
    card's f32 proposal heads further from the CPU's bf16 ones than the
    card's bf16 heads are."""
    model_gpu, _ = build_votenet("scannet", device=dev, **knobs)
    model_cpu, _ = build_votenet("scannet", device="cpu", **knobs)
    model_f32, _ = build_votenet("scannet", device=dev)
    pc = torch.from_numpy(make_scenes(4, 1, N))
    moved = torch.from_numpy(moved_clouds({"point_clouds": pc.numpy()}, ENVELOPE_EPS)[
        "point_clouds"])
    with torch.inference_mode():
        ep_gpu, ep_f32 = model_gpu(pc.to(dev)), model_f32(pc.to(dev))
        ep_moved = model_gpu(moved.to(dev))
        torch.cuda.synchronize()
        ep_cpu = model_cpu(pc)
    for k in ("sa1_inds", "sa2_inds", "seed_inds", "aggregated_vote_inds"):
        if not torch.equal(ep_gpu[k].cpu(), ep_cpu[k]):
            raise AssertionError(f"{k} differ between the card and the CPU ({knobs})")
    rel, rel_f32, rel_env, failed = {}, {}, {}, []
    for k in ("center", "objectness_scores", "sem_cls_scores", "size_residuals", "iou_scores"):
        a, f, m, b = ep_gpu[k].cpu(), ep_f32[k].cpu(), ep_moved[k].cpu(), ep_cpu[k]
        if a.dtype != torch.float32 or not torch.isfinite(a).all():
            raise AssertionError(f"{k}: {a.dtype} or non-finite on the card ({knobs})")
        scale = float(b.abs().max())
        rel[k], rel_f32[k], rel_env[k] = (max_err(x, b) / scale for x in (a, f, m))
        if rel[k] > max(BF16_FORWARD_REL, 2 * rel_env[k]):
            failed.append(k)
    corr = float(np.corrcoef(ep_gpu["objectness_scores"].cpu().numpy().ravel(),
                             ep_cpu["objectness_scores"].numpy().ravel())[0, 1])
    heads = ("center", "objectness_scores", "sem_cls_scores")
    say(phase="bf16_forward_vs_cpu", precision=precision_name(knobs), scenes=1, points=N,
        indices_equal=True, rel_diff=rel, moved_rel_diff=rel_env, f32_rel_diff_to_cpu_bf16=rel_f32,
        objectness_correlation=corr,
        tol=f"indices equal, max |diff| / max |cpu| <= max({BF16_FORWARD_REL}, 2 x the card's for "
            f"clouds moved by {ENVELOPE_EPS}), objectness correlation > 0.999, f32's proposal "
            "heads further from the CPU's bf16 than the card's bf16")
    if failed or corr <= 0.999:
        raise AssertionError(f"bf16 forward ({knobs}): {failed} of {rel}, correlation {corr}")
    if not max(rel_f32[k] for k in heads) > max(rel[k] for k in heads):
        raise AssertionError(f"the card's bf16 forward is no nearer the CPU's than f32 ({knobs})")
    return rel


def bf16_serve(cfg, dev) -> dict:
    """Phase 13 (b): 3 requests of B scenes for each precision, in turns
    (f32, bf16, bf16 with f32 GridConv, twice), each request's picks held
    to the host NumPy parse of the same outputs; device ms (CUDA events
    around the forward), scenes/s (forward and parse) and peak memory of
    the second turn; launches a request counted over the first bf16 turn."""
    config = eval_config_dict(cfg, use_iou_for_nms=True)
    forwards = {precision_name(k): make_eval_forward(build_votenet("scannet", device=dev, **k)[0])
                for k in PRECISIONS}
    batches = [torch.from_numpy(make_scenes(10 + i, B, N)).to(dev) for i in range(3)]
    for fwd in forwards.values():
        parse_predictions(fwd(batches[0]), config)  # warm-up
    out = {}
    for turn in range(BF16_TURNS):
        for name, fwd in forwards.items():
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats(dev)
            for fn in KERNELS.values():
                fn.launches = 0
            device_ms, wall = [], 0.0
            for i, pc in enumerate(batches):
                start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
                t0 = time.perf_counter()
                start.record()
                with plain_watch(f"{name} request {i}"):
                    res = fwd(pc)
                end.record()
                end.synchronize()
                picks = proposal_lists(pack_predictions(res, config), cfg.num_class, config)
                wall += time.perf_counter() - t0
                device_ms.append(start.elapsed_time(end))
                same_picks(picks, parse_predictions_np({k: v.cpu().numpy() for k, v in res.items()},
                                                       config), f"{name} request {i}")
                if not all(torch.isfinite(v).all() for v in res.values()):
                    raise AssertionError(f"{name} request {i}: non-finite outputs")
            launches = {k: fn.launches for k, fn in KERNELS.items()}
            row = {"device_ms": device_ms, "scenes_per_s": 3 * B / wall,
                   "max_memory_allocated": torch.cuda.max_memory_allocated(dev),
                   "launches_per_request": {k: v / 3 for k, v in launches.items()}}
            say(phase="bf16_serve", turn=turn, precision=name, requests=3, **row)
            if row["launches_per_request"] != REQUEST_LAUNCHES:
                raise AssertionError(f"{name} serving launched {launches}, expected 3 x "
                                     f"{REQUEST_LAUNCHES}")
            out.setdefault(name, []).append(row)
            if name == "bf16" and turn == 0:
                out["launches_bf16_3_requests"] = launches
    return out


def step_gate(what: str, gpu: dict, cast: dict, cpu: dict, extra: dict) -> dict:
    """The card's bf16 step against the CPU's: FPS indices equal; SA1's
    features (before any train-mode BatchNorm has amplified a flip) within
    BF16_SA1_ULPS bf16 ulps of their largest magnitude; the loss finite and
    within BF16_LOSS_RTOL, the gradient's cosine above BF16_MIN_COSINE.
    Beside them, for the record, the same step on the card with BatchNorm
    in the CPU's cast form (``cast``): two bf16 programs that differ only in
    f32 rounding, the distance rounding alone makes."""
    def cos(a, b):
        return float(a @ b / (a.norm() * b.norm()))

    scale = float(cpu["sa1"].abs().max())
    ulp = 2.0 ** (np.floor(np.log2(scale)) - 7)
    row = {"loss_gpu": gpu["loss"], "loss_cpu": cpu["loss"], "loss_gpu_cast_bn": cast["loss"],
           "loss_rel": abs(gpu["loss"] - cpu["loss"]) / abs(cpu["loss"]),
           "loss_rel_cast_bn": abs(gpu["loss"] - cast["loss"]) / abs(cpu["loss"]),
           "grad_cosine": cos(gpu["grads"], cpu["grads"]),
           "grad_cosine_cast_bn": cos(gpu["grads"], cast["grads"]),
           "sa1_ulps": float((gpu["sa1"] - cpu["sa1"]).abs().max()) / ulp,
           "gpu_s": gpu["seconds"], "cpu_s": cpu["seconds"], **extra}
    say(phase=what, **row, tol=f"FPS indices equal, SA1's features within {BF16_SA1_ULPS} bf16 "
                               f"ulps of scale, loss rtol {BF16_LOSS_RTOL}, gradient cosine > "
                               f"{BF16_MIN_COSINE}")
    if not torch.equal(gpu["inds"], cpu["inds"]):
        raise AssertionError(f"{what}: the FPS indices differ between the card and the CPU")
    if not (np.isfinite(gpu["loss"]) and row["loss_rel"] <= BF16_LOSS_RTOL
            and row["sa1_ulps"] <= BF16_SA1_ULPS and row["grad_cosine"] > BF16_MIN_COSINE):
        raise AssertionError(f"{what}: {row}")
    return row


def moved_clouds(batch: dict, eps: float) -> dict:
    out = dict(batch)
    if eps:
        rng = np.random.RandomState(61)
        for k in ("point_clouds", "ema_point_clouds"):
            if k in out:
                pc = np.array(out[k])
                pc[..., 0:3] += eps * rng.randn(*pc[..., 0:3].shape).astype(np.float32)
                out[k] = pc
    return out


@contextlib.contextmanager
def cast_bn_form():
    """Train-mode BatchNorm in the CPU's form (cast to f32, ``two_pass``,
    cast back) on every device, for the card's rounding-only comparison."""
    real = BatchNorm.forward

    def cast(self, x):
        if not self.training:
            return real(self, x)
        flat = x.reshape(-1, x.shape[-1])
        return self.two_pass(flat.float()).to(x.dtype).reshape(x.shape)

    BatchNorm.forward = cast
    try:
        yield
    finally:
        BatchNorm.forward = real


def step_runs(knobs: dict, dev, run_one) -> list:
    """``run_one(model, state, where) -> (loss, metrics)`` on the card, on the
    card with ``cast_bn_form``, and on the CPU, from the same weights; each
    run's loss, gradient, FPS indices, SA1 features and seconds."""
    runs = []
    for where, cast in ((dev, False), (dev, True), (torch.device("cpu"), False)):
        model, _ = build_votenet("scannet", device=where, **knobs)
        state = create_train_state(model, with_ema=True)
        seen = {}
        hooks = [model.backbone_net.sa1.register_forward_hook(
            lambda m, a, out: seen.__setitem__("sa1", out[1].detach().float().cpu()))]
        hooks += [m.backbone_net.register_forward_hook(
            lambda mod, a, ep, who=who: seen.__setitem__(who, ep["sa1_inds"].cpu()))
            for who, m in (("teacher", state.ema_model), ("student", model))]
        try:
            with cast_bn_form() if cast else contextlib.nullcontext():
                t = time.perf_counter()
                loss, metrics = run_one(model, state, where)
                seconds = time.perf_counter() - t
        finally:
            for h in hooks:
                h.remove()
        runs.append({"loss": loss, "metrics": metrics, "grads": _grads(model),
                     "sa1": seen["sa1"], "seconds": seconds,
                     "inds": torch.cat([seen[w] for w in ("teacher", "student") if w in seen])})
    return runs


def bf16_train_check(cfg, dev, knobs: dict) -> dict:
    """Phase 13 (c): phase 6's card-vs-CPU pretrain step (2 scenes, GT at
    the random model's vote centres), in bf16, held by ``step_gate``."""
    momentum = get_bn_momentum(0)
    batch = make_train_batch(20, 2, cfg, vote_anchors(make_scenes(20, 2, N), dev))
    noise = torch.randn((2, 2, K, 3), generator=torch.Generator().manual_seed(21))

    def run_one(model, state, where):
        metrics = make_pretrain_step(cfg)(
            state, {k: torch.from_numpy(np.asarray(v)).to(where) for k, v in batch.items()},
            LR, momentum, noise=(noise[0].to(where), noise[1].to(where)))
        return float(metrics["loss"]), {"pos_ratio": float(metrics["pos_ratio"])}

    runs = step_runs(knobs, dev, run_one)
    return step_gate("bf16_train_vs_cpu", *runs, {"precision": precision_name(knobs),
                                                  "pos_ratio": runs[0]["metrics"]["pos_ratio"]})


def bf16_ssl_check(cfg, dev, knobs: dict) -> dict:
    """Phase 13 (c): phase 7's card-vs-CPU SSL step (1 + 1 scenes,
    reference_exact with view-stats, LHS IoU SSL_CHECK_NMS_IOU), in bf16,
    held by ``step_gate``; pseudo labels on the card, and its LHS equal to
    the plain version on the card's own inputs (the teacher's bf16 outputs
    may pick other boxes on the CPU)."""
    momentum = get_bn_momentum(0)
    student_pc, _ = augment_view(make_scenes(50, 2, N), 51)
    batch = make_ssl_batch(50, 1, 1, cfg, vote_anchors(student_pc, dev))
    noise = torch.randn((4, 2, K, 3), generator=torch.Generator().manual_seed(52))
    thr = teacher_thresholds(batch["ema_point_clouds"], (noise[0], noise[1]), dev, 1)

    def run_one(model, state, where):
        lhs_calls = []

        def recording(*args):
            lhs_calls.append((args, lhs_3d_samecls(*args)))
            return lhs_calls[-1][1]

        unlabeled.lhs_3d_samecls = recording
        try:
            metrics = make_ssl_step(cfg, 1, reference_exact=True, view_stats=True,
                                    nms_iou=SSL_CHECK_NMS_IOU, **thr)(
                state, {k: torch.from_numpy(np.asarray(v)).to(where) for k, v in batch.items()},
                SSL_LR, momentum, noise=((noise[0].to(where), noise[1].to(where)),
                                         (noise[2].to(where), noise[3].to(where))))
        finally:
            unlabeled.lhs_3d_samecls = lhs_3d_samecls
        (lhs_args, keep), = lhs_calls
        return float(metrics["loss"]), {
            "pseudo_gt_ratio": float(metrics["pseudo_gt_ratio"]),
            "lhs_equal_plain": bool(torch.equal(keep.cpu(), lhs_3d_samecls_plain(*lhs_args).cpu()))}

    runs = step_runs(knobs, dev, run_one)
    gpu = runs[0]["metrics"]
    row = step_gate("bf16_ssl_vs_cpu", *runs, {
        "precision": precision_name(knobs), "thresholds": thr, **gpu,
        "pseudo_gt_ratio_cpu": runs[2]["metrics"]["pseudo_gt_ratio"]})
    if not (gpu["lhs_equal_plain"] and gpu["pseudo_gt_ratio"] > 0):
        raise AssertionError(f"bf16 SSL check: LHS against its plain version, or no pseudo labels: {row}")
    return row


def split_profile(what: str, knobs: dict, step, state, batch, lr: float) -> dict:
    """Phase 13 (d): one step under torch.profiler: the device ms of the
    GEMMs (cuBLAS / CUTLASS kernels: the SA, FP, GridConv and head
    products), of BatchNorm's kernels and of the rest, and the busy share
    of the step's wall time."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    momentum = get_bn_momentum(0)
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        t = time.perf_counter()
        step(state, batch, lr, momentum)
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t) * 1e3
    kern = [e for e in prof.key_averages() if e.device_type == DeviceType.CUDA]
    busy = sum(e.self_device_time_total for e in kern) / 1e3
    gemm = sum(e.self_device_time_total for e in kern if GEMM_KERNEL.search(e.key)) / 1e3
    bn = sum(e.self_device_time_total for e in kern if BN_KERNEL.search(e.key)) / 1e3
    kern.sort(key=lambda e: e.self_device_time_total, reverse=True)
    row = {"gemm_ms": gemm, "batch_norm_ms": bn, "other_ms": busy - gemm - bn,
           "device_busy_ms": busy, "profiled_wall_ms": wall_ms, "busy_share": busy / wall_ms,
           "gemm_share_of_device": gemm / busy}
    say(phase="bf16_profile", step=what, precision=precision_name(knobs), **row,
        top_kernels=[[e.key[:80], e.self_device_time_total / 1e3, e.count] for e in kern[:10]])
    return row


def bn_bf16_forms(model, step, state, batch, dev) -> dict:
    """BatchNorm at each bf16 input of one bf16 pretrain step: the card's
    native kernels on bf16 rows (f32 statistics and weights) against the
    CPU's form, cast to f32 -> ``two_pass`` (train) or the f32 eval formula
    -> cast, on the card: outputs within one bf16 ulp on all but 1e-3 of the
    elements, running statistics within rtol 1e-4; and both train forms'
    forward+backward ms a step."""
    shapes = []
    hooks = [m.register_forward_pre_hook(
        lambda m, a: shapes.append((a[0].numel() // a[0].shape[-1], a[0].shape[-1]))
        if a[0].dtype == torch.bfloat16 else None)
        for m in model.modules() if isinstance(m, BatchNorm)]
    try:
        step(state, batch, LR, get_bn_momentum(0))
    finally:
        for h in hooks:
            h.remove()
    gen = torch.Generator(device=dev).manual_seed(19)
    total, worst_share, worst_stats = {"native": 0.0, "two_pass_casts": 0.0}, 0.0, 0.0
    for rows, c in shapes:
        x = (torch.randn(rows, c, generator=gen, device=dev) * 2 + 0.5).to(torch.bfloat16)
        x.requires_grad_()
        g = torch.randn(rows, c, generator=gen, device=dev).to(torch.bfloat16)
        bns = [BatchNorm(c).to(dev) for _ in range(2)]
        for bn in bns:
            bn.momentum = get_bn_momentum(0)
            bn.train()
        native = lambda t, bn=bns[0]: F.batch_norm(t, bn.running_mean, bn.running_var,  # noqa: E731
                                                   bn.weight, bn.bias, True, bn.momentum, bn.eps)
        casts = lambda t, bn=bns[1]: bn.two_pass(t.float()).to(torch.bfloat16)  # noqa: E731
        with torch.no_grad():
            a, b = native(x).float(), casts(x).float()
        ulp = torch.exp2(torch.floor(torch.log2(b.abs().clamp(min=2.0 ** -126))) - 7)
        worst_share = max(worst_share, float(((a - b).abs() > ulp).float().mean()))
        with torch.no_grad():  # eval mode: BatchNorm's own forms, native and cast
            bns[0].eval()
            bns[1].eval()
            a = bns[0](x.detach()).float()
            b = (bns[1](x.detach().float())).to(torch.bfloat16).float()
            bns[0].train()
            bns[1].train()
        worst_share = max(worst_share, float(((a - b).abs() > ulp).float().mean()))
        for key in ("running_mean", "running_var"):
            ra, rb = getattr(bns[0], key), getattr(bns[1], key)
            worst_stats = max(worst_stats, float(((ra - rb).abs() / rb.abs().clamp(min=1e-6)).max()))
        for name, fn, bn in (("native", native, bns[0]), ("two_pass_casts", casts, bns[1])):
            total[name] += cuda_ms(lambda: torch.autograd.grad(fn(x), (x, bn.weight, bn.bias), g),
                                   1, 5)
    say(phase="bn_bf16_forms", layers_a_step=len(shapes), forward_backward_ms_a_step=total,
        share_over_1_bf16_ulp=worst_share, running_stats_max_rel=worst_stats,
        tol="<= 1e-3 of the outputs over 1 bf16 ulp, running statistics rtol 1e-4")
    if not shapes or worst_share > 1e-3 or worst_stats > 1e-4:
        raise AssertionError(f"bf16 BatchNorm's native form against the CPU's: {worst_share}, "
                             f"{worst_stats} ({len(shapes)} layers)")
    return total


def bf16_drivers(root: Path, dev) -> dict:
    """Phase 13 (e), on phase 9's dumps: for ``--bf16`` and ``--bf16
    --f32_gridconv``, one pretrain epoch (one step of the 8 labeled scans),
    one SSL epoch from its checkpoint (2 steps), and ``--eval
    --use_iou_for_nms --opt_step 10`` resuming the SSL checkpoint. Each logs
    its compute dtype; the checkpoints hold float32 only; launches a step as
    phases 6 and 7's."""
    data = ["--dataset", "scannet", "--data_path", str(root / "data"),
            "--labeled_sample_list", "labeled.txt"]
    out = {}
    for flags in BF16_FLAGS:
        name = "bf16" + ("_f32_gridconv" if "--f32_gridconv" in flags else "")
        line = ("compute dtype: bfloat16 (GridConv " + ("float32" if "--f32_gridconv" in flags
                                                          else "bfloat16") + ")")
        pre, ssl = root / f"{name}_pretrain", root / f"{name}_ssl"
        runs = {"pretrain": driver_run(
            f"{name}_pretrain", cli_pretrain.main,
            ["--log_dir", str(pre), "--batch_size", str(B), "--max_epoch", "1",
             "--eval_interval", "0", "--print_interval", "1"] + data + flags, pre,
            DUMP_LABELED // B, B, {k: v * (DUMP_LABELED // B) for k, v in TRAIN_LAUNCHES.items()})}
        runs["ssl"] = driver_run(
            f"{name}_ssl", cli_train.main,
            ["--log_dir", str(ssl), "--batch_size", f"{SSL_NL},{SSL_NU}", "--detector_checkpoint",
             str(pre / "checkpoint.tar"), "--view_stats", "--reference_exact_step", "--max_epoch",
             "1", "--eval_interval", "0", "--print_interval", "1"] + data + flags, ssl,
            DUMP_LABELED // SSL_NL, SSL_NL + SSL_NU,
            {k: v * (DUMP_LABELED // SSL_NL) for k, v in SSL_LAUNCHES.items()})
        t = time.perf_counter()
        means, ap, map_sum = cli_train.main(
            ["--log_dir", str(ssl), "--resume", "--eval", "--use_iou_for_nms", "--opt_step",
             str(OPT_STEP), "--opt_rate", str(OPT_RATE), "--batch_size", f"{SSL_NL},{SSL_NU}"]
            + data + flags)
        eval_s = time.perf_counter() - t
        log = (ssl / "log_train.txt").read_text()
        for run in ("pretrain", "ssl"):
            if line not in runs[run]["log"]:
                raise AssertionError(f"{name} {run}: no '{line}' in its log")
        if log.count(line) != 2 or "compute dtype: float32" in log:
            raise AssertionError(f"{name}: the SSL and eval runs' logs do not both say bf16")
        dtypes = {}
        for path in (pre / "checkpoint.tar", ssl / "checkpoint.tar"):
            saved = checkpoint.read(str(path))
            for key in ("model_state_dict", "ema_model_state_dict"):
                for k, v in saved.get(key, {}).items():
                    dtypes[str(v.dtype)] = dtypes.get(str(v.dtype), 0) + 1
        if set(dtypes) != {"torch.float32"}:
            raise AssertionError(f"{name}: checkpoints hold {dtypes}")
        if not (np.isfinite(map_sum) and all(np.isfinite(v) for v in means.values())):
            raise AssertionError(f"{name} eval: non-finite results")
        say(phase="bf16_drivers", precision=name, checkpoint_dtypes=dtypes, eval_s=eval_s,
            eval_map={t: ap[t]["mAP"] for t in ap}, eval_ar={t: ap[t]["AR"] for t in ap})
        out[name] = {k: v["row"]["launches"] for k, v in runs.items()}
    return out


def phase_bf16(cfg, dev, root: Path) -> dict:
    """Phase 13, bf16 mixed precision at full width (8 x 40,000 points, 128
    proposals), after phase 9 and on its dumps: (b) serving in turns with
    f32; 2 warm-up and 5 timed pretrain and SSL steps of each precision in
    turns, twice, with (d) one profiled step of each kind in f32 and in
    bf16 and bf16 BatchNorm's two forms; then, their long CPU sides after
    the timed cells (long CPU work stalls a host-clock cell after it), (a)
    the forward and (c) the pretrain and SSL steps card vs CPU for
    ``--bf16`` and ``--bf16 --f32_gridconv``; (e) the drivers. Returns the
    bf16 launches (3 requests, 5 pretrain and 5 SSL steps of ``--bf16``,
    the drivers')."""
    t0 = time.perf_counter()
    serve = bf16_serve(cfg, dev)
    train_batch = {k: torch.from_numpy(v).to(dev) for k, v in make_train_batch(22, B, cfg).items()}
    ssl_batch = {k: torch.from_numpy(np.asarray(v)).to(dev)
                 for k, v in make_ssl_batch(53, SSL_NL, SSL_NU, cfg).items()}
    out, timed = {"serve": serve}, {}
    for turn in range(BF16_TURNS):
        for knobs in PRECISIONS:
            name = precision_name(knobs)
            model, state, step, counts, stats = timed_train_steps(cfg, dev, train_batch, knobs)
            timed.setdefault(f"train_{name}", []).append(stats)
            if turn == BF16_TURNS - 1 and name in ("f32", "bf16"):
                out[f"profile_train_{name}"] = split_profile("pretrain", knobs, step, state,
                                                             train_batch, LR)
                if name == "bf16":
                    out["launches_bf16_5_train_steps"] = counts
                    out["bn_bf16_forms"] = bn_bf16_forms(model, step, state, train_batch, dev)
            del model, state, step
            state, step, counts, stats = timed_ssl_steps(cfg, dev, ssl_batch, knobs)
            timed.setdefault(f"ssl_{name}", []).append(stats)
            if turn == BF16_TURNS - 1 and name in ("f32", "bf16"):
                out[f"profile_ssl_{name}"] = split_profile("ssl", knobs, step, state, ssl_batch,
                                                           SSL_LR)
                if name == "bf16":
                    out["launches_bf16_5_ssl_steps"] = counts
            del state, step
    say(phase="bf16_steps", turns=BF16_TURNS, **{k: [
        {"step_ms_median": float(np.median(s["step_ms"])), "wall_ms_per_step": s["wall_ms_per_step"],
         "scenes_per_s": s["scenes_per_s"], "max_memory_allocated": s["max_memory_allocated"]}
        for s in v] for k, v in timed.items()})
    # the card-vs-CPU checks' long CPU sides run after the timed cells
    for knobs in PRECISIONS[1:]:
        bf16_forward(dev, knobs)
        bf16_train_check(cfg, dev, knobs)
        bf16_ssl_check(cfg, dev, knobs)
    out["drivers"] = bf16_drivers(root, dev)
    say(phase="bf16", seconds=time.perf_counter() - t0)
    return out


def first_step_metrics(log: str) -> dict:
    """The metrics a driver's log prints after its first step (``--print_interval 1``)."""
    line = next(x for x in log.splitlines() if x.startswith(" batch 0001 "))
    parts = line.split()[2:]
    return {k.rstrip(":"): float(v) for k, v in zip(parts[::2], parts[1::2])}

def phase_profile(model, forward, pc):
    """Where one request's forward spends its time: CUDA-event spans per
    layer (host launch time included, as the request sees it), then the
    kernels by device time under torch.profiler and the device's busy share."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    bb = model.backbone_net
    layers = {"sa1": bb.sa1, "sa2": bb.sa2, "sa3": bb.sa3, "sa4": bb.sa4, "fp1": bb.fp1,
              "fp2": bb.fp2, "vgen": model.vgen, "pnet": model.pnet, "grid_conv": model.grid_conv}
    marks, hooks = {}, []

    def mark(name):
        ev = torch.cuda.Event(enable_timing=True)
        ev.record()
        marks.setdefault(name, []).append(ev)

    for name, mod in layers.items():
        hooks.append(mod.register_forward_pre_hook(lambda m, a, name=name: mark(name)))
        hooks.append(mod.register_forward_hook(lambda m, a, o, name=name: mark(name)))
    try:
        forward(pc)
        torch.cuda.synchronize()
    finally:
        for h in hooks:
            h.remove()
    layer_ms = {n: s.elapsed_time(e) for n, (s, e) in marks.items()}

    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        t = time.perf_counter()
        forward(pc)
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t) * 1e3
    kern = [e for e in prof.key_averages() if e.device_type == DeviceType.CUDA]
    kern.sort(key=lambda e: e.self_device_time_total, reverse=True)
    busy_ms = sum(e.self_device_time_total for e in kern) / 1e3
    say(phase="profile", layer_ms=layer_ms, profiled_wall_ms=wall_ms, device_busy_ms=busy_ms,
        busy_share=busy_ms / wall_ms,
        top_kernels=[[e.key[:80], e.self_device_time_total / 1e3, e.count] for e in kern[:12]])


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--kernels-only", action="store_true",
                    help="build, then check and time the kernels only")
    ap.add_argument("--fps-sweep", action="store_true",
                    help="also time FPS at every (cluster, threads) of FPS_SWEEP")
    ap.add_argument("--bq-sweep", action="store_true",
                    help="also time the ball query at every (C, T) of BQ_SWEEP at each of its shapes")
    ap.add_argument("--gbwd-sweep", action="store_true",
                    help="also time the gather backward at every GBWD_SWEEP launch at each of its shapes")
    ap.add_argument("--nn-sweep", action="store_true",
                    help="also time three_nn at every (S, Q) of NN_LAUNCHES at each of its shapes")
    ap.add_argument("--nn-counts", action="store_true",
                    help="also run three_nn's -DTHREE_NN_COUNTS build at each of its shapes")
    ap.add_argument("--nms-sweep", action="store_true",
                    help="also time NMS at every cluster size of NMS_CLUSTERS at each of its "
                         "rows, and the global path's at every knob of GLOBAL_TILE_BLOCKS or "
                         "GLOBAL_ROWS_PER_BLOCK")
    ap.add_argument("--nms-only", action="store_true",
                    help="build csrc/nms.cu only, then check and time the NMS rows only")
    ap.add_argument("--ibwd-sweep", action="store_true",
                    help="also time three_interpolate's backward at every launch of IBWD_SWEEP "
                         "at each of its shapes")
    ap.add_argument("--parallel-rank", choices=("a", "b"), help=argparse.SUPPRESS)
    ap.add_argument("--parallel-dir", type=Path, help=argparse.SUPPRESS)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is false", file=sys.stderr)
        return 1
    if args.parallel_rank:  # a rank of phase 12, started by run_ranks
        return parallel_rank(args.parallel_rank, args.parallel_dir)
    dev = torch.device("cuda", 0)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60, check=True)
    card = smi.stdout.strip().splitlines()[0]
    print(card, flush=True)
    model, cfg = build_votenet("scannet", device=dev)  # also switches TF32 off
    flags = {"cuda.matmul.allow_tf32": torch.backends.cuda.matmul.allow_tf32,
             "cudnn.allow_tf32": torch.backends.cudnn.allow_tf32}
    ops_per_s, max_sm_mhz = issue_rate(dev)
    say(phase="card", nvidia_smi=card, torch=torch.__version__, cuda=torch.version.cuda,
        device=torch.cuda.get_device_name(0), count=torch.cuda.device_count(), tf32=flags,
        max_sm_mhz=max_sm_mhz, instructions_per_s=ops_per_s)
    if any(flags.values()):
        raise AssertionError(f"TF32 is on: {flags}")

    if args.nms_only:  # timings of the NMS rows alone, no spill check
        _build.build(("nms",))
        rows = {}
        nms_rows(dev, ops_per_s, rows, launch_floor_ms(), args.nms_sweep)
        return 0
    t = time.perf_counter()
    built = sorted(_build.build())
    seconds = time.perf_counter() - t
    # read back whether built now or before, so the spill check below always runs
    logs = {name: _build.build_log(name) for name in _build.SOURCES}
    fps_regs = fps_ptxas(logs["fps"])
    ptxas = {name: ptxas_report(log) for name, log in logs.items() if name != "fps"}
    say(phase="build", seconds=seconds, built=built, ptxas=ptxas,
        fps_ptxas={f"{t}x{p}": v for (t, p), v in sorted(fps_regs.items())})
    for name, entries in NO_SPILL.items():
        for entry in entries:
            r = ptxas[name].get(entry)
            if r is None or (r.get("spill_stores"), r.get("spill_loads")) != (0, 0):
                raise AssertionError(f"{entry} of {name}.cu spills or is missing: {r}")

    rows = phase_kernels(dev, ops_per_s, args.fps_sweep, args.bq_sweep, args.gbwd_sweep,
                         args.nn_sweep, args.nn_counts, args.nms_sweep, args.ibwd_sweep)
    for r in rows["fps"]:  # the planned variants keep their share on chip, without spills
        key = (r["launch"]["threads"], r["launch"]["ppt"])
        if key not in fps_regs or fps_regs[key][1:] != (0, 0):
            raise AssertionError(f"FPS variant {key} spills or is missing: {fps_regs.get(key)}")
    if args.kernels_only:
        return 0
    for knobs in FORWARD_KNOBS:
        phase_forward(model, dev, knobs)
    serve = phase_serve(model, cfg, dev)
    evals = phase_eval(model, cfg, dev)
    for knobs in MODEL_KNOBS:
        phase_forward(model, dev, knobs)
    train, train_stats = phase_train(cfg, dev)
    ssl, ssl_stats = phase_ssl(cfg, dev)
    data = phase_data(cfg, dev, train_stats, ssl_stats)
    eval_request = {k: v // 3 for k, v in evals[0].items()}
    opt_request = {k: v // 3 for k, v in evals[OPT_STEP].items()}
    root = Path(tempfile.mkdtemp(prefix="chip_smoke_drivers_"))
    try:
        drivers = phase_drivers(cfg, dev, eval_request, root, opt_request)
        phase_parallel(cfg, dev, root)
        bf16 = phase_bf16(cfg, dev, root)
    finally:
        shutil.rmtree(root)
    sunrgbd = phase_sunrgbd(dev, card, ops_per_s, rows, eval_request)
    phase_library(dev)

    kernels = []
    for name, checks in rows.items():
        # the heaviest shape of the serving forward, the eval, the pretrain or the SSL step
        first = max((c for c in checks if c["main"]), key=lambda c: c["bound_ms"])
        # launches over the 5 timed SSL steps, or for a kernel off that path
        # (NMS) over the 3 requests of the eval phase without optimisation
        on_ssl = ssl[name] > 0
        kernels.append({
            "name": name, "route": "cuda",
            "source": f"iou3dmatch_tpu_torch/csrc/{KERNEL_SOURCES.get(name, name)}.cu",
            "replaces": REPLACES[name], "launches": ssl[name] if on_ssl else evals[0][name],
            "launches_of": "5 SSL steps" if on_ssl else "3 eval requests",
            "launches_5_train_steps": train[name], "launches_3_requests": serve[name],
            "launches_5_loader_train_steps": data["train"][name],
            "launches_5_loader_ssl_steps": data["ssl"][name],
            "launches_3_eval_requests": evals[0][name],
            "launches_3_eval_opt_requests": evals[OPT_STEP][name],
            "launches_bf16_3_requests": bf16["serve"]["launches_bf16_3_requests"][name],
            "launches_bf16_5_train_steps": bf16["launches_bf16_5_train_steps"][name],
            "launches_bf16_5_ssl_steps": bf16["launches_bf16_5_ssl_steps"][name],
            **{f"launches_driver_{run}_{p}": counts[name]
               for p, runs in bf16["drivers"].items() for run, counts in runs.items()},
            **{f"launches_driver_{run}": counts[name] for run, counts in drivers.items()},
            **{f"launches_sunrgbd_{run}": counts[name] for run, counts in sunrgbd.items()},
            "max_abs_err": max(c["max_abs_err"] for c in checks),
            "ms": first["ms"], "plain_ms": first["plain_ms"], "bound_ms": first["bound_ms"],
            "bound_by": first["bound_by"], "library_ms": first["library_ms"],
            "shape": first["shape"], "ok": all(c["ok"] for c in checks), "checks": checks,
        })
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                                            "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
