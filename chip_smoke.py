#!/usr/bin/env python3
"""Drives the PyTorch port's detection forward, eval, pretrain step, SSL step and training input path on one NVIDIA GPU.

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
   step and at FP1 and FP2 of 8 and 12 scenes, greedy NMS at serving's
   (8, 128) class-aware boxes in float64 (off every path: its float32 3D
   and 2D branches, tied scores, K = 256, 512 and 1,024 and matrix mode on
   a rotated BEV IoU, each with its planned cluster size and its cycles a
   step for the leader block and the others, and the overlaps computed and
   skipped; the ball query on surface scenes, the rotated IoU on rotated
   boxes), with
   CUDA-event timings of kernel, plain version and library call, the
   launch floor (a one-element ``zero_()`` timed the same way), and the
   launch plans of FPS, the ball query, the gather's backward and
   three_nn; FPS, the
   ball query, the gather, LHS, three_nn and NMS must be
   exactly equal, the gather's backward within 1e-5 x the sum of |g| of each
   element of an f64 sum, the IoU within atol 1e-5; it fails if a planned
   FPS variant spills, or three_nn, LHS or NMS spills;
4. the whole forward on the card against the CPU on one 40,000-point scene;
5. serving: 3 requests of 8 scenes x 40,000 points through the eval forward
   and ``parse_predictions``' two halves with IoU-guided class-aware NMS on
   the card, each request's picks equal to the host NumPy parse of the same
   outputs, which is timed beside it (parse ms, host list ms, old host
   parse ms), with the kernels' launch counts; then the first request
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
   in the card's form and in the CPU's;
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
   empty Adam state.

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
rows.

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
import functools
import itertools
import json
import os
import pickle
import re
import shutil
import subprocess
import sys
import tempfile
import time
import types
from pathlib import Path

import numpy as np
import torch

from iou3dmatch_tpu_torch.cli import common as cli_common
from iou3dmatch_tpu_torch.data.config import get_config
from iou3dmatch_tpu_torch.data.loader import DataLoader, SSLBatcher, prefetch
from iou3dmatch_tpu_torch.data.scannet import ScannetDetectionDataset
from iou3dmatch_tpu_torch.data.staging import layout as staging_layout
from iou3dmatch_tpu_torch.data.staging import stage_batch
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
from iou3dmatch_tpu_torch.losses import unlabeled
from iou3dmatch_tpu_torch.models.factory import build_votenet
from iou3dmatch_tpu_torch.models import grid_conv, pointnet2
from iou3dmatch_tpu_torch.models.mlp import BatchNorm, set_bn_momentum
from iou3dmatch_tpu_torch.ops import _build
from iou3dmatch_tpu_torch.ops.ball_query import (BallQueryLaunch, GatherBwdLaunch, ball_query,
                                                 ball_query_plain, ball_query_plan,
                                                 gather_bwd_plan, group_points,
                                                 group_points_backward,
                                                 group_points_backward_plain,
                                                 group_points_plain)
from iou3dmatch_tpu_torch.ops.fps import (fps_plan, fps_variant, furthest_point_sample,
                                          furthest_point_sample_plain)
from iou3dmatch_tpu_torch.ops.interpolate import (NN_LAUNCHES, NnLaunch, three_nn, three_nn_plain,
                                                  three_nn_plan)
from iou3dmatch_tpu_torch.ops.lhs import SMALL_BOXES, lhs_3d_samecls
from iou3dmatch_tpu_torch.ops.nms import MODE_IDS as NMS_MODE_IDS
from iou3dmatch_tpu_torch.ops.nms import NMS_CLUSTERS, nms_boxes, nms_masked, planned_cluster
from iou3dmatch_tpu_torch.ops.nms import max_active_clusters as nms_max_active
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
# boxes still remaining (nms_pairs, a replay of the rounds); ordering K
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
}
# three_nn's operations: each (query, seed) pair is a distance test of
# PAIR_OPS (3 sub, 3 mul, 2 add, 1 compare; no FMA, csrc/three_nn.cu is
# built with -fmad=false); each query's 3 selected d2 are computed again,
# with their square roots, at about a pair's cost each: (m + 3) PAIR_OPS a
# query.
NN_YARDSTICK = "torch.cdist + topk(3, largest=False): two calls, matmul-form distances, not exact"
# the kernels whose compiler report must list these entries, none spilling
NO_SPILL = {"three_nn": tuple(f"three_nn_kernelILi{s}ELi{q}EE" for s, q in NN_LAUNCHES),
            "lhs": ("lhs_small_kernel", "lhs_kernel"),
            "nms": tuple(f"nms_kernelILi{mode}EE" for mode in range(4))}
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
                  "three_nn": 3, "nms": 0}
SSL_LAUNCHES = {"fps": 1, "ball_query": 10, "gather": 12, "gather_bwd": 4, "iou3d": 3, "lhs": 1,
                "three_nn": 6, "nms": 0}
# Phase 8's dumps: ScanNet scans as data/prep_scannet.py writes them, at
# its MAX_NUM_POINT of 50,000 vertices (prep_scannet.py:31)
DUMP_SCANS, DUMP_TRAIN, DUMP_LABELED = 48, 40, 8
DUMP_VERTICES = 50_000
LOADER_WORKERS = 4  # the drivers' --num_workers default (cli/pretrain.py:69)


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


def fps_rows(dev, ops_per_s, b, main):
    """FPS at (b, N) -> NPOINT with the planned launch, µs per step beside it."""
    xyz = torch.from_numpy(make_scenes(1, b, N)[..., :3].copy()).to(dev)
    inds, r = check_kernel(
        "fps", f"({b},{N},3)->{NPOINT}", furthest_point_sample, furthest_point_sample_plain,
        None, (xyz, NPOINT), b * N * 12 + b * NPOINT * 4,
        lambda _: (NPOINT - 1) * b * N * PAIR_OPS,  # per point and step: 3 sub, 3 mul, 2 add, 1 min
        ops_per_s, 3, PLAIN_FPS_REPS, main)
    r["us_per_step"] = r["ms"] * 1e3 / (NPOINT - 1)
    launch, answers = fps_plan(dev, b, N)
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
                  nn_counts_on: bool = False, nms_sweep_on: bool = False) -> dict:
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

    def gather(label, table, idx):
        b, n, c = table.shape
        q = idx.shape[1] * idx.shape[2]
        flat = idx.long().clamp(0, n - 1)
        # the table rows the indices name, each read once; the indices; the output
        rows_read = sum(int(torch.unique(flat[i]).numel()) for i in range(b))
        nbytes = rows_read * c * 4 + b * q * 4 + b * q * c * 4
        library = lambda t, i: t[rows_idx[:, :, None], flat]  # noqa: E731
        _, r = check_kernel("gather", label, group_points, group_points_plain, library,
                            (table, idx), nbytes, lambda _: 0, ops_per_s, 10)
        rows.setdefault("gather", []).append(r)

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
    sa3_xyz = sa2_xyz[:, :512].contiguous()
    idx = bq(f"sa4 r1.2 ns16 ({B},512)x256", 1.2, 16, sa3_xyz, sa3_xyz[:, :256].contiguous())
    gather(f"sa4 ({B},512,259)x({B},256,16)", torch.cat([sa3_xyz, f256[:, :512]], -1), idx)
    gather_bwd(f"sa4 ({B},{256 * 16},259)->({B},512,259)", torch.cat([sa3_xyz, f256[:, :512]], -1),
               idx)
    idx = bq(f"vote_agg r0.3 ns16 ({B},1024)x128", 0.3, 16, votes, votes[:, :128].contiguous())
    gather(f"vote_agg ({B},1024,259)x({B},128,16)", torch.cat([votes, f256], -1), idx)
    gather_bwd(f"vote_agg ({B},{128 * 16},259)->({B},1024,259)", torch.cat([votes, f256], -1), idx)
    _, idx = three_nn(grid_queries(sa2_xyz, False, 5), sa2_xyz)
    gather(f"grid_conv ({B},1024,259)x({B},{K * 64},3)", torch.cat([sa2_xyz, f256], -1), idx)

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
    three_nn_rows(ops_per_s, rows, sa1_xyz, ctr, floor, nn_sweep_on, nn_counts_on)
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
                  counts_on: bool = False):
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
    names its plan (S, Q) and carries the launch floor ``floor``."""
    n_sm = torch.cuda.get_device_properties(sa1_8.device).multi_processor_count

    def one(label, unknown, known):
        b, n, m = unknown.shape[0], unknown.shape[1], known.shape[1]
        nbytes = (b * n * 3 + b * m * 3) * 4 + b * n * 3 * (4 + 4)
        got, r = check_kernel("three_nn", label, three_nn, three_nn_plain, None, (unknown, known),
                              nbytes, lambda _: b * n * (m + 3) * PAIR_OPS, ops_per_s, 5)
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


def make_boxes(rng, b: int, n: int, rotated: bool) -> np.ndarray:
    """(b, n, 7) boxes of ScanNet classes inside the room: sizes from the
    class means x U(0.8, 1.2), headings uniform when ``rotated`` (SUN RGB-D
    has them), else 0."""
    mean = get_config("scannet").mean_size_arr
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


def make_lhs_input(seed: int, b: int, k: int) -> tuple:
    """LHS's input at the SSL step's shape: (b, k) axis-aligned bounds of
    boxes of ScanNet classes in the room, half of them copies of others
    moved by N(0, 0.1) m with the same class, as a teacher's clusters of
    near-duplicate proposals; scores uniform."""
    rng = np.random.RandomState(seed)
    box = make_boxes(rng, b, k, False)
    cls = rng.randint(0, 18, (b, k))
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


def lhs_rows(dev, ops_per_s, rows, thresh: float = 0.25):
    """LHS at the SSL step's (8, 64) boxes (``make_lhs_input``): equal to
    the plain version. The bound counts the work this input needs, from a
    replay of its rounds (``lhs_work``, itself held to the kernel's keep
    mask), and each input byte and output byte once. ns_per_round is the
    kernel's time over the most rounds of one scene, as the scenes run in
    parallel (the launch and the sort included)."""
    b, k = SSL_NU, unlabeled.MAX_NUM_OBJ
    args = [torch.from_numpy(x).to(dev) for x in make_lhs_input(40, b, k)] + [thresh]
    replay, nrounds, nsupp, box_rounds, rank_pairs, most = lhs_work(*args)
    ops = b * k * LHS_BOX_OPS + box_rounds * LHS_ROUND_OPS + rank_pairs * LHS_RANK_OPS
    nbytes = b * k * (7 * 4 + 8 + 1)  # bounds and score f32, int64 class, bool keep
    got, r = check_kernel("lhs", f"({b},{k}) boxes, IoU > {thresh}", lhs_3d_samecls,
                          lhs_3d_samecls_plain, None, args, nbytes, lambda _: ops, ops_per_s, 10)
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
    rows["lhs"] = [r]


def nms_pairs(over: torch.Tensor, scores: torch.Tensor, higher_index_first: bool) -> int:
    """The overlaps greedy NMS needs on these inputs: each round's winner
    against the boxes still remaining after it, summed over the rounds and
    scenes, from a replay of the rounds on the host with the plain
    version's suppression matrix ``over`` (B, K, K) and its pick order."""
    over, scores = over.cpu().numpy(), scores.cpu()
    total = 0
    for s in range(scores.shape[0]):
        sc = scores[s].tolist()
        order = sorted(range(len(sc)), key=lambda i: (sc[i], i if higher_index_first else -i),
                       reverse=True)
        left = np.array(order, np.int64)
        while left.size:
            w, rest = left[0], left[1:]
            total += rest.size
            left = rest[~over[s, w, rest]]
    return int(total)


def nms_rows(dev, ops_per_s, rows, floor: float, sweep_on: bool = False):
    """Greedy NMS (csrc/nms.cu) against its plain versions, exactly: box mode
    at serving's (B, K) class-aware in float64 at IoU 0.25 (the main path's
    shape), the 3D and 2D float32 branches, tied scores, K = 256, 512 and
    1,024 (the most proposals the model makes), and matrix mode on the
    rotated BEV IoU of (B, K) boxes (nms_rotated's). Each row names its
    planned cluster size, the card's cudaOccupancyMaxActiveClusters answers
    it was planned from, and its cycles a step (``nms_phases``);
    ``sweep_on`` also times every cluster size.
    The boxes are ``make_lhs_input``'s clusters of near-duplicates. The
    bound counts each input and output byte once, the overlaps the rounds
    need (``nms_pairs``, NMS_PAIR_OPS each) with each box's area, and a
    sort of the keys; its time lies under any launch's, so each row also
    gives its time over the launch floor ``floor``."""
    n_sm = torch.cuda.get_device_properties(dev).multi_processor_count
    f64_ratio = LANES_PER_SM / FP64_LANES_PER_SM  # float32 instructions a float64 one costs

    def one(label, mode, tensors, thresh, main):
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
        pairs = nms_pairs(over, scores, mode != "matrix")
        scale = f64_ratio if mode == "3d_cls" else 1.0
        ops = (pairs * NMS_PAIR_OPS[mode] + b * k * NMS_AREA_OPS[mode]) * scale \
            + b * k * int(np.ceil(np.log2(max(k, 2))))
        got, r = check_kernel("nms", label, kernel, plain, None, args, nbytes, lambda _: ops,
                              ops_per_s, 10, main=main)
        cluster = planned_cluster(dev, b, k, mode)
        answers = {c: nms_max_active(dev, mode, k, c) for c in NMS_CLUSTERS[1:]}
        r.update(mode=mode, pairs=pairs, kept=int(got.sum()), launch_floor_ms=floor,
                 of_floor=r["ms"] / floor, plain_rounds="K masked rounds in PyTorch",
                 cluster=cluster, max_active_clusters=answers)
        r["phases"] = nms_phases(args, got, cluster)
        say(phase="nms_work", shape=label, mode=mode, pairs=pairs, ops=ops, kept=r["kept"],
            of_floor=r["of_floor"], fp64_lanes_per_sm=FP64_LANES_PER_SM, sms=n_sm,
            cluster=cluster, max_active_clusters=answers, phases=r.get("phases"))
        rows.setdefault("nms", []).append(r)
        if sweep_on:
            nms_sweep(label, kernel, args, got)

    def boxes(seed, k, tied=False):
        mins, maxs, scores, cls = make_lhs_input(seed, B, k)
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
    its characters), with its integer template arguments as mangled, or
    None."""
    m = re.search(r"_ZN(\w+)", line)
    rest = m[1] if m else ""
    while rest[:1].isdigit():
        digits = re.match(r"\d+", rest)[0]
        ident, rest = rest[len(digits):len(digits) + int(digits)], rest[len(digits) + int(digits):]
        if ident.endswith("_kernel"):
            args = re.match(r"I(?:Lin?\d+E)+E", rest)
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


def phase_forward(model_gpu, dev):
    model_cpu, _ = build_votenet("scannet", device="cpu")  # same seed, same weights
    pc = torch.from_numpy(make_scenes(4, 1, N))
    with torch.inference_mode():
        t = time.perf_counter()
        ep_gpu = model_gpu(pc.to(dev))
        torch.cuda.synchronize()
        gpu_s = time.perf_counter() - t
        t = time.perf_counter()
        ep_cpu = model_cpu(pc)
        cpu_s = time.perf_counter() - t
    if not torch.equal(ep_gpu["sa1_inds"].cpu(), ep_cpu["sa1_inds"]):
        raise AssertionError("sa1_inds differ between the card and the CPU")
    diffs = {}
    for k in ("center", "objectness_scores", "sem_cls_scores", "size_residuals", "iou_scores"):
        a, b = ep_gpu[k].cpu(), ep_cpu[k]
        diffs[k] = max_err(a, b)
        if not torch.isfinite(a).all() or not torch.allclose(a, b, rtol=1e-3, atol=1e-3):
            raise AssertionError(f"{k} differs between the card and the CPU: max {diffs[k]}")
    say(phase="forward_vs_cpu", scenes=1, points=N, sa1_inds_equal=True, tol="atol 1e-3 rtol 1e-3",
        max_abs_diff=diffs, gpu_s=gpu_s, cpu_s=cpu_s)


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
              "three_nn": 9, "nms": 3}
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
                  "iou3d": 3, "lhs": 0, "three_nn": 3 * (2 + grid), "nms": 3}
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


def vote_anchors(pc: np.ndarray, dev) -> np.ndarray:
    """The random model's (b, K, 3) aggregated_vote_xyz on ``pc`` in train
    mode, where the step's objectness labels are taken; from a model of its
    own, so that no state the step starts from moves."""
    model, _ = build_votenet("scannet", device=dev)
    model.train()
    set_bn_momentum(model, get_bn_momentum(0))
    with torch.no_grad():
        return model.forward_backbone(torch.from_numpy(pc).to(dev))["aggregated_vote_xyz"].cpu().numpy()


def phase_train(cfg, dev) -> tuple:
    """The pretrain step: one step of 2 scenes on the card and on the CPU
    from the same weights, batch and jitter draws, then 2 warm-up and 5
    timed steps of B scenes, one step's spans and its profile. The check's
    GT boxes sit at the random model's own vote centers, so that at least
    MIN_POS_RATIO of its proposals are positives and every box term of the
    loss carries gradient. Returns the kernels' launches over the 5 timed
    steps and the timed steps' ms, wall ms and scenes/s."""
    momentum = get_bn_momentum(0)
    batch = make_train_batch(20, 2, cfg, vote_anchors(make_scenes(20, 2, N), dev))
    noise = torch.randn((2, 2, K, 3), generator=torch.Generator().manual_seed(21))
    runs = []
    for where in (dev, torch.device("cpu")):
        model, _ = build_votenet("scannet", device=where)  # seed 0: the same weights
        state = create_train_state(model)
        seen = {}
        hook = model.backbone_net.register_forward_hook(
            lambda m, a, ep: seen.__setitem__("sa1_inds", ep["sa1_inds"].cpu()))
        t = time.perf_counter()
        metrics = make_pretrain_step(cfg)(
            state, {k: torch.from_numpy(v).to(where) for k, v in batch.items()}, LR, momentum,
            noise=(noise[0].to(where), noise[1].to(where)))
        loss = float(metrics["loss"])
        seconds = time.perf_counter() - t
        hook.remove()
        runs.append((loss, _grads(model), seen["sa1_inds"], seconds, float(metrics["pos_ratio"])))
    (loss_gpu, g_gpu, inds_gpu, gpu_s, pos), (loss_cpu, g_cpu, inds_cpu, cpu_s, pos_cpu) = runs
    cos = float(g_gpu @ g_cpu / (g_gpu.norm() * g_cpu.norm()))
    rel_l2 = float((g_gpu - g_cpu).norm() / g_cpu.norm())
    say(phase="train_vs_cpu", scenes=2, points=N, loss_gpu=loss_gpu, loss_cpu=loss_cpu,
        grad_cosine=cos, grad_rel_l2=rel_l2, pos_ratio=pos, pos_ratio_cpu=pos_cpu, gpu_s=gpu_s,
        cpu_s=cpu_s, tol=f"loss rtol 2e-3, gradient cosine > 0.999 and relative L2 < 0.05, "
                         f"pos_ratio >= {MIN_POS_RATIO}")
    if not torch.equal(inds_gpu, inds_cpu):
        raise AssertionError("the step's FPS indices differ between the card and the CPU")
    if min(pos, pos_cpu) < MIN_POS_RATIO:
        raise AssertionError(f"pos_ratio {pos} on the card, {pos_cpu} on the CPU: too few positives")
    if not (np.isfinite(loss_gpu) and abs(loss_gpu - loss_cpu) <= 2e-3 * abs(loss_cpu)):
        raise AssertionError(f"step loss {loss_gpu} on the card, {loss_cpu} on the CPU")
    if not (cos > 0.999 and rel_l2 < 0.05):
        raise AssertionError(f"step gradient: cosine {cos}, relative L2 {rel_l2}")

    model, _ = build_votenet("scannet", device=dev)
    state = create_train_state(model)
    step = make_pretrain_step(cfg)
    batch = {k: torch.from_numpy(v).to(dev) for k, v in make_train_batch(22, B, cfg).items()}
    for _ in range(2):
        step(state, batch, LR, momentum)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats(dev)
    for fn in KERNELS.values():
        fn.launches = 0
    events, losses = [], []
    t = time.perf_counter()
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
    say(phase="train", scenes=B, points=N, steps=5, step_ms=step_ms, wall_ms_per_step=wall_s * 200,
        scenes_per_s=5 * B / wall_s, max_memory_allocated=torch.cuda.max_memory_allocated(dev),
        losses=losses.tolist(), launches_per_step=launches,
        adam="torch.optim.Adam, foreach", lr=LR, bn_momentum=momentum)
    if not torch.isfinite(losses).all():
        raise AssertionError(f"non-finite training loss: {losses.tolist()}")
    if launches != TRAIN_LAUNCHES:
        raise AssertionError(f"launches a step {launches}, expected {TRAIN_LAUNCHES}")
    phase_train_profile(model, state, step, batch, momentum)
    return counts, {"step_ms": step_ms, "wall_ms_per_step": wall_s * 200,
                    "scenes_per_s": 5 * B / wall_s}


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


def bn_forms(shapes, dev):
    """Train-mode BatchNorm forward and backward at each of one step's BN
    inputs (rows, C), in the card's form (PyTorch's native kernels) and in
    the CPU's (``BatchNorm.two_pass``, written out); ms a step, summed."""
    gen = torch.Generator(device=dev).manual_seed(9)
    total = {"native": 0.0, "two_pass": 0.0}
    for rows, c in shapes:
        bn = BatchNorm(c).to(dev)
        bn.momentum = get_bn_momentum(0)
        x = torch.randn(rows, c, generator=gen, device=dev, requires_grad=True)
        g = torch.randn(rows, c, generator=gen, device=dev)
        for form, fn in (("native", bn), ("two_pass", bn.two_pass)):
            total[form] += cuda_ms(lambda: torch.autograd.grad(fn(x), (x, bn.weight, bn.bias), g), 1, 5)
    say(phase="bn_forms", layers_a_step=len(shapes), forward_backward_ms_a_step=total)


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


def teacher_thresholds(pc: np.ndarray, noise, dev, nl: int) -> dict:
    """Pseudo-label thresholds at the 0.3, 0.3 and 0.2 quantiles of the
    random teacher's own train-mode objectness, class and IoU scores on the
    unlabeled scenes of ``pc``, the step's teacher forward on a model of
    its own: the released 0.9 / 0.9 / 0.25 pass none of a random model's
    boxes, these pass a share."""
    model, _ = build_votenet("scannet", device=dev)
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


def ssl_check(cfg, dev):
    """One SSL step of 1 labeled + 1 unlabeled scene on the card and on the
    CPU, ``reference_exact`` with view-stats, from the same weights, batch
    and jitter draws, with thresholds low enough for pseudo labels
    (``teacher_thresholds``) and LHS IoU ``SSL_CHECK_NMS_IOU``: the gates
    of the pretrain check, FPS indices equal, pseudo labels on both sides,
    LHS dropping boxes, its keep masks equal between the card and the CPU,
    and the card's LHS equal to its plain version on the card's inputs."""
    momentum = get_bn_momentum(0)
    student_pc, _ = augment_view(make_scenes(50, 2, N), 51)
    batch = make_ssl_batch(50, 1, 1, cfg, vote_anchors(student_pc, dev))
    noise = torch.randn((4, 2, K, 3), generator=torch.Generator().manual_seed(52))
    thr = teacher_thresholds(batch["ema_point_clouds"], (noise[0], noise[1]), dev, 1)
    runs = []
    for where in (dev, torch.device("cpu")):
        model, _ = build_votenet("scannet", device=where)  # seed 0: the same weights
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
                                    nms_iou=SSL_CHECK_NMS_IOU, **thr)(
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
    say(phase="ssl_vs_cpu", scenes="1 + 1", points=N, thresholds=thr, nms_iou=SSL_CHECK_NMS_IOU,
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


def phase_ssl(cfg, dev) -> tuple:
    """The SSL step: the card-vs-CPU check (``ssl_check``), then 2 warm-up
    and 5 timed steps at the users' settings (run_train.sh): 4 labeled + 8
    unlabeled scenes, ``reference_exact`` with view-stats, thresholds 0.9 /
    0.9 / 0.25, lr 2e-3, epoch 0's BN momentum, EMA decay 0.999; then one
    step's spans and profile. Returns the kernels' launches over the 5
    timed steps and the timed steps' ms, wall ms and scenes/s."""
    ssl_check(cfg, dev)
    momentum = get_bn_momentum(0)
    model, _ = build_votenet("scannet", device=dev)
    state = create_train_state(model, with_ema=True)
    step = make_ssl_step(cfg, SSL_NL, reference_exact=True, view_stats=True)
    batch = {k: torch.from_numpy(np.asarray(v)).to(dev)
             for k, v in make_ssl_batch(53, SSL_NL, SSL_NU, cfg).items()}
    for _ in range(2):
        step(state, batch, SSL_LR, momentum)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats(dev)
    for fn in KERNELS.values():
        fn.launches = 0
    events, metrics = [], []
    t = time.perf_counter()
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
    say(phase="ssl", scenes=f"{SSL_NL} + {SSL_NU}", points=N, steps=5,
        step_ms=step_ms, wall_ms_per_step=wall_s * 200,
        scenes_per_s=5 * scenes / wall_s, max_memory_allocated=torch.cuda.max_memory_allocated(dev),
        losses=losses.tolist(), pseudo_gt_ratio=[float(m["pseudo_gt_ratio"]) for m in metrics],
        launches_per_step=launches, lr=SSL_LR, bn_momentum=momentum, ema_decay=0.999,
        thresholds="0.9 / 0.9 / 0.25")
    if not torch.isfinite(losses).all():
        raise AssertionError(f"non-finite SSL loss: {losses.tolist()}")
    if launches != SSL_LAUNCHES:
        raise AssertionError(f"SSL launches a step {launches}, expected {SSL_LAUNCHES}")
    phase_ssl_profile(state, step, batch, momentum)
    return counts, {"step_ms": step_ms, "wall_ms_per_step": wall_s * 200,
                    "scenes_per_s": 5 * scenes / wall_s}


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
                    help="also time NMS at every cluster size of NMS_CLUSTERS at each of its rows")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is false", file=sys.stderr)
        return 1
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
                         args.nn_sweep, args.nn_counts, args.nms_sweep)
    for r in rows["fps"]:  # the planned variants keep their share on chip, without spills
        key = (r["launch"]["threads"], r["launch"]["ppt"])
        if key not in fps_regs or fps_regs[key][1:] != (0, 0):
            raise AssertionError(f"FPS variant {key} spills or is missing: {fps_regs.get(key)}")
    if args.kernels_only:
        return 0
    phase_forward(model, dev)
    serve = phase_serve(model, cfg, dev)
    evals = phase_eval(model, cfg, dev)
    train, train_stats = phase_train(cfg, dev)
    ssl, ssl_stats = phase_ssl(cfg, dev)
    data = phase_data(cfg, dev, train_stats, ssl_stats)

    kernels = []
    for name, checks in rows.items():
        # the heaviest shape of the serving forward, the eval, the pretrain or the SSL step
        first = max((c for c in checks if c["main"]), key=lambda c: c["bound_ms"])
        # launches over the 5 timed SSL steps, or for a kernel off that path
        # (NMS) over the 3 requests of the eval phase without optimisation
        on_ssl = ssl[name] > 0
        kernels.append({
            "name": name, "route": "cuda", "source": f"iou3dmatch_tpu_torch/csrc/{name}.cu",
            "replaces": REPLACES[name], "launches": ssl[name] if on_ssl else evals[0][name],
            "launches_of": "5 SSL steps" if on_ssl else "3 eval requests",
            "launches_5_train_steps": train[name], "launches_3_requests": serve[name],
            "launches_5_loader_train_steps": data["train"][name],
            "launches_5_loader_ssl_steps": data["ssl"][name],
            "launches_3_eval_requests": evals[0][name],
            "launches_3_eval_opt_requests": evals[OPT_STEP][name],
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
