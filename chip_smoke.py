#!/usr/bin/env python3
"""Drives the PyTorch port's detection forward and pretrain step on one NVIDIA GPU.

Run from the repository root: ``python3 chip_smoke.py``. It needs one CUDA
card and the CUDA toolkit (``nvcc``); it builds the kernels from
``iou3dmatch_tpu_torch/csrc/`` into ``build/kernels/`` itself. Phases, each
reported on its own line; a failed check raises and the exit code is not 0:

1. the card (``nvidia-smi`` name and power limit), versions, TF32 flags;
2. the kernels' build, one ``nvcc`` per source, all in parallel, and every
   kernel's registers, stack frame and spills from the compiler output kept
   beside its library;
3. each kernel against its plain PyTorch version on the card, at every shape
   the full-width ScanNet forward and pretrain step launch it at (FPS also
   at the SSL step's 24 clouds; the ball query also on surface scenes and at
   the SSL forward's 12 clouds; the gather's backward also at SA2 of the SSL
   student's 12 scenes; the rotated IoU also on rotated boxes), with
   CUDA-event timings of kernel, plain version and library call, and the
   launch plans of FPS, the ball query and the gather's backward; FPS, the
   ball query and the gather must be exactly equal, the gather's backward
   within 1e-5 x the sum of |g| of each element of an f64 sum, the IoU
   within atol 1e-5; it fails if a planned FPS variant spills;
4. the whole forward on the card against the CPU on one 40,000-point scene;
5. serving: 3 requests of 8 scenes x 40,000 points through the eval forward
   and IoU-guided class-aware NMS, with the kernels' launch counts;
6. training: one pretrain step of 2 scenes on the card against the CPU,
   with GT boxes at the random model's own vote centres (the loss within
   rtol 2e-3, the gradient with cosine > 0.999 and relative L2 < 0.05, FPS
   indices equal, at least MIN_POS_RATIO positives), then 2 warm-up and 5
   timed steps of 8 scenes x 40,000 points (ms a step, scenes/s, peak
   memory, launches a step), one step's forward, backward and optimizer
   spans and its profile, and train-mode BatchNorm at that step's inputs
   in the card's form and in the CPU's.

``--kernels-only`` stops after phase 3 and prints neither of the last two
lines. It also runs from another checkout's root, one whose ball query or
gather backward has no launch plan or whose IoU has no reject rule, so
that two versions of the kernels are timed on one card in one call.
``--fps-sweep`` adds FPS over every cluster x block size of FPS_SWEEP at
the serving shape to phase 3; ``--bq-sweep`` adds the ball query over every
(C, T) of BQ_SWEEP at each of its shapes; ``--gbwd-sweep`` the gather's
backward over every count of sum blocks of GBWD_SWEEP at each of its shapes.

The model is the full-width ScanNet VoteNet (128 proposals, height channel,
SA 2048/1024/512/256) with random weights from a fixed seed. Scenes are
uniform points in a [-3, 3]^2 x [0, 2.5] room with the height channel
z - min z, made from a NumPy seed; a training scene adds 8-16 boxes of
ScanNet classes with vote labels on the points inside them. The surface scenes spread their points
uniformly by area over the floor and four walls of a 4 x 4 x 2.5 m room, as
a scan sees it, so that most balls of r 0.2 fill their 64 slots. The last
two lines are the kernels' JSON and the device JSON.
"""
import argparse
import json
import re
import subprocess
import sys
import time

import numpy as np
import torch

from iou3dmatch_tpu_torch.data.config import get_config
from iou3dmatch_tpu_torch.eval.ap_helper import eval_config_dict, parse_predictions
from iou3dmatch_tpu_torch.geometry.iou3d import bev_candidates, box_pairs, box_pairs_plain
from iou3dmatch_tpu_torch.models.factory import build_votenet
from iou3dmatch_tpu_torch.models.mlp import BatchNorm, set_bn_momentum
from iou3dmatch_tpu_torch.ops import _build
from iou3dmatch_tpu_torch.ops.ball_query import (ball_query, ball_query_plain,
                                                 group_points, group_points_backward,
                                                 group_points_backward_plain,
                                                 group_points_plain)
from iou3dmatch_tpu_torch.ops.fps import (fps_plan, fps_variant, furthest_point_sample,
                                          furthest_point_sample_plain)
from iou3dmatch_tpu_torch.ops.interpolate import three_nn
from iou3dmatch_tpu_torch.train.schedules import get_bn_momentum
from iou3dmatch_tpu_torch.train.state import create_train_state
from iou3dmatch_tpu_torch.train.steps import make_eval_forward, make_pretrain_step

try:
    from iou3dmatch_tpu_torch.ops.ball_query import BallQueryLaunch, ball_query_plan
except ImportError:  # a ball query of one warp per center, timed with --kernels-only
    BallQueryLaunch = ball_query_plan = None
try:
    from iou3dmatch_tpu_torch.ops.ball_query import GatherBwdLaunch, gather_bwd_plan
except ImportError:  # a gather backward of L2 atomics, timed with --kernels-only
    GatherBwdLaunch = gather_bwd_plan = None
try:
    from iou3dmatch_tpu_torch.geometry.iou3d import pairs_apart
except ImportError:  # an IoU kernel without the reject, timed with --kernels-only
    pairs_apart = None

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
KERNELS = {
    "fps": furthest_point_sample,
    "ball_query": ball_query,
    "gather": group_points,
    "gather_bwd": group_points_backward,
    "iou3d": box_pairs,
}
REPLACES = {
    "fps": "iou3dmatch_tpu/ops/fps_pallas.py:46",
    "ball_query": "iou3dmatch_tpu/ops/ball_query.py:35",
    "gather": "iou3dmatch_tpu/ops/gather_pallas.py:35",
    "gather_bwd": "iou3dmatch_tpu/ops/ball_query.py:234",
    "iou3d": "iou3dmatch_tpu/geometry/iou3d.py:94",
}


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


def max_err(a: torch.Tensor, b: torch.Tensor) -> float:
    return float((a.double() - b.double()).abs().max())


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
    ``ops_per_s``; ``main`` marks a shape of the serving forward or the
    pretrain step. ``agree(got, want)`` says whether the kernel's result is
    right; without it, it must equal the plain version's."""
    got, want = kernel(*args), plain(*args)
    torch.cuda.synchronize()
    err = max_err(got, want)
    ok = bool(torch.equal(got, want) if agree is None else agree(got, want))
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


def phase_kernels(dev, ops_per_s, fps_sweep_on: bool = False, bq_sweep_on: bool = False,
                  gbwd_sweep_on: bool = False) -> dict:
    pc = torch.from_numpy(make_scenes(1, B, N)).to(dev)
    rows = {}
    xyz, inds, r = fps_rows(dev, ops_per_s, B, True)
    rows["fps"] = [r]
    if fps_sweep_on:
        fps_sweep(xyz, inds)
    rows["fps"].append(fps_rows(dev, ops_per_s, 24, False)[2])  # the SSL step's shared SA1 FPS

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
        if ball_query_plan is None:
            r["plan"] = "absent: this checkout's ball query has no launch plan"
        else:
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
        if gather_bwd_plan is None:
            r["plan"] = "absent: this checkout's gather backward has no launch plan"
        else:
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
    grid = torch.from_numpy(make_scenes(5, B, 128 * 64)[..., :3].copy()).to(dev)
    _, idx = three_nn(grid, sa2_xyz)
    gather(f"grid_conv ({B},1024,259)x({B},{128 * 64},3)", torch.cat([sa2_xyz, f256], -1), idx)

    # off the step's path: SA2's backward at the SSL student's 12 scenes
    pts = torch.from_numpy(make_scenes(7, SSL_B, NPOINT)[..., :3].copy()).to(dev)
    idx = ball_query(0.4, 32, pts, pts[:, :1024].contiguous())
    gather_bwd(f"sa2 ssl ({SSL_B},{1024 * 32},131)->({SSL_B},{NPOINT},131)",
               torch.empty((SSL_B, NPOINT, 131), device=dev), idx, main=False)

    # off the serving path: SA1 on surface scenes, where most balls fill and
    # the early exit acts, and at the SSL forward's 12 clouds; centers by FPS
    for label, pts in ((f"sa1 surface r0.2 ns64 ({B},{N})x{NPOINT}", make_surface_scenes(6, B, N)),
                       (f"sa1 ssl r0.2 ns64 ({SSL_B},{N})x{NPOINT}",
                        make_scenes(7, SSL_B, N)[..., :3].copy())):
        pts = torch.from_numpy(pts).to(dev)
        ctr = pts[torch.arange(pts.shape[0], device=dev)[:, None], furthest_point_sample(pts, NPOINT).long()]
        bq(label, 0.2, 64, pts, ctr, main=False)
    iou_rows(dev, ops_per_s, rows)
    return rows


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
    those of the full work for every pair, pairs that need it). A checkout
    without ``pairs_apart`` counts every pair as needed."""
    rows, cols = a[:, :, None], b[:, None]
    px, py, valid = bev_candidates(*torch.broadcast_tensors(rows, cols))
    cnt = valid.sum(-1).double()
    if pairs_apart is None:
        need = torch.ones_like(valid[..., 0])
    else:
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


def phase_serve(model, cfg, dev) -> dict:
    forward = make_eval_forward(model)
    config = eval_config_dict(cfg, use_iou_for_nms=True)
    batches = [torch.from_numpy(make_scenes(10 + i, B, N)).to(dev) for i in range(3)]
    forward(batches[0])  # warm-up, not counted
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats(dev)
    for fn in KERNELS.values():
        fn.launches = 0
    t_all = time.perf_counter()
    for i, pc in enumerate(batches):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        out = forward(pc)
        end.record()
        end.synchronize()
        t = time.perf_counter()
        picks = parse_predictions(out, config)
        host_ms = (time.perf_counter() - t) * 1e3
        for k, v in out.items():
            if v.shape[0] != B or not torch.isfinite(v).all():
                raise AssertionError(f"request {i}: {k} has shape {tuple(v.shape)} or non-finite values")
        if out["center"].shape != (B, 128, 3) or out["iou_scores"].shape != (B, 128, 18):
            raise AssertionError(f"request {i}: unexpected output shapes")
        # per-class proposals: one entry per class for each box NMS kept
        say(phase="request", i=i, device_ms=start.elapsed_time(end), host_nms_ms=host_ms,
            boxes_kept_per_scene=[len(p) // cfg.num_class for p in picks])
    wall_s = time.perf_counter() - t_all
    launches = {k: fn.launches for k, fn in KERNELS.items()}
    expect = {"fps": 3, "ball_query": 15, "gather": 18, "gather_bwd": 0, "iou3d": 0}
    say(phase="serve", requests=3, scenes_per_s=3 * B / wall_s, wall_s=wall_s,
        max_memory_allocated=torch.cuda.max_memory_allocated(dev), launches=launches)
    if launches != expect:
        raise AssertionError(f"launch counts {launches}, expected {expect}")
    phase_profile(model, forward, batches[0])
    return launches


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


def phase_train(cfg, dev) -> dict:
    """The pretrain step: one step of 2 scenes on the card and on the CPU
    from the same weights, batch and jitter draws, then 2 warm-up and 5
    timed steps of B scenes, one step's spans and its profile. The check's
    GT boxes sit at the random model's own vote centers, so that at least
    MIN_POS_RATIO of its proposals are positives and every box term of the
    loss carries gradient. Returns the kernels' launches over the 5 timed
    steps."""
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
    expect = {"fps": 1, "ball_query": 5, "gather": 6, "gather_bwd": 4, "iou3d": 2}
    if launches != expect:
        raise AssertionError(f"launches a step {launches}, expected {expect}")
    phase_train_profile(model, state, step, batch, momentum)
    return counts


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
    args = ap.parse_args()
    if args.gbwd_sweep and GatherBwdLaunch is None:
        ap.error("--gbwd-sweep: this checkout's gather backward takes no launch")
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
    if args.kernels_only:
        say(phase="build", seconds=seconds, built=built)
        phase_kernels(dev, ops_per_s, args.fps_sweep, args.bq_sweep, args.gbwd_sweep)
        return 0
    # read back whether built now or before, so the spill check below always runs
    logs = {name: _build.build_log(name) for name in _build.SOURCES}
    fps_regs = fps_ptxas(logs["fps"])
    say(phase="build", seconds=seconds, built=built,
        ptxas={name: ptxas_report(log) for name, log in logs.items() if name != "fps"},
        fps_ptxas={f"{t}x{p}": v for (t, p), v in sorted(fps_regs.items())})

    rows = phase_kernels(dev, ops_per_s, args.fps_sweep, args.bq_sweep, args.gbwd_sweep)
    for r in rows["fps"]:  # the planned variants keep their share on chip, without spills
        key = (r["launch"]["threads"], r["launch"]["ppt"])
        if key not in fps_regs or fps_regs[key][1:] != (0, 0):
            raise AssertionError(f"FPS variant {key} spills or is missing: {fps_regs.get(key)}")
    phase_forward(model, dev)
    serve = phase_serve(model, cfg, dev)
    train = phase_train(cfg, dev)

    kernels = []
    for name, checks in rows.items():
        # the heaviest shape of the serving forward or the pretrain step
        first = max((c for c in checks if c["main"]), key=lambda c: c["bound_ms"])
        kernels.append({
            "name": name, "route": "cuda", "source": f"iou3dmatch_tpu_torch/csrc/{name}.cu",
            "replaces": REPLACES[name], "launches": train[name],  # over the 5 timed train steps
            "launches_3_requests": serve[name],
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
