#!/usr/bin/env python3
"""Drives the PyTorch port's detection forward on one NVIDIA GPU.

Run from the repository root: ``python3 chip_smoke.py``. It needs one CUDA
card and the CUDA toolkit (``nvcc``); it builds the kernels from
``iou3dmatch_tpu_torch/csrc/`` into ``build/kernels/`` itself. Phases, each
reported on its own line; a failed check raises and the exit code is not 0:

1. the card (``nvidia-smi`` name and power limit), versions, TF32 flags;
2. the kernels' build, one ``nvcc`` per source, all in parallel, and each
   FPS variant's registers and spills from the compiler output kept beside
   its library;
3. each kernel against its plain PyTorch version on the card, at every shape
   the full-width ScanNet forward launches it at (FPS also at the SSL step's
   24 clouds; the ball query also on surface scenes and at the SSL
   forward's 12 clouds), required exactly equal, with CUDA-event timings of
   kernel, plain version and library call, FPS's and the ball query's
   launch plans; it fails if a planned FPS variant spills;
4. the whole forward on the card against the CPU on one 40,000-point scene;
5. serving: 3 requests of 8 scenes x 40,000 points through the eval forward
   and IoU-guided class-aware NMS, with the kernels' launch counts.

``--kernels-only`` stops after phase 3 and prints neither of the last two
lines. It also runs from another checkout's root, one whose ball query has
no launch plan, so that two versions of the kernels are timed on one card
in one call. ``--fps-sweep`` adds FPS over every cluster x block size of
FPS_SWEEP at the serving shape to phase 3; ``--bq-sweep`` adds the ball
query over every (C, T) of BQ_SWEEP at each of its shapes.

The model is the full-width ScanNet VoteNet (128 proposals, height channel,
SA 2048/1024/512/256) with random weights from a fixed seed. Scenes are
uniform points in a [-3, 3]^2 x [0, 2.5] room with the height channel
z - min z, made from a NumPy seed. The surface scenes spread their points
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

from iou3dmatch_tpu_torch.eval.ap_helper import eval_config_dict, parse_predictions
from iou3dmatch_tpu_torch.models.factory import build_votenet
from iou3dmatch_tpu_torch.ops import _build
from iou3dmatch_tpu_torch.ops.ball_query import (ball_query, ball_query_plain,
                                                 group_points, group_points_plain)
from iou3dmatch_tpu_torch.ops.fps import (fps_plan, fps_variant, furthest_point_sample,
                                          furthest_point_sample_plain)
from iou3dmatch_tpu_torch.ops.interpolate import three_nn
from iou3dmatch_tpu_torch.train.steps import make_eval_forward

try:
    from iou3dmatch_tpu_torch.ops.ball_query import BallQueryLaunch, ball_query_plan
except ImportError:  # a ball query of one warp per center, timed with --kernels-only
    BallQueryLaunch = ball_query_plan = None

B, N, NPOINT = 8, 40_000, 2048
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
KERNELS = {
    "fps": furthest_point_sample,
    "ball_query": ball_query,
    "gather": group_points,
}
REPLACES = {
    "fps": "iou3dmatch_tpu/ops/fps_pallas.py:46",
    "ball_query": "iou3dmatch_tpu/ops/ball_query.py:35",
    "gather": "iou3dmatch_tpu/ops/gather_pallas.py:35",
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
                 plain_reps=REPS, main=True):
    """Kernel against plain version on ``args``, then timings. ``ops_of``
    counts the instructions the plain result says the work needs, issued at
    ``ops_per_s``; ``main`` marks a shape of the serving forward."""
    got, want = kernel(*args), plain(*args)
    torch.cuda.synchronize()
    err = max_err(got, want)
    ok = bool(torch.equal(got, want))
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


def phase_kernels(dev, ops_per_s, fps_sweep_on: bool = False, bq_sweep_on: bool = False) -> dict:
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
    sa2_xyz = sa1_xyz[:, :1024].contiguous()
    idx = bq(f"sa3 r0.8 ns16 ({B},1024)x512", 0.8, 16, sa2_xyz, sa2_xyz[:, :512].contiguous())
    gather(f"sa3 ({B},1024,259)x({B},512,16)", torch.cat([sa2_xyz, f256], -1), idx)
    sa3_xyz = sa2_xyz[:, :512].contiguous()
    idx = bq(f"sa4 r1.2 ns16 ({B},512)x256", 1.2, 16, sa3_xyz, sa3_xyz[:, :256].contiguous())
    gather(f"sa4 ({B},512,259)x({B},256,16)", torch.cat([sa3_xyz, f256[:, :512]], -1), idx)
    idx = bq(f"vote_agg r0.3 ns16 ({B},1024)x128", 0.3, 16, votes, votes[:, :128].contiguous())
    gather(f"vote_agg ({B},1024,259)x({B},128,16)", torch.cat([votes, f256], -1), idx)
    grid = torch.from_numpy(make_scenes(5, B, 128 * 64)[..., :3].copy()).to(dev)
    _, idx = three_nn(grid, sa2_xyz)
    gather(f"grid_conv ({B},1024,259)x({B},{128 * 64},3)", torch.cat([sa2_xyz, f256], -1), idx)

    # off the serving path: SA1 on surface scenes, where most balls fill and
    # the early exit acts, and at the SSL forward's 12 clouds; centers by FPS
    for label, pts in ((f"sa1 surface r0.2 ns64 ({B},{N})x{NPOINT}", make_surface_scenes(6, B, N)),
                       (f"sa1 ssl r0.2 ns64 ({SSL_B},{N})x{NPOINT}",
                        make_scenes(7, SSL_B, N)[..., :3].copy())):
        pts = torch.from_numpy(pts).to(dev)
        ctr = pts[torch.arange(pts.shape[0], device=dev)[:, None], furthest_point_sample(pts, NPOINT).long()]
        bq(label, 0.2, 64, pts, ctr, main=False)
    return rows


FPS_ENTRY = re.compile(r"fps_cluster_kernelILi(\d+)ELi(n?\d+)E")


def fps_ptxas(log: str) -> dict:
    """{(threads, ppt): (registers, spill store bytes, spill load bytes)} of
    every FPS instantiation, from ``nvcc -Xptxas -v`` output."""
    regs, spills, entry, props = {}, {}, None, None
    for ln in log.splitlines():
        m = FPS_ENTRY.search(ln)
        if "Compiling entry function" in ln:
            entry = m and (int(m[1]), int(m[2].replace("n", "-")))
        elif "Function properties for" in ln:
            props = m and (int(m[1]), int(m[2].replace("n", "-")))
        elif "spill stores" in ln and props:
            st, ld = re.findall(r"(\d+) bytes spill", ln)
            spills[props] = (int(st), int(ld))
        elif "Used" in ln and "registers" in ln and entry:
            regs[entry] = int(re.search(r"Used (\d+) registers", ln)[1])
    return {k: (regs.get(k), *spills.get(k, (None, None))) for k in regs}


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
    expect = {"fps": 3, "ball_query": 15, "gather": 18}
    say(phase="serve", requests=3, scenes_per_s=3 * B / wall_s, wall_s=wall_s,
        max_memory_allocated=torch.cuda.max_memory_allocated(dev), launches=launches)
    if launches != expect:
        raise AssertionError(f"launch counts {launches}, expected {expect}")
    phase_profile(model, forward, batches[0])
    return launches


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
    if args.kernels_only:
        say(phase="build", seconds=seconds, built=built)
        phase_kernels(dev, ops_per_s, args.fps_sweep, args.bq_sweep)
        return 0
    # read back whether built now or before, so the spill check below always runs
    logs = {name: _build.build_log(name) for name in _build.SOURCES}
    fps_regs = fps_ptxas(logs["fps"])
    say(phase="build", seconds=seconds, built=built,
        ptxas=[ln.strip() for name, log in logs.items() if name != "fps"
               for ln in log.splitlines() if "registers" in ln or "spill" in ln],
        fps_ptxas={f"{t}x{p}": v for (t, p), v in sorted(fps_regs.items())})

    rows = phase_kernels(dev, ops_per_s, args.fps_sweep, args.bq_sweep)
    for r in rows["fps"]:  # the planned variants keep their share on chip, without spills
        key = (r["launch"]["threads"], r["launch"]["ppt"])
        if key not in fps_regs or fps_regs[key][1:] != (0, 0):
            raise AssertionError(f"FPS variant {key} spills or is missing: {fps_regs.get(key)}")
    phase_forward(model, dev)
    launches = phase_serve(model, cfg, dev)

    kernels = []
    for name, checks in rows.items():
        # the heaviest serving-path shape
        first = max((c for c in checks if c["main"]), key=lambda c: c["bound_ms"])
        kernels.append({
            "name": name, "route": "cuda", "source": f"iou3dmatch_tpu_torch/csrc/{name}.cu",
            "replaces": REPLACES[name], "launches": launches[name],
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
