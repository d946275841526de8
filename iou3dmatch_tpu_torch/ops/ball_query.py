"""Ball query and grouping.

Counterpart of ``iou3dmatch_tpu/ops/ball_query.py``, with the semantics of
the reference CUDA kernels:

- ``ball_query`` (``ball_query_gpu.cu:14-58``): for each center, the first
  ``nsample`` points in scan order whose squared distance is strictly below
  f32(r) * f32(r); slots past the hit count repeat the first hit; a center
  with no hit gets index 0. int32 output, no gradient. On a CUDA tensor it
  launches ``csrc/ball_query.cu``: blocks of 8 warps, each warp holding C
  centers of one scene, share each tile of T points of the cloud that they
  stage in shared memory; ``ball_query_plan`` picks (C, T) from the shape
  and the card's SM count.
- ``group_points`` (``group_points_gpu.cu:13-79``): a row gather
  (B, N, C) x (B, m, ns) -> (B, m, ns, C), indices clamped to [0, N-1],
  differentiable in the table through one ``torch.autograd.Function``. On
  a CUDA tensor it launches ``csrc/gather.cu``, and its backward
  ``group_points_backward`` (the segment sum of the cotangent rows into
  the table rows they came from) launches ``csrc/gather_bwd.cu``: a
  counting sort of each scene's slots by row, then a warp for each run of
  whole rows, which writes each row's sum once; ``gather_bwd_plan`` picks
  the runs from the shape and the SM count.
- ``group_points_bitcast`` (bf16 mixed precision, JAX
  ``models/pointnet2.py:133-165``): one gather of the bf16 table [f32 xyz
  bitcast into 6 bf16 lanes | bf16 features], which ``csrc/gather.cu`` and
  ``csrc/gather_bwd.cu`` run as pairs of bf16 lanes viewed as f32 words.

Each wrapper takes its plain version only for a CPU tensor.
"""
from typing import NamedTuple, Optional

import numpy as np
import torch

from . import _build


def _radius_sq(radius: float) -> float:
    # f32(r) * f32(r), as the CUDA kernel computes it; f32(r * r) in double
    # is one ulp off for r = 0.2 and can flip a point under the strict test
    return float(np.float32(radius) * np.float32(radius))


def ball_query_plain(radius: float, nsample: int, xyz: torch.Tensor,
                     new_xyz: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch ball query. xyz: (B, N, 3), new_xyz: (B, m, 3) ->
    (B, m, nsample) int32. One scene at a time, so the (m, N) distance
    matrix is the largest temporary."""
    r2 = _radius_sq(radius)
    xyz, new_xyz = xyz.float(), new_xyz.float()
    b, n, _ = xyz.shape
    m = new_xyz.shape[1]
    k = min(nsample, n)
    order = torch.arange(n, dtype=torch.int32, device=xyz.device)
    out = torch.empty((b, m, nsample), dtype=torch.int32, device=xyz.device)
    for i in range(b):
        c, p = new_xyz[i], xyz[i]
        dx = c[:, None, 0] - p[None, :, 0]
        dy = c[:, None, 1] - p[None, :, 1]
        dz = c[:, None, 2] - p[None, :, 2]
        hit = (dx * dx + dy * dy + dz * dz) < r2
        # the first nsample hits in scan order are the nsample smallest
        # indices among the hits; n marks a miss
        best = torch.where(hit, order, n).topk(k, dim=1, largest=False).values
        if k < nsample:
            best = torch.cat([best, best.new_full((m, nsample - k), n)], dim=1)
        found = best < n
        first = torch.where(found[:, :1], best[:, :1], 0)
        out[i] = torch.where(found, best, first)
    return out


# Centers a warp holds in registers: the instantiations of csrc/ball_query.cu.
BQ_CENTERS = (1, 2, 4, 8)
WARPS = 8  # a block's warps: csrc/ball_query.cu kWarps
MAX_TILE = 2048  # points; two tiles fill the 48 KB of default dynamic shared memory


class BallQueryLaunch(NamedTuple):
    """Blocks of WARPS warps, each warp holding ``centers`` centers of one
    scene; the scene's cloud streams through shared memory in double-buffered
    tiles of ``tile`` points."""
    centers: int
    tile: int

    @property
    def group(self) -> int:
        """Centers a block holds."""
        return self.centers * WARPS

    def blocks(self, b: int, m: int) -> int:
        return b * -(-m // self.group)


def ball_query_plan(b: int, m: int, n: int, n_sm: int) -> BallQueryLaunch:
    """The launch for B scenes of N points and m centers each: tiles of 2,048
    points (fewer when the cloud is smaller), and the largest C of BQ_CENTERS
    whose blocks still give every SM one; C = 1 where even that leaves SMs
    idle. A larger C spreads a chunk's shared loads and vote over more
    centers; fewer blocks than SMs leave SMs without work."""
    tile = min(MAX_TILE, -(-n // 32) * 32)
    for c in reversed(BQ_CENTERS):
        launch = BallQueryLaunch(c, tile)
        if launch.blocks(b, m) >= n_sm:
            return launch
    return BallQueryLaunch(1, tile)


def ball_query(radius: float, nsample: int, xyz: torch.Tensor, new_xyz: torch.Tensor,
               launch: Optional[BallQueryLaunch] = None) -> torch.Tensor:
    """xyz: (B, N, 3) candidates, new_xyz: (B, m, 3) centers, both f32 ->
    (B, m, nsample) int32 indices into xyz. ``launch`` overrides the planned
    launch (for sweeps and tests)."""
    if xyz.device.type == "cpu":
        return ball_query_plain(radius, nsample, xyz, new_xyz)
    _build.require(xyz, torch.float32, "xyz")
    _build.require(new_xyz, torch.float32, "new_xyz", xyz.device)
    if xyz.dim() != 3 or xyz.shape[2] != 3 or new_xyz.dim() != 3 \
            or new_xyz.shape[2] != 3 or new_xyz.shape[0] != xyz.shape[0]:
        raise ValueError(
            f"xyz (B, N, 3) and new_xyz (B, m, 3) expected, got "
            f"{tuple(xyz.shape)} and {tuple(new_xyz.shape)}")
    b, n, _ = xyz.shape
    m = new_xyz.shape[1]
    if b < 1 or n < 1 or m < 1 or nsample < 1:
        raise ValueError(f"empty ball query: B={b}, N={n}, m={m}, nsample={nsample}")
    if launch is None:
        n_sm = torch.cuda.get_device_properties(xyz.device).multi_processor_count
        launch = ball_query_plan(b, m, n, n_sm)
    if launch.centers not in BQ_CENTERS or launch.tile % 32 or not 32 <= launch.tile <= MAX_TILE:
        raise ValueError(f"csrc/ball_query.cu has no launch {launch}")
    out = torch.empty((b, m, nsample), dtype=torch.int32, device=xyz.device)
    fn = _build.kernel("ball_query", "ball_query_launch",
                       (_build.VP,) * 3 + (_build.INT,) * 4 + (_build.FLOAT,)
                       + (_build.INT,) * 2 + (_build.VP,))
    _build.check(fn(xyz.data_ptr(), new_xyz.data_ptr(), out.data_ptr(), b, n, m, nsample,
                    _radius_sq(radius), *launch, _build.stream(xyz)), "ball_query")
    ball_query.launches += 1
    return out


ball_query.launches = 0


def group_points_plain(features: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch grouping gather. features: (B, N, C), idx: (B, m, ns)
    -> (B, m, ns, C)."""
    b, n = features.shape[:2]
    rows = torch.arange(b, device=features.device)[:, None, None]
    return features[rows, idx.long().clamp(0, n - 1)]


def _check_grouping(features: torch.Tensor, idx: torch.Tensor) -> None:
    _build.require(features, torch.float32, "features")
    _build.require(idx, torch.int32, "idx", features.device)
    if features.dim() != 3 or idx.dim() != 3 or idx.shape[0] != features.shape[0]:
        raise ValueError(
            f"features (B, N, C) and idx (B, m, ns) expected, got "
            f"{tuple(features.shape)} and {tuple(idx.shape)}")
    b, n, c = features.shape
    if b < 1 or n < 1 or c < 1 or idx.shape[1] * idx.shape[2] < 1:
        raise ValueError(f"empty gather: table {tuple(features.shape)}, idx {tuple(idx.shape)}")


def _gather_kernel(features: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    b, n, c = features.shape
    m, ns = idx.shape[1:]
    out = torch.empty((b, m, ns, c), dtype=torch.float32, device=features.device)
    fn = _build.kernel("gather", "gather_launch",
                       (_build.VP,) * 3 + (_build.INT,) * 4 + (_build.VP,))
    _build.check(fn(features.data_ptr(), idx.data_ptr(), out.data_ptr(), b, n, m * ns, c,
                    _build.stream(features)), "gather")
    group_points.launches += 1
    return out


class _GroupPoints(torch.autograd.Function):
    """The gather, differentiable in the table only: the custom VJP of the
    JAX ``group_points`` (``ops/ball_query.py:422-438``). It keeps the
    indices and N, never the table."""

    @staticmethod
    def forward(ctx, features, idx):
        ctx.n = features.shape[1]
        ctx.save_for_backward(idx)
        if features.device.type == "cpu":
            return group_points_plain(features, idx)
        return _gather_kernel(features, idx)

    @staticmethod
    def backward(ctx, g):
        if not ctx.needs_input_grad[0]:
            return None, None
        (idx,) = ctx.saved_tensors
        return group_points_backward(g.contiguous(), idx, ctx.n), None


def group_points(features: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """features: (B, N, C) f32, idx: (B, m, ns) int32 -> (B, m, ns, C).
    Differentiable in ``features``: the backward is
    ``group_points_backward``, skipped where the table needs no gradient."""
    if features.device.type != "cpu":
        _check_grouping(features, idx)
    return _GroupPoints.apply(features, idx)


group_points.launches = 0


def _bitcast_table(xyz: torch.Tensor, features: torch.Tensor) -> torch.Tensor:
    """The (B, N, 6 + C) bf16 table [xyz's f32 bits | features]."""
    table = torch.cat([xyz.contiguous().view(torch.bfloat16), features], dim=-1)
    if table.shape[-1] % 2:
        raise ValueError(f"group_points_bitcast: the packed table's width 6 + C = "
                         f"{table.shape[-1]} is odd, so its bf16 lanes do not pair into f32 words")
    return table


def _split_bitcast(out: torch.Tensor):
    return out[..., :6].view(torch.float32), out[..., 6:]


def group_points_bitcast_plain(xyz: torch.Tensor, features: torch.Tensor, idx: torch.Tensor):
    """Plain PyTorch ``group_points_bitcast``: the bf16 gather of the packed
    table by indexing, on any device; no gradient."""
    return _split_bitcast(group_points_plain(_bitcast_table(xyz, features), idx))


class _GroupPointsBitcast(torch.autograd.Function):
    """The bitcast-packed bf16 gather, differentiable in the features only
    (the xyz lanes are bits, not numbers)."""

    @staticmethod
    def forward(ctx, xyz, features, idx):
        ctx.n = features.shape[1]
        ctx.save_for_backward(idx)
        table = _bitcast_table(xyz, features)
        if table.device.type == "cpu":
            out = group_points_plain(table, idx)
        else:
            words = table.view(torch.float32)
            _check_grouping(words, idx)
            out = _gather_kernel(words, idx).view(torch.bfloat16)
        grouped_xyz, grouped_features = _split_bitcast(out)
        ctx.mark_non_differentiable(grouped_xyz)
        return grouped_xyz, grouped_features

    @staticmethod
    def backward(ctx, g_xyz, g):
        if not ctx.needs_input_grad[1] or g is None:
            return None, None, None
        (idx,) = ctx.saved_tensors
        # summed in f32 and rounded once, as ops/scatter.py:62 casts its f32
        # accumulator to the cotangent's dtype
        grad = group_points_backward(g.float().contiguous(), idx, ctx.n)
        return None, grad.to(torch.bfloat16), None


def group_points_bitcast(xyz: torch.Tensor, features: torch.Tensor, idx: torch.Tensor):
    """xyz: (B, N, 3) f32, features: (B, N, C) bf16 with 6 + C even, idx:
    (B, m, ns) int32 -> (grouped xyz (B, m, ns, 3) f32, exact bits; grouped
    features (B, m, ns, C) bf16). One gather of the (B, N, 6 + C) bf16
    table [xyz's bits | features]: on a CUDA tensor ``csrc/gather.cu`` on
    the table viewed as (B, N, (6 + C) / 2) f32 words (131 at C = 256),
    bit for bit the plain bf16 gather by indexing that the CPU runs. The
    gradient reaches the features only: the cotangent of their lanes in
    f32, ``group_points_backward`` over C channels, rounded to bf16 (one
    bf16 ulp from the plain f32 sum, whose order differs). xyz must carry
    no gradient, as in the JAX backbone, where it derives from the input
    cloud alone."""
    if features.dtype != torch.bfloat16:
        raise ValueError(f"group_points_bitcast takes bf16 features, not {features.dtype}")
    if xyz.dtype != torch.float32 or xyz.shape[:2] != features.shape[:2] or xyz.shape[-1] != 3:
        raise ValueError(f"group_points_bitcast takes f32 xyz (B, N, 3) beside the features, "
                         f"got {xyz.dtype} {tuple(xyz.shape)} and {tuple(features.shape)}")
    if xyz.requires_grad:
        raise ValueError("group_points_bitcast: xyz carries its bits, not a gradient: detach it")
    return _GroupPointsBitcast.apply(xyz, features, idx)


def group_points_backward_plain(g: torch.Tensor, idx: torch.Tensor, n: int) -> torch.Tensor:
    """Plain PyTorch backward of the gather: g (B, m, ns, C), idx (B, m, ns)
    -> (B, N, C), the rows of g summed into the rows their clamped indices
    name, in g's dtype (``ops/scatter.py::batched_onehot_segment_sum``)."""
    b, c = g.shape[0], g.shape[-1]
    rows = idx.long().clamp(0, n - 1) + n * torch.arange(b, device=g.device)[:, None, None]
    out = torch.zeros((b * n, c), dtype=g.dtype, device=g.device)
    out.index_add_(0, rows.reshape(-1), g.reshape(-1, c))
    return out.reshape(b, n, c)


GBWD_RUN_WARPS = 8  # runs a block of the sum kernel sums: csrc/gather_bwd.cu kSumWarps
GBWD_CHUNKS = 3  # 32-channel chunks a sum warp holds: kChunks
GBWD_BLOCKS_PER_SM = 3  # sum blocks the plan gives every SM
GBWD_LIST_ROWS = 8192  # rows a list block may own: kListRows


def gather_bwd_splits(c: int) -> int:
    """Sum warps a run of rows takes: one a group of GBWD_CHUNKS 32-channel
    chunks (2 at C = 131, 3 at C = 259)."""
    chunks = -(-c // 32)
    return -(-chunks // GBWD_CHUNKS)


class GatherBwdLaunch(NamedTuple):
    """The two kernels of csrc/gather_bwd.cu. The list kernel runs ``lists``
    blocks a scene, each owning a range of at most GBWD_LIST_ROWS table
    rows. The sum kernel runs ``parts`` blocks a scene for each group of
    channels, each of GBWD_RUN_WARPS warps; each warp sums one of the
    scene's GBWD_RUN_WARPS x parts runs of whole table rows, cut from its
    slots sorted by row so that each run holds about as many slots."""
    parts: int
    lists: int = 1

    @property
    def runs(self) -> int:
        return GBWD_RUN_WARPS * self.parts

    def blocks(self, b: int, c: int) -> int:
        """The sum kernel's blocks."""
        return b * self.parts * gather_bwd_splits(c)

    def scratch_ints(self, b: int, u: int) -> int:
        """The sorted slots and their rows, and each run's first row and
        first sorted slot, with an end for each."""
        return 2 * b * u + 2 * b * (self.runs + 1)


def gather_bwd_plan(b: int, u: int, n: int, c: int, n_sm: int) -> GatherBwdLaunch:
    """The launch of the gather's backward for B scenes of U slots into N
    rows of C channels. Sum kernel: GBWD_BLOCKS_PER_SM blocks an SM (within
    a few percent of the best of chip_smoke.py's sweep at each of the
    step's shapes on an H100, PERF.md), never more runs than slots. List
    kernel: as many blocks a scene as give every scene's blocks an SM of
    their own (one block of 1,024 threads fills one), or more where a scene
    has more than GBWD_LIST_ROWS rows a block; never more blocks than
    rows."""
    parts = -(-GBWD_BLOCKS_PER_SM * n_sm // (b * gather_bwd_splits(c)))
    lists = max(-(-n // GBWD_LIST_ROWS), min(n, n_sm // b))
    return GatherBwdLaunch(max(1, min(parts, u // GBWD_RUN_WARPS)), lists)


def group_points_backward(g: torch.Tensor, idx: torch.Tensor, n: int,
                          launch: Optional[GatherBwdLaunch] = None) -> torch.Tensor:
    """g: (B, m, ns, C) f32 cotangent of ``group_points``, idx: (B, m, ns)
    int32 -> (B, N, C) f32 gradient of the table. On a CUDA tensor it
    launches ``csrc/gather_bwd.cu``: a counting sort of each scene's slots
    by row, then a warp for each run of whole rows (``gather_bwd_plan``, or
    ``launch``) that sums their cotangent rows and writes each row once. The
    sort's order within a row, and so the last bits of the sums, change from
    run to run."""
    if g.device.type == "cpu":
        return group_points_backward_plain(g, idx, n)
    _build.require(g, torch.float32, "g")
    _build.require(idx, torch.int32, "idx", g.device)
    if g.dim() != 4 or idx.shape != g.shape[:3] or n < 1 or g.numel() == 0:
        raise ValueError(f"non-empty g (B, m, ns, C) and idx (B, m, ns) expected with N >= 1, "
                         f"got {tuple(g.shape)}, {tuple(idx.shape)} and N = {n}")
    b, m, ns, c = g.shape
    u = m * ns
    if launch is None:
        launch = gather_bwd_plan(b, u, n, c,
                                 torch.cuda.get_device_properties(g.device).multi_processor_count)
    if launch.parts < 1 or not -(-n // GBWD_LIST_ROWS) <= launch.lists <= n:
        raise ValueError(f"csrc/gather_bwd.cu has no launch {launch} for N = {n}")
    out = torch.empty((b, n, c), dtype=torch.float32, device=g.device)
    scratch = torch.empty(launch.scratch_ints(b, u), dtype=torch.int32, device=g.device)
    fn = _build.kernel("gather_bwd", "gather_bwd_launch",
                       (_build.VP,) * 4 + (_build.INT,) * 6 + (_build.VP,))
    _build.check(fn(g.data_ptr(), idx.data_ptr(), out.data_ptr(), scratch.data_ptr(), b, n, u, c,
                    launch.parts, launch.lists, _build.stream(g)), "gather_bwd")
    group_points_backward.launches += 1
    return out


group_points_backward.launches = 0
