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
  (B, N, C) x (B, m, ns) -> (B, m, ns, C), indices clamped to [0, N-1]. On a
  CUDA tensor it launches ``csrc/gather.cu``, which has no backward yet.

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


def group_points(features: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """features: (B, N, C) f32, idx: (B, m, ns) int32 -> (B, m, ns, C)."""
    if features.device.type == "cpu":
        return group_points_plain(features, idx)
    _build.require(features, torch.float32, "features")
    _build.require(idx, torch.int32, "idx", features.device)
    if features.requires_grad:
        raise NotImplementedError(
            "group_points has no CUDA backward yet; it comes with the training slice")
    if features.dim() != 3 or idx.dim() != 3 or idx.shape[0] != features.shape[0]:
        raise ValueError(
            f"features (B, N, C) and idx (B, m, ns) expected, got "
            f"{tuple(features.shape)} and {tuple(idx.shape)}")
    b, n, c = features.shape
    m, ns = idx.shape[1:]
    if b < 1 or n < 1 or c < 1 or m * ns < 1:
        raise ValueError(f"empty gather: table {tuple(features.shape)}, idx {tuple(idx.shape)}")
    out = torch.empty((b, m, ns, c), dtype=torch.float32, device=features.device)
    fn = _build.kernel("gather", "gather_launch",
                       (_build.VP,) * 3 + (_build.INT,) * 4 + (_build.VP,))
    _build.check(fn(features.data_ptr(), idx.data_ptr(), out.data_ptr(), b, n, m * ns, c,
                    _build.stream(features)), "gather")
    group_points.launches += 1
    return out


group_points.launches = 0
