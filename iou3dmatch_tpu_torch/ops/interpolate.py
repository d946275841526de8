"""Three-nearest-neighbour search and inverse-distance interpolation.

Counterpart of ``iou3dmatch_tpu/ops/interpolate.py`` (reference
``interpolate_gpu.cu:14-160``).

- ``three_nn``: sqrt distances and int32 indices of the 3 nearest known
  points, the lowest index winning on ties. It launches ``csrc/three_nn.cu``
  on CUDA tensors and runs its plain PyTorch version, ``three_nn_plain``
  (three masked argmin passes, each returning the first minimum), on CPU
  tensors. No gradient. The kernel splits each query's seeds over S lanes
  of a warp and gives each thread Q queries; ``three_nn_plan`` picks
  (S, Q) from the shape and the card's SM count.
- ``three_interpolate``: a gather and a weighted sum over the 3 neighbours,
  in plain PyTorch on every device.
"""
from typing import NamedTuple, Optional

import torch

from . import _build


def _sq_dist(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """(..., 3) x (..., 3) -> (...) squared distance, written out term by
    term so each product is rounded on its own."""
    dx = a[..., 0] - b[..., 0]
    dy = a[..., 1] - b[..., 1]
    dz = a[..., 2] - b[..., 2]
    return dx * dx + dy * dy + dz * dz


def three_nn_plain(unknown: torch.Tensor, known: torch.Tensor):
    """unknown: (B, n, 3), known: (B, m, 3) ->
    (dist (B, n, 3) f32, idx (B, n, 3) int32)."""
    unknown, known = unknown.float(), known.float()
    d2 = _sq_dist(unknown[:, :, None, :], known[:, None, :, :])  # (B, n, m)
    idxs = []
    for _ in range(3):
        i = torch.argmin(d2, dim=2)
        idxs.append(i)
        d2 = d2.scatter(2, i[..., None], float("inf"))
    idx = torch.stack(idxs, dim=-1)  # (B, n, 3)
    rows = torch.arange(known.shape[0], device=known.device)[:, None, None]
    dist = torch.sqrt(_sq_dist(unknown[:, :, None, :], known[rows, idx]))
    return dist, idx.to(torch.int32)


# The instantiations of csrc/three_nn.cu (its NN_CASEs): S lanes a query, Q
# queries a thread.
NN_LANES = (1, 2, 4, 8, 16, 32)
NN_QUERIES = (1, 2, 4)
NN_LAUNCHES = tuple((s, q) for s in NN_LANES for q in NN_QUERIES)
NN_THREADS = 256  # a block's threads: csrc/three_nn.cu kThreads
# warps the plan gives every SM where the shape has them: two blocks, less a
# warp, so that 256 blocks on 132 SMs count (chip_smoke.py --nn-sweep, PERF.md)
NN_WARPS_PER_SM = 15


class NnLaunch(NamedTuple):
    """Blocks of NN_THREADS threads; each query's seeds split over ``lanes``
    lanes of a warp (lane l scans the 4-seed groups g with g % lanes == l),
    ``queries`` queries a thread."""
    lanes: int
    queries: int

    @property
    def rows(self) -> int:
        """Queries a block holds."""
        return NN_THREADS // self.lanes * self.queries

    def blocks(self, b: int, n: int) -> int:
        return b * -(-n // self.rows)

    def warps(self, b: int, n: int) -> int:
        return self.blocks(b, n) * NN_THREADS // 32


def three_nn_plan(b: int, n: int, m: int, n_sm: int) -> NnLaunch:
    """The launch for B scenes of n queries among m seeds: the smallest S,
    and for it the largest Q, whose blocks give every SM NN_WARPS_PER_SM
    warps, S at most one lane a 4-seed group (m // 4); where none does, the
    largest such S with Q = 1. A larger S splits each query's scan and adds
    a merge; a larger Q lets one shared load serve more distance tests;
    either way fewer warps are left to hide latency."""
    lanes = [s for s in NN_LANES if s <= max(1, m // 4)]
    for s in lanes:
        for q in reversed(NN_QUERIES):
            launch = NnLaunch(s, q)
            if launch.warps(b, n) >= NN_WARPS_PER_SM * n_sm:
                return launch
    return NnLaunch(lanes[-1], 1)


def three_nn(unknown: torch.Tensor, known: torch.Tensor, launch: Optional[NnLaunch] = None):
    """unknown: (B, n, 3), known: (B, m, 3) with m >= 1 ->
    (dist (B, n, 3) f32, idx (B, n, 3) int32), equal to ``three_nn_plain``.

    Neither output carries a gradient, on either route, as the reference's
    ``ThreeNN``: GridConv keeps only ``idx`` and computes the distances again
    in autograd, and FP's xyz needs none. On CUDA tensors (contiguous f32,
    one device) it launches the kernel on the current stream with
    ``three_nn_plan``'s launch, or ``launch`` (for sweeps and tests), and
    counts the launch in ``three_nn.launches``."""
    if unknown.dim() != 3 or unknown.shape[2] != 3 or known.dim() != 3 or known.shape[2] != 3 \
            or known.shape[0] != unknown.shape[0]:
        raise ValueError(f"unknown (B, n, 3) and known (B, m, 3) expected, got "
                         f"{tuple(unknown.shape)} and {tuple(known.shape)}")
    if known.shape[1] < 1:
        raise ValueError("three_nn needs at least one known point a scene")
    if unknown.device.type == "cpu":
        return three_nn_plain(unknown.detach(), known.detach())
    _build.require(unknown, torch.float32, "unknown")
    _build.require(known, torch.float32, "known", unknown.device)
    b, n, m = unknown.shape[0], unknown.shape[1], known.shape[1]
    dist = torch.empty((b, n, 3), dtype=torch.float32, device=unknown.device)
    idx = torch.empty((b, n, 3), dtype=torch.int32, device=unknown.device)
    if dist.numel() == 0:
        return dist, idx
    if launch is None:
        n_sm = torch.cuda.get_device_properties(unknown.device).multi_processor_count
        launch = three_nn_plan(b, n, m, n_sm)
    if tuple(launch) not in NN_LAUNCHES:
        raise ValueError(f"csrc/three_nn.cu has no launch {launch}")
    fn = _build.kernel("three_nn", "three_nn_launch", (_build.VP,) * 4 + (_build.INT,) * 5
                       + (_build.VP,))
    _build.check(fn(unknown.data_ptr(), known.data_ptr(), dist.data_ptr(), idx.data_ptr(), b, n, m,
                    *launch, _build.stream(unknown)), "three_nn")
    three_nn.launches += 1
    return dist, idx


three_nn.launches = 0


def three_interpolate(features: torch.Tensor, idx: torch.Tensor,
                      weight: torch.Tensor) -> torch.Tensor:
    """features: (B, m, C), idx: (B, n, 3), weight: (B, n, 3) -> (B, n, C)."""
    b, m = features.shape[:2]
    rows = torch.arange(b, device=features.device)[:, None, None]
    g = features[rows, idx.long().clamp(0, m - 1)]  # (B, n, 3, C)
    return (g * weight[..., None]).sum(dim=2)
