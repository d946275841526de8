"""Furthest point sampling (FPS).

Counterpart of ``iou3dmatch_tpu/ops/fps.py`` and its Pallas kernel
``fps_pallas.py``. Semantics of the reference CUDA kernel
(``pointnet2/_ext_src/src/sampling_gpu.cu:75-178``): the first index is 0;
points with |p|^2 <= 1e-3 are never chosen; each step updates a running min
of squared distances to the chosen set and takes its argmax, the lowest
index winning on equal values. int32 output, no gradient.

``furthest_point_sample`` launches ``csrc/fps.cu`` on a CUDA tensor and
takes the plain version only for a CPU tensor. The kernel runs one
thread-block cluster of S blocks per scene; ``fps_launch_plan`` picks S and
the variant that holds a block's share of the points (registers, shared
memory, or streamed from global memory) from the shape, the card's SM count
and its ``cudaOccupancyMaxActiveClusters`` answers.
"""
import ctypes
from typing import Dict, NamedTuple, Optional, Tuple

import torch

from . import _build

_MAG_EPS = 1e-3

MAX_CLUSTER = 16  # the largest cluster an H100 launches (non-portable size)
MIN_SHARE = 1024  # a scene is not split into shares smaller than this
# With the share in registers, clusters of 8 beat clusters of 16 in PERF.md's
# sweep: the exchange costs more than the shorter pass saves.
FAST_CLUSTER = 8
# Points a thread keeps in registers, per block size: the instantiations of
# csrc/fps.cu. The rule plans 128 or 256 threads (40 points a thread, 188
# registers, no spills); 512 and 1,024 threads hold only what PERF.md's
# cluster x block-size sweep runs at the serving shape.
PLAN_THREADS = (128, 256)
REG_PPTS = {128: (2, 5, 10, 20, 40), 256: (2, 5, 10, 20, 40), 512: (5, 10), 1024: (3, 5)}
SHARED_MAX_POINTS = 14336  # 224 KiB of (x, y, z, min distance) a block
STREAM_THREADS = 1024  # block size of the shared-memory and streaming variants
SHARED, GLOBAL = 0, -1  # ppt values of those two variants


def furthest_point_sample_plain(xyz: torch.Tensor, npoint: int) -> torch.Tensor:
    """Plain PyTorch FPS. xyz: (B, N, 3) -> (B, npoint) int32.

    Distances are written out term by term, left to right, so each product
    is rounded on its own, as in the kernel."""
    xyz = xyz.float()
    b = xyz.shape[0]
    x, y, z = xyz.unbind(-1)
    valid = (x * x + y * y + z * z) > _MAG_EPS
    # invalid points hold -1: every distance (>= 0) keeps them out of the argmax
    mind = torch.full_like(x, 1e10).masked_fill(~valid, -1.0)
    idx = torch.zeros((b, npoint), dtype=torch.int32, device=xyz.device)
    rows = torch.arange(b, device=xyz.device)
    old = torch.zeros(b, dtype=torch.long, device=xyz.device)
    for j in range(1, npoint):
        p = xyz[rows, old]  # (B, 3)
        dx = x - p[:, 0:1]
        dy = y - p[:, 1:2]
        dz = z - p[:, 2:3]
        mind = torch.minimum(mind, dx * dx + dy * dy + dz * dz)
        old = torch.argmax(mind, dim=1)  # first occurrence on ties
        idx[:, j] = old.to(torch.int32)
    return idx


class FpsLaunch(NamedTuple):
    """One cluster of ``cluster`` blocks of ``threads`` threads per scene,
    each block owning ``share`` consecutive points. ``ppt`` > 0 keeps a
    thread's points in registers, ``SHARED`` the share in shared memory,
    ``GLOBAL`` streams it from global memory."""
    cluster: int
    threads: int
    ppt: int
    share: int

    @property
    def variant(self) -> str:
        return "registers" if self.ppt > 0 else ("shared" if self.ppt == SHARED else "global")


def fps_variant(n: int, cluster: int, threads: Optional[int] = None) -> FpsLaunch:
    """The variant that holds a share of ceil(n / cluster) points: registers
    at ``threads`` threads or, by default, at the fewest of PLAN_THREADS
    that hold it (in PERF.md's sweep fewer warps, with the same points on
    chip, always made the step shorter); else shared memory; else the
    streaming one."""
    share = -(-n // cluster)
    for t in (threads,) if threads else PLAN_THREADS:
        need = -(-share // t)
        if need <= REG_PPTS[t][-1]:
            return FpsLaunch(cluster, t, min(p for p in REG_PPTS[t] if p >= need), share)
    if share <= SHARED_MAX_POINTS:
        return FpsLaunch(cluster, STREAM_THREADS, SHARED, share)
    return FpsLaunch(cluster, STREAM_THREADS, GLOBAL, share)


def fps_candidates(n: int) -> Tuple[FpsLaunch, ...]:
    """One launch for each cluster size worth asking the card about: powers
    of two up to MAX_CLUSTER that leave shares of at least MIN_SHARE points."""
    top = max(1, min(MAX_CLUSTER, n // MIN_SHARE))
    return tuple(fps_variant(n, 1 << k) for k in range(top.bit_length()))


def fps_preference(launch: FpsLaunch) -> tuple:
    """Larger is better: the share in registers, then in shared memory,
    then streamed; among register launches S <= FAST_CLUSTER first; then
    the larger S, whose shorter share shortens each step."""
    rank = {"registers": 2, "shared": 1, "global": 0}[launch.variant]
    return rank, launch.variant != "registers" or launch.cluster <= FAST_CLUSTER, launch.cluster


def fps_launch_plan(b: int, n: int, n_sm: int, max_active: Dict[int, int]) -> FpsLaunch:
    """The launch for B scenes of N points: the preferred candidate among
    those whose B clusters run in one wave, one block to an SM
    (B * S <= n_sm) and all resident at once (``max_active[S]``, the
    cudaOccupancyMaxActiveClusters answer for that candidate). S = 1 is
    always allowed: the scenes then run in waves."""
    fits = [c for c in fps_candidates(n)
            if c.cluster == 1 or (b * c.cluster <= n_sm and max_active.get(c.cluster, 0) >= b)]
    return max(fits, key=fps_preference)


_plans = {}


def max_active_clusters(launch: FpsLaunch, device: torch.device) -> int:
    """cudaOccupancyMaxActiveClusters for ``launch`` on ``device``."""
    fn = _build.kernel("fps", "fps_max_active_clusters",
                       (_build.INT,) * 4 + (ctypes.POINTER(ctypes.c_int),))
    count = ctypes.c_int(0)
    with torch.cuda.device(device):
        _build.check(fn(launch.cluster, launch.threads, launch.ppt, launch.share,
                        ctypes.byref(count)), "fps occupancy query")
    return count.value


def fps_plan(device: torch.device, b: int, n: int) -> Tuple[FpsLaunch, Dict[int, int]]:
    """The launch the wrapper takes for (B, N) on ``device``, with the
    card's answers it was chosen from; cached per device and shape."""
    key = (device, b, n)
    if key not in _plans:
        answers = {c.cluster: max_active_clusters(c, device) for c in fps_candidates(n)}
        n_sm = torch.cuda.get_device_properties(device).multi_processor_count
        _plans[key] = fps_launch_plan(b, n, n_sm, answers), answers
    return _plans[key]


def furthest_point_sample(xyz: torch.Tensor, npoint: int,
                          launch: Optional[FpsLaunch] = None) -> torch.Tensor:
    """Batched FPS. xyz: (B, N, 3) f32 -> (B, npoint) int32. ``launch``
    overrides the planned launch shape (for sweeps and tests)."""
    if xyz.device.type == "cpu":
        return furthest_point_sample_plain(xyz, npoint)
    _build.require(xyz, torch.float32, "xyz")
    if xyz.dim() != 3 or xyz.shape[2] != 3:
        raise ValueError(f"xyz must be (B, N, 3), got {tuple(xyz.shape)}")
    b, n, _ = xyz.shape
    if b < 1 or n < 1 or npoint < 1:
        raise ValueError(f"empty FPS: B={b}, N={n}, npoint={npoint}")
    if launch is None:
        launch = fps_plan(xyz.device, b, n)[0]
    if launch.share < 1 or launch.cluster * launch.share < n:
        raise ValueError(f"{launch} does not cover N={n} points")
    out = torch.empty((b, npoint), dtype=torch.int32, device=xyz.device)
    mind = torch.empty((b, n) if launch.ppt == GLOBAL else (0,), dtype=torch.float32,
                       device=xyz.device)
    fn = _build.kernel("fps", "fps_launch", (_build.VP,) * 3 + (_build.INT,) * 7 + (_build.VP,))
    _build.check(fn(xyz.data_ptr(), mind.data_ptr(), out.data_ptr(), b, n, npoint,
                    launch.cluster, launch.threads, launch.ppt, launch.share,
                    _build.stream(xyz)), "fps")
    furthest_point_sample.launches += 1
    return out


furthest_point_sample.launches = 0
