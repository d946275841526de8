"""The port's point-cloud primitives in their plain PyTorch form: the
reference runs these where the port launches its CUDA kernels."""
from typing import Optional

import numpy as np
import torch

from ..geometry.nms import lhs_3d_samecls_plain as lhs_3d_samecls  # noqa: F401
from ..geometry.nms import nms_boxes_plain as nms_boxes  # noqa: F401
from .sampling import gather_points  # noqa: F401

_MAG_EPS = 1e-3


def furthest_point_sample(xyz: torch.Tensor, npoint: int) -> torch.Tensor:
    """FPS. xyz: (B, N, 3) -> (B, npoint) int32: the first index is 0; points
    with |p|^2 <= 1e-3 are never chosen; each step takes the argmax of the
    running min of squared distances, the lowest index on ties."""
    xyz = xyz.float()
    b = xyz.shape[0]
    x, y, z = xyz.unbind(-1)
    valid = (x * x + y * y + z * z) > _MAG_EPS
    mind = torch.full_like(x, 1e10).masked_fill(~valid, -1.0)
    idx = torch.zeros((b, npoint), dtype=torch.int32, device=xyz.device)
    rows = torch.arange(b, device=xyz.device)
    old = torch.zeros(b, dtype=torch.long, device=xyz.device)
    for j in range(1, npoint):
        p = xyz[rows, old]
        dx = x - p[:, 0:1]
        dy = y - p[:, 1:2]
        dz = z - p[:, 2:3]
        mind = torch.minimum(mind, dx * dx + dy * dy + dz * dz)
        old = torch.argmax(mind, dim=1)
        idx[:, j] = old.to(torch.int32)
    return idx


def ball_query(radius: float, nsample: int, xyz: torch.Tensor,
               new_xyz: torch.Tensor) -> torch.Tensor:
    """xyz (B, N, 3), new_xyz (B, m, 3) -> (B, m, nsample) int32: the first
    nsample points in index order strictly within ``radius``, misses filled
    with the first hit (0 where none)."""
    r2 = float(np.float32(radius) * np.float32(radius))
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
        best = torch.where(hit, order, n).topk(k, dim=1, largest=False).values
        if k < nsample:
            best = torch.cat([best, best.new_full((m, nsample - k), n)], dim=1)
        found = best < n
        first = torch.where(found[:, :1], best[:, :1], 0)
        out[i] = torch.where(found, best, first)
    return out


def group_points(features: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """features (B, N, C), idx (B, m, ns) -> (B, m, ns, C); autograd's
    indexing backward sums the rows."""
    b, n = features.shape[:2]
    rows = torch.arange(b, device=features.device)[:, None, None]
    return features[rows, idx.long().clamp(0, n - 1)]


def _sq_dist(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    dx = a[..., 0] - b[..., 0]
    dy = a[..., 1] - b[..., 1]
    dz = a[..., 2] - b[..., 2]
    return dx * dx + dy * dy + dz * dz


def three_nn(unknown: torch.Tensor, known: torch.Tensor):
    """unknown (B, n, 3), known (B, m, 3) -> (dist, idx), each (B, n, 3): the
    three nearest known points, the lowest index on ties. No gradient."""
    unknown, known = unknown.detach().float(), known.detach().float()
    d2 = _sq_dist(unknown[:, :, None, :], known[:, None, :, :])
    idxs = []
    for _ in range(3):
        i = torch.argmin(d2, dim=2)
        idxs.append(i)
        d2 = d2.scatter(2, i[..., None], float("inf"))
    idx = torch.stack(idxs, dim=-1)
    rows = torch.arange(known.shape[0], device=known.device)[:, None, None]
    dist = torch.sqrt(_sq_dist(unknown[:, :, None, :], known[rows, idx]))
    return dist, idx.to(torch.int32)


def three_interpolate(features: torch.Tensor, idx: torch.Tensor, weight: torch.Tensor,
                      skip: Optional[torch.Tensor] = None) -> torch.Tensor:
    """features (B, m, C), idx and weight (B, n, 3) -> (B, n, C), the weighted
    sum of the three rows; with ``skip`` (B, n, Cs), [that | skip].
    Differentiable in ``features`` and ``skip``, not in the weights."""
    b, m = features.shape[:2]
    rows = torch.arange(b, device=features.device)[:, None, None]
    g = features[rows, idx.long().clamp(0, m - 1)]
    out = (g * weight.detach()[..., None]).sum(dim=2)
    return out if skip is None else torch.cat([out, skip], dim=-1)
