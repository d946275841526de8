"""PointNet++ set-abstraction and feature-propagation modules.

Counterpart of ``iou3dmatch_tpu/models/pointnet2.py`` (reference
``pointnet2/pointnet2_modules.py`` and ``pointnet2_utils.py``). Channels-last
throughout: a grouped neighbourhood is (B, npoint, nsample, C), the shared
MLP works on the last axis and the pool runs over nsample.

- ``PointnetSAModuleVotes``: single-scale set abstraction with max, avg or
  rbf pooling, optional uniform resampling of the ball (the backbone's SA
  layers and vote aggregation use max pooling on normalised xyz).
- ``PointnetFPModule``: 3-NN inverse-distance feature propagation.
- ``QueryAndGroup`` and ``GroupAll``: the groupers on their own.
- ``PointnetSAModuleMSG``, the ``PointnetSAModule`` factory and
  ``PointnetSAModuleMSGVotes``: one FPS, several (radius, nsample, mlp)
  scales, features concatenated across scales.
- ``PointnetLFPModuleMSG``: learnable multi-scale feature propagation.

Where xyz and features are both grouped, one gather of the packed table
[xyz | features] stands for the JAX modules' two; a gather copies rows, so
the result is the same.

``dtype=torch.bfloat16`` (JAX's ``dtype``) runs the shared MLPs in bf16
(``models/mlp.py``). With it, ``bitcast_gather`` (the backbone's SA3 and
SA4) gathers one bf16 table, the f32 xyz bitcast into 6 bf16 lanes beside
the features cast to bf16 (``ops/ball_query.py::group_points_bitcast``):
half the bytes of the f32 table, and the same MLP input, since the MLP
would cast the features to bf16 anyway. Only for SA layers whose xyz
carries no gradient.

Random draws come from an explicit ``torch.Generator`` on the tensors'
device: ``uniform_resample_idx`` splits into a deterministic core that takes
the uniform draws and a wrapper that draws them.
"""
from typing import Optional, Sequence, Union

import torch
import torch.nn.functional as F
from torch import nn

from ..ops import (ball_query, furthest_point_sample, gather_points,
                   group_points, three_interpolate, three_nn)
from .mlp import BatchNorm, PointwiseConv, SharedMLP

POOLINGS = ("max", "avg", "rbf")


def uniform_resample_from(idx: torch.Tensor, u: torch.Tensor):
    """Deduplicates ball-query indices and refills the rest from ``u``
    (JAX ``uniform_resample_idx``, reference ``pointnet2_utils.py:337-347``):
    each region's first occurrences move to the front in their order, and
    slot j >= unique_cnt takes ``floor(u[..., j] * unique_cnt)`` (at most
    unique_cnt - 1) of them. idx (B, m, ns) int32, u (B, m, ns) float32 in
    [0, 1) -> (new idx int32, unique_cnt float32 (B, m))."""
    ns = idx.shape[-1]
    earlier = torch.ones(ns, ns, dtype=torch.bool, device=idx.device).tril(-1)
    is_dup = ((idx[..., :, None] == idx[..., None, :]) & earlier).any(-1)  # (B, m, ns)
    unique_cnt = (~is_dup).sum(-1, dtype=torch.int32)
    order = torch.argsort(is_dup.to(torch.int32), dim=-1, stable=True)
    compacted = torch.gather(idx, -1, order)
    cnt = unique_cnt[..., None]
    draw = torch.floor(u * cnt.to(torch.float32)).to(torch.int32)
    draw = torch.minimum(draw, cnt - 1)
    slot = torch.arange(ns, dtype=torch.int32, device=idx.device)
    pos = torch.where(slot < cnt, slot, draw)
    return torch.gather(compacted, -1, pos.long()), unique_cnt.to(torch.float32)


def uniform_resample_idx(idx: torch.Tensor, generator: torch.Generator):
    """``uniform_resample_from`` on uniform draws taken from ``generator``,
    which lives on ``idx``'s device."""
    if generator is None:
        raise ValueError("sample_uniformly draws from an explicit generator: pass generator=")
    u = torch.rand(idx.shape, generator=generator, device=idx.device)
    return uniform_resample_from(idx, u)


def _group(xyz: torch.Tensor, features: Optional[torch.Tensor], centers: torch.Tensor,
           idx: torch.Tensor, bitcast: bool = False):
    """(xyz relative to the centers, features or None), both (B, m, ns, .),
    through one gather of the packed table where there are features; with
    ``bitcast``, of the bf16 table, whose features come back in bf16."""
    if features is None:
        return group_points(xyz, idx) - centers[:, :, None, :], None
    grouped = group_points(torch.cat([xyz, features], dim=-1), idx)
    return grouped[..., :3] - centers[:, :, None, :], grouped[..., 3:]


def _join(grouped_xyz: torch.Tensor, grouped_features: Optional[torch.Tensor],
          use_xyz: bool) -> torch.Tensor:
    """xyz channels first (pointnet2_utils.py:364-369); xyz alone without
    features."""
    if grouped_features is None:
        return grouped_xyz
    if use_xyz:
        return torch.cat([grouped_xyz, grouped_features], dim=-1)
    return grouped_features


def _mlp_channels(mlp: Sequence[int], use_xyz: bool) -> list:
    channels = list(mlp)
    if use_xyz:
        channels[0] += 3  # relative xyz rides in front of the features
    return channels


def _sample_centers(xyz: torch.Tensor, npoint: int,
                    inds: Union[None, str, torch.Tensor]):
    """(new_xyz, inds): FPS when ``inds`` is None; "prefix" when ``xyz`` is
    FPS-ordered, so FPS would pick its first npoint points in order (see
    the JAX module); else the given (B, npoint) indices."""
    if isinstance(inds, str):
        if inds != "prefix":
            raise ValueError(f"unknown inds sentinel {inds!r}")
        b = xyz.shape[0]
        inds = torch.arange(npoint, dtype=torch.int32, device=xyz.device).expand(b, -1)
        return xyz[:, :npoint].contiguous(), inds
    if inds is None:
        inds = furthest_point_sample(xyz, npoint)
    return gather_points(xyz, inds), inds


class PointnetSAModuleVotes(nn.Module):
    """FPS (or given indices) -> gather centers -> ball query (optionally
    resampled uniformly) -> [relative xyz | features] -> shared MLP -> max,
    avg or rbf pool (reference ``pointnet2_modules.py:169-277``).

    ``normalize_xyz`` divides the relative xyz by the radius; ``sigma``
    (rbf) defaults to radius / 2. ``sample_uniformly`` needs a
    ``generator`` at the call; ``ret_unique_cnt`` (which needs it) also
    returns the unique count of each ball. ``dtype`` is the shared MLP's
    compute dtype; ``bitcast_gather`` takes the bf16 packed gather where
    ``dtype`` is bf16 and there are features."""

    def __init__(self, *, mlp, npoint: int, radius: float, nsample: int,
                 generator: torch.Generator, use_xyz: bool = True, normalize_xyz: bool = True,
                 pooling: str = "max", sigma: Optional[float] = None,
                 sample_uniformly: bool = False, ret_unique_cnt: bool = False,
                 dtype=None, bitcast_gather: bool = False):
        super().__init__()
        if pooling not in POOLINGS:
            raise ValueError(f"pooling is one of {POOLINGS}, not {pooling!r}")
        if ret_unique_cnt and not sample_uniformly:
            raise ValueError("ret_unique_cnt needs sample_uniformly (pointnet2_utils.py:315-316)")
        self.npoint, self.radius, self.nsample = npoint, radius, nsample
        self.use_xyz, self.normalize_xyz, self.pooling = use_xyz, normalize_xyz, pooling
        self.sigma = radius / 2 if sigma is None else sigma
        self.sample_uniformly, self.ret_unique_cnt = sample_uniformly, ret_unique_cnt
        self.bitcast = bitcast_gather and dtype == torch.bfloat16
        self.mlp_module = SharedMLP(_mlp_channels(mlp, use_xyz), generator, dtype=dtype)

    def forward(self, xyz: torch.Tensor, features: Optional[torch.Tensor],
                inds: Union[None, str, torch.Tensor] = None,
                generator: Optional[torch.Generator] = None):
        """xyz: (B, N, 3) contiguous; features: (B, N, C) or None; inds:
        None (run FPS), "prefix" or (B, npoint) indices; ``generator`` for
        ``sample_uniformly``. Returns (new_xyz, pooled features, inds[,
        unique_cnt])."""
        new_xyz, inds = _sample_centers(xyz, self.npoint, inds)
        idx = ball_query(self.radius, self.nsample, xyz, new_xyz)
        unique_cnt = None
        if self.sample_uniformly:
            idx, unique_cnt = uniform_resample_idx(idx, generator)
        grouped_xyz, grouped_features = _group(xyz, features, new_xyz, idx, self.bitcast)
        if self.normalize_xyz:
            grouped_xyz = grouped_xyz / self.radius
        h = self.mlp_module(_join(grouped_xyz, grouped_features, self.use_xyz))
        if self.pooling == "max":
            pooled = h.amax(dim=2)
        elif self.pooling == "avg":
            pooled = h.mean(dim=2)
        else:
            # exp(-|gxyz|^2 / sigma^2 / 2) weighted sum / nsample, on the
            # grouper's relative coordinates (pointnet2_modules.py:267-271)
            rbf = torch.exp(-(grouped_xyz * grouped_xyz).sum(-1) / (self.sigma ** 2) / 2)
            pooled = (h * rbf[..., None]).sum(dim=2) / float(self.nsample)
        if self.ret_unique_cnt:
            return new_xyz, pooled, inds, unique_cnt
        return new_xyz, pooled, inds


class PointnetFPModule(nn.Module):
    """Feature propagation: 3-NN inverse-distance interpolation, concat
    [interpolated, skip], shared MLP (in ``dtype``; the interpolation in
    f32). The interpolation writes the concatenation itself
    (``three_interpolate(..., skip=)``), so the card runs no concat kernel
    and its backward no copy."""

    def __init__(self, mlp, generator: torch.Generator, dtype=None):
        super().__init__()
        self.mlp = SharedMLP(list(mlp), generator, dtype=dtype)

    def forward(self, unknown, known, unknown_feats, known_feats):
        dist, idx = three_nn(unknown, known)
        dist_recip = 1.0 / (dist + 1e-8)
        weight = dist_recip / dist_recip.sum(dim=2, keepdim=True)
        return self.mlp(three_interpolate(known_feats, idx, weight, unknown_feats))


