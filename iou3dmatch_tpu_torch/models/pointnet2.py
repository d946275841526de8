"""PointNet++ set-abstraction and feature-propagation modules.

Counterpart of ``iou3dmatch_tpu/models/pointnet2.py`` (reference
``pointnet2/pointnet2_modules.py``: PointnetSAModuleVotes ``:169-277``,
PointnetFPModule ``:362-422``). Channels-last throughout: a grouped
neighbourhood is (B, npoint, nsample, C), the shared MLP works on the last
axis and the pool is a max over nsample.

The SA module here is the single-scale one with max pooling, relative xyz
normalised by the radius and xyz channels first; MSG, LFP, QueryAndGroup,
uniform resampling and rbf/avg pooling come with later slices.
"""
from typing import Optional, Union

import torch
from torch import nn

from ..ops import (ball_query, furthest_point_sample, gather_points,
                   group_points, three_interpolate, three_nn)
from .mlp import SharedMLP


class PointnetSAModuleVotes(nn.Module):
    """FPS (or given indices) -> gather centers -> ball query -> one packed
    [xyz | features] gather -> shared MLP -> max pool."""

    def __init__(self, *, mlp, npoint: int, radius: float, nsample: int,
                 generator: torch.Generator):
        super().__init__()
        self.npoint, self.radius, self.nsample = npoint, radius, nsample
        channels = list(mlp)
        channels[0] += 3  # relative xyz rides in front of the features
        self.mlp_module = SharedMLP(channels, generator)

    def forward(self, xyz: torch.Tensor, features: Optional[torch.Tensor],
                inds: Union[None, str, torch.Tensor] = None):
        """xyz: (B, N, 3) contiguous; features: (B, N, C) or None; inds:
        None (run FPS), "prefix" (``xyz`` is FPS-ordered, so FPS would pick
        its first npoint points in order, see the JAX module) or (B, npoint)
        indices. Returns (new_xyz, pooled features, inds)."""
        if isinstance(inds, str):
            if inds != "prefix":
                raise ValueError(f"unknown inds sentinel {inds!r}")
            b = xyz.shape[0]
            inds = torch.arange(self.npoint, dtype=torch.int32, device=xyz.device).expand(b, -1)
            new_xyz = xyz[:, : self.npoint].contiguous()
        else:
            if inds is None:
                inds = furthest_point_sample(xyz, self.npoint)
            new_xyz = gather_points(xyz, inds)

        idx = ball_query(self.radius, self.nsample, xyz, new_xyz)
        if features is not None:
            # one gather of the packed table instead of two
            grouped_all = group_points(torch.cat([xyz, features], dim=-1), idx)
            grouped_xyz = grouped_all[..., :3] - new_xyz[:, :, None, :]
            grouped = torch.cat([grouped_xyz / self.radius, grouped_all[..., 3:]], dim=-1)
        else:
            grouped = (group_points(xyz, idx) - new_xyz[:, :, None, :]) / self.radius
        return new_xyz, self.mlp_module(grouped).amax(dim=2), inds


class PointnetFPModule(nn.Module):
    """Feature propagation: 3-NN inverse-distance interpolation, concat
    [interpolated, skip], shared MLP."""

    def __init__(self, mlp, generator: torch.Generator):
        super().__init__()
        self.mlp = SharedMLP(list(mlp), generator)

    def forward(self, unknown, known, unknown_feats, known_feats):
        dist, idx = three_nn(unknown, known)
        dist_recip = 1.0 / (dist + 1e-8)
        weight = dist_recip / dist_recip.sum(dim=2, keepdim=True)
        new = three_interpolate(known_feats, idx, weight)
        if unknown_feats is not None:
            new = torch.cat([new, unknown_feats], dim=-1)
        return self.mlp(new)
