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
from ..ops.ball_query import group_points_bitcast
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
    if bitcast:
        grouped_xyz, grouped_features = group_points_bitcast(
            xyz.detach(), features.to(torch.bfloat16), idx)
        return grouped_xyz - centers[:, :, None, :], grouped_features
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


class QueryAndGroup(nn.Module):
    """The ball-query grouper on its own (reference
    ``pointnet2_utils.py:295-377``), channels-last: (B, npoint, nsample,
    [3 +] C). Optionally also the grouped xyz and, with
    ``sample_uniformly``, each ball's unique count."""

    def __init__(self, radius: float, nsample: int, use_xyz: bool = True,
                 ret_grouped_xyz: bool = False, normalize_xyz: bool = False,
                 sample_uniformly: bool = False, ret_unique_cnt: bool = False):
        super().__init__()
        if ret_unique_cnt and not sample_uniformly:
            raise ValueError("ret_unique_cnt needs sample_uniformly (pointnet2_utils.py:315-316)")
        self.radius, self.nsample, self.use_xyz = radius, nsample, use_xyz
        self.ret_grouped_xyz, self.normalize_xyz = ret_grouped_xyz, normalize_xyz
        self.sample_uniformly, self.ret_unique_cnt = sample_uniformly, ret_unique_cnt

    def forward(self, xyz: torch.Tensor, new_xyz: torch.Tensor,
                features: Optional[torch.Tensor] = None,
                generator: Optional[torch.Generator] = None):
        if features is None and not self.use_xyz:
            raise ValueError("Cannot have not features and not use xyz as a feature!")
        idx = ball_query(self.radius, self.nsample, xyz, new_xyz)
        unique_cnt = None
        if self.sample_uniformly:
            idx, unique_cnt = uniform_resample_idx(idx, generator)
        grouped_xyz, grouped_features = _group(xyz, features, new_xyz, idx)
        if self.normalize_xyz:
            grouped_xyz = grouped_xyz / self.radius
        ret = [_join(grouped_xyz, grouped_features, self.use_xyz)]
        if self.ret_grouped_xyz:
            ret.append(grouped_xyz)
        if self.ret_unique_cnt:
            ret.append(unique_cnt)
        return ret[0] if len(ret) == 1 else tuple(ret)


class GroupAll(nn.Module):
    """All points as one neighbourhood (reference
    ``pointnet2_utils.py:380-426``): (B, 1, N, [3 +] C), absolute xyz."""

    def __init__(self, use_xyz: bool = True):
        super().__init__()
        self.use_xyz = use_xyz

    def forward(self, xyz: torch.Tensor, new_xyz=None,
                features: Optional[torch.Tensor] = None) -> torch.Tensor:
        return _join(xyz[:, None], None if features is None else features[:, None],
                     self.use_xyz)


class PointnetSAModuleMSG(nn.Module):
    """Multi-scale-grouping set abstraction (reference
    ``pointnet2_modules.py:83-130``): one FPS, per scale a ball query,
    [relative xyz | features] (not normalised), a shared MLP ``mlp{i}`` and
    a max pool, concatenated across scales. ``npoint=None`` groups all
    points at a center of zeros (B, 1, 3)."""

    def __init__(self, *, npoint: Optional[int], radii, nsamples, mlps,
                 generator: torch.Generator, use_xyz: bool = True):
        super().__init__()
        if not len(radii) == len(nsamples) == len(mlps):
            raise ValueError("radii, nsamples and mlps need one entry a scale")
        self.npoint, self.radii, self.nsamples, self.use_xyz = npoint, radii, nsamples, use_xyz
        for i, mlp in enumerate(mlps):
            self.add_module(f"mlp{i}", SharedMLP(_mlp_channels(mlp, use_xyz), generator))

    def _scales(self, xyz, features, new_xyz, generator=None, sample_uniformly=False):
        outs = []
        for i, (radius, nsample) in enumerate(zip(self.radii, self.nsamples)):
            if self.npoint is None:
                grouped = GroupAll(self.use_xyz)(xyz, new_xyz, features)
            else:
                idx = ball_query(radius, nsample, xyz, new_xyz)
                if sample_uniformly:
                    idx, _ = uniform_resample_idx(idx, generator)
                grouped = _join(*_group(xyz, features, new_xyz, idx), self.use_xyz)
            outs.append(getattr(self, f"mlp{i}")(grouped).amax(dim=2))
        return torch.cat(outs, dim=-1)

    def forward(self, xyz: torch.Tensor, features: Optional[torch.Tensor] = None):
        """Returns (new_xyz, features of every scale)."""
        if self.npoint is None:
            new_xyz = xyz.new_zeros((xyz.shape[0], 1, 3))
        else:
            new_xyz, _ = _sample_centers(xyz, self.npoint, None)
        return new_xyz, self._scales(xyz, features, new_xyz)


def PointnetSAModule(*, mlp, generator: torch.Generator, npoint=None, radius=None,
                     nsample=None, use_xyz: bool = True):
    """Single-scale SA (reference ``pointnet2_modules.py:133-166``): a
    one-scale ``PointnetSAModuleMSG``; ``npoint=None`` is ``GroupAll``."""
    return PointnetSAModuleMSG(npoint=npoint, radii=(radius,), nsamples=(nsample,),
                               mlps=(tuple(mlp),), generator=generator, use_xyz=use_xyz)


class PointnetSAModuleMSGVotes(PointnetSAModuleMSG):
    """Multi-scale SA that takes and returns the FPS indices, for vote
    lookup (reference ``pointnet2_modules.py:280-359``), optionally with
    uniform resampling of each ball (a ``generator`` at the call)."""

    def __init__(self, *, npoint: Optional[int], radii, nsamples, mlps,
                 generator: torch.Generator, use_xyz: bool = True,
                 sample_uniformly: bool = False):
        super().__init__(npoint=npoint, radii=radii, nsamples=nsamples, mlps=mlps,
                         generator=generator, use_xyz=use_xyz)
        self.sample_uniformly = sample_uniformly

    def forward(self, xyz: torch.Tensor, features: Optional[torch.Tensor] = None,
                inds: Optional[torch.Tensor] = None,
                generator: Optional[torch.Generator] = None):
        """Returns (new_xyz, features of every scale, inds); new_xyz and
        inds are None with ``npoint=None``."""
        new_xyz = None
        if self.npoint is not None:
            new_xyz, inds = _sample_centers(xyz, self.npoint, inds)
        return new_xyz, self._scales(xyz, features, new_xyz, generator,
                                     self.sample_uniformly), inds


class PostMLP(nn.Module):
    """LFP's post MLP: conv -> BN -> ReLU layers ``dense{j}`` and ``bn{j}``,
    each conv bias-free with a Conv1d (out, in, 1) weight and kaiming-normal
    init. These are the keys JAX's key rule gives a SharedMLP whose name
    does not start with ``mlp`` (``post_mlp{i}``), in ``state_dict_from_jax``
    and in the JAX package's ``export_state_dict`` alike."""

    def __init__(self, channels, generator: torch.Generator):
        super().__init__()
        self.depth = len(channels) - 1
        for j, (cin, cout) in enumerate(zip(channels[:-1], channels[1:])):
            w = torch.empty(cout, cin, 1).normal_(0.0, (2.0 / cin) ** 0.5, generator=generator)
            self.add_module(f"dense{j}", PointwiseConv(w))
            self.add_module(f"bn{j}", BatchNorm(cout))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        for j in range(self.depth):
            x = F.relu(getattr(self, f"bn{j}")(getattr(self, f"dense{j}")(x)))
        return x


class PointnetLFPModuleMSG(nn.Module):
    """Learnable multi-scale feature propagation (reference
    ``pointnet2_modules.py:425-503``): at each of xyz2's points, per scale
    a ball query into xyz1, [relative xyz | features1], ``mlp{i}``, a max
    pool, concat features2, ``post_mlp{i}``; scales concatenated. As the
    JAX module, a post MLP for each scale (the reference shares one).
    ``post_mlp[0]`` is the first scale's pooled width plus features2's (the
    reference's rule); each scale's post MLP takes its own pooled width plus
    features2's, the widths the JAX module's Dense layers take."""

    def __init__(self, *, radii, nsamples, mlps, post_mlp, generator: torch.Generator,
                 use_xyz: bool = True):
        super().__init__()
        if not len(radii) == len(nsamples) == len(mlps):
            raise ValueError("radii, nsamples and mlps need one entry a scale")
        self.radii, self.nsamples, self.use_xyz = radii, nsamples, use_xyz
        skip = post_mlp[0] - mlps[0][-1]  # features2's width
        for i, mlp in enumerate(mlps):
            self.add_module(f"mlp{i}", SharedMLP(_mlp_channels(mlp, use_xyz), generator))
            self.add_module(f"post_mlp{i}", PostMLP([mlp[-1] + skip, *post_mlp[1:]], generator))

    def forward(self, xyz2: torch.Tensor, xyz1: torch.Tensor,
                features2: Optional[torch.Tensor], features1: Optional[torch.Tensor]):
        """xyz2 (B, N2, 3) the centers, xyz1 (B, N1, 3) the points grouped,
        features2 (B, N2, C2), features1 (B, N1, C1) -> (B, N2, C)."""
        outs = []
        for i, (radius, nsample) in enumerate(zip(self.radii, self.nsamples)):
            idx = ball_query(radius, nsample, xyz1, xyz2)
            grouped = _join(*_group(xyz1, features1, xyz2, idx), self.use_xyz)
            h = getattr(self, f"mlp{i}")(grouped).amax(dim=2)
            if features2 is not None:
                h = torch.cat([h, features2], dim=-1)
            outs.append(getattr(self, f"post_mlp{i}")(h))
        return torch.cat(outs, dim=-1)
