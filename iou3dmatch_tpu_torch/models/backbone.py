"""PointNet++ backbone.

Counterpart of ``iou3dmatch_tpu/models/backbone.py`` (reference
``models/backbone_module.py:21-133``): four single-scale SA layers
(2048/1024/512/256 points, radii 0.2/0.4/0.8/1.2, nsample 64/32/16/16) and
two FP layers; the seeds are fp2 (1024 points, 256-d features).

``width`` multiplies every SA and FP width (Group-Free-3D's ``width``,
its ``backbone_module.py``) and ``seed_feat_dim`` sets FP2's output:
Group-Free-3D's w2x backbone is ``width=2, seed_feat_dim=288``. The
defaults, 1 and 256, are VoteNet's.

With ``fps_prefix`` (the default) SA2-SA4 take the "prefix" path: their
input is FPS-ordered, so FPS over it picks its first npoint points in order
and the kernel is skipped. ``fps_prefix=False`` runs FPS in each of them,
as the reference does (JAX ``models/backbone.py:76-84``); the outputs are
the same.

``dtype=torch.bfloat16`` runs SA1-SA4 and FP1-FP2's shared MLPs in bf16;
SA3 and SA4, whose rows are widest, gather the bitcast-packed bf16 table,
while SA1 and SA2 keep the f32 packed table (JAX ``backbone.py:38-51``).
"""
from typing import Optional, Sequence

import torch
from torch import nn

from .pointnet2 import PointnetFPModule, PointnetSAModuleVotes


class Pointnet2Backbone(nn.Module):
    def __init__(self, input_feature_dim: int, generator: torch.Generator,
                 sa_npoints: Sequence[int] = (2048, 1024, 512, 256),
                 sa_radii: Sequence[float] = (0.2, 0.4, 0.8, 1.2),
                 sa_nsamples: Sequence[int] = (64, 32, 16, 16), fps_prefix: bool = True,
                 dtype=None, width: int = 1, seed_feat_dim: int = 256):
        super().__init__()
        self.fps_prefix = fps_prefix
        w = width
        mlps = ((input_feature_dim, 64 * w, 64 * w, 128 * w), (128 * w, 128 * w, 128 * w, 256 * w),
                (256 * w, 128 * w, 128 * w, 256 * w), (256 * w, 128 * w, 128 * w, 256 * w))
        for i, (npoint, radius, nsample, mlp) in enumerate(
                zip(sa_npoints, sa_radii, sa_nsamples, mlps), start=1):
            self.add_module(f"sa{i}", PointnetSAModuleVotes(
                mlp=mlp, npoint=npoint, radius=radius, nsample=nsample,
                generator=generator, dtype=dtype, bitcast_gather=i >= 3))
        self.fp1 = PointnetFPModule((512 * w, 256 * w, 256 * w), generator, dtype=dtype)
        self.fp2 = PointnetFPModule((512 * w, 256 * w, seed_feat_dim), generator, dtype=dtype)

    def forward(self, pointcloud: torch.Tensor,
                sa1_inds: Optional[torch.Tensor] = None) -> dict:
        """pointcloud: (B, N, 3 + input_feature_dim) -> end_points dict.
        ``sa1_inds`` optionally gives SA1's FPS indices (B, npoint[0])."""
        xyz = pointcloud[..., 0:3].contiguous()
        features = pointcloud[..., 3:] if pointcloud.shape[-1] > 3 else None

        ep = {}
        xyz, features, inds = self.sa1(xyz, features, inds=sa1_inds)
        ep["sa1_inds"], ep["sa1_xyz"], ep["sa1_features"] = inds, xyz, features
        prefix = "prefix" if self.fps_prefix else None
        xyz, features, inds = self.sa2(xyz, features, inds=prefix)
        ep["sa2_inds"], ep["sa2_xyz"], ep["sa2_features"] = inds, xyz, features
        xyz, features, _ = self.sa3(xyz, features, inds=prefix)
        ep["sa3_xyz"], ep["sa3_features"] = xyz, features
        xyz, features, _ = self.sa4(xyz, features, inds=prefix)
        ep["sa4_xyz"], ep["sa4_features"] = xyz, features

        features = self.fp1(ep["sa3_xyz"], ep["sa4_xyz"], ep["sa3_features"],
                            ep["sa4_features"])
        features = self.fp2(ep["sa2_xyz"], ep["sa3_xyz"], ep["sa2_features"], features)
        ep["fp2_features"] = features
        ep["fp2_xyz"] = ep["sa2_xyz"]
        # seed indices into the raw cloud: the first num_seed of SA1's FPS
        # order (backbone_module.py:132)
        ep["fp2_inds"] = ep["sa1_inds"][:, 0:ep["fp2_xyz"].shape[1]]
        return ep
