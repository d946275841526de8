"""VoteNet with the IoU-prediction branch.

Counterpart of ``iou3dmatch_tpu/models/votenet.py`` (reference
``models/votenet_iou_branch.py:23-151``): backbone -> voting (with
L2-normalised vote features) -> proposal decode -> box computation (argmax
class, HALF sizes) -> GridConv IoU branch, and the training forward
``forward_with_pred_jitter`` (``votenet.py:137-203``), which adds jittered
copies of the boxes, and ``forward_onlyiou`` (``votenet.py:205-209``), the
IoU branch alone on given boxes, for test-time IoU optimisation.

``sampling`` goes to the proposal module, ``query_feats`` to GridConv and
``fps_prefix`` to the backbone and the proposal module (JAX
``votenet.py:41-65``). With ``random`` sampling every
forward takes a ``generator`` (or given ``sample_inds``);
``forward_with_pred_jitter`` draws the proposal indices first and the
jitter after them, from the same generator.

``compute_dtype="bfloat16"`` is JAX's mixed precision (``votenet.py:34-66``):
the backbone's SA and FP shared MLPs, and GridConv's ``mlp_before_iou`` and
interpolation unless ``f32_gridconv``, compute in bf16; the voting and
proposal modules and GridConv's conv head stay f32, and so do every
parameter and running statistic. ``f32_gridconv`` without bf16 changes
nothing.
"""
import math
from typing import Optional, Tuple

import numpy as np
import torch
from torch import nn

from .backbone import Pointnet2Backbone
from .grid_conv import GridConv
from .proposal import ProposalModule
from .voting import VotingModule

# compute_dtype -> the shared MLPs' dtype (JAX's names)
COMPUTE_DTYPES = {None: None, "bfloat16": torch.bfloat16}


class IoUDetector(nn.Module):
    """What VoteNet and Group-Free-3D (``models/groupfree.py``) share: the
    argmax-class box decode of the heads, GridConv on the detached boxes,
    the jittered training forward and the IoU branch alone. A subclass
    holds ``num_heading_bin``, the ``mean_size`` buffer and ``grid_conv``,
    and gives ``forward_backbone(point_clouds, sa1_inds, generator,
    sample_inds) -> end_points`` with the heads under the keys
    ``calculate_bbox`` reads and the seeds GridConv reads."""

    def class2angle(self, cls: torch.Tensor, residual: torch.Tensor) -> torch.Tensor:
        """Heading decode; ScanNet (1 bin) is always 0."""
        if self.num_heading_bin == 1:
            return torch.zeros(cls.shape, dtype=residual.dtype, device=cls.device)
        angle = cls.float() * (2 * math.pi / self.num_heading_bin) + residual
        return angle - 2 * math.pi * (angle > math.pi).float()

    def calculate_bbox(self, ep: dict):
        """Argmax-class box decode; HALF sizes with negative components
        clamped to 1e-6 (votenet_iou_branch.py:111-137)."""
        size_class = torch.argmax(ep["size_scores"], dim=-1)  # (B, K)
        size_residual = torch.gather(
            ep["size_residuals"], 2,
            size_class[:, :, None, None].expand(-1, -1, 1, 3))[:, :, 0, :]
        size = (self.mean_size[size_class] + size_residual) / 2.0
        size = torch.where(size < 0, torch.full_like(size, 1e-6), size)
        heading_class = torch.argmax(ep["heading_scores"], dim=-1)
        heading_residual = torch.gather(
            ep["heading_residuals"], 2, heading_class[:, :, None])[:, :, 0]
        heading = self.class2angle(heading_class, heading_residual)
        ep["size"] = size
        ep["heading"] = heading
        return ep["center"], size, heading

    def forward(self, point_clouds: torch.Tensor,
                sa1_inds: Optional[torch.Tensor] = None,
                generator: Optional[torch.Generator] = None,
                sample_inds: Optional[torch.Tensor] = None) -> dict:
        """Standard forward (votenet_iou_branch.py:139-151); the boxes are
        detached before the IoU branch."""
        ep = self.forward_backbone(point_clouds, sa1_inds=sa1_inds, generator=generator,
                                   sample_inds=sample_inds)
        center, size, heading = self.calculate_bbox(ep)
        return self.grid_conv(center.detach(), size.detach(), heading.detach(), ep)

    def forward_with_pred_jitter(self, point_clouds: torch.Tensor,
                                 generator: Optional[torch.Generator] = None,
                                 noise: Optional[Tuple[torch.Tensor, torch.Tensor]] = None,
                                 sa1_inds: Optional[torch.Tensor] = None,
                                 jitter_rows: Optional[int] = None,
                                 sample_inds: Optional[torch.Tensor] = None) -> dict:
        """Training forward with jittered box copies
        (votenet_iou_branch.py:157-181): center + size * N(0, 1) * 0.3 and
        size + size * N(0, 1) * 0.3 clamped at 1e-8, sizes HALF extents.

        ``noise`` gives the two (B, K, 3) standard-normal draws (center,
        then size); without it they are drawn from ``generator``, which
        must live on the model's device, after ``random`` sampling's draw. With ``jitter_rows`` None
        GridConv runs on (B, 2K) boxes; with an int nl only the first nl
        scenes keep jittered copies, which ride along as nl extra scenes
        sharing those scenes' seeds. The boxes are detached, and
        ``jitter_size`` holds full extents, as the reference does."""
        ep = self.forward_backbone(point_clouds, sa1_inds=sa1_inds, generator=generator,
                                   sample_inds=sample_inds)
        center, size, heading = (t.detach() for t in self.calculate_bbox(ep))
        b, k = heading.shape
        if noise is None:
            noise = tuple(torch.randn(size.shape, generator=generator, device=size.device)
                          for _ in range(2))
        noise_center, noise_size = noise
        center_jitter = center + size * noise_center * 0.3
        size_jitter = (size + size * noise_size * 0.3).clamp(min=1e-8)

        if jitter_rows is None:
            ep = self.grid_conv(torch.cat([center, center_jitter], 1),
                                torch.cat([size, size_jitter], 1),
                                torch.cat([heading, heading], 1), ep)
            ep["iou_scores_jitter"] = ep["iou_scores"][:, k:]
            ep["iou_scores"] = ep["iou_scores"][:, :k]
            ep["jitter_center"] = center_jitter
            ep["jitter_size"] = size_jitter * 2
            ep["jitter_heading"] = heading
            return ep

        nl = jitter_rows
        center_jitter, size_jitter = center_jitter[:nl], size_jitter[:nl]
        ep2 = dict(ep)
        for key in ("seed_xyz", "seed_features", "vote_xyz", "vote_features"):
            ep2[key] = torch.cat([ep2[key], ep2[key][:nl]], 0)
        ep2 = self.grid_conv(torch.cat([center, center_jitter], 0),
                             torch.cat([size, size_jitter], 0),
                             torch.cat([heading, heading[:nl]], 0), ep2)
        ep["iou_scores"] = ep2["iou_scores"][:b]
        ep["iou_scores_jitter"] = ep2["iou_scores"][b:]
        ep["jitter_center"] = center_jitter
        ep["jitter_size"] = size_jitter * 2
        ep["jitter_heading"] = heading[:nl]
        return ep

    def forward_onlyiou(self, ep: dict, center: torch.Tensor, size: torch.Tensor,
                        heading: torch.Tensor) -> dict:
        """Only the GridConv IoU branch, on the boxes given (center, HALF
        sizes, heading) and ``ep``'s seeds (votenet_iou_branch.py:183-185):
        a new dict with ``iou_scores`` replaced; ``ep`` is not changed.
        BatchNorm follows the module's mode: test-time optimisation runs it
        in eval mode, on running statistics, as JAX's ``train=False``. The
        gradient reaches ``center`` and ``size`` and not the seeds, which
        GridConv detaches."""
        return self.grid_conv(center, size, heading, dict(ep))


class VoteNet(IoUDetector):
    def __init__(self, num_class: int, num_heading_bin: int, num_size_cluster: int,
                 mean_size_arr, generator: torch.Generator, input_feature_dim: int = 0,
                 num_proposal: int = 128, vote_factor: int = 1,
                 sa_npoints=(2048, 1024, 512, 256), sampling: str = "seed_fps",
                 query_feats: str = "seed", fps_prefix: bool = True,
                 compute_dtype=None, f32_gridconv: bool = False):
        super().__init__()
        if compute_dtype not in COMPUTE_DTYPES:
            raise ValueError(f"compute_dtype is one of {COMPUTE_DTYPES}, not {compute_dtype!r}")
        mp_dtype = COMPUTE_DTYPES[compute_dtype]
        self.compute_dtype = mp_dtype or torch.float32
        self.f32_gridconv = f32_gridconv
        if query_feats == "seed+vote" and vote_factor != 1:
            raise ValueError("query_feats='seed+vote' pairs each seed with one vote: it needs "
                             f"vote_factor 1, not {vote_factor} (the JAX GridConv fails on "
                             "the shapes)")
        self.num_heading_bin = num_heading_bin
        self.register_buffer(
            "mean_size", torch.as_tensor(np.asarray(mean_size_arr), dtype=torch.float32),
            persistent=False)
        self.backbone_net = Pointnet2Backbone(input_feature_dim, generator,
                                              sa_npoints=sa_npoints, fps_prefix=fps_prefix,
                                              dtype=mp_dtype)
        self.vgen = VotingModule(vote_factor, 256, generator)
        self.pnet = ProposalModule(num_class, num_heading_bin, num_size_cluster,
                                   mean_size_arr, generator, num_proposal=num_proposal,
                                   sampling=sampling, fps_prefix=fps_prefix)
        self.grid_conv = GridConv(num_class, num_heading_bin, num_size_cluster, generator,
                                  query_feats=query_feats,
                                  dtype=None if f32_gridconv else mp_dtype)

    def forward_backbone(self, point_clouds: torch.Tensor,
                         sa1_inds: Optional[torch.Tensor] = None,
                         generator: Optional[torch.Generator] = None,
                         sample_inds: Optional[torch.Tensor] = None) -> dict:
        """(B, N, 3+C) -> end_points (votenet_iou_branch.py:75-109).
        ``generator`` and ``sample_inds`` go to the proposal module."""
        ep = self.backbone_net(point_clouds, sa1_inds=sa1_inds)
        ep["seed_inds"] = ep["fp2_inds"]
        ep["seed_xyz"] = ep["fp2_xyz"]
        ep["seed_features"] = ep["fp2_features"]
        xyz, features = self.vgen(ep["seed_xyz"], ep["seed_features"])
        features = features / torch.linalg.norm(features, dim=-1, keepdim=True)
        ep["vote_xyz"] = xyz
        ep["vote_features"] = features
        return self.pnet(xyz, features, ep, generator=generator, sample_inds=sample_inds)
