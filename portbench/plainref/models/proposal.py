"""Proposal module: vote aggregation and box/class decoding.

Counterpart of ``iou3dmatch_tpu/models/proposal.py`` (reference
``models/proposal_module.py:24-125``). Where vote aggregation centres its
num_proposal groups, by ``sampling``:

- ``seed_fps`` (the default): at FPS over the seeds. The seeds (SA2's xyz)
  are FPS-ordered, so FPS picks the first num_proposal in order: with
  ``fps_prefix`` (the default) the "prefix" path, no kernel; without it,
  FPS over ``seed_xyz`` (JAX ``models/proposal.py:72-79``).
- ``vote_fps``: at FPS over the votes.
- ``random``: at indices drawn uniformly from [0, num_seed) by
  ``torch.randint`` from the ``generator`` the caller passes (the
  reference's ``torch.randint``, proposal_module.py:104-106; JAX draws
  ``jax.random.randint`` from a key), or at ``sample_inds`` given.

Decoding (``decode_scores``, proposal_module.py:24-54) splits the channels
[objectness(2) | center offset(3) | heading scores(NH) | heading residuals
(NH, x pi/NH) | size scores(NS) | size residuals (NS*3, softplus(x)-1 then
x mean sizes) | sem-cls scores(NC)].
"""
from typing import Optional

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from ..ops import furthest_point_sample
from .mlp import BatchNorm, head_conv
from .pointnet2 import PointnetSAModuleVotes

SAMPLINGS = ("vote_fps", "seed_fps", "random")


class ProposalModule(nn.Module):
    def __init__(self, num_class: int, num_heading_bin: int, num_size_cluster: int,
                 mean_size_arr, generator: torch.Generator, num_proposal: int = 128,
                 seed_feat_dim: int = 256, agg_radius: float = 0.3, agg_nsample: int = 16,
                 sampling: str = "seed_fps", fps_prefix: bool = True):
        super().__init__()
        if sampling not in SAMPLINGS:
            raise ValueError(f"sampling is one of {SAMPLINGS}, not {sampling!r}")
        self.num_proposal = num_proposal
        self.sampling = sampling
        self.fps_prefix = fps_prefix
        self.num_class = num_class
        self.num_heading_bin = num_heading_bin
        self.num_size_cluster = num_size_cluster
        self.register_buffer(
            "mean_size", torch.as_tensor(np.asarray(mean_size_arr), dtype=torch.float32),
            persistent=False)
        self.vote_aggregation = PointnetSAModuleVotes(
            mlp=(seed_feat_dim, 128, 128, 128), npoint=num_proposal, radius=agg_radius,
            nsample=agg_nsample, generator=generator)
        out_dim = 2 + 3 + num_heading_bin * 2 + num_size_cluster * 4 + num_class
        self.conv1 = head_conv(128, 128, generator)
        self.conv2 = head_conv(128, 128, generator)
        self.conv3 = head_conv(128, out_dim, generator)
        self.bn1 = BatchNorm(128)
        self.bn2 = BatchNorm(128)

    def forward(self, xyz: torch.Tensor, features: torch.Tensor, ep: dict,
                generator: Optional[torch.Generator] = None,
                sample_inds: Optional[torch.Tensor] = None) -> dict:
        """xyz: votes (B, K, 3); features: vote features (B, K, C).
        ``random`` sampling takes ``sample_inds`` (B, num_proposal) int32 if
        given, else draws them from ``generator``, which lives on the
        votes' device; other samplings read neither."""
        if self.sampling == "vote_fps":
            inds = None
        elif self.sampling == "seed_fps":
            inds = "prefix" if self.fps_prefix else furthest_point_sample(
                ep["seed_xyz"], self.num_proposal)
        else:
            inds = sample_inds
            if inds is None:
                if generator is None:
                    raise ValueError("sampling='random' draws from an explicit generator: "
                                     "pass generator= or sample_inds=")
                inds = torch.randint(0, ep["seed_xyz"].shape[1], (xyz.shape[0], self.num_proposal),
                                     generator=generator, device=xyz.device, dtype=torch.int32)
        new_xyz, agg_features, sample_inds = self.vote_aggregation(xyz, features, inds=inds)
        ep["aggregated_vote_xyz"] = new_xyz
        ep["aggregated_vote_inds"] = sample_inds
        net = F.relu(self.bn1(self.conv1(agg_features)))
        net = F.relu(self.bn2(self.conv2(net)))
        return self.decode_scores(self.conv3(net), ep)

    def decode_scores(self, net: torch.Tensor, ep: dict) -> dict:
        nh, ns = self.num_heading_bin, self.num_size_cluster
        b, k, _ = net.shape
        ep["objectness_scores"] = net[..., 0:2]
        ep["center"] = ep["aggregated_vote_xyz"] + net[..., 2:5]
        ep["heading_scores"] = net[..., 5:5 + nh]
        hrn = net[..., 5 + nh:5 + nh * 2]
        ep["heading_residuals_normalized"] = hrn
        ep["heading_residuals"] = hrn * (np.pi / nh)
        ep["size_scores"] = net[..., 5 + nh * 2:5 + nh * 2 + ns]
        srn = F.softplus(net[..., 5 + nh * 2 + ns:5 + nh * 2 + ns * 4].reshape(b, k, ns, 3)) - 1.0
        ep["size_residuals_normalized"] = srn
        ep["size_residuals"] = srn * self.mean_size
        ep["sem_cls_scores"] = net[..., 5 + nh * 2 + ns * 4:]
        return ep
