"""Hough voting module.

Counterpart of ``iou3dmatch_tpu/models/voting.py`` (reference
``models/voting_module.py:16-65``): two conv+BN+ReLU layers and a conv
head giving per-seed xyz offsets and residual features. Channels-last.
"""
import torch
import torch.nn.functional as F
from torch import nn

from .mlp import BatchNorm, head_conv


class VotingModule(nn.Module):
    def __init__(self, vote_factor: int, seed_feature_dim: int,
                 generator: torch.Generator):
        super().__init__()
        c = seed_feature_dim
        self.vote_factor = vote_factor
        self.conv1 = head_conv(c, c, generator)
        self.conv2 = head_conv(c, c, generator)
        self.conv3 = head_conv(c, (3 + c) * vote_factor, generator)
        self.bn1 = BatchNorm(c)
        self.bn2 = BatchNorm(c)

    def forward(self, seed_xyz: torch.Tensor, seed_features: torch.Tensor):
        """seed_xyz: (B, S, 3); seed_features: (B, S, C) ->
        (vote_xyz (B, S*vf, 3), vote_features (B, S*vf, C))."""
        b, s, _ = seed_xyz.shape
        c = seed_features.shape[-1]
        net = F.relu(self.bn1(self.conv1(seed_features)))
        net = F.relu(self.bn2(self.conv2(net)))
        net = self.conv3(net).reshape(b, s, self.vote_factor, 3 + c)
        vote_xyz = (seed_xyz[:, :, None, :] + net[..., 0:3]).reshape(b, s * self.vote_factor, 3)
        vote_features = (seed_features[:, :, None, :] + net[..., 3:]).reshape(
            b, s * self.vote_factor, c)
        return vote_xyz, vote_features
