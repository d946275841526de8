"""VoteNet and Group-Free-3D with the GridConv IoU branch, channels-last
PyTorch modules.

Exports what ``iou3dmatch_tpu/models/__init__.py`` exports, and
``GroupFreeDetector``, which the JAX package does not have."""
from .mlp import BatchNorm, SharedMLP
from .pointnet2 import PointnetSAModuleVotes, PointnetSAModuleMSGVotes, PointnetFPModule
from .backbone import Pointnet2Backbone
from .voting import VotingModule
from .proposal import ProposalModule
from .grid_conv import GridConv
from .votenet import VoteNet
from .groupfree import GroupFreeDetector

__all__ = [
    "BatchNorm",
    "SharedMLP",
    "PointnetSAModuleVotes",
    "PointnetSAModuleMSGVotes",
    "PointnetFPModule",
    "Pointnet2Backbone",
    "VotingModule",
    "ProposalModule",
    "GridConv",
    "VoteNet",
    "GroupFreeDetector",
]
