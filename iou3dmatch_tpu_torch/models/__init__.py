"""VoteNet with the GridConv IoU branch, channels-last PyTorch modules.

Exports what ``iou3dmatch_tpu/models/__init__.py`` exports."""
from .mlp import BatchNorm, SharedMLP
from .pointnet2 import PointnetSAModuleVotes, PointnetSAModuleMSGVotes, PointnetFPModule
from .backbone import Pointnet2Backbone
from .voting import VotingModule
from .proposal import ProposalModule
from .grid_conv import GridConv
from .votenet import VoteNet

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
]
