"""GridConv IoU-prediction branch.

Counterpart of ``iou3dmatch_tpu/models/grid_conv.py`` (reference
``models/grid_conv_module.py:22-116``) with ``query_feats="seed"``: a 4x4x4
grid spanning +-the half-extent of each predicted box (rotated by heading,
offset by center), 3-NN inverse-distance interpolation of the seed features
onto the grid points, [box-relative grid xyz | interpolated features], a
SharedMLP, a max over the 64 grid points and a conv head whose last
``num_class`` channels are the per-class IoU logits.

The interpolation takes the reference's gather form (the JAX package's
``IOU3DMATCH_GRIDCONV_GATHER`` branch, ``grid_conv.py:158-169``): three_nn
indices, one ``group_points`` gather of the packed seed [xyz | features],
distances recomputed from the gathered xyz, a weighted sum.
"""
import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from ..geometry.boxes import rot_gpu
from ..ops import group_points, three_nn
from .mlp import BatchNorm, SharedMLP, head_conv

GRID_SIZE = 4


def _grid_offsets() -> np.ndarray:
    """(64, 3) lattice in [-1, 1]^3; x slowest, z fastest
    (grid_conv_module.py:65-76)."""
    step = np.linspace(-1.0, 1.0, GRID_SIZE)
    gx, gy, gz = np.meshgrid(step, step, step, indexing="ij")
    return np.stack([gx.ravel(), gy.ravel(), gz.ravel()], axis=-1)


class GridConv(nn.Module):
    def __init__(self, num_class: int, num_heading_bin: int, num_size_cluster: int,
                 generator: torch.Generator, seed_feat_dim: int = 256):
        super().__init__()
        self.num_class = num_class
        self.register_buffer(
            "offsets", torch.as_tensor(_grid_offsets(), dtype=torch.float32), persistent=False)
        self.mlp_before_iou = SharedMLP((3 + seed_feat_dim, 128, 128, 128), generator)
        out_dim = 3 + num_heading_bin * 2 + num_size_cluster * 3 + num_class
        self.conv1_iou = head_conv(128, 128, generator)
        self.conv2_iou = head_conv(128, 128, generator)
        self.conv3_iou = head_conv(128, out_dim, generator)
        self.bn1_iou = BatchNorm(128)
        self.bn2_iou = BatchNorm(128)

    def forward(self, center: torch.Tensor, size: torch.Tensor, heading: torch.Tensor,
                ep: dict) -> dict:
        """center (B, K, 3), size (B, K, 3) half extents, heading (B, K).
        The seeds are detached, as the JAX branch stops their gradient
        (``grid_conv.py:124-125``): the IoU loss trains this branch only."""
        seed_xyz, seed_features = ep["seed_xyz"].detach(), ep["seed_features"].detach()
        b, k = size.shape[:2]
        g = GRID_SIZE ** 3
        rel = self.offsets[None, None] * size[:, :, None, :]  # (B, K, 64, 3)
        # grid @ R^T (grid_conv_module.py:77-78)
        grid = torch.einsum("bkgc,bkdc->bkgd", rel, rot_gpu(heading))
        grid = grid + center[:, :, None, :]
        flat_grid = grid.reshape(b, k * g, 3)

        _, idx = three_nn(flat_grid, seed_xyz)  # (B, K*64, 3)
        packed = torch.cat([seed_xyz, seed_features], dim=-1)
        grouped = group_points(packed, idx)  # (B, K*64, 3, 3+C)
        diff = grouped[..., :3] - flat_grid[:, :, None, :]
        dist = torch.sqrt((diff * diff).sum(dim=-1))
        weight = 1.0 / (dist + 1e-8)
        weight = weight / weight.sum(dim=2, keepdim=True)
        interp = (grouped[..., 3:] * weight[..., None]).sum(dim=2)  # (B, K*64, C)

        # box-relative grid coordinates in world orientation first
        # (grid_conv_module.py:94)
        rel_world = (grid - center[:, :, None, :]).reshape(b, k * g, 3)
        feats = torch.cat([rel_world, interp], dim=-1).reshape(b, k, g, -1)
        pooled = self.mlp_before_iou(feats).amax(dim=2)  # (B, K, 128)
        net = F.relu(self.bn1_iou(self.conv1_iou(pooled)))
        net = F.relu(self.bn2_iou(self.conv2_iou(net)))
        ep["iou_scores"] = self.conv3_iou(net)[..., -self.num_class:]
        return ep
