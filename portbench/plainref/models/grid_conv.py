"""GridConv IoU-prediction branch.

Counterpart of ``iou3dmatch_tpu/models/grid_conv.py`` (reference
``models/grid_conv_module.py:22-116``): a 4x4x4 grid spanning +-the
half-extent of each predicted box (rotated by heading, offset by center),
3-NN inverse-distance interpolation of origin features onto the grid
points, [box-relative grid xyz | interpolated features], a SharedMLP, a max
over the 64 grid points and a conv head whose last ``num_class`` channels
are the per-class IoU logits.

``query_feats`` picks the origins (JAX ``grid_conv.py:116-123``), both
detached: ``"seed"`` (the default) ``seed_xyz`` with ``seed_features``,
``"vote"`` ``vote_xyz`` with ``vote_features``, ``"seed+vote"``
``seed_xyz`` with ``vote_features``. ``"seed+vote"`` pairs S seeds with
S * vote_factor vote rows, which line up only at vote_factor 1: the JAX
module raises on the shapes past that (its one-hot product contracts S
against S * vote_factor), and ``VoteNet`` refuses the pair when it is
built.

The interpolation takes the reference's gather form (the JAX package's
``IOU3DMATCH_GRIDCONV_GATHER`` branch, ``grid_conv.py:158-169``): three_nn
indices, one ``group_points`` gather of the packed origin [xyz | features],
distances recomputed from the gathered xyz, a weighted sum.

With ``dtype=torch.bfloat16`` (JAX's bf16 ``_interp_onehot``,
``grid_conv.py:60-104``) the shared MLP runs in bf16, and so does the
interpolation: the neighbours' xyz are the seeds' bf16-rounded xyz, each
normalised weight is rounded to bf16, and a row is bf16(sum_k w_k * f_k)
over the bf16 features, the exact products summed in f32. The gather
takes the bitcast-packed bf16 table (``group_points_bitcast``, the seeds'
f32 xyz bits beside their bf16 features), half the f32 table's bytes, and
rounds the xyz after it. The gradient to center, size and heading flows
through the distances and the bf16 casts, as in JAX. JAX's bf16 GridConv
picks its neighbours by ``approx_min_k`` (``_three_nn_approx``), whose TPU
picks cannot be reproduced; the port runs the exact ``three_nn`` in both
dtypes (ROADMAP Queue 3).
"""
import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from ..geometry.boxes import rot_gpu
from ..ops import group_points, three_nn
from .mlp import BatchNorm, SharedMLP, head_conv

GRID_SIZE = 4
QUERY_FEATS = ("seed", "vote", "seed+vote")


def _grid_offsets() -> np.ndarray:
    """(64, 3) lattice in [-1, 1]^3; x slowest, z fastest
    (grid_conv_module.py:65-76)."""
    step = np.linspace(-1.0, 1.0, GRID_SIZE)
    gx, gy, gz = np.meshgrid(step, step, step, indexing="ij")
    return np.stack([gx.ravel(), gy.ravel(), gz.ravel()], axis=-1)


class GridConv(nn.Module):
    def __init__(self, num_class: int, num_heading_bin: int, num_size_cluster: int,
                 generator: torch.Generator, seed_feat_dim: int = 256,
                 query_feats: str = "seed", dtype=None):
        super().__init__()
        if query_feats not in QUERY_FEATS:
            raise ValueError(f"query_feats is one of {QUERY_FEATS}, not {query_feats!r}")
        self.num_class = num_class
        self.query_feats = query_feats
        self.dtype = dtype
        self.register_buffer(
            "offsets", torch.as_tensor(_grid_offsets(), dtype=torch.float32), persistent=False)
        self.mlp_before_iou = SharedMLP((3 + seed_feat_dim, 128, 128, 128), generator,
                                        dtype=dtype)
        out_dim = 3 + num_heading_bin * 2 + num_size_cluster * 3 + num_class
        self.conv1_iou = head_conv(128, 128, generator)
        self.conv2_iou = head_conv(128, 128, generator)
        self.conv3_iou = head_conv(128, out_dim, generator)
        self.bn1_iou = BatchNorm(128)
        self.bn2_iou = BatchNorm(128)

    def forward(self, center: torch.Tensor, size: torch.Tensor, heading: torch.Tensor,
                ep: dict) -> dict:
        """center (B, K, 3), size (B, K, 3) half extents, heading (B, K).
        The origins are detached, as the JAX branch stops their gradient
        (``grid_conv.py:124-125``): the IoU loss trains this branch only."""
        xyz_key = "vote_xyz" if self.query_feats == "vote" else "seed_xyz"
        feat_key = "seed_features" if self.query_feats == "seed" else "vote_features"
        origin_xyz, origin_features = ep[xyz_key].detach(), ep[feat_key].detach()
        b, k = size.shape[:2]
        g = GRID_SIZE ** 3
        rel = self.offsets[None, None] * size[:, :, None, :]  # (B, K, 64, 3)
        # grid @ R^T (grid_conv_module.py:77-78)
        grid = torch.einsum("bkgc,bkdc->bkgd", rel, rot_gpu(heading))
        grid = grid + center[:, :, None, :]
        flat_grid = grid.reshape(b, k * g, 3)

        _, idx = three_nn(flat_grid, origin_xyz)  # (B, K*64, 3)
        interp = self.interpolate(flat_grid, origin_xyz, origin_features, idx)

        # box-relative grid coordinates in world orientation first
        # (grid_conv_module.py:94)
        rel_world = (grid - center[:, :, None, :]).reshape(b, k * g, 3)
        feats = torch.cat([rel_world, interp], dim=-1).reshape(b, k, g, -1)
        pooled = self.mlp_before_iou(feats).amax(dim=2)  # (B, K, 128)
        net = F.relu(self.bn1_iou(self.conv1_iou(pooled)))
        net = F.relu(self.bn2_iou(self.conv2_iou(net)))
        ep["iou_scores"] = self.conv3_iou(net)[..., -self.num_class:]
        return ep

    def interpolate(self, flat_grid: torch.Tensor, origin_xyz: torch.Tensor,
                    origin_features: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
        """(B, q, C) inverse-distance interpolation of the origin features at
        the grid points from their three_nn ``idx`` (B, q, 3), in f32, or in
        bf16 with ``dtype`` bf16 (the module docstring)."""
        grouped = group_points(torch.cat([origin_xyz, origin_features], dim=-1), idx)
        pts, feats = grouped[..., :3], grouped[..., 3:]  # (B, q, 3, 3), (B, q, 3, C)
        diff = pts - flat_grid[:, :, None, :]
        dist = torch.sqrt((diff * diff).sum(dim=-1))
        weight = 1.0 / (dist + 1e-8)
        weight = weight / weight.sum(dim=2, keepdim=True)
        return (feats * weight[..., None]).sum(dim=2)
