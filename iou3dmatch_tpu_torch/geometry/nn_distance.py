"""Chamfer nearest-neighbour distances and the Huber loss.

Counterpart of ``iou3dmatch_tpu/geometry/nn_distance.py:9-35`` (reference
``utils/nn_distance.py:16-62``): dense (B, N, M) distance matrices, which
the losses take at most at (8, 128, 64).
"""
import torch


def huber_loss(error: torch.Tensor, delta: float = 1.0) -> torch.Tensor:
    """0.5 x^2 where |x| <= delta, else 0.5 delta^2 + delta (|x| - delta)."""
    abs_error = error.abs()
    quadratic = abs_error.clamp(max=delta)
    linear = abs_error - quadratic
    return 0.5 * quadratic ** 2 + delta * linear


def nn_distance(pc1: torch.Tensor, pc2: torch.Tensor, l1: bool = False):
    """pc1: (B, N, C), pc2: (B, M, C) -> (dist1 (B, N), idx1 (B, N),
    dist2 (B, M), idx2 (B, M)): squared L2 distance to the nearest point of
    the other set (the L1 distance with ``l1``), the first index on ties."""
    diff = pc1[..., :, None, :] - pc2[..., None, :, :]
    d = diff.abs().sum(-1) if l1 else (diff * diff).sum(-1)
    dist1, idx1 = d.min(-1)
    dist2, idx2 = d.min(-2)
    return dist1, idx1, dist2, idx2
