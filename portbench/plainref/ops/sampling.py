"""Gather points by index.

Counterpart of ``iou3dmatch_tpu/ops/sampling.py``
(reference ``pointnet2/_ext_src/src/sampling_gpu.cu:13-62``). Plain PyTorch
indexing, no kernel: the forward gathers 2,048 rows per scene at most.
"""
import torch


def gather_points(features: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """features: (B, N, C) channels-last, idx: (B, m) int -> (B, m, C).

    Out-of-range indices are clamped to [0, N-1], the JAX package's one
    index contract."""
    b, n = features.shape[:2]
    rows = torch.arange(b, device=features.device)[:, None]
    return features[rows, idx.long().clamp(0, n - 1)]
