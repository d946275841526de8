"""Three-nearest-neighbour search and inverse-distance interpolation.

Counterpart of ``iou3dmatch_tpu/ops/interpolate.py`` (reference
``interpolate_gpu.cu:14-160``), in plain PyTorch on every device: on the
detection forward they see at most 8 x 8,192 queries against 1,024 points.

- ``three_nn``: sqrt distances and int32 indices of the 3 nearest known
  points, the lowest index winning on ties (three masked argmin passes,
  each returning the first minimum). No gradient.
- ``three_interpolate``: a gather and a weighted sum over the 3 neighbours.
"""
import torch


def _sq_dist(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """(..., 3) x (..., 3) -> (...) squared distance, written out term by
    term so each product is rounded on its own."""
    dx = a[..., 0] - b[..., 0]
    dy = a[..., 1] - b[..., 1]
    dz = a[..., 2] - b[..., 2]
    return dx * dx + dy * dy + dz * dz


def three_nn(unknown: torch.Tensor, known: torch.Tensor):
    """unknown: (B, n, 3), known: (B, m, 3) ->
    (dist (B, n, 3) f32, idx (B, n, 3) int32)."""
    unknown, known = unknown.float(), known.float()
    d2 = _sq_dist(unknown[:, :, None, :], known[:, None, :, :])  # (B, n, m)
    idxs = []
    for _ in range(3):
        i = torch.argmin(d2, dim=2)
        idxs.append(i)
        d2 = d2.scatter(2, i[..., None], float("inf"))
    idx = torch.stack(idxs, dim=-1)  # (B, n, 3)
    rows = torch.arange(known.shape[0], device=known.device)[:, None, None]
    dist = torch.sqrt(_sq_dist(unknown[:, :, None, :], known[rows, idx]))
    return dist, idx.to(torch.int32)


def three_interpolate(features: torch.Tensor, idx: torch.Tensor,
                      weight: torch.Tensor) -> torch.Tensor:
    """features: (B, m, C), idx: (B, n, 3), weight: (B, n, 3) -> (B, n, C)."""
    b, m = features.shape[:2]
    rows = torch.arange(b, device=features.device)[:, None, None]
    g = features[rows, idx.long().clamp(0, m - 1)]  # (B, n, 3, C)
    return (g * weight[..., None]).sum(dim=2)
