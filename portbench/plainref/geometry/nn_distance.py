"""Chamfer nearest-neighbour distances and the Huber loss.

Counterpart of ``iou3dmatch_tpu/geometry/nn_distance.py`` (reference
``utils/nn_distance.py:16-216``): dense (B, N, M) distance matrices, which
the losses take at most at (8, 128, 64). Each function gives (dist1 (B, N),
idx1 (B, N), dist2 (B, M), idx2 (B, M)): for each point the distance to the
nearest point of the other set and its index, the first on ties. A pair's
distance is the squared L2, or with ``l1`` the L1, or with ``l1smooth`` the
Huber loss of each coordinate summed.

``nn_distance`` and ``nn_distance_withcls`` serve the losses; the
exclude-self and in-box variants are the library surface (no loss of the
port calls them, as none of JAX's does).
"""
import torch


def huber_loss(error: torch.Tensor, delta: float = 1.0) -> torch.Tensor:
    """0.5 x^2 where |x| <= delta, else 0.5 delta^2 + delta (|x| - delta)."""
    abs_error = error.abs()
    quadratic = abs_error.clamp(max=delta)
    linear = abs_error - quadratic
    return 0.5 * quadratic ** 2 + delta * linear


def _dist(diff: torch.Tensor, l1smooth: bool, delta: float, l1: bool) -> torch.Tensor:
    if l1smooth:
        return huber_loss(diff, delta).sum(-1)
    if l1:
        return diff.abs().sum(-1)
    return (diff * diff).sum(-1)


def _min_both(d: torch.Tensor):
    dist1, idx1 = d.min(-1)
    dist2, idx2 = d.min(-2)
    return dist1, idx1, dist2, idx2


def _cls_penalty(cls1: torch.Tensor, cls2: torch.Tensor, dtype) -> torch.Tensor:
    return (cls1[..., :, None] != cls2[..., None, :]).to(dtype) * 1000.0


def nn_distance(pc1: torch.Tensor, pc2: torch.Tensor, l1smooth: bool = False,
                delta: float = 1.0, l1: bool = False):
    """pc1: (B, N, C), pc2: (B, M, C) (nn_distance.py:35-62)."""
    return _min_both(_dist(pc1[..., :, None, :] - pc2[..., None, :, :], l1smooth, delta, l1))


def nn_distance_withcls(pc1: torch.Tensor, pc2: torch.Tensor, cls1: torch.Tensor,
                        cls2: torch.Tensor, l1smooth: bool = False, delta: float = 1.0,
                        l1: bool = False):
    """``nn_distance`` with 1000 added to the distance of every pair of
    other classes (nn_distance.py:144-178); cls1 (B, N), cls2 (B, M)."""
    d = _dist(pc1[..., :, None, :] - pc2[..., None, :, :], l1smooth, delta, l1)
    return _min_both(d + _cls_penalty(cls1, cls2, d.dtype))


def _exclude_self(pc1: torch.Tensor, pc2: torch.Tensor, l1smooth: bool, delta: float,
                  l1: bool) -> torch.Tensor:
    """The reference overwrites pc2's diagonal entries with -1000 before
    differencing (nn_distance.py:65-99), so a point's distance to itself is
    its distance to (-1000, ..., -1000): reproduced as it is."""
    n = pc1.shape[-2]
    if pc2.shape[-2] != n:
        raise ValueError(f"exclude-self needs sets of one size, got {n} and {pc2.shape[-2]}")
    eye = torch.eye(n, dtype=torch.bool, device=pc2.device)
    pc2_mod = torch.where(eye[:, :, None], torch.full((), -1000.0, dtype=pc2.dtype,
                                                      device=pc2.device), pc2[..., None, :, :])
    return _dist(pc1[..., :, None, :] - pc2_mod, l1smooth, delta, l1)


def nn_distance_exclude_self(pc1: torch.Tensor, pc2: torch.Tensor, l1smooth: bool = False,
                             delta: float = 1.0, l1: bool = False):
    """Chamfer of a set against a set of the same size with each point's
    own pair excluded (nn_distance.py:65-99)."""
    return _min_both(_exclude_self(pc1, pc2, l1smooth, delta, l1))


def nn_distance_exclude_self_with_cls(pc1: torch.Tensor, pc2: torch.Tensor, cls1: torch.Tensor,
                                      cls2: torch.Tensor, l1smooth: bool = False,
                                      delta: float = 1.0, l1: bool = False):
    """Exclude-self chamfer with 1000 added across classes
    (nn_distance.py:102-141)."""
    d = _exclude_self(pc1, pc2, l1smooth, delta, l1)
    return _min_both(d + _cls_penalty(cls1, cls2, d.dtype))


def nn_distance_inbox(pc1: torch.Tensor, seed: torch.Tensor, pc2: torch.Tensor,
                      half_size: torch.Tensor, l1smooth: bool = False, delta: float = 1.0,
                      l1: bool = False):
    """Chamfer with 1000 added where ``seed`` (B, N, 3), the point pc1's
    vote came from, lies outside the axis-aligned box of ``half_size`` (B,
    M, 3) around the pc2 target (nn_distance.py:181-216)."""
    d = _dist(pc1[..., :, None, :] - pc2[..., None, :, :], l1smooth, delta, l1)
    lower = pc2[..., None, :, :] - half_size[..., None, :, :]
    higher = pc2[..., None, :, :] + half_size[..., None, :, :]
    seed_t = seed[..., :, None, :]
    outside = ((lower > seed_t).any(-1) | (higher < seed_t).any(-1)).to(d.dtype) * 1000.0
    return _min_both(d + outside)
