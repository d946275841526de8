"""Lower-half suppression of the pseudo labels, on the card.

``lhs_3d_samecls`` launches ``csrc/lhs.cu`` on CUDA tensors (every round in
one launch, a block a scene: for K <= 64 its warps fill a 64 x 64 bit
suppression matrix and one warp runs the rounds on it, above a thread a box
runs each round) and runs its plain PyTorch version,
``geometry/nms.py::lhs_3d_samecls_plain``, on CPU tensors. Counterpart of
``iou3dmatch_tpu/geometry/nms.py::lhs_3d_samecls_jax`` vmapped over the
unlabeled scenes (``losses/unlabeled.py:196-198``).
"""
import torch

from ..geometry.nms import lhs_3d_samecls_plain
from . import _build

MAX_BOXES = 1024  # one thread a box in one block (csrc/lhs.cu kMaxBoxes)
SMALL_BOXES = 64  # up to this K the bit-matrix path (csrc/lhs.cu kSmallBoxes)


def lhs_3d_samecls(mins: torch.Tensor, maxs: torch.Tensor, scores: torch.Tensor,
                   cls: torch.Tensor, thresh: float) -> torch.Tensor:
    """mins, maxs (B, K, 3) f32, scores (B, K) f32, cls (B, K) integer
    classes -> (B, K) bool keep mask (see ``lhs_3d_samecls_plain``)."""
    if mins.dim() != 3 or mins.shape[2] != 3 or maxs.shape != mins.shape \
            or scores.shape != mins.shape[:2] or cls.shape != mins.shape[:2]:
        raise ValueError(
            f"mins, maxs (B, K, 3), scores and cls (B, K) expected, got {tuple(mins.shape)}, "
            f"{tuple(maxs.shape)}, {tuple(scores.shape)} and {tuple(cls.shape)}")
    b, k = scores.shape
    if k > MAX_BOXES:
        raise ValueError(f"LHS takes at most {MAX_BOXES} boxes a scene, got {k}")
    if cls.is_floating_point():
        raise TypeError(f"cls must hold integer classes, got {cls.dtype}")
    if mins.device.type == "cpu":
        return lhs_3d_samecls_plain(mins, maxs, scores, cls, thresh)
    _build.require(mins, torch.float32, "mins")
    _build.require(maxs, torch.float32, "maxs", mins.device)
    _build.require(scores, torch.float32, "scores", mins.device)
    cls = cls.to(torch.int64).contiguous()
    _build.require(cls, torch.int64, "cls", mins.device)
    keep = torch.empty((b, k), dtype=torch.bool, device=mins.device)
    if keep.numel() == 0:
        return keep
    fn = _build.kernel("lhs", "lhs_launch", (_build.VP,) * 5 + (_build.INT,) * 2
                       + (_build.FLOAT, _build.VP))
    _build.check(fn(mins.data_ptr(), maxs.data_ptr(), scores.data_ptr(), cls.data_ptr(),
                    keep.data_ptr(), b, k, thresh, _build.stream(mins)), "lhs")
    lhs_3d_samecls.launches += 1
    return keep


lhs_3d_samecls.launches = 0
