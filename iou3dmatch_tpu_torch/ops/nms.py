"""Greedy non-maximum suppression, on the card.

``nms_boxes`` (the three NMS branches of ``parse_predictions``) and
``nms_masked`` (greedy NMS over an IoU matrix, ``_nms_jax``) launch
``csrc/nms.cu`` on CUDA tensors, every scene of a request in one launch, a
block a scene, and run their plain PyTorch versions,
``geometry/nms.py::nms_boxes_plain`` and ``nms_masked_plain``, on CPU
tensors. Counterparts of the JAX package's host NumPy NMS
(``iou3dmatch_tpu/eval/ap_helper.py:95-135``) and of
``iou3dmatch_tpu/geometry/nms.py::_nms_jax`` (``:170-191``).
"""
import torch

from ..geometry.nms import BOX_MODES, nms_boxes_plain, nms_masked_plain
from . import _build

MAX_BOXES = 256  # csrc/nms.cu kMaxBoxes: the matrix and the boxes in shared memory
MODE_IDS = {"2d": 0, "3d": 1, "3d_cls": 2}  # csrc/nms.cu Mode


def _check_k(k: int) -> None:
    if k > MAX_BOXES:
        raise ValueError(f"NMS takes at most {MAX_BOXES} boxes a scene, got {k}")


def _valid_ptr(valid, shape, device) -> int:
    if valid is None:
        return 0
    if tuple(valid.shape) != tuple(shape):
        raise ValueError(f"valid {tuple(valid.shape)} expected {tuple(shape)}")
    _build.require(valid, torch.bool, "valid", device)
    return valid.data_ptr()


def nms_boxes(mins: torch.Tensor, maxs: torch.Tensor, scores: torch.Tensor, cls, valid,
              mode: str, old_type: bool, thresh: float) -> torch.Tensor:
    """mins, maxs (B, K, 3) f32, scores (B, K) f32, cls (B, K) integer
    classes for ``3d_cls`` (else None), valid (B, K) bool or None -> (B, K)
    bool keep mask (see ``nms_boxes_plain``)."""
    if mode not in BOX_MODES:
        raise ValueError(f"unknown NMS mode {mode!r}; one of {sorted(BOX_MODES)}")
    if mins.dim() != 3 or mins.shape[2] != 3 or maxs.shape != mins.shape \
            or scores.shape != mins.shape[:2]:
        raise ValueError(f"mins, maxs (B, K, 3) and scores (B, K) expected, got "
                         f"{tuple(mins.shape)}, {tuple(maxs.shape)} and {tuple(scores.shape)}")
    if mode == "3d_cls":
        if cls is None or cls.shape != scores.shape:
            raise ValueError("3d_cls needs cls (B, K)")
        if cls.is_floating_point():
            raise TypeError(f"cls must hold integer classes, got {cls.dtype}")
    b, k = scores.shape
    _check_k(k)
    if mins.device.type == "cpu":
        return nms_boxes_plain(mins, maxs, scores, cls, valid, mode, old_type, thresh)
    _build.require(mins, torch.float32, "mins")
    _build.require(maxs, torch.float32, "maxs", mins.device)
    _build.require(scores, torch.float32, "scores", mins.device)
    cls_ptr = 0
    if mode == "3d_cls":
        cls = cls.to(torch.int64).contiguous()
        _build.require(cls, torch.int64, "cls", mins.device)
        cls_ptr = cls.data_ptr()
    valid_ptr = _valid_ptr(valid, (b, k), mins.device)
    keep = torch.empty((b, k), dtype=torch.bool, device=mins.device)
    if keep.numel() == 0:
        return keep
    fn = _build.kernel("nms", "nms_boxes_launch", (_build.VP,) * 6 + (_build.INT,) * 4
                       + (_build.DOUBLE, _build.VP))
    _build.check(fn(mins.data_ptr(), maxs.data_ptr(), scores.data_ptr(), cls_ptr, valid_ptr,
                    keep.data_ptr(), b, k, MODE_IDS[mode], int(bool(old_type)), float(thresh),
                    _build.stream(mins)), "nms")
    nms_boxes.launches += 1
    return keep


nms_boxes.launches = 0


def nms_masked(iou: torch.Tensor, scores: torch.Tensor, thresh: float,
               valid=None) -> torch.Tensor:
    """iou (B, K, K) f32, scores (B, K) f32, valid (B, K) bool or None ->
    (B, K) bool keep mask (see ``nms_masked_plain``)."""
    if iou.dim() != 3 or iou.shape[1] != iou.shape[2] or scores.shape != iou.shape[:2]:
        raise ValueError(f"iou (B, K, K) and scores (B, K) expected, got {tuple(iou.shape)} "
                         f"and {tuple(scores.shape)}")
    b, k = scores.shape
    _check_k(k)
    if iou.device.type == "cpu":
        return nms_masked_plain(iou, scores, thresh, valid)
    _build.require(iou, torch.float32, "iou")
    _build.require(scores, torch.float32, "scores", iou.device)
    valid_ptr = _valid_ptr(valid, (b, k), iou.device)
    keep = torch.empty((b, k), dtype=torch.bool, device=iou.device)
    if keep.numel() == 0:
        return keep
    fn = _build.kernel("nms", "nms_matrix_launch", (_build.VP,) * 4 + (_build.INT,) * 2
                       + (_build.FLOAT, _build.VP))
    _build.check(fn(iou.data_ptr(), scores.data_ptr(), valid_ptr, keep.data_ptr(), b, k,
                    float(thresh), _build.stream(iou)), "nms")
    nms_masked.launches += 1
    return keep


nms_masked.launches = 0
