"""Greedy non-maximum suppression, on the card.

``nms_boxes`` (the three NMS branches of ``parse_predictions``) and
``nms_masked`` (greedy NMS over an IoU matrix, ``_nms_jax``) launch
``csrc/nms.cu`` on CUDA tensors: up to MAX_BOXES boxes a scene every scene
of a request in one launch, a thread-block cluster of ``nms_plan``'s size a
scene, the bit matrix in the leader block's shared memory; past it three
launches with the bit matrix in device memory (``_global``). On CPU tensors
they run their plain PyTorch versions, ``geometry/nms.py::nms_boxes_plain``
and ``nms_masked_plain``. Any K on either device, as the JAX package's
host NumPy NMS (``iou3dmatch_tpu/eval/ap_helper.py:95-135``) and
``iou3dmatch_tpu/geometry/nms.py::_nms_jax`` (``:170-191``) take.
"""
import ctypes
from typing import Dict, Optional

import torch

from ..geometry.nms import BOX_MODES, nms_boxes_plain, nms_masked_plain
from . import _build

# csrc/nms.cu kMaxBoxes: the cluster path's leader block holds the scene's
# K x K bit matrix in shared memory up to it; past it the global path
MAX_BOXES = 1024
MODE_IDS = {"2d": 0, "3d": 1, "3d_cls": 2, "matrix": 3}  # csrc/nms.cu Mode
# csrc/nms.cu kSmemMax: the global path's rounds kernel keeps a scene's
# removed, won and -inf masks (3 words of 8 bytes a 64 boxes) beside a
# diagonal block (512 bytes) and a first-box slot (8) in one block's
# shared memory, which bounds K there
SMEM_MAX = 232448
GLOBAL_MAX_BOXES = (SMEM_MAX - 8 - 64 * 8) // (3 * 8) * 64
NMS_CLUSTERS = (1, 2, 4, 8, 16)  # blocks a scene; 16 is the H100's non-portable largest
MIN_ROWS = 16  # rows of the bit matrix a block fills, at least: one a warp


def nms_plan(b: int, k: int, n_sm: int, max_active: Optional[Dict[int, int]] = None) -> int:
    """The cluster size for B scenes of K boxes: the largest of NMS_CLUSTERS
    that gives each block at least MIN_ROWS rows, whose B clusters fit on
    the card's ``n_sm`` SMs at one block an SM, and (where ``max_active``
    gives cudaOccupancyMaxActiveClusters for each size, which depends on
    the mode's shared memory) all run at once; 1 where none does, the
    scenes then running in waves. On an H100 with 8 scenes: 8 from K = 128
    (PERF.md §6: clusters of 16 do not all fit at once)."""
    fits = [c for c in NMS_CLUSTERS
            if c == 1 or (c * MIN_ROWS <= k and b * c <= n_sm
                          and (max_active is None or max_active.get(c, 0) >= b))]
    return max(fits)


_plans = {}


def max_active_clusters(device: torch.device, mode: str, k: int, cluster: int) -> int:
    """cudaOccupancyMaxActiveClusters of csrc/nms.cu in ``mode`` at K boxes a
    scene and clusters of ``cluster`` blocks, on ``device``."""
    fn = _build.kernel("nms", "nms_max_active_clusters",
                       (_build.INT,) * 3 + (ctypes.POINTER(ctypes.c_int),))
    count = ctypes.c_int(0)
    with torch.cuda.device(device):
        _build.check(fn(MODE_IDS[mode], k, cluster, ctypes.byref(count)), "nms occupancy query")
    return count.value


def planned_cluster(device: torch.device, b: int, k: int, mode: str) -> int:
    """``nms_plan`` with ``device``'s SM count and occupancy answers, cached
    per device and shape."""
    key = (device, b, k, mode)
    if key not in _plans:
        answers = {c: max_active_clusters(device, mode, k, c) for c in NMS_CLUSTERS[1:]}
        n_sm = torch.cuda.get_device_properties(device).multi_processor_count
        _plans[key] = nms_plan(b, k, n_sm, answers)
    return _plans[key]


def _launch_cluster(b: int, k: int, mode: str, device, cluster: Optional[int]) -> int:
    """The cluster size of a launch of the cluster path (K <= MAX_BOXES);
    raises for a size the kernel does not take."""
    if cluster is None:
        return planned_cluster(device, b, k, mode)
    if cluster not in NMS_CLUSTERS:
        raise ValueError(f"cluster {cluster} not one of {NMS_CLUSTERS}")
    return cluster


def _no_cluster(cluster: Optional[int], k: int) -> None:
    if cluster is not None:
        raise ValueError(f"cluster sizes are the cluster path's, up to {MAX_BOXES} boxes; "
                         f"{k} boxes take the global path")


def _global(b: int, k: int, device, launch) -> torch.Tensor:
    """The global path past MAX_BOXES: its scratch (each box's position and
    the valid count) and the (B, W, 64 W) u64 bit matrix, W = ceil(K / 64),
    from the caching allocator, then ``launch(keep, scratch, mat)``, which
    returns the C entry's code. Raises, by name, for a K the path cannot
    launch or a matrix the card cannot allocate."""
    if b > 65535 or k > GLOBAL_MAX_BOXES:
        raise ValueError(f"NMS on the card takes at most {GLOBAL_MAX_BOXES} boxes a scene and "
                         f"65,535 scenes a launch past {MAX_BOXES} boxes, got ({b}, {k})")
    words = -(-k // 64)
    keep = torch.empty((b, k), dtype=torch.bool, device=device)
    scratch = torch.empty(b * k + b, dtype=torch.int32, device=device)
    try:
        mat = torch.empty((b, words, 64 * words), dtype=torch.int64, device=device)
    except torch.cuda.OutOfMemoryError as e:
        raise MemoryError(f"NMS over ({b}, {k}) boxes needs a {b * words * 64 * words * 8:,}-byte "
                          f"bit matrix, which the card cannot allocate") from e
    _build.check(launch(keep, scratch, mat), "nms (global matrix)")
    return keep


def _valid_ptr(valid, shape, device) -> int:
    if valid is None:
        return 0
    if tuple(valid.shape) != tuple(shape):
        raise ValueError(f"valid {tuple(valid.shape)} expected {tuple(shape)}")
    _build.require(valid, torch.bool, "valid", device)
    return valid.data_ptr()


def nms_boxes(mins: torch.Tensor, maxs: torch.Tensor, scores: torch.Tensor, cls, valid,
              mode: str, old_type: bool, thresh: float, *,
              cluster: Optional[int] = None) -> torch.Tensor:
    """mins, maxs (B, K, 3) f32, scores (B, K) f32, cls (B, K) integer
    classes for ``3d_cls`` (else None), valid (B, K) bool or None -> (B, K)
    bool keep mask (see ``nms_boxes_plain``). On the card up to MAX_BOXES
    boxes take the cluster path, ``cluster`` overriding the planned cluster
    size (for tests and sweeps); past it the global path, which takes no
    cluster size."""
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
    if b * k == 0:
        return torch.empty((b, k), dtype=torch.bool, device=mins.device)
    if k > MAX_BOXES:
        _no_cluster(cluster, k)
        fn = _build.kernel("nms", "nms_boxes_global_launch", (_build.VP,) * 8 + (_build.INT,) * 4
                           + (_build.DOUBLE, _build.VP))
        keep = _global(b, k, mins.device, lambda keep, scratch, mat: fn(
            mins.data_ptr(), maxs.data_ptr(), scores.data_ptr(), cls_ptr, valid_ptr,
            keep.data_ptr(), scratch.data_ptr(), mat.data_ptr(), b, k, MODE_IDS[mode],
            int(bool(old_type)), float(thresh), _build.stream(mins)))
        nms_boxes.launches += 1
        return keep
    keep = torch.empty((b, k), dtype=torch.bool, device=mins.device)
    cluster = _launch_cluster(b, k, mode, mins.device, cluster)
    fn = _build.kernel("nms", "nms_boxes_launch", (_build.VP,) * 6 + (_build.INT,) * 4
                       + (_build.DOUBLE, _build.INT, _build.VP))
    _build.check(fn(mins.data_ptr(), maxs.data_ptr(), scores.data_ptr(), cls_ptr, valid_ptr,
                    keep.data_ptr(), b, k, MODE_IDS[mode], int(bool(old_type)), float(thresh),
                    cluster, _build.stream(mins)), "nms")
    nms_boxes.launches += 1
    return keep


nms_boxes.launches = 0


def nms_masked(iou: torch.Tensor, scores: torch.Tensor, thresh: float, valid=None, *,
               cluster: Optional[int] = None) -> torch.Tensor:
    """iou (B, K, K) f32, scores (B, K) f32, valid (B, K) bool or None ->
    (B, K) bool keep mask (see ``nms_masked_plain``). On the card past
    MAX_BOXES the global path; ``cluster`` overrides the planned cluster
    size below it."""
    if iou.dim() != 3 or iou.shape[1] != iou.shape[2] or scores.shape != iou.shape[:2]:
        raise ValueError(f"iou (B, K, K) and scores (B, K) expected, got {tuple(iou.shape)} "
                         f"and {tuple(scores.shape)}")
    b, k = scores.shape
    if iou.device.type == "cpu":
        return nms_masked_plain(iou, scores, thresh, valid)
    _build.require(iou, torch.float32, "iou")
    _build.require(scores, torch.float32, "scores", iou.device)
    valid_ptr = _valid_ptr(valid, (b, k), iou.device)
    if b * k == 0:
        return torch.empty((b, k), dtype=torch.bool, device=iou.device)
    if k > MAX_BOXES:
        _no_cluster(cluster, k)
        fn = _build.kernel("nms", "nms_matrix_global_launch", (_build.VP,) * 6 + (_build.INT,) * 2
                           + (_build.FLOAT, _build.VP))
        keep = _global(b, k, iou.device, lambda keep, scratch, mat: fn(
            iou.data_ptr(), scores.data_ptr(), valid_ptr, keep.data_ptr(), scratch.data_ptr(),
            mat.data_ptr(), b, k, float(thresh), _build.stream(iou)))
        nms_masked.launches += 1
        return keep
    keep = torch.empty((b, k), dtype=torch.bool, device=iou.device)
    cluster = _launch_cluster(b, k, "matrix", iou.device, cluster)
    fn = _build.kernel("nms", "nms_matrix_launch", (_build.VP,) * 4 + (_build.INT,) * 2
                       + (_build.FLOAT, _build.INT, _build.VP))
    _build.check(fn(iou.data_ptr(), scores.data_ptr(), valid_ptr, keep.data_ptr(), b, k,
                    float(thresh), cluster, _build.stream(iou)), "nms")
    nms_masked.launches += 1
    return keep


nms_masked.launches = 0
