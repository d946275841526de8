"""Greedy non-maximum suppression, on the card.

``nms_boxes`` (the three NMS branches of ``parse_predictions``) and
``nms_masked`` (greedy NMS over an IoU matrix, ``_nms_jax``) launch
``csrc/nms.cu`` on CUDA tensors: up to MAX_BOXES boxes a scene every scene
of a request in one launch, a thread-block cluster of ``nms_plan``'s size a
scene, the bit matrix in the leader block's shared memory; past it, up to
GLOBAL_MAX_BOXES, three launches with the bit matrix in device memory
(``_global``: a sort, the matrix, the rounds of each class segment or
scene, launched as ``global_blocks`` says; ``global_run`` sets it for tests
and sweeps); past GLOBAL_MAX_BOXES they raise by name. On CPU tensors
they run their plain PyTorch versions, ``geometry/nms.py::nms_boxes_plain``
and ``nms_masked_plain``, at any K, as the JAX package's host NumPy NMS
(``iou3dmatch_tpu/eval/ap_helper.py:95-135``) and
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
# csrc/nms.cu kSmemMax and kGlobalMaxBoxes: the global path's sort holds a
# scene's 8-byte keys twice (and a pad word every 32) in one block's shared
# memory, which bounds K there
SMEM_MAX = 232448
GLOBAL_MAX_BOXES = 14016
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


TILE_BLOCKS_PER_SM = 8  # csrc/nms.cu nms_tiles_kernel: 256 threads, ~9 KB, 8 blocks an SM
ROW_WARPS = 8  # csrc/nms.cu kRowsWarps: a warp a row
# the values global_run's blocks takes in the card tests and chip_smoke.py's
# --nms-sweep besides the planned one
GLOBAL_TILE_BLOCKS = (16, 33, 66, 132, 264)
GLOBAL_ROWS_PER_BLOCK = (8, 16, 32, 64, 128)


def global_blocks(b: int, n_sm: int, matrix: bool) -> int:
    """The global path's launch for B scenes on a card of ``n_sm`` SMs: in
    matrix mode the rows kernel's matrix rows a block, a row a warp (the
    fastest of GLOBAL_ROWS_PER_BLOCK at 2,048 and 4,096 boxes, PERF.md §6);
    in the box modes the tile kernel's blocks a scene, one wave of resident
    tile blocks spread over the scenes. (The rounds' blocks, csrc/nms.cu
    kChainBlocksPerSm an SM over the scenes, are planned in the launch.)"""
    if matrix:
        return ROW_WARPS
    return max(1, min(65535, -(-(n_sm * TILE_BLOCKS_PER_SM) // b)))


def _no_cluster(cluster: Optional[int], k: int) -> None:
    if cluster is not None:
        raise ValueError(f"cluster sizes are the cluster path's, up to {MAX_BOXES} boxes; "
                         f"{k} boxes take the global path")


def _entry(lib, symbol: str, argtypes):
    """The C entry ``symbol`` of csrc/nms.cu: the wrapper's library, or
    ``lib`` (another build of the same source) where given."""
    if lib is None:
        return _build.kernel("nms", symbol, argtypes)
    fn = getattr(lib, symbol)
    fn.argtypes, fn.restype = list(argtypes), ctypes.c_int
    return fn


def _global(b: int, k: int, device, lib, launch) -> torch.Tensor:
    """The global path past MAX_BOXES: its scratch (positions, segments,
    the tile list; ``nms_global_scratch_bytes``)
    and the (B, W, 64 W) u64 bit matrix, W = ceil(K / 64), from the caching
    allocator, then ``launch(keep, scratch, mat)``, which returns the C
    entry's code. Raises, by name, for a K the path cannot launch or a
    matrix the card cannot allocate."""
    if b > 65535 or k > GLOBAL_MAX_BOXES:
        raise ValueError(f"NMS on the card takes at most {GLOBAL_MAX_BOXES} boxes a scene and "
                         f"65,535 scenes a launch past {MAX_BOXES} boxes, got ({b}, {k})")
    words = -(-k // 64)
    keep = torch.empty((b, k), dtype=torch.bool, device=device)
    size = _entry(lib, "nms_global_scratch_bytes",
                  (_build.INT, _build.INT, ctypes.POINTER(ctypes.c_longlong)))
    nbytes = ctypes.c_longlong(0)
    _build.check(size(b, k, ctypes.byref(nbytes)), "nms scratch size")
    scratch = torch.empty(nbytes.value, dtype=torch.uint8, device=device)
    try:
        mat = torch.empty((b, words, 64 * words), dtype=torch.int64, device=device)
    except torch.cuda.OutOfMemoryError as e:
        raise MemoryError(f"NMS over ({b}, {k}) boxes needs a {b * words * 64 * words * 8:,}-byte "
                          f"bit matrix, which the card cannot allocate") from e
    _build.check(launch(keep, scratch, mat), "nms (global matrix)")
    return keep


def _global_only(k: int, blocks: Optional[int], lib) -> None:
    """Raises for ``global_run``'s settings where the cluster path runs or
    for a ``blocks`` the launch does not take."""
    if k <= MAX_BOXES and (blocks is not None or lib is not None):
        raise ValueError(f"blocks and lib are the global path's, past {MAX_BOXES} boxes; "
                         f"{k} boxes take the cluster path")
    if blocks is not None and not 1 <= blocks <= 65535:
        raise ValueError(f"global path blocks {blocks} out of range")


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
    size (for tests and sweeps); past it the global path."""
    return _boxes(mins, maxs, scores, cls, valid, mode, old_type, thresh, cluster)


def _boxes(mins, maxs, scores, cls, valid, mode, old_type, thresh, cluster=None, blocks=None,
           lib=None):
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
    _global_only(k, blocks, lib)
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
        if blocks is None:
            n_sm = torch.cuda.get_device_properties(mins.device).multi_processor_count
            blocks = global_blocks(b, n_sm, False)
        fn = _entry(lib, "nms_boxes_global_launch", (_build.VP,) * 8 + (_build.INT,) * 4
                    + (_build.DOUBLE, _build.INT, _build.VP))
        keep = _global(b, k, mins.device, lib, lambda keep, scratch, mat: fn(
            mins.data_ptr(), maxs.data_ptr(), scores.data_ptr(), cls_ptr, valid_ptr,
            keep.data_ptr(), scratch.data_ptr(), mat.data_ptr(), b, k, MODE_IDS[mode],
            int(bool(old_type)), float(thresh), blocks, _build.stream(mins)))
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
    return _masked(iou, scores, thresh, valid, cluster)


def _masked(iou, scores, thresh, valid=None, cluster=None, blocks=None, lib=None):
    if iou.dim() != 3 or iou.shape[1] != iou.shape[2] or scores.shape != iou.shape[:2]:
        raise ValueError(f"iou (B, K, K) and scores (B, K) expected, got {tuple(iou.shape)} "
                         f"and {tuple(scores.shape)}")
    b, k = scores.shape
    _global_only(k, blocks, lib)
    if iou.device.type == "cpu":
        return nms_masked_plain(iou, scores, thresh, valid)
    _build.require(iou, torch.float32, "iou")
    _build.require(scores, torch.float32, "scores", iou.device)
    valid_ptr = _valid_ptr(valid, (b, k), iou.device)
    if b * k == 0:
        return torch.empty((b, k), dtype=torch.bool, device=iou.device)
    if k > MAX_BOXES:
        _no_cluster(cluster, k)
        blocks = ROW_WARPS if blocks is None else blocks
        fn = _entry(lib, "nms_matrix_global_launch", (_build.VP,) * 6 + (_build.INT,) * 2
                    + (_build.FLOAT, _build.INT, _build.VP))
        keep = _global(b, k, iou.device, lib, lambda keep, scratch, mat: fn(
            iou.data_ptr(), scores.data_ptr(), valid_ptr, keep.data_ptr(), scratch.data_ptr(),
            mat.data_ptr(), b, k, float(thresh), blocks, _build.stream(iou)))
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


def global_run(kernel, args, blocks: Optional[int] = None, lib=None) -> torch.Tensor:
    """The card tests' and measurements' hook into the global path:
    ``kernel`` (``nms_boxes`` or ``nms_masked``) on its positional ``args``
    past MAX_BOXES, with ``blocks`` in place of ``global_blocks``' plan
    (the tile kernel's blocks a scene in the box modes, the rows kernel's
    matrix rows a block in matrix mode) and ``lib``'s C entries in place of
    the wrapper's library (csrc/nms.cu built with -DNMS_PHASES, say).
    Counted as a call of ``kernel``; raises where the cluster path runs."""
    return {nms_boxes: _boxes, nms_masked: _masked}[kernel](*args, blocks=blocks, lib=lib)
