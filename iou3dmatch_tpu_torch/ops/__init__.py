"""Point-cloud primitives of the PyTorch port.

Counterparts of ``iou3dmatch_tpu/ops``. FPS, ball query, the grouping
gather, ``three_nn`` and ``three_interpolate`` launch hand-written CUDA
kernels (``csrc/``) on CUDA tensors and run their plain PyTorch versions on CPU tensors; so do
lower-half suppression (``ops/lhs.py``) and the rotated IoU
(``geometry/iou3d.py``).
"""
from .ball_query import ball_query, group_points
from .fps import furthest_point_sample
from .interpolate import three_interpolate, three_nn
from .sampling import gather_points

__all__ = [
    "ball_query",
    "furthest_point_sample",
    "gather_points",
    "group_points",
    "three_interpolate",
    "three_nn",
]
