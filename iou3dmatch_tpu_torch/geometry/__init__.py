"""Box geometry, rotated IoU, chamfer distances and NMS.

Exports the counterpart of each name ``iou3dmatch_tpu/geometry/__init__.py``
exports; where the JAX name says ``_jax``, the port's function has its own
name: ``nms_rotated_jax`` is ``nms_rotated``, ``nms_normal_jax``
``nms_normal`` and ``lhs_3d_samecls_jax`` ``lhs_3d_samecls_plain`` (its
kernel is ``ops/lhs.py::lhs_3d_samecls``).
"""
from .boxes import (box2d_iou, box3d_iou_batch_np, box3d_vol_batch_np, check_valid_corners3d,
                    corners3d_to_parameter, corners_aabb, flip_axis_to_camera,
                    flip_axis_to_depth, get_3d_box_batch_np, get_3d_box_depth_np,
                    get_3d_box_np, get_iou, rot_gpu, roty_np, rotz)
from .iou3d import (box3d_iou_axis_aligned, boxes_iou3d, boxes_iou3d_paired_rows,
                    boxes_iou_bev, boxes_overlap_bev)
from .nms import (lhs_3d_faster_samecls, lhs_3d_samecls_plain, nms_2d, nms_2d_faster,
                  nms_3d_faster, nms_3d_faster_samecls, nms_normal, nms_rotated)
from .nn_distance import (huber_loss, nn_distance, nn_distance_exclude_self,
                          nn_distance_exclude_self_with_cls, nn_distance_inbox,
                          nn_distance_withcls)

__all__ = [
    "boxes_iou3d",
    "boxes_iou_bev",
    "boxes_iou3d_paired_rows",
    "boxes_overlap_bev",
    "box3d_iou_axis_aligned",
    "rotz",
    "rot_gpu",
    "roty_np",
    "get_3d_box_batch_np",
    "get_3d_box_np",
    "get_3d_box_depth_np",
    "flip_axis_to_camera",
    "flip_axis_to_depth",
    "corners_aabb",
    "box3d_vol_batch_np",
    "get_iou",
    "box2d_iou",
    "box3d_iou_batch_np",
    "corners3d_to_parameter",
    "check_valid_corners3d",
    "huber_loss",
    "nn_distance",
    "nn_distance_withcls",
    "nn_distance_exclude_self",
    "nn_distance_exclude_self_with_cls",
    "nn_distance_inbox",
    "nms_2d",
    "nms_2d_faster",
    "nms_rotated",
    "nms_normal",
    "nms_3d_faster",
    "nms_3d_faster_samecls",
    "lhs_3d_faster_samecls",
    "lhs_3d_samecls_plain",
]
