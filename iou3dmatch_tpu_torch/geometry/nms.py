"""Axis-aligned NMS and lower-half suppression.

Counterpart of ``iou3dmatch_tpu/geometry/nms.py``: the NumPy NMS of the
host-side eval path (reference ``utils/nms.py:52-165``), and
``lhs_3d_samecls_plain``, the batched tensor form of the on-device
lower-half suppression ``lhs_3d_samecls_jax`` (``nms.py:115-167``) that
dedups the teacher's pseudo labels. ``ops/lhs.py::lhs_3d_samecls`` runs
it on a CPU tensor and launches ``csrc/lhs.cu`` on a CUDA one.
"""
import numpy as np
import torch


def _nms_loop(boxes, overlap_threshold, old_type, same_cls):
    x1, y1, z1 = boxes[:, 0], boxes[:, 1], boxes[:, 2]
    x2, y2, z2 = boxes[:, 3], boxes[:, 4], boxes[:, 5]
    score = boxes[:, 6]
    cls = boxes[:, 7] if same_cls else None
    area = (x2 - x1) * (y2 - y1) * (z2 - z1)

    order = np.argsort(score)
    pick = []
    while order.size != 0:
        i = order[-1]
        pick.append(i)
        rest = order[:-1]
        l = np.maximum(0, np.minimum(x2[i], x2[rest]) - np.maximum(x1[i], x1[rest]))
        w = np.maximum(0, np.minimum(y2[i], y2[rest]) - np.maximum(y1[i], y1[rest]))
        h = np.maximum(0, np.minimum(z2[i], z2[rest]) - np.maximum(z1[i], z1[rest]))
        inter = l * w * h
        if old_type:
            o = inter / area[rest]
        else:
            o = inter / (area[i] + area[rest] - inter)
        if same_cls:
            o = o * (cls[i] == cls[rest])
        inds = np.where(o > overlap_threshold)[0]
        order = np.delete(order, np.concatenate(([order.size - 1], inds)))
    return pick


def nms_2d_faster(boxes, overlap_threshold, old_type=False):
    """boxes: (n, 5) [x1,y1,x2,y2,score] (utils/nms.py:52-83)."""
    x1, y1, x2, y2, score = (boxes[:, k] for k in range(5))
    area = (x2 - x1) * (y2 - y1)
    order = np.argsort(score)
    pick = []
    while order.size != 0:
        i = order[-1]
        pick.append(i)
        rest = order[:-1]
        w = np.maximum(0, np.minimum(x2[i], x2[rest]) - np.maximum(x1[i], x1[rest]))
        h = np.maximum(0, np.minimum(y2[i], y2[rest]) - np.maximum(y1[i], y1[rest]))
        inter = w * h
        if old_type:
            o = inter / area[rest]
        else:
            o = inter / (area[i] + area[rest] - inter)
        order = np.delete(
            order, np.concatenate(([order.size - 1], np.where(o > overlap_threshold)[0]))
        )
    return pick


def nms_3d_faster(boxes, overlap_threshold, old_type=False):
    """boxes: (n, 7) [x1,y1,z1,x2,y2,z2,score] (utils/nms.py:86-122)."""
    return _nms_loop(boxes, overlap_threshold, old_type, False)


def nms_3d_faster_samecls(boxes, overlap_threshold, old_type=False):
    """boxes: (n, 8) [...,score,cls] (utils/nms.py:125-165)."""
    return _nms_loop(boxes, overlap_threshold, old_type, True)


def samecls_iou_aabb(mins: torch.Tensor, maxs: torch.Tensor, cls: torch.Tensor) -> torch.Tensor:
    """The (B, K, K) IoU of each scene's axis-aligned boxes, 0 across
    classes, in the JAX function's order: area (dx dy) dz + 1e-8, IoU
    inter / ((area_i + area_j) - inter), times the class gate."""
    dims = (maxs - mins).clamp(min=0.0)
    area = dims[..., 0] * dims[..., 1] * dims[..., 2] + 1e-8
    side = (torch.minimum(maxs[:, :, None], maxs[:, None])
            - torch.maximum(mins[:, :, None], mins[:, None])).clamp(min=0.0)
    inter = side[..., 0] * side[..., 1] * side[..., 2]
    iou = inter / ((area[:, :, None] + area[:, None]) - inter)
    return iou * (cls[:, :, None] == cls[:, None]).to(iou.dtype)


def lhs_3d_samecls_plain(mins: torch.Tensor, maxs: torch.Tensor, scores: torch.Tensor,
                         cls: torch.Tensor, thresh: float) -> torch.Tensor:
    """Lower-half suppression over the K axis-aligned boxes of each of B
    scenes: mins, maxs (B, K, 3) f32, scores (B, K) f32, cls (B, K)
    integer classes -> (B, K) bool keep mask.

    K fixed rounds, each gated on whether any box remains, with no read
    back to the host: pick the remaining box of highest score (ties to
    the higher index), suppress the remaining boxes of its class whose
    IoU with it exceeds ``thresh``, and keep back the better half of the
    suppressed cluster (rank < n_supp // 2, ties ranked by index). The
    IoU is inter / ((area_i + area_j) - inter) with area (dx dy) dz +
    1e-8, times the class gate, in the order of the JAX function."""
    b, k = scores.shape
    thresh = float(np.float32(thresh))  # compared in f32, as JAX does
    iou = samecls_iou_aabb(mins, maxs, cls)
    idx = torch.arange(k, device=scores.device)
    s_a, s_b = scores[:, :, None], scores[:, None]
    above = (s_a < s_b) | ((s_a == s_b) & (idx[:, None] < idx[None]))  # [a, b]: b ranks above a
    rows = torch.arange(b, device=scores.device)
    remaining = torch.ones((b, k), dtype=torch.bool, device=scores.device)
    keep = torch.zeros_like(remaining)
    for _ in range(k):
        any_left = remaining.any(1, keepdim=True)
        sc = torch.where(remaining, scores, -torch.inf)
        win = (k - 1) - sc.flip(1).argmax(1)  # the last maximum
        hot = idx == win[:, None]
        supp = remaining & (iou[rows, win] > thresh) & ~hot
        n_supp = supp.sum(1, keepdim=True)
        rank = (above & supp[:, None]).sum(2)
        keep = keep | ((hot | (supp & (rank < n_supp // 2))) & any_left)
        remaining = torch.where(any_left, remaining & ~supp & ~hot, remaining)
    return keep
