"""Axis-aligned NMS for the host-side eval path, in NumPy.

Counterpart of the NumPy half of ``iou3dmatch_tpu/geometry/nms.py``
(reference ``utils/nms.py:52-165``), without the lower-half-suppression
branch of ``_nms_loop``, which comes with the SSL slice.
"""
import numpy as np


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
