"""Host-side oriented 3D box IoU from 8-corner boxes (upright camera frame).

The port's copy of ``iou3dmatch_tpu/eval/box3d_iou_np.py``, which mirrors
`utils/box_util.py:23-137` (Sutherland–Hodgman polygon clip +
shoelace area + y-extent overlap). Used by the VOC AP greedy matcher
(`utils/eval_det.py:76-78`). The clipped polygon of two convex rectangles is
convex, so its shoelace area equals the reference's ConvexHull area.
"""
import numpy as np


def polygon_clip(subject, clip_poly):
    """Clip ``subject`` by convex ``clip_poly`` (CCW points). Returns vertex
    list or None when empty (box_util.py:23-69, same strict `>` inside test)."""

    def inside(p, cp1, cp2):
        return (cp2[0] - cp1[0]) * (p[1] - cp1[1]) > (cp2[1] - cp1[1]) * (p[0] - cp1[0])

    def intersection(cp1, cp2, s, e):
        dc = (cp1[0] - cp2[0], cp1[1] - cp2[1])
        dp = (s[0] - e[0], s[1] - e[1])
        n1 = cp1[0] * cp2[1] - cp1[1] * cp2[0]
        n2 = s[0] * e[1] - s[1] * e[0]
        n3 = 1.0 / (dc[0] * dp[1] - dc[1] * dp[0])
        return ((n1 * dp[0] - n2 * dc[0]) * n3, (n1 * dp[1] - n2 * dc[1]) * n3)

    output = list(subject)
    cp1 = clip_poly[-1]
    for cp2 in clip_poly:
        inp = output
        output = []
        if not inp:
            return None
        s = inp[-1]
        for e in inp:
            if inside(e, cp1, cp2):
                if not inside(s, cp1, cp2):
                    output.append(intersection(cp1, cp2, s, e))
                output.append(e)
            elif inside(s, cp1, cp2):
                output.append(intersection(cp1, cp2, s, e))
            s = e
        cp1 = cp2
        if len(output) == 0:
            return None
    return output


def poly_area(x, y):
    return 0.5 * np.abs(np.dot(x, np.roll(y, 1)) - np.dot(y, np.roll(x, 1)))


def box3d_vol(corners):
    a = np.sqrt(np.sum((corners[0, :] - corners[1, :]) ** 2))
    b = np.sqrt(np.sum((corners[1, :] - corners[2, :]) ** 2))
    c = np.sqrt(np.sum((corners[0, :] - corners[4, :]) ** 2))
    return a * b * c


def is_clockwise(p):
    """(n,2) polygon points -> True if wound clockwise
    (box_util.py:106-109, shoelace sign)."""
    x, y = p[:, 0], p[:, 1]
    return np.dot(x, np.roll(y, 1)) - np.dot(y, np.roll(x, 1)) > 0


def convex_hull_intersection(p1, p2):
    """Intersection polygon and its area for two convex (x,y) vertex lists
    (box_util.py:77-87). The clip of two convex polygons is convex, so the
    shoelace area equals the reference's scipy ConvexHull volume."""
    inter_p = polygon_clip(p1, p2)
    if inter_p is not None:
        pts = np.array(inter_p)
        return inter_p, poly_area(pts[:, 0], pts[:, 1])
    return None, 0.0


def boxes3d_iou_batch(batch_corners1, batch_corners2):
    """Oriented cross IoU (n,8,3) x (m,8,3), camera frame -> (n,m)
    (box_util.py:152-186). NOTE: kept output-compatible with the reference,
    which normalizes by `box3d_vol_batch`'s sqrt'd edge lengths (see
    geometry.boxes.box3d_vol_batch_np) — use `box3d_iou` per pair for the
    true volumetric IoU."""
    from ..geometry.boxes import box3d_vol_batch_np

    n, m = batch_corners1.shape[0], batch_corners2.shape[0]
    vol1 = box3d_vol_batch_np(batch_corners1)
    vol2 = box3d_vol_batch_np(batch_corners2)
    y_max1, y_min1 = batch_corners1[:, 0, 1], batch_corners1[:, 4, 1]
    y_max2, y_min2 = batch_corners2[:, 0, 1], batch_corners2[:, 4, 1]
    rects1 = [
        [(batch_corners1[j, k, 0], batch_corners1[j, k, 2])
         for k in range(3, -1, -1)]
        for j in range(n)
    ]
    iou = np.zeros((n, m), dtype=np.float32)
    for i in range(m):
        rect2 = [(batch_corners2[i, k, 0], batch_corners2[i, k, 2])
                 for k in range(3, -1, -1)]
        inter_y = np.clip(np.minimum(y_max1, y_max2[i])
                          - np.maximum(y_min1, y_min2[i]), 0.0, None)
        inter_area = np.array([
            convex_hull_intersection(rects1[j], rect2)[1] for j in range(n)
        ], dtype=np.float32)
        inter_vol = inter_y * inter_area
        iou[:, i] = inter_vol / (vol1 + vol2[i] - inter_vol)
    return iou


def box3d_iou(corners1, corners2):
    """(8,3) x (8,3) camera-frame corners -> (iou3d, iou_bev)
    (box_util.py:112-137)."""
    rect1 = [(corners1[i, 0], corners1[i, 2]) for i in range(3, -1, -1)]
    rect2 = [(corners2[i, 0], corners2[i, 2]) for i in range(3, -1, -1)]
    area1 = poly_area(np.array(rect1)[:, 0], np.array(rect1)[:, 1])
    area2 = poly_area(np.array(rect2)[:, 0], np.array(rect2)[:, 1])
    inter = polygon_clip(rect1, rect2)
    if inter is None:
        inter_area = 0.0
    else:
        pts = np.array(inter)
        inter_area = poly_area(pts[:, 0], pts[:, 1])
    iou_2d = inter_area / (area1 + area2 - inter_area)
    ymax = min(corners1[0, 1], corners2[0, 1])
    ymin = max(corners1[4, 1], corners2[4, 1])
    inter_vol = inter_area * max(0.0, ymax - ymin)
    vol1 = box3d_vol(corners1)
    vol2 = box3d_vol(corners2)
    iou = inter_vol / (vol1 + vol2 - inter_vol)
    return iou, iou_2d
