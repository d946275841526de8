"""Box corner math and frame conversions.

Counterpart of ``iou3dmatch_tpu/geometry/boxes.py`` (reference
``utils/box_util.py`` and ``models/ap_helper.py:28-41``): ``rot_gpu`` and
``corners_aabb`` on tensors for the model and the pseudo labels,
``get_3d_box_batch_tensor`` for the eval decode on the card, and the NumPy
helpers for the host-side eval path and the library surface (the 2D IoU of
``get_iou`` and ``box2d_iou``, the paired axis-aligned IoU of corners,
``corners3d_to_parameter``, ``check_valid_corners3d``).
"""
import numpy as np
import torch


def rotz(t):
    """NumPy z-rotation matrix (utils/box_util.py:256-263)."""
    c, s = np.cos(t), np.sin(t)
    return np.array([[c, -s, 0], [s, c, 0], [0, 0, 1]])


def roty_np(t):
    """NumPy y-rotation matrix (utils/box_util.py:266-272)."""
    c, s = np.cos(t), np.sin(t)
    return np.array([[c, 0, s], [0, 1, 0], [-s, 0, c]])


def rot_gpu(t: torch.Tensor) -> torch.Tensor:
    """Batched upright-axis rotation matrices, (...,) -> (..., 3, 3).

    R = [[c, s, 0], [-s, c, 0], [0, 0, 1]] (utils/box_util.py:292-306);
    callers multiply by R^T to rotate points counter-clockwise."""
    c, s = torch.cos(t), torch.sin(t)
    z, o = torch.zeros_like(t), torch.ones_like(t)
    return torch.stack([
        torch.stack([c, s, z], -1),
        torch.stack([-s, c, z], -1),
        torch.stack([z, z, o], -1),
    ], dim=-2)


def corners_aabb(center: torch.Tensor, size: torch.Tensor, heading: torch.Tensor):
    """Axis-aligned bounds of boxes rotated about z, in the depth frame
    (JAX ``geometry/boxes.py:222-240``): center and size (..., 3), heading
    (...,) -> (mins, maxs), each (..., 3). The half extents are
    ``hx |cos| + hy |sin|`` and ``hx |sin| + hy |cos|``, in that order.
    The reference takes camera-frame corner bounds on the host
    (``loss_helper_unlabeled.py:441-490``), an axis permutation that
    leaves the IoU of the bounds unchanged."""
    hx, hy, hz = size[..., 0] * 0.5, size[..., 1] * 0.5, size[..., 2] * 0.5
    c, s = torch.cos(heading).abs(), torch.sin(heading).abs()
    half = torch.stack([hx * c + hy * s, hx * s + hy * c, hz], -1)
    return center - half, center + half


def roty_batch_np(t):
    """utils/box_util.py:275-289."""
    out = np.zeros(tuple(list(t.shape) + [3, 3]))
    c, s = np.cos(t), np.sin(t)
    out[..., 0, 0] = c
    out[..., 0, 2] = s
    out[..., 1, 1] = 1
    out[..., 2, 0] = -s
    out[..., 2, 2] = c
    return out


def get_3d_box_np(box_size, heading_angle, center):
    """One box's upright-camera corners, (8, 3) (utils/box_util.py:335-358)."""
    R = roty_batch_np(np.asarray(heading_angle))
    l, w, h = box_size[0], box_size[1], box_size[2]
    x = np.array([l, l, -l, -l, l, l, -l, -l]) / 2.0
    y = np.array([h, h, h, h, -h, -h, -h, -h]) / 2.0
    z = np.array([w, -w, -w, w, w, -w, -w, w]) / 2.0
    corners = np.stack([x, y, z], axis=-1) @ R.T
    return corners + np.asarray(center)


def get_3d_box_depth_np(box_size, heading_angle, center):
    """One box's corners in the depth frame (z up, heading about z), (8, 3)
    (utils/box_util.py:309-332)."""
    R = rotz(heading_angle)
    l, w, h = box_size[0], box_size[1], box_size[2]
    x = np.array([l, l, -l, -l, l, l, -l, -l]) / 2.0
    y = np.array([w, -w, -w, w, w, -w, -w, w]) / 2.0
    z = np.array([h, h, h, h, -h, -h, -h, -h]) / 2.0
    return (R @ np.vstack([x, y, z])).T + np.asarray(center)


def get_3d_box_batch_np(box_size, heading_angle, center):
    """Batched corner generation in the upright-camera frame.

    box_size: (..., 3), heading_angle: (...,), center: (..., 3)
    -> (..., 8, 3). Mirrors `get_3d_box_batch` (utils/box_util.py:361-381).
    """
    R = roty_batch_np(heading_angle)
    l = np.expand_dims(box_size[..., 0], -1)
    w = np.expand_dims(box_size[..., 1], -1)
    h = np.expand_dims(box_size[..., 2], -1)
    shape = list(heading_angle.shape) + [8, 3]
    corners = np.zeros(shape)
    corners[..., :, 0] = np.concatenate(
        (l / 2, l / 2, -l / 2, -l / 2, l / 2, l / 2, -l / 2, -l / 2), -1
    )
    corners[..., :, 1] = np.concatenate(
        (h / 2, h / 2, h / 2, h / 2, -h / 2, -h / 2, -h / 2, -h / 2), -1
    )
    corners[..., :, 2] = np.concatenate(
        (w / 2, -w / 2, -w / 2, w / 2, w / 2, -w / 2, -w / 2, w / 2), -1
    )
    tlist = list(range(len(heading_angle.shape))) + [
        len(heading_angle.shape) + 1,
        len(heading_angle.shape),
    ]
    corners = np.matmul(corners, np.transpose(R, tuple(tlist)))
    corners += np.expand_dims(center, -2)
    return corners


def flip_axis_to_camera(pc):
    """Depth (X-right, Y-fwd, Z-up) -> camera (X-right, Y-down, Z-fwd)
    (models/ap_helper.py:28-35)."""
    x, y, z = pc[..., 0], pc[..., 1], pc[..., 2]
    return np.stack([x, -z, y], axis=-1)


def flip_axis_to_depth(pc):
    """Inverse of ``flip_axis_to_camera`` (models/ap_helper.py:37-41)."""
    x, y, z = pc[..., 0], pc[..., 1], pc[..., 2]
    return np.stack([x, z, -y], axis=-1)


def box3d_vol_batch_np(corners):
    """(n, 8, 3) corners -> (n,) products of the square roots of the edge
    lengths, as ``box3d_vol_batch`` (utils/box_util.py:98-104) computes
    them: (l w h) ** 0.5 for a cuboid, not its volume. Kept as the
    reference has it because ``boxes3d_iou_batch`` divides by it; the
    volume is ``eval/box3d_iou_np.py::box3d_vol`` of each box."""
    l = np.sqrt(np.linalg.norm(corners[:, 1, :] - corners[:, 2, :], axis=1))
    w = np.sqrt(np.linalg.norm(corners[:, 0, :] - corners[:, 1, :], axis=1))
    h = np.sqrt(np.linalg.norm(corners[:, 0, :] - corners[:, 4, :], axis=1))
    return l * w * h


def get_iou(bb1, bb2):
    """Axis-aligned 2D IoU of dict boxes {'x1', 'y1', 'x2', 'y2'}
    (utils/box_util.py:189-237); raises on a box with x1 >= x2 or
    y1 >= y2. Not ``eval/eval_det.py::get_iou``, the 3D IoU of
    (center, lengths) boxes."""
    for bb in (bb1, bb2):
        if not (bb["x1"] < bb["x2"] and bb["y1"] < bb["y2"]):
            raise ValueError(f"get_iou needs x1 < x2 and y1 < y2, got {bb}")
    x_left = max(bb1["x1"], bb2["x1"])
    y_top = max(bb1["y1"], bb2["y1"])
    x_right = min(bb1["x2"], bb2["x2"])
    y_bottom = min(bb1["y2"], bb2["y2"])
    if x_right < x_left or y_bottom < y_top:
        return 0.0
    inter = (x_right - x_left) * (y_bottom - y_top)
    area1 = (bb1["x2"] - bb1["x1"]) * (bb1["y2"] - bb1["y1"])
    area2 = (bb2["x2"] - bb2["x1"]) * (bb2["y2"] - bb2["y1"])
    return inter / float(area1 + area2 - inter)


def box2d_iou(box1, box2):
    """(xmin, ymin, xmax, ymax) tuples -> IoU (utils/box_util.py:240-250)."""
    return get_iou({"x1": box1[0], "y1": box1[1], "x2": box1[2], "y2": box1[3]},
                   {"x1": box2[0], "y1": box2[1], "x2": box2[2], "y2": box2[3]})


def box3d_iou_batch_np(corners1, corners2):
    """Paired axis-aligned IoU of (..., 8, 3) corner arrays -> (...,)
    (utils/box_util.py:384-411); the tensor form is
    ``geometry/iou3d.py::box3d_iou_axis_aligned``."""
    max_a, max_b = np.max(corners1, axis=-2), np.max(corners2, axis=-2)
    min_a, min_b = np.min(corners1, axis=-2), np.min(corners2, axis=-2)
    vol_a = (max_a - min_a).prod(axis=-1)
    vol_b = (max_b - min_b).prod(axis=-1)
    inter = np.clip(np.minimum(max_a, max_b) - np.maximum(min_a, min_b), 0, None).prod(axis=-1)
    return inter / (vol_a + vol_b - inter + 1e-8)


def corners3d_to_parameter(corners_3d):
    """(8, 3) upright-camera corners -> (7,) depth-frame box
    [cx, cy, cz, l, w, h, heading] (utils/box_util.py:442-469)."""
    center = 0.5 * (corners_3d.max(0) + corners_3d.min(0))
    x_side = corners_3d[0] - corners_3d[3]
    y_side = corners_3d[0] - corners_3d[4]
    z_side = corners_3d[0] - corners_3d[1]
    l = np.linalg.norm(x_side)
    w = np.linalg.norm(z_side)
    h = np.linalg.norm(y_side)
    heading_angle = np.arccos(x_side[0] / l)
    return np.concatenate([[center[0], center[2], -center[1]], [l, w, h], [heading_angle]])


def check_valid_corners3d(corners_3d):
    """True iff the (8, 3) corners form a rectangular cuboid within the
    reference's tolerances (utils/box_util.py:472-521): parallel edges
    equal to 2 decimals, the edges at corner 0 perpendicular to 1 decimal,
    and not all near zero. ``npt.assert_almost_equal(decimal=d)`` passes
    below 1.5 * 10 ** -d."""
    c = np.asarray(corners_3d, dtype=float)
    x_lines = np.stack([c[0] - c[3], c[1] - c[2], c[4] - c[7], c[5] - c[6]])
    y_lines = np.stack([c[0] - c[4], c[1] - c[5], c[3] - c[7], c[2] - c[6]])
    z_lines = np.stack([c[0] - c[1], c[4] - c[5], c[3] - c[2], c[7] - c[6]])
    lengths = np.stack([np.linalg.norm(x_lines, axis=1), np.linalg.norm(y_lines, axis=1),
                        np.linalg.norm(z_lines, axis=1)], axis=1)  # (4, 3)
    if np.all(np.abs(lengths[0]) < 1.5e-1):
        return False  # a degenerate, near-zero box
    for i in range(4):
        for j in range(i + 1, 4):
            if not np.all(np.abs(lengths[i] - lengths[j]) < 1.5e-2):
                return False
    e_y, e_z, e_x = c[0] - c[4], c[0] - c[1], c[0] - c[3]
    for a, b in ((e_y, e_z), (e_y, e_x), (e_z, e_x)):
        if not abs(a @ b) < 1.5e-1:
            return False
    return True


# the unit corners of get_3d_box_batch_np: signs of l, h and w for x, y, z
_CORNER_SIGNS = ((1, 1, -1, -1, 1, 1, -1, -1), (1, 1, 1, 1, -1, -1, -1, -1),
                 (1, -1, -1, 1, 1, -1, -1, 1))


def get_3d_box_batch_tensor(box_size: torch.Tensor, heading_angle: torch.Tensor,
                            center: torch.Tensor) -> torch.Tensor:
    """``get_3d_box_batch_np`` on tensors, on their device: box_size (..., 3)
    full extents, heading_angle (...,), center (..., 3) upright-camera ->
    (..., 8, 3), in the inputs' dtype (the eval decode passes float64, as
    NumPy computes it). The corners are (x cos + z sin, y, z cos - x sin)
    plus the center, the rotation about y of ``roty_batch_np``."""
    signs = torch.tensor(_CORNER_SIGNS, dtype=box_size.dtype, device=box_size.device)
    half = box_size / 2.0
    x = signs[0] * half[..., 0:1]
    y = signs[1] * half[..., 2:3]
    z = signs[2] * half[..., 1:2]
    c, s = torch.cos(heading_angle)[..., None], torch.sin(heading_angle)[..., None]
    corners = torch.stack([x * c + z * s, y, z * c - x * s], dim=-1)
    return corners + center[..., None, :]
