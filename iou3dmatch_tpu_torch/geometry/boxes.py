"""Box corner math and frame conversions.

Counterpart of ``iou3dmatch_tpu/geometry/boxes.py`` (reference
``utils/box_util.py`` and ``models/ap_helper.py:28-41``): ``rot_gpu`` and
``corners_aabb`` on tensors for the model and the pseudo labels,
``get_3d_box_batch_tensor`` for the eval decode on the card, and the NumPy
helpers for the host-side eval path.
"""
import numpy as np
import torch


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
