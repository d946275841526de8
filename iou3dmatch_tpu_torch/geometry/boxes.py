"""Box corner math and frame conversions.

Counterpart of ``iou3dmatch_tpu/geometry/boxes.py`` (reference
``utils/box_util.py`` and ``models/ap_helper.py:28-41``): ``rot_gpu`` and
``corners_aabb`` on tensors for the model and the pseudo labels, the NumPy
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
