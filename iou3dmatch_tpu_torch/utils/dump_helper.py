"""Result dumps for visual inspection (PLY files).

The port's copy of ``iou3dmatch_tpu/utils/dump_helper.py`` (reference
``models/dump_helper.py:24-141``), whose files it writes byte for byte: per
scene, the input cloud, seeds, votes, proposal centres and the confident
(objectness > 0.5) predicted boxes. PLY I/O is its own (no plyfile or
trimesh): ASCII PLY for points, a triangulated box mesh for boxes.
``dump_results`` takes NumPy arrays or tensors on any device.
"""
import os

import numpy as np

DUMP_CONF_THRESH = 0.5  # dump boxes with objectness prob above this


# ------------------------------------------------------------------ PLY I/O
def write_ply(points, filename):
    """points: (N, 3) -> ascii ply of vertices (pc_util.write_ply)."""
    points = np.asarray(points)
    with open(filename, "w") as f:
        f.write(
            "ply\nformat ascii 1.0\n"
            f"element vertex {len(points)}\n"
            "property float x\nproperty float y\nproperty float z\n"
            "end_header\n"
        )
        for p in points:
            f.write(f"{p[0]:.6f} {p[1]:.6f} {p[2]:.6f}\n")


def write_ply_rgb(points, colors, filename):
    """points: (N,3), colors: (N,3) uint8."""
    points = np.asarray(points)
    colors = np.asarray(colors).astype(np.uint8)
    with open(filename, "w") as f:
        f.write(
            "ply\nformat ascii 1.0\n"
            f"element vertex {len(points)}\n"
            "property float x\nproperty float y\nproperty float z\n"
            "property uchar red\nproperty uchar green\nproperty uchar blue\n"
            "end_header\n"
        )
        for p, c in zip(points, colors):
            f.write(f"{p[0]:.6f} {p[1]:.6f} {p[2]:.6f} {c[0]} {c[1]} {c[2]}\n")


def write_ply_color(points, labels, filename, num_classes=None):
    """points: (N,3), labels: (N,) ints -> ascii ply colored per label
    (pc_util.write_ply_color semantics; a deterministic HSV-wheel palette
    in place of matplotlib's colormap, so that nothing needs matplotlib)."""
    points = np.asarray(points)
    labels = np.asarray(labels).astype(np.int64)
    n = num_classes or (int(labels.max()) + 1 if labels.size else 1)
    n = max(n, 1)
    # evenly spaced hues at s=v=1 -> rgb palette
    c = np.zeros((n, 3))
    for i in range(n):
        h = (i / n) * 6.0
        x = 1 - abs(h % 2 - 1)
        sector = int(h) % 6
        c[i] = [(1, x, 0), (x, 1, 0), (0, 1, x),
                (0, x, 1), (x, 0, 1), (1, 0, x)][sector]
    colors = (c[np.clip(labels, 0, n - 1)] * 255).astype(np.uint8)
    write_ply_rgb(points, colors, filename)


_BOX_FACES = np.array([
    [0, 1, 2], [0, 2, 3], [4, 6, 5], [4, 7, 6],  # bottom, top
    [0, 4, 5], [0, 5, 1], [1, 5, 6], [1, 6, 2],  # sides
    [2, 6, 7], [2, 7, 3], [3, 7, 4], [3, 4, 0],
])


def _obb_corners(obb):
    """obb: (7,) = cx,cy,cz,dx,dy,dz,heading (full extents) -> (8,3)."""
    cx, cy, cz, dx, dy, dz, heading = [float(v) for v in obb[:7]]
    x = np.array([1, 1, -1, -1, 1, 1, -1, -1]) * dx / 2
    y = np.array([1, -1, -1, 1, 1, -1, -1, 1]) * dy / 2
    z = np.array([-1, -1, -1, -1, 1, 1, 1, 1]) * dz / 2
    c, s = np.cos(heading), np.sin(heading)
    xr = c * x - s * y
    yr = s * x + c * y
    return np.stack([xr + cx, yr + cy, z + cz], axis=1)


def _write_ply_mesh(verts, faces, filename):
    verts = np.asarray(verts)
    faces = np.asarray(faces, dtype=int)
    with open(filename, "w") as f:
        f.write(
            "ply\nformat ascii 1.0\n"
            f"element vertex {len(verts)}\n"
            "property float x\nproperty float y\nproperty float z\n"
            f"element face {len(faces)}\n"
            "property list uchar int vertex_indices\n"
            "end_header\n"
        )
        for v in verts:
            f.write(f"{v[0]:.6f} {v[1]:.6f} {v[2]:.6f}\n")
        for t in faces:
            f.write(f"3 {t[0]} {t[1]} {t[2]}\n")


def _boxes_to_mesh(corner_fn, boxes):
    boxes = np.asarray(boxes)
    verts, faces = [], []
    for i, box in enumerate(boxes):
        verts.append(corner_fn(box))
        faces.append(_BOX_FACES + 8 * i)
    verts = np.concatenate(verts) if verts else np.zeros((0, 3))
    faces = np.concatenate(faces) if faces else np.zeros((0, 3), int)
    return verts, faces


def write_oriented_bbox(obbs, filename):
    """obbs: (K, 7) z-heading -> one ply mesh with a solid box per obb
    (pc_util.write_oriented_bbox:389-425 semantics without trimesh)."""
    verts, faces = _boxes_to_mesh(_obb_corners, np.asarray(obbs).reshape(-1, 7))
    _write_ply_mesh(verts, faces, filename)


def write_bbox(scene_bbox, filename):
    """scene_bbox: (K, 6) = center + lengths, axis-aligned -> ply mesh
    (pc_util.write_bbox:358-387)."""
    boxes = np.asarray(scene_bbox).reshape(-1, 6)
    obbs = np.concatenate([boxes, np.zeros((len(boxes), 1))], axis=1)
    write_oriented_bbox(obbs, filename)


def _obb_corners_camera(obb):
    """obb: (7,) camera frame (y down), heading about the Y axis
    (pc_util.write_oriented_bbox_camera_coord:427-464)."""
    cx, cy, cz, dx, dy, dz, heading = [float(v) for v in obb[:7]]
    x = np.array([1, 1, -1, -1, 1, 1, -1, -1]) * dx / 2
    y = np.array([1, -1, -1, 1, 1, -1, -1, 1]) * dy / 2
    z = np.array([-1, -1, -1, -1, 1, 1, 1, 1]) * dz / 2
    c, s = np.cos(heading), np.sin(heading)
    xr = c * x + s * z
    zr = -s * x + c * z
    return np.stack([xr + cx, y + cy, zr + cz], axis=1)


def write_oriented_bbox_camera_coord(scene_bbox, filename):
    """(K, 7) boxes with heading about +Y (camera coords) -> ply mesh."""
    verts, faces = _boxes_to_mesh(
        _obb_corners_camera, np.asarray(scene_bbox).reshape(-1, 7))
    _write_ply_mesh(verts, faces, filename)


def write_lines_as_cylinders(pcl, filename, rad=0.005, res=64):
    """pcl: (N, 2, 3) segment endpoints -> ply mesh of cylinders
    (pc_util.write_lines_as_cylinders:466+ without trimesh). Each segment
    becomes an open tube with `res` rectangular sections (2*res triangles).
    """
    pcl = np.asarray(pcl).reshape(-1, 2, 3)
    ang = np.linspace(0, 2 * np.pi, res, endpoint=False)
    ring = np.stack([np.cos(ang) * rad, np.sin(ang) * rad,
                     np.zeros(res)], axis=1)  # (res, 3) in local frame
    verts, faces = [], []
    for n, (src, tgt) in enumerate(pcl):
        vec = tgt - src
        length = np.linalg.norm(vec)
        if length < 1e-12:
            z = np.array([0.0, 0.0, 1.0])
        else:
            z = vec / length
        # orthonormal frame around z
        a = np.array([1.0, 0.0, 0.0]) if abs(z[0]) < 0.9 else np.array([0.0, 1.0, 0.0])
        x = np.cross(a, z)
        x /= np.linalg.norm(x)
        y = np.cross(z, x)
        frame = np.stack([x, y, z], axis=1)  # columns
        bottom = ring @ frame.T + src
        top = ring @ frame.T + tgt
        base = 2 * res * n
        verts.append(bottom)
        verts.append(top)
        i = np.arange(res)
        j = (i + 1) % res
        faces.append(np.stack([base + i, base + j, base + res + i], axis=1))
        faces.append(np.stack([base + j, base + res + j, base + res + i], axis=1))
    verts = np.concatenate(verts) if verts else np.zeros((0, 3))
    faces = np.concatenate(faces) if faces else np.zeros((0, 3), int)
    _write_ply_mesh(verts, faces, filename)


# --------------------------------------------------------------- dump_results
def _np(x):
    if hasattr(x, "detach"):  # a tensor, on any device
        return x.detach().cpu().numpy()
    return np.asarray(x)


def softmax(x):
    e = np.exp(x - x.max(axis=-1, keepdims=True))
    return e / e.sum(axis=-1, keepdims=True)


def dump_results(end_points, batch, dump_dir, config, inference_switch=False):
    """Writes each scene's PLYs of its input, seeds, votes, proposals and
    confident predicted boxes, and with GT labels in ``batch`` (and not
    ``inference_switch``) its GT boxes (models/dump_helper.py:24-141)."""
    os.makedirs(dump_dir, exist_ok=True)
    point_clouds = _np(batch["point_clouds"])
    seed_xyz = _np(end_points["seed_xyz"])
    vote_xyz = _np(end_points["vote_xyz"])
    agg_xyz = _np(end_points["aggregated_vote_xyz"])
    center = _np(end_points["center"])
    obj_prob = softmax(_np(end_points["objectness_scores"]))[:, :, 1]
    size = _np(end_points["size"]) * 2.0  # half -> full extents
    heading = _np(end_points["heading"])
    idx_beg = int(_np(batch["scan_idx"])[0]) if "scan_idx" in batch else 0

    b = point_clouds.shape[0]
    for i in range(b):
        pre = os.path.join(dump_dir, f"{idx_beg + i:06d}")
        write_ply(point_clouds[i, :, :3], pre + "_pc.ply")
        write_ply(seed_xyz[i], pre + "_seed_pc.ply")
        write_ply(vote_xyz[i], pre + "_vgen_pc.ply")
        write_ply(agg_xyz[i], pre + "_aggregated_vote_pc.ply")
        write_ply(center[i], pre + "_proposal_pc.ply")
        conf = obj_prob[i] > DUMP_CONF_THRESH
        if conf.any():
            obbs = np.concatenate(
                [center[i][conf], size[i][conf], heading[i][conf, None]], axis=1
            )
            write_oriented_bbox(obbs, pre + "_pred_confident_bbox.ply")
    if not inference_switch and "center_label" in batch:
        for i in range(b):
            pre = os.path.join(dump_dir, f"{idx_beg + i:06d}")
            mask = _np(batch["box_label_mask"])[i] > 0.5
            if mask.any():
                cfg = config
                gt_center = _np(batch["center_label"])[i][mask]
                size_cls = _np(batch["size_class_label"])[i][mask]
                size_res = _np(batch["size_residual_label"])[i][mask]
                gt_size = cfg.mean_size_arr[size_cls] + size_res
                if cfg.num_heading_bin > 1:
                    gt_heading = np.array([
                        cfg.class2angle(int(c), float(r))
                        for c, r in zip(
                            _np(batch["heading_class_label"])[i][mask],
                            _np(batch["heading_residual_label"])[i][mask],
                        )
                    ])
                else:
                    gt_heading = np.zeros(mask.sum())
                obbs = np.concatenate(
                    [gt_center, gt_size, gt_heading[:, None]], axis=1
                )
                write_oriented_bbox(obbs, pre + "_gt_bbox.ply")
