"""SUN RGB-D calibration, frames and raw labels (host side, NumPy, scipy).

The port's copy of ``iou3dmatch_tpu/data/sunrgbd_calib.py`` (reference
``sunrgbd/sunrgbd_utils.py`` and the accessors of ``sunrgbd_data.py``):
the five SUN RGB-D coordinate systems (camera, depth, upright depth,
upright camera, image; sunrgbd_utils.py:62-88), the calibration file's
projections, 3D boxes from raw labels, points inside a box (scipy's
Delaunay, as the reference), a Bresenham rasterizer in place of cv2, and
the raw ``sunrgbd_trainval`` accessor with its statistics and viewer.

PIL is imported only where an image is read or written, when that is
called; where it is not installed the call raises an ``ImportError`` that
names it. The offline prep itself is ``prep_sunrgbd.py`` and
``prep_sunrgbd_raw.py``.
"""
import gzip
import os
import pickle

import numpy as np

from ..geometry.boxes import flip_axis_to_camera, flip_axis_to_depth
from .pc_util import import_optional, rotz

_HERE = "iou3dmatch_tpu_torch/data/sunrgbd_calib.py"


def rotx(t):
    """Rotation about the x-axis (JAX ``sunrgbd_calib.py:21-24``, sunrgbd_utils.py:141-148)."""
    c, s = np.cos(t), np.sin(t)
    return np.array([[1, 0, 0], [0, c, -s], [0, s, c]])


def transform_from_rot_trans(R, t):
    """(3, 3) + (3,) -> (4, 4) rigid transform (sunrgbd_utils.py:168-173)."""
    R = np.asarray(R).reshape(3, 3)
    t = np.asarray(t).reshape(3, 1)
    return np.vstack((np.hstack([R, t]), [0, 0, 0, 1]))


def inverse_rigid_trans(Tr):
    """Inverse of a (3, 4) rigid transform [R|t] (sunrgbd_utils.py:175-182)."""
    inv = np.zeros_like(Tr)
    inv[0:3, 0:3] = np.transpose(Tr[0:3, 0:3])
    inv[0:3, 3] = np.dot(-np.transpose(Tr[0:3, 0:3]), Tr[0:3, 3])
    return inv


class SUNObject3d:
    """One raw label line (sunrgbd_utils.py:41-59): class name, 2D box
    (x, y, w, h on disk, kept as x1 y1 x2 y2), centroid, HALF sizes
    (w, l, h) and the heading of the orientation vector, -atan2(oy, ox)."""

    def __init__(self, line):
        data = line.split(" ")
        data[1:] = [float(x) for x in data[1:]]
        self.classname = data[0]
        self.xmin, self.ymin = data[1], data[2]
        self.xmax, self.ymax = data[1] + data[3], data[2] + data[4]
        self.box2d = np.array([self.xmin, self.ymin, self.xmax, self.ymax])
        self.centroid = np.array([data[5], data[6], data[7]])
        self.unused_dimension = np.array([data[8], data[9], data[10]])
        self.w, self.l, self.h = data[8], data[9], data[10]
        self.orientation = np.zeros((3,))
        self.orientation[0] = data[11]
        self.orientation[1] = data[12]
        self.heading_angle = -1 * np.arctan2(self.orientation[1], self.orientation[0])


class SUNRGBD_Calibration:
    """The calibration file's matrices and the frames' projections
    (sunrgbd_utils.py:61-139). The file holds Rtilt (line 1) and K (line 2),
    each flattened column-major. Depth points and 3D labels lie in the
    upright depth frame (z up), 2D boxes in the image frame."""

    def __init__(self, calib_filepath):
        with open(calib_filepath) as f:
            lines = [line.rstrip() for line in f]
        Rtilt = np.array([float(x) for x in lines[0].split(" ")])
        self.Rtilt = np.reshape(Rtilt, (3, 3), order="F")
        K = np.array([float(x) for x in lines[1].split(" ")])
        self.K = np.reshape(K, (3, 3), order="F")
        self.f_u, self.f_v = self.K[0, 0], self.K[1, 1]
        self.c_u, self.c_v = self.K[0, 2], self.K[1, 2]

    def project_upright_depth_to_camera(self, pc):
        """(N, 3) upright depth -> camera (z forward, y down)."""
        pc2 = np.dot(np.transpose(self.Rtilt), np.transpose(pc[:, 0:3]))
        return flip_axis_to_camera(np.transpose(pc2))

    def project_upright_depth_to_image(self, pc):
        """(N, 3) -> ((N, 2) uv, (N,) depth)."""
        pc2 = self.project_upright_depth_to_camera(pc)
        uv = np.dot(pc2, np.transpose(self.K))
        uv[:, 0] /= uv[:, 2]
        uv[:, 1] /= uv[:, 2]
        return uv[:, 0:2], pc2[:, 2]

    def project_upright_depth_to_upright_camera(self, pc):
        return flip_axis_to_camera(pc)

    def project_upright_camera_to_upright_depth(self, pc):
        return flip_axis_to_depth(pc)

    def project_image_to_camera(self, uv_depth):
        """(N, 3) [u, v, depth] -> (N, 3) camera-frame points."""
        n = uv_depth.shape[0]
        x = ((uv_depth[:, 0] - self.c_u) * uv_depth[:, 2]) / self.f_u
        y = ((uv_depth[:, 1] - self.c_v) * uv_depth[:, 2]) / self.f_v
        pts = np.zeros((n, 3))
        pts[:, 0], pts[:, 1], pts[:, 2] = x, y, uv_depth[:, 2]
        return pts

    def project_image_to_upright_camerea(self, uv_depth):
        """Image and depth -> upright camera (the reference's public name,
        typo included, sunrgbd_utils.py:135-139)."""
        pts_depth = flip_axis_to_depth(self.project_image_to_camera(uv_depth))
        pts_upright = np.transpose(np.dot(self.Rtilt, np.transpose(pts_depth)))
        return self.project_upright_depth_to_upright_camera(pts_upright)

    project_image_to_upright_camera = project_image_to_upright_camerea


def read_sunrgbd_label(label_filename):
    """Label file -> list of SUNObject3d (sunrgbd_utils.py:184-187)."""
    with open(label_filename) as f:
        return [SUNObject3d(line.rstrip()) for line in f]


def load_image(img_filename):
    """RGB image as (H, W, 3) uint8, read by PIL (the reference used cv2)."""
    image = import_optional("PIL.Image", _HERE)
    return np.asarray(image.open(img_filename).convert("RGB"))


def load_depth_points(depth_filename):
    return np.loadtxt(depth_filename)


def load_depth_points_mat(depth_filename):
    """The ``instance`` array, (N, 6) xyz rgb, of a depth ``.mat`` file."""
    import scipy.io as sio

    return sio.loadmat(depth_filename)["instance"]


def random_shift_box2d(box2d, shift_ratio=0.1, rng=None):
    """Shift the centre and scale the sides of an image-frame 2D box at
    random, four ``random()`` draws (sunrgbd_utils.py:200-213)."""
    rng = rng if rng is not None else np.random
    r = shift_ratio
    xmin, ymin, xmax, ymax = box2d
    h, w = ymax - ymin, xmax - xmin
    cx, cy = (xmin + xmax) / 2.0, (ymin + ymax) / 2.0
    cx2 = cx + w * r * (rng.random() * 2 - 1)
    cy2 = cy + h * r * (rng.random() * 2 - 1)
    h2 = h * (1 + rng.random() * 2 * r - r)
    w2 = w * (1 + rng.random() * 2 * r - r)
    return np.array([cx2 - w2 / 2.0, cy2 - h2 / 2.0, cx2 + w2 / 2.0, cy2 + h2 / 2.0])


def in_hull(p, hull):
    """(N, 3) points inside the convex hull of (M, 3) points, or of a given
    ``scipy.spatial.Delaunay`` (sunrgbd_utils.py:215-219)."""
    from scipy.spatial import Delaunay

    if not isinstance(hull, Delaunay):
        hull = Delaunay(hull)
    return hull.find_simplex(p) >= 0


def extract_pc_in_box3d(pc, box3d):
    """pc (N, C), box3d (8, 3) -> (the points inside, their bool mask)
    (sunrgbd_utils.py:221-224)."""
    inds = in_hull(pc[:, 0:3], box3d)
    return pc[inds, :], inds


def my_compute_box_3d(center, size, heading_angle):
    """Upright-depth corners of a box of HALF sizes: rotz(-heading) applied
    to the +-size corners (sunrgbd_utils.py:227-238)."""
    R = rotz(-1 * heading_angle)
    l, w, h = size
    x = np.array([-l, l, l, -l, -l, l, l, -l])
    y = np.array([w, w, -w, -w, w, w, -w, -w])
    z = np.array([h, h, h, h, -h, -h, -h, -h])
    return (R @ np.vstack([x, y, z])).T + np.asarray(center)


def compute_box_3d(obj, calib):
    """Raw label object -> ((8, 2) image corners, (8, 3) upright-depth
    corners) (sunrgbd_utils.py:240-271)."""
    corners_3d = my_compute_box_3d(obj.centroid, (obj.l, obj.w, obj.h), obj.heading_angle)
    corners_2d, _ = calib.project_upright_depth_to_image(corners_3d)
    return corners_2d, corners_3d


def compute_orientation_3d(obj, calib):
    """The orientation arrow's end points in image and upright-depth
    coordinates (sunrgbd_utils.py:273-291)."""
    ori = obj.orientation
    orientation_3d = np.array([[0.0, ori[0]], [0.0, ori[1]], [0.0, 0.0]])
    orientation_3d += np.asarray(obj.centroid)[:, None]
    orientation_2d, _ = calib.project_upright_depth_to_image(np.transpose(orientation_3d))
    return orientation_2d, np.transpose(orientation_3d)


def _draw_line(image, p0, p1, color):
    """Bresenham line on an (H, W, 3) uint8 array, clipped to the image."""
    h, w = image.shape[:2]
    x0, y0 = int(p0[0]), int(p0[1])
    x1, y1 = int(p1[0]), int(p1[1])
    dx, dy = abs(x1 - x0), -abs(y1 - y0)
    sx = 1 if x0 < x1 else -1
    sy = 1 if y0 < y1 else -1
    err = dx + dy
    while True:
        if 0 <= x0 < w and 0 <= y0 < h:
            image[y0, x0] = color
        if x0 == x1 and y0 == y1:
            break
        e2 = 2 * err
        if e2 >= dy:
            err += dy
            x0 += sx
        if e2 <= dx:
            err += dx
            y0 += sy


def draw_projected_box3d(image, qs, color=(255, 255, 255), thickness=2):
    """The 12 edges of (8, 2) projected corners drawn on an (H, W, 3) uint8
    image, one pixel wide whatever ``thickness`` says
    (sunrgbd_utils.py:293-316, which drew with cv2)."""
    qs = np.asarray(qs).astype(np.int32)
    for k in range(4):
        _draw_line(image, qs[k], qs[(k + 1) % 4], color)
        _draw_line(image, qs[k + 4], qs[(k + 1) % 4 + 4], color)
        _draw_line(image, qs[k], qs[k + 4], color)
    return image


def save_zipped_pickle(obj, filename, protocol=-1):
    with gzip.open(filename, "wb") as f:
        pickle.dump(obj, f, protocol)


def load_zipped_pickle(filename):
    with gzip.open(filename, "rb") as f:
        return pickle.load(f)


def draw_boxes3d_in_point_cloud(gt_boxes3d, filename, rad=0.01, colors=None):
    """The 12 edges of each (8, 3)-corner box of ``gt_boxes3d`` (n, 8, 3)
    written as a PLY mesh of cylinders (sunrgbd_utils.draw_boxes3d:318-343
    rendered mayavi figures; this mesh opens in MeshLab)."""
    from ..utils.dump_helper import write_lines_as_cylinders

    segments = []
    for b in np.asarray(gt_boxes3d).reshape(-1, 8, 3):
        for k in range(4):
            i, j = k, (k + 1) % 4
            segments.append([b[i], b[j]])
            segments.append([b[i + 4], b[j + 4]])
            segments.append([b[i], b[i + 4]])
    write_lines_as_cylinders(np.array(segments), filename, rad=rad)


class SunrgbdObject:
    """The raw ``sunrgbd_trainval`` layout (sunrgbd/sunrgbd_data.py:31-72):
    image, depth ``.mat``, calib and label files by 6-digit index."""

    def __init__(self, root_dir, split="training", use_v1=False):
        self.root_dir = root_dir
        self.split = split
        assert self.split == "training"
        self.split_dir = root_dir
        self.num_samples = 10335
        self.image_dir = f"{self.split_dir}/image"
        self.calib_dir = f"{self.split_dir}/calib"
        self.depth_dir = f"{self.split_dir}/depth"
        self.label_dir = f"{self.split_dir}/label_v1" if use_v1 else f"{self.split_dir}/label"

    def __len__(self):
        return self.num_samples

    def get_image(self, idx):
        return load_image(f"{self.image_dir}/{idx:06d}.jpg")

    def get_depth(self, idx):
        return load_depth_points_mat(f"{self.depth_dir}/{idx:06d}.mat")

    def get_calibration(self, idx):
        return SUNRGBD_Calibration(f"{self.calib_dir}/{idx:06d}.txt")

    def get_label_objects(self, idx):
        return read_sunrgbd_label(f"{self.label_dir}/{idx:06d}.txt")


sunrgbd_object = SunrgbdObject  # the reference's class name (sunrgbd_data.py:31)

DEFAULT_TYPE_WHITELIST = ["bed", "table", "sofa", "chair", "toilet", "desk", "dresser",
                          "night_stand", "bookshelf", "bathtub"]


def get_box3d_dim_statistics(idx_filename, root_dir="./sunrgbd_trainval",
                             type_whitelist=DEFAULT_TYPE_WHITELIST, save_path=None):
    """Each whitelisted class's median (l, w, h) over the raw labels of the
    listed frames (sunrgbd_data.py:264-305); with ``save_path``, the class
    names, dimensions and headings pickled one after another."""
    dataset = SunrgbdObject(root_dir)
    dimension_list, type_list, ry_list = [], [], []
    with open(idx_filename) as f:
        indices = [int(line.rstrip()) for line in f]
    for data_idx in indices:
        for obj in dataset.get_label_objects(data_idx):
            if obj.classname not in type_whitelist:
                continue
            dimension_list.append(np.array([obj.l, obj.w, obj.h]))
            type_list.append(obj.classname)
            ry_list.append(-1 * np.arctan2(obj.orientation[1], obj.orientation[0]))

    if save_path is not None:
        with open(save_path, "wb") as fp:
            pickle.dump(type_list, fp)
            pickle.dump(dimension_list, fp)
            pickle.dump(ry_list, fp)

    medians = {}
    for class_type in sorted(set(type_list)):
        dims = [d for d, t in zip(dimension_list, type_list) if t == class_type]
        medians[class_type] = np.median(np.stack(dims), axis=0)
    return medians


def data_viz(data_dir, dump_dir="data_viz_dump", idx=1):
    """One raw SUN RGB-D frame for the eye (sunrgbd_data.py:74-137 without
    cv2 or mayavi): the image with the cloud's projection coloured by
    depth, the image with the 2D and projected 3D label boxes, and the
    cloud and the 3D boxes as PLY."""
    from ..utils.dump_helper import write_ply

    image = import_optional("PIL.Image", _HERE)
    os.makedirs(dump_dir, exist_ok=True)
    dataset = SunrgbdObject(data_dir)
    pc = dataset.get_depth(idx)
    calib = dataset.get_calibration(idx)
    uv, d = calib.project_upright_depth_to_image(pc[:, 0:3])

    img = dataset.get_image(idx).copy()
    h, w = img.shape[:2]
    u = np.round(uv[:, 0]).astype(int)
    v = np.round(uv[:, 1]).astype(int)
    ok = (u >= 0) & (u < w) & (v >= 0) & (v < h) & (d > 0)
    depth_norm = np.clip(120.0 / np.maximum(d[ok], 1e-6), 0, 255) / 255.0
    colors = np.stack([depth_norm, 1 - depth_norm, np.abs(0.5 - depth_norm) * 2], axis=1) * 255
    img[v[ok], u[ok]] = colors.astype(np.uint8)
    image.fromarray(img).save(f"{dump_dir}/img_depth.jpg")

    img2 = dataset.get_image(idx).copy()
    boxes3d = []
    for obj in dataset.get_label_objects(idx):
        for x in (int(obj.xmin), int(obj.xmax)):
            _draw_line(img2, (x, obj.ymin), (x, obj.ymax), (0, 255, 0))
        for y in (int(obj.ymin), int(obj.ymax)):
            _draw_line(img2, (obj.xmin, y), (obj.xmax, y), (0, 255, 0))
        box3d_pts_2d, box3d_pts_3d = compute_box_3d(obj, calib)
        draw_projected_box3d(img2, box3d_pts_2d, color=(255, 0, 0))
        boxes3d.append(box3d_pts_3d)
    image.fromarray(img2).save(f"{dump_dir}/img_boxes.jpg")

    write_ply(pc[:, 0:3], f"{dump_dir}/pc.ply")
    if boxes3d:
        draw_boxes3d_in_point_cloud(np.stack(boxes3d), f"{dump_dir}/label_boxes.ply")
