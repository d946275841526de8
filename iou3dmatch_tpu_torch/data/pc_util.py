"""Point-cloud utilities (host side, NumPy).

The port's copy of ``iou3dmatch_tpu/data/pc_util.py`` (reference
``utils/pc_util.py``): ``random_sampling`` (with replacement only when the
cloud holds fewer points than asked for), rotations, voxelization, the
matplotlib drawings and the box helpers. Every function draws the same
calls, in the same order, from the generator it is given as the JAX
package's does, so the two give the same arrays for the same seed.

matplotlib is imported only by the drawings, when they are called; where
it is not installed they raise an ``ImportError`` that names it
(``import_optional``).
"""
import importlib

import numpy as np


def import_optional(name, user):
    """``importlib.import_module(name)``, or an ``ImportError`` naming the
    package and ``user``, the port's file that needs it. No other reader
    stands in for a missing package. The top-level package is imported
    first, so a package marked missing in ``sys.modules`` is refused even
    when its submodule was imported before."""
    try:
        importlib.import_module(name.split(".")[0])
        return importlib.import_module(name)
    except ImportError as e:
        raise ImportError(f"{user} needs the package '{name.split('.')[0]}' for this call, "
                          "and it is not installed") from e


def random_sampling(pc, num_sample, replace=None, return_choices=False, rng=None):
    """pc: (N, C) -> (num_sample, C), drawn with replacement only when the
    cloud holds fewer than ``num_sample`` points (JAX ``pc_util.py:12-20``,
    utils/pc_util.py:35-43)."""
    if replace is None:
        replace = pc.shape[0] < num_sample
    rng = rng if rng is not None else np.random
    choices = rng.choice(pc.shape[0], num_sample, replace=replace)
    if return_choices:
        return pc[choices], choices
    return pc[choices]


def rotz(t):
    """Rotation about the z-axis (JAX ``pc_util.py:23-25``)."""
    c, s = np.cos(t), np.sin(t)
    return np.array([[c, -s, 0], [s, c, 0], [0, 0, 1]])


def roty(t):
    """Rotation about the y-axis (JAX ``pc_util.py:28-31``, utils/pc_util.py:287-293)."""
    c, s = np.cos(t), np.sin(t)
    return np.array([[c, 0, s], [0, 1, 0], [-s, 0, c]])


def roty_batch(t):
    """(...,) angles -> (..., 3, 3) y-rotations (JAX ``pc_util.py:34-44``)."""
    t = np.asarray(t)
    out = np.zeros(t.shape + (3, 3))
    c, s = np.cos(t), np.sin(t)
    out[..., 0, 0] = c
    out[..., 0, 2] = s
    out[..., 1, 1] = 1
    out[..., 2, 0] = -s
    out[..., 2, 2] = c
    return out


def rotate_point_cloud(points, rotation_matrix=None, rng=None):
    """Rotate (n, 3) about the z axis around the centroid; returns
    (rotated, rotation_matrix). The angle is one ``uniform()`` draw
    (JAX ``pc_util.py:47-56``)."""
    if rotation_matrix is None:
        rng = rng if rng is not None else np.random
        angle = rng.uniform() * 2 * np.pi
        s, c = np.sin(angle), np.cos(angle)
        rotation_matrix = np.array([[c, s, 0], [-s, c, 0], [0, 0, 1]])
    ctr = points.mean(axis=0)
    return np.dot(points - ctr, rotation_matrix) + ctr, rotation_matrix


def rotate_pc_along_y(pc, rot_angle):
    """In-place rotation of (N, C >= 3) camera-frame points about y
    (JAX ``pc_util.py:59-65``)."""
    c, s = np.cos(rot_angle), np.sin(rot_angle)
    rotmat = np.array([[c, -s], [s, c]])
    pc[:, [0, 2]] = np.dot(pc[:, [0, 2]], rotmat.T)
    return pc


# ------------------------------------------------------------- voxelization
def _cells(points, radius, cell):
    """Each point's integer cell, floor((p + r) / cell) for points in range."""
    return ((points + radius) / cell).astype(int)


def point_cloud_to_volume(points, vsize, radius=1.0):
    """(N, 3) in [-radius, radius] -> (vsize,)*3 occupancy grid
    (JAX ``pc_util.py:69-77``)."""
    vol = np.zeros((vsize, vsize, vsize))
    loc = _cells(points, radius, 2 * radius / float(vsize))
    vol[loc[:, 0], loc[:, 1], loc[:, 2]] = 1.0
    return vol


def point_cloud_to_volume_batch(point_clouds, vsize=12, radius=1.0, flatten=True):
    """(B, N, 3) -> (B, vsize**3) if flatten else (B,) + (vsize,)*3 + (1,)
    (JAX ``pc_util.py:80-87``)."""
    vols = [point_cloud_to_volume(pc, vsize, radius) for pc in point_clouds]
    if flatten:
        return np.vstack([v.flatten() for v in vols])
    return np.stack(vols)[..., None]


def volume_to_point_cloud(vol):
    """Occupancy grid -> (N, 3) integer cell coordinates (JAX ``pc_util.py:90-95``)."""
    vsize = vol.shape[0]
    assert vol.shape[1] == vsize and vol.shape[2] == vsize
    pts = np.argwhere(vol == 1).astype(float)
    return pts if len(pts) else np.zeros((0, 3))


def _sample_or_pad(pc, num_sample, rng):
    """Sample without replacement if too many, edge-pad if too few
    (JAX ``pc_util.py:98-104``)."""
    if pc.shape[0] > num_sample:
        return random_sampling(pc, num_sample, replace=False, rng=rng)
    if pc.shape[0] < num_sample:
        return np.pad(pc, ((0, num_sample - pc.shape[0]), (0, 0)), "edge")
    return pc


def _cell_sets(points, cells, num_sample, rng):
    """(cell, its points sampled or padded to ``num_sample``) for each
    occupied cell, in the JAX loop's order (the iteration order of a set of
    tuples), so the draws from ``rng`` fall as they do there."""
    for key in {tuple(c) for c in cells}:
        mask = np.all(cells == key, axis=1)
        yield key, _sample_or_pad(points[mask], num_sample, rng)


def point_cloud_to_volume_v2(points, vsize, radius=1.0, num_sample=128, rng=None):
    """(N, 3) -> (vsize, vsize, vsize, num_sample, 3): each voxel's points,
    sampled or edge-padded to num_sample, centred on the voxel and scaled by
    its size (JAX ``pc_util.py:107-120``)."""
    vol = np.zeros((vsize, vsize, vsize, num_sample, 3))
    voxel = 2 * radius / float(vsize)
    for key, pc in _cell_sets(points, _cells(points, radius, voxel), num_sample, rng):
        center = (np.array(key) + 0.5) * voxel - radius
        vol[key] = (pc - center) / voxel
    return vol


def point_cloud_to_volume_v2_batch(point_clouds, vsize=12, radius=1.0, num_sample=128, rng=None):
    """(B, N, 3) -> (B, vsize, vsize, vsize, num_sample, 3) (JAX ``pc_util.py:123-129``)."""
    return np.stack([point_cloud_to_volume_v2(pc, vsize, radius, num_sample, rng)
                     for pc in point_clouds])


def point_cloud_to_image(points, imgsize, radius=1.0, num_sample=128, rng=None):
    """(N, 3) -> (imgsize, imgsize, num_sample, 3): each pixel's (xy cell's)
    points; xy centred and scaled by the pixel, z kept (JAX ``pc_util.py:132-145``)."""
    img = np.zeros((imgsize, imgsize, num_sample, 3))
    pixel = 2 * radius / float(imgsize)
    for key, pc in _cell_sets(points, _cells(points[:, 0:2], radius, pixel), num_sample, rng):
        pc = pc.copy()
        center = (np.array(key) + 0.5) * pixel - radius
        pc[:, 0:2] = (pc[:, 0:2] - center) / pixel
        img[key] = pc
    return img


def point_cloud_to_image_batch(point_clouds, imgsize, radius=1.0, num_sample=128, rng=None):
    """(B, N, 3) -> (B, imgsize, imgsize, num_sample, 3) (JAX ``pc_util.py:148-154``)."""
    return np.stack([point_cloud_to_image(pc, imgsize, radius, num_sample, rng)
                     for pc in point_clouds])


# ------------------------------------------------------------------ drawing
def pyplot_draw_point_cloud(points, output_filename=None):
    """3D scatter of an (N, 3) cloud with matplotlib, saved to
    ``output_filename`` when given (JAX ``pc_util.py:158-174``)."""
    matplotlib = import_optional("matplotlib", "iou3dmatch_tpu_torch/data/pc_util.py")
    matplotlib.use("Agg")
    plt = import_optional("matplotlib.pyplot", "iou3dmatch_tpu_torch/data/pc_util.py")

    fig = plt.figure()
    ax = fig.add_subplot(111, projection="3d")
    ax.scatter(points[:, 0], points[:, 1], points[:, 2])
    ax.set_xlabel("x")
    ax.set_ylabel("y")
    ax.set_zlabel("z")
    if output_filename:
        fig.savefig(output_filename)
    plt.close(fig)


def pyplot_draw_volume(vol, output_filename=None):
    """An occupancy grid drawn as its cells' point cloud (JAX ``pc_util.py:177-180``)."""
    pyplot_draw_point_cloud(volume_to_point_cloud(vol), output_filename)


# ------------------------------------------------------------------- bboxes
def bbox_corner_dist_measure(crnr1, crnr2):
    """Corner-distance similarity in [0, 1] of two boxes given as (8, 3)
    camera-frame corners, the least over the 4 cyclic corner alignments
    (JAX ``pc_util.py:183-197``, utils/pc_util.py:323-344 without its
    debug print)."""
    dist = min(
        np.linalg.norm(
            crnr2[[(x + y) % 4 for x in range(4)]
                  + [4 + (x + y) % 4 for x in range(4)], :] - crnr1,
            axis=1,
        ).sum() / 8.0
        for y in range(4)
    )
    u = sum(np.linalg.norm(x[0, :] - x[6, :]) for x in (crnr1, crnr2)) / 2.0
    return max(1.0 - dist / u, 0)


def point_cloud_to_bbox(points):
    """AABB of (N, 3) or (B, N, 3) -> 6-dim [center, lengths]
    (JAX ``pc_util.py:200-204``)."""
    which_dim = len(points.shape) - 2
    mn, mx = points.min(which_dim), points.max(which_dim)
    return np.concatenate([0.5 * (mn + mx), mx - mn], axis=which_dim)
