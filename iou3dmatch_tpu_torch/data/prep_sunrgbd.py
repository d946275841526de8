"""Offline SUN RGB-D export: the ``sunrgbd_trainval`` layout -> per-scene dumps.

The port's copy of ``iou3dmatch_tpu/data/prep_sunrgbd.py`` (reference
``sunrgbd/sunrgbd_data.py`` extract_sunrgbd_data and the label parsing of
``sunrgbd_utils.py``). It reads the layout that the reference's MATLAB step,
or ``prep_sunrgbd_raw.py``, writes:

    sunrgbd_trainval/depth/XXXXXX.mat     point cloud, key 'instance', (N, 6)
    sunrgbd_trainval/label_v1/XXXXXX.txt  one object a line
    sunrgbd_trainval/train_data_idx.txt / val_data_idx.txt

and writes, a scene an index:

    XXXXXX_pc.npz    key 'pc': (num_point, 6) xyz + rgb (0-1), upright depth
    XXXXXX_bbox.npy  (K, 8): centroid, HALF sizes (l, w, h), heading, class
    XXXXXX_votes.npz key 'point_votes': (num_point, 10) = [in-any-box flag,
                     3 vote offsets] (the first vote copied into empty slots)

Given the same files and seed it writes the JAX prep's bytes: one
``random_sampling`` draw a scene that is not skipped, in the index file's
order, and the votes of its loop (JAX ``prep_sunrgbd.py:104-116``) filled
a box at a time instead of a point at a time.

Usage:
    python -m iou3dmatch_tpu_torch.data.prep_sunrgbd --root sunrgbd_trainval \
        --idx_file sunrgbd_trainval/train_data_idx.txt \
        --output_dir sunrgbd_pc_bbox_votes_50k_v1_train --use_v1
"""
import argparse
import os

import numpy as np

from .pc_util import random_sampling, rotz

TYPE2CLASS = {"bed": 0, "table": 1, "sofa": 2, "chair": 3, "toilet": 4, "desk": 5, "dresser": 6,
              "night_stand": 7, "bookshelf": 8, "bathtub": 9}
DEFAULT_TYPE_WHITELIST = tuple(TYPE2CLASS.keys())


class SunObject3d:
    """One line of a label file, as the JAX prep reads it
    (``prep_sunrgbd.py:37-49``): class x y w h cx cy cz l w h ox oy, the
    sizes HALF extents, the heading -atan2(oy, ox). It takes l, w from the
    line's 9th and 10th fields, where ``sunrgbd_calib.SUNObject3d`` takes
    w, l (ROADMAP.md, Queue 3)."""

    def __init__(self, line):
        parts = line.split(" ")
        vals = [float(x) for x in parts[1:]]
        self.classname = parts[0]
        self.centroid = np.array(vals[4:7])
        self.l, self.w, self.h = vals[7], vals[8], vals[9]
        self.heading_angle = -np.arctan2(vals[11], vals[10])


def load_label_objects(label_file):
    with open(label_file) as f:
        return [SunObject3d(line.rstrip()) for line in f if line.rstrip()]


def load_depth_points_mat(depth_file):
    """The ``instance`` array, (N, 6) xyz rgb, of a depth ``.mat`` file (as
    ``sunrgbd_calib.load_depth_points_mat``, which this module does not
    import: it imports torch, and the prep is NumPy and scipy only)."""
    import scipy.io as sio

    return sio.loadmat(depth_file)["instance"]


def compute_box_corners(center, half_size, heading_angle):
    """(8, 3) corners in upright depth coordinates: +-half_size turned by
    rotz(-heading) (sunrgbd_utils.my_compute_box_3d:227-238)."""
    l, w, h = half_size
    x = np.array([-l, l, l, -l, -l, l, l, -l])
    y = np.array([w, w, -w, -w, w, w, -w, -w])
    z = np.array([h, h, h, h, -h, -h, -h, -h])
    corners = rotz(-heading_angle) @ np.stack([x, y, z])
    return (corners + np.asarray(center)[:, None]).T


def points_in_box(pc, center, half_size, heading_angle):
    """Bool mask of the points inside the rotated box, by half-space tests in
    the box's frame (the reference's Delaunay ``in_hull`` on the corners,
    sunrgbd_utils.py:215-225, gives the same set for a box)."""
    local = (pc[:, :3] - np.asarray(center)) @ rotz(-heading_angle)
    half = np.asarray([half_size[0], half_size[1], half_size[2]])
    return np.all(np.abs(local) <= half + 1e-8, axis=1)


def extract_scene(root, data_idx, num_point=50000, use_v1=True,
                  type_whitelist=DEFAULT_TYPE_WHITELIST, rng=None, skip_empty_scene=True):
    """(pc_sub, obbs, point_votes), or None for a skipped scene. A point
    inside boxes votes for the first three in label order: the first box's
    vote fills all three slots, the second's slot 2, every later one's
    slot 3 (each overwriting the last)."""
    label_dir = os.path.join(root, "label_v1" if use_v1 else "label")
    objects = load_label_objects(os.path.join(label_dir, f"{data_idx:06d}.txt"))
    objects = [o for o in objects if o.classname in type_whitelist]
    if skip_empty_scene and not objects:
        return None

    obbs = np.zeros((len(objects), 8))
    for i, obj in enumerate(objects):
        obbs[i, 0:3] = obj.centroid
        obbs[i, 3:6] = [obj.l, obj.w, obj.h]
        obbs[i, 6] = obj.heading_angle
        obbs[i, 7] = TYPE2CLASS[obj.classname]

    pc = load_depth_points_mat(os.path.join(root, "depth", f"{data_idx:06d}.mat"))
    pc_sub = random_sampling(pc, num_point, rng=rng)

    n = pc_sub.shape[0]
    point_votes = np.zeros((n, 10))
    point_vote_idx = np.zeros(n, dtype=np.int32)
    for obj in objects:
        inds = points_in_box(pc_sub, obj.centroid, (obj.l, obj.w, obj.h), obj.heading_angle)
        point_votes[inds, 0] = 1
        rows = np.flatnonzero(inds)
        votes = obj.centroid[None, :] - pc_sub[inds, :3]
        slot = point_vote_idx[rows]
        first = slot == 0
        point_votes[rows[first], 1:10] = np.tile(votes[first], 3)
        point_votes[rows[slot == 1], 4:7] = votes[slot == 1]
        point_votes[rows[slot == 2], 7:10] = votes[slot == 2]
        point_vote_idx[inds] = np.minimum(2, point_vote_idx[inds] + 1)
    return pc_sub, obbs, point_votes


def main(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("--root", default="sunrgbd_trainval")
    p.add_argument("--idx_file", required=True)
    p.add_argument("--output_dir", required=True)
    p.add_argument("--num_point", type=int, default=50000)
    p.add_argument("--use_v1", action="store_true")
    p.add_argument("--no_skip_empty", action="store_true")
    p.add_argument("--seed", type=int, default=0)
    args = p.parse_args(argv)

    os.makedirs(args.output_dir, exist_ok=True)
    rng = np.random.RandomState(args.seed)
    with open(args.idx_file) as f:
        idx_list = [int(line) for line in f if line.strip()]
    for data_idx in idx_list:
        try:
            out = extract_scene(args.root, data_idx, args.num_point, args.use_v1, rng=rng,
                                skip_empty_scene=not args.no_skip_empty)
        except Exception as e:  # the reference's per-scene resilience, reported per scene
            print(f"{data_idx:06d}: FAILED ({e})")
            continue
        if out is None:
            print(f"{data_idx:06d}: empty scene, skipped")
            continue
        pc_sub, obbs, point_votes = out
        np.savez_compressed(os.path.join(args.output_dir, f"{data_idx:06d}_pc.npz"), pc=pc_sub)
        np.save(os.path.join(args.output_dir, f"{data_idx:06d}_bbox.npy"), obbs)
        np.savez_compressed(os.path.join(args.output_dir, f"{data_idx:06d}_votes.npz"),
                            point_votes=point_votes)
        print(f"{data_idx:06d}: done ({len(obbs)} objects)")


if __name__ == "__main__":
    main()
