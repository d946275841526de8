"""SUN RGB-D detection datasets (supervised + SSL labeled/unlabeled).

Mirrors `sunrgbd/sunrgbd_detection_dataset.py:43-246` and
`sunrgbd/sunrgbd_ssl_dataset.py:26-312`: per-scan {scan}_pc.npz (Nx6),
{scan}_bbox.npy (K, 8: cx cy cz hl hw hh heading cls — sizes on disk are
HALF extents, x2 before size2class!), {scan}_votes.npz (Nx10: mask + 3
votes). Augmentation: 50% x-flip (heading -> pi - heading), +/-30deg
z-rotation (votes rotated through endpoints), optional color jitter, global
scale 0.85-1.15. Point sampling happens AFTER label building. 12 heading
bins. RNG draw order matches the reference.

The port's copy of ``iou3dmatch_tpu/data/sunrgbd.py:1-307``, NumPy only,
each ``__getitem__`` bit for bit the JAX one after the same
``np.random.seed``. The floor percentile always runs natively
(``native/loader.py``); ``viz_votes``, ``viz_obb`` and
``get_sem_cls_statistics`` wait for ``utils/dump_helper.py``.
"""
import os

import numpy as np

from ..native.loader import percentile_native
from .config import SunrgbdConfig
from .pc_util import random_sampling, rotz

DC = SunrgbdConfig()
MAX_NUM_OBJ = 64
MEAN_COLOR_RGB = np.array([0.5, 0.5, 0.5])


def _load_scan(data_path, scan_name):
    pc = np.load(os.path.join(data_path, scan_name) + "_pc.npz")["pc"]
    bboxes = np.load(os.path.join(data_path, scan_name) + "_bbox.npy")
    votes = np.load(os.path.join(data_path, scan_name) + "_votes.npz")["point_votes"]
    return pc, bboxes, votes


def _prep_cloud(point_cloud, use_color, use_height):
    if not use_color:
        pc = point_cloud[:, 0:3]
    else:
        pc = point_cloud[:, 0:6].copy()
        pc[:, 3:] = pc[:, 3:] - MEAN_COLOR_RGB
    if use_height:
        floor_height = percentile_native(pc[:, 2], 0.99)
        if floor_height is None:
            floor_height = np.percentile(pc[:, 2], 0.99)
        height = pc[:, 2] - floor_height
        pc = np.concatenate([pc, np.expand_dims(height, 1)], 1)
    return pc


def _augment(point_cloud, bboxes, point_votes, use_color, use_height,
             flip_boxes=True):
    """Shared augmentation (sunrgbd_detection_dataset.py:154-200). Returns
    (flip_x_axis, rot_mat, rot_angle, scale_ratio)."""
    flip_x_axis = 0
    if np.random.random() > 0.5:
        flip_x_axis = 1
        point_cloud[:, 0] = -1 * point_cloud[:, 0]
        if flip_boxes:
            bboxes[:, 0] = -1 * bboxes[:, 0]
            bboxes[:, 6] = np.pi - bboxes[:, 6]
        point_votes[:, [1, 4, 7]] = -1 * point_votes[:, [1, 4, 7]]

    rot_angle = (np.random.random() * np.pi / 3) - np.pi / 6  # -30 ~ +30 deg
    rot_mat = rotz(rot_angle)
    votes_end = np.zeros_like(point_votes)
    for a, b in ((1, 4), (4, 7), (7, 10)):
        votes_end[:, a:b] = np.dot(
            point_cloud[:, 0:3] + point_votes[:, a:b], np.transpose(rot_mat)
        )
    point_cloud[:, 0:3] = np.dot(point_cloud[:, 0:3], np.transpose(rot_mat))
    if flip_boxes:
        bboxes[:, 0:3] = np.dot(bboxes[:, 0:3], np.transpose(rot_mat))
        bboxes[:, 6] -= rot_angle
    for a, b in ((1, 4), (4, 7), (7, 10)):
        point_votes[:, a:b] = votes_end[:, a:b] - point_cloud[:, 0:3]

    if use_color:
        rgb = point_cloud[:, 3:6] + MEAN_COLOR_RGB
        rgb *= 1 + 0.4 * np.random.random(3) - 0.2
        rgb += 0.1 * np.random.random(3) - 0.05
        rgb += np.expand_dims(0.05 * np.random.random(point_cloud.shape[0]) - 0.025, -1)
        rgb = np.clip(rgb, 0, 1)
        rgb *= np.expand_dims(np.random.random(point_cloud.shape[0]) > 0.3, -1)
        point_cloud[:, 3:6] = rgb - MEAN_COLOR_RGB

    scale_ratio = np.random.random() * 0.3 + 0.85
    scale_ratio = np.expand_dims(np.tile(scale_ratio, 3), 0)
    point_cloud[:, 0:3] *= scale_ratio
    if flip_boxes:
        bboxes[:, 0:3] *= scale_ratio
        bboxes[:, 3:6] *= scale_ratio
    for a, b in ((1, 4), (4, 7), (7, 10)):
        point_votes[:, a:b] *= scale_ratio
    if use_height:
        point_cloud[:, -1] *= scale_ratio[0, 0]
    return flip_x_axis, rot_mat, rot_angle, scale_ratio


def _box_labels(bboxes):
    target_bboxes = np.zeros((MAX_NUM_OBJ, 6))
    target_bboxes_mask = np.zeros((MAX_NUM_OBJ))
    angle_classes = np.zeros((MAX_NUM_OBJ,))
    angle_residuals = np.zeros((MAX_NUM_OBJ,))
    size_classes = np.zeros((MAX_NUM_OBJ,))
    size_residuals = np.zeros((MAX_NUM_OBJ, 3))
    semcls = np.zeros((MAX_NUM_OBJ))
    target_bboxes_mask[0 : bboxes.shape[0]] = 1
    target_bboxes[0 : bboxes.shape[0], :] = bboxes[:, 0:6]
    for i in range(bboxes.shape[0]):
        bbox = bboxes[i]
        semantic_class = bbox[7]
        angle_class, angle_residual = DC.angle2class(bbox[6])
        box3d_size = bbox[3:6] * 2  # half-extents on disk!
        size_class, size_residual = DC.size2class(
            box3d_size, DC.class2type[semantic_class]
        )
        angle_classes[i] = angle_class
        angle_residuals[i] = angle_residual
        size_classes[i] = size_class
        size_residuals[i] = size_residual
        semcls[i] = semantic_class
    return (target_bboxes, target_bboxes_mask, angle_classes, angle_residuals,
            size_classes, size_residuals, semcls)


def _label_dict(idx, point_cloud, point_votes, choices, labels):
    (target_bboxes, mask, acls, ares, scls, sres, semcls) = labels
    votes_mask = point_votes[choices, 0]
    votes = point_votes[choices, 1:]
    return {
        "point_clouds": point_cloud.astype(np.float32),
        "center_label": target_bboxes.astype(np.float32)[:, 0:3],
        "heading_class_label": acls.astype(np.int64),
        "heading_residual_label": ares.astype(np.float32),
        "size_class_label": scls.astype(np.int64),
        "size_residual_label": sres.astype(np.float32),
        "sem_cls_label": semcls.astype(np.int64),
        "box_label_mask": mask.astype(np.float32),
        "vote_label": votes.astype(np.float32),
        "vote_label_mask": votes_mask.astype(np.int64),
        "scan_idx": np.array(idx).astype(np.int64),
        "supervised_mask": np.array(1).astype(np.int64),
    }


class SunrgbdDetectionVotesDataset:
    """Supervised dataset (sunrgbd_detection_dataset.py:43-246)."""

    def __init__(self, data_path, split_dir=None, labeled_sample_list=None,
                 num_points=20000, use_color=False, use_height=False, augment=False):
        assert num_points <= 50000
        self.data_path = data_path
        self.scan_names = sorted(set(
            os.path.basename(x)[0:6] for x in os.listdir(data_path)
        ))
        if labeled_sample_list is not None:
            with open(os.path.join(split_dir, labeled_sample_list)) as f:
                self.scan_names = [x.strip() for x in f.readlines()]
        self.num_points = num_points
        self.use_color = use_color
        self.use_height = use_height
        self.augment = augment

    def __len__(self):
        return len(self.scan_names)

    def __getitem__(self, idx):
        scan_name = self.scan_names[idx]
        raw_pc, bboxes, point_votes = _load_scan(self.data_path, scan_name)
        bboxes = bboxes.copy()
        point_votes = point_votes.copy()
        point_cloud = _prep_cloud(raw_pc, self.use_color, self.use_height)
        if self.augment:
            _augment(point_cloud, bboxes, point_votes, self.use_color, self.use_height)
        labels = _box_labels(bboxes)
        point_cloud, choices = random_sampling(
            point_cloud, self.num_points, return_choices=True
        )
        return _label_dict(idx, point_cloud, point_votes, choices, labels)


class SunrgbdSSLLabeledDataset:
    """SSL labeled dataset (sunrgbd_ssl_dataset.py:26-182)."""

    def __init__(self, data_path, split_dir, labeled_sample_list,
                 num_points=20000, use_color=False, use_height=False, augment=False):
        self.data_path = data_path
        with open(os.path.join(split_dir, labeled_sample_list)) as f:
            self.scan_names = [x.strip() for x in f.readlines()]
        self.num_points = num_points
        self.use_color = use_color
        self.use_height = use_height
        self.augment = augment

    def __len__(self):
        return len(self.scan_names)

    def __getitem__(self, idx):
        scan_name = self.scan_names[idx]
        raw_pc, bboxes, point_votes = _load_scan(self.data_path, scan_name)
        bboxes = bboxes.copy()
        point_votes = point_votes.copy()
        point_cloud = _prep_cloud(raw_pc, self.use_color, self.use_height)
        ema_point_cloud = random_sampling(point_cloud, self.num_points)

        flip_x_axis = 0
        rot_mat = np.identity(3)
        rot_angle = 0.0
        scale_ratio = np.ones((1, 3))
        if self.augment:
            flip_x_axis, rot_mat, rot_angle, scale_ratio = _augment(
                point_cloud, bboxes, point_votes, self.use_color, self.use_height
            )
        labels = _box_labels(bboxes)
        point_cloud, choices = random_sampling(
            point_cloud, self.num_points, return_choices=True
        )
        ret = _label_dict(idx, point_cloud, point_votes, choices, labels)
        ret.update({
            "ema_point_clouds": ema_point_cloud.astype(np.float32),
            "flip_x_axis": np.array(flip_x_axis).astype(np.int64),
            "flip_y_axis": np.array(0).astype(np.int64),
            "rot_mat": rot_mat.astype(np.float32),
            "rot_angle": np.array(rot_angle).astype(np.float32),
            "scale": np.array(scale_ratio).astype(np.float32),
        })
        return ret


class SunrgbdSSLUnlabeledDataset:
    """SSL unlabeled dataset (sunrgbd_ssl_dataset.py:184-312): x-flip only +
    rotation + scale; flip_y_axis always 0."""

    def __init__(self, data_path, split_dir, labeled_sample_list,
                 num_points=20000, use_color=False, use_height=False, augment=True,
                 load_labels=False):
        self.load_labels = load_labels  # raw-frame GT for --view_stats
        self.data_path = data_path
        all_names = sorted(set(
            os.path.basename(x)[0:6] for x in os.listdir(data_path)
        ))
        with open(os.path.join(split_dir, labeled_sample_list)) as f:
            labeled = [x.strip() for x in f.readlines()]
        if len(all_names) == len(labeled):
            self.scan_names = all_names
        else:
            self.scan_names = sorted(set(all_names) - set(labeled))
        self.num_points = num_points
        self.use_color = use_color
        self.use_height = use_height
        self.augment = augment

    def __len__(self):
        return len(self.scan_names)

    def __getitem__(self, idx):
        scan_name = self.scan_names[idx]
        raw_pc, bboxes, point_votes = _load_scan(self.data_path, scan_name)
        point_votes = point_votes.copy()
        raw_point_cloud = _prep_cloud(raw_pc, self.use_color, self.use_height)
        ema_point_cloud = random_sampling(raw_point_cloud, self.num_points)

        # Reference RNG order (sunrgbd_ssl_dataset.py:281-303): the student
        # view is SAMPLED FIRST, then augmented points-only — x-flip,
        # ±30° z-rotation, scale; no vote/box transforms, no color jitter.
        point_cloud, _ = random_sampling(
            raw_point_cloud, self.num_points, return_choices=True
        )
        flip_x_axis = 0
        rot_mat = np.identity(3)
        rot_angle = 0.0
        scale_ratio = np.ones((1, 3))
        if self.augment:
            if np.random.random() > 0.5:
                flip_x_axis = 1
                point_cloud[:, 0] = -1 * point_cloud[:, 0]
            rot_angle = (np.random.random() * np.pi / 3) - np.pi / 6
            rot_mat = rotz(rot_angle)
            point_cloud[:, 0:3] = np.dot(point_cloud[:, 0:3], np.transpose(rot_mat))
            scale_ratio = np.random.random() * 0.3 + 0.85
            scale_ratio = np.expand_dims(np.tile(scale_ratio, 3), 0)
            point_cloud[:, 0:3] *= scale_ratio
            if self.use_height:
                point_cloud[:, -1] *= scale_ratio[0, 0]
        ret = {
            "ema_point_clouds": ema_point_cloud.astype(np.float32),
            "point_clouds": point_cloud.astype(np.float32),
            "flip_x_axis": np.array(flip_x_axis).astype(np.int64),
            "flip_y_axis": np.array(0).astype(np.int64),
            "rot_mat": rot_mat.astype(np.float32),
            "rot_angle": np.array(rot_angle).astype(np.float32),
            "scale": np.array(scale_ratio).astype(np.float32),
            "scan_idx": np.array(idx).astype(np.int64),
            "supervised_mask": np.array(0).astype(np.int64),
        }
        if self.load_labels:
            # RAW-frame GT (view-stats diagnostics,
            # sunrgbd_ssl_dataset.py:238-247 of the reference)
            (target_bboxes, mask, acls, ares, scls, sres, semcls) = _box_labels(bboxes)
            ret.update({
                "center_label": target_bboxes.astype(np.float32)[:, 0:3],
                "box_label_mask": mask.astype(np.float32),
                "heading_class_label": acls.astype(np.int64),
                "heading_residual_label": ares.astype(np.float32),
                "size_class_label": scls.astype(np.int64),
                "size_residual_label": sres.astype(np.float32),
                "sem_cls_label": semcls.astype(np.int64),
            })
        return ret
