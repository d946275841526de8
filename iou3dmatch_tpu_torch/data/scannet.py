"""ScanNet detection datasets (supervised + SSL labeled/unlabeled).

Mirrors `scannet/scannet_detection_dataset.py:31-258` and
`scannet/scannet_ssl_dataset.py:24-320`: npy quads per scan
({scan}_vert/_ins_label/_sem_label/_bbox.npy), optional color
((rgb - MEAN)/256) and height (z - 0.99-percentile floor) channels, random
num_points subset, augmentation (50% x-flip, 50% y-flip, +/-5deg z-rotation
with AABB re-fit, global scale 0.85-1.15), votes recomputed from instance
masks AFTER augmentation and tiled x3, labels padded to MAX_NUM_OBJ=64.
RNG draw order matches the reference so a seeded run produces the same
augmentations.

The port's copy of ``iou3dmatch_tpu/data/scannet.py``, NumPy only, each ``__getitem__`` bit for bit the JAX one after the same
``np.random.seed``. The vote labels and the floor percentile always run
natively (``native/loader.py``); the debug dumps ``viz_votes`` and
``viz_obb`` wait for ``utils/dump_helper.py``.
"""
import os

import numpy as np

from ..native.loader import compute_votes_native, percentile_native
from .config import ScannetConfig
from .pc_util import random_sampling, rotz

DC = ScannetConfig()
MAX_NUM_OBJ = 64
MEAN_COLOR_RGB = np.array([109.8, 97.2, 83.8])


def rotate_aligned_boxes(input_boxes, rot_mat):
    """Re-fit axis-aligned boxes after z-rotation
    (scannet/model_util_scannet.py:85-106)."""
    centers, lengths = input_boxes[:, 0:3], input_boxes[:, 3:6]
    new_centers = np.dot(centers, np.transpose(rot_mat))
    dx, dy = lengths[:, 0] / 2.0, lengths[:, 1] / 2.0
    new_x = np.zeros((dx.shape[0], 4))
    new_y = np.zeros((dx.shape[0], 4))
    for i, crnr in enumerate([(-1, -1), (1, -1), (1, 1), (-1, 1)]):
        crnrs = np.zeros((dx.shape[0], 3))
        crnrs[:, 0] = crnr[0] * dx
        crnrs[:, 1] = crnr[1] * dy
        crnrs = np.dot(crnrs, np.transpose(rot_mat))
        new_x[:, i] = crnrs[:, 0]
        new_y[:, i] = crnrs[:, 1]
    new_dx = 2.0 * np.max(new_x, 1)
    new_dy = 2.0 * np.max(new_y, 1)
    new_lengths = np.stack((new_dx, new_dy, lengths[:, 2]), axis=1)
    return np.concatenate([new_centers, new_lengths], axis=1)


def _load_scan(data_path, scan_name):
    mesh_vertices = np.load(os.path.join(data_path, scan_name) + "_vert.npy")
    instance_labels = np.load(os.path.join(data_path, scan_name) + "_ins_label.npy")
    semantic_labels = np.load(os.path.join(data_path, scan_name) + "_sem_label.npy")
    instance_bboxes = np.load(os.path.join(data_path, scan_name) + "_bbox.npy")
    return mesh_vertices, instance_labels, semantic_labels, instance_bboxes


def _prep_cloud(mesh_vertices, use_color, use_height):
    if not use_color:
        pc = mesh_vertices[:, 0:3]
    else:
        pc = mesh_vertices[:, 0:6].copy()
        pc[:, 3:] = (pc[:, 3:] - MEAN_COLOR_RGB) / 256.0
    if use_height:
        floor_height = percentile_native(pc[:, 2], 0.99)
        if floor_height is None:
            floor_height = np.percentile(pc[:, 2], 0.99)
        height = pc[:, 2] - floor_height
        pc = np.concatenate([pc, np.expand_dims(height, 1)], 1)
    return pc


def _augment(point_cloud, target_bboxes, use_height, flip_points_only=False):
    """Shared augmentation block. Returns aug params for the SSL transforms."""
    flip_x_axis = 0
    flip_y_axis = 0
    if np.random.random() > 0.5:
        flip_x_axis = 1
        point_cloud[:, 0] = -1 * point_cloud[:, 0]
        if not flip_points_only:
            target_bboxes[:, 0] = -1 * target_bboxes[:, 0]
    if np.random.random() > 0.5:
        flip_y_axis = 1
        point_cloud[:, 1] = -1 * point_cloud[:, 1]
        if not flip_points_only:
            target_bboxes[:, 1] = -1 * target_bboxes[:, 1]
    rot_angle = (np.random.random() * np.pi / 18) - np.pi / 36  # -5 ~ +5 deg
    rot_mat = rotz(rot_angle)
    point_cloud[:, 0:3] = np.dot(point_cloud[:, 0:3], np.transpose(rot_mat))
    if not flip_points_only:
        target_bboxes[:] = rotate_aligned_boxes(target_bboxes, rot_mat)
    scale_ratio = np.random.random() * 0.3 + 0.85
    scale_ratio = np.expand_dims(np.tile(scale_ratio, 3), 0)
    point_cloud[:, 0:3] *= scale_ratio
    if not flip_points_only:
        target_bboxes[:, 0:3] *= scale_ratio
        target_bboxes[:, 3:6] *= scale_ratio
    if use_height:
        point_cloud[:, -1] *= scale_ratio[0, 0]
    return flip_x_axis, flip_y_axis, rot_mat, rot_angle, scale_ratio


def _compute_votes(point_cloud, instance_labels, semantic_labels):
    """Votes (N, 9), each point's box-center offset tiled x3, and the (N,)
    mask of the reference's per-instance loop
    (scannet_detection_dataset.py:182-193), from the native kernel;
    ``native/loader.py::compute_votes_plain`` is its NumPy form."""
    point_votes, point_votes_mask = compute_votes_native(
        point_cloud, instance_labels, semantic_labels, DC.nyu40ids)
    return np.tile(point_votes, (1, 3)), point_votes_mask


def _box_labels(instance_bboxes, target_bboxes):
    size_classes = np.zeros((MAX_NUM_OBJ,))
    size_residuals = np.zeros((MAX_NUM_OBJ, 3))
    target_bboxes_semcls = np.zeros((MAX_NUM_OBJ))
    class_ind = [np.where(DC.nyu40ids == x)[0][0] for x in instance_bboxes[:, -1]]
    size_classes[0 : instance_bboxes.shape[0]] = class_ind
    size_residuals[0 : instance_bboxes.shape[0], :] = (
        target_bboxes[0 : instance_bboxes.shape[0], 3:6] - DC.mean_size_arr[class_ind, :]
    )
    target_bboxes_semcls[0 : instance_bboxes.shape[0]] = class_ind
    return size_classes, size_residuals, target_bboxes_semcls, class_ind


def _scene_label(class_ind):
    """Multi-hot class-presence vector (scannet_detection_dataset.py:218-222,
    scannet_ssl_dataset.py:170-175). Emitted but unconsumed by the reference
    training code; kept for batch-surface parity."""
    scene_label = np.zeros(DC.num_class)
    for ind in set(class_ind):
        scene_label[int(ind)] = 1
    return scene_label.astype(np.float32)


class ScannetDetectionDataset:
    """Supervised dataset (scannet_detection_dataset.py:31-258)."""

    def __init__(self, data_path, split_dir=None, split_set="train",
                 labeled_ratio=0.1, labeled_sample_list=None, num_points=20000,
                 use_color=False, use_height=False, augment=False):
        self.data_path = data_path
        all_scan_names = sorted(set(
            os.path.basename(x)[0:12]
            for x in os.listdir(data_path) if x.startswith("scene")
        ))
        if split_set == "all" or split_dir is None:
            self.scan_names = list(all_scan_names)
        else:
            with open(os.path.join(split_dir, f"scannetv2_{split_set}.txt")) as f:
                names = f.read().splitlines()
            self.scan_names = [s for s in names if s in all_scan_names]
        self.split_dir = split_dir
        self.num_points = num_points
        self.use_color = use_color
        self.use_height = use_height
        self.augment = augment
        if split_set == "train" and labeled_sample_list is not None:
            with open(os.path.join(split_dir, labeled_sample_list)) as f:
                self.scan_names = [x.strip() for x in f.readlines()]

    def __len__(self):
        return len(self.scan_names)

    def __getitem__(self, idx):
        scan_name = self.scan_names[idx]
        mesh_vertices, instance_labels, semantic_labels, instance_bboxes = _load_scan(
            self.data_path, scan_name
        )
        point_cloud = _prep_cloud(mesh_vertices, self.use_color, self.use_height)

        target_bboxes = np.zeros((MAX_NUM_OBJ, 6))
        target_bboxes_mask = np.zeros((MAX_NUM_OBJ))
        angle_classes = np.zeros((MAX_NUM_OBJ,))
        angle_residuals = np.zeros((MAX_NUM_OBJ,))
        point_cloud, choices = random_sampling(
            point_cloud, self.num_points, return_choices=True
        )
        instance_labels = instance_labels[choices]
        semantic_labels = semantic_labels[choices]
        target_bboxes_mask[0 : instance_bboxes.shape[0]] = 1
        target_bboxes[0 : instance_bboxes.shape[0], :] = instance_bboxes[:, 0:6]

        if self.augment:
            _augment(point_cloud, target_bboxes, self.use_height)

        point_votes, point_votes_mask = _compute_votes(
            point_cloud, instance_labels, semantic_labels
        )
        size_classes, size_residuals, semcls, class_ind = _box_labels(
            instance_bboxes, target_bboxes
        )

        return {
            "point_clouds": point_cloud.astype(np.float32),
            "center_label": target_bboxes.astype(np.float32)[:, 0:3],
            "heading_class_label": angle_classes.astype(np.int64),
            "heading_residual_label": angle_residuals.astype(np.float32),
            "size_class_label": size_classes.astype(np.int64),
            "size_residual_label": size_residuals.astype(np.float32),
            "sem_cls_label": semcls.astype(np.int64),
            "box_label_mask": target_bboxes_mask.astype(np.float32),
            "vote_label": point_votes.astype(np.float32),
            "vote_label_mask": point_votes_mask.astype(np.int64),
            "scan_idx": np.array(idx).astype(np.int64),
            "supervised_mask": np.array(1).astype(np.int64),
            "scene_label": _scene_label(class_ind),
        }


class ScannetSSLLabeledDataset:
    """SSL labeled dataset (scannet_ssl_dataset.py:24-184): adds the
    unaugmented EMA view and the augmentation parameters."""

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
        mesh_vertices, instance_labels, semantic_labels, instance_bboxes = _load_scan(
            self.data_path, scan_name
        )
        raw_point_cloud = _prep_cloud(mesh_vertices, self.use_color, self.use_height)

        target_bboxes = np.zeros((MAX_NUM_OBJ, 6))
        target_bboxes_mask = np.zeros((MAX_NUM_OBJ))
        angle_classes = np.zeros((MAX_NUM_OBJ,))
        angle_residuals = np.zeros((MAX_NUM_OBJ,))

        point_cloud, choices = random_sampling(
            raw_point_cloud, self.num_points, return_choices=True
        )
        ema_point_cloud = random_sampling(raw_point_cloud, self.num_points)
        instance_labels = instance_labels[choices]
        semantic_labels = semantic_labels[choices]
        target_bboxes_mask[0 : instance_bboxes.shape[0]] = 1
        target_bboxes[0 : instance_bboxes.shape[0], :] = instance_bboxes[:, 0:6]

        flip_x_axis, flip_y_axis = 0, 0
        rot_mat = np.identity(3)
        rot_angle = 0.0
        scale_ratio = np.ones((1, 3))
        if self.augment:
            flip_x_axis, flip_y_axis, rot_mat, rot_angle, scale_ratio = _augment(
                point_cloud, target_bboxes, self.use_height
            )

        point_votes, point_votes_mask = _compute_votes(
            point_cloud, instance_labels, semantic_labels
        )
        size_classes, size_residuals, semcls, class_ind = _box_labels(
            instance_bboxes, target_bboxes
        )

        return {
            "point_clouds": point_cloud.astype(np.float32),
            "center_label": target_bboxes.astype(np.float32)[:, 0:3],
            "heading_class_label": angle_classes.astype(np.int64),
            "heading_residual_label": angle_residuals.astype(np.float32),
            "size_class_label": size_classes.astype(np.int64),
            "size_residual_label": size_residuals.astype(np.float32),
            "sem_cls_label": semcls.astype(np.int64),
            "box_label_mask": target_bboxes_mask.astype(np.float32),
            "vote_label": point_votes.astype(np.float32),
            "vote_label_mask": point_votes_mask.astype(np.int64),
            "scan_idx": np.array(idx).astype(np.int64),
            "supervised_mask": np.array(1).astype(np.int64),
            "scene_label": _scene_label(class_ind),
            "ema_point_clouds": ema_point_cloud.astype(np.float32),
            "flip_x_axis": np.array(flip_x_axis).astype(np.int64),
            "flip_y_axis": np.array(flip_y_axis).astype(np.int64),
            "rot_mat": rot_mat.astype(np.float32),
            "rot_angle": np.array(rot_angle).astype(np.float32),
            "scale": np.array(scale_ratio).astype(np.float32),
        }


class ScannetSSLUnlabeledDataset:
    """SSL unlabeled dataset (scannet_ssl_dataset.py:187-320): train-split
    scans minus the labeled list; student view augmented, teacher view raw."""

    def __init__(self, data_path, split_dir, labeled_sample_list,
                 num_points=20000, use_color=False, use_height=False, augment=True,
                 load_labels=False):
        self.load_labels = load_labels  # raw-frame GT for --view_stats
        self.data_path = data_path
        all_scan_names = set(
            os.path.basename(x)[0:12]
            for x in os.listdir(data_path) if x.startswith("scene")
        )
        with open(os.path.join(split_dir, "scannetv2_train.txt")) as f:
            train_scan_names = [s for s in f.read().splitlines() if s in all_scan_names]
        with open(os.path.join(split_dir, labeled_sample_list)) as f:
            labeled = [x.strip() for x in f.readlines()]
        if len(train_scan_names) == len(labeled):
            self.scan_names = train_scan_names
        else:
            self.scan_names = list(set(train_scan_names) - set(labeled))
        self.scan_names.sort()
        self.num_points = num_points
        self.use_color = use_color
        self.use_height = use_height
        self.augment = augment

    def __len__(self):
        return len(self.scan_names)

    def __getitem__(self, idx):
        scan_name = self.scan_names[idx]
        mesh_vertices = np.load(os.path.join(self.data_path, scan_name) + "_vert.npy")
        raw_point_cloud = _prep_cloud(mesh_vertices, self.use_color, self.use_height)

        ema_point_cloud = random_sampling(raw_point_cloud, self.num_points)
        point_cloud, _ = random_sampling(
            raw_point_cloud, self.num_points, return_choices=True
        )

        flip_x_axis, flip_y_axis = 0, 0
        rot_mat = np.identity(3)
        rot_angle = 0.0
        scale_ratio = np.ones((1, 3))
        if self.augment:
            flip_x_axis, flip_y_axis, rot_mat, rot_angle, scale_ratio = _augment(
                point_cloud, None, self.use_height, flip_points_only=True
            )

        ret = {
            "ema_point_clouds": ema_point_cloud.astype(np.float32),
            "point_clouds": point_cloud.astype(np.float32),
            "flip_x_axis": np.array(flip_x_axis).astype(np.int64),
            "flip_y_axis": np.array(flip_y_axis).astype(np.int64),
            "rot_mat": rot_mat.astype(np.float32),
            "rot_angle": np.array(rot_angle).astype(np.float32),
            "scale": np.array(scale_ratio).astype(np.float32),
            "scan_idx": np.array(idx).astype(np.int64),
            "supervised_mask": np.array(0).astype(np.int64),
        }
        if self.load_labels:
            # RAW-frame GT (view-stats diagnostics,
            # scannet_ssl_dataset.py:272-279 of the reference)
            instance_bboxes = np.load(
                os.path.join(self.data_path, scan_name) + "_bbox.npy")
            target_bboxes = np.zeros((MAX_NUM_OBJ, 6))
            mask = np.zeros(MAX_NUM_OBJ)
            nb = instance_bboxes.shape[0]
            mask[:nb] = 1
            target_bboxes[:nb] = instance_bboxes[:, 0:6]
            scls, sres, semcls, _ = _box_labels(instance_bboxes, target_bboxes)
            ret.update({
                "center_label": target_bboxes.astype(np.float32)[:, 0:3],
                "box_label_mask": mask.astype(np.float32),
                "heading_class_label": np.zeros(MAX_NUM_OBJ, np.int64),
                "heading_residual_label": np.zeros(MAX_NUM_OBJ, np.float32),
                "size_class_label": scls.astype(np.int64),
                "size_residual_label": sres.astype(np.float32),
                "sem_cls_label": semcls.astype(np.int64),
            })
        return ret
