"""Synthetic indoor-scene generator.

Produces batches with the exact key/shape contract of the real loaders —
random axis-aligned rooms with boxes, surface points, and center votes — for
tests, benchmarking, and smoke training when the ScanNet / SUN RGB-D dumps
are not on disk (they require manual download in the reference too,
README.md:83-117).

The port's copy of ``iou3dmatch_tpu/data/synthetic.py``: the same scenes
bit for bit from the same seed.
"""
import numpy as np

from .config import get_config

MAX_NUM_OBJ = 64


def synthetic_scene(rng, cfg, num_points, num_boxes=8, heading=False,
                    size_jitter=0.05):
    """One scene: points scattered in a room + clusters inside GT boxes.

    ``size_jitter`` keeps box sizes close to the class mean so the semantic
    class is actually inferable from geometry (classes have no other signal
    in synthetic scenes; a wide jitter makes them ambiguous and caps mAP).
    """
    nb = min(num_boxes, MAX_NUM_OBJ)
    centers = rng.uniform(-3, 3, (nb, 3)).astype(np.float32)
    centers[:, 2] = rng.uniform(0.2, 1.5, nb)
    cls = rng.randint(0, cfg.num_class, nb)
    sizes = cfg.mean_size_arr[cls] * rng.uniform(
        1.0 - size_jitter, 1.0 + size_jitter, (nb, 3))
    angles = (
        rng.uniform(-np.pi, np.pi, nb) if heading else np.zeros(nb)
    ).astype(np.float32)

    n_obj_pts = num_points // 2
    per_box = n_obj_pts // nb
    pts, votes, votes_mask = [], [], []
    for i in range(nb):
        local = rng.uniform(-0.5, 0.5, (per_box, 3)) * sizes[i]
        c, s = np.cos(angles[i]), np.sin(angles[i])
        rot = np.array([[c, -s, 0], [s, c, 0], [0, 0, 1]])
        p = local @ rot.T + centers[i]
        pts.append(p)
        votes.append(centers[i] - p)
        votes_mask.append(np.ones(per_box))
    n_bg = num_points - per_box * nb
    bg = rng.uniform(-4, 4, (n_bg, 3))
    bg[:, 2] = rng.uniform(0, 2.5, n_bg)
    pts.append(bg)
    votes.append(np.zeros((n_bg, 3)))
    votes_mask.append(np.zeros(n_bg))

    point_cloud = np.concatenate(pts).astype(np.float32)
    vote = np.tile(np.concatenate(votes), (1, 3)).astype(np.float32)
    vote_mask = np.concatenate(votes_mask).astype(np.int64)
    perm = rng.permutation(num_points)
    point_cloud, vote, vote_mask = point_cloud[perm], vote[perm], vote_mask[perm]

    height = point_cloud[:, 2:3] - np.percentile(point_cloud[:, 2], 0.99)
    point_cloud = np.concatenate([point_cloud, height], axis=1)

    center_label = np.zeros((MAX_NUM_OBJ, 3), np.float32)
    center_label[:nb] = centers
    mask = np.zeros(MAX_NUM_OBJ, np.float32)
    mask[:nb] = 1
    size_cls = np.zeros(MAX_NUM_OBJ, np.int64)
    size_cls[:nb] = cls
    size_res = np.zeros((MAX_NUM_OBJ, 3), np.float32)
    size_res[:nb] = sizes - cfg.mean_size_arr[cls]
    sem = np.zeros(MAX_NUM_OBJ, np.int64)
    sem[:nb] = cls
    heading_cls = np.zeros(MAX_NUM_OBJ, np.int64)
    heading_res = np.zeros(MAX_NUM_OBJ, np.float32)
    if heading and cfg.num_heading_bin > 1:
        for i in range(nb):
            hc, hr = cfg.angle2class(angles[i])
            heading_cls[i] = hc
            heading_res[i] = hr

    return {
        "point_clouds": point_cloud,
        "center_label": center_label,
        "heading_class_label": heading_cls,
        "heading_residual_label": heading_res,
        "size_class_label": size_cls,
        "size_residual_label": size_res,
        "sem_cls_label": sem,
        "box_label_mask": mask,
        "vote_label": vote,
        "vote_label_mask": vote_mask,
        "scan_idx": np.array(0, np.int64),
        "supervised_mask": np.array(1, np.int64),
    }


class SyntheticDataset:
    """Dataset-shaped wrapper (supervised or SSL labeled/unlabeled views)."""

    def __init__(self, dataset="scannet", num_scenes=64, num_points=20000,
                 ssl=False, labeled=True, seed=0, load_labels=False):
        self.load_labels = load_labels
        self.cfg = get_config(dataset)
        self.num_scenes = num_scenes
        self.num_points = num_points
        self.ssl = ssl
        self.labeled = labeled
        self.seed = seed
        self.heading = dataset == "sunrgbd"

    def __len__(self):
        return self.num_scenes

    def __getitem__(self, idx):
        rng = np.random.RandomState(self.seed * 100003 + idx)
        d = synthetic_scene(rng, self.cfg, self.num_points, heading=self.heading)
        if not self.ssl:
            return d
        d["ema_point_clouds"] = d["point_clouds"].copy()
        d["flip_x_axis"] = np.array(0, np.int64)
        d["flip_y_axis"] = np.array(0, np.int64)
        d["rot_mat"] = np.eye(3, dtype=np.float32)
        d["rot_angle"] = np.array(0, np.float32)
        d["scale"] = np.ones((1, 3), np.float32)
        if not self.labeled:
            keep = [
                "point_clouds", "ema_point_clouds", "flip_x_axis", "flip_y_axis",
                "rot_mat", "rot_angle", "scale", "scan_idx",
            ]
            if self.load_labels:  # raw-frame GT for --view_stats
                keep += ["center_label", "box_label_mask", "heading_class_label",
                         "heading_residual_label", "size_class_label",
                         "size_residual_label", "sem_cls_label"]
            d = {k: d[k] for k in keep}
            d["supervised_mask"] = np.array(0, np.int64)
        return d
