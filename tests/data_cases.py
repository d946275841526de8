"""Fake ScanNet and SUN RGB-D dumps for the data tests of both packages.

The layouts are those the offline prep writes (``data/prep_scannet.py``,
``data/prep_sunrgbd.py``) and the drivers read (``cli/common.py``
``_data_root``): under one root, ``scannet_train_detection_data/`` with
``{scan}_vert.npy`` (N, 6) float32, ``_ins_label.npy``, ``_sem_label.npy``
and ``_bbox.npy`` (K, 7: center, size, nyu40 id), ``meta_data/`` with the
split lists; ``sunrgbd_pc_bbox_votes_50k_{v1,v2}_{train,val}/`` with
``{scan}_pc.npz`` (N, 6), ``_bbox.npy`` (K, 8: center, half extents,
heading, class) and ``_votes.npz`` (N, 10), ``sunrgbd_trainval/`` with the
labeled list. Everything comes from a seed.
"""
import numpy as np

SCANNET_NYU40IDS = (3, 4, 5, 6, 7, 8, 9, 10, 11, 12, 14, 16, 24, 28, 33, 34, 36, 39)
WALL, FLOOR = 1, 2  # nyu40 ids that are not ScanNet detection classes


def scannet_scan(rng, n):
    """(verts, instance ids, semantic ids, boxes) of one room: 2-5 objects
    of ScanNet classes, a wall and a floor, and unannotated points (id 0)."""
    k = rng.randint(2, 6)
    sizes = rng.uniform(0.3, 1.5, (k, 3))
    centers = np.c_[rng.uniform(-2, 2, (k, 2)), sizes[:, 2] / 2]
    ids = rng.choice(SCANNET_NYU40IDS, k)
    part = rng.multinomial(n, [0.5 / k] * k + [0.2, 0.2, 0.1])
    xyz, ins, sem = [], [], []
    for j in range(k):
        xyz.append(centers[j] + rng.uniform(-0.5, 0.5, (part[j], 3)) * sizes[j])
        ins.append(np.full(part[j], j + 1))
        sem.append(np.full(part[j], ids[j]))
    wall = np.c_[rng.uniform(-3, 3, part[k]), np.full(part[k], 3.0), rng.uniform(0, 2.5, part[k])]
    floor = np.c_[rng.uniform(-3, 3, (part[k + 1], 2)), np.zeros(part[k + 1])]
    loose = rng.uniform(-3, 3, (part[k + 2], 3))
    xyz += [wall, floor, loose]
    ins += [np.full(part[k], k + 1), np.full(part[k + 1], k + 2), np.zeros(part[k + 2])]
    sem += [np.full(part[k], WALL), np.full(part[k + 1], FLOOR), np.zeros(part[k + 2])]
    perm = rng.permutation(n)
    verts = np.c_[np.concatenate(xyz), rng.uniform(0, 255, (n, 3))].astype(np.float32)[perm]
    ins = np.concatenate(ins).astype(np.int64)[perm]
    sem = np.concatenate(sem).astype(np.int64)[perm]
    boxes = []
    for j in range(k):
        pts = verts[ins == j + 1, :3]
        lo, hi = pts.min(0), pts.max(0)
        boxes.append(np.r_[(lo + hi) / 2, hi - lo, ids[j]])
    return verts, ins, sem, np.array(boxes)


def write_scannet_dump(root, seed=0, n_train=6, n_val=2, n_labeled=2, n=3000):
    """Writes ``n_train + n_val`` scans of ``n`` vertices under ``root``;
    ``meta_data/labeled.txt`` lists the first ``n_labeled`` train scans.
    Returns the root."""
    rng = np.random.RandomState(seed)
    data, meta = root / "scannet_train_detection_data", root / "meta_data"
    data.mkdir(parents=True)
    meta.mkdir()
    names = [f"scene{i:04d}_00" for i in range(n_train + n_val)]
    for name in names:
        verts, ins, sem, boxes = scannet_scan(rng, n)
        for suffix, arr in (("vert", verts), ("ins_label", ins), ("sem_label", sem),
                            ("bbox", boxes)):
            np.save(data / f"{name}_{suffix}.npy", arr)
    (meta / "scannetv2_train.txt").write_text("\n".join(names[:n_train]) + "\n")
    (meta / "scannetv2_val.txt").write_text("\n".join(names[n_train:]) + "\n")
    (meta / "labeled.txt").write_text("\n".join(names[:n_labeled]) + "\n")
    return root


def sunrgbd_scan(rng, n):
    """(pc, boxes, votes) of one SUN RGB-D scene: 1-4 oriented boxes of the
    10 classes (half extents on disk), points inside each voting for its
    center, the rest of the points loose."""
    k = rng.randint(1, 5)
    pc = np.c_[rng.uniform(-4, 4, (n, 3)), rng.uniform(0, 1, (n, 3))].astype(np.float32)
    votes = np.zeros((n, 10), np.float32)
    boxes = np.zeros((k, 8))
    per = n // (2 * k)
    for j in range(k):
        center = np.r_[rng.uniform(-2, 2, 2), rng.uniform(0.2, 1.0)]
        half = rng.uniform(0.2, 1.0, 3)
        heading = rng.uniform(-np.pi, np.pi)
        c, s = np.cos(-heading), np.sin(-heading)
        rot = np.array([[c, -s, 0], [s, c, 0], [0, 0, 1]])
        rows = slice(j * per, (j + 1) * per)
        pc[rows, :3] = rng.uniform(-1, 1, (per, 3)) * half * 0.9 @ rot.T + center
        v = center - pc[rows, :3]
        votes[rows] = np.c_[np.ones(per), v, v, v]
        boxes[j] = np.r_[center, half, heading, rng.randint(0, 10)]
    return pc, boxes, votes


def write_sunrgbd_dump(root, seed=0, n_train=5, n_val=2, n_labeled=2, n=2500):
    """Writes v1 and v2 train and val dirs under ``root`` (v2's scenes are
    other draws) and ``sunrgbd_trainval/labeled.txt`` listing the first
    ``n_labeled`` train scenes. Returns the root."""
    rng = np.random.RandomState(seed)
    for ver in ("v1", "v2"):
        for split, count, first in (("train", n_train, 1), ("val", n_val, 5001)):
            d = root / f"sunrgbd_pc_bbox_votes_50k_{ver}_{split}"
            d.mkdir(parents=True)
            for i in range(first, first + count):
                pc, boxes, votes = sunrgbd_scan(rng, n)
                np.savez_compressed(d / f"{i:06d}_pc.npz", pc=pc)
                np.save(d / f"{i:06d}_bbox.npy", boxes)
                np.savez_compressed(d / f"{i:06d}_votes.npz", point_votes=votes)
    split_dir = root / "sunrgbd_trainval"
    split_dir.mkdir()
    (split_dir / "labeled.txt").write_text(
        "\n".join(f"{i:06d}" for i in range(1, 1 + n_labeled)) + "\n")
    return root


class ExitsAt:
    """A dataset of ``n`` tiny samples whose worker process exits at index
    ``bad``, as an OOM-killed worker would."""

    def __init__(self, n=4, bad=1):
        self.n, self.bad = n, bad

    def __len__(self):
        return self.n

    def __getitem__(self, i):
        if i == self.bad:
            import os

            os._exit(3)
        return {"x": np.full(3, i, np.float32)}
