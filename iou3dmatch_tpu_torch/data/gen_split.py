"""Random labeled splits that cover every class.

The port's copy of ``iou3dmatch_tpu/data/gen_split.py`` (reference
``generate_random_split.py``): draw random labeled subsets of the train
split until every detection class appears in at least one labeled scene,
then write the scene list. Given the same dumps and seed it writes the JAX
split's bytes: the same ``rng.choice`` draws, one a try.

Usage:
    python -m iou3dmatch_tpu_torch.data.gen_split scannet 0.1 0 \
        --data_path scannet_train_detection_data --split_file meta_data/scannetv2_train.txt
    python -m iou3dmatch_tpu_torch.data.gen_split sunrgbd 0.05 0 \
        --data_path sunrgbd_pc_bbox_votes_50k_v1_train --out_dir sunrgbd_trainval
"""
import argparse
import os

import numpy as np

from .config import get_config


def scan_class_matrix_scannet(scan_names, data_path, cfg):
    """(scenes, classes) 0/1: the classes of each scene's ``_bbox.npy``
    (nyu40 ids in the last column)."""
    m = np.zeros((len(scan_names), cfg.num_class))
    for i, scan_name in enumerate(scan_names):
        bboxes = np.load(os.path.join(data_path, scan_name + "_bbox.npy"))
        for nyu40id in bboxes[:, -1]:
            m[i, cfg.nyu40id2class[int(nyu40id)]] = 1
    return m


def scan_class_matrix_sunrgbd(scan_names, data_path, cfg):
    """(scenes, classes) 0/1: the classes of each scene's ``_bbox.npy``
    (class ids in the last column)."""
    m = np.zeros((len(scan_names), cfg.num_class))
    for i, scan_name in enumerate(scan_names):
        bboxes = np.load(os.path.join(data_path, scan_name + "_bbox.npy"))
        for cls in bboxes[:, -1]:
            m[i, int(cls)] = 1
    return m


def draw_split(scan_names, scan2label, labeled_ratio, num_class, rng, max_tries=100000):
    """Draw ``int(ratio x scenes)`` scenes without replacement until they
    cover every class (generate_random_split.py:39-48). Raises at once when
    the dataset itself misses a class, and after ``max_tries`` draws
    otherwise, where the reference would spin for ever."""
    num_labeled = int(labeled_ratio * len(scan_names))
    covered_total = int((scan2label.sum(axis=0) > 0).sum())
    if covered_total < num_class:
        raise ValueError(f"dataset covers only {covered_total}/{num_class} classes; "
                         "no labeled split can cover all of them")
    for _ in range(max_tries):
        choices = rng.choice(len(scan_names), num_labeled, replace=False)
        if (scan2label[choices].sum(axis=0) > 0).sum() == num_class:
            return [scan_names[i] for i in choices]
    raise RuntimeError(f"no class-covering split of ratio {labeled_ratio} found in "
                       f"{max_tries} draws; raise the ratio or max_tries")


def main(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("dataset", choices=["scannet", "sunrgbd"])
    p.add_argument("ratio", type=float)
    p.add_argument("count", type=int, help="split id suffix")
    p.add_argument("--data_path", required=True)
    p.add_argument("--split_file", default=None,
                   help="scannet: train scan list; sunrgbd: inferred from data_path")
    p.add_argument("--out_dir", default=None)
    p.add_argument("--seed", type=int, default=None)
    args = p.parse_args(argv)

    cfg = get_config(args.dataset)
    rng = np.random.RandomState(args.seed)
    if args.dataset == "scannet":
        with open(args.split_file) as f:
            scan_names = f.read().splitlines()
        scan2label = scan_class_matrix_scannet(scan_names, args.data_path, cfg)
        out_dir = args.out_dir or os.path.dirname(args.split_file)
        out = os.path.join(out_dir, f"scannetv2_train_{args.ratio}_{args.count}.txt")
    else:
        scan_names = sorted(set(os.path.basename(x)[0:6] for x in os.listdir(args.data_path)))
        scan2label = scan_class_matrix_sunrgbd(scan_names, args.data_path, cfg)
        out_dir = args.out_dir or "."
        out = os.path.join(out_dir, f"sunrgbd_v1_train_{args.ratio}_{args.count}.txt")

    labeled = draw_split(scan_names, scan2label, args.ratio, cfg.num_class, rng)
    with open(out, "w") as f:
        f.write("\n".join(labeled) + "\n")
    print(f"selected {len(labeled)} labeled scans -> {out} "
          f"({len(scan_names) - len(labeled)} remain unlabeled)")
    return out


if __name__ == "__main__":
    main()
