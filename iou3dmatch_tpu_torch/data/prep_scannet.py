"""Offline ScanNet export: raw scans -> per-scene npy quads.

The port's copy of ``iou3dmatch_tpu/data/prep_scannet.py`` (reference
``scannet/load_scannet_data.py`` and ``batch_load_scannet_data.py``): for
each scan, read the cleaned mesh PLY, the aggregation and segmentation
JSON and the axis-alignment matrix of the meta txt, and write

    <scan>_vert.npy       (N, 6) float32: xyz (axis-aligned) + rgb 0-255
    <scan>_sem_label.npy  (N,)  uint32 nyu40 ids (0 = unannotated)
    <scan>_ins_label.npy  (N,)  uint32 instance ids (1-indexed, 0 = none)
    <scan>_bbox.npy       (K, 7): cx cy cz dx dy dz nyu40id, axis-aligned
                          boxes of the 18 detection classes only

capped at 50,000 random vertices a scan (batch_load_scannet_data.py:36,
70-76). Given the same files and seed it writes the JAX prep's bytes: the
cap draws one ``rng.choice`` a capped scan, in the scan list's order.

Usage:
    python -m iou3dmatch_tpu_torch.data.prep_scannet --scannet_dir scans \
        --label_map scannetv2-labels.combined.tsv \
        --scan_list meta_data/scannet_train.txt --output_dir scannet_train_detection_data
"""
import argparse
import csv
import json
import os

import numpy as np

from .ply import read_mesh_vertices_rgb

# nyu40 ids of the 18 detection classes (batch_load_scannet_data.py:35)
OBJ_CLASS_IDS = np.array([3, 4, 5, 6, 7, 8, 9, 10, 11, 12, 14, 16, 24, 28, 33, 34, 36, 39])
MAX_NUM_POINT = 50000


def represents_int(s):
    """True iff ``s`` parses as an int (scannet_utils.py:19-25)."""
    try:
        int(s)
        return True
    except ValueError:
        return False


def read_label_mapping(filename, label_from="raw_category", label_to="nyu40id"):
    """Raw category name -> nyu40 id from the ScanNet tsv; the keys become
    ints when every key is numeric (scannet_utils.py:28-40)."""
    mapping = {}
    with open(filename) as f:
        for row in csv.DictReader(f, delimiter="\t"):
            mapping[row[label_from]] = int(row[label_to])
    if mapping and all(represents_int(k) for k in mapping):
        mapping = {int(k): v for k, v in mapping.items()}
    return mapping


def read_aggregation(filename):
    """(object id (1-indexed) -> segment ids, label -> segment ids)."""
    with open(filename) as f:
        data = json.load(f)
    object_id_to_segs, label_to_segs = {}, {}
    for group in data["segGroups"]:
        object_id = group["objectId"] + 1
        object_id_to_segs[object_id] = group["segments"]
        label_to_segs.setdefault(group["label"], []).extend(group["segments"])
    return object_id_to_segs, label_to_segs


def read_segmentation(filename):
    """(segment id -> vertex indices, the vertex count)."""
    with open(filename) as f:
        seg_indices = json.load(f)["segIndices"]
    seg_to_verts = {}
    for i, seg_id in enumerate(seg_indices):
        seg_to_verts.setdefault(seg_id, []).append(i)
    return seg_to_verts, len(seg_indices)


def read_axis_align_matrix(meta_file):
    """The meta txt's ``axisAlignment`` as (4, 4), or the identity."""
    with open(meta_file) as f:
        for line in f:
            if "axisAlignment" in line:
                vals = line.rstrip().split("=")[1].strip().split()
                return np.array([float(v) for v in vals]).reshape(4, 4)
    return np.eye(4)


def export(mesh_file, agg_file, seg_file, meta_file, label_map_file):
    """One scan -> (vertices, semantic labels, instance labels, instance
    boxes) (load_scannet_data.export)."""
    label_map = read_label_mapping(label_map_file)
    mesh_vertices = read_mesh_vertices_rgb(mesh_file)

    axis_align = read_axis_align_matrix(meta_file)
    pts = np.concatenate([mesh_vertices[:, :3], np.ones((len(mesh_vertices), 1))], axis=1)
    mesh_vertices = mesh_vertices.copy()
    mesh_vertices[:, :3] = (pts @ axis_align.T)[:, :3]

    object_id_to_segs, label_to_segs = read_aggregation(agg_file)
    seg_to_verts, num_verts = read_segmentation(seg_file)

    label_ids = np.zeros(num_verts, dtype=np.uint32)
    for label, segs in label_to_segs.items():
        label_id = label_map[label]
        for seg in segs:
            label_ids[seg_to_verts[seg]] = label_id

    instance_ids = np.zeros(num_verts, dtype=np.uint32)
    object_id_to_label_id = {}
    for object_id, segs in object_id_to_segs.items():
        for seg in segs:
            verts = seg_to_verts[seg]
            instance_ids[verts] = object_id
            object_id_to_label_id.setdefault(object_id, label_ids[verts[0]])

    instance_bboxes = np.zeros((len(object_id_to_segs), 7))
    for object_id in object_id_to_segs:
        obj_pc = mesh_vertices[instance_ids == object_id, :3]
        if len(obj_pc) == 0:
            continue
        mn, mx = obj_pc.min(0), obj_pc.max(0)
        instance_bboxes[object_id - 1] = np.concatenate(
            [(mn + mx) / 2.0, mx - mn, [object_id_to_label_id[object_id]]])
    return mesh_vertices, label_ids, instance_ids, instance_bboxes


def export_one_scan(scannet_dir, scan_name, label_map_file, output_prefix, rng):
    """One scan's four files under ``output_prefix``; a scan of more than
    MAX_NUM_POINT vertices is cut to a ``rng.choice`` of them."""
    d = os.path.join(scannet_dir, scan_name)
    verts, sem, ins, bboxes = export(
        os.path.join(d, scan_name + "_vh_clean_2.ply"),
        os.path.join(d, scan_name + ".aggregation.json"),
        os.path.join(d, scan_name + "_vh_clean_2.0.010000.segs.json"),
        os.path.join(d, scan_name + ".txt"),
        label_map_file,
    )
    bboxes = bboxes[np.isin(bboxes[:, -1], OBJ_CLASS_IDS)]
    if len(verts) > MAX_NUM_POINT:
        choices = rng.choice(len(verts), MAX_NUM_POINT, replace=False)
        verts, sem, ins = verts[choices], sem[choices], ins[choices]
    np.save(output_prefix + "_vert.npy", verts)
    np.save(output_prefix + "_sem_label.npy", sem)
    np.save(output_prefix + "_ins_label.npy", ins)
    np.save(output_prefix + "_bbox.npy", bboxes)


def main(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("--scannet_dir", default="scans")
    p.add_argument("--label_map", default="meta_data/scannetv2-labels.combined.tsv")
    p.add_argument("--scan_list", default="meta_data/scannet_train.txt")
    p.add_argument("--output_dir", default="scannet_train_detection_data")
    p.add_argument("--seed", type=int, default=0)
    args = p.parse_args(argv)

    os.makedirs(args.output_dir, exist_ok=True)
    rng = np.random.RandomState(args.seed)
    with open(args.scan_list) as f:
        scan_names = [line.strip() for line in f if line.strip()]
    for scan_name in scan_names:
        prefix = os.path.join(args.output_dir, scan_name)
        if os.path.isfile(prefix + "_vert.npy"):
            print(f"{scan_name}: exists, skipping")
            continue
        try:
            export_one_scan(args.scannet_dir, scan_name, args.label_map, prefix, rng)
            print(f"{scan_name}: done")
        except Exception as e:  # the reference's per-scan resilience, reported per scan
            print(f"{scan_name}: FAILED ({e})")


if __name__ == "__main__":
    main()
