"""Visual sanity check of prepped ScanNet detection data.

The port's copy of ``iou3dmatch_tpu/cli/data_viz.py``, writing its files.
A working equivalent of the reference's `scannet/data_viz.py` (which calls a
`param2bbox` helper that no longer exists there): loads one prepped scene
(`<prefix>_vert.npy, _ins_label.npy, _sem_label.npy, _bbox.npy` as written
by `data/prep_scannet.py`, mirroring `batch_load_scannet_data.py`) and
dumps colored PLYs for eyeballing in MeshLab.

Usage:
  python -m iou3dmatch_tpu_torch.cli.data_viz \
      scannet_train_detection_data/scene0002_00 [out_dir]
"""
import os
import sys

import numpy as np

from ..utils.dump_helper import (
    write_oriented_bbox,
    write_ply_color,
    write_ply_rgb,
)


def main(argv=None):
    argv = sys.argv[1:] if argv is None else argv
    if not argv:
        print(__doc__)
        return 1
    prefix = argv[0]
    out = argv[1] if len(argv) > 1 else "data_viz_dump"

    verts = np.load(prefix + "_vert.npy")
    points, colors = verts[:, 0:3], verts[:, 3:6]
    ins = np.load(prefix + "_ins_label.npy")
    sem = np.load(prefix + "_sem_label.npy")
    bboxes = np.load(prefix + "_bbox.npy")  # (K, 7): cx cy cz dx dy dz cls

    print("instance ids:", np.unique(ins))
    print("semantic ids:", np.unique(sem))
    print("bboxes:", bboxes.shape)

    os.makedirs(out, exist_ok=True)
    write_ply_rgb(points, colors, os.path.join(out, "scene.ply"))
    write_ply_color(points, ins, os.path.join(out, "scene_instance.ply"))
    write_ply_color(points, sem, os.path.join(out, "scene_semantic.ply"))
    # bbox.npy boxes are axis-aligned; column 7 is the class id, not heading
    obbs = np.concatenate(
        [bboxes[:, :6], np.zeros((len(bboxes), 1), bboxes.dtype)], axis=1
    )
    write_oriented_bbox(obbs, os.path.join(out, "scene_bbox.ply"))
    print(f"wrote {out}/scene{{,_instance,_semantic,_bbox}}.ply")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
