"""SUN RGB-D raw extraction in Python, in place of the reference's MATLAB
step (``sunrgbd/matlab/extract_rgbd_data_v2.m``, ``extract_split.m``).

The port's copy of ``iou3dmatch_tpu/data/prep_sunrgbd_raw.py``. It reads
the official release (OFFICIAL_SUNRGBD/ with SUNRGBDMeta3DBB_v2.mat,
SUNRGBDMeta2DBB_v2.mat, SUNRGBDtoolbox/traintestSUNRGBD/allsplit.mat and
each scene's depth and RGB files) with scipy.io and writes the
``sunrgbd_trainval`` layout that ``prep_sunrgbd.py`` reads:

    depth/XXXXXX.mat   key 'instance': (N, 6) xyz + rgb, upright depth coordinates
    image/XXXXXX.jpg   the RGB file, copied
    calib/XXXXXX.txt   Rtilt, then K, each flattened column-major
    label_v1|label/XXXXXX.txt  'cls x y w h cx cy cz c1 c2 c3 ox oy' a box
    train_data_idx.txt / val_data_idx.txt

The points follow SUNRGBDtoolbox read3dPoints.m: the 16-bit depth PNG
holds millimetres rotated by 3 bits; points are unprojected with K, their
axes swapped to z up, tilted by Rtilt, and depth is capped at 8 m.

The depth PNG and the RGB image are decoded by PIL, imported when a scene
is read; without it the extraction raises an ``ImportError`` that names
it. (``prep_sunrgbd.py`` needs only scipy.)
"""
import argparse
import os
import shutil

import numpy as np

from .pc_util import import_optional

_HERE = "iou3dmatch_tpu_torch/data/prep_sunrgbd_raw.py"


def _field(rec, name):
    """A record's field, unwrapped from scipy's 1-element object arrays."""
    v = rec[name]
    while isinstance(v, np.ndarray) and v.dtype == object and v.size == 1:
        v = v.item()
    return v


def read_depth_points(depth_path, k_mat):
    """Depth PNG -> ((N, 3) camera-frame points, (N, 2) their (row, col)),
    read3dPoints.m: depth = (d >> 3 | d << 13) / 1000 m, capped at 8 m,
    pixels of depth 0 dropped."""
    image = import_optional("PIL.Image", _HERE)
    depth_vis = np.asarray(image.open(depth_path), dtype=np.uint16)
    depth = np.bitwise_or(np.right_shift(depth_vis, 3),
                          np.left_shift(depth_vis, 16 - 3)).astype(np.float32) / 1000.0
    depth[depth > 8.0] = 8.0
    h, w = depth.shape
    cx, cy = k_mat[0, 2], k_mat[1, 2]
    fx, fy = k_mat[0, 0], k_mat[1, 1]
    u, v = np.meshgrid(np.arange(w), np.arange(h))
    x = (u - cx) * depth / fx
    y = (v - cy) * depth / fy
    valid = depth > 0
    pts = np.stack([x[valid], y[valid], depth[valid]], axis=1)
    rgb_uv = np.stack([v[valid], u[valid]], axis=1)
    return pts, rgb_uv


def camera_to_upright_depth(points_cam, rtilt):
    """[x, z, -y], then tilted by Rtilt (read3dPoints.m's axes)."""
    pts = np.stack([points_cam[:, 0], points_cam[:, 2], -points_cam[:, 1]], axis=1)
    return pts @ rtilt.T


def extract_one(meta_rec, meta2d_rec, official_root, out, idx, v1=False):
    """One scene of the 3D (and 2D) metadata -> its depth, image, calib and
    label files under ``out``, named by ``idx``."""
    import scipy.io as sio

    image = import_optional("PIL.Image", _HERE)
    rtilt = np.asarray(_field(meta_rec, "Rtilt"), dtype=np.float64)
    k_mat = np.asarray(_field(meta_rec, "K"), dtype=np.float64)

    def _local(p):
        p = str(np.asarray(p).item()) if isinstance(p, np.ndarray) else str(p)
        if os.path.exists(p):
            return p
        # the metadata holds absolute paths of the capture machine
        # ('/n/fs/sun3d/data/...'): strip that prefix and rebase
        # (extract_rgbd_data_v2.m:41-44)
        return os.path.join(official_root, p[17:] if p.startswith("/") else p)

    depth_path = _local(_field(meta_rec, "depthpath"))
    rgb_path = _local(_field(meta_rec, "rgbpath"))

    pts_cam, rgb_uv = read_depth_points(depth_path, k_mat)
    pts_up = camera_to_upright_depth(pts_cam, rtilt)
    rgb_img = np.asarray(image.open(rgb_path), dtype=np.float32) / 255.0
    rgb = rgb_img[rgb_uv[:, 0], rgb_uv[:, 1]]
    points3d_rgb = np.concatenate([pts_up, rgb], axis=1).astype(np.float32)

    for sub in ("depth", "image", "calib"):
        os.makedirs(os.path.join(out, sub), exist_ok=True)
    label_dir = os.path.join(out, "label_v1" if v1 else "label")
    os.makedirs(label_dir, exist_ok=True)

    sio.savemat(os.path.join(out, "depth", f"{idx:06d}.mat"), {"instance": points3d_rgb},
                do_compression=True)
    shutil.copyfile(rgb_path, os.path.join(out, "image", f"{idx:06d}.jpg"))
    with open(os.path.join(out, "calib", f"{idx:06d}.txt"), "w") as f:
        f.write(" ".join(str(v) for v in rtilt.flatten(order="F")) + "\n")
        f.write(" ".join(str(v) for v in k_mat.flatten(order="F")) + "\n")

    boxes3d = _field(meta_rec, "groundtruth3DBB")
    boxes2d = _field(meta2d_rec, "groundtruth2DBB") if meta2d_rec is not None else None
    lines = []
    if boxes3d is not None and np.asarray(boxes3d).size:
        boxes3d = np.atleast_1d(np.asarray(boxes3d).squeeze())
        b2 = (np.atleast_1d(np.asarray(boxes2d).squeeze())
              if boxes2d is not None and np.asarray(boxes2d).size else None)
        for j in range(len(boxes3d)):
            bb = boxes3d[j]
            cls = str(np.asarray(_field(bb, "classname")).item())
            centroid = np.asarray(_field(bb, "centroid")).ravel()
            coeffs = np.abs(np.asarray(_field(bb, "coeffs")).ravel())
            orient = np.asarray(_field(bb, "orientation")).ravel()
            if b2 is not None and j < len(b2):
                box2d = np.asarray(_field(b2[j], "gtBb2D")).ravel()
            else:
                box2d = np.zeros(4)
            lines.append(
                f"{cls} {int(box2d[0])} {int(box2d[1])} {int(box2d[2])} {int(box2d[3])} "
                f"{centroid[0]:f} {centroid[1]:f} {centroid[2]:f} "
                f"{coeffs[0]:f} {coeffs[1]:f} {coeffs[2]:f} {orient[0]:f} {orient[1]:f}")
    with open(os.path.join(label_dir, f"{idx:06d}.txt"), "w") as f:
        f.write("\n".join(lines) + ("\n" if lines else ""))


def write_splits(official_root, out):
    """allsplit.mat -> the train and val index files (extract_split.m): a
    scene is train when its sequence folder is within a train path."""
    import scipy.io as sio

    split = sio.loadmat(os.path.join(official_root, "SUNRGBDtoolbox", "traintestSUNRGBD",
                                     "allsplit.mat"), squeeze_me=True)
    train = {str(p)[17:] if str(p).startswith("/") else str(p) for p in split["alltrain"]}
    meta = sio.loadmat(os.path.join(official_root, "SUNRGBDMeta3DBB_v2.mat"),
                       squeeze_me=True, struct_as_record=True)["SUNRGBDMeta"]
    train_idx, val_idx = [], []
    for i in range(len(meta)):
        folder = str(_field(meta[i], "sequenceName"))
        (train_idx if any(folder in t for t in train) else val_idx).append(i + 1)
    with open(os.path.join(out, "train_data_idx.txt"), "w") as f:
        f.write("\n".join(str(i) for i in train_idx) + "\n")
    with open(os.path.join(out, "val_data_idx.txt"), "w") as f:
        f.write("\n".join(str(i) for i in val_idx) + "\n")
    return len(train_idx), len(val_idx)


def main(argv=None):
    import scipy.io as sio

    p = argparse.ArgumentParser()
    p.add_argument("--official_root", default="OFFICIAL_SUNRGBD")
    p.add_argument("--out", default="sunrgbd_trainval")
    p.add_argument("--v1", action="store_true", help="write label_v1/")
    p.add_argument("--start", type=int, default=1)
    p.add_argument("--end", type=int, default=10335)
    args = p.parse_args(argv)

    import_optional("PIL.Image", _HERE)  # refuse before the first scene, not once a scene
    os.makedirs(args.out, exist_ok=True)
    meta = sio.loadmat(os.path.join(args.official_root, "SUNRGBDMeta3DBB_v2.mat"),
                       squeeze_me=True, struct_as_record=True)["SUNRGBDMeta"]
    try:
        meta2d = sio.loadmat(os.path.join(args.official_root, "SUNRGBDMeta2DBB_v2.mat"),
                             squeeze_me=True, struct_as_record=True)["SUNRGBDMeta2DBB"]
    except Exception:  # the 2D boxes are optional: their label fields become 0
        meta2d = None
    for idx in range(args.start, args.end + 1):
        try:
            extract_one(meta[idx - 1], None if meta2d is None else meta2d[idx - 1],
                        args.official_root, args.out, idx, v1=args.v1)
            print(f"{idx:06d}: done")
        except Exception as e:  # the MATLAB step's per-scene try/catch, reported per scene
            print(f"{idx:06d}: FAILED ({e})")
    n_train, n_val = write_splits(args.official_root, args.out)
    print(f"splits: {n_train} train / {n_val} val")


if __name__ == "__main__":
    main()
