"""The port's offline data prep against the JAX package's, on the CPU.

``prep_scannet``, ``prep_sunrgbd``, ``prep_sunrgbd_raw`` and ``gen_split``
of both packages are fed the same tiny raw files, written here in the
layouts tests/test_prep.py and tests/test_prep_raw.py write (re-created
in this file's helpers, with more scans, boxes that overlap, a scan over
the vertex cap and an empty frame), and the same seeds. What they write
must be the same:

- arrays (``.npy``, and the arrays of ``.npz``) bit for bit: dtype, shape
  and bytes;
- text (labels, calib, splits) and copied images byte for byte;
- ``.mat`` files as loaded arrays (``savemat``'s compressed bytes carry no
  contract).

Where PIL is missing the raw prep raises an ``ImportError`` that names it.
"""
import json
import os
import struct
import sys

import numpy as np
import pytest

scipy_io = pytest.importorskip("scipy.io")

from iou3dmatch_tpu.data import gen_split as jgen  # noqa: E402
from iou3dmatch_tpu.data import prep_scannet as jscan  # noqa: E402
from iou3dmatch_tpu.data import prep_sunrgbd as jsun  # noqa: E402
from iou3dmatch_tpu.data import prep_sunrgbd_raw as jraw  # noqa: E402
from iou3dmatch_tpu_torch.data import gen_split as pgen  # noqa: E402
from iou3dmatch_tpu_torch.data import prep_scannet as pscan  # noqa: E402
from iou3dmatch_tpu_torch.data import prep_sunrgbd as psun  # noqa: E402
from iou3dmatch_tpu_torch.data import prep_sunrgbd_raw as praw  # noqa: E402
from iou3dmatch_tpu_torch.data.config import get_config  # noqa: E402

SCANNET_LABELS = {"chair": 5, "table": 7, "wall": 1, "floor": 2, "bookshelf": 10}


def same(got, want, what=""):
    got, want = np.asarray(got), np.asarray(want)
    assert (got.dtype, got.shape) == (want.dtype, want.shape), what
    assert got.tobytes() == want.tobytes(), what


def same_trees(got_dir, want_dir):
    """Every file of ``want_dir`` is in ``got_dir`` with the same content:
    arrays bit for bit, .mat as loaded arrays, anything else byte for byte."""
    names = sorted(os.listdir(want_dir))
    assert sorted(os.listdir(got_dir)) == names
    for name in names:
        g, w = os.path.join(got_dir, name), os.path.join(want_dir, name)
        if os.path.isdir(w):
            same_trees(g, w)
        elif name.endswith(".npy"):
            same(np.load(g), np.load(w), name)
        elif name.endswith(".npz"):
            with np.load(g) as a, np.load(w) as b:
                assert sorted(a.files) == sorted(b.files)
                for k in b.files:
                    same(a[k], b[k], f"{name}:{k}")
        elif name.endswith(".mat"):
            a, b = scipy_io.loadmat(g), scipy_io.loadmat(w)
            keys = sorted(k for k in b if not k.startswith("__"))
            assert sorted(k for k in a if not k.startswith("__")) == keys
            for k in keys:
                same(a[k], b[k], f"{name}:{k}")
        else:
            with open(g, "rb") as f, open(w, "rb") as h:
                assert f.read() == h.read(), name
    return names


# ------------------------------------------------------------------ ScanNet
def write_binary_ply(path, xyz, rgb):
    header = ("ply\nformat binary_little_endian 1.0\n"
              f"element vertex {len(xyz)}\n"
              "property float x\nproperty float y\nproperty float z\n"
              "property uchar red\nproperty uchar green\nproperty uchar blue\n"
              "property uchar alpha\nend_header\n")
    with open(path, "wb") as f:
        f.write(header.encode())
        for p, c in zip(xyz, rgb):
            f.write(struct.pack("<fffBBBB", *p, *c, 255))


def write_scan(root, scan_name, seed, n=120):
    """A raw ScanNet scan: a PLY of ``n`` vertices, segments of 3 vertices,
    objects of chairs, a table, a bookshelf, a wall and a floor, unannotated
    segments, and a rotated axis-alignment matrix."""
    rng = np.random.RandomState(seed)
    d = os.path.join(root, scan_name)
    os.makedirs(d)
    xyz = rng.uniform(-2, 2, (n, 3)).astype(np.float32)
    write_binary_ply(os.path.join(d, scan_name + "_vh_clean_2.ply"), xyz,
                     rng.randint(0, 255, (n, 3)))
    segs = rng.permutation(np.repeat(np.arange(n // 3) * 7, 3)).tolist()
    with open(os.path.join(d, scan_name + "_vh_clean_2.0.010000.segs.json"), "w") as f:
        json.dump({"segIndices": segs}, f)
    seg_ids = sorted(set(segs))
    labels = ["chair", "table", "chair", "bookshelf", "wall", "floor"]
    groups, per = [], len(seg_ids) // (len(labels) + 1)
    for i, label in enumerate(labels):
        groups.append({"objectId": i, "label": label,
                       "segments": seg_ids[i * per:(i + 1) * per]})
    with open(os.path.join(d, scan_name + ".aggregation.json"), "w") as f:
        json.dump({"segGroups": groups}, f)
    c, s = np.cos(0.3 * seed), np.sin(0.3 * seed)
    align = np.array([[c, -s, 0, 0.5], [s, c, 0, -0.2], [0, 0, 1, 0.1], [0, 0, 0, 1]])
    with open(os.path.join(d, scan_name + ".txt"), "w") as f:
        f.write("sceneType = Bedroom\n")
        f.write(f"axisAlignment = {' '.join(str(float(v)) for v in align.ravel())}\n")


def write_scannet_raw(root, names, n=120):
    for i, name in enumerate(names):
        write_scan(root, name, i + 1, n)
    tsv = os.path.join(root, "labels.tsv")
    with open(tsv, "w") as f:
        f.write("raw_category\tnyu40id\n")
        for k, v in SCANNET_LABELS.items():
            f.write(f"{k}\t{v}\n")
    return tsv


def test_scannet_readers_match_jax(tmp_path):
    root = str(tmp_path)
    tsv = write_scannet_raw(root, ["scene0000_00"])
    d = os.path.join(root, "scene0000_00", "scene0000_00")
    assert pscan.read_label_mapping(tsv) == jscan.read_label_mapping(tsv) == SCANNET_LABELS
    numeric = tmp_path / "numeric.tsv"
    numeric.write_text("nyu40id\tmapped\n5\t1\n7\t2\n")
    got = pscan.read_label_mapping(str(numeric), "nyu40id", "mapped")
    assert got == jscan.read_label_mapping(str(numeric), "nyu40id", "mapped") == {5: 1, 7: 2}
    assert pscan.read_aggregation(d + ".aggregation.json") == \
        jscan.read_aggregation(d + ".aggregation.json")
    assert pscan.read_segmentation(d + "_vh_clean_2.0.010000.segs.json") == \
        jscan.read_segmentation(d + "_vh_clean_2.0.010000.segs.json")
    same(pscan.read_axis_align_matrix(d + ".txt"), jscan.read_axis_align_matrix(d + ".txt"))
    (tmp_path / "none.txt").write_text("sceneType = Office\n")
    same(pscan.read_axis_align_matrix(str(tmp_path / "none.txt")),
         jscan.read_axis_align_matrix(str(tmp_path / "none.txt")))
    assert [pscan.represents_int(s) for s in ("3", "x", "-1", "1.5")] == [True, False, True, False]
    same(pscan.OBJ_CLASS_IDS, jscan.OBJ_CLASS_IDS)
    assert pscan.MAX_NUM_POINT == jscan.MAX_NUM_POINT == 50000
    files = [d + "_vh_clean_2.ply", d + ".aggregation.json", d + "_vh_clean_2.0.010000.segs.json",
             d + ".txt", tsv]
    for a, b in zip(pscan.export(*files), jscan.export(*files)):
        same(a, b)


def test_scannet_export_one_scan_matches_jax(tmp_path):
    root = str(tmp_path)
    tsv = write_scannet_raw(root, ["scene0000_00"])
    for mod in (pscan, jscan):
        out = tmp_path / mod.__name__
        out.mkdir()
        mod.export_one_scan(root, "scene0000_00", tsv, str(out / "scene0000_00"),
                            np.random.RandomState(0))
    names = same_trees(str(tmp_path / pscan.__name__), str(tmp_path / jscan.__name__))
    assert len(names) == 4
    boxes = np.load(tmp_path / pscan.__name__ / "scene0000_00_bbox.npy")
    assert boxes.shape == (4, 7) and set(boxes[:, -1]) == {5, 7, 10}  # no wall, no floor


@pytest.mark.parametrize("cap", [50000, 100])
def test_scannet_main_matches_jax(tmp_path, monkeypatch, capsys, cap):
    """Three scans through both mains with one seed; at a cap of 100 of the
    120 vertices the cap's draws are taken in the scan list's order."""
    names = ["scene0000_00", "scene0001_00", "scene0002_01"]
    tsv = write_scannet_raw(str(tmp_path / "scans"), names)
    (tmp_path / "list.txt").write_text("\n".join(names) + "\n\n")
    printed = {}
    for mod in (pscan, jscan):
        monkeypatch.setattr(mod, "MAX_NUM_POINT", cap)
        mod.main(["--scannet_dir", str(tmp_path / "scans"), "--label_map", tsv, "--scan_list",
                  str(tmp_path / "list.txt"), "--output_dir", str(tmp_path / mod.__name__),
                  "--seed", "4"])
        printed[mod] = capsys.readouterr().out
    assert len(same_trees(str(tmp_path / pscan.__name__), str(tmp_path / jscan.__name__))) == 12
    assert printed[pscan] == printed[jscan]
    assert len(np.load(tmp_path / pscan.__name__ / "scene0001_00_vert.npy")) == min(cap, 120)
    # a second run skips what exists, as JAX's does
    pscan.main(["--scannet_dir", str(tmp_path / "scans"), "--label_map", tsv, "--scan_list",
                str(tmp_path / "list.txt"), "--output_dir", str(tmp_path / pscan.__name__)])
    assert capsys.readouterr().out.count("exists, skipping") == 3


# --------------------------------------------------------------- SUN RGB-D
LABELS = [
    # class x y w h cx cy cz l w h ox oy (half sizes)
    ["bed 0 0 10 10 1.0 2.0 0.5 1.0 0.8 0.4 0.955 -0.296",
     "chair 1 1 5 5 1.2 2.2 0.5 0.5 0.4 0.45 0.0 1.0",     # overlaps the bed
     "table 2 2 5 5 1.1 2.1 0.6 0.6 0.6 0.3 -0.7 -0.7",    # a third box over both
     "sofa 2 2 5 5 0.9 2.0 0.5 0.7 0.5 0.5 1 0",           # a fourth: slot 3 again
     "lamp 3 3 2 2 4.0 4.0 1.0 0.2 0.2 0.2 1 0"],          # not a detection class
    ["desk 0 0 1 1 -1.0 3.0 0.4 0.6 0.4 0.4 0.5 0.8"],
    ["lamp 0 0 1 1 0.0 0.0 0.0 0.1 0.1 0.1 1 0"],          # empty once filtered
    ["bathtub 0 0 1 1 0.0 2.0 0.3 0.9 0.5 0.3 0.2 0.9",
     "toilet 0 0 1 1 0.5 1.5 0.3 0.3 0.3 0.4 -0.9 0.1"],
]


def write_trainval(root, counts=(400, 300, 200, 90)):
    """``sunrgbd_trainval`` frames 1-4 (depth .mat of float32 points, half
    of them inside the boxes, and label_v1 lines); frame 4 holds fewer
    points than the prep samples."""
    rng = np.random.RandomState(4)
    for sub in ("depth", "label_v1", "label"):
        os.makedirs(os.path.join(root, sub), exist_ok=True)
    for i, (lines, n) in enumerate(zip(LABELS, counts), start=1):
        pts = [rng.uniform(-1, 5, (n - n // 2, 3))]
        objs = [jsun.SunObject3d(x) for x in lines]
        for j in range(n // 2):
            o = objs[j % len(objs)]
            local = rng.uniform(-1, 1, 3) * np.array([o.l, o.w, o.h]) * 0.95
            pts.append((jsun.rotz(-o.heading_angle) @ local + o.centroid)[None])
        xyz = np.concatenate(pts)
        pc = np.c_[xyz, rng.uniform(0, 1, (n, 3))].astype(np.float32)
        scipy_io.savemat(os.path.join(root, "depth", f"{i:06d}.mat"), {"instance": pc})
        for sub in ("label_v1", "label"):
            with open(os.path.join(root, sub, f"{i:06d}.txt"), "w") as f:
                f.write("\n".join(lines) + "\n")
    with open(os.path.join(root, "train_data_idx.txt"), "w") as f:
        f.write("1\n2\n3\n4\n")


@pytest.mark.parametrize("line", LABELS[0] + LABELS[3])
def test_sunrgbd_label_parsing_matches_jax(line):
    got, want = psun.SunObject3d(line), jsun.SunObject3d(line)
    assert (got.classname, got.l, got.w, got.h, got.heading_angle) == \
        (want.classname, want.l, want.w, want.h, want.heading_angle)
    same(got.centroid, want.centroid)
    size = (want.l, want.w, want.h)
    same(psun.compute_box_corners(want.centroid, size, want.heading_angle),
         jsun.compute_box_corners(want.centroid, size, want.heading_angle))
    pc = np.random.RandomState(0).uniform(-1, 5, (500, 6))
    mask = psun.points_in_box(pc, want.centroid, size, want.heading_angle)
    same(mask, jsun.points_in_box(pc, want.centroid, size, want.heading_angle))


@pytest.mark.parametrize("skip_empty", [True, False])
@pytest.mark.parametrize("num_point", [150, 400])
def test_sunrgbd_extract_scene_matches_jax(tmp_path, skip_empty, num_point):
    """Every frame, with one generator for the whole list as main uses it:
    points in up to 4 boxes fill the 3 vote slots, frame 3 is empty after
    the class filter, frame 4 is drawn with replacement."""
    write_trainval(str(tmp_path))
    g, w = np.random.RandomState(3), np.random.RandomState(3)
    assert psun.TYPE2CLASS == jsun.TYPE2CLASS
    assert psun.DEFAULT_TYPE_WHITELIST == jsun.DEFAULT_TYPE_WHITELIST
    for i in range(1, 5):
        for use_v1 in (True, False):
            got = psun.extract_scene(str(tmp_path), i, num_point, use_v1, rng=g,
                                     skip_empty_scene=skip_empty)
            want = jsun.extract_scene(str(tmp_path), i, num_point, use_v1, rng=w,
                                      skip_empty_scene=skip_empty)
            assert (got is None) == (want is None) == (skip_empty and i == 3)
            if want is not None:
                for a, b in zip(got, want):
                    same(a, b, f"frame {i}")
    votes = psun.extract_scene(str(tmp_path), 1, 400, rng=np.random.RandomState(0))[2]
    assert votes[:, 0].sum() > 0
    # points in 2 and 3 boxes: slot 2 and slot 3 hold other votes than slot 1
    assert (np.abs(votes[:, 4:7] - votes[:, 1:4]).sum(1) > 0).any()
    assert (np.abs(votes[:, 7:10] - votes[:, 4:7]).sum(1) > 0).any()


@pytest.mark.parametrize("flags", [["--use_v1"], ["--no_skip_empty", "--num_point", "120"]])
def test_sunrgbd_main_matches_jax(tmp_path, capsys, flags):
    write_trainval(str(tmp_path / "trainval"))
    printed = {}
    for mod in (psun, jsun):
        mod.main(["--root", str(tmp_path / "trainval"), "--idx_file",
                  str(tmp_path / "trainval" / "train_data_idx.txt"), "--output_dir",
                  str(tmp_path / mod.__name__), "--seed", "7"] + flags)
        printed[mod] = capsys.readouterr().out
    names = same_trees(str(tmp_path / psun.__name__), str(tmp_path / jsun.__name__))
    assert len(names) == (12 if "--no_skip_empty" in flags else 9)
    assert printed[psun] == printed[jsun]


# ----------------------------------------------------------- raw SUN RGB-D
PREFIX = "/n/fs/sun3d/data/"  # the capture machine's prefix the metadata paths carry


def write_official(root, scenes=3):
    """OFFICIAL_SUNRGBD with ``scenes`` scenes: depth PNGs (millimetres
    rotated by 3 bits, some pixels 0 and some beyond 8 m), RGB JPEGs, the 3D
    metadata with boxes (one scene without), the 2D metadata and
    allsplit.mat (scene 2 in val)."""
    from PIL import Image

    rng = np.random.RandomState(0)
    h, w = 24, 32
    recs, recs2d = [], []
    for s in range(1, scenes + 1):
        seq = f"SUNRGBD/kv1/scene{s}"
        d = os.path.join(root, seq)
        os.makedirs(d, exist_ok=True)
        depth_mm = rng.uniform(500, 9000, (h, w)).astype(np.uint16)
        depth_mm[rng.rand(h, w) < 0.1] = 0
        depth_vis = np.bitwise_or(np.left_shift(depth_mm, 3),
                                  np.right_shift(depth_mm, 16 - 3)).astype(np.uint16)
        Image.fromarray(depth_vis).save(os.path.join(d, "depth.png"))
        Image.fromarray(rng.randint(0, 255, (h, w, 3), np.uint8)).save(os.path.join(d, "rgb.jpg"))
        k_mat = np.array([[40.0 + s, 0, w / 2], [0, 41.0, h / 2], [0, 0, 1]])
        c, sn = np.cos(0.05 * s), np.sin(0.05 * s)
        rtilt = np.array([[1, 0, 0], [0, c, -sn], [0, sn, c]])
        nbox = 0 if s == 3 else s
        boxes = np.zeros((1, nbox), dtype=[("classname", "O"), ("centroid", "O"),
                                           ("coeffs", "O"), ("orientation", "O")])
        for j in range(nbox):
            boxes[0, j] = (["bed", "chair"][j % 2], rng.uniform(-1, 1, (1, 3)) + [0, 3, 0],
                           -rng.uniform(0.2, 1.0, (1, 3)), rng.uniform(-1, 1, (1, 3)))
        recs.append((seq, rtilt, k_mat, PREFIX + seq + "/depth.png", PREFIX + seq + "/rgb.jpg",
                     boxes))
        b2 = np.zeros((1, nbox), dtype=[("gtBb2D", "O")])
        for j in range(nbox):
            b2[0, j] = (rng.uniform(0, 30, (1, 4)),)
        recs2d.append((b2,))
    meta = np.array(recs, dtype=[("sequenceName", "O"), ("Rtilt", "O"), ("K", "O"),
                                 ("depthpath", "O"), ("rgbpath", "O"),
                                 ("groundtruth3DBB", "O")])[None]
    scipy_io.savemat(os.path.join(root, "SUNRGBDMeta3DBB_v2.mat"), {"SUNRGBDMeta": meta})
    meta2d = np.array(recs2d, dtype=[("groundtruth2DBB", "O")])[None]
    scipy_io.savemat(os.path.join(root, "SUNRGBDMeta2DBB_v2.mat"), {"SUNRGBDMeta2DBB": meta2d})
    split_dir = os.path.join(root, "SUNRGBDtoolbox", "traintestSUNRGBD")
    os.makedirs(split_dir)
    train = np.array([PREFIX + f"SUNRGBD/kv1/scene{s}" for s in range(1, scenes + 1) if s != 2],
                     dtype=object)
    scipy_io.savemat(os.path.join(split_dir, "allsplit.mat"), {"alltrain": train})


def test_raw_depth_and_frames_match_jax(tmp_path):
    write_official(str(tmp_path))
    k_mat = np.array([[40.0, 0, 16], [0, 41.0, 12], [0, 0, 1]])
    path = str(tmp_path / "SUNRGBD" / "kv1" / "scene1" / "depth.png")
    got, want = praw.read_depth_points(path, k_mat), jraw.read_depth_points(path, k_mat)
    for a, b in zip(got, want):
        same(a, b)
    assert got[0][:, 2].max() == np.float32(8.0) and len(got[0]) < 24 * 32
    rtilt = jraw.np.array([[1, 0, 0], [0, 0.9, -0.1], [0, 0.1, 0.9]])
    same(praw.camera_to_upright_depth(got[0], rtilt), jraw.camera_to_upright_depth(want[0], rtilt))


@pytest.mark.parametrize("v1", [True, False])
def test_raw_main_matches_jax(tmp_path, capsys, v1):
    """Both mains over the official layout: depth .mat, copied images,
    calib and labels (2D boxes from the 2D metadata, a scene without boxes),
    and the split files; then prep_sunrgbd of the port reads the result."""
    write_official(str(tmp_path / "official"))
    printed = {}
    for mod in (praw, jraw):
        mod.main(["--official_root", str(tmp_path / "official"), "--out",
                  str(tmp_path / mod.__name__), "--start", "1", "--end", "3"]
                 + (["--v1"] if v1 else []))
        printed[mod] = capsys.readouterr().out
    assert "FAILED" not in printed[jraw]
    assert printed[praw] == printed[jraw]
    same_trees(str(tmp_path / praw.__name__), str(tmp_path / jraw.__name__))
    out = tmp_path / praw.__name__
    assert (out / "train_data_idx.txt").read_text() == "1\n3\n"
    label = (out / ("label_v1" if v1 else "label") / "000002.txt").read_text().splitlines()
    assert len(label) == 2 and label[1].startswith("chair ")
    assert (out / ("label_v1" if v1 else "label") / "000003.txt").read_text() == ""
    res = psun.extract_scene(str(out), 2, 100, use_v1=v1, rng=np.random.RandomState(0))
    assert res is not None and res[1].shape == (2, 8)


def test_raw_extract_one_without_2d_metadata_matches_jax(tmp_path):
    """extract_one on a record given as a dict, as tests/test_prep_raw.py
    does, with no 2D metadata: the label's 2D fields are 0."""
    from PIL import Image

    root = tmp_path / "official"
    (root / "scene1").mkdir(parents=True)
    depth_mm = np.full((32, 40), 2000, np.uint16)
    Image.fromarray(np.bitwise_or(np.left_shift(depth_mm, 3), np.right_shift(depth_mm, 13))
                    .astype(np.uint16)).save(root / "scene1" / "depth.png")
    Image.fromarray(np.full((32, 40, 3), 128, np.uint8)).save(root / "scene1" / "rgb.jpg")
    rec = {"Rtilt": np.eye(3), "K": np.array([[50.0, 0, 20], [0, 50.0, 16], [0, 0, 1]]),
           "depthpath": str(root / "scene1" / "depth.png"),
           "rgbpath": str(root / "scene1" / "rgb.jpg"), "sequenceName": "kv1/scene1",
           "groundtruth3DBB": np.array([(np.array([[0.0, 2.0, 0.5]]), np.array([[0.6, 0.9, 0.4]]),
                                         np.array([[1.0, 0.0]]), "bed")],
                                       dtype=[("centroid", "O"), ("coeffs", "O"),
                                              ("orientation", "O"), ("classname", "O")])}
    for mod in (praw, jraw):
        (tmp_path / mod.__name__).mkdir()
        mod.extract_one(rec, None, str(root), str(tmp_path / mod.__name__), 1, v1=True)
    same_trees(str(tmp_path / praw.__name__), str(tmp_path / jraw.__name__))
    assert (tmp_path / praw.__name__ / "label_v1" / "000001.txt").read_text().startswith(
        "bed 0 0 0 0 0.000000 2.000000 0.500000 0.600000 0.900000 0.400000 1.000000 0.000000")


def test_raw_prep_refuses_without_pil(tmp_path, monkeypatch):
    write_official(str(tmp_path / "official"))
    monkeypatch.setitem(sys.modules, "PIL", None)
    msg = r"data/prep_sunrgbd_raw\.py needs the package 'PIL'"
    with pytest.raises(ImportError, match=msg):
        praw.read_depth_points(str(tmp_path / "official" / "SUNRGBD" / "kv1" / "scene1" /
                                   "depth.png"), np.eye(3))
    with pytest.raises(ImportError, match=msg):
        praw.main(["--official_root", str(tmp_path / "official"), "--out", str(tmp_path / "out"),
                   "--end", "3"])
    assert not (tmp_path / "out").exists()  # refused before the first scene
    # prep_sunrgbd needs only scipy
    write_trainval(str(tmp_path / "trainval"))
    assert psun.extract_scene(str(tmp_path / "trainval"), 2, 50,
                              rng=np.random.RandomState(0)) is not None


# ---------------------------------------------------------------- gen_split
def sunrgbd_dump(root, n=40, seed=0):
    """``n`` SUN RGB-D dump scenes of 1-3 classes each."""
    rng = np.random.RandomState(seed)
    os.makedirs(root)
    for i in range(1, n + 1):
        cls = rng.choice(10, rng.randint(1, 4), replace=False)
        boxes = np.c_[rng.randn(len(cls), 7), cls]
        np.save(os.path.join(root, f"{i:06d}_bbox.npy"), boxes)
        np.savez_compressed(os.path.join(root, f"{i:06d}_pc.npz"), pc=np.zeros((2, 6)))


def scannet_dump(root, n=60, seed=0):
    rng = np.random.RandomState(seed)
    os.makedirs(os.path.join(root, "data"))
    os.makedirs(os.path.join(root, "meta"))
    ids = pscan.OBJ_CLASS_IDS
    names = [f"scene{i:04d}_00" for i in range(n)]
    for name in names:
        nyu = rng.choice(ids, rng.randint(2, 8))
        np.save(os.path.join(root, "data", name + "_bbox.npy"), np.c_[rng.randn(len(nyu), 6), nyu])
    with open(os.path.join(root, "meta", "scannetv2_train.txt"), "w") as f:
        f.write("\n".join(names))
    return os.path.join(root, "meta", "scannetv2_train.txt")


def test_class_matrices_match_jax(tmp_path):
    sunrgbd_dump(str(tmp_path / "sun"))
    names = sorted({f[:6] for f in os.listdir(tmp_path / "sun")})
    same(pgen.scan_class_matrix_sunrgbd(names, str(tmp_path / "sun"), get_config("sunrgbd")),
         jgen.scan_class_matrix_sunrgbd(names, str(tmp_path / "sun"), jgen.get_config("sunrgbd")))
    split = scannet_dump(str(tmp_path / "scan"))
    names = open(split).read().splitlines()
    same(pgen.scan_class_matrix_scannet(names, str(tmp_path / "scan" / "data"),
                                        get_config("scannet")),
         jgen.scan_class_matrix_scannet(names, str(tmp_path / "scan" / "data"),
                                        jgen.get_config("scannet")))


@pytest.mark.parametrize("dataset,ratio", [("sunrgbd", 0.25), ("sunrgbd", 0.5),
                                           ("scannet", 0.1), ("scannet", 0.2)])
def test_gen_split_main_matches_jax(tmp_path, capsys, dataset, ratio):
    if dataset == "sunrgbd":
        sunrgbd_dump(str(tmp_path / "data"))
        flags = ["--data_path", str(tmp_path / "data")]
    else:
        split = scannet_dump(str(tmp_path / "scan"))
        flags = ["--data_path", str(tmp_path / "scan" / "data"), "--split_file", split]
    outs = {}
    for mod in (pgen, jgen):
        (tmp_path / mod.__name__).mkdir()
        mod.main([dataset, str(ratio), "0", "--seed", "11", "--out_dir",
                  str(tmp_path / mod.__name__)] + flags)
        outs[mod] = capsys.readouterr().out.replace(mod.__name__, "")
    assert outs[pgen] == outs[jgen]
    assert len(same_trees(str(tmp_path / pgen.__name__), str(tmp_path / jgen.__name__))) == 1


def test_draw_split_refusals_match_jax():
    names = [f"{i:06d}" for i in range(10)]
    m = np.zeros((10, 3))
    m[np.arange(10), np.arange(10) % 2] = 1  # class 2 appears nowhere
    for mod in (pgen, jgen):
        with pytest.raises(ValueError, match="covers only 2/3 classes"):
            mod.draw_split(names, m, 0.5, 3, np.random.RandomState(0))
    m[0, 2] = 1  # every class somewhere, but one scene of 10 cannot hold all three
    for mod in (pgen, jgen):
        with pytest.raises(RuntimeError, match="in 50 draws"):
            mod.draw_split(names, m, 0.1, 3, np.random.RandomState(0), max_tries=50)
    g, w = np.random.RandomState(1), np.random.RandomState(1)
    assert pgen.draw_split(names, m, 0.5, 3, g) == jgen.draw_split(names, m, 0.5, 3, w)
    assert g.randint(1 << 30) == w.randint(1 << 30)  # the same draws were taken


@pytest.mark.parametrize("jax_module,port_module", [(jscan, pscan), (jsun, psun), (jraw, praw),
                                                    (jgen, pgen)],
                         ids=["prep_scannet", "prep_sunrgbd", "prep_sunrgbd_raw", "gen_split"])
def test_every_jax_function_has_a_counterpart(jax_module, port_module):
    names = {n for n, v in vars(jax_module).items()
             if callable(v) and getattr(v, "__module__", None) == jax_module.__name__}
    assert names and not sorted(n for n in names if not callable(getattr(port_module, n, None)))
